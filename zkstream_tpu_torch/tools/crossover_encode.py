"""Send-direction crossover study: could the batched device encoder
(``ops/encode.build_reply_streams``) beat the host encoders in any
runtime shape this package has?  The port's copy of the JAX package's
``tools/crossover_encode.py``.

The two candidate consumers are measured against their host-side
incumbents:

1. **Server notification fan-out** (server/server.py ``notify``): one
   database change -> N subscribed connections.  Incumbent: encode the
   packet ONCE, share the bytes (one ``encode`` + N buffer appends —
   the appends are the floor ANY implementation pays to hand N sockets
   their bytes).  Device candidate: ``build_reply_streams`` emitting N
   identical notification frames, one launch sequence + one readback.

2. **Proxy outbound sweep** (MeshFleetIngest sending its fleet's
   pings / watch re-arms in one tick): N distinct small frames
   (per-connection xids).  Incumbents: the C-extension
   ``encode_request`` and the Python ``JuteWriter`` per frame.  Device
   candidate: the same ``build_reply_streams`` call (header-only
   frames — exactly a ping).

The device candidate runs on ``--device`` (``cuda`` default: torch
tensors on the card, one packed readback a tick, the synchronize
inside the timed window) and once more on ``cpu``, the plain torch
version on the host, printed as such.  Before any timing its output
bytes are held to the host encoder's for the same fields; a mismatch
raises.

Prints one JSON line per measurement.

Usage:  python -m zkstream_tpu_torch.tools.crossover_encode
            [--conns 128,1024] [--frames 1] [--reps 50] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

#: the zxid every encoded frame carries (high word 0)
_ZXID = 1234


def bench_host_fanout(n: int, reps: int) -> dict:
    """Encode-once fan-out: the server's actual notify shape."""
    from ..protocol.framing import PacketCodec

    codec = PacketCodec(server=True)
    codec.handshaking = False
    pkt = {'xid': -1, 'zxid': 12345, 'err': 'OK',
           'opcode': 'NOTIFICATION', 'type': 'DATA_CHANGED',
           'state': 'SYNC_CONNECTED', 'path': '/some/watched/node'}
    sinks = [bytearray() for _ in range(n)]
    t0 = time.perf_counter()
    for _ in range(reps):
        data = codec.encode(dict(pkt))      # encode ONCE
        for s in sinks:                     # the floor: N byte hands
            s += data
    dt = (time.perf_counter() - t0) / reps
    for s in sinks:
        s.clear()
    return {'what': 'host_fanout_encode_once', 'n': n,
            'us_per_event': round(dt * 1e6, 2),
            'ns_per_conn': round(dt / n * 1e9, 1)}


def bench_host_replies(n: int, reps: int, use_ext: bool) -> dict | None:
    """N DISTINCT small frames (per-connection xids) — the proxy
    outbound sweep shape — through the scalar encoders."""
    from ..protocol.framing import PacketCodec

    try:
        codec = PacketCodec(server=True, use_native=use_ext)
    except RuntimeError:
        return None
    codec.handshaking = False
    pkts = [{'xid': i + 1, 'zxid': 1000 + i, 'err': 'OK',
             'opcode': 'PING'} for i in range(n)]
    total = 0
    t0 = time.perf_counter()
    for _ in range(reps):
        for p in pkts:
            total += len(codec.encode(p))
    dt = (time.perf_counter() - t0) / reps
    return {'what': 'host_replies_%s' % ('c' if use_ext else 'py'),
            'n': n, 'us_per_tick': round(dt * 1e6, 2),
            'ns_per_frame': round(dt / n * 1e9, 1),
            'mib_s': round(total / reps / dt / (1 << 20), 1)}


def batch_fields(n: int, frames: int) -> dict:
    """The device candidate's field planes (numpy int32 ``[n, frames]``):
    distinct xids, one zxid, no error, header-only bodies."""
    import numpy as np

    return {'xid': np.arange(1, n * frames + 1, dtype=np.int32
                             ).reshape(n, frames),
            'zxid_hi': np.zeros((n, frames), np.int32),
            'zxid_lo': np.full((n, frames), _ZXID, np.int32),
            'err': np.zeros((n, frames), np.int32),
            'body_sizes': np.full((n, frames), 16, np.int32)}


def host_streams(fields: dict) -> list[bytes]:
    """The host encoder's bytes for the same fields, one stream a row:
    each frame a header-only reply through the Python ``PacketCodec``."""
    from ..protocol.framing import PacketCodec

    codec = PacketCodec(server=True, use_native=False)
    codec.handshaking = False
    zxid = (int(fields['zxid_hi'][0, 0]) << 32) | int(fields['zxid_lo'][0, 0])
    return [b''.join(codec.encode({'xid': int(x), 'zxid': zxid,
                                   'err': 'OK', 'opcode': 'PING'})
                     for x in row)
            for row in fields['xid']]


def _encoder(fields: dict, out_len: int, device):
    """``(fn, host)``: ``fn()`` runs one tick of the device encode — the
    packed ``[n, 4 + out_len]`` result (each row's int32 length, then its
    stream bytes) copied into the pinned host tensor ``host`` in one
    readback, the stream synchronized."""
    import torch

    from ..ops.encode import build_reply_streams

    args = [torch.from_numpy(fields[k]).to(device)
            for k in ('xid', 'zxid_hi', 'zxid_lo', 'err', 'body_sizes')]
    n = args[0].shape[0]
    cuda = device.type == 'cuda'
    host = torch.empty((n, 4 + out_len), dtype=torch.uint8,
                       pin_memory=cuda)

    def fn():
        buf, lens = build_reply_streams(*args, out_len=out_len)
        packed = torch.cat([lens.view(torch.uint8).reshape(n, 4), buf], 1)
        host.copy_(packed, non_blocking=cuda)
        if cuda:
            torch.cuda.synchronize(device)
        return host
    return fn, host


def _rows(host) -> list[bytes]:
    """Each row's stream bytes out of a packed readback."""
    a = host.numpy()
    lens = a[:, :4].copy().view('<i4')[:, 0]
    return [a[i, 4:4 + int(lens[i])].tobytes() for i in range(a.shape[0])]


def device_streams(n: int, frames: int, device='cuda') -> list[bytes]:
    """One tick of the device encode on ``device``, as bytes a row."""
    from ..ops.pipeline import resolve_device

    fn, _host = _encoder(batch_fields(n, frames), frames * 24,
                         resolve_device(device))
    return _rows(fn())


def bench_device_batch(n: int, frames: int, reps: int,
                       device='cuda') -> dict:
    """The batched device encode for the same sweep: field planes in,
    framed streams out, ONE launch sequence + ONE readback per tick
    (the readback is the point — the bytes must reach host sockets).
    Raises before timing if the bytes differ from the host encoder's."""
    import torch

    from ..ops.pipeline import resolve_device

    dev = resolve_device(device)
    out_len = frames * 24
    fields = batch_fields(n, frames)
    fn, host = _encoder(fields, out_len, dev)
    got = _rows(fn())                         # warm + first readback
    want = host_streams(fields)
    if got != want:
        bad = next(i for i in range(n) if got[i] != want[i])
        raise AssertionError(
            'device encode on %s differs from the host encoder at row %d: '
            '%s != %s' % (dev, bad, got[bad].hex(), want[bad].hex()))
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = (time.perf_counter() - t0) / reps
    # e2e variant: the produced bytes must reach N sockets — add the
    # per-row slice handoff every consumer pays after the readback
    sinks = [bytearray() for _ in range(n)]
    a = host.numpy()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        ln = a[:, :4].copy().view('<i4')[:, 0].tolist()
        mv = memoryview(a).cast('B', (n * (4 + out_len),))
        for i in range(n):
            off = i * (4 + out_len) + 4
            sinks[i] += mv[off:off + ln[i]]
    dt_e2e = (time.perf_counter() - t0) / reps
    for s in sinks:
        s.clear()
    out = {'what': 'device_batch_encode', 'platform': dev.type,
           'n': n, 'frames': frames, 'bytes_equal_host': True,
           'us_per_tick': round(dt * 1e6, 2),
           'us_per_tick_e2e': round(dt_e2e * 1e6, 2),
           'ns_per_frame': round(dt / (n * frames) * 1e9, 1),
           'ns_per_frame_e2e': round(dt_e2e / (n * frames) * 1e9, 1)}
    if dev.type == 'cuda':
        out['device_name'] = torch.cuda.get_device_name(dev)
    else:
        out['note'] = 'host CPU, plain torch'
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument('--conns', default='128,1024')
    ap.add_argument('--frames', type=int, default=1)
    ap.add_argument('--reps', type=int, default=50)
    ap.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    args = ap.parse_args(argv)
    from ..ops.pipeline import resolve_device

    resolve_device(args.device)       # no card: raise before any line

    for n in [int(x) for x in args.conns.split(',')]:
        print(json.dumps(bench_host_fanout(n, args.reps)), flush=True)
        for use_ext in (True, False):
            r = bench_host_replies(n, args.reps, use_ext)
            if r is not None:
                print(json.dumps(r), flush=True)
        print(json.dumps(bench_device_batch(
            n, args.frames, args.reps, args.device)), flush=True)
        # the host column: the same encode as plain torch on the CPU
        if args.device != 'cpu':
            print(json.dumps(bench_device_batch(
                n, args.frames, args.reps, 'cpu')), flush=True)


if __name__ == '__main__':
    main()
