"""Profile the port's scalar (per-connection) codec hot paths: the
port's copy of the JAX package's ``tools/profile_hotpath.py``, on the
port's ``protocol/`` and ``utils/native`` (the ``ext`` tiers are the
port's ``_zkwire_ext_torch``, built from ``csrc/zkwire_ext.c``).

Answers the question "where does the Python codec actually spend its
time, and what native boundary does that justify?"

Decode (default): three tiers over the same GET_DATA reply stream
(the dominant packet shape of a read-heavy ZK workload: 16-byte
header + data buffer + 68-byte Stat):

  framing   FrameDecoder only (what csrc/zkwire.cpp accelerates)
  python    full PacketCodec decode, pure Python
  ext       full PacketCodec decode via the C extension
            (csrc/zkwire_ext.c), when buildable

plus a cProfile breakdown of the pure-Python tier, so the "jute
primitive reads dominate" claim stays checkable as the code evolves.

Encode (``--encode``): the send-side twin.  Three tiers over the
steady-state write shapes — the GET_DATA reply (server direction) and
the SET_DATA request (client direction):

  per-field  records.write_* walking a JuteWriter one primitive at a
             time (the round-1 idiom; ZKSTREAM_NO_FASTENC forces it
             in production code)
  fast       protocol/fastencode.py single-pass struct-batched
             encoders
  ext        the C encoders in csrc/zkwire_ext.c, when buildable

Ingress (``--ingress``): the receive-drain micro-profile.  N
socketpairs all holding pending bytes, three ways to move them out of
the kernel:

  stream     per-connection asyncio StreamReader reads — one task
             wakeup + read() per connection (the single-loop
             validator's shape)
  os.read    flat per-fd os.read loop in Python (the batch tier's
             pure-Python fallback)
  drain_recv the whole dirty set in ONE C call
             (csrc/zkwire_ext.c), when buildable

Usage:  python -m zkstream_tpu_torch.tools.profile_hotpath [--frames N]
            [--reps N] [--encode | --ingress]
"""

from __future__ import annotations

import argparse
import cProfile
import io
import pstats
import time

from ..protocol import records
from ..protocol.framing import FrameDecoder, PacketCodec
from ..utils import native


def mk_stream(frames: int, data_len: int = 64) -> bytes:
    st = records.Stat(1, 2, 3, 4, 5, 6, 7, 0, data_len, 0, 8)
    enc = PacketCodec(server=True)
    enc.handshaking = False
    return b''.join(
        enc.encode({'xid': i + 1, 'zxid': 1000 + i, 'opcode': 'GET_DATA',
                    'err': 'OK', 'data': b'd' * data_len, 'stat': st})
        for i in range(frames))


def tier_framing(stream: bytes, frames: int) -> None:
    dec = FrameDecoder(use_native=False)
    for _ in dec.feed(stream):
        pass


def tier_codec(stream: bytes, frames: int,
               use_native: bool) -> list:
    c = PacketCodec(use_native=use_native)
    c.handshaking = False
    c.xid_map = {i + 1: 'GET_DATA' for i in range(frames)}
    return c.decode(stream)


def measure(fn, stream: bytes, frames: int, reps: int) -> float:
    """Best-of-trials MiB/s (this image runs on one shared core; min
    over interleaved trials rejects scheduling noise)."""
    best = float('inf')
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(stream, frames)
        best = min(best, (time.perf_counter() - t0) / reps)
    return len(stream) / best / (1 << 20)


def mk_encode_corpora(frames: int, data_len: int = 64):
    """The two steady-state write shapes: GET_DATA replies (server
    direction) and SET_DATA requests (client direction)."""
    st = records.Stat(1, 2, 3, 4, 5, 6, 7, 0, data_len, 0, 8)
    replies = [
        {'xid': i + 1, 'zxid': 1000 + i, 'opcode': 'GET_DATA',
         'err': 'OK', 'data': b'd' * data_len, 'stat': st}
        for i in range(frames)]
    requests = [
        {'xid': i + 1, 'opcode': 'SET_DATA', 'path': '/bench/node',
         'data': b'd' * data_len, 'version': -1}
        for i in range(frames)]
    return (('GET_DATA reply', True, replies),
            ('SET_DATA request', False, requests))


def measure_encode(fn, pkts, reps: int):
    """Best-of-trials (MiB/s, us/frame) for one encoder over a packet
    corpus (same min-over-interleaved-trials discipline as decode)."""
    nbytes = sum(len(fn(dict(p))) for p in pkts)
    best = float('inf')
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(reps):
            for p in pkts:
                fn(p)
        best = min(best, (time.perf_counter() - t0) / reps)
    return nbytes / best / (1 << 20), best / len(pkts) * 1e6


def run_encode_profile(frames: int, reps: int) -> None:
    from ..protocol.fastencode import FastEncoder
    from ..protocol.framing import frame
    from ..protocol.jute import JuteWriter

    ext = native.ensure_ext()
    if ext is None:
        print('C extension unavailable; skipping ext tier')
    for shape, server, pkts in mk_encode_corpora(frames):
        wire = records.write_response if server \
            else records.write_request

        def per_field(pkt):
            w = JuteWriter()
            wire(w, pkt)
            return frame(w.to_bytes())

        fast = FastEncoder()
        fast_fn = (fast.encode_response if server
                   else fast.encode_request)
        tiers = [('per-field (JuteWriter)', per_field),
                 ('single-pass (python)', fast_fn)]
        if ext is not None:
            tiers.append(('C extension',
                          ext.encode_response if server
                          else ext.encode_request))
        sample = dict(pkts[0])
        print('%s (%d B framed, %d frames):'
              % (shape, len(per_field(sample)), len(pkts)))
        for name, fn in tiers:
            assert fn(dict(pkts[0])) == per_field(dict(pkts[0])), \
                'tier %r diverges from the spec bytes' % (name,)
            mibs, us = measure_encode(fn, pkts, reps)
            print('  %-22s %8.1f MiB/s  (%.2f us/frame)'
                  % (name, mibs, us))


def run_ingress_profile(conns: int, reps: int,
                        payload: int = 512) -> None:
    """The receive-drain A/B: ``conns`` dirty sockets, every tier
    must surface the same bytes — per-connection stream reads vs the
    flat ``os.read`` loop vs the one-C-call batch drain."""
    import asyncio
    import os
    import socket

    pairs = [socket.socketpair() for _ in range(conns)]
    for a, b in pairs:
        a.setblocking(False)
        b.setblocking(False)
    fds = [a.fileno() for a, _b in pairs]
    blob = b'x' * payload

    def fill() -> None:
        for _a, b in pairs:
            b.send(blob)

    def t_osread() -> int:
        total = 0
        for fd in fds:
            total += len(os.read(fd, 65536))
        return total

    ext = native.ensure_ext()

    def t_drain() -> int:
        return sum(len(r) for r in ext.drain_recv(fds, 65536))

    tiers = [('os.read loop (python)', t_osread)]
    if ext is not None:
        tiers.append(('drain_recv (C, one call)', t_drain))
    else:
        print('C extension unavailable; skipping drain_recv tier')
    print('%d dirty connections, %d B pending each:'
          % (conns, payload))
    for name, fn in tiers:
        best = float('inf')
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(reps):
                fill()
                n = fn()
                assert n == conns * payload
            best = min(best, (time.perf_counter() - t0) / reps)
        print('  %-26s %8.1f us/drain  (%.3f us/conn)'
              % (name, best * 1e6, best * 1e6 / conns))
    # the stream tier: one pending task wakeup per connection — the
    # asyncio machinery the sharded drain deletes.  Fresh socketpairs
    # (the transports above own their fds).
    spairs = [socket.socketpair() for _ in range(conns)]

    async def stream_round() -> None:
        loop = asyncio.get_running_loop()
        readers = []
        transports = []
        for a, _b in spairs:
            a.setblocking(False)
            reader = asyncio.StreamReader()
            tr, _p = await loop.connect_accepted_socket(
                lambda r=reader: asyncio.StreamReaderProtocol(r),
                sock=a)
            readers.append(reader)
            transports.append(tr)
        best = float('inf')
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(reps):
                for _a, b in spairs:
                    b.send(blob)
                got = 0
                for r in readers:
                    while True:
                        got += len(await asyncio.wait_for(
                            r.read(65536), 5))
                        if got % payload == 0:
                            break
                assert got == conns * payload
            best = min(best, (time.perf_counter() - t0) / reps)
        print('  %-26s %8.1f us/drain  (%.3f us/conn)'
              % ('StreamReader (asyncio)', best * 1e6,
                 best * 1e6 / conns))
        for tr in transports:
            tr.close()

    asyncio.run(stream_round())
    for a, b in pairs + spairs:
        a.close()
        b.close()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument('--frames', type=int, default=2000)
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--encode', action='store_true',
                    help='profile the encode tiers instead of decode')
    ap.add_argument('--ingress', action='store_true',
                    help='profile the receive-drain tiers '
                         '(io/ingress.py) instead of decode')
    args = ap.parse_args(argv)

    if args.encode:
        run_encode_profile(args.frames, args.reps)
        return
    if args.ingress:
        run_ingress_profile(min(args.frames, 512), args.reps)
        return

    stream = mk_stream(args.frames)
    print('stream: %d frames, %d bytes' % (args.frames, len(stream)))

    tiers = [('framing-only (python)', tier_framing),
             ('full-decode (python)',
              lambda s, f: tier_codec(s, f, use_native=False))]
    if native.ensure_ext() is not None:
        tiers.append(('full-decode (C ext)',
                      lambda s, f: tier_codec(s, f, use_native=True)))
    else:
        print('C extension unavailable; skipping ext tier')

    for name, fn in tiers:
        mibs = measure(fn, stream, args.frames, args.reps)
        us = len(stream) / (mibs * (1 << 20)) / args.frames * 1e6
        print('%-22s %8.1f MiB/s  (%.2f us/frame)' % (name, mibs, us))

    print('\ncProfile of full-decode (python), top 12 by tottime:')
    pr = cProfile.Profile()
    pr.enable()
    for _ in range(args.reps):
        tier_codec(stream, args.frames, use_native=False)
    pr.disable()
    s = io.StringIO()
    pstats.Stats(pr, stream=s).sort_stats('tottime').print_stats(12)
    print('\n'.join(s.getvalue().splitlines()[4:22]))


if __name__ == '__main__':
    main()
