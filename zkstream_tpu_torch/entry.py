"""Entry points of the port: the receive tick decode and the mesh dry run.

``entry()`` returns ``(fn, args)``: ``fn`` is
:func:`~zkstream_tpu_torch.ops.pipeline.wire_pipeline_step_auto` with
``max_frames=64`` (kernel K1 on a CUDA device), and ``args`` is an
example batch of framed reply streams already on the device.

``dryrun_multichip(n)`` validates the full sharded step over an
n-shard mesh: the dp-sharded decode with its sum/max reductions, the
encode->decode roundtrip, the sequence-parallel scan with its cursor
ring, and a small live fleet served through ``MeshFleetIngest`` and
``MultihostFleetIngest``.  The port of ``__graft_entry__.py``'s.
"""

from __future__ import annotations

import asyncio
import functools
import struct

import numpy as np


def _example_batch(B=64, L=2048, seed=0):
    """Deterministic synthetic reply streams: B rows of framed reply
    packets (16-byte header + small body) padded to L bytes."""
    rng = np.random.RandomState(seed)
    buf = np.zeros((B, L), np.uint8)
    lens = np.zeros((B,), np.int32)
    for i in range(B):
        s = b''
        while len(s) < L - 64:
            xid = int(rng.randint(1, 1 << 20))
            zxid = int(rng.randint(1, 1 << 40))
            body = bytes(rng.randint(0, 256, rng.randint(0, 40),
                                     dtype=np.uint8))
            hdr = struct.pack('>iqi', xid, zxid, 0)
            s += struct.pack('>i', len(hdr) + len(body)) + hdr + body
        buf[i, :len(s)] = np.frombuffer(s, np.uint8)
        lens[i] = len(s)
    return buf, lens


def entry(device='cuda'):
    """Return ``(fn, args)``: the tick decode and an example batch on
    ``device`` (raises when ``'cuda'`` is asked for and absent)."""
    from .ops.pipeline import batch_to_device, wire_pipeline_step_auto

    buf, lens = _example_batch()
    args = batch_to_device(buf, lens, device)
    return functools.partial(wire_pipeline_step_auto, max_frames=64), args


def dryrun_multichip(n_devices: int, device='cuda', devices=None) -> dict:
    """Execute one full sharded step on an n-shard mesh and check it.

    The mesh is ``devices`` (n of them, repeats allowed) or, by default,
    n devices of type ``device``: ``'cuda'`` needs n CUDA devices and
    raises otherwise (pass ``devices=`` to put several shards on one
    card); ``'cpu'`` runs the plain versions.  Checks that the
    dp-sharded step is bit-equal to the single-device step, the u64 max
    and totals, the roundtrip and the sp scan, then serves a small fleet
    of stand-in connections through ``MeshFleetIngest`` and
    ``MultihostFleetIngest``.  Returns the counts it checked.
    """
    import torch

    from .ops.bytesops import u64pair_reduce_max
    from .ops.pipeline import (batch_to_device, resolve_device,
                               wire_pipeline_step_auto)
    from .parallel import (make_mesh, seq_parallel_frame_scan,
                           sharded_wire_roundtrip, sharded_wire_step)

    if devices is None:
        dev = resolve_device(device)
        if dev.type == 'cuda':
            if torch.cuda.device_count() < n_devices:
                raise RuntimeError(
                    'dryrun_multichip(%d) needs %d CUDA devices, found %d; '
                    'pass devices= to put several shards on one card'
                    % (n_devices, n_devices, torch.cuda.device_count()))
            devices = [torch.device('cuda', i) for i in range(n_devices)]
        else:
            devices = [dev] * n_devices
    if len(devices) != n_devices:
        raise ValueError('%d devices given for %d shards'
                         % (len(devices), n_devices))
    sp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    dp = n_devices // sp
    mesh = make_mesh(dp=dp, sp=sp, devices=devices)
    first = mesh.first

    # dp-sharded fleet decode at fleet scale (>= 1024 streams), rounded
    # up to a multiple of dp, checked BIT-EQUAL against the single-device
    # step: sharding is an execution layout, never a semantics change
    B = dp * max(256, -(-1024 // dp))
    buf, lens = batch_to_device(*_example_batch(B=B, L=512, seed=1), first)
    stats, g = sharded_wire_step(mesh, max_frames=32)(buf, lens)
    total = int(g.total_frames)
    assert total > 0, 'dp-sharded decode produced no frames'
    assert total == int(stats.n_frames.sum())
    ref = wire_pipeline_step_auto(buf, lens, max_frames=32)
    mismatches = [f for f in stats._fields
                  if not torch.equal(getattr(stats, f), getattr(ref, f))]
    assert not mismatches, (
        f'sharded != single-device WireStats: {mismatches}')
    rh, rl = u64pair_reduce_max(ref.max_zxid_hi, ref.max_zxid_lo)
    assert (int(g.max_zxid_hi), int(g.max_zxid_lo)) == (int(rh), int(rl)), \
        'global max-zxid reduction mismatch'
    assert int(g.total_notifications) == int(ref.n_notifications.sum())
    assert int(g.total_errors) == int(ref.n_errors.sum())

    # dp-sharded encode->decode roundtrip
    F = 8
    rng = np.random.RandomState(3)

    def mk(lo, hi):
        return torch.from_numpy(
            rng.randint(lo, hi, (B, F)).astype(np.int32)).to(first)
    rt = sharded_wire_roundtrip(mesh, max_frames=F, out_len=512)
    _rstats, rtotal = rt(mk(1, 1 << 20), mk(0, 1 << 16), mk(0, 1 << 20),
                         torch.zeros((B, F), dtype=torch.int32,
                                     device=first), mk(16, 48))
    assert int(rtotal) == B * F, 'roundtrip lost frames'

    # sp-sharded single-stream scan with the cursor ring
    sp_mesh = make_mesh(dp=1, sp=n_devices, devices=devices)
    one, one_len = _example_batch(B=1, L=n_devices * 256, seed=2)
    is_start, nframes, bad = seq_parallel_frame_scan(sp_mesh)(
        torch.from_numpy(one[0]).to(first), int(one_len[0]))
    assert int(nframes) > 0 and not bool(bad)

    # the runtime consumers: a live stand-in fleet through the
    # mesh-sharded tick and through the fixed-cadence multihost proxy
    # (single process), every packet equal to the scalar drain's and
    # the fleet max equal to the largest reply zxid delivered
    fleet_mesh = make_mesh(dp=n_devices, sp=1, devices=devices)
    served, fleet_zxid = _dryrun_fleet(fleet_mesh, cadence=False)
    cadence_served, _z = _dryrun_fleet(fleet_mesh, cadence=True)
    print(f'dryrun_multichip({n_devices}): mesh dp={dp} sp={sp} on '
          f'{[str(d) for d in devices]} OK — {total} frames dp-decoded over '
          f'{B} streams (bit-equal to single-device), {int(rtotal)} '
          f'roundtripped, {int(nframes)} frames sp-scanned, live fleet: '
          f'{served} frames served, fleet max zxid {fleet_zxid}, cadence '
          f'proxy: {cadence_served} frames served')
    return {'frames': total, 'roundtripped': int(rtotal),
            'sp_frames': int(nframes), 'served': served,
            'fleet_max_zxid': fleet_zxid, 'cadence_served': cadence_served}


class _StandIn:
    """A connection as the fleet ingest sees it: a codec, a state and
    the ``ingestDeliver`` event (the port has no client stack yet)."""

    def __init__(self, codec):
        self.codec = codec
        self.got: list = []
        self.err = None

    def is_in_state(self, state: str) -> bool:
        return state == 'connected' and self.err is None

    def emit(self, event: str, pkts, err) -> None:
        assert event == 'ingestDeliver', event
        self.got.extend(pkts)
        if err is not None:
            self.err = err


def _dryrun_fleet(mesh, cadence: bool):
    """Serve 12 corpus streams, fed in two halves, through
    ``MeshFleetIngest`` (``cadence=False``) or ``MultihostFleetIngest``
    on ``mesh``; returns ``(frames served, fleet max zxid)``."""
    from .corpus import fleet
    from .parallel import MeshFleetIngest, MultihostFleetIngest
    from .protocol.framing import PacketCodec

    buf, _lens, _slots, maps = fleet(B=12, seed=3, frames=16)
    streams = [r.tobytes() for r in buf]

    def codec(m):
        c = PacketCodec(use_native=False)
        c.handshaking = False
        c.xid_map.update(m)
        return c

    want = [codec(m).decode(s) for s, m in zip(streams, maps)]
    conns = [_StandIn(codec(m)) for m in maps]
    dp = mesh.shape['dp']
    if cadence:
        ing = MultihostFleetIngest(
            mesh=mesh, local_rows=-(-len(conns) // dp) * dp,
            stream_len=4096, tick_interval=0.005, body_mode='host',
            max_frames=4)
    else:
        ing = MeshFleetIngest(mesh=mesh, body_mode='host', max_frames=4,
                              min_len=1024, warm='block')

    async def run():
        if cadence:
            ing.warmup_tick()
            ing.start()
        for c in conns:
            ing.register(c)
        for half in (0, 1):
            for c, s in zip(conns, streams):
                cut = len(s) // 2
                ing.feed(c, s[:cut] if half == 0 else s[cut:])
            await asyncio.sleep(0)
        loop = asyncio.get_running_loop()
        deadline = loop.time() + 60.0
        while (getattr(ing, '_scheduled', False)
               or any(b for _c, b in ing._slots.values())):
            assert loop.time() < deadline, 'fleet did not drain'
            await asyncio.sleep(0.001)
        if cadence:
            await ing.stop(after_ticks=ing.tick_count + 1)
            assert ing.launch_count == ing.tick_count

    asyncio.run(run())
    for c, w in zip(conns, want):
        assert c.err is None and c.got == w, 'mesh ingest != scalar drain'
    assert ing.ticks > 0 and ing.ticks_scalar == 0
    best = max(p['zxid'] for c in conns for p in c.got if p['xid'] >= 0)
    assert ing.fleet_max_zxid == best, 'fleet max != delivered max'
    return ing.frames_routed, ing.fleet_max_zxid
