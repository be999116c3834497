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
    and totals, the roundtrip and the sp scan, then serves small fleets
    of live clients (``Client``) against an in-process ``ZKServer`` through
    ``MeshFleetIngest`` and ``MultihostFleetIngest``, each fleet max
    equal to the sessions' largest zxid.  Returns the counts it checked.
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

    # the runtime consumers: a LIVE connection fleet served through
    # the mesh-sharded tick (MeshFleetIngest) and through the
    # fixed-cadence multihost proxy (MultihostFleetIngest, single
    # process), each against the in-process server with the collective
    # reductions checked against the sessions' scalar-side checkpoints
    fleet_mesh = make_mesh(dp=n_devices, sp=1, devices=devices)
    served, fleet_zxid = _dryrun_live_mesh_fleet(fleet_mesh)
    cadence_served = _dryrun_cadence_fleet(fleet_mesh)
    print(f'dryrun_multichip({n_devices}): mesh dp={dp} sp={sp} on '
          f'{[str(d) for d in devices]} OK — {total} frames dp-decoded over '
          f'{B} streams (bit-equal to single-device), {int(rtotal)} '
          f'roundtripped, {int(nframes)} frames sp-scanned, live fleet: '
          f'{served} frames served, fleet max zxid {fleet_zxid}, cadence '
          f'proxy: {cadence_served} frames served')
    return {'frames': total, 'roundtripped': int(rtotal),
            'sp_frames': int(nframes), 'served': served,
            'fleet_max_zxid': fleet_zxid, 'cadence_served': cadence_served}


def _dryrun_live_mesh_fleet(mesh):
    """Serve a small live client fleet through ``MeshFleetIngest`` on
    ``mesh``; returns ``(frames_served, fleet_max_zxid)``."""
    from .client import Client
    from .parallel import MeshFleetIngest
    from .server import ZKServer

    async def run():
        ingest = MeshFleetIngest(mesh=mesh, body_mode='host',
                                 max_frames=4, min_len=1024,
                                 warm='block')
        srv = await ZKServer().start()
        await ingest.prewarm(8)
        clients = [Client(address='127.0.0.1', port=srv.port,
                          ingest=ingest, session_timeout=8000)
                   for _ in range(8)]
        for c in clients:
            c.start()
        try:
            await asyncio.gather(*[c.wait_connected(timeout=10)
                                   for c in clients])
            for i, c in enumerate(clients):
                await c.create('/d%d' % i, b'x%d' % i)
            for i, c in enumerate(clients):
                data, _stat = await c.get('/d%d' % i)
                assert data == b'x%d' % i
            assert ingest.ticks > 0 and ingest.ticks_warming == 0
            assert ingest.fleet_max_zxid == max(
                c.session.last_zxid for c in clients), \
                'fleet pmax != session checkpoints'
            return ingest.frames_routed, ingest.fleet_max_zxid
        finally:
            await asyncio.gather(*[c.close() for c in clients])
            await srv.stop()

    return asyncio.run(run())


def _dryrun_cadence_fleet(mesh) -> int:
    """One pass of the multi-controller fleet proxy (single-process
    degenerate: the same fixed-cadence collective tick, process count
    1); returns frames served."""
    from .client import Client
    from .parallel import MultihostFleetIngest
    from .server import ZKServer

    async def run():
        dp = mesh.shape['dp']
        # capacity must divide over the dp axis whatever n is
        rows = ((max(8, dp) + dp - 1) // dp) * dp
        proxy = MultihostFleetIngest(
            mesh=mesh, local_rows=rows, stream_len=2048,
            tick_interval=0.005, body_mode='host', max_frames=4)
        srv = await ZKServer().start()
        proxy.warmup_tick()
        clients = [Client(address='127.0.0.1', port=srv.port,
                          ingest=proxy, session_timeout=8000)
                   for _ in range(4)]
        for c in clients:
            c.start()
        proxy.start()
        try:
            await asyncio.gather(*[c.wait_connected(timeout=10)
                                   for c in clients])
            for i, c in enumerate(clients):
                await c.create('/cad%d' % i, b'y%d' % i)
            for i, c in enumerate(clients):
                data, _stat = await c.get('/cad%d' % i)
                assert data == b'y%d' % i
            assert proxy.ticks > 0
            assert proxy.fleet_max_zxid == max(
                c.session.last_zxid for c in clients)
            return proxy.frames_routed
        finally:
            await proxy.stop()
            await asyncio.gather(*[c.close() for c in clients])
            await srv.stop()

    return asyncio.run(run())
