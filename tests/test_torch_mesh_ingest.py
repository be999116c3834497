"""The port's MeshFleetIngest and MultihostFleetIngest on 8 CPU shards.

First, behind the reference ``Client`` + ``ZKServer`` over real TCP:
the dp-sharded tick (``MeshFleetIngest(device='cpu')`` at dp=8) gives
the same observations as the port's single-device ingest and the scalar
drain, in both body modes, and its fleet max zxid equals the sessions'
checkpoints.  Second, with stand-in connections: the same chunks
through the JAX ``MeshFleetIngest`` and the port's deliver equal
packets, equal to a fresh scalar codec's.  Third, the fixed-cadence
``MultihostFleetIngest`` in one process, with its assembly-failure and
dispatch-failure cases (tests/test_mesh_ingest.py's).  No process group
is created here: the two-process run is tests/test_torch_multihost.py.
"""

from __future__ import annotations

import asyncio

import pytest
import torch

from helpers import wait_until
from test_ingest import _workload, make_client
from test_torch_ingest import (_cut, _device_fleet, _expected, _norm, _serve,
                               _streams)
from zkstream_tpu.parallel import MeshFleetIngest as RefMeshIngest
from zkstream_tpu.parallel import make_mesh as ref_make_mesh
from zkstream_tpu.protocol.framing import PacketCodec as RefCodec
from zkstream_tpu.server import ZKServer
from zkstream_tpu_torch.io.ingest import FleetIngest
from zkstream_tpu_torch.parallel import (MeshFleetIngest,
                                         MultihostFleetIngest, make_mesh)
from zkstream_tpu_torch.protocol.framing import PacketCodec

CPU8 = [torch.device('cpu')] * 8


def _mesh(dp=8):
    return make_mesh(dp=dp, devices=[torch.device('cpu')] * dp)


async def _observe(ingest, n_clients=1):
    """Run the full-op workload on client 0 of ``n_clients`` sharing
    ``ingest``; returns (observations, max session checkpoint)."""
    srv = await ZKServer().start()
    if ingest is not None:
        await ingest.prewarm(n_clients)
    cs = [make_client(srv.port, ingest=ingest) for _ in range(n_clients)]
    try:
        await asyncio.gather(*[c.wait_connected(timeout=10) for c in cs])
        obs = _norm(await _workload(cs[0]))
        for i, c in enumerate(cs[1:]):
            await c.create('/o%d' % i, b'x')
        return obs, max(c.session.last_zxid for c in cs)
    finally:
        await asyncio.gather(*[c.close() for c in cs])
        await srv.stop()


@pytest.mark.timeout(60)
@pytest.mark.parametrize('body_mode', ['host', 'device'])
async def test_mesh_ingest_matches_single_device_and_scalar(body_mode):
    kw = dict(body_mode=body_mode, max_frames=8, min_len=1024,
              warm='block', max_data=128, max_path=64)
    scalar, _z = await _observe(None)
    single = FleetIngest(device='cpu', bypass_bytes=0, **kw)
    one, _z = await _observe(single)
    mesh = MeshFleetIngest(mesh=_mesh(), device='cpu', **kw)
    assert mesh.bypass_bytes == 0 and mesh.frag_guard is False
    got, best = await _observe(mesh, n_clients=3)
    assert got == one == scalar
    assert mesh.ticks > 0 and mesh.ticks_warming == 0
    assert mesh.global_stats['total_frames'] > 0
    assert mesh.fleet_max_zxid == best


@pytest.mark.timeout(60)
async def test_mesh_ingest_serves_live_fleet():
    """16 live clients over the 8 shards (2 streams a shard): creates,
    gets and a 16-way watch fan-out through the sharded tick."""
    ingest = MeshFleetIngest(mesh=_mesh(), body_mode='host', max_frames=4,
                             min_len=1024, warm='block')
    srv = await ZKServer().start()
    await ingest.prewarm(16)
    clients = [make_client(srv.port, ingest=ingest, session_timeout=8000)
               for _ in range(16)]
    try:
        await asyncio.gather(*[c.wait_connected(timeout=10)
                               for c in clients])

        async def one(i, c):
            assert await c.create('/m%02d' % i, b'v%02d' % i) == '/m%02d' % i
            data, stat = await c.get('/m%02d' % i)
            assert data == b'v%02d' % i and stat.version == 0

        await asyncio.gather(*[one(i, c) for i, c in enumerate(clients)])
        fired = []
        for i, c in enumerate(clients):
            c.watcher('/sig').on('created',
                                 lambda *a, _i=i: fired.append(_i))
        await clients[0].create('/sig', b'')
        await wait_until(lambda: len(fired) >= 16, timeout=10)
        assert sorted(fired) == list(range(16))
        assert ingest.ticks > 0 and ingest.frames_routed >= 48
        assert ingest.fleet_max_zxid == max(c.session.last_zxid
                                            for c in clients)
    finally:
        await asyncio.gather(*[c.close() for c in clients])
        await srv.stop()


def _count_ticks(ing) -> list:
    """Record, per device tick, the fleet-global frame total beside the
    sum of the routed rows' frame counts."""
    seen = []
    unpack, route = ing._unpack, ing._route_stream

    def counted_unpack(ints, byts):
        out = unpack(ints, byts)
        seen.append([ing.global_stats['total_frames'], 0])
        return out

    def counted_route(conn, buf, st, bd, i):
        seen[-1][1] += int(st.n_frames[i])
        return route(conn, buf, st, bd, i)
    ing._unpack, ing._route_stream = counted_unpack, counted_route
    return seen


@pytest.mark.parametrize('max_frames', [4, 64])
async def test_mesh_ingest_matches_jax_mesh_ingest(max_frames):
    """Stand-in connections, host bodies: the port's and the JAX
    package's mesh ingests deliver the scalar drain's packets; the
    port's per-tick global total equals the frames of the rows it
    routed, and its fleet max the largest reply zxid delivered."""
    streams, maps = _streams(5)
    chunks = _cut(streams, 5)
    want = _expected(chunks, maps)
    port = MeshFleetIngest(mesh=_mesh(), device='cpu',
                           max_frames=max_frames, warm='block')
    ticks = _count_ticks(port)
    got = await _serve(port, PacketCodec, chunks, maps)
    ref = RefMeshIngest(mesh=ref_make_mesh(dp=8), max_frames=max_frames,
                        warm='block')
    ref_got = await _serve(ref, RefCodec, chunks, maps, use_native=False)
    assert got == want and ref_got == want
    assert want[-1][1] == 'BAD_LENGTH'
    assert ticks and all(t == r for t, r in ticks)
    assert port.ticks == len(ticks)
    best = max(p['zxid'] for pkts, _c in want for p in pkts if p['xid'] >= 0)
    assert port.fleet_max_zxid == ref.fleet_max_zxid == best


@pytest.mark.timeout(120)
async def test_mesh_device_ingest_matches_jax_mesh_ingest():
    """Device bodies (the K2 plain version and the torch body parse on
    every shard) against the JAX mesh ingest and the scalar drain."""
    streams, maps = _device_fleet(2)
    chunks = _cut(streams, 2)
    want = _expected(chunks, maps)
    kw = dict(body_mode='device', max_frames=16, min_len=4096, max_data=64,
              max_path=32, max_children=6, max_name=12, max_acls=2,
              max_scheme=8, max_id=32, warm='block')
    port = MeshFleetIngest(mesh=_mesh(), device='cpu', **kw)
    got = await _serve(port, PacketCodec, chunks, maps)
    ref = RefMeshIngest(mesh=ref_make_mesh(dp=8), **kw)
    ref_got = await _serve(ref, RefCodec, chunks, maps, use_native=False)
    assert got == want and ref_got == want
    assert port.body_fallbacks == ref.body_fallbacks > 0
    assert port.global_stats == ref.global_stats


def test_mesh_bucket_divides_over_dp_and_metrics():
    from zkstream_tpu.utils.metrics import Collector as RefCollector
    from zkstream_tpu_torch.utils.metrics import Collector

    ing = MeshFleetIngest(mesh=_mesh(3), device='cpu')
    Bp, L = ing._bucket(5, 100)
    assert Bp % 3 == 0 and Bp >= 8 and L == 256
    bk = ing._warm_bucket((Bp, L))
    assert len(bk.shards) == 3 and all(b.shape == (Bp // 3, L)
                                       for b, _n in bk.shards)
    port, ref = Collector(), RefCollector()
    ing.bind_metrics(port)
    RefMeshIngest(mesh=ref_make_mesh(dp=8)).bind_metrics(ref)
    assert sorted(port._gauges) == sorted(ref._gauges)
    assert 'zkstream_fleet_max_zxid 0' in port.expose()
    with pytest.raises(ValueError, match='match'):
        MeshFleetIngest(mesh=_mesh(), device='cuda')


def test_mesh_ingest_default_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default mesh is valid')
    with pytest.raises(RuntimeError, match='CUDA'):
        MeshFleetIngest()
    with pytest.raises(RuntimeError, match='CUDA'):
        MultihostFleetIngest()


def test_dryrun_multichip_on_cpu_shards():
    from zkstream_tpu_torch.entry import dryrun_multichip

    out = dryrun_multichip(4, device='cpu')
    assert out['frames'] > 0 and out['roundtripped'] == 1024 * 8
    # 8 live clients x (create + get), 4 through the cadence proxy (a
    # keepalive ping reply may ride along)
    assert out['served'] >= 16 and out['cadence_served'] >= 8
    assert out['fleet_max_zxid'] == 8
    with pytest.raises(ValueError):
        dryrun_multichip(4, devices=CPU8)


def _proxy(**kw):
    return MultihostFleetIngest(mesh=_mesh(), device='cpu', local_rows=8,
                                stream_len=2048, tick_interval=0.005,
                                body_mode='host', max_frames=4, **kw)


@pytest.mark.timeout(75)
async def test_multihost_fleet_ingest_single_process():
    """The fixed-cadence proxy in one process: live connections served
    by timer-driven fixed-shape ticks, with carry-over past
    ``stream_len`` and capacity enforcement."""
    proxy = _proxy()
    with pytest.raises(ValueError, match='divide'):
        MultihostFleetIngest(mesh=_mesh(), device='cpu', local_rows=6)
    srv = await ZKServer().start()
    proxy.warmup_tick()
    clients = [make_client(srv.port, ingest=proxy, session_timeout=8000)
               for _ in range(8)]
    try:
        proxy.start()
        await asyncio.gather(*[c.wait_connected(timeout=10)
                               for c in clients])
        for i, c in enumerate(clients):
            assert await c.create('/h%d' % i, b'x%d' % i) == '/h%d' % i
        datas = await asyncio.gather(*[c.get('/h%d' % i)
                                       for i, c in enumerate(clients)])
        assert [d for d, _s in datas] == [b'x%d' % i for i in range(8)]
        assert proxy.ticks > 0
        assert proxy.global_stats['total_frames'] >= 0
        assert proxy.fleet_max_zxid == max(c.session.last_zxid
                                           for c in clients)
        # a reply larger than stream_len escapes to the scalar drain
        await clients[0].create('/big', b'z' * 4000)
        data, _stat = await clients[0].get('/big')
        assert data == b'z' * 4000
        # capacity is static: a 9th connection is scalar-drained
        extra = make_client(srv.port, ingest=proxy, session_timeout=5000)
        await extra.wait_connected(timeout=10)
        assert await extra.create('/overflow', b'ok') == '/overflow'
        await extra.close()
        with pytest.raises(NotImplementedError):
            await proxy.prewarm(8)
    finally:
        stop_at = proxy.tick_count + 1
        await proxy.stop(after_ticks=stop_at)
        assert proxy.launch_count == proxy.tick_count == stop_at
        with pytest.raises(RuntimeError, match='already ran'):
            proxy.start()
            await asyncio.sleep(0.05)
            await proxy.stop(after_ticks=1)
        await proxy.stop()
        await asyncio.gather(*[c.close() for c in clients])
        await srv.stop()


@pytest.mark.timeout(75)
async def test_multihost_assembly_failure_keeps_launches_aligned():
    """A host-side error before the dispatch falls back to an empty
    aligned launch; the buffered bytes survive and the next healthy
    tick delivers them."""
    proxy = _proxy()
    srv = await ZKServer().start()
    proxy.warmup_tick()
    clients = [make_client(srv.port, ingest=proxy, session_timeout=8000)
               for _ in range(4)]
    try:
        proxy.start()
        await asyncio.gather(*[c.wait_connected(timeout=10)
                               for c in clients])
        await clients[0].create('/af', b'v')
        fail = {'n': 3}
        orig = proxy._assemble_tick

        def boom():
            if fail['n'] > 0:
                fail['n'] -= 1
                raise RuntimeError('injected assembly failure')
            return orig()
        proxy._assemble_tick = boom
        datas = await asyncio.gather(*[c.get('/af') for c in clients])
        assert [d for d, _s in datas] == [b'v'] * 4
        assert fail['n'] == 0, 'injection never exercised'
        assert proxy.launch_count == proxy.tick_count
    finally:
        await proxy.stop(after_ticks=proxy.tick_count + 1)
        await asyncio.gather(*[c.close() for c in clients])
        await srv.stop()


@pytest.mark.timeout(75)
async def test_multihost_dispatch_failure_detected_loudly():
    """A failed dispatch breaks the launch alignment; the cadence
    survives and ``stop`` reports the divergence."""
    proxy = _proxy()
    srv = await ZKServer().start()
    proxy.warmup_tick()
    clients = [make_client(srv.port, ingest=proxy, session_timeout=8000)
               for _ in range(2)]
    try:
        proxy.start()
        await asyncio.gather(*[c.wait_connected(timeout=10)
                               for c in clients])
        await clients[0].create('/df', b'v')
        real_fn = proxy._fns[False]
        fail = {'n': 1}

        def bad_fn(*a, **k):
            if fail['n'] > 0:
                fail['n'] -= 1
                raise RuntimeError('injected dispatch failure')
            return real_fn(*a, **k)
        proxy._fns[False] = bad_fn
        data, _ = await clients[1].get('/df')
        assert data == b'v' and fail['n'] == 0
        assert proxy.launch_count < proxy.tick_count
        with pytest.raises(RuntimeError, match='launch divergence'):
            await proxy.stop(after_ticks=proxy.tick_count + 1)
    finally:
        if proxy._timer is not None:
            proxy._timer.cancel()
            proxy._timer = None
        await asyncio.gather(*[c.close() for c in clients])
        await srv.stop()


async def test_multihost_device_bodies_with_stand_ins():
    """Device bodies on the cadence: the stand-in streams come out as
    the scalar drain delivers them, and every tick launched."""
    streams, maps = _device_fleet(4, n_streams=8)
    chunks = _cut(streams, 4)
    want = _expected(chunks, maps)
    proxy = MultihostFleetIngest(
        mesh=_mesh(), device='cpu', local_rows=8, stream_len=4096,
        body_mode='device', max_frames=16, max_data=64, max_path=32,
        max_children=6, max_name=12, max_acls=2, max_scheme=8, max_id=32)
    proxy.warmup_tick()
    proxy.start()
    got = await _serve(proxy, PacketCodec, chunks, maps)
    await proxy.stop(after_ticks=proxy.tick_count + 1)
    assert got == want and proxy.ticks > 0
    assert proxy.launch_count == proxy.tick_count
    assert proxy.body_fallbacks > 0
