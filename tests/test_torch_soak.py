"""The port of tests/test_soak.py, with the port's clients and ingests (on
the CPU); every case on an in-process server or ensemble runs twice, on
the port's and on the JAX package's, with the port's clients.

Chaos soak: sustained random ops under repeated connection murder.

The reference's value is production resilience (session resumption,
exactly-once request failure, watcher re-arm) — the targeted tests
prove each mechanism in isolation; this proves them *composed*, under
sustained fire, with the invariants that actually matter in a long-
running process:

- no unhandled exceptions reach the event loop (every teardown path
  routes errors to its request/session owner);
- every client ends the storm connected (or resumed) and usable;
- no pending-request entry outlives the storm (fail-pending-
  exactly-once really fails them all);
- the process's task set returns to baseline (no leaked asyncio tasks).

Bounded: ~8 s of chaos per variant inside a 75 s per-test budget (the
ingest variants add XLA warm-up on this single-core host).
"""

from __future__ import annotations

import asyncio
import random

import pytest

from zkstream_tpu_torch import Client, CreateFlag, ZKError
from zkstream_tpu_torch.io.ingest import FleetIngest
from zkstream_tpu_torch.protocol.errors import (
    ZKNotConnectedError,
    ZKPingTimeoutError,
    ZKProtocolError,
)
from test_torch_basic import ensemble_cls, server, server_cls  # noqa: F401

N_CLIENTS = 10
CHAOS_SECONDS = 8.0

#: Errors an op may legitimately surface while its connection is being
#: murdered mid-flight.
EXPECTED = (ZKError, ZKNotConnectedError, ZKProtocolError,
            ZKPingTimeoutError, asyncio.TimeoutError)

#: Ingest configurations the soaks run under: the
#: batched drain has the most novel failure surface (mid-tick
#: teardown, take/restore_pending hand-off, bad-frame fallback,
#: background-warm scalar deferral), so it soaks in both body modes
#: with the bypass both disabled and at its production default.
def _ingest_variants():
    return {
        'scalar': lambda: None,
        'ingest-host': lambda: FleetIngest(
            device='cpu', body_mode='host', max_frames=8, bypass_bytes=0,
            min_len=1024),
        # narrow device planes: the soak exercises lifecycle, not
        # decode width, and the smaller program compiles ~3x faster
        # (its background compiles would otherwise bleed core time
        # into the following tests on this single-core host)
        'ingest-device': lambda: FleetIngest(
            device='cpu', body_mode='device', max_frames=8, bypass_bytes=0,
            min_len=1024, max_data=64, max_path=32, max_children=4,
            max_name=16, max_acls=2, max_scheme=8, max_id=16),
        'ingest-bypass': lambda: FleetIngest(
            device='cpu', body_mode='host', max_frames=8),  # default bypass
        'ingest-mesh': _mesh_variant,  # dp-sharded tick under fire
    }


def _mesh_variant():
    import torch

    from zkstream_tpu_torch.parallel import MeshFleetIngest, make_mesh

    return MeshFleetIngest(
        mesh=make_mesh(dp=8, devices=[torch.device('cpu')] * 8),
        device='cpu', body_mode='host', max_frames=8, min_len=1024)


async def _prewarm(ingest: FleetIngest | None) -> None:
    """Compile the buckets the soak's fleet will hit (warm stays
    'background': a mid-soak miss must drain scalar, never block —
    that path is part of what the soak exercises)."""
    if ingest is None:
        return
    for n in (4, N_CLIENTS):
        await ingest.prewarm(n)


@pytest.mark.timeout(75)
@pytest.mark.parametrize('variant', list(_ingest_variants()))
async def test_chaos_soak(variant, server_cls):
    ingest = _ingest_variants()[variant]()
    loop = asyncio.get_event_loop()
    unhandled: list = []
    loop.set_exception_handler(
        lambda l, ctx: unhandled.append(ctx))

    baseline_tasks = len(asyncio.all_tasks(loop))
    srv = await server_cls().start()
    await _prewarm(ingest)
    clients = [Client(address='127.0.0.1', port=srv.port,
                      session_timeout=8000, ingest=ingest)
               for _ in range(N_CLIENTS)]
    for c in clients:
        c.start()
    await asyncio.gather(*[c.wait_connected(timeout=10)
                           for c in clients])

    stats = {'ops': 0, 'errors': 0, 'kills': 0, 'watch_fires': 0}
    stop = loop.time() + CHAOS_SECONDS

    # a watcher per client on a shared path, firing throughout
    for c in clients:
        c.watcher('/shared').on(
            'dataChanged', lambda *a: stats.__setitem__(
                'watch_fires', stats['watch_fires'] + 1))
    await clients[0].create('/shared', b'0')

    async def worker(i: int, c: Client):
        rng = random.Random(1000 + i)
        seq = 0
        while loop.time() < stop:
            try:
                op = rng.randrange(6)
                if op == 0:
                    seq += 1
                    await c.create('/c%d-%d' % (i, seq), b'x')
                elif op == 1:
                    await c.set('/shared', b'v%d' % seq)
                elif op == 2:
                    await c.get('/shared')
                elif op == 3:
                    await c.list('/')
                elif op == 4:
                    await c.stat('/shared')
                else:
                    await c.delete('/c%d-%d' % (i, seq), -1)
                stats['ops'] += 1
            except EXPECTED:
                stats['errors'] += 1
                await asyncio.sleep(0.05)
            await asyncio.sleep(rng.uniform(0, 0.01))

    async def chaos():
        rng = random.Random(4242)
        while loop.time() < stop:
            await asyncio.sleep(rng.uniform(0.25, 0.6))
            victim = rng.choice(clients)
            sess = victim.session
            conn = sess.get_connection() if sess else None
            if conn is not None and conn.transport is not None:
                conn.transport.abort()
                stats['kills'] += 1

    await asyncio.gather(chaos(),
                         *[worker(i, c) for i, c in enumerate(clients)])

    # -- invariants --
    # every client converges back to usable within the session timeout
    for c in clients:
        await c.wait_connected(timeout=10)
        data, _stat = await c.get('/shared')
        assert data.startswith(b'v') or data == b'0'
        conn = c.session.get_connection()
        # no pending-request entry survived its connection's death:
        # whatever is in-flight now belongs to the live connection only
        for xid, req in list(conn.reqs.items()):
            assert xid in conn.codec.xid_map or xid < 0

    assert stats['kills'] >= 5, stats
    assert stats['ops'] > 50, stats

    await asyncio.gather(*[c.close() for c in clients])
    await srv.stop()
    await asyncio.sleep(0.2)  # let teardown callbacks drain

    # the loop saw no unhandled exceptions through the whole storm
    assert unhandled == [], unhandled[:3]
    # no task leak: back to the baseline (the harness's own tasks)
    leaked = [t for t in asyncio.all_tasks(loop)
              if not t.done()]
    assert len(leaked) <= baseline_tasks + 1, leaked


@pytest.mark.timeout(75)
@pytest.mark.parametrize('variant', ['scalar', 'ingest-host'])
async def test_chaos_soak_ensemble(variant, ensemble_cls):
    """The failover composition under fire: clients spread over a
    3-member ensemble while backends are killed and restarted (never
    all at once). Sessions must migrate/resume, an ephemeral node must
    survive every kill its owner outlives, and the same global
    invariants hold (no unhandled loop exceptions, no task leak) —
    including with the fleet's receive path on the batched drain."""
    ingest = _ingest_variants()[variant]()
    loop = asyncio.get_event_loop()
    unhandled: list = []
    loop.set_exception_handler(lambda l, ctx: unhandled.append(ctx))
    baseline_tasks = len(asyncio.all_tasks(loop))

    ens = await ensemble_cls(3).start()
    await _prewarm(ingest)
    clients = [Client(servers=ens.addresses(), session_timeout=8000,
                      ingest=ingest)
               for _ in range(6)]
    for c in clients:
        c.start()
    await asyncio.gather(*[c.wait_connected(timeout=10)
                           for c in clients])

    # an ephemeral node owned by clients[0] must ride out every kill
    await clients[0].create('/eph', b'mine', flags=CreateFlag.EPHEMERAL)

    stats = {'ops': 0, 'errors': 0, 'kills': 0}
    stop = loop.time() + CHAOS_SECONDS

    async def worker(i: int, c: Client):
        rng = random.Random(2000 + i)
        seq = 0
        while loop.time() < stop:
            try:
                op = rng.randrange(4)
                if op == 0:
                    seq += 1
                    await c.create('/e%d-%d' % (i, seq), b'x')
                elif op == 1:
                    await c.stat('/eph')
                elif op == 2:
                    await c.list('/')
                else:
                    await c.get('/eph')
                stats['ops'] += 1
            except EXPECTED:
                stats['errors'] += 1
                await asyncio.sleep(0.05)
            await asyncio.sleep(rng.uniform(0, 0.01))

    async def chaos():
        rng = random.Random(777)
        down: int | None = None
        while loop.time() < stop:
            await asyncio.sleep(rng.uniform(0.8, 1.4))
            if down is not None:
                await ens.restart(down)
                down = None
                continue
            down = rng.randrange(3)
            await ens.kill(down)
            stats['kills'] += 1
        if down is not None:
            await ens.restart(down)

    await asyncio.gather(chaos(),
                         *[worker(i, c) for i, c in enumerate(clients)])

    for c in clients:
        await c.wait_connected(timeout=10)
    # the ephemeral's owner never expired, so the node must still exist
    data, _stat = await clients[1].get('/eph')
    assert data == b'mine'
    assert stats['kills'] >= 2, stats
    assert stats['ops'] > 30, stats

    await asyncio.gather(*[c.close() for c in clients])
    await ens.stop()
    await asyncio.sleep(0.2)

    assert unhandled == [], unhandled[:3]
    leaked = [t for t in asyncio.all_tasks(loop) if not t.done()]
    assert len(leaked) <= baseline_tasks + 1, leaked
