"""Watcher-engine integration tests of the port's ``Client``: the port
of tests/test_watchers.py (the reference's watcher sequences in
test/basic.test.js:644-981), each on the port's server and on the JAX
package's; the lagging-follower case on both packages'
``ZKEnsemble``."""

import asyncio

import pytest

from helpers import wait_until
from zkstream_tpu_torch import Client
from test_torch_basic import ensemble_cls, server, server_cls  # noqa: F401


@pytest.fixture
def two_clients(event_loop, server):
    async def setup():
        cs = []
        for _ in range(2):
            c = Client(address='127.0.0.1', port=server.port,
                       session_timeout=5000)
            c.start()
            await c.wait_connected(timeout=5)
            cs.append(c)
        return cs
    cs = event_loop.run_until_complete(setup())
    yield cs
    for c in cs:
        event_loop.run_until_complete(c.close())


async def test_data_watcher_cross_client(two_clients):
    c1, c2 = two_clients
    await c1.create('/foo', b'hi there')
    seen = []
    c1.watcher('/foo').on('dataChanged',
                          lambda data, stat: seen.append(bytes(data)))
    await wait_until(lambda: seen == [b'hi there'])
    await c2.set('/foo', b'hi')
    await wait_until(lambda: seen == [b'hi there', b'hi'])


async def test_delete_while_watching(two_clients):
    c1, c2 = two_clients
    await c1.create('/dw', b'x')
    deleted = []
    c1.watcher('/dw').on('deleted', lambda *a: deleted.append(True))
    stat = await c1.stat('/dw')
    await c1.delete('/dw', stat.version)
    await wait_until(lambda: deleted == [True])


async def test_delete_while_watching_data(two_clients):
    # dataChanged fires exactly once (the initial arm), then deleted
    # (reference: basic.test.js:728-771).
    c1, _ = two_clients
    await c1.create('/foobar', b'hi')
    dw_fired = []
    done = []
    w = c1.watcher('/foobar')
    w.on('dataChanged', lambda data, stat: dw_fired.append(1))
    w.on('deleted', lambda *a: done.append(len(dw_fired)))
    await wait_until(lambda: len(dw_fired) == 1)
    stat = await c1.stat('/foobar')
    await c1.delete('/foobar', stat.version)
    await wait_until(lambda: bool(done))
    assert done[0] == 1


async def test_children_watcher_sequence(two_clients):
    # Children changes arrive with monotonically increasing cversion
    # (reference: basic.test.js:764-810).
    c1, c2 = two_clients
    await c1.create('/kids', b'')
    snaps = []
    c1.watcher('/kids').on(
        'childrenChanged',
        lambda kids, stat: snaps.append((sorted(kids), stat.cversion)))
    await wait_until(lambda: len(snaps) == 1)
    await c2.create('/kids/a', b'')
    await wait_until(lambda: len(snaps) >= 2)
    await c2.create('/kids/b', b'')
    await wait_until(lambda: len(snaps) >= 3)
    await c2.delete('/kids/a', -1)
    await wait_until(lambda: any(s[0] == ['b'] for s in snaps))
    cversions = [s[1] for s in snaps]
    assert cversions == sorted(cversions)
    assert snaps[0][0] == []


async def test_children_watcher_no_node_parks(two_clients):
    # A children watch on a missing node parks in wait_node until the
    # node is created (reference: basic.test.js:812-870).
    c1, c2 = two_clients
    snaps = []
    w = c1.watcher('/parent')
    w.on('childrenChanged', lambda kids, stat: snaps.append(sorted(kids)))
    # Also watch existence so wait_node has a 'created' to chain from.
    w.on('created', lambda *a: None)
    await asyncio.sleep(0.1)
    assert snaps == []
    await c2.create('/parent', b'')
    await wait_until(lambda: snaps == [[]])
    await c2.create('/parent/kid', b'')
    await wait_until(lambda: ['kid'] in snaps)


async def test_existence_watcher_lifecycle(two_clients):
    c1, c2 = two_clients
    events = []
    w = c1.watcher('/ghost')
    w.on('created', lambda *a: events.append('created'))
    w.on('deleted', lambda *a: events.append('deleted'))
    # Arming on a missing node reports deleted
    # (reference: lib/zk-session.js:869-875).
    await wait_until(lambda: events == ['deleted'])
    await c2.create('/ghost', b'')
    await wait_until(lambda: events == ['deleted', 'created'])
    await c2.delete('/ghost', -1)
    await wait_until(lambda: events == ['deleted', 'created', 'deleted'])


async def test_watcher_cached_per_path(two_clients):
    c1, _ = two_clients
    assert c1.watcher('/x') is c1.watcher('/x')
    assert c1.watcher('/x') is not c1.watcher('/y')


async def test_watcher_once_forbidden(two_clients):
    c1, _ = two_clients
    with pytest.raises(NotImplementedError):
        c1.watcher('/x').once('dataChanged', lambda *a: None)


async def test_watcher_zxid_dedup_suppresses_duplicate_emits(two_clients):
    # A created notification also re-arms the dataChanged watch (server
    # watch-kind overlap); the zxid dedup keeps user emits unique
    # (reference: lib/zk-session.js:496-526, 849-856).
    c1, c2 = two_clients
    await c1.create('/dd', b'v')
    seen = []
    c1.watcher('/dd').on('dataChanged',
                         lambda data, stat: seen.append(bytes(data)))
    await wait_until(lambda: seen == [b'v'])
    # Reads that do not change mzxid must not re-emit.
    await c1.get('/dd')
    await asyncio.sleep(0.2)
    assert seen == [b'v']


async def test_stale_rearm_on_lagging_follower_does_not_reemit(ensemble_cls):
    """A churn-forced re-arm can land on a lagging follower whose tree
    is BEHIND what this watcher already delivered; the stale read's
    older mzxid must not re-emit (watch at-most-once per change —
    io/invariants.py check_watch_once).  Deterministic: the follower
    is parked (lag=None) before the change, the serving member is
    killed after the fire, and the session resumes on the stale
    follower."""
    from zkstream_tpu_torch.io.backoff import BackoffPolicy

    ens = await ensemble_cls(2, lag=0.0).start()
    c = Client(servers=ens.addresses(), shuffle_backends=False,
               session_timeout=8000, op_timeout=2000,
               connect_policy=BackoffPolicy(timeout=400, retries=3,
                                            delay=30, cap=200))
    c.start()
    try:
        await c.wait_connected(timeout=10)
        assert c.current_connection().backend.port == \
            ens.servers[0].port
        await c.create('/w', b'v0')
        fires = []
        c.watcher('/w').on(
            'dataChanged',
            lambda data, stat: fires.append((bytes(data),
                                             stat.mzxid)))
        await wait_until(lambda: len(fires) == 1)   # the arming emit
        ens.set_lag(1, None)           # park the follower HERE
        await c.set('/w', b'v1', version=-1)
        await wait_until(lambda: len(fires) == 2)   # the change fires
        created_zxid, changed_zxid = fires[0][1], fires[1][1]
        assert changed_zxid > created_zxid

        dying = c.current_connection()
        await ens.kill(0)
        await wait_until(
            lambda: not dying.is_in_state('connected'), timeout=10)
        # session resumes on the parked follower; its re-arm read
        # serves the PRE-change tree (mzxid == created_zxid) — the
        # stale state must not re-emit
        await c.wait_connected(timeout=10, fail_fast=False)
        await asyncio.sleep(0.5)       # window for a wrong emit
        assert fires[2:] == [], fires
        # un-park: the follower applies the change it lagged on; the
        # re-armed watch must not double-fire it either (the watcher
        # already delivered changed_zxid)
        ens.set_lag(1, 0.0)
        await asyncio.sleep(0.5)
        assert [z for _d, z in fires].count(changed_zxid) == 1, fires
        # a genuinely new change still fires exactly once
        await c.set('/w', b'v2', version=-1)
        await wait_until(lambda: any(d == b'v2' for d, _z in fires))
        assert len(fires) == 3, fires
    finally:
        await c.close()
        await ens.stop()
