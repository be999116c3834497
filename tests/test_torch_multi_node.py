"""The port of tests/test_multi_node.py, on the port's clients; every case
on an in-process server or ensemble runs twice, on the port's and on
the JAX package's, with the port's clients.

Ensemble tests: write visibility with sync (against followers that
genuinely lag), cross-server watches, and ephemeral survival across
backend kill — the rebuild's equivalent of the reference's
test/multi-node.test.js (three real ZK servers on localhost there;
three in-process members here — a leader with a commit log and
followers on their own ReplicaStores with injectable replication
lag)."""

import asyncio

import pytest

from helpers import wait_until
from zkstream_tpu_torch import Client, CreateFlag, ZKError
from test_torch_basic import ensemble_cls  # noqa: F401


@pytest.fixture
def ensemble(event_loop, ensemble_cls):
    ens = event_loop.run_until_complete(ensemble_cls(3).start())
    yield ens
    event_loop.run_until_complete(ens.stop())


def make_client(ensemble, pin=None, **kw):
    """Create a client over all ensemble members; ``pin`` forces the
    preference order to start at that member (the reference pins via a
    cueball key-sort hack, multi-node.test.js:248-255)."""
    kw.setdefault('session_timeout', 5000)
    addrs = ensemble.addresses()
    if pin is not None:
        addrs = addrs[pin:] + addrs[:pin]
    c = Client(servers=addrs, shuffle_backends=False, **kw)
    c.start()
    return c


async def test_write_visibility_across_servers(ensemble):
    """Write via one member, sync + read via another
    (reference: multi-node.test.js:107-165)."""
    c1 = make_client(ensemble, pin=0)
    c2 = make_client(ensemble, pin=2)
    await c1.wait_connected(timeout=5)
    await c2.wait_connected(timeout=5)
    assert c1.current_connection().backend.key != \
        c2.current_connection().backend.key

    await c1.create('/viz', b'hello')
    await c2.sync('/viz')
    data, _ = await c2.get('/viz')
    assert data == b'hello'
    await c1.close()
    await c2.close()


async def test_follower_stale_read_until_sync(ensemble):
    """A held follower serves a *genuinely stale* read — the failure
    mode ``sync`` exists for — and the read issued after ``sync``
    observes the write (reference: multi-node.test.js:107-165, which is
    only meaningful because real followers can lag).  The staleness is
    asserted directly: without the sync the read really does return the
    old value."""
    c1 = make_client(ensemble, pin=0)
    c2 = make_client(ensemble, pin=1)
    await c1.wait_connected(timeout=5)
    await c2.wait_connected(timeout=5)
    assert c2.current_connection().backend.key == \
        '127.0.0.1:%d' % ensemble.servers[1].port

    await c1.create('/lag', b'old')
    data, _ = await c2.get('/lag')
    assert data == b'old'

    # Hold member 1's replication and write through the leader.
    ensemble.set_lag(1, None)
    await c1.set('/lag', b'new')
    await c1.create('/lag2', b'x')

    # The follower is honestly behind: stale data, missing node.
    data, stat = await c2.get('/lag')
    assert data == b'old'
    assert stat.version == 0
    with pytest.raises(ZKError) as ei:
        await c2.get('/lag2')
    assert ei.value.code == 'NO_NODE'

    # sync flushes replication; the next read is current.
    await c2.sync('/lag')
    data, stat = await c2.get('/lag')
    assert data == b'new'
    assert stat.version == 1
    data, _ = await c2.get('/lag2')
    assert data == b'x'
    await c1.close()
    await c2.close()


async def test_follower_timed_lag_catches_up(ensemble):
    """With a timed replication delay the follower converges without
    any sync, and a watch set through it fires when the FOLLOWER
    applies the transaction — real follower-commit watch locality."""
    ensemble.set_lag(1, 0.15)
    c1 = make_client(ensemble, pin=0)
    c2 = make_client(ensemble, pin=1)
    await c1.wait_connected(timeout=5)
    await c2.wait_connected(timeout=5)

    await c1.create('/timed', b'v0')
    # not yet replicated to member 1
    with pytest.raises(ZKError):
        await c2.get('/timed')
    seen = []
    w = c2.watcher('/timed')
    w.on('created', lambda *a: seen.append('created'))
    await wait_until(lambda: seen == ['created'], timeout=5)
    data, _ = await c2.get('/timed')
    assert data == b'v0'

    seen2 = []
    c2.watcher('/timed').on(
        'dataChanged', lambda data, stat: seen2.append(bytes(data)))
    await wait_until(lambda: seen2 == [b'v0'])
    t0 = asyncio.get_running_loop().time()
    await c1.set('/timed', b'v1')
    await wait_until(lambda: seen2 == [b'v0', b'v1'], timeout=5)
    assert asyncio.get_running_loop().time() - t0 >= 0.1
    await c1.close()
    await c2.close()


async def test_write_through_lagging_follower_reads_own_write(ensemble):
    """A write through a held follower catches that member up through
    the transaction before replying (real ZK: the follower commits
    before it replies), so read-your-own-writes holds per member."""
    ensemble.set_lag(1, None)
    c1 = make_client(ensemble, pin=0)
    c2 = make_client(ensemble, pin=1)
    await c1.wait_connected(timeout=5)
    await c2.wait_connected(timeout=5)

    await c1.create('/ryow', b'leader')       # held back on member 1
    with pytest.raises(ZKError):
        await c2.get('/ryow')
    await c2.create('/ryow2', b'mine')        # write THROUGH member 1
    data, _ = await c2.get('/ryow2')
    assert data == b'mine'
    # catching up to its own write also applied the earlier txn
    data, _ = await c2.get('/ryow')
    assert data == b'leader'
    await c1.close()
    await c2.close()


async def test_cross_server_data_watch(ensemble):
    """Watch via one member, write via another
    (reference: multi-node.test.js:167-231)."""
    c1 = make_client(ensemble, pin=0)
    c2 = make_client(ensemble, pin=1)
    await c1.wait_connected(timeout=5)
    await c2.wait_connected(timeout=5)

    await c1.create('/xw', b'v0')
    seen = []
    c1.watcher('/xw').on('dataChanged',
                         lambda data, stat: seen.append(bytes(data)))
    await wait_until(lambda: seen == [b'v0'])
    await c2.set('/xw', b'v1')
    await wait_until(lambda: seen == [b'v0', b'v1'])
    await c1.close()
    await c2.close()


async def test_ephemeral_survives_backend_kill(ensemble):
    """Kill the member the owner is pinned to: the session must resume
    on another member within the timeout, the ephemeral must survive,
    and the deleted watcher must never fire
    (reference: multi-node.test.js:233-350)."""
    owner = make_client(ensemble, pin=0)
    observer = make_client(ensemble, pin=1)
    await owner.wait_connected(timeout=5)
    await observer.wait_connected(timeout=5)
    assert owner.current_connection().backend.key == \
        '127.0.0.1:%d' % ensemble.servers[0].port

    await owner.create('/eph-ha', b'mine', flags=CreateFlag.EPHEMERAL)

    deleted = []
    w = observer.watcher('/eph-ha')
    w.on('dataChanged', lambda *a: None)
    w.on('deleted', lambda *a: deleted.append(True))
    await asyncio.sleep(0.1)

    dying = owner.current_connection()
    await ensemble.kill(0)
    await wait_until(lambda: not dying.is_in_state('connected'),
                     timeout=10)
    await wait_until(lambda: owner.is_connected(), timeout=10)
    # Resumed on a different member.
    assert owner.current_connection().backend.key != \
        '127.0.0.1:%d' % ensemble.servers[0].port

    data, stat = await observer.get('/eph-ha')
    assert data == b'mine'
    assert stat.ephemeralOwner == owner.session.session_id
    assert deleted == []

    # Restart the dead member and verify again through it.
    await ensemble.restart(0)
    c3 = make_client(ensemble, pin=0)
    await c3.wait_connected(timeout=5)
    data, _ = await c3.get('/eph-ha')
    assert data == b'mine'
    assert deleted == []

    await owner.close()
    # Clean close deletes the ephemeral; observer hears about it.
    await wait_until(lambda: deleted == [True], timeout=5)
    with pytest.raises(ZKError):
        await observer.stat('/eph-ha')
    await observer.close()
    await c3.close()


async def test_session_migration_to_preferred_backend(ensemble):
    """A client connected to a less-preferred member migrates its live
    session back when the preferred one returns (decoherence +
    reattaching with revert; reference: lib/zk-session.js:265-339,
    lib/client.js:110-111)."""
    await ensemble.kill(0)
    c = make_client(ensemble, pin=0, decoherence_interval=500)
    await c.wait_connected(timeout=10)
    # Connected to a fallback member.
    fallback = c.current_connection().backend.key
    assert fallback != '127.0.0.1:%d' % ensemble.servers[0].port
    sid = c.session.session_id

    await ensemble.restart(0)
    # Decoherence fires every 500 ms; the session should migrate.
    await wait_until(
        lambda: c.is_connected() and
        c.current_connection().backend.key ==
        '127.0.0.1:%d' % ensemble.servers[0].port,
        timeout=10)
    assert c.session.session_id == sid  # moved, not recreated
    await c.ping()
    await c.close()


async def test_session_migration_revert_on_failure(ensemble):
    """If the move to a more-preferred backend fails mid-handshake, the
    session must revert to its old, still-live connection without
    dropping the session (reference: lib/zk-session.js:298-317)."""
    await ensemble.kill(0)
    c = make_client(ensemble, pin=0, decoherence_interval=300)
    await c.wait_connected(timeout=10)
    fallback = c.current_connection().backend.key
    sid = c.session.session_id
    states = []
    c.session.on('stateChanged', lambda st: states.append(st))

    # Impersonate the preferred member with a server that accepts the
    # connection, swallows the ConnectRequest, then aborts: the
    # migration attempt must fail and revert.
    async def handler(reader, writer):
        try:
            await reader.read(64)
        except (ConnectionError, OSError):
            pass
        writer.transport.abort()
    fake = await asyncio.start_server(
        handler, '127.0.0.1', ensemble.servers[0].port)
    try:
        await wait_until(
            lambda: 'reattaching' in states and states[-1] == 'attached',
            timeout=10)
        assert c.session.session_id == sid
        assert c.is_connected()
        assert c.current_connection().backend.key == fallback
        await c.ping()
    finally:
        # Unbind even on timeout/assert failure, or the port leaks into
        # the restart below.  Do NOT wait_closed() here: on 3.12+ it
        # waits for every live handler, and the client's warm spare
        # holds one open in read() until the client closes.
        fake.close()
    await ensemble.restart(0)
    await wait_until(
        lambda: c.is_connected() and
        c.current_connection().backend.key ==
        '127.0.0.1:%d' % ensemble.servers[0].port,
        timeout=10)
    assert c.session.session_id == sid
    await c.ping()
    await c.close()
    await fake.wait_closed()


async def test_sequential_counter_shared_across_servers(ensemble):
    c1 = make_client(ensemble, pin=0)
    c2 = make_client(ensemble, pin=1)
    await c1.wait_connected(timeout=5)
    await c2.wait_connected(timeout=5)
    p1 = await c1.create('/seq-', b'', flags=CreateFlag.SEQUENTIAL)
    p2 = await c2.create('/seq-', b'', flags=CreateFlag.SEQUENTIAL)
    assert p1 == '/seq-0000000000'
    assert p2 == '/seq-0000000001'
    await c1.close()
    await c2.close()


async def test_sync_through_batched_ingest(ensemble):
    """Cross-feature composition: the follower-lag/sync semantics hold
    when the clients' receive path runs through the batched device
    ingest — the replication model and the decode plane compose."""
    from zkstream_tpu_torch.io.ingest import FleetIngest

    ensemble.set_lag(1, None)
    ing = FleetIngest(device='cpu', body_mode='host', max_frames=8,
                      bypass_bytes=0,
                      warm='block', min_len=1024)
    await ing.prewarm(2)
    c1 = make_client(ensemble, pin=0, ingest=ing)
    c2 = make_client(ensemble, pin=1, ingest=ing)
    await c1.wait_connected(timeout=5)
    await c2.wait_connected(timeout=5)

    await c1.create('/il', b'old')
    await c2.sync('/il')
    data, _ = await c2.get('/il')
    assert data == b'old'
    await c1.set('/il', b'new')
    data, _ = await c2.get('/il')      # held follower: stale
    assert data == b'old'
    await c2.sync('/il')
    data, stat = await c2.get('/il')   # synced: fresh
    assert data == b'new' and stat.version == 1
    assert ing.ticks > 0               # the device plane carried it
    await c1.close()
    await c2.close()


async def test_commit_log_truncates_once_applied_everywhere():
    """The leader's commit log must not grow without bound on a
    long-running ensemble: the prefix every attached replica has
    applied is dropped (in chunks), while a deliberately-held replica
    pins exactly the history it still needs."""
    from zkstream_tpu_torch.protocol.consts import CreateFlag
    from zkstream_tpu_torch.protocol.records import OPEN_ACL_UNSAFE
    from zkstream_tpu_torch.server.store import ReplicaStore, ZKDatabase

    leader = ZKDatabase()
    live = ReplicaStore(leader, lag=0.0)
    held = ReplicaStore(leader, lag=None)       # applies on catch_up

    n = 3 * ZKDatabase.LOG_TRUNC_CHUNK
    for i in range(n):
        leader.create('/n%d' % i, b'payload-%d' % i,
                      OPEN_ACL_UNSAFE, CreateFlag(0))
    # the held replica pins the whole history
    assert held.applied == 0 and live.applied == n
    assert leader.log_base == 0 and len(leader.log) == n

    held.catch_up()
    assert held.applied == n
    # the next commit triggers the truncation sweep
    leader.create('/last', b'', OPEN_ACL_UNSAFE, CreateFlag(0))
    assert leader.log_base >= n
    assert len(leader.log) <= 1 + ZKDatabase.LOG_TRUNC_CHUNK
    assert leader.log_end() == n + 1

    # both replicas converged on the leader's tree
    for store in (live, held):
        store.catch_up()
        assert store.nodes.keys() == leader.nodes.keys()
        assert store.nodes['/n7'].data == b'payload-7'
