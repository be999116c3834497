"""The port of tests/test_replication.py, the replication layer of the
port, driven in one process.

In-process unit tests for the cross-process replication layer
(tests/test_process_ensemble.py proves the tier end-to-end across real
OS processes; these drive the same code in ONE process so the error
paths and bookkeeping are observable: RPC error propagation, mirror
ingest/ack flow, truncation interplay, late-joiner snapshot
bootstrap, detach on follower death).

The control channel is a blocking socket by design (follower request
handlers call it inline); here the blocking calls run on an executor
thread while the service runs on the test's loop — the same
cross-process topology, folded into one process."""

from __future__ import annotations

import asyncio

import pytest

from zkstream_tpu_torch.protocol.consts import CreateFlag
from zkstream_tpu_torch.protocol.records import OPEN_ACL_UNSAFE
from zkstream_tpu_torch.server.replication import (
    RemoteLeader,
    RemoteReplicaStore,
    ReplicationService,
)
from zkstream_tpu_torch.server.store import ZKDatabase, ZKOpError


@pytest.fixture
def repl(event_loop):
    db = ZKDatabase()
    svc = event_loop.run_until_complete(ReplicationService(db).start())
    remotes: list[RemoteLeader] = []

    async def connect():
        r = await RemoteLeader('127.0.0.1', svc.port).connect()
        remotes.append(r)
        return r

    yield db, svc, connect
    for r in remotes:
        r.close()
    event_loop.run_until_complete(svc.stop())


async def _rpc(fn, *args):
    """Run a blocking RemoteLeader call off-loop, as a second process
    would effectively do from the service's point of view."""
    return await asyncio.get_running_loop().run_in_executor(
        None, lambda: fn(*args))


async def test_rpc_write_ops_and_error_propagation(repl):
    db, svc, connect = repl
    remote = await connect()
    store = RemoteReplicaStore(remote, lag=0.0)

    path = await _rpc(remote.create, '/a', b'x', OPEN_ACL_UNSAFE,
                      CreateFlag(0), None)
    assert path == '/a'
    # the RPC piggyback delivered the commit: local catch_up suffices
    store.catch_up()
    assert store.nodes['/a'].data == b'x'

    stat = await _rpc(remote.set_data, '/a', b'y', 0)
    assert stat.version == 1
    with pytest.raises(ZKOpError) as ei:
        await _rpc(remote.set_data, '/missing', b'', -1)
    assert ei.value.code == 'NO_NODE'
    with pytest.raises(ZKOpError):
        await _rpc(remote.delete, '/a', 99)      # BAD_VERSION
    await _rpc(remote.delete, '/a', 1)
    store.catch_up()
    assert '/a' not in store.nodes


async def test_session_lifecycle_over_control_channel(repl):
    db, svc, connect = repl
    remote = await connect()

    sess = await _rpc(remote.create_session, 9000)
    assert db.sessions[sess.id].timeout == 9000
    # resume with the right and wrong password
    again = await _rpc(remote.resume_session, sess.id, sess.passwd)
    assert again is sess                 # same local mirror object
    bad = await _rpc(remote.resume_session, sess.id, b'\x00' * 16)
    assert bad is None
    # touch is fire-and-forget; close reaps leader-side
    remote.touch_session(sess)
    await _rpc(remote.close_session, sess.id)
    assert db.sessions[sess.id].closed
    assert remote.sessions[sess.id].closed


async def test_events_channel_pushes_commits_and_acks(repl):
    db, svc, connect = repl
    remote = await connect()
    applied = []
    remote.on('committed', lambda: applied.append(remote.log_end()))

    # a write NOT through this follower (the leader's own member):
    # reaches the mirror via the events push
    db.create('/pushed', b'p', OPEN_ACL_UNSAFE, CreateFlag(0))
    for _ in range(50):
        if remote.log_end() == db.log_end():
            break
        await asyncio.sleep(0.02)
    assert remote.log_end() == db.log_end() == 1
    assert applied, 'committed never emitted from the events push'
    # ...and the follower's ack advanced the leader-side floor
    (handle,) = svc._handles.values()
    for _ in range(50):
        if handle.applied == 1:
            break
        await asyncio.sleep(0.02)
    assert handle.applied == 1


async def test_expiry_broadcast_reaches_follower(repl):
    db, svc, connect = repl
    remote = await connect()
    sess = await _rpc(remote.create_session, 1000)
    seen = []
    remote.on('sessionExpired', seen.append)
    db.expire_session(sess.id)
    for _ in range(50):
        if seen:
            break
        await asyncio.sleep(0.02)
    assert seen == [sess.id]
    assert remote.sessions[sess.id].expired


async def test_late_joiner_bootstraps_from_snapshot(repl):
    """A follower joining after history began installs the leader's
    snapshot and replays only the tail — real ZK's follower resync.
    History before ANY replica attached was never logged; the image
    carries its effects anyway."""
    db, svc, connect = repl
    # pre-replication history: zxid advances, nothing is logged
    db.create('/pre', b'old', OPEN_ACL_UNSAFE, CreateFlag(0))
    assert db.zxid == 1 and db.log_end() == 0

    late = await connect()
    store = RemoteReplicaStore(late, lag=0.0)
    assert store.nodes['/pre'].data == b'old'
    assert store.zxid == 1 and store.applied == 0

    # post-join traffic replicates normally, via both channels
    await _rpc(late.create, '/post', b'new', OPEN_ACL_UNSAFE,
               CreateFlag(0), None)
    store.catch_up()
    assert store.nodes['/post'].data == b'new'
    db.create('/pushed', b'p', OPEN_ACL_UNSAFE, CreateFlag(0))
    for _ in range(50):
        if late.log_end() == db.log_end():
            break
        await asyncio.sleep(0.02)
    store.catch_up()
    assert store.nodes['/pushed'].data == b'p'
    assert store.zxid == db.zxid == 3


async def test_snapshot_join_past_truncated_log(repl):
    """A joiner arriving after the log was truncated (its prefix
    applied everywhere and dropped) still bootstraps correctly: the
    snapshot position sits past the truncation floor by
    construction."""
    db, svc, connect = repl
    first = await connect()
    RemoteReplicaStore(first, lag=0.0)
    n = ZKDatabase.LOG_TRUNC_CHUNK + 20
    for i in range(n):
        await _rpc(first.create, '/n%d' % i, b'', OPEN_ACL_UNSAFE,
                   CreateFlag(0), None)
    (h1,) = svc._handles.values()
    for _ in range(100):
        if h1.applied == db.log_end():
            break
        await asyncio.sleep(0.02)
    await _rpc(first.create, '/trunc-trigger', b'', OPEN_ACL_UNSAFE,
               CreateFlag(0), None)
    assert db.log_base > 0, 'truncation never ran'

    late = await connect()
    store = RemoteReplicaStore(late, lag=0.0)
    await _rpc(store.sync_flush)
    assert store.nodes.keys() == db.nodes.keys()
    assert store.zxid == db.zxid


async def test_follower_death_detaches_handle(repl):
    db, svc, connect = repl
    remote = await connect()
    await _rpc(remote.create, '/x', b'', OPEN_ACL_UNSAFE,
               CreateFlag(0), None)
    assert len(svc._handles) == 1 and len(db._replicas) == 1
    remote.close()                       # both channels die
    for _ in range(50):
        if not svc._handles:
            break
        await asyncio.sleep(0.02)
    assert not svc._handles and not db._replicas
    # with no replicas attached the next write is not even logged
    # (nothing left that could replay it)
    db.create('/after', b'', OPEN_ACL_UNSAFE, CreateFlag(0))
    assert db.log_end() == db.log_base + len(db.log)


async def test_sync_barrier_fetches_unpushed_history(repl):
    """sync_flush must round-trip: a commit the events channel has NOT
    delivered is still visible after the barrier.  The hold-back is
    deterministic — the leader-side push writer is detached while the
    commit lands, so the events channel genuinely never carries it and
    only the barrier's control-channel piggyback can (a regression of
    sync_flush to plain catch_up fails this test every run)."""
    db, svc, connect = repl
    remote = await connect()
    store = RemoteReplicaStore(remote, lag=0.0)
    (handle,) = svc._handles.values()
    writer, handle.writer = handle.writer, None    # pause pushes
    try:
        db.create('/s', b'v0', OPEN_ACL_UNSAFE, CreateFlag(0))
        await asyncio.sleep(0.05)
        assert remote.log_end() == 0, 'push leaked past the hold-back'
        await _rpc(store.sync_flush)
        assert store.nodes['/s'].data == b'v0'
        assert remote.log_end() == db.log_end()
    finally:
        handle.writer = writer


async def test_truncation_waits_for_follower_acks(repl):
    """The leader must never truncate past the lowest follower ACK:
    a slow-to-ack follower pins the log tail its next control RPC may
    piggyback from."""
    db, svc, connect = repl
    remote = await connect()
    RemoteReplicaStore(remote, lag=0.0)
    n = ZKDatabase.LOG_TRUNC_CHUNK + 40
    for i in range(n):
        await _rpc(remote.create, '/t%d' % i, b'', OPEN_ACL_UNSAFE,
                   CreateFlag(0), None)
    (handle,) = svc._handles.values()
    # acks flow on the events channel; wait for them to drain
    for _ in range(100):
        if handle.applied == db.log_end():
            break
        await asyncio.sleep(0.02)
    assert handle.applied == db.log_end()
    # the next commit runs the truncation sweep past the chunk floor
    await _rpc(remote.create, '/t-last', b'', OPEN_ACL_UNSAFE,
               CreateFlag(0), None)
    assert db.log_base >= ZKDatabase.LOG_TRUNC_CHUNK
    assert db.log_base <= handle.applied


async def test_stop_with_live_followers_does_not_hang(repl):
    """Since Python 3.12.1, Server.wait_closed() also waits for client
    handlers; stop() must sever live follower channels first (the
    ZKServer.stop() hazard, server.py) — bounded here so a regression
    fails fast instead of deadlocking the suite."""
    db, svc, connect = repl
    remote = await connect()
    await _rpc(remote.create, '/live', b'', OPEN_ACL_UNSAFE,
               CreateFlag(0), None)
    await asyncio.wait_for(svc.stop(), timeout=10)
    assert not svc._handles


async def test_unknown_rpc_method_is_a_loud_error(repl):
    """A protocol-version skew (follower asking for an RPC this leader
    does not speak) surfaces as a RuntimeError naming the method, not
    a hang or a silent None."""
    db, svc, connect = repl
    remote = await connect()
    with pytest.raises(RuntimeError, match='nonsense'):
        await _rpc(remote._rpc, 'nonsense')
    # the channel survives the error: normal RPCs keep working
    await _rpc(remote.create, '/after-err', b'', OPEN_ACL_UNSAFE,
               CreateFlag(0), None)


async def test_unknown_hello_kind_is_dropped(repl):
    """A connection speaking neither channel role is closed, and the
    service keeps serving real followers."""
    import struct as _struct

    db, svc, connect = repl
    reader, writer = await asyncio.open_connection('127.0.0.1',
                                                   svc.port)
    import pickle
    payload = pickle.dumps(('bogus', 'tok'))
    writer.write(_struct.pack('>I', len(payload)) + payload)
    await writer.drain()
    data = await asyncio.wait_for(reader.read(), 5)
    assert data == b''                   # server closed it
    writer.close()
    remote = await connect()             # real followers still join
    await _rpc(remote.create, '/ok', b'', OPEN_ACL_UNSAFE,
               CreateFlag(0), None)
