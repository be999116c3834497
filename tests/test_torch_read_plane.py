"""The port of tests/test_read_plane.py, on the port's read plane; every
case on an in-process server or ensemble runs twice, on the port's and
on the JAX package's, with the port's clients (the process-tier case is
the port's alone).

The read scale-out plane (README "Read plane").

Three interlocking pieces under test: **observer members** (receive
the replication stream, serve reads/watches/sessions, never vote and
never count toward the quorum-commit majority), the **zxid read
gate** (a session never observes state older than what it has already
seen: reads on a member behind the session floor block briefly or
bounce — server/server.py ReadGate), and the **client read plane**
(get/exists/getACL/list fan out over per-backend read sessions,
validated against the client floor by the reply header's zxid —
io/pool.py ReadPlane).  ``check_session_reads``
(analysis/linearize.py) is the acceptance checker, wired into
``check_history``; ``ZKSTREAM_NO_READ_GATE=1`` is the env-gated
ungated validator it must catch.
"""

import tempfile

import pytest

from helpers import wait_until
from zkstream_tpu_torch import Client
from zkstream_tpu_torch.protocol.errors import ZKError
from zkstream_tpu_torch.server.election import quorum_of
from test_torch_basic import ensemble_cls  # noqa: F401
from test_torch_process_ensemble import on_free_ports


def make_client(ens, pin=None, **kw):
    kw.setdefault('session_timeout', 5000)
    addrs = ens.addresses()
    if pin is not None:
        addrs = addrs[pin:] + addrs[:pin]
    c = Client(servers=addrs, shuffle_backends=False, **kw)
    c.start()
    return c


# -- observer role: non-voting, non-quorum ------------------------------


async def test_observers_serve_reads_but_never_vote(event_loop, ensemble_cls):
    """Observers carry the replicated tree and serve reads, report
    the observer role, and are invisible to the election: candidates,
    quorum denominators and the quorum-commit voter set are the
    voting membership alone."""
    ens = await ensemble_cls(3, observers=2, heartbeat_ms=40,
                           seed=1).start()
    try:
        assert [s.role for s in ens.servers] == [
            'leader', 'follower', 'follower', 'observer', 'observer']
        assert ens.voters == 3 and ens.observer_count == 2
        # quorum-commit membership: voters only
        assert ens.quorum.total == 3
        # only voting followers feed quorum acks
        assert ens.servers[3].store.on_applied is None
        assert ens.servers[4].store.on_applied is None

        c = make_client(ens, pin=3)   # connect through an observer
        await c.wait_connected(timeout=5)
        await c.create('/o', b'x')    # write forwards to the shared db
        data, _ = await c.get('/o')   # read serves from the observer
        assert data == b'x'
        # the quorum floor advanced on VOTER acks alone
        assert set(ens.quorum.acked) <= {'member:1', 'member:2'}
        assert ens.quorum.quorum_zxid() >= 1

        # election: observers are not candidates, and leader loss
        # elects a VOTER (the heartbeat monitor detects it) while
        # observers keep their role
        coord = ens.election
        assert all(i < 3 for i in coord._candidates())
        epoch_before = ens.db.epoch
        await ens.kill(0)
        await wait_until(lambda: ens.db.epoch > epoch_before
                         and ens.leader_idx != 0, timeout=10)
        assert ens.leader_idx < 3
        assert ens.servers[3].role == 'observer'
        assert ens.servers[4].role == 'observer'
        # killing BOTH observers never threatens the quorum
        await ens.kill(3)
        await ens.kill(4)
        assert len(coord._candidates()) >= quorum_of(ens.voters)
        await c.close()
    finally:
        await ens.stop()


async def test_observer_restart_keeps_role(event_loop, ensemble_cls):
    ens = await ensemble_cls(2, observers=1).start()
    try:
        await ens.kill(2)
        await ens.restart(2)
        assert ens.servers[2].role == 'observer'
        rows = dict(ens.servers[2].monitor_stats())
        assert rows['zk_member_role'] == 'observer'
        assert 'zk_read_zxid_gate_blocks' in rows
    finally:
        await ens.stop()


# -- the zxid read gate -------------------------------------------------


async def test_read_gate_blocks_until_member_catches_up(
        event_loop, ensemble_cls):
    """A session that saw newer state migrates onto a parked member:
    its read PARKS at the gate and serves — fresh — the moment the
    replica applies through the floor.  A session on the live leader
    is untouched (a degraded member hurts only its own sessions)."""
    ens = await ensemble_cls(2, election=False).start()
    try:
        ens.set_lag(1, None)          # member 1: deterministically stale
        c = make_client(ens, pin=0, op_timeout=4000)
        await c.wait_connected(timeout=5)
        await c.create('/g', b'v0')
        await c.set('/g', b'v1', version=-1)   # session floor advances
        leader_client = make_client(ens, pin=0)
        await leader_client.wait_connected(timeout=5)

        await ens.kill(0)             # the pool migrates the session
        await wait_until(lambda: c.is_connected(), timeout=5)

        def unpark():
            ens.set_lag(1, 0.0)
            ens.servers[1].store.catch_up()
        # un-park member 1 shortly after the read parks at the gate
        # (inside the gate's bounded wait)
        event_loop.call_later(0.05, unpark)
        data, _ = await c.get('/g')
        assert data == b'v1'          # never the stale v0 snapshot
        gate = ens.servers[1].read_gate
        assert gate.blocks >= 1
        assert gate.bounces == 0
        await c.close()
        await leader_client.close()
    finally:
        await ens.stop()


async def test_read_gate_bounces_after_bounded_wait(event_loop,
                                                    monkeypatch, ensemble_cls):
    """The parked member never catches up: the gated read bounces
    with a typed CONNECTION_LOSS inside the bounded wait — never a
    stale payload, never a wedge."""
    monkeypatch.setenv('ZKSTREAM_READ_GATE_WAIT_MS', '60')
    ens = await ensemble_cls(2, election=False).start()
    try:
        ens.set_lag(1, None)
        c = make_client(ens, pin=0, op_timeout=4000)
        await c.wait_connected(timeout=5)
        await c.create('/g', b'v0')
        await c.set('/g', b'v1', version=-1)
        await ens.kill(0)
        await wait_until(lambda: c.is_connected(), timeout=5)
        with pytest.raises(ZKError) as ei:
            await c.get('/g')
        assert ei.value.code == 'CONNECTION_LOSS'
        gate = ens.servers[1].read_gate
        assert gate.bounces >= 1
        # healing the member heals the session's reads
        ens.set_lag(1, 0.0)
        ens.servers[1].store.catch_up()
        data, _ = await c.get('/g')
        assert data == b'v1'
        await c.close()
    finally:
        await ens.stop()


async def test_ungated_validator_serves_stale_and_checker_catches_it(
        event_loop, monkeypatch, ensemble_cls):
    """``ZKSTREAM_NO_READ_GATE=1``: the ungated read path really does
    serve the session an older state than it has seen — and the
    wired-in ``check_session_reads`` (via ``check_history``) flags
    exactly that history."""
    monkeypatch.setenv('ZKSTREAM_NO_READ_GATE', '1')
    from zkstream_tpu_torch.io.invariants import History, check_history

    ens = await ensemble_cls(2, election=False).start()
    try:
        assert ens.servers[1].read_gate is None
        c = make_client(ens, pin=0, op_timeout=4000)
        await c.wait_connected(timeout=5)
        h = History()
        call = h.invoke('create', '/g', client=0, data=b'v0')
        await c.create('/g', b'v0')
        h.settle(call, 'ok', zxid=1)
        ens.set_lag(1, None)          # park AFTER the create landed
        call = h.invoke('set', '/g', client=0, data=b'v1')
        stat = await c.set('/g', b'v1', version=-1)
        h.settle(call, 'ok', zxid=stat.mzxid, version=stat.version)
        await ens.kill(0)
        await wait_until(lambda: c.is_connected(), timeout=5)
        call = h.invoke('get', '/g', client=0)
        data, rstat = await c.get('/g')
        h.settle(call, 'ok', zxid=rstat.mzxid, data=bytes(data),
                 version=rstat.version)
        assert data == b'v0'          # the stale read the gate forbids
        out = check_history(h, ens.db)
        assert any(v.startswith('session-reads:') for v in out), out
        await c.close()
    finally:
        await ens.stop()


async def test_sync_is_a_leader_barrier_on_stale_members(
        event_loop, ensemble_cls):
    """``sync`` through a parked member applies everything the leader
    committed before replying — read-your-writes across sessions for
    whoever reads through that member afterwards."""
    ens = await ensemble_cls(2, election=False).start()
    try:
        writer = make_client(ens, pin=0)
        await writer.wait_connected(timeout=5)
        await writer.create('/s', b'old')
        ens.set_lag(1, None)
        await writer.set('/s', b'new', version=-1)
        reader = make_client(ens, pin=1)   # fresh session, stale member
        await reader.wait_connected(timeout=5)
        await reader.sync('/s')
        data, _ = await reader.get('/s')
        assert data == b'new'
        await writer.close()
        await reader.close()
    finally:
        await ens.stop()


# -- the client read plane ----------------------------------------------


async def test_read_distribution_fans_out_and_stays_fresh(
        event_loop, ensemble_cls):
    """With the read plane on, reads land on read sessions across the
    membership while every write-then-read observes its own write
    (the client-side zxid gate discards stale replies)."""
    ens = await ensemble_cls(3, observers=2).start()
    try:
        c = make_client(ens, read_distribution=True)
        await c.wait_connected(timeout=5)
        await wait_until(
            lambda: any(s.is_connected()
                        for s in c._read_plane.subs), timeout=5)
        await c.create('/d', b'v0')
        for i in range(12):
            await c.set('/d', b'v%d' % i, version=-1)
            data, _ = await c.get('/d')
            assert data == b'v%d' % i
            stat = await c.stat('/d')
            assert stat.version == i + 1
        plane = c._read_plane
        assert plane.distributed > 0
        assert plane.distributed + plane.bounced + plane.fallbacks \
            >= 24
        # observer members really hold read sessions of the plane
        await wait_until(
            lambda: sum(len(s.conns) for s in ens.servers[3:]) >= 1,
            timeout=5)
        await c.close()
        assert not plane.subs          # read sessions closed with it
    finally:
        await ens.stop()


async def test_read_plane_bounces_stale_member_to_primary(
        event_loop, ensemble_cls):
    """A parked observer's replies fall below the client floor: the
    plane discards them and the primary serves — stale state is never
    surfaced, and the bounce is counted."""
    ens = await ensemble_cls(1, observers=1, election=False).start()
    try:
        c = make_client(ens, pin=0, read_distribution=True)
        await c.wait_connected(timeout=5)
        await wait_until(
            lambda: any(s.is_connected()
                        for s in c._read_plane.subs), timeout=5)
        await c.create('/b', b'v0')
        ens.set_lag(1, None)           # park the observer
        await c.set('/b', b'v1', version=-1)
        for _ in range(4):
            data, _ = await c.get('/b')
            assert data == b'v1'       # never the parked snapshot
        assert c._read_plane.bounced >= 1
        await c.close()
    finally:
        await ens.stop()


# -- OS-process tier: observer members as real processes ----------------


async def test_process_tier_observer_follows_and_serves(event_loop,
                                                        tmp_path):
    """One voter + one observer as OS processes: the observer
    re-follows the voter-elected leader, serves the acked tree back
    through its own client port, reports the observer role, and never
    wins an election (asserted inside run_process_schedule)."""
    from zkstream_tpu_torch.server.election import run_process_schedule

    # a fresh directory each try: a retry must not recover the WALs of
    # the try before it
    res = await on_free_ports(lambda: run_process_schedule(
        991, ops=3, members=1, elections=0, generations=1,
        workdir=tempfile.mkdtemp(dir=tmp_path), observers=1))
    assert res.violations == [], res.violations
    assert res.acked >= 1
