"""The port of tests/test_election.py, on the port's election plane; every
case on an in-process server or ensemble runs twice, on the port's and
on the JAX package's, with the port's clients.

Quorum leader election (server/election.py): the vote rule, the
in-process coordinator (detection by jittered heartbeat, quorum gate,
epoch persistence, deposed-member fencing), the epoch-stamped
replication fencing over real TCP, the typed leader-lost error, and
the client pool re-resolving the new leader with no operator."""

from __future__ import annotations

import asyncio

import pytest

from zkstream_tpu_torch import Client
from zkstream_tpu_torch.io.invariants import History, check_election
from zkstream_tpu_torch.protocol.errors import ZKError, ZKProtocolError
from zkstream_tpu_torch.server.election import (
    ElectionCoordinator,
    Vote,
    tally,
)
from zkstream_tpu_torch.server.replication import (
    RemoteLeader,
    ReplicationService,
    ZKLeaderLostError,
)
from zkstream_tpu_torch.server.store import ZKDatabase, ZKOpError
from zkstream_tpu_torch.utils.metrics import Collector
from test_torch_basic import ensemble_cls, pkg_attr  # noqa: F401


# -- the vote rule ----------------------------------------------------


def test_vote_rule_highest_epoch_wins():
    # a higher epoch beats ANY zxid: a deposed era's longer history
    # must never out-vote the current era
    win = tally([Vote(epoch=2, zxid=5, member=0),
                 Vote(epoch=1, zxid=900, member=1)])
    assert win.member == 0


def test_vote_rule_zxid_breaks_equal_epochs():
    # equal epochs: the member holding the most history wins, so no
    # acked write can be seeded away
    win = tally([Vote(epoch=1, zxid=10, member=0),
                 Vote(epoch=1, zxid=42, member=1),
                 Vote(epoch=1, zxid=41, member=2)])
    assert win.member == 1


def test_vote_rule_split_vote_tiebreak_is_deterministic():
    # an exact (epoch, zxid) split: highest member id wins, and every
    # permutation of the ballot computes the same winner — the rule
    # that keeps a symmetric split vote from live-locking
    votes = [Vote(epoch=3, zxid=7, member=0),
             Vote(epoch=3, zxid=7, member=2),
             Vote(epoch=3, zxid=7, member=1)]
    assert tally(votes).member == 2
    assert tally(reversed(votes)).member == 2
    assert tally(votes[1:] + votes[:1]).member == 2
    assert tally([]) is None


# -- invariant 7 ------------------------------------------------------


def test_invariant_two_leaders_per_epoch_detected():
    h = History()
    h.election(0, 1)
    h.election(2, 1)                  # same epoch, different winner
    out = check_election(h)
    assert len(out) == 1 and 'two leaders' in out[0]


def test_invariant_epoch_must_increase():
    h = History()
    h.election(1, 2)
    h.election(0, 1)                  # a deposed era re-seeded
    out = check_election(h)
    assert len(out) == 1 and 'not increasing' in out[0]


def test_invariant_clean_and_reobserved_elections_pass():
    h = History()
    h.election(1, 1)
    h.election(1, 1)                  # re-observed standing leader
    h.election(2, 2)
    h.election(0, 3)
    assert check_election(h) == []


# -- in-process coordinator -------------------------------------------


async def _elected(coord: ElectionCoordinator,
                   timeout: float = 8.0) -> tuple:
    fut = asyncio.get_running_loop().create_future()
    coord.on('elected', lambda m, e, d: (not fut.done()
                                         and fut.set_result((m, e))))
    return await asyncio.wait_for(fut, timeout)


async def _eventually(coro_fn, attempts: int = 50,
                      delay: float = 0.1):
    """Bounded retry across the reconnect window after a member
    kill: the pool's redial races the test's next op."""
    last = None
    for _ in range(attempts):
        try:
            return await coro_fn()
        except (ZKError, ZKProtocolError) as e:
            last = e
            await asyncio.sleep(delay)
    raise last


async def test_leader_kill_elects_successor_and_client_continues(
        tmp_path, ensemble_cls):
    """The headline: kill the leader member; the heartbeat monitor
    detects it, a successor is elected at epoch 1 with no operator,
    the pool re-resolves onto a live member, writes keep landing, and
    the epoch is on disk (WAL control record)."""
    from zkstream_tpu_torch.server.persist import recover_state

    wal_dir = str(tmp_path / 'wal')
    collector = Collector()
    ens = await ensemble_cls(3, wal_dir=wal_dir, heartbeat_ms=30,
                           seed=1, collector=collector).start()
    c = Client(servers=ens.addresses(), shuffle_backends=False,
               session_timeout=8000)
    c.start()
    try:
        await c.wait_connected(timeout=10)
        await c.create('/pre', b'v0')
        waiter = asyncio.get_running_loop().create_task(
            _elected(ens.election))
        await ens.kill(0)
        member, epoch = await waiter
        assert member in (1, 2) and epoch == 1
        assert ens.leader_idx == member
        assert ens.servers[member].role == 'leader'
        assert ens.election.elections == 1
        # the pool redialed a surviving member and writes continue
        await _eventually(lambda: c.create('/post', b'v1'))
        got, _ = await c.get('/pre')
        assert got == b'v0'
        conn = c.current_connection()
        assert conn.backend.port != ens.servers[0].port
        # observability: the mntr rows + the election histogram
        rows = dict(ens.servers[member].monitor_stats())
        assert rows['zk_member_role'] == 'leader'
        assert rows['zk_epoch'] == 1
        assert rows['zk_elections_total'] == 1
        assert collector.get_collector('zk_election_ms').count() == 1
        # ELECTION + EPOCH_BUMP spans on the winner's ring
        ops = [s['op'] for s in ens.servers[member].trace.dump()]
        assert 'ELECTION' in ops and 'EPOCH_BUMP' in ops
    finally:
        await c.close()
        await ens.stop()
    # the fencing token survived on disk
    assert recover_state(wal_dir).epoch == 1


async def test_restarted_ex_leader_rejoins_as_follower(ensemble_cls):
    ens = await ensemble_cls(3, heartbeat_ms=30, seed=2).start()
    try:
        waiter = asyncio.get_running_loop().create_task(
            _elected(ens.election))
        await ens.kill(0)
        member, epoch = await waiter
        await ens.restart(0)
        assert ens.servers[0].role == 'follower'
        assert ens.leader_idx == member
        assert ens.db.epoch == epoch == 1
    finally:
        await ens.stop()


async def test_partitioned_minority_member_cannot_win(ensemble_cls):
    """A member cut off from the quorum neither votes nor wins; and
    when the survivors of a leader kill are themselves a minority, NO
    epoch is seeded at all (CP behavior)."""
    # 5 members: leader killed, one follower partitioned -> the other
    # three are a quorum; the partitioned member must not win
    ens = await ensemble_cls(5, heartbeat_ms=30, seed=3).start()
    try:
        ens.election.partition(4)
        waiter = asyncio.get_running_loop().create_task(
            _elected(ens.election))
        await ens.kill(0)
        member, epoch = await waiter
        assert member in (1, 2, 3) and member != 4
        assert ens.servers[4].role == 'follower'
    finally:
        await ens.stop()

    # 3 members: leader killed AND a follower partitioned -> the one
    # reachable survivor is a minority; no election may complete
    ens = await ensemble_cls(3, heartbeat_ms=25, seed=4).start()
    try:
        ens.election.partition(1)
        await ens.kill(0)
        await asyncio.sleep(0.5)      # many heartbeat intervals
        assert ens.election.elections == 0
        assert ens.db.epoch == 0
        assert ens.servers[1].role != 'leader'
        # heal: the quorum re-forms and the election completes
        waiter = asyncio.get_running_loop().create_task(
            _elected(ens.election))
        ens.election.heal()
        member, epoch = await waiter
        assert member in (1, 2) and epoch == 1
    finally:
        await ens.stop()


async def test_deposed_leader_write_is_fenced_not_lost(ensemble_cls):
    """The acceptance criterion: a deposed-but-alive ex-leader's
    write bounces with a typed EPOCH_FENCED error — neither acked nor
    silently dropped — and succeeds again once it rejoins the current
    epoch."""
    ens = await ensemble_cls(5, heartbeat_ms=30, seed=5).start()
    # pin a client to the member about to be deposed
    c = Client(servers=[ens.addresses()[0]], session_timeout=8000)
    c.start()
    try:
        await c.wait_connected(timeout=10)
        waiter = asyncio.get_running_loop().create_task(
            _elected(ens.election))
        # partition the LEADER away from the quorum: the majority
        # elects a successor while the old leader still serves
        ens.election.partition(0)
        member, epoch = await waiter
        assert member != 0 and epoch == 1
        assert 0 in ens.election.deposed
        with pytest.raises(ZKError) as ei:
            await c.create('/fenced', b'x')
        assert ei.value.code == 'EPOCH_FENCED'
        # not silently applied either
        with pytest.raises(pkg_attr(ens, 'server.store.ZKOpError')):
            ens.db.get_data('/fenced')
        # heal: the ex-leader rejoins the current epoch; the same
        # write through it now lands
        ens.election.heal(0)
        assert ens.servers[0].role == 'follower'
        await c.create('/fenced', b'x')
        got, _ = ens.db.get_data('/fenced')
        assert bytes(got) == b'x'
    finally:
        await c.close()
        await ens.stop()


async def test_static_fallback_env_gate(monkeypatch, ensemble_cls):
    monkeypatch.setenv('ZKSTREAM_NO_ELECTION', '1')
    ens = ensemble_cls(3)
    assert ens.election is None
    assert ens.leader_idx == 0
    monkeypatch.delenv('ZKSTREAM_NO_ELECTION')
    assert ensemble_cls(3, election=False).election is None


# -- replication fencing over real TCP --------------------------------


async def _off_loop(fn, *args):
    return await asyncio.get_running_loop().run_in_executor(
        None, fn, *args)


async def test_stale_epoch_push_rejected_by_mirror():
    """A push stamped below the follower's accepted epoch is dropped
    (counted), never merged; a push at a newer epoch is adopted."""
    db = ZKDatabase()
    svc = await ReplicationService(db).start()
    remote = await RemoteLeader('127.0.0.1', svc.port).connect()
    try:
        # the mirror has accepted epoch 5 (a previous leader's stamp)
        remote.epoch = 5
        db.create('/a', b'x', None, 0)
        await asyncio.sleep(0.2)
        assert remote.stale_pushes >= 1
        assert remote.log_end() == 0      # nothing merged
        # the leader catches up past the fence: new pushes are
        # adopted, and the control channel's piggyback (which always
        # serves from the mirror's end) fills the fenced-away gap
        db.bump_epoch(6)
        db.create('/b', b'y', None, 0)
        await asyncio.sleep(0.2)
        assert remote.epoch == 6
        await _off_loop(remote.sync_barrier)
        assert remote.log_end() == 2
        assert [e[1] for e in remote.log] == ['/a', '/b']
    finally:
        remote.close()
        await svc.stop()


async def test_deposed_service_fences_forwarded_writes():
    """A deposed leader's forwarded-write RPCs bounce with a typed
    EPOCH_FENCED error (the write is neither acked nor applied);
    reads of already-mirrored state keep working."""
    from zkstream_tpu_torch.protocol.records import OPEN_ACL_UNSAFE

    db = ZKDatabase()
    svc = await ReplicationService(db).start()
    remote = await RemoteLeader('127.0.0.1', svc.port).connect()
    try:
        await _off_loop(remote.create, '/pre', b'p', OPEN_ACL_UNSAFE,
                        0)
        svc.depose(epoch=7)
        before = db.zxid
        with pytest.raises(ZKOpError) as ei:
            await _off_loop(remote.create, '/w', b'x',
                            OPEN_ACL_UNSAFE, 0)
        assert ei.value.code == 'EPOCH_FENCED'
        assert db.zxid == before          # nothing applied
        assert '/w' not in db.nodes
    finally:
        remote.close()
        await svc.stop()


async def test_rpc_from_newer_epoch_deposes_the_service():
    """The other direction: an RPC stamped with a HIGHER epoch proves
    a newer leader exists — the service fences itself."""
    from zkstream_tpu_torch.protocol.records import OPEN_ACL_UNSAFE

    db = ZKDatabase()
    svc = await ReplicationService(db).start()
    remote = await RemoteLeader('127.0.0.1', svc.port).connect()
    try:
        remote.epoch = 3                  # learned of epoch 3 elsewhere
        with pytest.raises(ZKOpError) as ei:
            await _off_loop(remote.create, '/w', b'x',
                            OPEN_ACL_UNSAFE, 0)
        assert ei.value.code == 'EPOCH_FENCED'
        assert svc.deposed
    finally:
        remote.close()
        await svc.stop()


async def test_leader_death_mid_rpc_is_typed_not_raw_eof():
    """Drive-by: the leader process dying mid-RPC surfaces as the
    typed outcome-unknown error (CONNECTION_LOSS — what the chaos
    harness classifies as ambiguous), never a raw ConnectionError,
    and the push-channel EOF fires the leader-lost signal."""
    from zkstream_tpu_torch.protocol.records import OPEN_ACL_UNSAFE

    db = ZKDatabase()
    svc = await ReplicationService(db).start()
    remote = await RemoteLeader('127.0.0.1', svc.port).connect()
    lost = asyncio.Event()
    loop = asyncio.get_running_loop()
    remote.on_leader_lost = \
        lambda: loop.call_soon_threadsafe(lost.set)
    try:
        await svc.stop()                  # the leader dies
        with pytest.raises(ZKLeaderLostError) as ei:
            await _off_loop(remote.create, '/x', b'', OPEN_ACL_UNSAFE,
                            0)
        assert ei.value.code == 'CONNECTION_LOSS'
        await asyncio.wait_for(lost.wait(), 5)
    finally:
        remote.close()
        await svc.stop()


# -- pool re-resolution -----------------------------------------------


async def test_pool_reresolves_leader_without_operator(ensemble_cls):
    """The serving (leader) backend dies; the pool promotes/redials a
    surviving member, the session resumes, and the elected successor
    serves the session's writes — zero operator actions."""
    ens = await ensemble_cls(3, heartbeat_ms=30, seed=6).start()
    c = Client(servers=ens.addresses(), shuffle_backends=False,
               session_timeout=10000)
    c.start()
    try:
        await c.wait_connected(timeout=10)
        sid = c.session.get_session_id()
        await c.create('/rr', b'v0')
        waiter = asyncio.get_running_loop().create_task(
            _elected(ens.election))
        await ens.kill(0)
        await waiter
        # bounded settle: redial + resume happen with no operator
        await _eventually(lambda: c.set('/rr', b'v1', version=-1))
        assert c.session.get_session_id() == sid
        got, _ = await c.get('/rr')
        assert got == b'v1'
        assert c.current_connection().backend.port in (
            ens.servers[1].port, ens.servers[2].port)
    finally:
        await c.close()
        await ens.stop()


# -- the claim (promise) round ----------------------------------------


def test_claim_grant_rule_single_candidate_per_epoch():
    from zkstream_tpu_torch.server.election import ElectionPeer

    peer = ElectionPeer(0, [], total=3)
    peer.epoch_fn = lambda: 2
    va = Vote(epoch=2, zxid=10, member=1)
    vb = Vote(epoch=2, zxid=10, member=2)
    # a target at or below the standing epoch is never granted
    assert not peer.grant(2, va)
    # first eligible claim wins the target epoch...
    assert peer.grant(3, va)
    # ...and the grant is STICKY: a rival is denied no matter how
    # long the claimant takes to promote (liveness is the rival's
    # job — escalate to target+1, a fresh arbitration)...
    assert not peer.grant(3, vb)
    assert peer.grant(4, vb)
    # ...while the same candidate's retry is idempotent
    assert peer.grant(3, va)
    # settled eras prune: once an epoch at/above a target stands,
    # its grant entry is gone and the target is denied outright
    peer.epoch_fn = lambda: 4
    assert not peer.grant(3, vb)
    assert not peer.grant(4, va)
    assert 3 not in peer._grants and 4 not in peer._grants


async def test_claim_round_arbitrates_overlapping_quorums():
    """Two candidates whose reachable ballots both look like a quorum
    (the asymmetric-partition split): the shared granter promises the
    target epoch to exactly one of them, so at most one reaches a
    quorum of grants — two leaders can never seed the SAME epoch."""
    from zkstream_tpu_torch.server.election import ElectionPeer

    granter = await ElectionPeer(0, [], total=3).start()
    try:
        a = ElectionPeer(1, [(0, '127.0.0.1', granter.port)], total=3)
        b = ElectionPeer(2, [(0, '127.0.0.1', granter.port)], total=3)
        va = Vote(epoch=0, zxid=5, member=1)
        vb = Vote(epoch=0, zxid=5, member=2)
        won_a = await a._claim_quorum(1, va)
        won_b = await b._claim_quorum(1, vb)
        assert won_a and not won_b
        # a later era is a fresh arbitration
        assert await b._claim_quorum(2, vb)
    finally:
        await granter.stop()


def test_promise_floor_survives_granter_restart(tmp_path):
    """A grant must survive the granter's SIGKILL: a restarted peer
    that forgot its promise could hand the same epoch to a second
    candidate.  The durable floor denies re-grants of any target at
    or below it; the denied candidate escalates to a fresh epoch."""
    from zkstream_tpu_torch.server.election import ElectionPeer

    d = str(tmp_path)
    va = Vote(epoch=0, zxid=9, member=1)
    vb = Vote(epoch=0, zxid=9, member=2)
    peer = ElectionPeer(0, [], total=3, promise_dir=d)
    assert peer.grant(1, va)
    # ...the granter dies and restarts with an empty memory...
    reborn = ElectionPeer(0, [], total=3, promise_dir=d)
    assert reborn.promised_floor == 1
    # a rival's claim for the promised epoch is denied outright
    assert not reborn.grant(1, vb)
    # even the ORIGINAL claimant is denied (the peer cannot know who
    # held it) — escalation to a fresh target restores liveness
    assert not reborn.grant(1, va)
    assert reborn.grant(2, vb)
