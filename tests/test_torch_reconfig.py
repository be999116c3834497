"""The port of tests/test_reconfig.py, on the port's membership plane;
every case on an in-process server or ensemble runs twice, on the
port's and on the JAX package's, with the port's clients (campaign and
process-tier cases are the port's alone).

Dynamic membership (README "Dynamic membership").

Runtime reconfiguration as epoch-fenced WAL CONTROL records, two
rungs under test: **observer add/remove under traffic** (join =
snapshot bootstrap + replication attach + a single final-phase
record; leave = drain-then-detach) and **voter add/remove/replace
with joint-majority handoff** (a 'joint' record installs C_old+C_new
— quorum commit and election tallies need majorities of BOTH sets
until the 'final' record commits, and a removed member can neither
ack a quorum nor win a ballot).  The client side is the elastic
resolver (io/pool.py ``Resolver`` + the ``read_subset`` rendezvous
subset).  ``check_reconfig`` (io/invariants.py) is the invariant-7
extension: config versions strictly increase, at most one voter-set
change per epoch, no overlapping joint windows.  The chaos slices
run reconfig steps on both tiers; the OS-process tier's
full-ensemble SIGKILL mid-joint-window must recover from the WAL's
CONTROL records and complete — or safely roll back — the
interrupted change.
"""

from __future__ import annotations

import asyncio
import functools
import os
import tempfile

import pytest

from helpers import wait_until
from zkstream_tpu_torch import Client
from zkstream_tpu_torch.io import faults
from zkstream_tpu_torch.io.invariants import (
    History,
    check_reconfig,
    format_history,
)
from zkstream_tpu_torch.io.pool import Backend, Resolver
from zkstream_tpu_torch.server.persist import open_wal_database
from zkstream_tpu_torch.server.replication import QuorumGate
from zkstream_tpu_torch.server.store import ZKDatabase
from test_torch_basic import ensemble_cls  # noqa: F401
from test_torch_process_ensemble import on_free_ports

#: The CPU tests run every plan's ``FleetIngest`` on the CPU (the port's
#: schedules default to ``device='cuda'``).
run_ensemble_schedule = functools.partial(faults.run_ensemble_schedule,
                                          device='cpu')

BASE_SEED = int(os.environ.get('ZKSTREAM_CHAOS_ENS_SEED', '0'))
SCHEDULES = int(os.environ.get('ZKSTREAM_CHAOS_ENS_SCHEDULES', '120'))


def make_client(ens, **kw):
    kw.setdefault('session_timeout', 5000)
    c = Client(servers=ens.addresses(), shuffle_backends=False, **kw)
    c.start()
    return c


# -- the quorum gate's joint-consensus commit rule ----------------------


def test_joint_window_needs_both_majorities():
    """Mid-joint, a majority of C_old alone — or of C_new alone — is
    NOT a quorum: the floor is the LOWER of the two sets' majority
    floors until the final record commits."""
    db = ZKDatabase()
    gate = QuorumGate(db, 3, enabled=True)
    gate.set_config({'m0', 'm3', 'm4'}, {'m0', 'm1', 'm2'},
                    leader_key='m0')
    db.zxid = 5
    # C_old's majority holds zxid 5 (leader + m1 + m2) ...
    gate.note_ack('m1', 5, db.epoch)
    gate.note_ack('m2', 5, db.epoch)
    # ... but C_new's is leader-only: no quorum yet
    assert gate.quorum_zxid() == 0
    # one C_new follower ack completes BOTH majorities
    gate.note_ack('m3', 5, db.epoch)
    assert gate.quorum_zxid() == 5

    # the mirror case: C_new-only majorities are equally insufficient
    gate2 = QuorumGate(db, 3, enabled=True)
    gate2.set_config({'m0', 'm3', 'm4'}, {'m0', 'm1', 'm2'},
                     leader_key='m0')
    gate2.note_ack('m3', 5, db.epoch)
    gate2.note_ack('m4', 5, db.epoch)
    assert gate2.quorum_zxid() == 0
    gate2.note_ack('m1', 5, db.epoch)
    assert gate2.quorum_zxid() == 5

    # closing the joint window: C_new alone governs
    gate2.set_config({'m0', 'm3', 'm4'}, None, leader_key='m0')
    assert gate2.quorum_zxid() == 5


def test_removed_voter_ack_is_fenced():
    """Once a named config stands, an ack from a member outside it is
    dropped and counted like a stale epoch's — a removed voter can
    never satisfy (or hold back) the new majority — and its standing
    vote leaves the pool at the config switch."""
    db = ZKDatabase()
    gate = QuorumGate(db, 3, enabled=True)
    gate.set_config({'m0', 'm1', 'm2'}, leader_key='m0')
    db.zxid = 3
    gate.note_ack('m1', 3, db.epoch)
    gate.note_ack('m2', 3, db.epoch)
    assert gate.quorum_zxid() == 3
    # m2 is replaced by m3: its standing vote is forgotten ...
    gate.set_config({'m0', 'm1', 'm3'}, leader_key='m0')
    assert 'm2' not in gate.acked
    # ... and its later acks are fenced, not counted
    db.zxid = 4
    before = gate.stale_acks
    gate.note_ack('m2', 4, db.epoch)
    assert gate.stale_acks == before + 1
    assert 'm2' not in gate.acked
    assert gate.quorum_zxid() == 3
    gate.note_ack('m1', 4, db.epoch)
    assert gate.quorum_zxid() == 4


# -- the election's joint-consensus ballot rule -------------------------


async def test_election_ballot_honors_joint_and_final_configs(
        event_loop, ensemble_cls):
    """During a joint window the ballot is open to C_old ∪ C_new and
    winning needs reachable majorities of BOTH sets; once the final
    record commits, a removed member neither stands nor counts."""
    ens = await ensemble_cls(3, observers=1, heartbeat_ms=60000,
                           seed=2).start()
    try:
        coord = ens.election
        coord.set_config({0, 1, 3}, {0, 1, 2})
        assert coord._candidates() == [0, 1, 2, 3]
        # {0,1}: majority of C_new ({0,1,3}) AND of C_old ({0,1,2})
        assert coord._quorum_reached([0, 1])
        # C_new-only majority: {0,3} reaches 2 of C_new but 1 of C_old
        assert not coord._quorum_reached([0, 3])
        # C_old-only majority: {1,2} reaches 2 of C_old but 1 of C_new
        assert not coord._quorum_reached([1, 2])
        # the final record commits: member 2 leaves the ballot
        coord.set_config({0, 1, 3})
        assert 2 not in coord._candidates()
        assert coord._quorum_reached([0, 1])
        assert coord._quorum_reached([0, 3])
    finally:
        await ens.stop()


# -- reconfig CONTROL records: phases, versions, fences -----------------


def test_reconfig_records_phases_versions_and_epoch_fence():
    db = ZKDatabase()
    db.install_config({'version': 0, 'voters': (0, 1, 2),
                       'observers': ()})
    # a voter change opens a joint window: phase 'joint', C_old kept
    entry = db.propose_reconfig((0, 1, 3))
    assert entry[0] == 'reconfig' and entry[2] == 'joint'
    assert entry[1] == db.config_version == 1
    assert entry[3] == (0, 1, 2) and entry[4] == (0, 1, 3)
    assert db.joint_config() == ((0, 1, 2), (0, 1, 3))
    # a second change mid-joint is refused (no overlapping windows)
    with pytest.raises(ValueError):
        db.propose_reconfig((0, 1, 4))
    final = db.commit_reconfig()
    assert final[2] == 'final' and final[1] == db.config_version == 2
    assert db.joint_config() is None
    assert db.reconfig_total == 1
    assert db.reconfig_epoch == db.epoch
    # at most ONE voter-set change per epoch: the next needs a bump
    with pytest.raises(ValueError):
        db.propose_reconfig((0, 1, 4))
    # an observer-only change has no quorum implications: one final
    # record, no joint window, legal in the same epoch
    obs = db.propose_reconfig((0, 1, 3), observers=(5,))
    assert obs[2] == 'final' and db.config_version == 3
    assert db.observer_ids == (5,) and db.joint_config() is None
    # after an epoch bump the voter-change budget refills
    db.bump_epoch(db.epoch + 1)
    entry = db.propose_reconfig((0, 1, 4))
    assert entry[2] == 'joint' and db.config_version == 4
    # the empty voter set is never legal
    db.commit_reconfig()
    db.bump_epoch(db.epoch + 1)
    with pytest.raises(ValueError):
        db.propose_reconfig(())


def test_wal_recovers_in_progress_reconfig(tmp_path):
    """A full-ensemble crash mid-joint-window: the WAL's CONTROL
    records alone rebuild the joint config, and the promoted
    successor completes the interrupted change under its fresh
    epoch (run_member does exactly this on promotion)."""
    d = str(tmp_path)
    db = open_wal_database(d, sync='always')
    db.install_config({'version': 0, 'voters': (0, 1, 2),
                       'observers': ()})
    db.create('/a', b'x', [], 0)
    db.propose_reconfig((0, 1, 3))
    # crash: no commit_reconfig, no clean close
    db2 = open_wal_database(d, sync='always')
    assert db2.voter_ids == (0, 1, 3)
    assert db2.old_voter_ids == (0, 1, 2)   # the joint window stands
    assert db2.config_version == 1
    assert '/a' in db2.nodes
    # the promoted leader closes the window under a fresh epoch
    db2.bump_epoch(db2.epoch + 1)
    final = db2.commit_reconfig()
    assert final[2] == 'final' and db2.config_version == 2
    # the completed change is itself durable
    db3 = open_wal_database(d, sync='always')
    assert db3.voter_ids == (0, 1, 3)
    assert db3.old_voter_ids is None
    assert db3.config_version == 2


def test_check_reconfig_flags_bad_histories():
    """The invariant-7 extension: version monotonicity, no
    overlapping joint windows, at most one voter change per epoch."""
    h = History()
    h.reconfig(1, 'joint', 2, voters=(0, 1, 3),
               old_voters=(0, 1, 2))
    h.reconfig(2, 'final', 2, voters=(0, 1, 3))
    h.reconfig(3, 'joint', 3, voters=(0, 1, 4),
               old_voters=(0, 1, 3))
    h.reconfig(4, 'final', 3, voters=(0, 1, 4))
    assert check_reconfig(h) == []

    bad = History()
    bad.reconfig(2, 'final', 2, voters=(0, 1))
    bad.reconfig(2, 'final', 2, voters=(0, 1))
    assert any('not increasing' in v for v in check_reconfig(bad))

    bad = History()
    bad.reconfig(1, 'joint', 2, voters=(0, 3), old_voters=(0, 1))
    bad.reconfig(2, 'joint', 2, voters=(0, 4), old_voters=(0, 3))
    out = check_reconfig(bad)
    assert any('still open' in v for v in out)
    assert any('at-most-one-change-per-epoch' in v for v in out)


# -- observer join/leave under traffic ----------------------------------


async def test_observer_join_under_write_load_is_byte_identical(
        event_loop, ensemble_cls):
    """A member added while a client is writing bootstraps from a
    snapshot, attaches to the replication feed at the tail, and ends
    the run holding a byte-identical tree — no write pause, no gap
    between the snapshot image and the attach point."""
    ens = await ensemble_cls(3).start()
    c = make_client(ens)
    try:
        await c.wait_connected(timeout=5)
        await c.create('/j', b'v0')
        stop = asyncio.Event()
        wrote = [0]

        async def writer():
            while not stop.is_set():
                await c.set('/j', b'v%d' % (wrote[0],), version=-1)
                await c.create('/j/c%d' % (wrote[0],), b'x')
                wrote[0] += 1
        wtask = asyncio.ensure_future(writer())
        await asyncio.sleep(0.05)
        idx = await ens.add_observer()
        await asyncio.sleep(0.05)
        stop.set()
        await wtask
        assert wrote[0] >= 2            # traffic flowed throughout
        assert idx in ens.db.observer_ids
        assert ens.servers[idx].role == 'observer'
        assert ens.db.config_version == 1
        # the joined member's tree is byte-identical to the leader's
        store = ens.servers[idx].store
        store.catch_up()
        assert set(store.nodes) == set(ens.db.nodes)
        for path, node in ens.db.nodes.items():
            mirror = store.nodes[path]
            assert bytes(mirror.data) == bytes(node.data), path
            assert mirror.version == node.version, path
        # the elastic client adopts the grown membership
        assert c.update_backends(ens.addresses())
        assert not c.update_backends(ens.addresses())   # idempotent
        # mntr on the new member reports the installed config
        rows = dict(ens.servers[idx].monitor_stats())
        assert rows['zk_config_version'] == 1
        assert 'observers=%d' % (idx,) in rows['zk_config_members']
        assert rows['zk_reconfig_total'] == 1
    finally:
        await c.close()
        await ens.stop()


async def test_voter_replace_fences_removed_member(event_loop, ensemble_cls):
    """One joint window swaps a fresh member in for a demoted voter:
    afterwards the config names C_new alone, the demoted member
    serves on as an observer, and both its quorum acks and its
    ballot standing are fenced — while writes keep acking."""
    ens = await ensemble_cls(3, heartbeat_ms=60000, seed=4).start()
    c = make_client(ens)
    try:
        await c.wait_connected(timeout=5)
        await c.create('/r', b'v0')
        idx = await ens.replace_voter(2)
        assert ens.db.voter_ids == (0, 1, idx)
        assert ens.db.old_voter_ids is None
        assert ens.servers[2].role == 'observer'
        assert ens.servers[idx].role == 'follower'
        # quorum side: the gate tallies the named C_new set only
        if ens.quorum.enabled:
            assert ens.quorum.voters == {
                'member:0', 'member:1', 'member:%d' % (idx,)}
            before = ens.quorum.stale_acks
            ens.quorum.note_ack('member:2', ens.db.zxid,
                                ens.db.epoch)
            assert ens.quorum.stale_acks == before + 1
        # ballot side: the removed member neither stands nor counts
        assert ens.election.voter_set == {0, 1, idx}
        assert 2 not in ens.election._candidates()
        # the write path is live across the handoff
        stat = await c.set('/r', b'v1', version=-1)
        assert stat.version == 1
    finally:
        await c.close()
        await ens.stop()


# -- the elastic client resolver + read-subset rebalance ----------------


def test_resolver_update_detects_change_and_notifies():
    r = Resolver([Backend('a', 1), Backend('b', 2)])
    seen = []
    r.on('changed', lambda bs: seen.append([b.key for b in bs]))
    # same membership: no change, no notification
    assert not r.update([Backend('a', 1), Backend('b', 2)])
    assert seen == []
    assert r.update([Backend('a', 1), Backend('c', 3)])
    assert seen == [['a:1', 'c:3']]
    assert [b.key for b in r.backends] == ['a:1', 'c:3']


async def test_read_subset_caps_dials_and_rebalances(event_loop, ensemble_cls):
    """``read_subset=K`` dials at most K read sessions, chosen by
    rendezvous hashing (deterministic per client); a config-change
    notification re-runs the selection against the new member list
    instead of redialing the world."""
    ens = await ensemble_cls(3, observers=2).start()
    c = make_client(ens, read_distribution=True, read_subset=2,
                    seed=7)
    try:
        await c.wait_connected(timeout=5)
        plane = c._read_plane
        assert plane.subset == 2
        assert len(plane._select()) == 2
        assert plane._select() == plane._select()   # deterministic
        await wait_until(lambda: len(plane.subs) == 2, timeout=5)
        before_keys = {s.pool.backends[0].key for s in plane.subs}
        await ens.add_observer()
        assert c.update_backends(ens.addresses())
        assert len(plane._backends) == 6
        want = {b.key for b in plane._select()}
        assert len(want) == 2
        # minimal churn: the subset never swaps wholesale on one join
        assert want & before_keys
        await wait_until(
            lambda: {s.pool.backends[0].key
                     for s in plane.subs} == want, timeout=5)
        # reads still serve through the rebalanced subset
        await c.create('/s', b'x')
        data, _ = await c.get('/s')
        assert data == b'x'
    finally:
        await c.close()
        await ens.stop()


# -- chaos: reconfig steps join the fault vocabulary (both tiers) -------


@pytest.mark.timeout(180)
async def test_ensemble_chaos_slice_with_reconfig():
    """Tier-1 slice: seeded ensemble schedules with forced reconfig
    steps (the first executed step is always a voter replace, so
    every schedule exercises >= 1 joint handoff) pass all invariants
    — the invariant-7 extension included — and stay rerunnable via
    `chaos --tier ensemble --reconfig --seed N`."""
    bad = []
    for seed in (BASE_SEED, BASE_SEED + 1, BASE_SEED + 2):
        r = await run_ensemble_schedule(seed, reconfigs=2)
        recs = [rec for rec in r.history
                if rec['kind'] == 'reconfig']
        assert recs, 'seed %d: no reconfig record landed' % (seed,)
        assert any(rec['phase'] == 'joint' for rec in recs), \
            'seed %d: no joint handoff exercised' % (seed,)
        versions = [rec['version'] for rec in recs]
        assert versions == sorted(versions) and \
            len(set(versions)) == len(versions), versions
        # the elastic client side engaged too
        assert any(str(e['event']) == 'resolver-update'
                   for e in r.member_events), r.member_events
        if not r.ok:
            bad.append(r)
    assert not bad, '; '.join(
        'seed %d: %s\n%s' % (r.seed, '; '.join(r.violations),
                             format_history(r.history))
        for r in bad)


@pytest.mark.timeout(300)
async def test_process_tier_sigkill_mid_joint_recovers(tmp_path):
    """OS-process tier acceptance: per-era voter replaces through the
    rcfg admin channel, then a full-ensemble SIGKILL while a JOINT
    record sits in the WAL uncommitted.  Recovery (2 generations
    deep) must rebuild the joint window from the CONTROL records and
    complete the change — or safely roll back — and a joint config
    must never survive a full recovery."""
    from zkstream_tpu_torch.server.election import run_process_schedule

    # a fresh directory each try: a retry must not recover the WALs of
    # the try before it
    res = await on_free_ports(lambda: run_process_schedule(
        993, ops=4, members=3, elections=2, generations=2,
        workdir=tempfile.mkdtemp(dir=tmp_path), observers=1,
        reconfig=True))
    assert res.violations == [], res.violations
    recs = [rec for rec in res.history if rec['kind'] == 'reconfig']
    assert recs, 'no membership change recorded'
    events = [str(rec['event']) for rec in res.history
              if rec['kind'] == 'member']
    assert any(e.startswith('sigkill-mid-joint') for e in events), \
        events
    assert any(e.startswith('reconfig-recovered')
               or e == 'reconfig-rolled-back' for e in events), events


@pytest.mark.slow
@pytest.mark.timeout(1800)
async def test_ensemble_campaign_reconfig_full():
    """The full >= 100-schedule campaign with reconfig steps on every
    schedule (slow-marked; the 3-seed slice above keeps tier-1
    bounded).  Every schedule exercises >= 1 voter replace."""
    bad = []
    replaces = 0
    for seed in range(BASE_SEED, BASE_SEED + SCHEDULES):
        r = await run_ensemble_schedule(seed, reconfigs=2)
        replaces += sum(
            1 for e in r.member_events
            if str(e['event']).startswith('reconfig-replace-voter'))
        if not r.ok:
            bad.append(r)
    assert replaces >= SCHEDULES
    assert not bad, '; '.join(
        'seed %d: %s' % (r.seed, '; '.join(r.violations))
        for r in bad)
