"""The port of tests/test_chaos_ensemble.py, on the port's ensemble tier;
every case on an in-process server or ensemble runs twice, on the
port's and on the JAX package's, with the port's clients (the campaigns
are the port's alone, their ingests on the CPU).

Ensemble-tier chaos: deterministic failover campaigns with the
history-checked invariant engine (io/faults.py ensemble tier +
io/invariants.py).

Per seeded schedule the campaign interleaves client ops with member
kills/restarts, replication partitions of the TCP replica, follower
lag and forced session migration, records everything into an
append-only history, and checks five invariants after the schedule:
no acked-write loss, zxid monotonicity per session, ephemeral
lifetime, sequential-number gaps, watch at-most-once per arm — plus
replica convergence after partitions heal.

Scale knobs: ``ZKSTREAM_CHAOS_ENS_SCHEDULES`` (slow campaign size,
default 120) and ``ZKSTREAM_CHAOS_ENS_SEED``; the tier-1 slice runs
``ZKSTREAM_CHAOS_ENS_TIER1`` (default 12) schedules.  Any failing
seed reruns with ``python -m zkstream_tpu_torch chaos --tier ensemble
--seed N --schedules 1``.
"""

from __future__ import annotations

import asyncio
import functools
import json
import os

import pytest

from helpers import wait_until
from zkstream_tpu_torch import Client
from zkstream_tpu_torch.io.backoff import BackoffPolicy
from zkstream_tpu_torch.io import faults
from zkstream_tpu_torch.io.faults import (
    FaultConfig,
    FaultInjector,
    FaultPlan,
)
from zkstream_tpu_torch.io.invariants import (
    History,
    check_acked_durability,
    check_ephemerals,
    check_history,
    check_sequential,
    check_watch_once,
    check_zxid_monotonic,
    format_history,
)
from zkstream_tpu_torch.server.store import ZKDatabase
from zkstream_tpu_torch.utils.metrics import Collector
from zkstream_tpu_torch.utils.trace import TRACE_SCHEMA, format_spans
from test_torch_basic import ensemble_cls, server, server_cls  # noqa: F401

#: The CPU tests run every plan's ``FleetIngest`` on the CPU (the port's
#: schedules default to ``device='cuda'``).
run_ensemble_schedule = functools.partial(faults.run_ensemble_schedule,
                                          device='cpu')
run_concurrent_schedule = functools.partial(
    faults.run_concurrent_schedule, device='cpu')

BASE_SEED = int(os.environ.get('ZKSTREAM_CHAOS_ENS_SEED', '0'))
SCHEDULES = int(os.environ.get('ZKSTREAM_CHAOS_ENS_SCHEDULES', '120'))
TIER1 = int(os.environ.get('ZKSTREAM_CHAOS_ENS_TIER1', '12'))

FAST = dict(
    connect_policy=BackoffPolicy(timeout=300, retries=2, delay=30,
                                 cap=200),
    default_policy=BackoffPolicy(timeout=300, retries=2, delay=50,
                                 cap=400))


# -- determinism --------------------------------------------------------

def test_same_seed_same_plan():
    for seed in (0, 3, 11, 4242):
        a = FaultPlan.randomized(seed)
        b = FaultPlan.randomized(seed)
        assert a == b
        assert FaultInjector(seed, a.config).schedule_digest() == \
            FaultInjector(seed, b.config).schedule_digest()


def test_plan_space_is_covered():
    """The per-seed plan draws genuinely vary: every ingest mode and
    session-timeout choice appears across a modest seed range."""
    plans = [FaultPlan.randomized(s) for s in range(64)]
    assert {p.ingest_mode for p in plans} == \
        {'none', 'direct', 'batch'}
    assert {p.session_timeout for p in plans} == {2000, 4000, 8000}
    assert any(p.decoherence_ms is not None for p in plans)
    assert any(p.config.p_ingest_hold > 0 for p in plans)
    # the durability plane's draws (appended after the existing
    # fields, so they never perturbed the plan shapes above): both
    # fsync policies appear, segment sizes vary (small ones force
    # rotation + fuzzy snapshots mid-schedule), and disk faults fire
    # on some seeds
    assert {p.durability for p in plans} == {'tick', 'always'}
    assert len({p.wal_segment_bytes for p in plans}) >= 2
    assert any(p.config.p_fsync_delay > 0 for p in plans)
    assert any(p.config.p_fsync_error > 0 for p in plans)


# -- the invariant engine itself ---------------------------------------

def _db_with(*paths: tuple[str, bytes]) -> ZKDatabase:
    db = ZKDatabase()
    for path, data in paths:
        db.create(path, data, None, 0, None)
    return db


def test_invariant_acked_create_loss_detected():
    h = History()
    h.acked_create('/a', b'x', 1)
    assert check_acked_durability(h, _db_with()) == \
        ['acked create /a lost (NO_NODE after campaign)']
    assert check_acked_durability(h, _db_with(('/a', b'x'))) == []
    # data mismatch is a loss too
    assert check_acked_durability(h, _db_with(('/a', b'y')))
    # ...unless an unacked delete may have landed
    h.ambiguous('delete', '/a', 1)
    assert check_acked_durability(h, _db_with()) == []
    # a re-create acked AFTER the ambiguous delete spends the excuse:
    # the delete provably resolved before the re-create was acked
    h.acked_create('/a', b'z', 1)
    assert check_acked_durability(h, _db_with()) == \
        ['acked create /a lost (NO_NODE after campaign)']


def test_invariant_acked_delete_and_set():
    h = History()
    h.acked_create('/a', b'x', 1)
    h.acked_delete('/a', 1)
    assert check_acked_durability(h, _db_with(('/a', b'x'))) == \
        ['acked delete /a did not stick']
    h2 = History()
    h2.acked_set('/w', 3, 1)
    assert check_acked_durability(h2, _db_with(('/w', b'v2')))
    assert check_acked_durability(h2, _db_with(('/w', b'v3'))) == []
    assert check_acked_durability(h2, _db_with(('/w', b'v7'))) == []


def test_invariant_delete_recreate_set_lifecycle():
    """Acked delete invalidates earlier set expectations (they died
    with the node), the re-created node's data is checked for real,
    and an ambiguous re-create excuses a surviving 'deleted' node."""
    h = History()
    h.acked_create('/x', b'a', 1)
    h.acked_set('/x', 3, 1)
    h.acked_delete('/x', 1)
    h.acked_create('/x', b'y', 1)
    # legal: re-created node holds its create data, old sets gone
    assert check_acked_durability(h, _db_with(('/x', b'y'))) == []
    # the re-created node's data IS still checked
    out = check_acked_durability(h, _db_with(('/x', b'zzz')))
    assert out == ["acked create /x holds b'zzz', expected b'y'"]
    # an ambiguous create after an acked delete excuses existence
    h2 = History()
    h2.acked_create('/d', b'a', 1)
    h2.acked_delete('/d', 1)
    assert check_acked_durability(h2, _db_with(('/d', b'a'))) == \
        ['acked delete /d did not stick']
    h2.ambiguous('create', '/d', 1)
    assert check_acked_durability(h2, _db_with(('/d', b'a'))) == []


def test_invariant_zxid_regression_detected():
    h = History()
    h.op('SET_DATA', '/w', 'ok', zxid=5, session_id=9)
    h.op('CREATE', '/c', 'ok', zxid=7, session_id=9)
    assert check_zxid_monotonic(h) == []
    h.op('SET_DATA', '/w', 'ok', zxid=6, session_id=9)
    out = check_zxid_monotonic(h)
    assert len(out) == 1 and 'zxid regression' in out[0]
    # reads and other sessions do not participate
    h2 = History()
    h2.op('GET_DATA', '/w', 'ok', zxid=9, session_id=9)
    h2.op('SET_DATA', '/w', 'ok', zxid=2, session_id=9)
    h2.op('SET_DATA', '/w', 'ok', zxid=3, session_id=8)
    assert check_zxid_monotonic(h2) == []


async def test_invariant_ephemeral_lifetime():
    # async: session expiry clocks schedule on the running loop
    db = ZKDatabase()
    sess = db.create_session(30000)
    from zkstream_tpu_torch.protocol.consts import CreateFlag
    db.create('/e', b'x', None, CreateFlag.EPHEMERAL, sess)
    h = History()
    h.acked_create('/e', b'x', sess.id, ephemeral=True)
    assert check_ephemerals(h, db) == []
    db.expire_session(sess.id)       # reaps /e
    assert check_ephemerals(h, db) == []
    # a node that survives a confirmed expiry is the bug
    db.nodes['/e'] = db.nodes['/']   # resurrect a stand-in
    out = check_ephemerals(h, db)
    assert len(out) == 1 and 'outlived its session' in out[0]


def test_invariant_sequential_gaps():
    h = History()
    h.acked_create('/seq/n-0000000000', b'', 1,
                   sequential_parent='/seq')
    h.acked_create('/seq/n-0000000001', b'', 1,
                   sequential_parent='/seq')
    assert check_sequential(h) == []
    h2 = History()
    h2.acked_create('/seq/n-0000000000', b'', 1,
                    sequential_parent='/seq')
    h2.acked_create('/seq/n-0000000002', b'', 1,
                    sequential_parent='/seq')
    out = check_sequential(h2)
    assert len(out) == 1 and 'sequential gap' in out[0]
    # an ambiguous create BEFORE the gap-revealing ack accounts for
    # the consumed number...
    h3 = History()
    h3.acked_create('/seq/n-0000000000', b'', 1,
                    sequential_parent='/seq')
    h3.ambiguous('create', '/seq/n-', 1, sequential_parent='/seq')
    h3.acked_create('/seq/n-0000000002', b'', 1,
                    sequential_parent='/seq')
    assert check_sequential(h3) == []
    # ...but one issued after it cannot excuse the earlier loss (ops
    # complete in issue order, so it consumed a higher number)
    h2.ambiguous('create', '/seq/n-', 1, sequential_parent='/seq')
    assert len(check_sequential(h2)) == 1


def test_invariant_watch_duplicates():
    h = History()
    h.watch_fire('/w', 'dataChanged', 5)
    h.watch_fire('/w', 'dataChanged', 6)
    h.watch_fire('/w', 'deleted', None)
    assert check_watch_once(h) == []
    h.watch_fire('/w', 'dataChanged', 6)
    h.watch_fire('/w', 'deleted', None)
    out = check_watch_once(h)
    assert any('duplicated dataChanged' in v for v in out)
    assert any('deleted fires' in v for v in out)


def test_check_history_composes_all_checkers():
    """The composite check runs every invariant: a history violating
    two of them reports both."""
    h = History()
    h.acked_create('/a', b'x', 1)
    h.watch_fire('/w', 'dataChanged', 5)
    h.watch_fire('/w', 'dataChanged', 5)
    out = check_history(h, _db_with())
    assert any('acked create /a lost' in v for v in out)
    assert any('duplicated dataChanged' in v for v in out)
    assert check_history(History(), _db_with()) == []


def test_format_history_renders_member_timeline():
    h = History()
    h.member_event('kill', 1)
    h.session_event('expired', 0x1234)
    h.member_event('restart', 1)
    text = format_history(h)
    assert 'member 1        kill' in text
    assert 'restart' in text and 'expired' in text
    # a plain record list (ScheduleResult.history) renders the same
    assert format_history(list(h.records)) == text


# -- the campaign: tier-1 bounded slice + slow full campaign -----------

def _assert_clean_scrape(collector: Collector, result) -> None:
    """Satellite: after a campaign the FSM census must hold no leaked
    transitional states, the degraded gauge must be consistent
    (reconnected-before-close schedules end not-degraded), and every
    trace span — client and member rings alike — must be settled (an
    op evicted from the pending table without a settle finishes
    'abandoned', never stays 'open')."""
    leaked_spans = [s for s in result.trace if s['status'] == 'open']
    assert not leaked_spans, \
        'seed %d left %d open client span(s): %r' \
        % (result.seed, len(leaked_spans), leaked_spans[:4])
    assert result.member_rings, \
        'seed %d: member rings missing from result' % (result.seed,)
    for name, spans in result.member_rings.items():
        leaked_spans = [s for s in spans if s['status'] == 'open']
        assert not leaked_spans, \
            'seed %d left %d open span(s) on %s: %r' \
            % (result.seed, len(leaked_spans), name,
               leaked_spans[:4])
    text = collector.expose()
    for fsm, states in (
            ('ZKConnection', ('connecting', 'handshaking',
                              'connected', 'closing', 'parked')),
            ('ZKSession', ('attaching', 'attached', 'reattaching',
                           'closing')),
            ('ConnectionPool', ('starting', 'running', 'failed'))):
        for state in states:
            needle = 'zkstream_fsm_state{fsm="%s",state="%s"}' \
                % (fsm, state)
            for line in text.splitlines():
                if line.startswith(needle):
                    assert float(line.split()[-1]) == 0.0, \
                        'seed %d leaked %s in state %s: %s' \
                        % (result.seed, fsm, state, line)
    if result.ok:
        assert 'zookeeper_degraded 0.0' in text, \
            'seed %d ended degraded despite a clean schedule' \
            % (result.seed,)
        # the outbound plane was engaged: a clean schedule's frames
        # all flowed through the tick-cork (io/sendplane.py), which is
        # the campaign default — so ensemble chaos genuinely exercises
        # coalescing, not a silently-disabled plane
        from zkstream_tpu_torch.io.sendplane import (
            METRIC_FLUSH_FRAMES,
            cork_default,
        )
        if cork_default():
            flushes = collector.get_collector(METRIC_FLUSH_FRAMES)
            assert flushes.count({'plane': 'client'}) > 0, \
                'seed %d: no client-plane flush recorded' \
                % (result.seed,)


def _campaign_failure_report(bad) -> str:
    lines = ['ensemble schedules failed; rerun any with '
             '`python -m zkstream_tpu_torch chaos --tier ensemble '
             '--seed N --schedules 1`:']
    for r in bad:
        lines.append('seed %d: %s' % (r.seed,
                                      '; '.join(r.violations)))
        lines.append('  member-event timeline:')
        lines.append(format_history(r.history) or '  (none)')
        lines.append('  span ring (oldest first):')
        lines.append(format_spans(r.trace, limit=40))
    return '\n'.join(lines)


def test_campaign_runs_with_watchtable_enabled():
    """The ensemble campaign runs with the sharded watch fan-out
    (server/watchtable.py) in its default-enabled state — a stray
    ZKSTREAM_NO_WATCHTABLE must not silently weaken what these
    schedules exercise.  The emitter-fallback slice lives in
    tests/test_watchtable.py."""
    from zkstream_tpu_torch.server.watchtable import watchtable_default
    assert watchtable_default(), \
        'ZKSTREAM_NO_WATCHTABLE must not be set for the tier-1 campaign'


def test_campaign_runs_on_default_transport():
    """Same rationale for the batched-syscall transport tier
    (io/transport.py): a stray ZKSTREAM_TRANSPORT must not silently
    rebase what these campaigns certify, so the env force must be
    UNSET (``probe().chosen`` folds the force in — comparing against
    it would pass any resolved force).  The forced-backend slices
    live in tests/test_transport.py."""
    import os
    assert os.environ.get('ZKSTREAM_TRANSPORT') in (None, ''), \
        'ZKSTREAM_TRANSPORT must not be set for the tier-1 campaign'


@pytest.mark.timeout(90)
async def test_kill_recover_rides_every_schedule():
    """The durability plane's kill/recover pass (invariant 6) runs
    inside every ensemble schedule — within the existing tier-1
    budget, not on top of it: the schedule ends with a full-ensemble
    SIGKILL crash image cut at an injector-chosen fsync window, a
    restart-from-disk recovery, and the acked-write check against the
    recovered tree.  Verify the machinery actually engaged: the
    member timeline carries the sigkill-recover event and the span
    ring carries the recovery span."""
    r = await run_ensemble_schedule(BASE_SEED)
    assert r.ok, r.violations
    assert any(str(e['event']).startswith('sigkill-recover')
               for e in r.member_events), r.member_events
    assert any(s.get('op') == 'WAL_RECOVER' for s in r.trace)
    # acks are zxid-stamped so the invariant's fsync-error floor can
    # demote exactly the non-durable suffix
    acks = [rec for rec in r.history if rec['kind'] == 'ack']
    if acks:
        assert all(rec.get('zxid') for rec in acks), acks[:3]


@pytest.mark.timeout(180)
async def test_ensemble_campaign_tier1_slice():
    """Bounded slice of the seeded ensemble campaign, with the
    scrape-after-chaos assertion on every schedule."""
    bad = []
    for seed in range(BASE_SEED, BASE_SEED + TIER1):
        collector = Collector()
        r = await run_ensemble_schedule(seed, collector=collector)
        _assert_clean_scrape(collector, r)
        if not r.ok:
            bad.append(r)
    assert not bad, _campaign_failure_report(bad)


@pytest.mark.timeout(300)
async def test_concurrent_campaign_tier1_slice():
    """The concurrent tier's bounded slice: N clients writing
    overlapping keys per schedule, the per-key WGL linearizability
    pass (invariant 9) on every history, and the scrape-after-chaos
    assertion extended to N clients — the FSM census sums every
    client's machines, so a single leaked per-client transitional
    state fails here.  Scale with ZKSTREAM_CHAOS_CONC_TIER1; rerun
    any seed with `python -m zkstream_tpu_torch chaos --tier ensemble
    --clients 3 --seed N --schedules 1`."""

    n = int(os.environ.get('ZKSTREAM_CHAOS_CONC_TIER1', '12'))
    bad = []
    for seed in range(BASE_SEED, BASE_SEED + n):
        collector = Collector()
        r = await run_concurrent_schedule(seed, clients=3,
                                          collector=collector)
        assert r.clients == 3
        assert any(rec['kind'] == 'invoke' for rec in r.history), \
            'seed %d recorded no interval ops' % (seed,)
        _assert_clean_scrape(collector, r)
        if not r.ok:
            bad.append(r)
    assert not bad, _campaign_failure_report(bad)


@pytest.mark.timeout(180)
async def test_forced_election_schedules_pass_invariants():
    """The election plane's ensemble-tier acceptance: seeded
    schedules with >= 2 FORCED elections (the current leader is
    killed at evenly spaced plan steps; the heartbeat monitor must
    elect a successor each time) pass every invariant — the new
    at-most-one-leader-per-epoch / epoch-monotonicity check included
    — and remain rerunnable via `chaos --tier ensemble --seed N
    --elections 2`."""
    bad = []
    for seed in (BASE_SEED, BASE_SEED + 3):
        r = await run_ensemble_schedule(seed, elections=2)
        assert r.elections >= 2, (seed, r.elections, r.violations)
        epochs = [rec['epoch'] for rec in r.history
                  if rec['kind'] == 'election']
        assert epochs == sorted(epochs), epochs
        if not r.ok:
            bad.append(r)
    assert not bad, _campaign_failure_report(bad)


async def _quiet_cached_reads(collector) -> None:
    """A cached Client on an unfaulted ensemble, its cache root armed,
    reads one key twice with no write and no reconnect between: the
    first read fills the cache and the second is served from it, with
    the server read's data and stat.  A write then invalidates the
    entry before its reply lands, so the next read goes to the server
    and sees the write."""
    ens = await faults.EnsembleUnderTest(3).start()
    c = Client(servers=ens.addresses(), shuffle_backends=False,
               session_timeout=8000, cache='/', collector=collector, **FAST)
    c.start()
    try:
        await c.wait_connected(timeout=10)
        await wait_until(lambda: c.cache.stats()['armed'] == 1, timeout=10)
        await c.create('/quiet', b'v1')
        first = await c.get('/quiet')
        hits = c.cache.hits
        second = await c.get('/quiet')
        assert c.cache.hits == hits + 1, 'the quiet re-read was not served'
        assert second == first and first[0] == b'v1'
        await c.set('/quiet', b'v2')
        third = await c.get('/quiet')
        assert c.cache.hits == hits + 1 and third[0] == b'v2'
    finally:
        await c.close()
        await ens.stop()


@pytest.mark.timeout(300)
async def test_cached_client_schedules_pass_invariants():
    """The cache plane's ensemble-tier slice (`chaos --tier ensemble
    --cached`): schedules whose clients run with the watch-backed
    client cache on (cache='/'), single-client and concurrent, must
    pass every invariant — check_session_reads in particular holds
    the no-time-travel rung on every locally served read.  The
    slice also asserts the cache actually engaged: the exported
    zookeeper_cache_hits total is non-zero (a cache that never serves
    is not under test).

    A schedule's hits are not certain: a hit needs a second read of a
    key with no write to it and no reconnect between, and the churn
    driver is paced by the wall clock, so on a loaded host more churn
    lands between a client's ops and the schedules may serve nothing.
    So the slice also drives a quiet cached client
    (:func:`_quiet_cached_reads`), whose re-read must be served; its
    hit counts in the total beside the schedules'."""
    import re

    bad = []
    hits = 0.0
    for seed in (BASE_SEED, BASE_SEED + 1):
        collector = Collector()
        r = await run_ensemble_schedule(seed, cached=True,
                                        collector=collector)
        _assert_clean_scrape(collector, r)
        text = collector.expose()
        assert 'zookeeper_cache_hits' in text
        hits += sum(float(m) for m in re.findall(
            r'^zookeeper_cache_hits\{[^}]*\} (\S+)', text, re.M))
        if not r.ok:
            bad.append(r)
    for seed in (BASE_SEED + 2, BASE_SEED + 3):
        collector = Collector()
        r = await run_concurrent_schedule(seed, clients=3,
                                          cached=True,
                                          collector=collector)
        assert any(rec['kind'] == 'invoke' for rec in r.history), \
            'seed %d recorded no interval ops' % (seed,)
        _assert_clean_scrape(collector, r)
        hits += sum(float(m) for m in re.findall(
            r'^zookeeper_cache_hits\{[^}]*\} (\S+)',
            collector.expose(), re.M))
        if not r.ok:
            bad.append(r)
    collector = Collector()
    await _quiet_cached_reads(collector)
    hits += sum(float(m) for m in re.findall(
        r'^zookeeper_cache_hits\{[^}]*\} (\S+)', collector.expose(), re.M))
    assert not bad, _campaign_failure_report(bad)
    assert hits > 0, 'cache never served across the cached slice'


@pytest.mark.slow
@pytest.mark.timeout(2400)
async def test_cached_campaign_full():
    """The cache plane's acceptance campaign (slow-marked): >= 120
    seeded CONCURRENT schedules with cached clients through the full
    fault vocabulary (kills, elections, partitions, reconfig), zero
    check_session_reads violations — a cached read can never
    time-travel, under any schedule."""

    bad = []
    for seed in range(BASE_SEED, BASE_SEED + SCHEDULES):
        r = await run_concurrent_schedule(seed, clients=3,
                                          cached=True)
        if not r.ok:
            bad.append(r)
    assert not bad, _campaign_failure_report(bad)


async def test_schedule_runs_on_static_leader_fallback(monkeypatch):
    """ZKSTREAM_NO_ELECTION=1 keeps the static member-0 leader as the
    env-gated validator path: the same seeded schedule runs with no
    coordinator and no election records."""
    monkeypatch.setenv('ZKSTREAM_NO_ELECTION', '1')
    r = await run_ensemble_schedule(BASE_SEED)
    assert r.elections == 0
    assert not any(rec['kind'] == 'election' for rec in r.history)
    assert r.ok, r.violations


@pytest.mark.slow
@pytest.mark.timeout(900)
async def test_ensemble_campaign_full():
    """The full >= 100-schedule seeded campaign (slow-marked; the
    tier-1 slice above keeps the fast suite bounded)."""
    bad = []
    for seed in range(BASE_SEED, BASE_SEED + SCHEDULES):
        r = await run_ensemble_schedule(seed)
        if not r.ok:
            bad.append(r)
    assert not bad, _campaign_failure_report(bad)


# -- SET_WATCHES re-arm across leader failover -------------------------

@pytest.mark.timeout(60)
async def test_set_watches_rearm_across_leader_failover(ensemble_cls):
    """A watch armed on the old leader must fire exactly once for a
    change committed during the outage: the SET_WATCHES catch-up on
    the surviving member delivers it, and the re-arm read's zxid
    dedup must not deliver it again."""
    ens = await ensemble_cls(2).start()
    c1 = Client(servers=ens.addresses(), shuffle_backends=False,
                session_timeout=8000, op_timeout=2000, **FAST)
    c2 = Client(servers=[ens.addresses()[1]], session_timeout=8000,
                **FAST)
    c1.start()
    c2.start()
    try:
        await c1.wait_connected(timeout=10)
        await c2.wait_connected(timeout=10)
        assert c1.current_connection().backend.port == \
            ens.servers[0].port
        await c1.create('/x', b'v0')

        fires: list[int] = []
        c1.watcher('/x').on('dataChanged',
                            lambda data, stat:
                            fires.append(stat.mzxid))
        # the arming read emits once for the current state
        await wait_until(lambda: len(fires) == 1, timeout=10)

        dying = c1.current_connection()
        await ens.kill(0)
        await wait_until(
            lambda: not dying.is_in_state('connected'), timeout=10)

        # committed during the outage, through the surviving member
        stat = await c2.set('/x', b'v1', version=-1)
        changed = stat.mzxid

        # failover: session resumes on member 1, SET_WATCHES at the
        # old zxid, catch-up notification fires the watcher
        await wait_until(lambda: changed in fires, timeout=20)
        # exactly once: give any duplicate a window to appear
        await asyncio.sleep(0.5)
        assert fires.count(changed) == 1, fires
        h = History()
        for z in fires:
            h.watch_fire('/x', 'dataChanged', z)
        assert check_watch_once(h) == []
    finally:
        await c1.close()
        await c2.close()
        await ens.stop()


# -- FleetIngest tick faults (batch regime) ----------------------------

@pytest.mark.timeout(60)
async def test_ingest_tick_faults_keep_parity(server):
    """With every tick withholding a suffix (p_ingest_hold=1), the
    batched drain must still deliver every reply — partial frames at
    arbitrary tick cuts are finished on follow-up ticks."""
    from zkstream_tpu_torch.io.ingest import FleetIngest

    inj = FaultInjector(7, FaultConfig(p_ingest_hold=1.0,
                                       max_faults=None))
    ingest = FleetIngest(device='cpu', body_mode='host', max_frames=8,
                         bypass_bytes=0)
    ingest.faults = inj
    c = Client(address='127.0.0.1', port=server.port,
               session_timeout=8000, op_timeout=5000,
               ingest=ingest, **FAST)
    c.start()
    try:
        await c.wait_connected(timeout=10)
        await c.create('/i', b'seed')
        for i in range(40):
            data, _stat = await c.get('/i')
            assert bytes(data) == b'seed'
        assert any(d == 'ingest tick hold' for _c, d in inj.fired)
    finally:
        await c.close()
        ingest.close()
        inj.close()


@pytest.mark.timeout(60)
async def test_ingest_tick_reset_is_survivable(server):
    """A tick-time reset kills the connection mid-batch; the client
    must redial and every op must still terminate (typed errors
    allowed, hangs not)."""
    from zkstream_tpu_torch.io.ingest import FleetIngest
    from zkstream_tpu_torch.protocol.errors import ZKProtocolError

    inj = FaultInjector(11, FaultConfig(p_ingest_reset=0.2,
                                        max_faults=4))
    ingest = FleetIngest(device='cpu', body_mode='host', max_frames=8,
                         bypass_bytes=0)
    ingest.faults = inj
    c = Client(address='127.0.0.1', port=server.port,
               session_timeout=8000, op_timeout=1000,
               ingest=ingest, **FAST)
    c.start()
    try:
        await c.wait_connected(timeout=10)
        await c.create('/r', b'x')
        ok = 0
        for i in range(30):
            if not c.is_connected():
                try:
                    await c.wait_connected(timeout=2,
                                           fail_fast=False)
                except (asyncio.TimeoutError, TimeoutError):
                    pass
            try:
                await asyncio.wait_for(c.get('/r'), 5)
                ok += 1
            except ZKProtocolError:
                pass
        assert ok > 0, 'no op survived the tick resets'
    finally:
        await c.close()
        ingest.close()
        inj.close()


# -- CLI: rerun support + member events in the trace dump --------------

def test_chaos_ensemble_cli_rerun_and_trace(tmp_path):
    from zkstream_tpu_torch.cli import main

    out = tmp_path / 'trace.json'
    rc = main(['--device', 'cpu', 'chaos', '--tier', 'ensemble', '--seed',
               str(BASE_SEED), '--schedules', '3', '--quiet',
               '--trace-out', str(out)])
    assert rc == 0
    dumps = json.loads(out.read_text())
    assert len(dumps) == 3
    assert all(d['tier'] == 'ensemble' for d in dumps)
    assert all('member_events' in d and 'history' in d
               for d in dumps)
    # schema-stamped payload: member rings per member, merged
    # zxid-ordered timeline
    assert all(d['trace_schema'] == TRACE_SCHEMA for d in dumps)
    # 3 voters, plus any plan-drawn observers (the read plane): every
    # member's ring is carried, observers included
    assert all(len(d['member_rings']) >= 3 for d in dumps)
    assert any(s['op'] == 'APPLY'
               for d in dumps
               for spans in d['member_rings'].values()
               for s in spans)
    assert all(isinstance(d['timeline'], list) for d in dumps)
    # member kill/restart events ride the span ring too
    kinds = {s.get('kind') for d in dumps for s in d['trace']}
    events = [e for d in dumps for e in d['member_events']]
    if events:                       # plan-dependent, seed-stable
        assert 'member' in kinds
        assert any(e['event'].startswith(('kill', 'restart',
                                          'partition', 'heal',
                                          'lag', 'migrate'))
                   for e in events)
