"""The port of tests/test_linearize.py, on the port's checker and its
concurrent tier (ingests on the CPU).

Invariant 9: the per-key WGL linearizability checker
(zkstream_tpu_torch/analysis/linearize.py) and the concurrent chaos tier
that feeds it (io/faults.py ``run_concurrent_schedule``).

Three layers, mirroring the zkanalyze corpus discipline:

- the checker itself is under test — every ``tests/linearize_corpus``
  known-bad history must be flagged WITH a counterexample window,
  every known-good one must produce zero findings;
- the interval model's edges (unsettled invokes, ambiguity branches,
  zxid pruning, MULTI component merge, the search budget) are pinned
  by unit histories;
- the concurrent tier runs for real: seeded N-client schedules
  through the full fault vocabulary, rerunnable by seed, with the
  120-schedule campaign under the slow marker (scale with
  ``ZKSTREAM_CHAOS_CONC_SCHEDULES`` / ``_SEED``; the tier-1 slice
  with the scrape assertion lives in tests/test_chaos_ensemble.py).

Rerun any failing seed with ``python -m zkstream_tpu_torch chaos --tier
ensemble --clients 3 --seed N --schedules 1`` (``--tier process``
for the OS-process slice).
"""

from __future__ import annotations

import functools
import glob
import json
import os

import pytest

from zkstream_tpu_torch.analysis.linearize import (
    check_linearizable,
    check_recovered_prefix,
    check_session_reads,
    intervals,
)
from zkstream_tpu_torch.io import faults
from zkstream_tpu_torch.io.invariants import History, format_history
from test_torch_process_ensemble import on_free_ports

#: The CPU tests run every plan's ``FleetIngest`` on the CPU (the port's
#: schedules default to ``device='cuda'``).
run_concurrent_schedule = functools.partial(
    faults.run_concurrent_schedule, device='cpu')

BASE_SEED = int(os.environ.get('ZKSTREAM_CHAOS_CONC_SEED', '0'))
SCHEDULES = int(os.environ.get('ZKSTREAM_CHAOS_CONC_SCHEDULES',
                               '120'))
CLIENTS = 3

CORPUS = os.path.join(os.path.dirname(__file__), 'linearize_corpus')


def _load(name):
    with open(os.path.join(CORPUS, name + '.json')) as f:
        doc = json.load(f)
    return doc['records'], doc.get('final'), \
        doc.get('checker', 'linearize')


def _corpus(suffix):
    return sorted(
        os.path.basename(p)[:-len('.json')]
        for p in glob.glob(os.path.join(CORPUS, '*' + suffix)))


# -- the violation corpus: the checker is itself under test ------------

def test_corpus_is_populated():
    assert len(_corpus('_bad.json')) >= 5
    assert len(_corpus('_clean.json')) >= 5


@pytest.mark.parametrize('name', _corpus('_bad.json'))
def test_corpus_bad_is_flagged_with_window(name):
    records, final, checker = _load(name)
    if checker == 'session-reads':
        # the session-monotone rung: today's contract allows the
        # staleness, so invariant 9 must stay quiet — the GATE the
        # read plane will wire in is what flags it
        assert check_linearizable(records, final) == [], name
        out = check_session_reads(records)
        assert out, \
            '%s: known-bad history produced no finding' % (name,)
        assert all(v.startswith('session-reads:') for v in out)
        assert 'already seen' in out[0]       # the floor crossed
        assert 'stale window' in out[0]       # and the window shown
    else:
        out = check_linearizable(records, final)
        assert out, \
            '%s: known-bad history produced no finding' % (name,)
        # every finding arrives with its minimal counterexample:
        # either the search window (frontier + spec state + pending
        # ops with reasons) or the read's failed explanation
        assert all(v.startswith('linearizability:') for v in out)
        assert ('pending:' in out[0] and 'spec state:' in out[0]) \
            or 'no prefix-consistent explanation' in out[0]


@pytest.mark.parametrize('name', _corpus('_clean.json'))
def test_corpus_clean_is_clean(name):
    records, final, _checker = _load(name)
    assert check_linearizable(records, final) == [], name
    assert check_session_reads(records) == [], name


@pytest.mark.parametrize('name',
                         _corpus('_bad.json') + _corpus('_clean.json'))
def test_corpus_verdicts_are_deterministic(name):
    records, final, _checker = _load(name)
    assert check_linearizable(records, final) == \
        check_linearizable(records, final)
    assert check_session_reads(records) == \
        check_session_reads(records)


# -- interval model edges ----------------------------------------------

def test_intervals_pairing_and_unsettled_is_unknown():
    h = History()
    a = h.invoke('set', '/k', client=1, data=b'x')
    b = h.invoke('get', '/k', client=2)
    h.settle(a, 'ok', zxid=3, version=1)
    ops = {o.call: o for o in intervals(h)}
    assert ops[a].status == 'ok' and ops[a].zxid == 3
    assert ops[a].invoke_t == 0 and ops[a].settle_t == 2
    # an invoke with no settle is outcome-unknown (never responds)
    assert ops[b].status == 'unknown'
    assert ops[b].settle_t == float('inf')


def test_intervals_drop_definite_failures():
    h = History()
    a = h.invoke('set', '/k', data=b'x')
    h.settle(a, 'fail', error='NOT_CONNECTED')
    assert intervals(h) == []


def test_ambiguous_write_may_apply_or_drop():
    h = History()
    c = h.invoke('create', '/k', data=b'a')
    h.settle(c, 'ok', zxid=1)
    s = h.invoke('set', '/k', data=b'vX')
    h.settle(s, 'unknown', error='CONNECTION_LOSS')
    # both resolutions are admissible...
    assert check_linearizable(h, {'/k': b'a'}) == []
    assert check_linearizable(h, {'/k': b'vX'}) == []
    # ...but a value nobody wrote is not
    out = check_linearizable(h, {'/k': b'zz'})
    assert out and 'final tree' in out[0]


def test_zxid_order_is_enforced():
    """A later-invoked write acked at a LOWER zxid has no sequential
    explanation (circular ack order) — and the window names zxids."""
    h = History()
    c = h.invoke('create', '/k', data=b'a')
    h.settle(c, 'ok', zxid=1)
    s1 = h.invoke('set', '/k', data=b'vA')
    h.settle(s1, 'ok', zxid=9, version=1)
    s2 = h.invoke('set', '/k', data=b'vB')
    h.settle(s2, 'ok', zxid=8, version=1)
    out = check_linearizable(h)
    assert out and 'zxid' in out[0]


def test_read_pins_to_writer_mzxid():
    """A read's observed stat.mzxid must name a write some prefix
    actually contains."""
    h = History()
    c = h.invoke('create', '/k', data=b'a')
    h.settle(c, 'ok', zxid=1)
    g = h.invoke('get', '/k')
    h.settle(g, 'ok', zxid=7, data=b'a', version=0)  # forged mzxid
    out = check_linearizable(h)
    assert out and 'mzxid' in out[0]


def test_stale_follower_read_is_legal_today():
    """Reads are prefix-consistent, not linearizable: a lagging
    follower may serve an OLDER snapshot (README failover matrix:
    'stale reads allowed'), so a read of a superseded value is not a
    violation — but a value nobody ever wrote still is."""
    h = History()
    c = h.invoke('create', '/k', data=b'a')
    h.settle(c, 'ok', zxid=1)
    s1 = h.invoke('set', '/k', client=1, data=b'v1')
    h.settle(s1, 'ok', zxid=2, version=1)
    s2 = h.invoke('set', '/k', client=2, data=b'v2')
    h.settle(s2, 'ok', zxid=3, version=2)
    g = h.invoke('get', '/k', client=0)
    h.settle(g, 'ok', zxid=2, data=b'v1', version=1)  # stale: legal
    assert check_linearizable(h, {'/k': b'v2'}) == []
    g2 = h.invoke('get', '/k', client=0)
    h.settle(g2, 'ok', zxid=2, data=b'GHOST', version=1)
    out = check_linearizable(h, {'/k': b'v2'})
    assert out and 'no prefix-consistent explanation' in out[-1]


def test_read_cannot_observe_the_future():
    """A read that RETURNED before the write it claims to have seen
    was even invoked is causally impossible, stale or not."""
    h = History()
    c = h.invoke('create', '/k', data=b'a')
    h.settle(c, 'ok', zxid=1)
    g = h.invoke('get', '/k')
    h.settle(g, 'ok', zxid=2, data=b'v1', version=1)
    s = h.invoke('set', '/k', data=b'v1')     # invoked AFTER g settled
    h.settle(s, 'ok', zxid=2, version=1)
    out = check_linearizable(h)
    assert out and 'before it was invoked' in out[0]


def test_session_gate_flags_view_regression():
    """check_session_reads (the read-plane gate, not yet wired): a
    session that saw zxid 3 and then reads the [2, 3) snapshot went
    backwards; a DIFFERENT session doing the same is mere follower
    staleness and stays clean."""
    def history(second_reader):
        h = History()
        c = h.invoke('create', '/k', client=0, data=b'a')
        h.settle(c, 'ok', zxid=1)
        s1 = h.invoke('set', '/k', client=1, data=b'v1')
        h.settle(s1, 'ok', zxid=2, version=1)
        s2 = h.invoke('set', '/k', client=2, data=b'v2')
        h.settle(s2, 'ok', zxid=3, version=2)
        g1 = h.invoke('get', '/k', client=0)
        h.settle(g1, 'ok', zxid=3, data=b'v2', version=2)
        g2 = h.invoke('get', '/k', client=second_reader)
        h.settle(g2, 'ok', zxid=2, data=b'v1', version=1)
        return h

    out = check_session_reads(history(second_reader=0))
    assert out and 'went\nbackwards' not in out[0]  # one line each
    assert 'already seen zxid 3' in out[0]
    assert check_session_reads(history(second_reader=4)) == []


def test_multi_merges_keys_into_one_component():
    h = History()
    a = h.invoke('create', '/a', data=b'0')
    h.settle(a, 'ok', zxid=1)
    b = h.invoke('create', '/b', data=b'0')
    h.settle(b, 'ok', zxid=2)
    m = h.invoke('multi', None,
                 subs=[('set_data', '/a', b'm1', -1),
                       ('set_data', '/b', b'm2', -1)])
    h.settle(m, 'ok', zxid=4)        # subs committed at 3 and 4
    # atomic: both halves visible, or the batch is torn
    assert check_linearizable(h, {'/a': b'm1', '/b': b'm2'}) == []
    out = check_linearizable(h, {'/a': b'm1', '/b': b'0'})
    assert out and len(out) == 1     # ONE component, one finding
    # a read pins each key to its OWN sub's zxid (the batch consumes
    # one zxid per sub-op; the reply carries the last)
    g = h.invoke('get', '/a')
    h.settle(g, 'ok', zxid=3, data=b'm1', version=1)
    assert check_linearizable(h, {'/a': b'm1', '/b': b'm2'}) == []


def test_rejected_multi_has_no_effect():
    h = History()
    a = h.invoke('create', '/a', data=b'0')
    h.settle(a, 'ok', zxid=1)
    m = h.invoke('multi', None,
                 subs=[('set_data', '/a', b'm1', -1),
                       ('set_data', '/b', b'm2', -1)])
    h.settle(m, 'error', error='MULTI_REJECTED')   # /b is NO_NODE
    assert check_linearizable(h, {'/a': b'0', '/b': None}) == []


def test_search_budget_is_loud_never_silent():
    records, final, _checker = _load('overlap_clean')
    out = check_linearizable(records, final, max_nodes=1)
    assert out and 'budget' in out[0]
    assert 'not a proven violation' in out[0]


def test_floor_demotion_mirrors_invariant_one():
    """Recovery checks: an ok write past the durable floor becomes
    outcome-unknown, so its absence from the recovered tree is
    excused; at or under the quorum floor it never demotes."""
    h = History()
    c = h.invoke('create', '/k', data=b'a')
    h.settle(c, 'ok', zxid=1)
    s = h.invoke('set', '/k', data=b'v1')
    h.settle(s, 'ok', zxid=5, version=1)
    assert check_linearizable(h, {'/k': b'a'}, floor_zxid=1) == []
    out = check_linearizable(h, {'/k': b'a'}, floor_zxid=1,
                             quorum_zxid=5)
    assert out                       # quorum-acked: never demoted
    assert check_linearizable(h, {'/k': b'v1'}, floor_zxid=1) == []


def test_recovered_prefix_replay():
    class Node:
        def __init__(self, data):
            self.data = data

    class RDB:
        def __init__(self, zxid, nodes):
            self.zxid = zxid
            self.nodes = nodes

    h = History()
    c = h.invoke('create', '/k', data=b'a')
    h.settle(c, 'ok', zxid=1)
    s1 = h.invoke('set', '/k', data=b'v1')
    h.settle(s1, 'ok', zxid=2, version=1)
    s2 = h.invoke('set', '/k', data=b'v2')
    h.settle(s2, 'ok', zxid=3, version=2)
    # the recovered tree must sit exactly at its zxid's replay point
    assert check_recovered_prefix(h, RDB(2, {'/k': Node(b'v1')})) == []
    assert check_recovered_prefix(h, RDB(3, {'/k': Node(b'v2')})) == []
    out = check_recovered_prefix(h, RDB(3, {'/k': Node(b'v1')}))
    assert out and 'diverges' in out[0]
    # a component touched by an outcome-unknown write is skipped (its
    # presence in the log is unknowable; strict equality would lie)
    u = h.invoke('set', '/k', data=b'v3')
    h.settle(u, 'unknown', error='CONNECTION_LOSS')
    assert check_recovered_prefix(h, RDB(3, {'/k': Node(b'v1')})) == []


def test_unpinned_final_key_is_unconstrained_not_absent():
    """A key MISSING from a plain finals mapping places no
    constraint (the process tier leaves a key out when its
    read-back exhausted retries) — an explicit None still means
    definitively absent."""
    h = History()
    c = h.invoke('create', '/k', data=b'a')
    h.settle(c, 'ok', zxid=1)
    assert check_linearizable(h, {}) == []           # unpinned
    assert check_linearizable(h, {'/k': b'a'}) == []
    assert check_linearizable(h, {'/k': None})       # absent: flag


def test_old_one_sided_histories_pass_vacuously():
    """Histories from the pre-concurrent tiers carry no interval
    records; invariant 9 must not invent findings for them."""
    h = History()
    h.acked_create('/a', b'x', 1, zxid=3)
    h.acked_set('/w', 2, 1, zxid=4)
    h.member_event('kill', 1)
    assert check_linearizable(h, {'/a': b'whatever'}) == []


def test_format_history_columns_view():
    h = History()
    a = h.invoke('set', '/k0', client=0, data=b'x')
    b = h.invoke('get', '/k0', client=1)
    h.member_event('kill', 2)
    h.settle(b, 'ok', zxid=4, data=b'x', version=1)
    h.settle(a, 'ok', zxid=5, version=2)
    text = format_history(h, columns=True)
    assert 'client 0' in text and 'client 1' in text
    assert '#0 set /k0 >' in text
    assert '< #1 ok z=4' in text
    assert 'kill 2' in text
    # a plain record list (ScheduleResult.history) renders the same
    assert format_history(list(h.records), columns=True) == text


# -- the concurrent tier, for real -------------------------------------

@pytest.mark.timeout(120)
async def test_concurrent_schedule_is_deterministic_by_seed():
    """Same seed => same per-client op plan (the rerun contract):
    each client's Nth draw never varies — the cross-client
    interleaving may, exactly like the fault categories' documented
    determinism (io/faults.py module docstring)."""
    def plan_of(r, ci):
        return [(rec['op'], rec['path']) for rec in r.history
                if rec['kind'] == 'invoke' and rec['client'] == ci]

    a = await run_concurrent_schedule(BASE_SEED + 3, clients=CLIENTS)
    b = await run_concurrent_schedule(BASE_SEED + 3, clients=CLIENTS)
    for ci in range(CLIENTS):
        assert plan_of(a, ci) == plan_of(b, ci), ci
    assert a.clients == b.clients == CLIENTS


@pytest.mark.timeout(120)
async def test_concurrent_schedule_history_shape():
    """The schedule genuinely concurrent-writes overlapping keys:
    interval records from every client, reads recording observed
    payloads, and every invoke settled by teardown."""
    r = await run_concurrent_schedule(BASE_SEED, clients=CLIENTS)
    assert r.ok, r.violations
    invokes = [rec for rec in r.history if rec['kind'] == 'invoke']
    settles = {rec['call'] for rec in r.history
               if rec['kind'] == 'settle'}
    assert {rec['client'] for rec in invokes} == set(range(CLIENTS))
    assert {rec['call'] for rec in invokes} == settles
    reads = [rec for rec in r.history if rec['kind'] == 'settle'
             and rec['status'] == 'ok' and rec.get('data')]
    assert reads, 'no read recorded its observed payload'
    # the crash-image recovery pass engaged (zxid-ordered replay)
    assert any(str(e['event']).startswith('sigkill-recover')
               for e in r.member_events)


@pytest.mark.timeout(180)
async def test_concurrent_forced_elections_stay_linearizable():
    r = await run_concurrent_schedule(BASE_SEED, clients=CLIENTS,
                                      elections=2)
    assert r.elections >= 2, (r.elections, r.violations)
    assert r.ok, r.violations


@pytest.mark.slow
@pytest.mark.timeout(1800)
async def test_concurrent_campaign_full():
    """The full >= 120-schedule N-client campaign (slow-marked): the
    whole fault vocabulary — kills, elections, partitions, disk
    faults, server_rx — under 3 concurrent writers, zero
    linearizability violations, every schedule rerunnable by seed."""
    bad = []
    for seed in range(BASE_SEED, BASE_SEED + SCHEDULES):
        r = await run_concurrent_schedule(seed, clients=CLIENTS)
        if not r.ok:
            bad.append(r)
    assert not bad, \
        'concurrent schedules failed; rerun any with `python -m ' \
        'zkstream_tpu_torch chaos --tier ensemble --clients 3 --seed N ' \
        '--schedules 1`:\n' + '\n'.join(
            'seed %d: %s' % (r.seed, '; '.join(r.violations))
            for r in bad)


@pytest.mark.slow
@pytest.mark.timeout(600)
async def test_process_tier_concurrent_slice():
    """The OS-process half: concurrent workload phases between
    leader SIGKILLs and full-ensemble generations, invariant 9
    pinned to the final states read back through the elected
    leader."""
    from zkstream_tpu_torch.server.election import run_process_schedule

    r = await on_free_ports(lambda: run_process_schedule(
        BASE_SEED, clients=CLIENTS))
    assert r.clients == CLIENTS
    assert any(rec['kind'] == 'invoke' for rec in r.history)
    assert r.ok, r.violations


# -- CLI: the rerun key ------------------------------------------------

def test_chaos_cli_clients_flag(tmp_path):
    from zkstream_tpu_torch.cli import main

    out = tmp_path / 'trace.json'
    rc = main(['--device', 'cpu', 'chaos', '--tier', 'ensemble',
               '--clients', '2',
               '--seed', str(BASE_SEED), '--schedules', '1',
               '--quiet', '--trace-out', str(out)])
    assert rc == 0
    dumps = json.loads(out.read_text())
    assert len(dumps) == 1
    # the interval records ride the dump for offline triage
    assert any(rec['kind'] == 'invoke' for rec in dumps[0]['history'])


def test_chaos_cli_clients_needs_history_tier(capsys):
    from zkstream_tpu_torch.cli import main

    rc = main(['--device', 'cpu', 'chaos', '--tier', 'transport',
               '--clients', '2',
               '--schedules', '1'])
    assert rc == 2
    assert '--clients' in capsys.readouterr().err
