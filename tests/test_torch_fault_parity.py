"""The port's fault plane and checkers decide as the JAX package's do.

A seed must draw the same ``FaultPlan`` and the same injector decisions
in both packages, so ``python -m zkstream_tpu_torch chaos --seed N``
reruns the schedule ``python -m zkstream_tpu chaos --seed N`` ran; and
the checkers (``check_history`` and its invariants, the
linearizability pass, the static analyzer) must give the same verdicts
and findings on the same inputs.  Tolerance 0: every result is exact.
"""

import asyncio
import dataclasses
import glob
import json
import os

import pytest

from zkstream_tpu.analysis import analyze_paths as ref_analyze_paths
from zkstream_tpu.analysis import linearize as ref_lin
from zkstream_tpu.io import faults as ref_faults
from zkstream_tpu.io import invariants as ref_inv
from zkstream_tpu.protocol.consts import CreateFlag as RefCreateFlag
from zkstream_tpu.protocol.records import OPEN_ACL_UNSAFE as REF_ACL
from zkstream_tpu.server.store import ZKDatabase as RefZKDatabase
from zkstream_tpu_torch.analysis import analyze_paths
from zkstream_tpu_torch.analysis import linearize as lin
from zkstream_tpu_torch.io import faults, invariants
from zkstream_tpu_torch.protocol.consts import CreateFlag
from zkstream_tpu_torch.protocol.records import OPEN_ACL_UNSAFE
from zkstream_tpu_torch.server.store import ZKDatabase

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIN_CORPUS = os.path.join(REPO, 'tests', 'linearize_corpus')
ANALYZE_CORPUS = os.path.join(REPO, 'tests', 'analyze_corpus')


# -- the seeded plans and decisions ------------------------------------

@pytest.mark.parametrize('block', range(10))
def test_fault_plan_equals_reference_field_for_field(block):
    """``FaultPlan.randomized(seed)`` for seeds 0-199, in blocks of 20,
    and the two ``FaultConfig`` draws under it."""
    for seed in range(20 * block, 20 * block + 20):
        for ops in (6, 12):
            assert dataclasses.asdict(
                faults.FaultPlan.randomized(seed, ops=ops)) == \
                dataclasses.asdict(
                    ref_faults.FaultPlan.randomized(seed, ops=ops)), seed
        assert dataclasses.asdict(faults.FaultConfig.randomized(seed)) \
            == dataclasses.asdict(ref_faults.FaultConfig.randomized(seed))
        assert dataclasses.asdict(
            faults.FaultConfig.randomized_ensemble(seed)) == \
            dataclasses.asdict(
                ref_faults.FaultConfig.randomized_ensemble(seed))
        plan = faults.FaultPlan.randomized(seed)
        ref_plan = ref_faults.FaultPlan.randomized(seed)
        for steps in ('forced_election_steps', 'forced_multi_steps',
                      'forced_reconfig_steps', 'forced_overload_steps'):
            assert getattr(plan, steps)() == getattr(ref_plan, steps)()


def _decisions(mod, seed: int, config) -> tuple:
    """One seeded call sequence through an injector of ``mod``: every
    decision point that needs no socket, interleaved."""
    inj = mod.FaultInjector(seed, config)
    out = []
    for i in range(400):
        k = i % 9
        if k == 0:
            out.append(inj.accept_refuse())
        elif k == 1:
            out.append(inj.drop_push('follower-%d' % (i % 3,)))
        elif k == 2:
            out.append(inj.ingest_reset(None))
        elif k == 3:
            out.append(inj.ingest_cut(None, 1 + i))
        elif k == 4:
            out.append(inj.fsync_fault())
        elif k == 5:
            out.append(inj.overload_action())
        elif k == 6:
            out.append(inj.crash_window_before_fsync())
        elif k == 7:
            out.append((inj.rand('plan'), inj.randint('plan', 0, 99),
                        inj.choice('plan', 'abcdef'),
                        inj.uniform('plan', 1.0, 2.0)))
        else:
            if i == 200:
                inj.stop()       # decisions keep drawing, none fires
            out.append(inj.schedule_digest(8))
    return out, list(inj.fired)


@pytest.mark.parametrize('seed', [0, 1, 7, 13, 42])
@pytest.mark.parametrize('draw', ['randomized', 'randomized_ensemble'])
def test_injector_fires_as_the_reference(seed, draw):
    port = _decisions(faults, seed,
                      getattr(faults.FaultConfig, draw)(seed))
    ref = _decisions(ref_faults, seed,
                     getattr(ref_faults.FaultConfig, draw)(seed))
    assert port == ref
    assert port[1], 'the sequence fired nothing: a vacuous comparison'
    assert faults.FaultInjector.randomized(seed).schedule_digest() == \
        ref_faults.FaultInjector.randomized(seed).schedule_digest()


# -- the checkers on the same histories --------------------------------

def _corpus(suffix: str) -> list:
    return sorted(os.path.basename(p)[:-len('.json')]
                  for p in glob.glob(os.path.join(LIN_CORPUS,
                                                  '*' + suffix)))


def _db(Database, Flag, acl, final: dict | None):
    """A leader database of one package holding ``final``."""
    db = Database()
    for path, data in sorted((final or {}).items()):
        if data is not None:
            db.create(path, data.encode(), acl, Flag(0), None)
    return db


def _verdicts(inv, linmod, Database, Flag, acl, records, final):
    h = inv.History()
    h.records = [dict(r) for r in records]
    db = _db(Database, Flag, acl, final)
    return {
        'linearizable': linmod.check_linearizable(records, final),
        'session_reads': linmod.check_session_reads(records),
        'history': inv.check_history(h, db),
        'election': inv.check_election(h),
        'zxid': inv.check_zxid_monotonic(h),
        'watch': inv.check_watch_once(h),
        'sequential': inv.check_sequential(h),
        'format': inv.format_history(h, columns=True),
    }


@pytest.mark.parametrize('name',
                         _corpus('_bad.json') + _corpus('_clean.json'))
def test_checkers_agree_on_the_linearize_corpus(name):
    with open(os.path.join(LIN_CORPUS, name + '.json')) as f:
        doc = json.load(f)
    records, final = doc['records'], doc.get('final')
    port = _verdicts(invariants, lin, ZKDatabase, CreateFlag,
                     OPEN_ACL_UNSAFE, records, final)
    ref = _verdicts(ref_inv, ref_lin, RefZKDatabase, RefCreateFlag,
                    REF_ACL, records, final)
    assert port == ref
    if name.endswith('_bad'):
        assert port['linearizable'] or port['session_reads']


@pytest.mark.parametrize('seed', [0, 13])
def test_checkers_agree_on_a_port_campaign_history(seed):
    """A concurrent schedule of the port (three clients, the full fault
    vocabulary, its ingest on the CPU) records a history; both
    packages' checkers judge it alike."""
    r = asyncio.run(faults.run_concurrent_schedule(seed, clients=3,
                                                   device='cpu'))
    assert r.ok, r.violations
    assert any(rec['kind'] == 'invoke' for rec in r.history)
    port = _verdicts(invariants, lin, ZKDatabase, CreateFlag,
                     OPEN_ACL_UNSAFE, r.history, None)
    ref = _verdicts(ref_inv, ref_lin, RefZKDatabase, RefCreateFlag,
                    REF_ACL, r.history, None)
    assert port == ref
    assert port['linearizable'] == port['session_reads'] == []


def _findings(fn, paths, readme):
    rep = fn(paths, readme_path=readme)
    return [f.to_dict() for f in rep.findings], \
        [s.to_dict() for s in rep.suppressions], rep.nfiles


@pytest.mark.parametrize('name', sorted(
    os.path.basename(p)
    for p in glob.glob(os.path.join(ANALYZE_CORPUS, '*.py'))))
def test_analyzer_findings_equal_on_the_corpus(name):
    path = os.path.join(ANALYZE_CORPUS, name)
    readme = os.path.join(ANALYZE_CORPUS, 'corpus_readme.md')
    port = _findings(analyze_paths, [path], readme)
    assert port == _findings(ref_analyze_paths, [path], readme)
    if name.endswith('_bad.py') or name == 'suppressed_noreason.py':
        assert port[0], name


def test_analyzer_finds_nothing_in_the_port():
    """The port's analyzer over the whole port package (README drift
    included) reports zero findings, as the reference's does over its
    own package."""
    readme = os.path.join(REPO, 'README.md')
    port = analyze_paths([os.path.join(REPO, 'zkstream_tpu_torch')],
                         readme_path=readme)
    assert port.findings == [], [f.format() for f in port.findings]
    ref = ref_analyze_paths([os.path.join(REPO, 'zkstream_tpu')],
                            readme_path=readme)
    assert ref.findings == []
