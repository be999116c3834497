"""The port of tests/test_analyze.py, on the port's analyzer, over the
port's package.

The semantic static-analysis tier (zkstream_tpu_torch/analysis/).

Three layers of proof:

- **violation corpus** (tests/analyze_corpus/): each checker catches
  its seeded bugs — including the span-leak re-introduction and
  the synthetic await-under-lock in a ReplicaStore-shaped class —
  and each clean twin passes;
- **suppression syntax**: reasoned annotations silence exactly their
  finding and surface in the suppression inventory; reason-less
  annotations are themselves findings;
- **the repo-wide zero-findings baseline**: `make analyze` over
  zkstream_tpu_torch/ reports nothing, every suppression carries a reason
  and is actually used — this is the tier-1 gate that keeps the
  plane contracts mechanical from here on.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

from zkstream_tpu_torch.analysis import analyze_paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, 'tests', 'analyze_corpus')
CORPUS_README = os.path.join(CORPUS, 'corpus_readme.md')
PKG = os.path.join(REPO, 'zkstream_tpu_torch')


def corpus(name: str) -> str:
    return os.path.join(CORPUS, name)


def run_corpus(*names: str):
    return analyze_paths([corpus(n) for n in names],
                         readme_path=CORPUS_README)


def checkers_hit(report) -> dict[str, int]:
    out: dict[str, int] = {}
    for f in report.findings:
        out[f.checker] = out.get(f.checker, 0) + 1
    return out


# -- per-checker corpus units --

def test_loopblock_catches_seeded_violations():
    report = run_corpus('loopblock_bad.py')
    assert checkers_hit(report) == {'loop-blocking': 3}
    msgs = [f.message for f in report.findings]
    assert any('os.fsync' in m and 'async def group_sync' in m
               for m in msgs)
    assert any('time.sleep' in m for m in msgs)
    assert any('subprocess.run' in m and 'loop callback' in m
               for m in msgs), 'call_soon-registered sync fn missed'


def test_loopblock_clean_twin_passes():
    assert run_corpus('loopblock_clean.py').findings == []


def test_await_under_lock_catches_replicastore_shape():
    report = run_corpus('lock_bad.py')
    assert checkers_hit(report) == {'await-under-lock': 2}
    msgs = [f.message for f in report.findings]
    assert any('holding thread lock' in m
               and '_apply_lock' in m for m in msgs)
    assert any('read before an await and written after' in m
               and 'ReplicaStore' in m for m in msgs)


def test_lock_clean_twin_passes():
    assert run_corpus('lock_clean.py').findings == []


def test_span_leak_catches_pr7_reintroduction():
    report = run_corpus('span_bad.py')
    hits = checkers_hit(report)
    assert hits == {'span-leak': 4}
    by_line = {f.line: f.message for f in report.findings}
    # the _start_op shape with the settle-on-raise guard removed
    assert any('call/await raises' in m for m in by_line.values())
    assert any('return unsettled' in m for m in by_line.values())
    assert any('started and dropped' in m for m in by_line.values())


def test_span_clean_twin_passes():
    assert run_corpus('span_clean.py').findings == []


def test_fault_order_catches_cork_before_hook():
    report = run_corpus('faultorder_bad.py')
    assert checkers_hit(report) == {'fault-order': 1}
    (f,) = report.findings
    assert 'precedes the fault hook' in f.message


def test_fault_order_clean_twin_passes():
    assert run_corpus('faultorder_clean.py').findings == []


def test_ack_order_catches_write_before_barrier():
    report = run_corpus('quorum_bad.py')
    assert checkers_hit(report) == {'ack-order': 1}
    (f,) = report.findings
    assert 'precedes the ack barrier' in f.message
    assert 'quorum gate' in f.message


def test_ack_order_clean_twin_passes():
    assert run_corpus('quorum_clean.py').findings == []


def test_drift_catches_knob_metric_and_label_fork():
    report = run_corpus('drift_bad.py')
    assert checkers_hit(report) == {'drift': 3}
    msgs = ' | '.join(f.message for f in report.findings)
    assert 'ZKSTREAM_CORPUS_TURBO' in msgs
    assert 'zkstream_corpus_hidden_total' in msgs
    assert 'conflicting label-key sets' in msgs


def test_drift_clean_twin_passes():
    assert run_corpus('drift_clean.py').findings == []


# -- suppression syntax --

def test_suppression_roundtrip_silences_and_inventories():
    report = run_corpus('suppressed.py')
    assert report.findings == []
    assert len(report.suppressions) == 3
    assert all(s.used for s in report.suppressions)
    assert all(s.reason for s in report.suppressions)
    reasons = {s.reason for s in report.suppressions}
    assert 'measured fast device, inline by design' in reasons


def test_reasonless_suppression_is_a_finding():
    report = run_corpus('suppressed_noreason.py')
    hits = checkers_hit(report)
    # the annotation is rejected AND the underlying finding stands
    assert hits['suppression'] == 2
    assert hits['loop-blocking'] == 2
    assert all('no reason' in f.message for f in report.findings
               if f.checker == 'suppression')


def test_docstring_mention_is_not_an_annotation():
    # analysis/core.py's own docstring spells out the syntax; the
    # tokenizer-based parser must not treat prose as annotations
    report = analyze_paths(
        [os.path.join(PKG, 'analysis', 'core.py')])
    assert [f for f in report.findings
            if f.checker == 'suppression'] == []


def test_suppression_does_not_widen_to_later_raise_points(tmp_path):
    # a suppressed first raise point must NOT hide a second one
    # added behind it — each raise-point line reports independently
    p = tmp_path / 'm.py'
    p.write_text(
        'def f(trace, conn, pkt):\n'
        "    span = trace.start('OP', '/p')\n"
        '    # zkanalyze: ignore[span-leak] getter cannot raise\n'
        '    x = conn.session_id()\n'
        '    conn.notify(pkt)\n'
        '    span.finish()\n'
        '    return x\n')
    report = analyze_paths([str(p)])
    assert [f.line for f in report.findings
            if f.checker == 'span-leak'] == [5]


def test_settle_in_finally_idiom_is_clean(tmp_path):
    p = tmp_path / 'm.py'
    p.write_text(
        'def f(trace, conn, pkt):\n'
        '    try:\n'
        "        span = trace.start('OP', '/p')\n"
        '        conn.request(pkt)\n'
        '    finally:\n'
        '        span.finish()\n')
    assert analyze_paths([str(p)]).findings == []


def test_drift_local_constant_beats_cross_module(tmp_path):
    # a same-named constant in another module must not resolve this
    # module's registration to the wrong (documented) name
    (tmp_path / 'a.py').write_text(
        "METRIC_X = 'zk_documented'\n")
    (tmp_path / 'b.py').write_text(
        "METRIC_X = 'zk_secret'\n"
        'def reg(collector):\n'
        "    collector.counter(METRIC_X, 'h')\n")
    report = analyze_paths([str(tmp_path)],
                           readme_text='only `zk_documented` here')
    assert ['zk_secret' in f.message for f in report.findings
            if f.checker == 'drift'] == [True]


def test_drift_word_boundary_not_substring(tmp_path):
    # a knob that is a PREFIX of a documented knob is still drift
    p = tmp_path / 'm.py'
    p.write_text('import os\n'
                 "V = os.environ.get('ZKSTREAM_FLUSH')\n")
    report = analyze_paths(
        [str(p)], readme_text='documents `ZKSTREAM_FLUSH_CAP`')
    assert [f for f in report.findings if f.checker == 'drift']


def test_drift_ignores_environ_writes(tmp_path):
    p = tmp_path / 'm.py'
    p.write_text('import os\n'
                 "os.environ['ZKSTREAM_CHILD_MARK'] = '1'\n")
    report = analyze_paths([str(p)], readme_text='nothing')
    assert report.findings == []


def test_parse_failures_use_parse_checker(tmp_path):
    p = tmp_path / 'broken.py'
    p.write_text('def f(:\n')
    report = analyze_paths([str(p)])
    (f,) = report.findings
    assert f.checker == 'parse' and 'syntax error' in f.message


def test_suppression_gate_is_unsuppressible(tmp_path):
    p = tmp_path / 'm.py'
    p.write_text('# zkanalyze: skip-file[suppression] nice try\n')
    report = analyze_paths([str(p)])
    (f,) = report.findings
    assert f.checker == 'suppression'
    assert "unknown checker 'suppression'" in f.message


# -- the repo-wide baseline (the tier-1 gate) --

def test_package_zero_findings_baseline():
    report = analyze_paths([PKG],
                           readme_path=os.path.join(REPO,
                                                    'README.md'))
    assert report.findings == [], (
        'the zero-findings baseline regressed:\n'
        + '\n'.join(f.format() for f in report.findings))
    # every suppression must carry a reason and actually suppress
    for s in report.suppressions:
        assert s.reason, s.format()
        assert s.used, 'stale suppression: %s' % (s.format(),)


# -- entry points --

def test_cli_analyze_json_exit_and_schema():
    r = subprocess.run(
        [sys.executable, '-m', 'zkstream_tpu_torch', 'analyze',
         corpus('span_bad.py'), '--readme', CORPUS_README],
        capture_output=True, text=True, cwd=REPO)
    assert r.returncode == 1, r.stderr
    doc = json.loads(r.stdout)
    assert doc['schema'] == 1
    assert len(doc['findings']) == 4
    f = doc['findings'][0]
    assert set(f) == {'file', 'line', 'checker', 'message'}
    assert f['checker'] == 'span-leak'


def test_cli_analyze_package_is_green():
    r = subprocess.run(
        [sys.executable, '-m', 'zkstream_tpu_torch', 'analyze'],
        capture_output=True, text=True, cwd=REPO)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert json.loads(r.stdout)['findings'] == []


def test_tool_list_suppressions():
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, 'tools', 'zkanalyze.py'),
         '--list-suppressions', corpus('suppressed.py')],
        capture_output=True, text=True, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert 'measured fast device, inline by design' in r.stdout
    assert '3 suppression(s)' in r.stdout


# -- tools/lint.py drive-bys (surfaced while building the walker) --

def _lint():
    spec = importlib.util.spec_from_file_location(
        '_lint_under_test', os.path.join(REPO, 'tools', 'lint.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_lint_counts_fstring_usage(tmp_path):
    lint = _lint()
    p = tmp_path / 'm.py'
    p.write_text('import os\n'
                 "banner = f'cwd={os.getcwd()}'\n")
    assert lint.lint_file(p) == []


def test_lint_counts_quoted_annotation_usage(tmp_path):
    lint = _lint()
    p = tmp_path / 'm.py'
    p.write_text('import os\n'
                 "def f(x: 'os.PathLike') -> 'os.PathLike':\n"
                 '    return x\n')
    assert lint.lint_file(p) == []


def test_lint_counts_all_augassign_export(tmp_path):
    lint = _lint()
    p = tmp_path / 'm.py'
    p.write_text('import os\n'
                 'import sys\n'
                 "__all__ = ['os']\n"
                 "__all__ += ['sys']\n")
    assert lint.lint_file(p) == []


def test_lint_still_flags_genuinely_unused(tmp_path):
    lint = _lint()
    p = tmp_path / 'm.py'
    p.write_text('import os\nX = 1\n')
    probs = lint.lint_file(p)
    assert len(probs) == 1 and 'unused import' in probs[0]


def test_lint_fix_rewrites_mechanical_findings(tmp_path):
    lint = _lint()
    p = tmp_path / 'm.py'
    p.write_text('x = 1   \ndef f():\n\treturn x\n')
    msg = lint.fix_file(p)
    assert msg is not None and msg.endswith(': fixed')
    assert p.read_text() == 'x = 1\ndef f():\n    return x\n'
    assert lint.lint_file(p) == []


def test_lint_fix_refuses_string_literal_whitespace(tmp_path):
    lint = _lint()
    p = tmp_path / 'm.py'
    body = 's = """a   \nb"""\n'
    p.write_text(body)
    msg = lint.fix_file(p)
    assert msg is not None and 'NOT fixed' in msg
    assert p.read_text() == body    # untouched
