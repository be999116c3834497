"""zkanalyze: the repo's semantic static-analysis tier.

tools/lint.py answers "is this file tidy"; this package answers
"does this code honor the plane contracts" — one AST checker per
rule the PR trail established the hard way:

- ``loop-blocking`` — blocking calls (fsync/sleep/subprocess/sync
  dials) must not run on the event loop;
- ``await-under-lock`` — no suspension while holding a thread lock,
  no shared-attribute read-modify-write across an ``await``;
- ``span-leak`` — every ``TraceRing.start`` settles or escapes on
  all paths, exception edges included;
- ``fault-order`` — fault-injection hooks screen frames BEFORE the
  send-plane cork boundary;
- ``drift`` — every ``ZKSTREAM_*`` knob and registered metric is in
  the README inventory; label-key sets never fork.

Entry points: ``make analyze`` / ``python tools/zkanalyze.py``
(human report), ``python -m zkstream_tpu_torch analyze`` (JSON for
harnesses), and :func:`analyze_paths` for tests.  Suppressions
(``# zkanalyze: off-loop/ignore[..]/skip-file[..] <reason>``) are
specified in analysis/core.py and printed by
``--list-suppressions``.
"""

from .core import (ANALYZE_SCHEMA, CHECKER_NAMES, Context, Finding,
                   Module, Report, Suppression, analyze_paths,
                   find_readme)

__all__ = ['ANALYZE_SCHEMA', 'CHECKER_NAMES', 'Context', 'Finding',
           'Module', 'Report', 'Suppression', 'analyze_paths',
           'find_readme']
