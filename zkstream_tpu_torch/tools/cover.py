"""Line coverage of the port's package by its tests, stdlib-only: the
port's copy of the JAX package's ``tools/cover.py``, counting the lines
of ``zkstream_tpu_torch/``.

With no ``coverage`` package to lean on, this tool implements line
coverage on :mod:`sys.monitoring` (PEP 669, Python 3.12): a LINE
callback records each (file, line) once and then returns ``DISABLE``
so the instrumented line never fires again — near-zero steady-state
overhead, unlike ``trace``.

Executable-line universes come from walking compiled code objects
(``co_lines``), so the denominator matches what the interpreter could
actually execute.  Usage::

    python zkstream_tpu_torch/tools/cover.py [pytest args...]
    # default: tests/test_torch_*.py -q

(``python -m zkstream_tpu_torch.tools.cover`` works too, but imports the
package's ``__init__`` before the count starts, so its import-time
lines go uncounted.)

Prints per-file and total coverage for zkstream_tpu_torch/ and writes
COVERAGE_TORCH.txt at the repo root.
"""

from __future__ import annotations

import glob
import os
import sys

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)
if ROOT not in sys.path:  # run as a file: the tests import from the root
    sys.path.insert(0, ROOT)

TOOL = 2  # sys.monitoring tool ids 0-5 are free for applications
hits: dict[str, set[int]] = {}


def _on_line(code, line):
    fn = code.co_filename
    if fn.startswith(PKG):
        hits.setdefault(fn, set()).add(line)
    return sys.monitoring.DISABLE


def _executable_lines(path: str) -> set[int]:
    """All line numbers the compiled module could execute."""
    with open(path, 'rb') as f:
        src = f.read()
    lines: set[int] = set()
    stack = [compile(src, path, 'exec')]
    while stack:
        code = stack.pop()
        for const in code.co_consts:
            if hasattr(const, 'co_lines'):
                stack.append(const)
        for _s, _e, ln in code.co_lines():
            if ln is not None:
                lines.add(ln)
    return lines


def main() -> int:
    mon = sys.monitoring
    mon.use_tool_id(TOOL, 'zkstream-cover')
    mon.register_callback(TOOL, mon.events.LINE, _on_line)
    mon.set_events(TOOL, mon.events.LINE)
    try:
        import pytest
        args = sys.argv[1:] or sorted(glob.glob(
            os.path.join(ROOT, 'tests', 'test_torch_*.py'))) + ['-q']
        rc = pytest.main(args)
    finally:
        mon.set_events(TOOL, 0)
        mon.free_tool_id(TOOL)

    rows = []
    tot_hit = tot_all = 0
    for dirpath, _dirs, files in os.walk(PKG):
        for name in sorted(files):
            if not name.endswith('.py'):
                continue
            path = os.path.join(dirpath, name)
            want = _executable_lines(path)
            if not want:
                continue
            got = hits.get(path, set()) & want
            tot_hit += len(got)
            tot_all += len(want)
            rows.append((os.path.relpath(path, ROOT),
                         len(got), len(want)))

    out = ['%-52s %6s %6s %6s' % ('file', 'hit', 'exec', 'pct')]
    for rel, h, w in rows:
        out.append('%-52s %6d %6d %5.1f%%' % (rel, h, w, 100.0 * h / w))
    pct = 100.0 * tot_hit / tot_all if tot_all else 0.0
    out.append('%-52s %6d %6d %5.1f%%' % ('TOTAL', tot_hit, tot_all, pct))
    report = '\n'.join(out)
    print(report)
    with open(os.path.join(ROOT, 'COVERAGE_TORCH.txt'), 'w') as f:
        f.write(report + '\n')
    return int(rc)


if __name__ == '__main__':
    sys.exit(main())
