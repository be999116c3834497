"""zkanalyze core: findings, suppressions, module loading, driver.

The style tier (tools/lint.py) asks "is this file tidy"; this tier
asks "does this file honor the concurrency and tracing contracts the
planes established" — the rules the planes each re-derived by hand
after a violation shipped.  One checker per contract lives in a
sibling module; this module owns everything they share: the
:class:`Finding` record, the suppression syntax, source loading, and
the :func:`analyze_paths` driver `make analyze`, the ``analyze`` CLI
subcommand and tests/test_torch_analyze.py all call.

Suppression syntax (every form REQUIRES a reason string — a bare
annotation is itself a finding):

- ``# zkanalyze: off-loop <reason>`` — same line (or the line above):
  this blocking call is known to run off the event loop (executor
  thunk, documented-blocking sync path).  Sugar for
  ``ignore[loop-blocking]``.
- ``# zkanalyze: ignore[<checker>] <reason>`` — same line (or the
  line above): suppress one checker's finding here.
- ``# zkanalyze: skip-file[<checker>] <reason>`` — anywhere in the
  file: suppress one checker for the whole file.

``--list-suppressions`` prints every annotation with its reason and
whether any finding actually hit it, so stale escapes are visible.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import re
from pathlib import Path

#: Bump when the JSON emission shape changes; consumers key on it.
ANALYZE_SCHEMA = 1

#: Checker registry order (stable report order).  'suppression' is
#: the core's own gate on malformed/reason-less annotations and
#: 'parse' marks unreadable/unparseable files; neither is a valid
#: annotation target.
CHECKER_NAMES = ('loop-blocking', 'await-under-lock', 'span-leak',
                 'fault-order', 'ack-order', 'drift', 'suppression',
                 'parse')
_UNSUPPRESSIBLE = ('suppression', 'parse')

_SUPPRESS_RE = re.compile(
    r'#\s*zkanalyze:\s*(?P<form>off-loop'
    r'|ignore\[(?P<ign>[a-z-]+)\]'
    r'|skip-file\[(?P<skp>[a-z-]+)\])'
    r'[ \t]*(?P<reason>.*)$')


@dataclasses.dataclass
class Finding:
    """One contract violation at ``path:line``."""

    path: str
    line: int
    checker: str
    message: str

    def format(self) -> str:
        return '%s:%d: [%s] %s' % (self.path, self.line,
                                   self.checker, self.message)

    def to_dict(self) -> dict:
        return {'file': self.path, 'line': self.line,
                'checker': self.checker, 'message': self.message}


@dataclasses.dataclass
class Suppression:
    """One parsed ``# zkanalyze:`` annotation."""

    path: str
    line: int
    checker: str
    reason: str
    file_level: bool
    used: bool = False

    def format(self) -> str:
        scope = 'file' if self.file_level else 'line'
        state = 'used' if self.used else 'UNUSED'
        return '%s:%d: [%s] %s (%s, %s)' % (
            self.path, self.line, self.checker,
            self.reason or '<no reason>', scope, state)

    def to_dict(self) -> dict:
        return {'file': self.path, 'line': self.line,
                'checker': self.checker, 'reason': self.reason,
                'file_level': self.file_level, 'used': self.used}


class Module:
    """One parsed source file plus its suppression table."""

    def __init__(self, path: str, text: str, tree: ast.AST):
        self.path = path
        self.text = text
        self.lines = text.splitlines()
        self.tree = tree
        self.suppressions: list[Suppression] = []
        self.bad_suppressions: list[Finding] = []
        self._parse_suppressions()

    def _comments(self):
        """(line, text) for every real comment token — docstrings
        that merely *mention* the annotation syntax stay inert."""
        import io
        import tokenize
        try:
            toks = tokenize.generate_tokens(
                io.StringIO(self.text).readline)
            return [(t.start[0], t.string) for t in toks
                    if t.type == tokenize.COMMENT]
        except (tokenize.TokenError, IndentationError,
                SyntaxError):
            return [(i, line) for i, line in
                    enumerate(self.lines, 1) if '#' in line]

    def _parse_suppressions(self) -> None:
        for i, line in self._comments():
            # the annotation marker is the tool name followed by a
            # colon; prose comments may mention the bare name freely
            if 'zkanalyze' + ':' not in line:
                continue
            m = _SUPPRESS_RE.search(line)
            if m is None:
                self.bad_suppressions.append(Finding(
                    self.path, i, 'suppression',
                    'unparseable zkanalyze annotation (forms: '
                    'off-loop / ignore[checker] / '
                    'skip-file[checker], each with a reason)'))
                continue
            form = m.group('form')
            if form == 'off-loop':
                checker, file_level = 'loop-blocking', False
            elif form.startswith('ignore'):
                checker, file_level = m.group('ign'), False
            else:
                checker, file_level = m.group('skp'), True
            reason = m.group('reason').strip()
            suppressible = [c for c in CHECKER_NAMES
                            if c not in _UNSUPPRESSIBLE]
            if checker not in suppressible:
                # the annotation gate and parse failures must not be
                # annotatable away
                self.bad_suppressions.append(Finding(
                    self.path, i, 'suppression',
                    'unknown checker %r (suppressible: %s)'
                    % (checker, ', '.join(suppressible))))
                continue
            if not reason:
                self.bad_suppressions.append(Finding(
                    self.path, i, 'suppression',
                    '%s suppression carries no reason' % (checker,)))
                continue
            self.suppressions.append(Suppression(
                self.path, i, checker, reason, file_level))

    def file_suppression(self, checker: str) -> Suppression | None:
        for s in self.suppressions:
            if s.file_level and s.checker == checker:
                return s
        return None

    def line_suppression(self, checker: str,
                         line: int) -> Suppression | None:
        """A line suppression covers its own line and the one below
        (annotation above a long statement)."""
        for s in self.suppressions:
            if (not s.file_level and s.checker == checker
                    and s.line in (line, line - 1)):
                return s
        return None

    def src(self, node: ast.AST) -> str:
        """Source text of a node (for receiver-name heuristics)."""
        try:
            return ast.unparse(node)
        except Exception:
            return ''


class Context:
    """Shared cross-module state (the drift checker aggregates here;
    the driver owns the lifecycle)."""

    def __init__(self, readme_text: str | None):
        self.readme_text = readme_text
        self.modules: dict[str, Module] = {}
        #: module-level ``NAME = 'str'`` constants, for resolving
        #: metric names registered through imported constants
        self.constants: dict[str, str] = {}
        #: drift-checker aggregation: see analysis/drift.py
        self.env_reads: list[tuple[str, str, int]] = []
        self.metric_regs: list[tuple[str, str, int]] = []
        self.label_uses: dict[str, dict[frozenset,
                                        tuple[str, int]]] = {}


def load_module(path: Path) -> Module | Finding:
    try:
        text = path.read_text()
    except OSError as e:
        return Finding(str(path), 0, 'parse',
                       'cannot read: %s' % (e,))
    try:
        tree = ast.parse(text, filename=str(path))
    except SyntaxError as e:
        return Finding(str(path), e.lineno or 0, 'parse',
                       'syntax error: %s' % (e.msg,))
    return Module(str(path), text, tree)


def iter_py_files(paths: list[str]) -> list[Path]:
    out: list[Path] = []
    for arg in paths:
        p = Path(arg)
        if p.is_dir():
            out.extend(sorted(f for f in p.rglob('*.py')
                              if '__pycache__' not in f.parts))
        else:
            out.append(p)
    return out


def find_readme(paths: list[str]) -> Path | None:
    """Locate the repo README by walking up from the first target —
    the knob/metric inventory the drift checker diffs against."""
    if not paths:
        return None
    start = Path(paths[0]).resolve()
    if start.is_file():
        start = start.parent
    for d in (start, *start.parents):
        cand = d / 'README.md'
        if cand.is_file():
            return cand
    return None


@dataclasses.dataclass
class Report:
    """One analysis run: findings (suppressions already applied),
    every parsed suppression, and the file count."""

    findings: list[Finding]
    suppressions: list[Suppression]
    nfiles: int

    def to_dict(self) -> dict:
        return {
            'schema': ANALYZE_SCHEMA,
            'files': self.nfiles,
            'findings': [f.to_dict() for f in self.findings],
            'suppressions': [s.to_dict()
                             for s in self.suppressions],
        }

    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)


def _checkers():
    # imported here, not at module top: the checker modules import
    # this one for Finding/Module
    from . import ackorder, drift, faultorder, locks, loopblock, spans
    return ((loopblock.NAME, loopblock.check),
            (locks.NAME, locks.check),
            (spans.NAME, spans.check),
            (faultorder.NAME, faultorder.check),
            (ackorder.NAME, ackorder.check),
            (drift.NAME, drift.check))


def analyze_paths(paths: list[str],
                  readme_text: str | None = None,
                  readme_path: str | None = None) -> Report:
    """Run every checker over ``paths`` (files or directories).

    README resolution for the drift checker: explicit ``readme_text``
    wins, then ``readme_path``, then a walk up from the first target;
    with none found the README diff is skipped (the other checkers
    still run)."""
    from . import drift

    if readme_text is None:
        rp = Path(readme_path) if readme_path else find_readme(paths)
        if rp is not None and rp.is_file():
            readme_text = rp.read_text()
    ctx = Context(readme_text)
    files = iter_py_files(paths)
    modules: list[Module] = []
    findings: list[Finding] = []
    for f in files:
        loaded = load_module(f)
        if isinstance(loaded, Finding):
            findings.append(loaded)
            continue
        modules.append(loaded)
        ctx.modules[loaded.path] = loaded
    for m in modules:        # constants first: cross-module refs
        _collect_constants(m, ctx)
    checkers = _checkers()
    for m in modules:
        findings.extend(m.bad_suppressions)
        for name, check in checkers:
            fsup = m.file_suppression(name)
            if fsup is not None:
                fsup.used = True
                continue
            for f in check(m, ctx):
                sup = m.line_suppression(f.checker, f.line)
                if sup is not None:
                    sup.used = True
                    continue
                findings.append(f)
    for f in drift.finalize(ctx):
        m = ctx.modules.get(f.path)
        if m is not None:
            fsup = m.file_suppression(f.checker)
            if fsup is not None:
                fsup.used = True
                continue
            sup = m.line_suppression(f.checker, f.line)
            if sup is not None:
                sup.used = True
                continue
        findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.checker))
    sups = [s for m in modules for s in m.suppressions]
    return Report(findings, sups, len(files))


def _collect_constants(module: Module, ctx: Context) -> None:
    for node in module.tree.body:
        if (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    ctx.constants.setdefault(t.id, node.value.value)


def dotted_name(node: ast.AST) -> str | None:
    """Flatten ``a.b.c`` to ``'a.b.c'`` (None when the chain has a
    non-Name root: calls, subscripts)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return '.'.join(reversed(parts))


def import_aliases(tree: ast.AST) -> dict[str, str]:
    """Map local names to dotted origins: ``import subprocess as sp``
    -> ``sp: subprocess``; ``from time import sleep`` ->
    ``sleep: time.sleep``."""
    out: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split('.')[0]] = a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                if a.name != '*':
                    out[a.asname or a.name] = (
                        '%s.%s' % (node.module, a.name))
    return out


def resolve_call(node: ast.Call,
                 aliases: dict[str, str]) -> str | None:
    """Resolve a call's target to a dotted name through the module's
    import aliases (``sp.run`` -> ``subprocess.run``)."""
    name = dotted_name(node.func)
    if name is None:
        return None
    head, _, rest = name.partition('.')
    head = aliases.get(head, head)
    return '%s.%s' % (head, rest) if rest else head


def walk_no_funcs(node: ast.AST):
    """``ast.walk`` that does not descend into nested function or
    lambda bodies (their code runs at some other time, in some other
    context — not at this point of the enclosing function)."""
    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        for child in ast.iter_child_nodes(n):
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef, ast.Lambda)):
                continue
            stack.append(child)


class FuncStackVisitor(ast.NodeVisitor):
    """Visitor tracking the enclosing function chain in ``stack``
    (FunctionDef / AsyncFunctionDef / Lambda nodes, outermost
    first)."""

    def __init__(self):
        self.stack: list[ast.AST] = []

    def _push(self, node):
        self.stack.append(node)
        self.generic_visit(node)
        self.stack.pop()

    visit_FunctionDef = _push
    visit_AsyncFunctionDef = _push
    visit_Lambda = _push
