"""Checker: knobs and metrics must not drift from the README
inventory, and a metric's label set must be fixed.

Every ``ZKSTREAM_*`` environment read and every metric name
registered on a collector is part of the operator surface — the
README's knob mentions and metrics table ARE the inventory operators
grep.  A knob or series that exists only in code is invisible until
the incident where it mattered; the reference gates the same way by
hand-reviewing artedi registrations.

Three rules:

- every ``os.environ.get('ZKSTREAM_X')`` / ``os.environ['ZKSTREAM_X']``
  / ``os.getenv('ZKSTREAM_X')`` name must appear in README.md;
- every registered metric name (``collector.counter/histogram/gauge/
  multi_gauge``) must appear in README.md — names are resolved
  through module-level ``METRIC_* = '...'`` constants (cross-module,
  via the shared constant table) and, for loop/prefix registrations,
  by scanning the registering function for metric-shaped string
  literals;
- a metric's label KEY set must be identical at every ``increment`` /
  ``observe`` call site that passes a literal dict — the Prometheus
  rule that a series' label names are fixed at registration
  (mismatched keys silently split one series into two).
"""

from __future__ import annotations

import ast
import re

from .core import Context, Finding, Module, dotted_name

NAME = 'drift'

ENV_NAME_RE = re.compile(r'^ZKSTREAM_[A-Z0-9_]+$')
METRIC_NAME_RE = re.compile(r'^(zk|zookeeper|zkstream)_[a-z0-9_]+$')
REG_ATTRS = ('counter', 'histogram', 'gauge', 'multi_gauge')
_REG_RECV_RE = re.compile(r'(?i)(collector|source)')
USE_ATTRS = ('increment', 'observe')


def _const_str(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _collect_env_reads(module: Module, ctx: Context) -> None:
    for node in ast.walk(module.tree):
        name = None
        if isinstance(node, ast.Call):
            target = dotted_name(node.func) or ''
            if (target.endswith('environ.get')
                    or target.endswith('environ.pop')
                    or target.endswith('os.getenv')
                    or target == 'getenv') and node.args:
                name = _const_str(node.args[0])
        elif (isinstance(node, ast.Subscript)
                and isinstance(node.ctx, ast.Load)
                and (dotted_name(node.value) or '')
                .endswith('environ')):
            # Load only: os.environ['X'] = '1' is a write (the
            # child-process handshake pattern), not a knob read
            name = _const_str(node.slice)
        if name is not None and ENV_NAME_RE.match(name):
            ctx.env_reads.append((name, module.path, node.lineno))


def _enclosing_function_strings(module: Module,
                                call: ast.Call) -> list[str]:
    """Metric-shaped string literals in the function containing
    ``call`` — the fallback for loop/prefix registrations
    (``collector.gauge(prefix + name, ...)`` over a literal table,
    server/persist.py / io/ingest.py style)."""
    best: ast.AST | None = None
    for fn in ast.walk(module.tree):
        if not isinstance(fn, (ast.FunctionDef,
                               ast.AsyncFunctionDef)):
            continue
        if (fn.lineno <= call.lineno
                and call.lineno <= (fn.end_lineno or fn.lineno)):
            if best is None or fn.lineno > best.lineno:
                best = fn
    if best is None:
        return []
    out = []
    for node in ast.walk(best):
        s = _const_str(node)
        if s is not None and METRIC_NAME_RE.match(s):
            out.append(s)
    return out


def _collect_registrations(module: Module, ctx: Context,
                           findings: list[Finding]) -> None:
    #: (attr-or-var name) -> metric name, for label-use resolution
    var_map: dict[str, str] = {}
    local_consts: dict[str, str] = {}
    for node in module.tree.body:
        if (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    local_consts[t.id] = node.value.value
    assign_of: dict[int, ast.Assign] = {}
    for node in ast.walk(module.tree):
        if (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)):
            assign_of[id(node.value)] = node
    for reg in ast.walk(module.tree):
        if not (isinstance(reg, ast.Call)
                and isinstance(reg.func, ast.Attribute)
                and reg.func.attr in REG_ATTRS
                and _REG_RECV_RE.search(module.src(reg.func.value))
                and reg.args):
            continue
        assign = assign_of.get(id(reg))
        arg0 = reg.args[0]
        names: list[str] = []
        resolved_one = _const_str(arg0)
        if resolved_one is None and isinstance(arg0, ast.Name):
            # the module's OWN constant wins; the cross-module table
            # only resolves imported names (a same-named constant in
            # another module must not shadow this one)
            resolved_one = local_consts.get(
                arg0.id, ctx.constants.get(arg0.id))
        if resolved_one is not None:
            names = [resolved_one]
        else:
            names = _enclosing_function_strings(module, reg)
            if not names:
                findings.append(Finding(
                    module.path, reg.lineno, NAME,
                    'metric name %r is not statically resolvable '
                    '(no constant, no metric-shaped literal in the '
                    'registering function) — the README inventory '
                    'cannot be checked'
                    % (module.src(arg0),)))
                continue
        if assign is not None and resolved_one is not None:
            for t in assign.targets:
                if isinstance(t, ast.Attribute):
                    var_map[t.attr] = resolved_one
                elif isinstance(t, ast.Name):
                    var_map[t.id] = resolved_one
        for n in names:
            ctx.metric_regs.append((n, module.path, reg.lineno))
    _collect_label_uses(module, ctx, var_map)


def _collect_label_uses(module: Module, ctx: Context,
                        var_map: dict[str, str]) -> None:
    for node in ast.walk(module.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in USE_ATTRS):
            continue
        recv = node.func.value
        key = None
        if isinstance(recv, ast.Attribute):
            key = recv.attr
        elif isinstance(recv, ast.Name):
            key = recv.id
        metric = var_map.get(key or '')
        if metric is None:
            continue
        labels = None
        want_pos = 0 if node.func.attr == 'increment' else 1
        if len(node.args) > want_pos:
            labels = node.args[want_pos]
        for kw in node.keywords:
            if kw.arg == 'labels':
                labels = kw.value
        if not isinstance(labels, ast.Dict):
            continue            # dynamic label dict: unresolvable
        keys = []
        for k in labels.keys:
            s = _const_str(k)
            if s is None:
                break
            keys.append(s)
        else:
            ctx.label_uses.setdefault(metric, {}).setdefault(
                frozenset(keys), (module.path, node.lineno))


def check(module: Module, ctx: Context) -> list[Finding]:
    findings: list[Finding] = []
    _collect_env_reads(module, ctx)
    _collect_registrations(module, ctx, findings)
    return findings


def finalize(ctx: Context) -> list[Finding]:
    """Cross-module phase: diff the aggregated inventories against
    the README and check label-set consistency."""
    findings: list[Finding] = []
    readme = ctx.readme_text
    if readme is not None:
        def documented(name: str) -> bool:
            # word-boundary match, not substring: a knob named
            # ZKSTREAM_FLUSH must not ride on ZKSTREAM_FLUSH_CAP's
            # documentation (all inventory names are \w-only, so \b
            # is exact)
            return re.search(r'\b%s\b' % re.escape(name),
                             readme) is not None

        seen: set[str] = set()
        for name, path, line in ctx.env_reads:
            if name in seen or documented(name):
                continue
            seen.add(name)
            findings.append(Finding(
                path, line, NAME,
                'env knob %s is read here but undocumented in '
                'README.md — add it to the knob inventory'
                % (name,)))
        seen = set()
        for name, path, line in ctx.metric_regs:
            if name in seen or documented(name):
                continue
            seen.add(name)
            findings.append(Finding(
                path, line, NAME,
                'metric %s is registered here but missing from the '
                'README metrics table' % (name,)))
    for metric, uses in sorted(ctx.label_uses.items()):
        if len(uses) <= 1:
            continue
        sets = sorted(sorted(s) for s in uses)
        path, line = sorted(uses.values())[0]
        findings.append(Finding(
            path, line, NAME,
            'metric %s is used with conflicting label-key sets %s '
            '— label names are fixed at registration; one series '
            'must not fork' % (metric, sets)))
    return findings
