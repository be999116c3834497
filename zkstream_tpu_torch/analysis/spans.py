"""Checker: every span started must settle on all paths.

The abandoned-span class: an op that dies between
``trace.start()`` and the pending-table insert leaves a phantom
"open" span in the ring forever — the chaos campaigns assert
``TraceRing.open_spans()`` is empty at teardown, but only a schedule
that happens to hit the window catches it dynamically.  This checker
proves it structurally: a variable assigned from ``<ring>.start(...)``
(receiver naming ``trace``/``ring``/``span``) must, on every path out
of the function, either

- **settle** — ``var.finish(...)`` / ``var.settle(...)``, or
- **escape** — ownership handed off: stored into an attribute /
  container (``req.span = span``), passed to a call, returned,
  yielded, aliased, or captured by a nested function (the receiver
  settles it, as io/connection.py does for request spans).

Exception edges: an ``await`` (or bare ``raise``) reached while the
span is open and unprotected leaks it if the awaited future raises —
unless an enclosing ``try`` settles the span in a handler or
``finally`` (the client.py ``_start_op`` idiom).  A start whose
result is dropped outright is flagged too (``TraceRing.note`` is the
instant-settle API for that).

Loops are approximated (body runs zero or one time); ``with`` bodies
are inlined.  This is a project lint, not a prover: name heuristics
pick the spans, and ``# zkanalyze: ignore[span-leak] <reason>``
documents the escapes it cannot see.
"""

from __future__ import annotations

import ast
import re

from .core import Context, Finding, Module, walk_no_funcs

NAME = 'span-leak'

_RECV_RE = re.compile(r'(?i)(trace|ring|span)')
_SETTLE_ATTRS = ('finish', 'settle')

# abstract states of one tracked span variable
_OPEN, _SETTLED, _ESCAPED = 'open', 'settled', 'escaped'


def _is_start_call(node: ast.AST, module: Module) -> bool:
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == 'start'
            and bool(node.args or node.keywords)
            and _RECV_RE.search(module.src(node.func.value))
            is not None)


def _settles(stmt: ast.AST, var: str) -> bool:
    for node in ast.walk(stmt):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _SETTLE_ATTRS
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == var):
            return True
    return False


def _escapes(stmt: ast.AST, var: str) -> bool:
    """Ownership leaves this function: var stored somewhere, passed
    somewhere, returned/yielded, aliased, or closure-captured."""
    for node in ast.walk(stmt):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            for inner in ast.walk(node):
                if isinstance(inner, ast.Name) and inner.id == var:
                    return True
            continue
        if isinstance(node, ast.Call):
            for arg in list(node.args) + [k.value
                                          for k in node.keywords]:
                if isinstance(arg, ast.Name) and arg.id == var:
                    return True
        elif isinstance(node, ast.Assign):
            if (isinstance(node.value, ast.Name)
                    and node.value.id == var):
                return True     # alias or req.span = var
        elif isinstance(node, (ast.Return, ast.Yield,
                               ast.YieldFrom)):
            v = node.value
            if v is not None:
                for inner in ast.walk(v):
                    if (isinstance(inner, ast.Name)
                            and inner.id == var):
                        return True
        elif isinstance(node, (ast.List, ast.Tuple, ast.Set,
                               ast.Dict)):
            for inner in ast.iter_child_nodes(node):
                if isinstance(inner, ast.Name) and inner.id == var:
                    return True
    return False


def _has_raise_point(stmt: ast.AST, var: str) -> bool:
    """The statement can raise past an open span: an ``await``, or a
    call on anything other than the span itself (``conn.request(pkt)``
    raising between start and the pending-table insert IS the abandoned-span
    leak; ``span.xid = ...`` attribute stamps are safe)."""
    for node in walk_no_funcs(stmt):
        if isinstance(node, ast.Await):
            return True
        if isinstance(node, ast.Call):
            f = node.func
            on_var = (isinstance(f, ast.Attribute)
                      and isinstance(f.value, ast.Name)
                      and f.value.id == var)
            if not on_var:
                return True
    return False


class _Tracker:
    """Walk the statements after one ``start()`` assign, tracking the
    span variable's state over every structural path."""

    def __init__(self, module: Module, var: str, start_line: int):
        self.module = module
        self.var = var
        self.start_line = start_line
        self.findings: list[Finding] = []
        #: one finding per raise-point LINE (not one per span: a
        #: suppression on the first raise point must not silently
        #: cover later ones added behind it)
        self._raise_lines: set[int] = set()

    def _flag(self, line: int, msg: str) -> None:
        self.findings.append(Finding(
            self.module.path, line, NAME,
            'span %r (started line %d) %s'
            % (self.var, self.start_line, msg)))

    def run_block(self, stmts: list[ast.stmt], state: str,
                  protected: bool) -> set[str]:
        """Returns the possible states at the end of the block;
        terminal paths (return/raise) report and vanish."""
        states = {state}
        for stmt in stmts:
            if _OPEN not in states:
                break           # settled/escaped on all live paths
            nxt: set[str] = set()
            for s in states:
                nxt |= self._step(stmt, s, protected)
            states = nxt
            if not states:
                break           # every path terminated
        return states

    def _step(self, stmt: ast.stmt, state: str,
              protected: bool) -> set[str]:
        var = self.var
        if state != _OPEN:
            return {state}
        if isinstance(stmt, ast.Return):
            if stmt.value is not None and _escapes(stmt, var):
                return set()
            self._flag(stmt.lineno,
                       'may return unsettled here — finish/settle '
                       'it (or hand it off) first')
            return set()
        if isinstance(stmt, ast.Raise):
            if not protected:
                self._flag(stmt.lineno,
                           'raised past while open — settle before '
                           'raising (status="abandoned"/"error")')
            return set()
        if isinstance(stmt, ast.If):
            out = self.run_block(stmt.body, state, protected)
            out |= self.run_block(stmt.orelse, state, protected)
            return out
        if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
            once = self.run_block(stmt.body, state, protected)
            skip = self.run_block(stmt.orelse, state, protected)
            return once | skip
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            if _escapes(stmt, var) or _settles(stmt, var):
                return self._leaf(stmt, state, protected)
            return self.run_block(stmt.body, state, protected)
        if isinstance(stmt, ast.Try):
            return self._try(stmt, state, protected)
        return self._leaf(stmt, state, protected)

    def _leaf(self, stmt: ast.stmt, state: str,
              protected: bool) -> set[str]:
        if _escapes(stmt, self.var):
            return {_ESCAPED}
        if _settles(stmt, self.var):
            return {_SETTLED}
        if (not protected and stmt.lineno not in self._raise_lines
                and _has_raise_point(stmt, self.var)):
            self._raise_lines.add(stmt.lineno)
            self._flag(stmt.lineno,
                       'leaks if this call/await raises — settle it '
                       'in a finally/except (the _start_op idiom), '
                       'or hand it off first')
        return {state}

    def _try(self, stmt: ast.Try, state: str,
             protected: bool) -> set[str]:
        var = self.var
        handlers_settle = bool(stmt.handlers) and all(
            any(_settles(s, var) or _escapes(s, var)
                for s in h.body)
            for h in stmt.handlers)
        final_settles = any(_settles(s, var) or _escapes(s, var)
                            for s in stmt.finalbody)
        body_protected = (protected or handlers_settle
                          or final_settles)
        out_body = self.run_block(stmt.body, state, body_protected)
        out = set()
        for s in out_body:      # orelse continues the success path
            out |= self.run_block(stmt.orelse, s, protected)
        for h in stmt.handlers:
            out |= self.run_block(h.body, state, protected)
        if stmt.finalbody:
            joined = set()
            for s in out or {state}:
                joined |= self.run_block(stmt.finalbody, s,
                                         protected)
            out = joined
        return out


def _function_blocks(fn: ast.AST):
    """Yield (block, idx) pairs positioning every statement of ``fn``
    without descending into nested functions."""
    stack = [fn.body]
    while stack:
        block = stack.pop()
        for i, stmt in enumerate(block):
            yield block, i, stmt
            if isinstance(stmt, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                continue
            for field in ('body', 'orelse', 'finalbody'):
                sub = getattr(stmt, field, None)
                if sub:
                    stack.append(sub)
            for h in getattr(stmt, 'handlers', ()) or ():
                stack.append(h.body)


def _spine(fn: ast.AST, target_block: list) -> list[list[ast.stmt]]:
    """Continuation blocks from the target's block outward to the
    function body (each sliced after the enclosing statement by the
    caller)."""
    # Path reconstruction: walk down from fn.body looking for the
    # block object identity.
    def descend(block, acc):
        if block is target_block:
            return acc + [block]
        for stmt in block:
            if isinstance(stmt, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                continue
            subs = [getattr(stmt, f, None)
                    for f in ('body', 'orelse', 'finalbody')]
            subs += [h.body for h in
                     getattr(stmt, 'handlers', ()) or ()]
            for sub in subs:
                if not sub:
                    continue
                found = descend(sub, acc + [(block, stmt)])
                if found is not None:
                    return found
        return None
    return descend(fn.body, [])


def check(module: Module, ctx: Context) -> list[Finding]:
    findings: list[Finding] = []
    funcs = [n for n in ast.walk(module.tree)
             if isinstance(n, (ast.FunctionDef,
                               ast.AsyncFunctionDef))]
    for fn in funcs:
        for block, i, stmt in list(_function_blocks(fn)):
            start_call = None
            var = None
            if (isinstance(stmt, ast.Assign)
                    and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and _is_start_call(stmt.value, module)):
                start_call = stmt.value
                var = stmt.targets[0].id
            elif (isinstance(stmt, ast.Expr)
                    and _is_start_call(stmt.value, module)):
                findings.append(Finding(
                    module.path, stmt.lineno, NAME,
                    'span started and dropped — nothing can settle '
                    'it (use TraceRing.note() for instant events)'))
                continue
            if start_call is None:
                continue
            tracker = _Tracker(module, var, stmt.lineno)
            path = _spine(fn, block)
            if path is None:
                continue
            # innermost block first: statements after the start.
            # A start inside a try body whose handlers/finally
            # settle the var is exception-protected from the top.
            protected = False
            if len(path) > 1:
                container = path[-2][1]
                if (isinstance(container, ast.Try)
                        and container.body is block):
                    protected = (
                        any(_settles(s, var) or _escapes(s, var)
                            for s in container.finalbody)
                        or (bool(container.handlers) and all(
                            any(_settles(s, var) or _escapes(s, var)
                                for s in h.body)
                            for h in container.handlers)))
            states = tracker.run_block(block[i + 1:], _OPEN,
                                       protected)
            # then each enclosing block's continuation after the
            # statement that contained us — flowing through a Try
            # container's orelse/finalbody first, so the canonical
            # settle-in-finally idiom resolves to SETTLED
            cur_block = block
            for enc_block, enc_stmt in reversed(path[:-1]):
                if _OPEN not in states:
                    break
                if isinstance(enc_stmt, ast.Try):
                    tails = []
                    if cur_block is enc_stmt.body:
                        tails = [enc_stmt.orelse, enc_stmt.finalbody]
                    elif cur_block is not enc_stmt.finalbody:
                        tails = [enc_stmt.finalbody]
                    for tail in tails:
                        nxt = set()
                        for s in states:
                            nxt |= tracker.run_block(tail, s, False)
                        states = nxt
                j = enc_block.index(enc_stmt)
                nxt = set()
                for s in states:
                    nxt |= tracker.run_block(enc_block[j + 1:], s,
                                             False)
                states = nxt
                cur_block = enc_block
            if _OPEN in states:
                end = getattr(fn.body[-1], 'end_lineno',
                              fn.body[-1].lineno)
                tracker._flag(end, 'can reach the end of %s() '
                              'unsettled' % (fn.name,))
            findings.extend(tracker.findings)
    return findings
