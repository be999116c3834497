"""Checker: thread-lock bodies must not suspend; shared attributes
must not be read-modify-written across an ``await``.

The ``_apply_until`` class of bug: classes shared across the
loop/thread boundary (anything owning a ``threading.Lock`` — the
replica stores, the ingest placer) interleave loop callbacks with
worker threads.  Two contract halves:

- **await-under-lock** — an ``await`` inside a *sync* ``with <lock>:``
  body holds a thread lock across a suspension point: every thread
  contending for that lock stalls until the loop resumes the
  coroutine, and a resume that needs the same thread deadlocks.
  (``async with`` on asyncio locks is fine and not matched.)
- **rmw-across-await** — in an async method of a lock-owning class, a
  ``self.X`` read followed by an ``await`` followed by a ``self.X``
  write is a lost-update window: the thread side can interleave at
  the suspension and its update is overwritten.

Receiver heuristic for the first half: a ``with`` item whose source
names a recorded threading-lock attribute of the enclosing class, or
whose name has a ``lock``/``mutex`` segment.
"""

from __future__ import annotations

import ast

from .core import (Context, Finding, Module, dotted_name,
                   import_aliases, walk_no_funcs)

NAME = 'await-under-lock'

_LOCK_FACTORIES = {'threading.Lock', 'threading.RLock',
                   'threading.Condition', 'threading.Semaphore',
                   'threading.BoundedSemaphore'}


def _is_lockish_name(text: str) -> bool:
    segs = [s for s in
            text.replace('(', ' ').replace(')', ' ')
            .replace('.', ' ').replace('_', ' ').lower().split()
            if s]
    return any(s in ('lock', 'mutex', 'rlock') for s in segs)


def _lock_attrs(cls: ast.ClassDef,
                aliases: dict[str, str]) -> set[str]:
    """Attribute names assigned a threading lock anywhere in the
    class body (``self._lock = threading.Lock()``)."""
    out: set[str] = set()
    for node in ast.walk(cls):
        if not (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)):
            continue
        name = dotted_name(node.value.func)
        if name is None:
            continue
        head, _, rest = name.partition('.')
        resolved = aliases.get(head, head)
        full = '%s.%s' % (resolved, rest) if rest else resolved
        if full not in _LOCK_FACTORIES:
            continue
        for t in node.targets:
            if (isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == 'self'):
                out.add(t.attr)
    return out


def _self_attr(node: ast.AST) -> str | None:
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == 'self'):
        return node.attr
    return None


def _check_with_bodies(module: Module, cls_locks: set[str],
                       tree: ast.AST, findings: list[Finding],
                       seen_withs: set[int],
                       seen_awaits: set[int]) -> None:
    """``seen_withs`` keeps a With scoped to its innermost class
    (the caller walks classes innermost-first); ``seen_awaits``
    yields ONE finding per await even under nested lock blocks."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.With) or id(node) in seen_withs:
            continue
        seen_withs.add(id(node))
        held = None
        for item in node.items:
            expr = item.context_expr
            attr = _self_attr(expr)
            text = module.src(expr)
            if ((attr is not None and attr in cls_locks)
                    or _is_lockish_name(text)):
                held = text
                break
        if held is None:
            continue
        for sub in node.body:
            for inner in walk_no_funcs(sub):
                if (isinstance(inner, ast.Await)
                        and id(inner) not in seen_awaits):
                    seen_awaits.add(id(inner))
                    findings.append(Finding(
                        module.path, inner.lineno, NAME,
                        'await while holding thread lock %r — '
                        'every contending thread stalls across the '
                        'suspension; release first or use an '
                        'asyncio primitive' % (held,)))


def _check_rmw(module: Module, cls: ast.ClassDef,
               lock_attrs: set[str],
               findings: list[Finding]) -> None:
    for fn in cls.body:
        if not isinstance(fn, ast.AsyncFunctionDef):
            continue
        reads: dict[str, list[int]] = {}
        writes: list[tuple[str, int, ast.AST]] = []
        awaits: list[int] = []
        for node in walk_no_funcs(fn):
            if isinstance(node, ast.Await):
                awaits.append(node.lineno)
                continue
            attr = _self_attr(node)
            if attr is None or attr in lock_attrs:
                continue
            if isinstance(node.ctx, ast.Load):
                reads.setdefault(attr, []).append(node.lineno)
            elif isinstance(node.ctx, ast.Store):
                writes.append((attr, node.lineno, node))
        seen: set[str] = set()
        for attr, lw, _node in writes:
            if attr in seen:
                continue
            spans = any(lr < lw and any(lr <= la <= lw
                                        for la in awaits)
                        for lr in reads.get(attr, ()))
            if spans:
                seen.add(attr)
                findings.append(Finding(
                    module.path, lw, NAME,
                    'self.%s read before an await and written after '
                    'it in async %s of lock-owning class %s — a '
                    'thread can interleave at the suspension and '
                    'lose its update; recompute after the await or '
                    'restructure' % (attr, fn.name, cls.name)))


def check(module: Module, ctx: Context) -> list[Finding]:
    findings: list[Finding] = []
    aliases = import_aliases(module.tree)
    class_nodes = [n for n in ast.walk(module.tree)
                   if isinstance(n, ast.ClassDef)]
    per_class: dict[int, set[str]] = {
        id(cls): _lock_attrs(cls, aliases) for cls in class_nodes}
    # innermost class first (nested classes start on later lines),
    # so a With binds to its OWN class's lock attributes; the final
    # module-level pass catches lock-named managers outside classes
    seen_withs: set[int] = set()
    seen_awaits: set[int] = set()
    for cls in sorted(class_nodes, key=lambda c: -c.lineno):
        _check_with_bodies(module, per_class[id(cls)], cls,
                           findings, seen_withs, seen_awaits)
    _check_with_bodies(module, set(), module.tree, findings,
                       seen_withs, seen_awaits)
    for cls in class_nodes:
        if per_class[id(cls)]:
            _check_rmw(module, cls, per_class[id(cls)], findings)
    return findings
