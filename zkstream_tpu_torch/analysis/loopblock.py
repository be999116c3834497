"""Checker: blocking calls must never run on the event loop.

The durability rule — "fsync never blocks the loop" — plus its
generalization: ``os.fsync``, ``time.sleep``, ``subprocess`` waits and
synchronous socket dials belong on an executor thread (or in a sync
function the loop never runs).  A violation stalls EVERY session the
loop serves for the duration of the call; the WAL's group fsync and
the fault injector's device-latency sleeps both run inside executor
thunks for exactly this reason (server/persist.py ``work()``).

Flagged contexts:

- a blocking call whose nearest enclosing function is ``async def``;
- a blocking call inside a sync function (or lambda) that this module
  hands to the loop: an argument to ``call_soon`` / ``call_later`` /
  ``call_at`` / ``call_soon_threadsafe`` / ``add_done_callback``.

Not flagged: calls inside nested sync ``def`` bodies that are not
loop-registered (executor thunks — ``run_in_executor`` receives the
function object, so the blocking call's nearest enclosing function is
the thunk, not the coroutine).

Escape hatch: ``# zkanalyze: off-loop <reason>`` on the call line —
the reason prints in ``--list-suppressions``.
"""

from __future__ import annotations

import ast

from .core import (Context, Finding, FuncStackVisitor, Module,
                   import_aliases, resolve_call)

NAME = 'loop-blocking'

#: Dotted call targets that block the calling thread.
BLOCKING = {
    'os.fsync': 'fsync blocks until the device acks',
    'os.fdatasync': 'fdatasync blocks until the device acks',
    'time.sleep': 'sleep parks the whole loop, not one task',
    'subprocess.run': 'waits for child exit',
    'subprocess.call': 'waits for child exit',
    'subprocess.check_call': 'waits for child exit',
    'subprocess.check_output': 'waits for child exit',
    'socket.create_connection': 'synchronous TCP dial',
    'socket.getaddrinfo': 'synchronous resolver round trip',
}

#: Loop-callback registration points: a sync function passed here
#: runs ON the loop.
REGISTRARS = ('call_soon', 'call_later', 'call_at',
              'call_soon_threadsafe', 'add_done_callback')


def _callback_targets(tree: ast.AST) -> tuple[set[str], set[int]]:
    """Names (and lambda node ids) this module registers as loop
    callbacks."""
    names: set[str] = set()
    lambdas: set[int] = set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in REGISTRARS):
            continue
        for arg in node.args:
            if isinstance(arg, ast.Name):
                names.add(arg.id)
            elif isinstance(arg, ast.Attribute):
                names.add(arg.attr)
            elif isinstance(arg, ast.Lambda):
                lambdas.add(id(arg))
    return names, lambdas


class _Visitor(FuncStackVisitor):
    def __init__(self, module: Module, aliases: dict[str, str],
                 cb_names: set[str], cb_lambdas: set[int]):
        super().__init__()
        self.module = module
        self.aliases = aliases
        self.cb_names = cb_names
        self.cb_lambdas = cb_lambdas
        self.findings: list[Finding] = []

    def visit_Call(self, node: ast.Call) -> None:
        target = resolve_call(node, self.aliases)
        why = BLOCKING.get(target or '')
        if why is not None and self.stack:
            fn = self.stack[-1]
            ctx = None
            if isinstance(fn, ast.AsyncFunctionDef):
                ctx = 'async def %s' % (fn.name,)
            elif (isinstance(fn, ast.FunctionDef)
                    and fn.name in self.cb_names):
                ctx = 'loop callback %s' % (fn.name,)
            elif (isinstance(fn, ast.Lambda)
                    and id(fn) in self.cb_lambdas):
                ctx = 'loop-registered lambda'
            if ctx is not None:
                self.findings.append(Finding(
                    self.module.path, node.lineno, NAME,
                    'blocking call %s() on the event loop (%s; %s) '
                    '— run_in_executor it, or annotate '
                    '"# zkanalyze: off-loop <reason>"'
                    % (target, ctx, why)))
        self.generic_visit(node)


def check(module: Module, ctx: Context) -> list[Finding]:
    aliases = import_aliases(module.tree)
    cb_names, cb_lambdas = _callback_targets(module.tree)
    v = _Visitor(module, aliases, cb_names, cb_lambdas)
    v.visit(module.tree)
    return v.findings
