"""Checker: fault injection happens BEFORE the cork boundary.

The rule the send, fault and ingest planes each re-derived by hand: the
seeded fault injector's tx hooks (``faults.tx`` / ``faults.server_tx``)
are a *per-frame* boundary — they may truncate a frame, schedule a
reset, or take over delivery entirely — so they must see every frame
before it enters a :class:`SendPlane` cork (``.send`` /
``.send_flush``). A frame corked first and faulted later can reorder
ahead of the injected delivery, and the schedule stops reproducing by
seed (io/sendplane.py "Ordering contract"; server/server.py
``_write_bytes``; server/watchtable.py ``_enqueue``).

Mechanically: in any function body that calls BOTH a fault hook and a
send-plane cork entry point, every cork call must come after the
first fault-hook call in source order.  Receivers are matched by
name (``faults`` / ``fi`` / ``injector`` vs ``_tx`` / ``plane`` /
``cork``) — this is a project lint over the project's own naming
conventions, with ``# zkanalyze: ignore[fault-order] <reason>`` for
the cases it misreads.
"""

from __future__ import annotations

import ast
import re

from .core import Context, Finding, Module, walk_no_funcs

NAME = 'fault-order'

#: FaultInjector per-frame / per-event hook methods (io/faults.py).
#: ``server_rx`` is the ingress drain's per-chunk boundary: it must
#: run before any decode AND before any cork a handler might take
#: (the receive-side mirror of the tx rule).
FAULT_ATTRS = ('tx', 'rx', 'server_tx', 'server_rx', 'accept_refuse',
               'drop_push', 'fsync_fault', 'ingest_reset',
               'ingest_cut', 'before_connect',
               'crash_window_before_fsync')
_FAULT_RECV_RE = re.compile(r'(?i)(fault|injector|(^|\.)fi$)')

#: SendPlane cork entry points (io/sendplane.py).
CORK_ATTRS = ('send', 'send_flush')
_CORK_RECV_RE = re.compile(r'(?i)(_tx$|(^|[._])tx$|plane|cork)')


def _calls_in(fn: ast.AST):
    for node in walk_no_funcs(fn):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            yield node


def check(module: Module, ctx: Context) -> list[Finding]:
    findings: list[Finding] = []
    funcs = [n for n in ast.walk(module.tree)
             if isinstance(n, (ast.FunctionDef,
                               ast.AsyncFunctionDef))]
    for fn in funcs:
        faults: list[tuple[int, int, str]] = []
        corks: list[tuple[int, int, str]] = []
        for call in _calls_in(fn):
            recv = module.src(call.func.value)
            attr = call.func.attr
            if (attr in FAULT_ATTRS
                    and _FAULT_RECV_RE.search(recv)):
                faults.append((call.lineno, call.col_offset,
                               '%s.%s' % (recv, attr)))
            elif (attr in CORK_ATTRS
                    and _CORK_RECV_RE.search(recv)):
                corks.append((call.lineno, call.col_offset,
                              '%s.%s' % (recv, attr)))
        if not faults or not corks:
            continue
        first_fault = min(faults)
        for line, col, name in sorted(corks):
            if (line, col) < (first_fault[0], first_fault[1]):
                findings.append(Finding(
                    module.path, line, NAME,
                    'cork boundary %s() precedes the fault hook '
                    '%s() at line %d — injection must screen every '
                    'frame before it corks, or the injected '
                    'delivery reorders (io/sendplane.py ordering '
                    'contract)' % (name, first_fault[2],
                                   first_fault[0])))
    return findings
