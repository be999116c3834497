"""Checker: no ack byte before the fsync barrier AND the quorum gate.

The ack-order contract of the quorum-commit plane (io/sendplane.py ``barrier``;
server/replication.py ``CommitBarrier``): a server reply reaches the
transport only once BOTH halves of the leader's ack barrier have
cleared — the WAL's group fsync covering the txn, and (when the
member carries a quorum gate) the majority ack over it.  An ack path
that performs a raw transport write *before* taking a barrier it also
uses is exactly the bug quorum-commit exists to rule out: the client
sees an ack a leader death can still un-happen.

Mechanically: in any function body that calls BOTH a barrier-taking
method and a raw transport write, every raw write must come after the
first barrier call in source order.  Receivers are matched by the
project's naming conventions — barriers on ``barrier`` / ``wal`` /
``quorum`` / ``gate`` / ``_tx``-plane receivers (``gate_flush`` /
``sync_for_flush`` / ``flush_hard`` / quorum ``wait``), raw writes as
``.write(...)`` on ``writer`` / ``transport`` receivers — with
``# zkanalyze: ignore[ack-order] <reason>`` for the cases it
misreads.  Functions that only write (the plane's own sink callbacks,
admin words, election gossip) are out of scope: the contract binds
paths that themselves take a barrier.
"""

from __future__ import annotations

import ast
import re

from .core import Context, Finding, Module, walk_no_funcs

NAME = 'ack-order'

#: (attr, receiver-regex) pairs that count as taking the ack barrier.
BARRIER_CALLS = (
    ('gate_flush', re.compile(r'(?i)(barrier|wal|quorum|gate)')),
    ('sync_for_flush', re.compile(r'(?i)(barrier|wal|quorum|gate)')),
    ('flush_hard', re.compile(r'(?i)(_tx$|plane|cork)')),
    ('wait', re.compile(r'(?i)quorum')),
)

#: Raw transport writes: the bytes leave this process.
_WRITE_RE = re.compile(r'(?i)(writer|transport)$')


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
        barriers: list[tuple[int, int, str]] = []
        writes: list[tuple[int, int, str]] = []
        for call in _calls_in(fn):
            recv = module.src(call.func.value)
            attr = call.func.attr
            for battr, brx in BARRIER_CALLS:
                if attr == battr and brx.search(recv):
                    barriers.append((call.lineno, call.col_offset,
                                     '%s.%s' % (recv, attr)))
                    break
            else:
                if attr == 'write' and _WRITE_RE.search(recv):
                    writes.append((call.lineno, call.col_offset,
                                   '%s.%s' % (recv, attr)))
        if not barriers or not writes:
            continue
        first_barrier = min(barriers)
        for line, col, name in sorted(writes):
            if (line, col) < (first_barrier[0], first_barrier[1]):
                findings.append(Finding(
                    module.path, line, NAME,
                    'raw transport write %s() precedes the ack '
                    'barrier %s() at line %d — no ack byte may reach '
                    'the transport before the fsync barrier AND the '
                    'quorum gate have cleared (io/sendplane.py '
                    'barrier contract; server/replication.py '
                    'CommitBarrier)' % (name, first_barrier[2],
                                        first_barrier[0])))
    return findings
