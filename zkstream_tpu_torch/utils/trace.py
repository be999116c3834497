"""Lightweight causal tracing: client op spans + member span chains.

The metrics layer answers "how much / how slow in aggregate"; this
module answers "what happened to THAT request".  A :class:`Span` is
created per client op (client.py), threaded by xid through the
connection's pending-request table (io/connection.py) and stamped with
the reply's zxid when the reply routes back; the session layer records
notification deliveries into the same ring (io/session.py), so one
dump interleaves requests, replies, errors, and watch notifications in
arrival order.

Since the server grew its own trace plane, every ensemble member also
carries a ring (server/server.py ``ZKServer.trace``): a write txn
leaves a **zxid-keyed span chain** across the ensemble — the batch
decode (``SRV_DECODE``), the store apply (``COMMIT``), the WAL append
(``WAL_APPEND``), the group fsync its ack rode (``GROUP_FSYNC``, one
span shared by every txn in the barrier, stamped with the batch size),
the replication push per follower (``REPL_PUSH``), each follower's
apply (``APPLY``), and the watch fan-out delivery (``FANOUT``, watch
count + flushed bytes).  :func:`merge_timelines` joins the client ring
and any number of member rings **by zxid** into one causal timeline;
:func:`format_timeline` renders it.  The ``timeline`` CLI demos the
merge end to end, and both chaos tiers dump the member rings next to
the client ring on failure (cli.py and io/faults.py).

Spans live in a bounded in-memory ring buffer (:class:`TraceRing`) —
fixed memory, no I/O, safe to leave on in production; overwrites are
counted in :attr:`TraceRing.dropped` (the ``zk_trace_ring_dropped``
mntr row).  The chaos campaign (io/faults.py, the ``chaos`` CLI)
dumps the rings alongside the failing seed, so a schedule failure
arrives with the exact cross-member path of the lost or duplicated
write instead of a log-grepping session.

``TRACE_SCHEMA`` versions every JSON emission of spans
(``chaos --trace-out``, the ``trce`` admin word, ``timeline --json``);
:meth:`Span.to_dict` emits its keys in one fixed order so dumps are
byte-stable for a given span.
"""

from __future__ import annotations

import collections
import itertools
import json
import time

#: Version stamp for every JSON emission of span dumps.  Bump when
#: span fields or their meaning change; consumers key on it.
#: Schema 2: member rings (``member``/``batch``/``nbytes``/``detail``
#: fields, server-side ops), stable-ordered ``Span.to_dict``.
TRACE_SCHEMA = 2

#: ``to_dict`` emission order (after the four always-present keys):
#: fixed so a span serializes byte-identically regardless of which
#: setattr path populated it.
_OPTIONAL_FIELDS = ('path', 'xid', 'zxid', 'backend', 'session_id',
                    'member', 'batch', 'nbytes', 'detail', 'error')


def server_trace_default() -> bool:
    """Process-wide default for the server-side trace plane (member
    rings + tick ledger).  ``ZKSTREAM_NO_SERVER_TRACE=1`` disables it
    — the untraced arm of the bench overhead A/B (`bench.py
    --traceov`), mirroring the cork/WAL/watchtable kill switches."""
    import os
    return os.environ.get('ZKSTREAM_NO_SERVER_TRACE') != '1'


class Span:
    """One traced operation: request-side fields stamped at creation,
    reply-side fields stamped on completion."""

    __slots__ = ('span_id', 'kind', 'op', 'path', 'xid', 'zxid',
                 'backend', 'session_id', 'status', 'error',
                 't_wall', '_t0', 'duration_ms',
                 'member', 'batch', 'nbytes', 'detail', '_on_slow')

    def __init__(self, span_id: int, op: str, path: str | None = None,
                 kind: str = 'op'):
        self.span_id = span_id
        self.kind = kind  # 'op'|'notification'|'event'|'server'|...
        self.op = op
        self.path = path
        self.xid: int | None = None
        self.zxid: int | None = None
        self.backend: str | None = None
        self.session_id: str | None = None
        #: Which ensemble member recorded this span (None = client).
        self.member: str | None = None
        #: Batch size, where the span covers several frames/txns
        #: (decode batch, group-fsync barrier, fan-out watch count).
        self.batch: int | None = None
        #: Bytes the span moved (WAL record, flushed fan-out bytes).
        self.nbytes: int | None = None
        #: Free-form qualifier (log-entry op, follower token).
        self.detail: str | None = None
        self.status: str = 'open'
        self.error: str | None = None
        self.t_wall = time.time()
        self._t0 = time.monotonic()
        self.duration_ms: float | None = None
        #: Armed by a ring with a slow-op threshold: called once with
        #: the span when finish() measures a duration at/over it.
        self._on_slow = None

    def finish(self, zxid: int | None = None, status: str = 'ok',
               error: str | None = None) -> None:
        """Close the span exactly once; a double-settle (teardown races
        in the connection) keeps the first outcome."""
        if self.status != 'open':
            return
        self.duration_ms = (time.monotonic() - self._t0) * 1000.0
        if zxid is not None:
            self.zxid = zxid
        self.status = status
        self.error = error
        hook = self._on_slow
        if hook is not None:
            self._on_slow = None
            hook(self)

    def to_dict(self) -> dict:
        """JSON-ready dict, keys in one fixed order (insertion order
        survives ``json.dumps``), so a span's serialization is stable
        across processes and runs."""
        d = {'span': self.span_id, 'kind': self.kind, 'op': self.op,
             'status': self.status, 't_wall': round(self.t_wall, 6)}
        for field in _OPTIONAL_FIELDS:
            val = getattr(self, field)
            if val is not None:
                d[field] = val
        if self.duration_ms is not None:
            d['duration_ms'] = round(self.duration_ms, 3)
        return d

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return '<Span %s>' % (self.to_dict(),)


class TraceRing:
    """A bounded ring of recent spans: appends evict the oldest entry
    once ``capacity`` is reached — memory is fixed regardless of op
    volume — and :attr:`dropped` counts the evictions so a scrape can
    tell a quiet ring from one that wrapped.  ``member`` stamps every
    span recorded here with the owning ensemble member's id (None for
    the client ring)."""

    def __init__(self, capacity: int = 256,
                 member: str | None = None):
        assert capacity > 0, capacity
        self.capacity = capacity
        self.member = member
        #: ring overwrites since construction (the mntr
        #: ``zk_trace_ring_dropped`` row)
        self.dropped = 0
        #: Slow-op digest threshold in ms, or None (off).  When set,
        #: every span settled on this ring whose duration meets it is
        #: handed to :attr:`on_slow` — the black-box plane's hook
        #: (utils/blackbox.py persists the span's causal chain).
        self.slow_ms: float | None = None
        self.on_slow = None
        self._ring: collections.deque[Span] = collections.deque(
            maxlen=capacity)
        self._ids = itertools.count(1)

    def __len__(self) -> int:
        return len(self._ring)

    def _slow_settled(self, span: Span) -> None:
        """Span.finish() callback: apply the threshold (the hook fires
        on every settle; sub-threshold spans stop here)."""
        if (self.slow_ms is not None and self.on_slow is not None
                and span.duration_ms is not None
                and span.duration_ms >= self.slow_ms):
            self.on_slow(span)

    def start(self, op: str, path: str | None = None,
              kind: str = 'op') -> Span:
        span = Span(next(self._ids), op, path, kind=kind)
        if self.member is not None:
            span.member = self.member
        if self.slow_ms is not None:
            span._on_slow = self._slow_settled
        if len(self._ring) >= self.capacity:
            self.dropped += 1       # the append below evicts one
        self._ring.append(span)
        return span

    def note(self, op: str, path: str | None = None,
             zxid: int | None = None, kind: str = 'event',
             **fields) -> Span:
        """Record an instantaneous event (notification delivery, state
        edge, a member-side txn stage) as an already-settled span.
        ``fields`` land last, so an explicit ``duration_ms=`` (a
        pre-measured stage, e.g. WAL_RECOVER or GROUP_FSYNC)
        overrides the 0 the instant close stamps.

        Built inline rather than via start()+finish(): this is the
        server hot path (a COMMIT + WAL_APPEND note per write txn),
        and skipping the open-span bookkeeping roughly halves the
        cost."""
        span = Span.__new__(Span)
        span.span_id = next(self._ids)
        span.kind = kind
        span.op = op
        span.path = path
        span.xid = None
        span.zxid = zxid
        span.backend = None
        span.session_id = None
        span.member = self.member
        span.batch = None
        span.nbytes = None
        span.detail = None
        span.status = 'ok'
        span.error = None
        span.t_wall = time.time()
        span._t0 = 0.0
        span.duration_ms = 0.0
        span._on_slow = None        # already settled; checked below
        for name, val in fields.items():
            setattr(span, name, val)
        if len(self._ring) >= self.capacity:
            self.dropped += 1       # the append below evicts one
        self._ring.append(span)
        if (self.slow_ms is not None
                and span.duration_ms >= self.slow_ms):
            self._slow_settled(span)
        return span

    def spans(self) -> list[Span]:
        return list(self._ring)

    def open_spans(self) -> list[Span]:
        """Spans still unsettled — after teardown there must be none
        (the chaos campaigns assert it; an op evicted from the pending
        table without a settle is a span-leak bug)."""
        return [s for s in self._ring if s.status == 'open']

    def dump(self) -> list[dict]:
        """The ring's contents, oldest first, as JSON-ready dicts."""
        return [s.to_dict() for s in self._ring]

    def dump_json(self, indent: int | None = None) -> str:
        return json.dumps(self.dump(), indent=indent)

    def clear(self) -> None:
        self._ring.clear()


def format_spans(spans: list[dict], limit: int | None = None) -> str:
    """Render dumped spans as aligned text lines for failure reports
    (newest-last; ``limit`` keeps assertion messages bounded)."""
    if limit is not None and len(spans) > limit:
        spans = spans[-limit:]
    lines = []
    for s in spans:
        dur = ('%8.2fms' % s['duration_ms']
               if s.get('duration_ms') is not None else '      open')
        lines.append(
            '  #%-4d %-12s xid=%-6s zxid=%-6s %-7s %s %s%s'
            % (s['span'], s['op'], s.get('xid', '-'),
               s.get('zxid', '-'), s['status'], dur,
               s.get('path') or '',
               (' [%s]' % s['error']) if s.get('error') else ''))
    return '\n'.join(lines)


# ---------------------------------------------------------------------
# Cross-ring merge: the zxid-keyed causal timeline.
# ---------------------------------------------------------------------

#: Causal stage rank within one zxid: in-process hops settle within
#: the same millisecond, so wall time alone cannot order the chain —
#: the pipeline's actual order does.  Client op spans (submit) lead,
#: the client-side notification delivery trails.
_STAGE_RANK = {
    'COMMIT': 2,
    'WAL_APPEND': 3,
    'GROUP_FSYNC': 4,
    'REPL_PUSH': 5,
    'APPLY': 6,
    'FANOUT': 7,
    'NOTIFICATION': 8,
}
_STAGE_DEFAULT = 9


def _stage(span: dict) -> int:
    rank = _STAGE_RANK.get(span.get('op', ''))
    if rank is not None:
        return rank
    if span.get('kind') == 'op':
        return 1                    # client submit leads its zxid
    return _STAGE_DEFAULT


def merge_timelines(rings: dict[str, list[dict]]) -> list[dict]:
    """Merge span dumps from several rings into one causal timeline.

    ``rings`` maps a source name ('client', 'member:1', ...) to that
    ring's :meth:`TraceRing.dump`.  Every span carrying a zxid joins
    the timeline, stamped with its source (a span's own ``member``
    field wins over the ring name), ordered by
    ``(zxid, causal stage, wall time)`` — so a lagging follower's
    apply span, recorded long after later transactions, still merges
    back into its own zxid's group in causal position."""
    out: list[dict] = []
    for source, spans in rings.items():
        # a member-qualified ring name wins over the span's own member
        # field: a caller merging two same-id members keys them apart
        # ('member:0@hostB:2181', timeline --live) and that distinction
        # must survive into the rendered source
        qualified = source.startswith('member:')
        for s in spans:
            if s.get('zxid') is None:
                continue
            e = dict(s)
            member = s.get('member')
            e['source'] = ('member:%s' % (member,)
                           if member is not None and not qualified
                           else source)
            out.append(e)
    out.sort(key=lambda e: (e['zxid'], _stage(e),
                            e.get('t_wall', 0.0)))
    return out


def format_timeline(entries: list[dict],
                    limit: int | None = None) -> str:
    """Render a merged timeline as aligned text, one causal step per
    line, zxid-grouped (oldest first)."""
    if limit is not None and len(entries) > limit:
        entries = entries[-limit:]
    lines = []
    last_zxid = None
    for e in entries:
        zxid = e['zxid']
        zcol = ('zxid %-6d' % zxid) if zxid != last_zxid \
            else '     %-6s' % ''
        last_zxid = zxid
        extra = []
        if e.get('batch') is not None:
            extra.append('batch=%d' % e['batch'])
        if e.get('nbytes') is not None:
            extra.append('%dB' % e['nbytes'])
        if e.get('detail'):
            extra.append(str(e['detail']))
        if e.get('xid') is not None:
            extra.append('xid=%d' % e['xid'])
        if e.get('duration_ms'):
            extra.append('%.2fms' % e['duration_ms'])
        if e.get('error'):
            extra.append('[%s]' % e['error'])
        lines.append(('%s %-10s %-12s %-7s %s %s'
                      % (zcol, e.get('source', '?'), e['op'],
                         e.get('status', ''), e.get('path') or '-',
                         ' '.join(extra))).rstrip())
    return '\n'.join(lines)
