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
mntr row).  A settled span is held there as a row of atomic values,
which the interpreter's collector stops walking after its first young
pass: a process of 1,024 clients holds up to 262,144 settled spans.
The chaos campaign (io/faults.py, the ``chaos`` CLI) dumps the rings
alongside the failing seed, so a schedule failure arrives with the
exact cross-member path of the lost or duplicated write instead of a
log-grepping session.

``TRACE_SCHEMA`` versions every JSON emission of spans
(``chaos --trace-out``, the ``trce`` admin word, ``timeline --json``);
:meth:`Span.to_dict` emits its keys in one fixed order so dumps are
byte-stable for a given span.

**Op stages.**  A client op's span carries five ``time.perf_counter``
stamps, so one op's latency splits where the time went: ``_t0``, the
call (``Client._start_op``); ``t_sent``, the send-plane flush that
handed its frame to the transport (io/sendplane.py); ``t_rx``, when
the connection's inbound buffer that held the reply last went from
empty to non-empty (io/connection.py, or the ``FleetIngest`` slot in
io/ingest.py); ``t_routed``, its reply routed back by xid
(:meth:`Span.finish` given ``t_rx``); ``t_resumed``, the awaiting
coroutine resumed (``Client._await_op``).  :meth:`Span.stage_ms` turns them into the
four stages ``send``, ``remote``, ``ingest`` and ``resume``, which
add up to the op's latency; the client observes them into
``zookeeper_op_stage_ms{stage=...}``.  The stamps are plain floats on
the span: no object the collector tracks is added an op.

**Profiler ranges.**  :func:`set_profiler_ranges` turns on the port's
own ``torch.profiler`` ranges (``zk.read``, ``zk.flush``, ``zk.route``,
``zk.call``, ``zk.reply``), so a device trace labels the host time
between kernels by the port code that ran.  Off by default: each
instrumented point then costs one global read and no torch call.  On,
a range is torch's fast record function (``_RecordFunctionFast``,
~1.5 us a range under a running profiler against ~27 us for
``record_function``'s dispatcher op, which the profiler records as an
op of its own); it shows in the trace as a host event of that name on
the kernels' clock, not as a user annotation.
"""

from __future__ import annotations

import json
import time
import weakref

#: Version stamp for every JSON emission of span dumps.  Bump when
#: span fields or their meaning change; consumers key on it.
#: Schema 2: member rings (``member``/``batch``/``nbytes``/``detail``
#: fields, server-side ops), stable-ordered ``Span.to_dict``.
#: Schema 3: a client op's stage durations (``send_ms``,
#: ``remote_ms``, ``ingest_ms``, ``resume_ms``), each where reached.
TRACE_SCHEMA = 3

#: The stages of one client op, in order (:meth:`Span.stage_ms`).
OP_STAGES = ('send', 'remote', 'ingest', 'resume')

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


#: A settled span's fields, in the order of its row in a
#: :class:`TraceRing`.
_ROW = ('span_id', 'kind', 'op', 'path', 'xid', 'zxid', 'backend',
        'session_id', 'status', 'error', 't_wall', '_t0', 'duration_ms',
        'member', 'batch', 'nbytes', 'detail', 't_sent', 't_rx',
        't_routed', 't_resumed')


class Span:
    """One traced operation: request-side fields stamped at creation,
    reply-side fields stamped on completion."""

    __slots__ = _ROW + ('_ring',)

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
        #: The call stamp (``time.perf_counter``), and the op's later
        #: stage stamps, None until reached (module docstring).
        self._t0 = time.perf_counter()
        self.t_sent: float | None = None
        self.t_rx: float | None = None
        self.t_routed: float | None = None
        self.t_resumed: float | None = None
        self.duration_ms: float | None = None
        #: The ring that started this span (:meth:`TraceRing.start`):
        #: told when it settles, and of a stamp written after that
        #: (:meth:`restamp`).  None for a span rebuilt from a row.
        self._ring = None

    def finish(self, zxid: int | None = None, status: str = 'ok',
               error: str | None = None,
               t_rx: float | None = None) -> None:
        """Close the span exactly once; a double-settle (teardown races
        in the connection) keeps the first outcome.  ``t_rx``, given
        where a reply routes back by xid, is the reply's read time: it
        stamps ``t_rx`` and ``t_routed`` (now) of a span still open."""
        if self.status != 'open':
            return
        now = time.perf_counter()
        if t_rx is not None:
            self.t_rx = t_rx
            self.t_routed = now
        self.duration_ms = (now - self._t0) * 1000.0
        if zxid is not None:
            self.zxid = zxid
        self.status = status
        self.error = error
        ring = self._ring
        if ring is not None:
            ring._settled(self)

    def restamp(self) -> None:
        """Carry fields written after the settle (``Client._await_op``'s
        ``t_resumed``, the send plane's ``t_sent`` of a frame flushed
        after its op's deadline) into the ring's row of this span;
        nothing while the span is open."""
        ring = self._ring
        if ring is not None and self.status != 'open':
            ring._store(self)

    def _row(self) -> tuple:
        """The span's fields in ``_ROW`` order."""
        return (self.span_id, self.kind, self.op, self.path, self.xid,
                self.zxid, self.backend, self.session_id, self.status,
                self.error, self.t_wall, self._t0, self.duration_ms,
                self.member, self.batch, self.nbytes, self.detail,
                self.t_sent, self.t_rx, self.t_routed, self.t_resumed)

    @classmethod
    def _of(cls, row: tuple) -> 'Span':
        """The span a row holds, field for field."""
        span = cls.__new__(cls)
        for name, val in zip(_ROW, row):
            setattr(span, name, val)
        span._ring = None
        return span

    def stage_ms(self) -> tuple:
        """The op's ``(send, remote, ingest, resume)`` durations in ms,
        each None where the op never reached the stamp that ends it
        (an op that failed, hit its deadline or was abandoned skips
        the rest).  ``remote`` starts at ``t_sent`` and ``ingest`` at
        the later of ``t_rx`` and ``t_sent`` (a reply read into a
        buffer that already held older bytes takes the buffer's
        time), so the four are >= 0 and, for an op that resumed on
        its routed reply, add up to ``t_resumed - _t0``."""
        sent, routed, resumed = self.t_sent, self.t_routed, self.t_resumed
        send = remote = ingest = resume = None
        if sent is not None:
            send = (sent - self._t0) * 1000.0
            if routed is not None:
                rx = self.t_rx
                if rx < sent:
                    rx = sent
                remote = (rx - sent) * 1000.0
                ingest = (routed - rx) * 1000.0
        if routed is not None and resumed is not None:
            resume = (resumed - routed) * 1000.0
        return send, remote, ingest, resume

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
        if self.t_sent is not None or self.t_routed is not None:
            for stage, ms in zip(OP_STAGES, self.stage_ms()):
                if ms is not None:
                    d[stage + '_ms'] = round(ms, 3)
        return d

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return '<Span %s>' % (self.to_dict(),)


class TraceRing:
    """A bounded ring of recent spans: appends evict the oldest entry
    once ``capacity`` is reached — memory is fixed regardless of op
    volume — and :attr:`dropped` counts the evictions so a scrape can
    tell a quiet ring from one that wrapped.  ``member`` stamps every
    span recorded here with the owning ensemble member's id (None for
    the client ring).

    An open span is held as its :class:`Span`, which the op path
    stamps; a settled one as its row, a tuple of its fields (``_ROW``)
    that holds only ints, strs, floats and None, so the collector
    untracks it at its first young pass and no later pass walks it.
    :meth:`spans` rebuilds the ``Span`` of each row, field for field."""

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
        #: Span ``n`` lives in slot ``(n - 1) % capacity``: a Span
        #: while open, a row once settled, None where nothing is.
        self._slots: list = [None] * capacity
        #: spans recorded since construction (the newest span id)
        self._n = 0
        #: ``_n`` at the last :meth:`clear`
        self._cleared = 0
        #: slots holding a Span rather than a row
        self._objects = 0

    def __len__(self) -> int:
        return min(self._n - self._cleared, self.capacity)

    def held(self) -> tuple:
        """``(rows, objects)``: the spans held as settled rows and as
        ``Span`` objects (the open ones)."""
        return len(self) - self._objects, self._objects

    def _put(self, n: int, entry) -> None:
        """Hold span ``n``'s ``entry``, evicting the oldest if full."""
        i = (n - 1) % self.capacity
        old = self._slots[i]
        if old is not None:
            self.dropped += 1
            if type(old) is not tuple:
                self._objects -= 1
        self._slots[i] = entry

    def _settled(self, span: Span) -> None:
        """Span.finish() callback: hand a span at or over the threshold
        to :attr:`on_slow`, then keep its row."""
        if (self.slow_ms is not None and self.on_slow is not None
                and span.duration_ms is not None
                and span.duration_ms >= self.slow_ms):
            self.on_slow(span)
        self._store(span)

    def _store(self, span: Span) -> None:
        """Hold the settled ``span`` as its row, in its slot, unless the
        ring let it go since (evicted or cleared)."""
        i = (span.span_id - 1) % self.capacity
        cur = self._slots[i]
        if cur is span:
            self._objects -= 1
        elif type(cur) is not tuple or cur[0] != span.span_id:
            return
        self._slots[i] = span._row()

    def start(self, op: str, path: str | None = None,
              kind: str = 'op') -> Span:
        n = self._n = self._n + 1
        span = Span(n, op, path, kind=kind)
        if self.member is not None:
            span.member = self.member
        span._ring = self
        self._put(n, span)
        self._objects += 1
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
        n = self._n = self._n + 1
        span = Span.__new__(Span)
        span.span_id = n
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
        span.t_sent = span.t_rx = span.t_routed = span.t_resumed = None
        span.duration_ms = 0.0
        span._ring = None           # born settled: the ring holds a row
        for name, val in fields.items():
            setattr(span, name, val)
        self._put(n, span._row())
        if (self.slow_ms is not None and self.on_slow is not None
                and span.duration_ms >= self.slow_ms):
            self.on_slow(span)
        return span

    def _entries(self) -> list:
        """The held entries, oldest first."""
        i = self._n % self.capacity
        slots = self._slots
        return [e for e in slots[i:] + slots[:i] if e is not None]

    def spans(self) -> list[Span]:
        return [e if type(e) is not tuple else Span._of(e)
                for e in self._entries()]

    def open_spans(self) -> list[Span]:
        """Spans still unsettled — after teardown there must be none
        (the chaos campaigns assert it; an op evicted from the pending
        table without a settle is a span-leak bug)."""
        return [e for e in self._entries()
                if type(e) is not tuple and e.status == 'open']

    def dump(self) -> list[dict]:
        """The ring's contents, oldest first, as JSON-ready dicts."""
        return [s.to_dict() for s in self.spans()]

    def dump_json(self, indent: int | None = None) -> str:
        return json.dumps(self.dump(), indent=indent)

    def clear(self) -> None:
        self._slots = [None] * self.capacity
        self._cleared = self._n
        self._objects = 0


#: The client rings' census (:func:`bind_ring_metrics`).
METRIC_RING_SPANS = 'zkstream_trace_ring_spans'


def _ring_census(registry) -> dict:
    rows = objects = 0
    for ring in list(registry):
        r, o = ring.held()
        rows += r
        objects += o
    return {(('form', 'row'),): float(rows),
            (('form', 'open'),): float(objects)}


def bind_ring_metrics(ring: TraceRing, collector) -> None:
    """Count ``ring`` in ``collector``'s pull gauge
    ``zkstream_trace_ring_spans{form}``: the spans its bound rings
    hold as settled rows (``row``) and as open ``Span`` objects
    (``open``), summed at scrape time (the process's, where one
    collector serves every client).  The registry holds weak
    references; binding is idempotent per collector."""
    registry = getattr(collector, '_ring_registry', None)
    if registry is None:
        registry = collector._ring_registry = weakref.WeakSet()
        collector.multi_gauge(
            METRIC_RING_SPANS,
            lambda reg=registry: _ring_census(reg),
            'Spans the client trace rings hold, by form (row: settled, '
            'open: a Span object)')
    registry.add(ring)


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


# ---------------------------------------------------------------------
# The port's own profiler ranges (module docstring, "Profiler ranges").
# ---------------------------------------------------------------------

#: True while a ``torch.profiler`` session has asked for the port's
#: ranges (:func:`set_profiler_ranges`); every instrumented point reads
#: it, and makes no torch call while it is False.
profiler_ranges = False
#: torch's fast record function, bound when the ranges are turned on.
_fast = None
#: The op's open synchronous range, ``(name, handle)``: ``zk.call``
#: over an op method's head up to the await on its reply, ``zk.reply``
#: over its tail after it.  One slot serves every op: heads and tails
#: are synchronous, so no two of them interleave on the loop's thread.
_op_open = None


def set_profiler_ranges(on: bool) -> None:
    """Turn the port's profiler ranges on (a profiler session asking
    for them) or off (its end, which also closes an op range left
    open)."""
    global profiler_ranges, _fast
    if on:
        import torch

        _fast = torch._C._profiler._RecordFunctionFast
        profiler_ranges = True
    else:
        op_switch(None)
        profiler_ranges = False


def range_enter(name: str):
    """Open the range ``name``; returns the handle :func:`range_exit`
    closes."""
    handle = _fast(name)
    handle.__enter__()
    return handle


def range_exit(handle) -> None:
    handle.__exit__(None, None, None)


def op_open() -> bool:
    """Open ``zk.call`` over an op's synchronous head, unless a head is
    already open (an op method called inside another's head); True
    when this call opened it, so the caller closes it with
    ``op_switch(None)`` when the op returns.  A tail left open (an op
    that resumed while the ranges were off) is closed first."""
    cur = _op_open
    if cur is not None and cur[0] == 'zk.call':
        return False
    op_switch('zk.call')
    return True


def op_switch(name: str | None) -> None:
    """Close the op's open range and open ``name`` in its place (None:
    leave none open)."""
    global _op_open
    cur = _op_open
    _op_open = None
    if cur is not None:
        range_exit(cur[1])
    if name is not None:
        _op_open = (name, range_enter(name))
