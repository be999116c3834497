"""Prometheus-style metrics: counters, gauges, and histograms (the
port's own copy of ``zkstream_tpu.utils.metrics``).

The reference records client events through the artedi collector
(reference: lib/client.js:46-61, lib/zk-session.js:61-65).  This is a
dependency-free equivalent: labelled counters, pull-model gauges, and
cumulative-bucket histograms with text exposition in the Prometheus
format.  A caller may supply their own ``Collector`` to ``Client`` or
let one be created internally, as in the reference.

Label values are escaped per the Prometheus exposition spec
(backslash, double quote, and newline), so a path or error string can
ride in a label without producing unparseable scrape output.
"""

from __future__ import annotations

import time
from bisect import bisect_left

from .aio import ambient_loop


def escape_label_value(value) -> str:
    """Escape a label value per the Prometheus text exposition format:
    ``\\`` -> ``\\\\``, ``"`` -> ``\\"``, newline -> ``\\n``."""
    return (str(value)
            .replace('\\', '\\\\')
            .replace('"', '\\"')
            .replace('\n', '\\n'))


def _render_labels(key: tuple[tuple[str, str], ...],
                   extra: tuple[tuple[str, str], ...] = ()) -> str:
    pairs = tuple(key) + tuple(extra)
    if not pairs:
        return ''
    return '{%s}' % ','.join(
        '%s="%s"' % (k, escape_label_value(v)) for k, v in pairs)


def _label_key(labels) -> tuple[tuple[str, str], ...]:
    """Normalize a label set (dict, or an iterable of (k, v) pairs —
    MultiGauge callbacks need hashable keys) to a sorted tuple."""
    if not labels:
        return ()
    items = labels.items() if isinstance(labels, dict) else labels
    return tuple(sorted(items))


class Counter:
    def __init__(self, name: str, help_text: str = ''):
        self.name = name
        self.help = help_text
        self._values: dict[tuple[tuple[str, str], ...], float] = {}

    def increment(self, labels: dict[str, str] | None = None,
                  by: float = 1.0) -> None:
        key = _label_key(labels)
        self._values[key] = self._values.get(key, 0.0) + by

    def value(self, labels: dict[str, str] | None = None) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def label_keys(self) -> list[tuple[tuple[str, str], ...]]:
        """Every label set with a recorded value (scrape helpers walk
        this to enumerate series, like Histogram.label_keys)."""
        return list(self._values.keys())

    def expose(self) -> str:
        lines = []
        if self.help:
            lines.append('# HELP %s %s' % (self.name, self.help))
        lines.append('# TYPE %s counter' % (self.name,))
        for key, val in sorted(self._values.items()):
            lines.append('%s%s %s' % (self.name, _render_labels(key),
                                      val))
        return '\n'.join(lines)


class Gauge:
    """A pull-model gauge: the value is read from a callback at
    exposition time — zero hot-path cost for instrumented components
    (the fleet ingest binds its tick/frame counters this way)."""

    def __init__(self, name: str, fn, help_text: str = ''):
        self.name = name
        self.help = help_text
        self._fn = fn

    def expose(self) -> str:
        lines = []
        if self.help:
            lines.append('# HELP %s %s' % (self.name, self.help))
        lines.append('# TYPE %s gauge' % (self.name,))
        try:
            val = self._fn()
        except Exception:  # a dead callback must not sink exposition
            val = float('nan')
        lines.append('%s %s' % (self.name, val))
        return '\n'.join(lines)


class MultiGauge:
    """A pull-model gauge with one series per label set: the callback
    returns ``{labels_dict: value}`` at exposition time.  Used for the
    FSM current-state gauge, where the series population (which
    machines exist, which states they sit in) changes at runtime."""

    def __init__(self, name: str, fn, help_text: str = ''):
        self.name = name
        self.help = help_text
        self._fn = fn

    def expose(self) -> str:
        lines = []
        if self.help:
            lines.append('# HELP %s %s' % (self.name, self.help))
        lines.append('# TYPE %s gauge' % (self.name,))
        try:
            values = {_label_key(labels): val
                      for labels, val in self._fn().items()}
        except Exception:  # a dead callback must not sink exposition
            lines.append('%s %s' % (self.name, float('nan')))
            return '\n'.join(lines)
        for key, val in sorted(values.items()):
            lines.append('%s%s %s' % (self.name, _render_labels(key),
                                      val))
        return '\n'.join(lines)


#: Default latency buckets, milliseconds: sub-ms client-loop hops up
#: through multi-second retry storms.
DEFAULT_BUCKETS = (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
                   250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0)


class Histogram:
    """A labelled Prometheus histogram: cumulative ``_bucket`` series
    (``le`` upper bounds plus ``+Inf``), ``_sum``, and ``_count``.

    ``observe`` is the hot-path call: one bisect-free linear scan over
    a small tuple of bounds plus two adds — cheap enough for per-op
    recording."""

    def __init__(self, name: str, help_text: str = '',
                 buckets=DEFAULT_BUCKETS):
        self.name = name
        self.help = help_text
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError('histogram needs at least one bucket bound')
        self.buckets = bounds
        #: label key -> [per-bucket counts..., +Inf count, sum]
        self._series: dict[tuple[tuple[str, str], ...], list] = {}

    def _row(self, labels: dict[str, str] | None) -> list:
        key = _label_key(labels)
        row = self._series.get(key)
        if row is None:
            row = self._series[key] = [0] * (len(self.buckets) + 1) \
                + [0.0]
        return row

    def observe(self, value: float,
                labels: dict[str, str] | None = None) -> None:
        row = self._row(labels)
        for i, bound in enumerate(self.buckets):
            if value <= bound:
                row[i] += 1
                break
        else:
            row[len(self.buckets)] += 1     # +Inf-only
        row[-1] += value

    def series(self, labels: dict[str, str] | None = None
               ) -> 'HistogramSeries':
        """One label set's series, resolved once: its ``observe``
        builds no label dict or key tuple (per-op hot paths)."""
        return HistogramSeries(self._row(labels), self.buckets)

    def rows(self, label: str, values) -> 'HistogramRows':
        """The series of ``label`` = each of ``values``, resolved once,
        observed together (:meth:`HistogramRows.observe_each`)."""
        return HistogramRows(tuple(self._row({label: v}) for v in values),
                             self.buckets)

    def count(self, labels: dict[str, str] | None = None) -> int:
        row = self._series.get(_label_key(labels))
        return sum(row[:-1]) if row is not None else 0

    def sum(self, labels: dict[str, str] | None = None) -> float:
        row = self._series.get(_label_key(labels))
        return row[-1] if row is not None else 0.0

    def label_keys(self) -> list[tuple[tuple[str, str], ...]]:
        """Every label set this histogram holds series for (sorted
        key tuples, as ``_label_key`` produces)."""
        return list(self._series)

    def percentile(self, q: float,
                   labels: dict[str, str] | None = None) -> float:
        """Estimate the ``q``-th percentile (0..100) the way
        ``histogram_quantile`` does: find the bucket the rank falls
        in, interpolate linearly inside it.  The +Inf bucket clamps
        to the largest finite bound (no upper edge to interpolate
        toward); an empty series returns NaN."""
        row = self._series.get(_label_key(labels))
        if row is None:
            return float('nan')
        total = sum(row[:-1])
        if total == 0:
            return float('nan')
        rank = q / 100.0 * total
        cum = 0.0
        lo = 0.0
        for i, bound in enumerate(self.buckets):
            prev = cum
            cum += row[i]
            if cum >= rank:
                frac = (rank - prev) / row[i] if row[i] else 0.0
                return lo + (bound - lo) * frac
            lo = bound
        return self.buckets[-1]

    def bucket_value(self, le: float,
                     labels: dict[str, str] | None = None) -> int:
        """Cumulative count for the bucket with upper bound ``le``
        (``float('inf')`` for the +Inf bucket)."""
        row = self._series.get(_label_key(labels))
        if row is None:
            return 0
        if le == float('inf'):
            return sum(row[:-1])
        idx = self.buckets.index(float(le))
        return sum(row[:idx + 1])

    @staticmethod
    def _fmt_bound(bound: float) -> str:
        return '%g' % (bound,)

    def expose(self) -> str:
        lines = []
        if self.help:
            lines.append('# HELP %s %s' % (self.name, self.help))
        lines.append('# TYPE %s histogram' % (self.name,))
        for key, row in sorted(self._series.items()):
            cum = 0
            for i, bound in enumerate(self.buckets):
                cum += row[i]
                lines.append('%s_bucket%s %d' % (
                    self.name,
                    _render_labels(key, (('le', self._fmt_bound(bound)),)),
                    cum))
            cum += row[len(self.buckets)]
            lines.append('%s_bucket%s %d' % (
                self.name, _render_labels(key, (('le', '+Inf'),)), cum))
            lines.append('%s_sum%s %s' % (self.name,
                                          _render_labels(key), row[-1]))
            lines.append('%s_count%s %d' % (self.name,
                                            _render_labels(key), cum))
        return '\n'.join(lines)


class HistogramSeries:
    """One series of a :class:`Histogram` (:meth:`Histogram.series`):
    ``observe`` lands in the same row the labelled call would."""

    __slots__ = ('_row', '_bounds', '_sum')

    def __init__(self, row: list, bounds: tuple):
        self._row = row
        self._bounds = bounds
        #: the sum's slot, the row's last, as a non-negative index
        #: (which the interpreter's list-subscript fast path takes)
        self._sum = len(row) - 1

    def observe(self, value: float) -> None:
        row = self._row
        # the first bound >= value, or the +Inf slot past the bounds
        row[bisect_left(self._bounds, value)] += 1
        row[self._sum] += value


class HistogramRows:
    """Series of one :class:`Histogram` (:meth:`Histogram.rows`),
    observed together: one call for a value of each (a per-op hot
    path observing several series)."""

    __slots__ = ('_rows', '_bounds', '_sum')

    def __init__(self, rows: tuple, bounds: tuple):
        self._rows = rows
        self._bounds = bounds
        self._sum = len(bounds) + 1       # as HistogramSeries._sum

    def observe_each(self, values) -> None:
        """Value ``i`` into series ``i``; a None observes nothing."""
        rows, bounds, at_sum = self._rows, self._bounds, self._sum
        i = 0
        for value in values:
            if value is not None:
                row = rows[i]
                row[bisect_left(bounds, value)] += 1
                row[at_sum] += value
            i += 1


METRIC_TICK = 'zk_tick_ms'
METRIC_TICK_PHASE = 'zk_tick_phase_ms'

#: Tick/phase duration buckets, ms: a busy tick on this stack spans
#: tens of microseconds (one pipelined reply) up to tens of
#: milliseconds (a wide fan-out flush or a slow-device fsync).
TICK_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                10.0, 25.0, 50.0)


class TickLedger:
    """Per-busy-tick phase accounting for one server member.

    The busy loop tick is the unit every plane already coalesces on —
    one cork flush, one group fsync, one fan-out flush per tick — but
    nothing said where the tick's wall time went.  The ledger splits
    it: call sites bracket their work with :meth:`enter`/:meth:`exit`
    (nested sections subtract cleanly, so a cork flush inside a shard
    flush is counted once), and when the burst goes quiet the tick
    closes — per-phase durations land in ``zk_tick_phase_ms{phase=}``
    and the burst's wall span in ``zk_tick_ms``.

    Phases (server/server.py wires them):

    - ``rx_drain`` — the ingress plane's batched receive: kernel-to-
      user time for one shard's dirty set (io/ingress.py; ~0 on the
      single-loop validator, whose reads are awaited, not drained);
    - ``decode_apply`` — request decode + handler dispatch (store
      apply and WAL append included, minus nested phases);
    - ``fsync_gate`` — loop-blocking durability-barrier time (the
      inline fast-device fsync, ``sync='always'`` appends, the
      synchronous barrier on close paths);
    - ``cork_flush`` — send-plane buffer join + transport write;
    - ``fanout_flush`` — the watch table's per-shard flush loop
      (minus the nested cork writes it triggers).

    A "tick" here is the whole burst: asyncio runs ``call_soon``
    callbacks scheduled during a callback in the *next* loop
    iteration, so the cork/fan-out flushes of one logical tick land
    one iteration after the decode that corked them — the close
    callback re-arms while activity continues and finalizes on the
    first quiet iteration.  Phase sums are <= the tick wall span by
    construction; the gap is un-instrumented loop work.

    Works without a collector (mntr-only servers keep their own
    histograms); with one, the same histograms are registered for
    scraping (``scrape_tick_cells`` summarizes them per bench cell).
    """

    PHASES = ('rx_drain', 'decode_apply', 'fsync_gate', 'cork_flush',
              'fanout_flush')

    #: Close a still-active burst after this many loop iterations
    #: anyway: under saturating back-to-back load every iteration has
    #: new phase activity and a pure quiet-pass rule would never
    #: close — the ledger then reports bounded burst slices (shares
    #: stay exact; only the per-tick bucketing coarsens).
    MAX_DEFERS = 8

    __slots__ = ('ticks', 'phase_hist', 'tick_hist', 'last_tick',
                 '_acc', '_stack', '_first', '_last', '_scheduled',
                 '_gen', '_sched_gen', '_defers')

    def __init__(self, collector=None):
        self.ticks = 0
        self.last_tick: dict | None = None
        self._acc: dict[str, float] = {}
        self._stack: list = []      # [phase, t0, child_seconds]
        self._first = 0.0
        self._last = 0.0
        self._scheduled = False
        self._gen = 0
        self._sched_gen = -1
        self._defers = 0
        source = collector if collector is not None else Collector()
        self.phase_hist = source.histogram(
            METRIC_TICK_PHASE,
            'Busy-tick time by phase, ms (rx_drain | decode_apply | '
            'fsync_gate | cork_flush | fanout_flush)',
            buckets=TICK_BUCKETS)
        self.tick_hist = source.histogram(
            METRIC_TICK, 'Busy-tick wall span, ms',
            buckets=TICK_BUCKETS)

    def enter(self, phase: str) -> None:
        """Open one phase section (re-entrant across phases: a nested
        section's time is subtracted from its parent)."""
        now = time.perf_counter()
        if not self._stack and not self._acc:
            self._first = now
        self._gen += 1
        self._stack.append([phase, now, 0.0])
        if not self._scheduled:
            # -1 forces the close callback to re-arm at least once:
            # it is queued BEFORE the tick's own spill-over callbacks
            # (cork/fan-out flushes land behind it in the same
            # iteration), so closing on the first run would split one
            # logical tick in two
            self._sched_gen = -1
            try:
                ambient_loop().call_soon(self._tick_close)
            except RuntimeError:
                return          # no loop (unit test): close manually
            self._scheduled = True

    def exit(self) -> None:
        """Close the innermost open section."""
        now = time.perf_counter()
        phase, t0, child = self._stack.pop()
        dur = now - t0
        self._acc[phase] = self._acc.get(phase, 0.0) + dur - child
        if self._stack:
            self._stack[-1][2] += dur
        self._last = now

    def _tick_close(self) -> None:
        self._scheduled = False
        self._defers += 1
        if self._stack or (self._gen != self._sched_gen
                           and self._defers < self.MAX_DEFERS):
            # activity since the last look (the burst spilled into
            # this iteration — cork/fan-out callbacks of the same
            # logical tick): look again next iteration; close after
            # one fully quiet pass, or at MAX_DEFERS under
            # saturating load
            self._sched_gen = self._gen
            try:
                ambient_loop().call_soon(self._tick_close)
            except RuntimeError:
                return
            self._scheduled = True
            return
        self.close_tick()

    def close_tick(self) -> None:
        """Finalize the current tick: observe every accumulated phase
        and the tick wall span.  Loop-driven normally; callable
        directly where no loop runs (unit tests)."""
        if not self._acc or self._stack:
            return
        self._defers = 0
        total_ms = (self._last - self._first) * 1000.0
        phases = {p: round(s * 1000.0, 6)
                  for p, s in self._acc.items()}
        self._acc = {}
        self.ticks += 1
        for phase, ms in phases.items():
            self.phase_hist.observe(ms, {'phase': phase})
        self.tick_hist.observe(total_ms)
        self.last_tick = {'total_ms': round(total_ms, 6),
                          'phases': phases}

    def phase_p99(self, phase: str) -> float | None:
        """p99 of one phase's per-tick duration, ms (None when the
        phase never ran) — the mntr ``zk_tick_phase_ms_p99`` rows."""
        labels = {'phase': phase}
        if not self.phase_hist.count(labels):
            return None
        return self.phase_hist.percentile(99, labels)


def scrape_tick_cells(collector) -> dict:
    """Summarize the tick ledger for bench cells (bench.py write-heavy
    and fan-out families): tick count + wall-span p50/p99, and per
    phase the per-tick p50/p99 plus ``share`` — the fraction of
    ledgered tick time the phase ate, the number the accept-shard and
    io_uring roadmap items are gated on."""
    out: dict = {}
    try:
        th = collector.get_collector(METRIC_TICK)
        ph = collector.get_collector(METRIC_TICK_PHASE)
    except ValueError:
        return out
    n = th.count()
    if not n:
        return out
    out['ticks'] = n
    out['tick_ms_p50'] = round(th.percentile(50), 4)
    out['tick_ms_p99'] = round(th.percentile(99), 4)
    total = th.sum()
    phases: dict = {}
    for key in ph.label_keys():
        labels = dict(key)
        name = labels.get('phase', '')
        c = ph.count(labels)
        if not c:
            continue
        phases[name] = {
            'count': c,
            'ms_p50': round(ph.percentile(50, labels), 4),
            'ms_p99': round(ph.percentile(99, labels), 4),
            'share': round(ph.sum(labels) / total, 3) if total else 0.0,
        }
    if phases:
        out['phases'] = phases
    return out


def sign_test_p(wins: int, losses: int) -> float:
    """Two-sided exact sign test (ties dropped): the probability of a
    split at least this lopsided under H0 = deltas symmetric around 0.
    Shared by every paired A/B study (tools/sweep_crossover.py's cork
    pairs, bench.py --wal's durability arms) so the published p-value
    tables can never drift apart."""
    import math

    n = wins + losses
    if n == 0:
        return 1.0
    k = min(wins, losses)
    p = 2.0 * sum(math.comb(n, i) for i in range(k + 1)) / (2.0 ** n)
    return min(1.0, p)


class Collector:
    def __init__(self) -> None:
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge | MultiGauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def _check_collision(self, name: str, kind: str) -> None:
        for other_kind, table in (('counter', self._counters),
                                  ('gauge', self._gauges),
                                  ('histogram', self._histograms)):
            if kind != other_kind and name in table:
                raise ValueError(
                    'metric %r already registered as a %s'
                    % (name, other_kind))

    def counter(self, name: str, help_text: str = '') -> Counter:
        """Create (or fetch) a counter by name — idempotent, like
        artedi's collector.counter()."""
        self._check_collision(name, 'counter')
        if name not in self._counters:
            self._counters[name] = Counter(name, help_text)
        return self._counters[name]

    def histogram(self, name: str, help_text: str = '',
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        """Create (or fetch) a histogram by name — idempotent like
        :meth:`counter`, so shared collectors (many clients, one
        scrape) register per-op latency once.  Re-registering with
        DIFFERENT bucket bounds raises: silently handing back the
        first registrant's buckets would mis-bucket the second
        registrant's observations with no warning."""
        self._check_collision(name, 'histogram')
        existing = self._histograms.get(name)
        if existing is not None:
            want = tuple(sorted(float(b) for b in buckets))
            if want != existing.buckets:
                raise ValueError(
                    'histogram %r already registered with buckets %r '
                    '(requested %r); use a distinct name/prefix'
                    % (name, existing.buckets, want))
            return existing
        self._histograms[name] = Histogram(name, help_text, buckets)
        return self._histograms[name]

    def _check_gauge_free(self, name: str) -> None:
        """Gauges are never idempotent — a same-name registration (of
        any kind) raises: silently replacing would drop the first
        registrant's series (bind two instrumented components under
        distinct prefixes instead)."""
        self._check_collision(name, 'gauge')
        if name in self._gauges:
            raise ValueError(
                'metric %r already registered; use a distinct '
                'name/prefix' % (name,))

    def gauge(self, name: str, fn, help_text: str = '') -> Gauge:
        """Register a callback-backed gauge (see
        :meth:`_check_gauge_free` for the collision policy)."""
        self._check_gauge_free(name)
        self._gauges[name] = Gauge(name, fn, help_text)
        return self._gauges[name]

    def multi_gauge(self, name: str, fn,
                    help_text: str = '') -> MultiGauge:
        """Register a labelled pull gauge (callback returns
        ``{labels: value}``); same collision policy as :meth:`gauge`."""
        self._check_gauge_free(name)
        self._gauges[name] = MultiGauge(name, fn, help_text)
        return self._gauges[name]

    def histograms(self) -> list[Histogram]:
        return list(self._histograms.values())

    def get_collector(self, name: str):
        if name in self._counters:
            return self._counters[name]
        if name in self._histograms:
            return self._histograms[name]
        if name in self._gauges:
            return self._gauges[name]
        registered = sorted(list(self._counters) + list(self._gauges)
                            + list(self._histograms))
        raise ValueError(
            'no metric %r registered; registered names: %s'
            % (name, ', '.join(registered) or '(none)'))

    def expose(self) -> str:
        parts = [c.expose() for c in self._counters.values()]
        parts += [h.expose() for h in self._histograms.values()]
        parts += [g.expose() for g in self._gauges.values()]
        return '\n'.join(parts)
