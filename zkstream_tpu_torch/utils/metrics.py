"""Prometheus-style metrics: the port's copy of the parts of
``zkstream_tpu.utils.metrics`` the fleet ingest uses — the latency
``Histogram`` (``FleetIngest.tick_hist``), the pull-model ``Gauge`` and
the ``Collector`` that ``FleetIngest.bind_metrics`` registers them on.
"""

from __future__ import annotations


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
    """Normalize a label set (dict, or an iterable of (k, v) pairs) to
    a sorted tuple."""
    if not labels:
        return ()
    items = labels.items() if isinstance(labels, dict) else labels
    return tuple(sorted(items))


#: Default latency buckets, milliseconds: sub-ms client-loop hops up
#: through multi-second retry storms.
DEFAULT_BUCKETS = (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
                   250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0)


class Histogram:
    """A labelled Prometheus histogram: cumulative ``_bucket`` series
    (``le`` upper bounds plus ``+Inf``), ``_sum``, and ``_count``."""

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

    def count(self, labels: dict[str, str] | None = None) -> int:
        row = self._series.get(_label_key(labels))
        return sum(row[:-1]) if row is not None else 0

    def sum(self, labels: dict[str, str] | None = None) -> float:
        row = self._series.get(_label_key(labels))
        return row[-1] if row is not None else 0.0

    def percentile(self, q: float,
                   labels: dict[str, str] | None = None) -> float:
        """Estimate the ``q``-th percentile (0..100) the way
        ``histogram_quantile`` does; an empty series returns NaN."""
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
                    _render_labels(key, (('le', '%g' % (bound,)),)),
                    cum))
            cum += row[len(self.buckets)]
            lines.append('%s_bucket%s %d' % (
                self.name, _render_labels(key, (('le', '+Inf'),)), cum))
            lines.append('%s_sum%s %s' % (self.name,
                                          _render_labels(key), row[-1]))
            lines.append('%s_count%s %d' % (self.name,
                                            _render_labels(key), cum))
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


class Collector:
    """Registry of gauges and histograms with one text exposition."""

    def __init__(self) -> None:
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def _check_collision(self, name: str, kind: str) -> None:
        for other_kind, table in (('gauge', self._gauges),
                                  ('histogram', self._histograms)):
            if kind != other_kind and name in table:
                raise ValueError(
                    'metric %r already registered as a %s'
                    % (name, other_kind))

    def histogram(self, name: str, help_text: str = '',
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        """Create (or fetch) a histogram by name — idempotent, so shared
        collectors register a series once.  Re-registering with
        DIFFERENT bucket bounds raises: silently handing back the first
        registrant's buckets would mis-bucket the second registrant's
        observations with no warning."""
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

    def gauge(self, name: str, fn, help_text: str = '') -> Gauge:
        """Register a callback-backed gauge.  Gauges are never
        idempotent — a same-name registration (of any kind) raises:
        silently replacing would drop the first registrant's series
        (bind two instrumented components under distinct prefixes
        instead)."""
        self._check_collision(name, 'gauge')
        if name in self._gauges:
            raise ValueError(
                'metric %r already registered; use a distinct '
                'name/prefix' % (name,))
        self._gauges[name] = Gauge(name, fn, help_text)
        return self._gauges[name]

    def get_collector(self, name: str):
        if name in self._histograms:
            return self._histograms[name]
        if name in self._gauges:
            return self._gauges[name]
        registered = sorted(list(self._gauges) + list(self._histograms))
        raise ValueError(
            'no metric %r registered; registered names: %s'
            % (name, ', '.join(registered) or '(none)'))

    def expose(self) -> str:
        parts = [h.expose() for h in self._histograms.values()]
        parts += [g.expose() for g in self._gauges.values()]
        return '\n'.join(parts)
