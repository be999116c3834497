"""Prometheus-style latency histogram (the port's copy of
``zkstream_tpu.utils.metrics.Histogram``, the one metric type the
fleet ingest owns: ``FleetIngest.tick_hist``)."""

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
