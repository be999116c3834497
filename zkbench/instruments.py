"""Instruments copied into the benchmark, frozen as its yardstick.

- :class:`GcPauses` is a copy of ``chip_smoke.py``'s ``_GcPauses`` (the
  interpreter's collector pauses through ``gc.callbacks``), which also
  keeps each pause's interval, so a traced run can label device idle
  time by it.
- :class:`LoopLag`: a 10 ms timer on the client's event loop and how
  late each of its wake-ups came (``chip_smoke.py``'s ``_lag_monitor``
  keeps only the longest; this keeps every sample).
- :func:`k1_bytes`: the bytes one launch of kernel K1 must move, at
  ``HBM_BYTES_PER_S`` (``chip_smoke.py``'s H100 SXM rate): a copy of
  ``zkstream_tpu_torch/ops/wire_scan.py``'s ``bound_bytes``.  K1 walks
  frame headers only, so it reads 20 bytes a frame it finds (the
  length prefix and the reply header) and 4 of ``lens`` a row, and
  writes the six int32 ``[B, F]`` header planes and the per-row
  ``counts``, ``resid`` (int32) and ``bad`` (bool) once; the bodies
  it skips are not counted.
- :func:`quantile`: Python's ``statistics.quantiles`` with an
  infinite value for a sample that never came.
"""

from __future__ import annotations

import asyncio
import gc
import math
import time

#: H100 SXM published HBM3 rate, bytes a second (chip_smoke.py).
HBM_BYTES_PER_S = 3.35e12


class GcPauses:
    """The interpreter's garbage-collector pauses while installed: their
    total seconds, the longest, their count by generation, and (with
    ``keep``) each pause as ``(start, end)`` on ``time.perf_counter``."""

    def __init__(self, keep: bool = False):
        self.s, self.n, self._t, self.max = 0.0, [0, 0, 0], 0.0, 0.0
        self.spans: list | None = [] if keep else None

    def __call__(self, phase, info):
        if phase == 'start':
            self._t = time.perf_counter()
        else:
            t = time.perf_counter()
            d = t - self._t
            self.s += d
            self.max = max(self.max, d)
            self.n[info['generation']] += 1
            if self.spans is not None:
                self.spans.append((self._t, t))

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)

    def seconds_in(self, t0: float, t1: float) -> float:
        """Pause seconds inside ``[t0, t1)``."""
        return sum(max(0.0, min(b, t1) - max(a, t0))
                   for a, b in self.spans)


class LoopLag:
    """How late a 10 ms timer on the running loop wakes, each time."""

    PERIOD = 0.01

    def __init__(self):
        self.samples: list = []      # (wake time, lateness s)
        self._task = None

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def _run(self) -> None:
        while True:
            t = time.perf_counter()
            await asyncio.sleep(self.PERIOD)
            now = time.perf_counter()
            self.samples.append((now, now - t - self.PERIOD))

    async def stop(self) -> None:
        self._task.cancel()
        try:
            await self._task
        except asyncio.CancelledError:
            pass

    def lateness_in(self, t0: float, t1: float) -> list:
        return [d for t, d in self.samples if t0 <= t < t1]


def k1_bytes(rows: int, max_frames: int, frames_found: int) -> int:
    """Bytes one K1 launch over ``rows`` rows must move: 20 read a
    frame found and 4 of ``lens`` a row; six int32 planes of
    ``max_frames`` slots and 9 bytes a row written."""
    return 20 * frames_found + 4 * rows + 24 * rows * max_frames + 9 * rows


def quantile(values: list, q: float) -> float:
    """The ``q`` quantile (0 < q < 1) of ``values`` as
    ``statistics.quantiles(values, n=100, method='exclusive')`` cuts
    them, ``math.inf`` standing for a sample that never came."""
    xs = sorted(values)
    n = len(xs)
    if n == 0:
        return math.nan
    # statistics.quantiles' exclusive method: position q * (n + 1)
    pos = q * (n + 1)
    j = int(pos)
    if j < 1:
        return xs[0]
    if j >= n:
        return xs[-1]
    lo, hi = xs[j - 1], xs[j]
    if math.isinf(lo) or math.isinf(hi):
        return hi
    return lo + (pos - j) * (hi - lo)
