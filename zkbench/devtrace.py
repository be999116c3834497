"""The traced run: ``torch.profiler`` over the window, and ranges
(``torch.profiler.record_function``) that the harness opens around its
own calls into each layer of the client process, so that the device's
idle time can be put down to what the host was doing.

Ranges, each around a synchronous call (none spans an ``await``):

- ``client.op``: the port ``Client`` encoding and queueing one request
  (``Client._start_op``);
- ``ingest.feed``: bytes handed to ``FleetIngest`` (a pass-through
  tick decodes them there);
- ``ingest.tick``: one ``FleetIngest`` tick, and inside it
  ``ingest.device_half`` (staging, the copies in, the graph replay,
  the readback: ``FleetIngest._run_step``);
- ``loop.select``: the event loop waiting on its sockets;
- ``gc.pause``: the interpreter's collector.

Anything else is ``host: other``.  Kernel and copy intervals on the
device are merged; their union is the busy time, and the gaps between
them inside the window are the idle time.
"""

from __future__ import annotations

import gc
import time

from .instruments import k1_bytes

#: Ranges this module opens (the labels of idle time).
RANGES = ('client.op', 'ingest.feed', 'ingest.tick', 'ingest.device_half',
          'loop.select', 'gc.pause')
OTHER = 'host: other'
WINDOW = 'zkbench.window'
#: Device-side records that are waits, not work.
_WAITS = ('Event Sync', 'Stream Sync', 'Context Sync', 'Device Sync')
#: K1's kernel, as the profiler names it.
K1_KERNEL = 'wire_scan_kernel'


class Tracer:
    """Profiles the client process over the window."""

    def __init__(self, torch):
        self.torch = torch
        self._undo: list = []
        self._prof = None
        self._window = None
        #: per tick replay: [time, bucket shape, frame slots a row,
        #: frames K1 found]
        self.replays: list = []

    def _wrap(self, obj, name: str, label: str) -> None:
        rf = self.torch.profiler.record_function
        orig = getattr(obj, name)

        def wrapped(*a, **kw):
            with rf(label):
                return orig(*a, **kw)
        self._set(obj, name, wrapped)

    def _set(self, obj, name: str, value) -> None:
        self._undo.append((obj, name, obj.__dict__.get(name)))
        setattr(obj, name, value)

    def install(self, loop, ingest, client_cls) -> None:
        """Open the ranges on this run's objects (the ingest instance,
        the ``Client`` class, the loop's selector)."""
        self._wrap(client_cls, '_start_op', 'client.op')
        self._wrap(ingest, 'feed', 'ingest.feed')
        self._wrap(ingest, '_tick', 'ingest.tick')
        run_step, unpack = ingest._run_step, ingest._unpack
        replays = self.replays
        rf = self.torch.profiler.record_function

        def run_step_rec(bk, active):
            with rf('ingest.device_half'):
                out = run_step(bk, active)
            replays.append([time.perf_counter(), tuple(bk.stage_buf.shape),
                            ingest.max_frames, 0])
            return out

        def unpack_rec(ints, byts):
            # the replay's readback, unpacked: K1's frame counts a row
            st, bd = unpack(ints, byts)
            replays[-1][3] = int(st.n_frames.sum())
            return st, bd
        self._set(ingest, '_run_step', run_step_rec)
        self._set(ingest, '_unpack', unpack_rec)
        self._wrap(loop._selector, 'select', 'loop.select')
        ops = self.torch.ops.profiler
        handle = [None]

        def on_gc(phase, info):
            if phase == 'start':
                handle[0] = ops._record_function_enter_new('gc.pause', None)
            elif handle[0] is not None:
                ops._record_function_exit._RecordFunction(handle[0])
                handle[0] = None
        gc.callbacks.append(on_gc)
        self._gc = on_gc

    def uninstall(self) -> None:
        for obj, name, own in reversed(self._undo):
            if own is None:
                delattr(obj, name)
            else:
                setattr(obj, name, own)
        self._undo.clear()
        gc.callbacks.remove(self._gc)

    def start(self) -> None:
        P = self.torch.profiler
        self._prof = P.profile(activities=[P.ProfilerActivity.CPU,
                                           P.ProfilerActivity.CUDA])
        self._prof.__enter__()

    def open_window(self) -> None:
        self._window = self.torch.ops.profiler._record_function_enter_new(
            WINDOW, None)

    def close_window(self) -> None:
        self.torch.ops.profiler._record_function_exit._RecordFunction(
            self._window)

    def stop(self) -> None:
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)

    def read(self, w0: float, w1: float) -> dict:
        """What the trace shows over the window: device busy seconds,
        the window's length, the device ops that took most time, the
        idle time by host range, and K1's device seconds and bytes."""
        events = self._prof.profiler.kineto_results.events()
        cpu = self.torch.autograd.DeviceType.CPU
        busy, ranges = [], []
        win = None
        by_name: dict = {}
        k1_s = 0.0
        for e in events:
            name = e.name()
            on_host = e.device_type() == cpu
            if e.is_user_annotation():
                # a range shows on the host and, mirrored, on the device
                if on_host and name == WINDOW:
                    win = (e.start_ns(), e.end_ns())
                elif on_host and name in RANGES:
                    ranges.append((e.start_ns(), e.end_ns(), name))
                continue
            # the device's own records: kernels, copies and fills
            if not on_host and not name.startswith(_WAITS):
                busy.append((e.start_ns(), e.end_ns(), name))
        if win is None:
            raise RuntimeError('the trace lost the window marker')
        a, b = win
        for s, t, name in busy:
            s, t = max(s, a), min(t, b)
            if t > s:
                by_name[name] = by_name.get(name, 0) + (t - s)
                if K1_KERNEL in name:
                    k1_s += (t - s) / 1e9
        merged = _union([(max(s, a), min(t, b)) for s, t, _n in busy
                         if min(t, b) > max(s, a)])
        busy_ns = sum(t - s for s, t in merged)
        gaps, prev = [], a
        for s, t in merged:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, t)
        if b > prev:
            gaps.append((prev, b))
        idle = _label(gaps, ranges)
        k1 = [r for r in self.replays if w0 <= r[0] < w1]
        buckets: dict = {}
        for _t, shape, _f, _n in k1:
            key = '%dx%d' % shape
            buckets[key] = buckets.get(key, 0) + 1
        return {
            'busy_s': busy_ns / 1e9,
            'window_s': (b - a) / 1e9,
            'device_ops': sorted(([n, v / 1e9] for n, v in by_name.items()),
                                 key=lambda x: -x[1])[:10],
            'idle_gaps': sorted(([n, v / 1e9] for n, v in idle.items()),
                                key=lambda x: -x[1])[:10],
            'k1_device_s': k1_s,
            'k1_bytes': sum(k1_bytes(shape[0], f, n)
                            for _t, shape, f, n in k1),
            'k1_replays': len(k1),
            'buckets': buckets,
        }


def _union(intervals: list) -> list:
    out: list = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            if t > out[-1][1]:
                out[-1][1] = t
        else:
            out.append([s, t])
    return out


def _label(gaps: list, ranges: list) -> dict:
    """Idle nanoseconds by the innermost host range open at each
    instant (ranges nest: every one is opened and closed on the one
    loop thread), the rest as ``host: other``."""
    marks = []
    for s, t, name in ranges:
        marks.append((s, 1, t, name))
        marks.append((t, 0, s, name))
    marks.sort(key=lambda m: (m[0], m[1]))
    # pieces: (start, end, label) where the innermost open range holds
    pieces, stack, last = [], [], None
    for at, opening, _other, name in marks:
        if last is not None and at > last:
            pieces.append((last, at, stack[-1] if stack else OTHER))
        last = at
        if opening:
            stack.append(name)
        elif name in stack:
            # close the innermost range of this name
            k = len(stack) - 1 - stack[::-1].index(name)
            del stack[k]
    out: dict = {}
    i = 0
    for gs, gt in gaps:
        covered = 0
        while i < len(pieces) and pieces[i][1] <= gs:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < gt:
            s, t, name = pieces[j]
            d = min(t, gt) - max(s, gs)
            if d > 0:
                out[name] = out.get(name, 0) + d
                covered += d
            j += 1
        rest = (gt - gs) - covered
        if rest > 0:
            out[OTHER] = out.get(OTHER, 0) + rest
    return out
