"""A tick program recorded once into a CUDA graph and replayed each tick.

The JAX ingest compiles its tick for each shape bucket ahead of time,
off the event loop, into one XLA executable, so a tick is one dispatch
(``zkstream_tpu/io/ingest.py``: ``_step_fn``, ``_compile``).  On a card
the counterpart is a CUDA graph: :class:`TickGraph` runs the port's
eager tick chain once under stream capture on the bucket's static input
tensors, and each tick then replays every recorded launch (kernel K1 or
K2, and the torch ops around it) with one call.  Nothing is compiled:
the graph holds the port's own kernels and the same torch ops.

Launch counts stay true under capture.  A kernel wrapper counts a launch
with :func:`count_launch`; while a thread is :func:`recording`, the
launches it makes there (a capture, which runs nothing, and the warm-up
run before it) go into that record instead of the wrappers' counts, and
each :meth:`TickGraph.replay` adds the captured record to them.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time

_tls = threading.local()


def count_launch(module: str) -> None:
    """Count one kernel launch of the wrapper module ``module`` (its
    ``launches``), or, while this thread is :func:`recording`, note it in
    that record instead."""
    rec = getattr(_tls, 'record', None)
    if rec is None:
        sys.modules[module].launches += 1
    else:
        rec[module] = rec.get(module, 0) + 1


@contextlib.contextmanager
def recording():
    """Launches this thread makes inside the block are noted in the
    yielded ``{module: launches}`` dict, not in the wrappers' counts."""
    prev = getattr(_tls, 'record', None)
    _tls.record = rec = {}
    try:
        yield rec
    finally:
        _tls.record = prev


class TickGraph:
    """``program()`` captured into a CUDA graph on ``device``.

    ``program`` reads only tensors that outlive the graph (the bucket's
    static inputs) and returns the tick's outputs, which the graph keeps
    in ``out`` and overwrites on every replay.  Capture runs on
    ``stream``, a side stream of the caller's, in ``thread_local`` mode,
    so another thread may replay other graphs meanwhile; the graph's
    memory comes from ``pool``, shared by all of an ingest's graphs
    (their replays are serialized on one stream, and each tick reads its
    outputs back before the next).  One eager run of ``program`` on that
    stream comes first, so lazy set-up (kernel libraries, K2's occupancy
    query, torch's own modules) never happens under capture; its
    launches are kept apart in ``warm_launches``.

    Attributes: ``out``; ``launches`` — ``{module: n}`` the graph replays
    each time; ``warm_launches``; ``warm_ms`` and ``capture_ms`` on the
    host clock.
    """

    def __init__(self, program, device, stream, pool):
        import torch

        with torch.cuda.device(device), torch.cuda.stream(stream):
            t0 = time.perf_counter()
            with recording() as self.warm_launches:
                program()
            stream.synchronize()
            t1 = time.perf_counter()
            self.graph = torch.cuda.CUDAGraph()
            with recording() as self.launches:
                self.graph.capture_begin(pool=pool,
                                         capture_error_mode='thread_local')
                try:
                    self.out = program()
                except BaseException:
                    # end the capture the error left open; its own error
                    # (an invalidated capture) says less than this one
                    with contextlib.suppress(Exception):
                        self.graph.capture_end()
                    raise
                self.graph.capture_end()
        self.warm_ms = (t1 - t0) * 1e3
        self.capture_ms = (time.perf_counter() - t1) * 1e3

    def replay(self):
        """Run the recorded tick on the current stream; returns ``out``."""
        self.graph.replay()
        for module, n in self.launches.items():
            sys.modules[module].launches += n
        return self.out
