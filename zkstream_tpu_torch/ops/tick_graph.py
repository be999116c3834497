"""A tick program recorded once into a CUDA graph and replayed each tick.

The JAX ingest compiles its tick for each shape bucket ahead of time,
off the event loop, into one XLA executable, so a tick is one dispatch
(``zkstream_tpu/io/ingest.py``: ``_step_fn``, ``_compile``).  On a card
the counterpart is a CUDA graph: :class:`TickGraph` runs the port's
eager tick chain once under stream capture on the bucket's static input
tensors, and each tick then replays every recorded launch (kernel K1 or
K2, and the torch ops around it) with one call.  Nothing is compiled:
the graph holds the port's own kernels and the same torch ops.

The JAX package's other one-card programs (``jax.jit`` of the sharded
step and roundtrip, of the sequence-parallel scan, and of the bench's
candidates) become :class:`Program`: one ``TickGraph`` per key of
argument shapes, dtypes and devices, captured on its first call and
replayed on every later one, as ``jax.jit`` compiles once per shape.

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


def count_launch(module: str, counter: str = 'launches') -> None:
    """Count one kernel launch of the wrapper module ``module`` (its
    ``counter``, default ``launches``), or, while this thread is
    :func:`recording`, note it in that record instead (keyed
    ``module``, or ``module:counter`` for another counter)."""
    key = module if counter == 'launches' else '%s:%s' % (module, counter)
    rec = getattr(_tls, 'record', None)
    if rec is None:
        _add(key, 1)
    else:
        rec[key] = rec.get(key, 0) + 1


def _split(key: str) -> tuple:
    module, _, counter = key.partition(':')
    return sys.modules[module], counter or 'launches'


def launch_count(key: str) -> int:
    """The launch counter a record key names (``module`` or
    ``module:counter``)."""
    return getattr(*_split(key))


def _add(key: str, n: int) -> None:
    mod, counter = _split(key)
    setattr(mod, counter, getattr(mod, counter) + n)


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


class CaptureError(RuntimeError):
    """``program`` failed while a :class:`TickGraph` recorded it, after
    its eager run on the same inputs succeeded: an op of the program
    that capture refuses (a pageable copy, a host sync), not a kernel
    that fails to build or launch."""


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
    launches are kept apart in ``warm_launches``.  A failure of that run
    is raised as it is; one under capture is raised as
    :class:`CaptureError`.

    Attributes: ``out``; ``launches`` — ``{module: n}`` the graph replays
    each time; ``warm_launches``; ``warm_ms`` and ``capture_ms`` on the
    host clock.
    """

    def __init__(self, program, device, stream, pool):
        import torch

        # the program's inputs were written on the caller's stream
        stream.wait_stream(torch.cuda.current_stream(device))
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
                    self.graph.capture_end()
                except Exception as e:
                    # end the capture the error left open; its own error
                    # (an invalidated capture) says less than this one
                    with contextlib.suppress(Exception):
                        self.graph.capture_end()
                    raise CaptureError('capture failed: %s' % (e,)) from e
        self.warm_ms = (t1 - t0) * 1e3
        self.capture_ms = (time.perf_counter() - t1) * 1e3

    def replay(self):
        """Run the recorded tick on the current stream; returns ``out``."""
        self.graph.replay()
        for key, n in self.launches.items():
            _add(key, n)
        return self.out


def _sig(a, device):
    """One argument's part of a :class:`Program`'s key: a tensor's shape,
    dtype and device, a list's of each element; a host int's is that of
    the int32 scalar on ``device`` it is staged into."""
    import torch

    if isinstance(a, (list, tuple)):
        return tuple(_sig(x, device) for x in a)
    if isinstance(a, int):
        return ((), torch.int32, device)
    return (tuple(a.shape), a.dtype, a.device)


def _alloc(a, device):
    """A program's input for an argument like ``a``, zeroed on
    ``device``: a host int's is an int32 scalar."""
    import torch

    if isinstance(a, (list, tuple)):
        return [_alloc(x, device) for x in a]
    if isinstance(a, int):
        return torch.zeros((), dtype=torch.int32, device=device)
    return torch.zeros(a.shape, dtype=a.dtype, device=device)


def _stage(dst, src) -> None:
    """Stage the argument ``src`` into the program's input ``dst``:
    nothing when ``src`` is ``dst``, else one copy on the current stream
    (a ``fill_`` for a host int)."""
    if isinstance(dst, list):
        for d, s in zip(dst, src):
            _stage(d, s)
    elif isinstance(src, int):
        dst.fill_(src)
    elif src is not dst:
        dst.copy_(src)


def owned(out):
    """Copies of a program's outputs (tensors in tuples, lists and
    NamedTuples) that no later call overwrites: fresh tensors, filled by
    one ``torch._foreach_copy_`` a dtype and device (one multi-tensor
    launch each on a card, where a clone a tensor is a launch a
    tensor)."""
    import torch
    from torch.utils._pytree import tree_flatten, tree_unflatten

    leaves, spec = tree_flatten(out)
    copies = [torch.empty_like(t) for t in leaves]
    groups: dict = {}
    for c, t in zip(copies, leaves):
        dst, src = groups.setdefault((t.dtype, t.device), ([], []))
        dst.append(c)
        src.append(t)
    for dst, src in groups.values():
        torch._foreach_copy_(dst, src)
    return tree_unflatten(copies, spec)


class Program:
    """``fn`` run as one program per key: the port of ``jax.jit`` for a
    program on one card.

    ``fn(*args)`` takes tensors, lists of tensors and host ints (an int
    is an int32 scalar on ``device`` inside the program, as ``jax.jit``
    traces a Python int) and returns tensors in tuples, lists and
    NamedTuples.  A call's key is each argument's shape, dtype and
    device, after ``static`` (what ``fn`` closes over that jit would
    take as static arguments: widths, the mesh, the tile).  Each key has
    an :class:`Entry`, which owns its input tensors on ``device``; a
    call is staged into them: an argument that *is* the input tensor is
    not copied, any other costs one device copy on the current stream.
    On a card the entry captures ``fn`` on its inputs once into a
    :class:`TickGraph` (its first call: an eager warm-up run, then the
    capture, on a side stream and in a pool that the program's entries
    share, so their replays must stay on one stream) and each call
    replays it.  On the CPU the staging and keying are the same and
    ``fn`` runs eagerly on the inputs.  A capture that fails raises:
    nothing runs the eager chain in a graph's place.

    ``graphed`` false (a mesh with a process group, or shards on more
    than one device) makes the program ``fn`` itself, run eagerly on
    the caller's arguments (a host int as an int32 scalar on
    ``device``), with no key, staging or capture.

    Attributes: ``fn``, ``device``, ``graphed``, ``static``, ``entries``
    (``{key: Entry}``), ``pool`` (the graphs' memory pool, None before
    the first capture).
    """

    def __init__(self, fn, device, graphed: bool = True, static=()):
        import torch

        self.fn = fn
        self.device = torch.device(device)
        self.graphed = graphed
        self.static = tuple(static)
        self.entries: dict = {}
        self.pool = self._stream = None

    def key(self, args) -> tuple:
        return self.static + tuple(_sig(a, self.device) for a in args)

    def entry(self, *args) -> 'Entry':
        """The entry for ``args``' key, built (and, on a card, captured)
        on first use; ``args`` are not staged."""
        if not self.graphed:
            raise ValueError('an eager program has no entries')
        k = self.key(args)
        e = self.entries.get(k)
        if e is None:
            e = Entry(self, [_alloc(a, self.device) for a in args])
            self.entries[k] = e
        return e

    def __call__(self, *args):
        """Run on ``args``.  The outputs are the caller's: a staged
        call's are :func:`owned` copies of the program's (which its next
        run overwrites); an eager call's are ``fn``'s."""
        if not self.graphed:
            import torch

            return self.fn(*[torch.tensor(a, dtype=torch.int32,
                                          device=self.device)
                             if isinstance(a, int) else a for a in args])
        e = self.entry(*args)
        e.stage(*args)
        return owned(e.run())


class Entry:
    """One key of a :class:`Program`: its input tensors ``inputs`` (in
    the arguments' structure) and, on a card, its captured ``graph``."""

    def __init__(self, prog: Program, inputs: list):
        self.prog, self.inputs, self.graph = prog, inputs, None
        if prog.device.type == 'cuda':
            import torch

            if prog.pool is None:
                prog._stream = torch.cuda.Stream(prog.device)
                prog.pool = torch.cuda.graph_pool_handle()
            self.graph = TickGraph(lambda: prog.fn(*inputs), prog.device,
                                   prog._stream, prog.pool)

    def stage(self, *args) -> None:
        """Stage ``args`` into the inputs (no copy for an input itself)."""
        for dst, src in zip(self.inputs, args):
            _stage(dst, src)

    def run(self):
        """One run on the staged inputs: a replay of the graph on a card
        (the outputs are the graph's, valid until the next replay of any
        of the program's entries, which share its pool), ``fn`` run
        eagerly on the CPU."""
        if self.graph is not None:
            return self.graph.replay()
        return self.prog.fn(*self.inputs)
