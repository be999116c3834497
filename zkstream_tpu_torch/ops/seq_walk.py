"""The chunk walk of the sequence-parallel frame scan, one CUDA thread.

``parallel/seqscan.py`` cuts one long stream's byte axis into chunks
and hands the frame cursor from chunk to chunk around a ring.  A chunk,
once it learns its entry cursor, walks its frames until the cursor
passes its end; that walk is this module.  It replaces the XLA
``while_loop`` of ``zkstream_tpu/parallel/seqscan.py::_walk``, which is
not a Pallas kernel.  The CUDA C++ source is ``seq_walk_kernel`` in
``zkstream_tpu_torch/csrc/wire_scan.cu``, built with kernels K1 and K2
into one library, and it takes their frame step (``next_frame``), so
all three walks share one state machine.

What bounds it on an H100: latency.  Where a frame starts depends on
the length of the one before it, so the walk is one dependent round
trip to memory per frame; it must read only the 4 bytes of each
length prefix and write the chunk's start mask (:func:`bound_bytes`).
Its design is the simplest that makes no host round trip: one thread,
one launch per chunk per ring step, and the entry cursor, the
``valid`` flag and the exit cursor stay in device memory — the kernel
itself decides whether the chunk adopts the entry it was offered.  A
per-frame ``.item()`` loop would synchronise the host once per frame,
and a pointer-doubling formulation needs exit-cursor logic ``_walk``
does not have.

:func:`seq_walk` runs :func:`seq_walk_plain` for a tensor on the CPU
and the kernel for a tensor on a CUDA device; there is no fallback from
one to the other.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..protocol.consts import MAX_PACKET
from . import wire_scan

#: What this kernel replaces: an XLA while_loop, not a Pallas kernel.
REPLACES = 'zkstream_tpu/parallel/seqscan.py:41'

#: The exit cursor of a walk that hit a bad or truncated frame.
SATURATED = 1 << 30

#: Launches of the CUDA kernel since the last reset (the plain version
#: never counts).
launches = 0

_bound = None


class WalkState(NamedTuple):
    """One chunk's ring state, updated in place by :func:`seq_walk`."""

    valid: torch.Tensor   # int32 0-d: 1 once the chunk has walked
    exit: torch.Tensor    # int32 0-d: exit cursor (-1 before the walk)
    mask: torch.Tensor    # bool [C]: frame-start mask of the chunk
    bad: torch.Tensor     # bool 0-d: a bad length prefix was seen


def new_state(C: int, device) -> WalkState:
    """The zero state: not walked, exit -1, empty mask, not bad."""
    return WalkState(
        valid=torch.zeros((), dtype=torch.int32, device=device),
        exit=torch.full((), -1, dtype=torch.int32, device=device),
        mask=torch.zeros((C,), dtype=torch.bool, device=device),
        bad=torch.zeros((), dtype=torch.bool, device=device))


def load():
    """Build (if needed) the kernel library and bind the chunk walk's
    launcher; idempotent."""
    global _bound
    lib = wire_scan.load()
    if _bound is None:
        fn = lib.seq_walk_launch
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_longlong] * 4
                       + [ctypes.c_void_p] * 6)
        fn.restype = ctypes.c_int
        _bound = fn
    return lib


def walk_plain(ext, base: int, chunk_end: int, n: int, entry: int):
    """The plain walk, ``_walk``'s semantics, for a CPU tensor: walk
    frames from absolute cursor ``entry`` until past ``chunk_end`` (or
    the stream ends or goes bad).  ``ext`` is the chunk plus a 4-byte
    right halo.  Returns ``(exit cursor, bool mask [C], bad)``."""
    E = ext.shape[0]
    C = E - 4
    raw = ext.numpy().tobytes()

    def byte(i):
        return raw[min(max(i, 0), E - 1)]

    mask = torch.zeros((C,), dtype=torch.bool)
    q, bad, stop = entry, False, False
    while not stop and not bad and q < chunk_end and q + 4 <= n:
        lq = q - base
        ln = int.from_bytes(bytes(byte(lq + k) for k in range(4)), 'big',
                            signed=True)
        is_bad = ln < 0 or ln > MAX_PACKET
        complete = not is_bad and q + 4 + ln <= n
        if complete and 0 <= lq < C:
            mask[lq] = True
        if complete:
            q += 4 + ln
        bad = bad or is_bad
        stop = not complete
    # a bad prefix or truncated frame ends the whole stream's decode
    if bad or stop:
        q = SATURATED
    return q, mask, bad


def seq_walk_plain(ext, base: int, chunk_end: int, n: int, rcv,
                   state: WalkState) -> None:
    """One ring step of one chunk, plain: adopt the offered entry
    ``rcv`` (int32 0-d) and walk, unless the chunk walked already or no
    entry was offered (``rcv < 0``)."""
    entry = int(rcv)
    if int(state.valid) or entry < 0:
        return
    q, mask, bad = walk_plain(ext, base, chunk_end, n, entry)
    state.valid.fill_(1)
    state.exit.fill_(q)
    state.mask.copy_(mask)
    state.bad.fill_(bad)


def _check(ext, base, chunk_end, n, rcv, state) -> None:
    if ext.dtype != torch.uint8 or ext.dim() != 1 or ext.shape[0] < 5:
        raise ValueError('ext must be uint8 [C + 4] with C >= 1, got %s %s'
                         % (ext.dtype, tuple(ext.shape)))
    C = ext.shape[0] - 4
    if state.mask.shape != (C,) or state.mask.dtype != torch.bool:
        raise ValueError('state.mask must be bool [%d]' % C)
    if rcv.dtype != torch.int32 or rcv.numel() != 1:
        raise ValueError('rcv must be one int32 cursor')
    for t in (rcv, state.valid, state.exit, state.mask, state.bad):
        if t.device != ext.device:
            raise ValueError('the chunk walk\'s tensors must share a device')
    if not 0 <= base <= 2**31 - 1 or not 0 <= n <= 2**31 - 1 \
            or not 0 <= chunk_end <= 2**31 - 1 or C + 4 > 2**31 - 1:
        raise ValueError('cursors must lie in [0, 2^31)')


def seq_walk(ext, base: int, chunk_end: int, n: int, rcv,
             state: WalkState) -> None:
    """One ring step of one chunk: a CPU tensor runs
    :func:`seq_walk_plain`, a CUDA tensor launches the kernel on the
    current stream (which reads ``rcv`` and ``state.valid`` on the
    device and updates ``state`` there)."""
    global launches
    _check(ext, base, chunk_end, n, rcv, state)
    dev = ext.device
    if dev.type == 'cpu':
        seq_walk_plain(ext, base, chunk_end, n, rcv, state)
        return
    if dev.type != 'cuda':
        raise ValueError('the chunk walk runs on CUDA or CPU tensors, not %s'
                         % (dev,))
    if not (ext.is_contiguous() and state.mask.is_contiguous()):
        raise ValueError('the chunk walk needs contiguous ext and mask')
    load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _bound(ext.data_ptr(), ext.shape[0] - 4, base, chunk_end, n,
                    rcv.data_ptr(), state.valid.data_ptr(),
                    state.exit.data_ptr(), state.mask.data_ptr(),
                    state.bad.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError('chunk walk launch failed: cudaError %d' % (rc,))
    launches += 1


def bound_bytes(frames: int, C: int) -> int:
    """Bytes one walk must move: the 4-byte prefix of each frame it
    finds, the 4-byte entry read, and the chunk's mask plus the exit,
    flag and bad written."""
    return 4 * frames + 4 + C + 9
