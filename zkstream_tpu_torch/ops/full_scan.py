"""Kernel K2: kernel K1's frame walk plus the GET_DATA body, one launch.

Replaces the TPU kernel ``zkstream_tpu/ops/pallas_scan.py::_full_kernel``
(launched by ``pallas_wire_full_scan``).  The CUDA C++ source is
``zkstream_tpu_torch/csrc/wire_scan.cu`` (``full_scan_kernel``), in the
same library as K1 and sharing K1's frame step.

Per frame slot it writes K1's six planes plus the raw jute length at
body+16 (``dlen_raw``), the payload as big-endian words
(``data_words``, only the words the field reaches) and the trailing
68-byte Stat as 17 big-endian words (``stat_words``, only where it fits
the frame).  :func:`~zkstream_tpu_torch.ops.pipeline.wire_full_decode`
unpacks those into a ``GetDataBodies``.

What bounds it on an H100: memory — :func:`bound_bytes` counts the
bytes it must move for a given input (at the bench shape it reads most
of every row and writes 352 bytes per frame slot).  A walk that reads
the row where the frames say would be a chain of dependent round trips
(length, then jute length, then body), so instead each warp streams
its row through a ring of shared-memory stages filled by Hopper's bulk
asynchronous copies ahead of the cursor, and walks the frames out of
the ring; frames outside the staged window read device memory
directly.  The lanes split each frame's body words so the
``[B, F, DW]`` and ``[B, F, 17]`` stores are coalesced (16 bytes a lane
where ``DW % 4 == 0``), and the seven ``[B, F]`` header planes are
buffered in shared memory and written as runs.  The grid is
persistent: as many blocks as fit on the card, each warp taking rows
``w, w + W, ...``.  :func:`launch_config` computes the geometry.  What
is left between it and its bound is each warp's walk: the frames of a
row are found one after another, a chain of shared-memory reads and
extent checks (``PERF.md`` keeps the measured share).

:func:`full_scan` runs the plain torch version for a tensor on the CPU
and the kernel for a tensor on a CUDA device; there is no fallback from
one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from ..protocol.consts import MAX_PACKET
from . import wire_scan
from .bytesops import be_i32_at
from .wire_scan import _MAX_ROW

#: Where the TPU kernel this module replaces lives.
REPLACES = 'zkstream_tpu/ops/pallas_scan.py:135'

#: Stat words per frame slot: 6 longs as (hi, lo) words + 5 ints.
STAT_WORDS = 17

#: Ring stages per warp (a power of two) and the largest stage.
STAGES = 4
MAX_STAGE_BYTES = 1024
#: Warps (rows in flight) per block; the kernel's ``__launch_bounds__``.
WARPS = 8
#: Frames of the header planes buffered in shared memory per warp.
MAX_HDR_FRAMES = 64
#: Shared memory one block may use on an H100.
SMEM_LIMIT = 232448

#: Launches of the CUDA kernel since the last reset (the plain version
#: never counts).
launches = 0

#: K2's [B, F] planes, in the order of its [7, B, F] output: K1's, then
#: the raw jute length
_HDR = wire_scan._PLANES + ('dlen_raw',)
_bound = None
#: (device index, warps, shared-memory bytes) -> K2 blocks resident at once
_resident: dict = {}


def load():
    """Build (if needed) the kernel library and bind K2's launcher and
    its occupancy query; idempotent."""
    global _bound
    lib = wire_scan.load()
    if _bound is None:
        q = lib.full_scan_resident
        q.argtypes = [ctypes.c_int, ctypes.c_int,
                      ctypes.POINTER(ctypes.c_int)]
        q.restype = ctypes.c_int
        fn = lib.full_scan_launch
        fn.argtypes = ([ctypes.c_void_p] * 2
                       + [ctypes.c_int, ctypes.c_longlong]
                       + [ctypes.c_int] * 8
                       + [ctypes.c_void_p] * 7)
        fn.restype = ctypes.c_int
        _bound = fn
    return lib


def resident_blocks(device, warps: int, smem_bytes: int) -> int:
    """Blocks of K2 with ``warps`` warps and ``smem_bytes`` of dynamic
    shared memory that the card ``device`` holds at once, from the CUDA
    occupancy calculator; asked once per device and geometry."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    key = (device.index, warps, smem_bytes)
    if key not in _resident:
        lib = load()
        n = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = lib.full_scan_resident(warps, smem_bytes, ctypes.byref(n))
        if rc != 0:
            raise RuntimeError('K2 occupancy query failed: cudaError %d'
                               % (rc,))
        if n.value <= 0:
            raise RuntimeError('K2 does not fit on %s with %d warps and %d '
                               'bytes of shared memory a block'
                               % (device, warps, smem_bytes))
        _resident[key] = n.value
    return _resident[key]


def build_report() -> str:
    """The ``nvcc -Xptxas -v`` output of the loaded library."""
    return wire_scan.build_report()


def launch_config(B: int, L: int, max_frames: int,
                  resident: int | None = None) -> dict:
    """K2's launch geometry for a ``[B, L]`` batch walked to
    ``max_frames``.  The body words stream through the ring, so the
    data width does not enter it.

    ``stage_bytes``: a power of two from 64 to 1024, about a quarter of
    a row (a short row needs no more ring than itself); ``stages`` of
    them per warp; ``warps`` per block; ``hdr_frames``: frames of the
    seven header planes buffered per warp (a multiple of 4, at most 64);
    ``smem_bytes``: the block's dynamic shared memory (mbarriers rounded
    to 16 bytes, then the rings, then the header buffers); ``blocks``:
    the grid, enough to give every row a warp but no more than
    ``resident`` (the blocks the card holds at once,
    :func:`resident_blocks`; ``None`` leaves it uncapped), so the grid
    is persistent and its warps loop over the rows."""
    quarter = -(-max(L, 1) // STAGES)
    stage = min(MAX_STAGE_BYTES, max(64, 1 << (quarter - 1).bit_length()))
    hdr_frames = min(MAX_HDR_FRAMES, max(4, -(-max_frames // 4) * 4))
    bars = -(-WARPS * STAGES * 8 // 16) * 16
    smem = (bars + WARPS * STAGES * stage
            + WARPS * len(_HDR) * hdr_frames * 4)
    blocks = -(-B // WARPS)
    return {'stage_bytes': stage, 'stage_shift': stage.bit_length() - 1,
            'stages': STAGES, 'warps': WARPS, 'hdr_frames': hdr_frames,
            'smem_bytes': smem,
            'blocks': blocks if resident is None else min(blocks, resident)}


def _body_words(buf, starts, sizes, max_data: int) -> dict:
    """K2's body planes from K1's ``starts``/``sizes``, with the masks
    the kernel applies (reads clamped to ``[0, L-1]``)."""
    B, F = starts.shape
    DW = max_data // 4
    hdr_ok = (starts >= 0) & (sizes >= 16)
    p = torch.where(hdr_ok, starts, 0)
    dlen = torch.where(hdr_ok, be_i32_at(buf, p + 16), 0)
    nb = dlen.clamp(0, MAX_PACKET + 1)
    w4 = 4 * torch.arange(DW, dtype=torch.int32, device=buf.device)
    need = hdr_ok[..., None] & (w4 < nb[..., None])
    off = (p + 20)[..., None] + w4
    dwords = be_i32_at(buf, off.reshape(B, F * DW)).reshape(B, F, DW)
    s_ok = hdr_ok & (20 + nb + 68 <= sizes)
    k4 = 4 * torch.arange(STAT_WORDS, dtype=torch.int32, device=buf.device)
    soff = (p + 20 + nb)[..., None] + k4
    swords = be_i32_at(buf, soff.reshape(B, F * STAT_WORDS)).reshape(
        B, F, STAT_WORDS)
    return {'dlen_raw': dlen,
            'data_words': torch.where(need, dwords, 0),
            'stat_words': torch.where(s_ok[..., None], swords, 0)}


def full_scan_plain(buf, lens, max_frames: int, max_data: int) -> dict:
    """The plain torch version: K1's plain version plus the body-word
    gathers, in K2's output layout."""
    out = wire_scan.wire_scan_plain(buf, lens, max_frames)
    out.update(_body_words(buf, out['starts'], out['sizes'], max_data))
    return out


def full_scan(buf, lens, max_frames: int, max_data: int) -> dict:
    """Frame scan + header parse + GET_DATA body words of a
    ``uint8 [B, L]`` batch.

    Returns K1's planes (int32 ``[B, F]`` ``starts``, ``sizes``,
    ``xid``, ``zxid_hi``, ``zxid_lo``, ``err``; int32 ``[B]``
    ``counts``, ``resid``; bool ``[B]`` ``bad``) plus int32 ``[B, F]``
    ``dlen_raw``, ``[B, F, max_data/4]`` ``data_words`` and
    ``[B, F, 17]`` ``stat_words`` — field for field what
    :func:`full_scan_plain` returns.  A CPU tensor runs the plain
    version; a CUDA tensor launches K2 on the current stream.
    """
    global launches
    if max_data % 4:
        raise ValueError('max_data must be a multiple of 4, got %d'
                         % (max_data,))
    if max_data < 0:
        raise ValueError('max_data must be >= 0')
    wire_scan._check(buf, lens, max_frames)
    dev = buf.device
    if dev.type == 'cpu':
        return full_scan_plain(buf, lens, max_frames, max_data)
    if dev.type != 'cuda':
        raise ValueError('K2 runs on CUDA or CPU tensors, not %s' % (dev,))
    if not (buf.is_contiguous() and lens.is_contiguous()):
        raise ValueError('K2 needs contiguous buf and lens')
    if buf.shape[1] > _MAX_ROW:
        raise ValueError('K2 takes rows of at most %d bytes' % _MAX_ROW)
    load()
    B, L = buf.shape
    DW = max_data // 4
    hdr = torch.empty((len(_HDR), B, max_frames), dtype=torch.int32,
                      device=dev)
    out = dict(zip(_HDR, hdr.unbind(0)))
    out['data_words'] = torch.empty((B, max_frames, DW), dtype=torch.int32,
                                    device=dev)
    out['stat_words'] = torch.empty((B, max_frames, STAT_WORDS),
                                    dtype=torch.int32, device=dev)
    out['counts'] = torch.empty((B,), dtype=torch.int32, device=dev)
    out['resid'] = torch.empty((B,), dtype=torch.int32, device=dev)
    out['bad'] = torch.empty((B,), dtype=torch.bool, device=dev)
    cfg = launch_config(B, L, max_frames)
    cfg = launch_config(B, L, max_frames, resident_blocks(
        dev, cfg['warps'], cfg['smem_bytes']))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _bound(
            buf.data_ptr(), lens.data_ptr(), B, L, max_frames, DW,
            cfg['warps'], cfg['stage_shift'], cfg['stages'],
            cfg['hdr_frames'], cfg['smem_bytes'], cfg['blocks'],
            hdr.data_ptr(), out['data_words'].data_ptr(),
            out['stat_words'].data_ptr(), out['counts'].data_ptr(),
            out['resid'].data_ptr(), out['bad'].data_ptr(), stream)
    if rc != 0:
        raise RuntimeError('K2 launch failed: cudaError %d' % (rc,))
    launches += 1
    return out


def bound_bytes(out: dict, max_data: int) -> int:
    """Bytes K2 must move for the call that gave ``out`` (its result or
    the plain version's): reads of 20 bytes per frame found, 4 per
    frame with a full reply header (the jute length), 4 per data word
    and 68 per Stat the masks let through, and 4 of ``lens`` per row;
    writes of ``4 * (7 + max_data/4 + 17)`` per frame slot plus 9 per
    row."""
    starts, sizes = out['starts'], out['sizes']
    B, F = starts.shape
    DW = max_data // 4
    found = starts >= 0
    hdr_ok = found & (sizes >= 16)
    nb = torch.where(hdr_ok, out['dlen_raw'], 0).clamp(0, MAX_PACKET + 1)
    words = ((nb.to(torch.int64) + 3) // 4).clamp(max=DW)
    stats = hdr_ok & (20 + nb + 68 <= sizes)
    reads = (20 * int(found.sum()) + 4 * int(hdr_ok.sum())
             + 4 * int(words.sum()) + 68 * int(stats.sum()) + 4 * B)
    writes = 4 * (7 + DW + STAT_WORDS) * B * F + 9 * B
    return reads + writes
