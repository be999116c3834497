"""Kernel K2: kernel K1's frame walk plus the GET_DATA body, one launch.

Replaces the TPU kernel ``zkstream_tpu/ops/pallas_scan.py::_full_kernel``
(launched by ``pallas_wire_full_scan``).  The CUDA C++ source is
``zkstream_tpu_torch/csrc/wire_scan.cu`` (``full_scan_kernel``), in the
same library as K1 and sharing K1's frame step: one warp per stream
row, the lanes splitting each frame's body words so the stores of the
``[B, F, DW]`` and ``[B, F, 17]`` planes are coalesced.

Per frame slot it writes K1's six planes plus the raw jute length at
body+16 (``dlen_raw``), the payload as big-endian words
(``data_words``, only the words the field reaches) and the trailing
68-byte Stat as 17 big-endian words (``stat_words``, only where it fits
the frame).  :func:`~zkstream_tpu_torch.ops.pipeline.wire_full_decode`
unpacks those into a ``GetDataBodies``.

What bounds it on an H100: memory — :func:`bound_bytes` counts the
bytes it must move for a given input.

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

#: Where the TPU kernel this module replaces lives.
REPLACES = 'zkstream_tpu/ops/pallas_scan.py:135'

#: Stat words per frame slot: 6 longs as (hi, lo) words + 5 ints.
STAT_WORDS = 17

#: Launches of the CUDA kernel since the last reset (the plain version
#: never counts).
launches = 0

#: K2's [B, F] planes, in the order of its [7, B, F] output: K1's, then
#: the raw jute length
_HDR = wire_scan._PLANES + ('dlen_raw',)
_bound = None


def load():
    """Build (if needed) the kernel library and bind K2's launcher;
    idempotent."""
    global _bound
    lib = wire_scan.load()
    if _bound is None:
        fn = lib.full_scan_launch
        fn.argtypes = ([ctypes.c_void_p] * 2
                       + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_int]
                       + [ctypes.c_void_p] * 7)
        fn.restype = ctypes.c_int
        _bound = fn
    return lib


def build_report() -> str:
    """The ``nvcc -Xptxas -v`` output of the loaded library."""
    return wire_scan.build_report()


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
    if buf.device.type == 'cpu':
        return full_scan_plain(buf, lens, max_frames, max_data)
    if buf.device.type != 'cuda':
        raise ValueError('K2 runs on CUDA or CPU tensors, not %s'
                         % (buf.device,))
    if not (buf.is_contiguous() and lens.is_contiguous()):
        raise ValueError('K2 needs contiguous buf and lens')
    load()
    B, L = buf.shape
    DW = max_data // 4
    dev = buf.device
    hdr = torch.empty((len(_HDR), B, max_frames), dtype=torch.int32,
                      device=dev)
    out = {name: hdr[k] for k, name in enumerate(_HDR)}
    out['data_words'] = torch.empty((B, max_frames, DW), dtype=torch.int32,
                                    device=dev)
    out['stat_words'] = torch.empty((B, max_frames, STAT_WORDS),
                                    dtype=torch.int32, device=dev)
    out['counts'] = torch.empty((B,), dtype=torch.int32, device=dev)
    out['resid'] = torch.empty((B,), dtype=torch.int32, device=dev)
    out['bad'] = torch.empty((B,), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _bound(
            buf.data_ptr(), lens.data_ptr(), B, L, max_frames, DW,
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
