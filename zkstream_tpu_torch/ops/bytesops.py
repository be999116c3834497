"""Gather-based big-endian field extraction over uint8 tensors.

The Jute wire format is big-endian throughout (reference:
lib/jute-buffer.js:102-125).  These helpers read int32 / int64 fields at
arbitrary (batched) byte offsets out of uint8 buffers using four/eight
one-byte gathers plus shift-or assembly.

64-bit fields (zxid, sessionId, timestamps) are ``(hi, lo)`` int32
pairs, as in ``zkstream_tpu.ops.bytesops``; unsigned comparison is
built from the sign-flip trick (torch has no unsigned 64-bit max).
All offset gathers are clamped to ``[0, L-1]`` so speculative lanes
(masked-off frames) stay in bounds.
"""

from __future__ import annotations

import numpy as np
import torch

# 0x80000000 as an int32 bit pattern
_SIGN = -0x80000000


def _byte_at(buf, off):
    """Gather one byte per offset -> int32.

    ``buf`` is uint8 [..., L]; ``off`` either matches buf's rank (K
    offsets per row, result [..., K]) or has one fewer dim (one offset
    per row, result [...]).  ``torch.gather`` takes int64 indices.
    """
    off = off.to(torch.int64).clamp(0, buf.shape[-1] - 1)
    squeeze = off.dim() == buf.dim() - 1
    if squeeze:
        off = off.unsqueeze(-1)
    out = torch.gather(buf, -1, off).to(torch.int32)
    return out.squeeze(-1) if squeeze else out


def be_i32_at(buf, off):
    """Read a big-endian int32 at byte offset ``off``.

    The top byte is sign-extended before its shift, so the assembly
    never overflows int32 and yields the two's-complement value.
    """
    b0 = _byte_at(buf, off)
    b1 = _byte_at(buf, off + 1)
    b2 = _byte_at(buf, off + 2)
    b3 = _byte_at(buf, off + 3)
    return (((b0 ^ 0x80) - 0x80) << 24) | (b1 << 16) | (b2 << 8) | b3


def be_i64pair_at(buf, off):
    """Read a big-endian int64 at ``off`` as an ``(hi, lo)`` int32 pair."""
    return be_i32_at(buf, off), be_i32_at(buf, off + 4)


def _as_unsigned_key(x):
    """Map int32 -> int32 so that signed compare == unsigned compare."""
    return x ^ _SIGN


def u64pair_lt(ah, al, bh, bl):
    """Unsigned 64-bit ``a < b`` on (hi, lo) pairs."""
    ah_u, bh_u = _as_unsigned_key(ah), _as_unsigned_key(bh)
    al_u, bl_u = _as_unsigned_key(al), _as_unsigned_key(bl)
    return (ah_u < bh_u) | ((ah == bh) & (al_u < bl_u))


def u64pair_max(ah, al, bh, bl):
    """Elementwise unsigned 64-bit max on (hi, lo) pairs."""
    a_lt_b = u64pair_lt(ah, al, bh, bl)
    return torch.where(a_lt_b, bh, ah), torch.where(a_lt_b, bl, al)


def u64pair_reduce_max(h, l, axis=None):
    """Unsigned 64-bit max-reduce of (hi, lo) int32 pairs along
    ``axis`` (None = all): unsigned max of hi, then unsigned max of lo
    among the elements achieving it."""
    uh = h ^ _SIGN
    if axis is None:
        mh_u = torch.amax(uh)
        lo_key = torch.where(uh == mh_u, l ^ _SIGN, _SIGN)
        ml_u = torch.amax(lo_key)
    else:
        mh_u = torch.amax(uh, dim=axis, keepdim=True)
        lo_key = torch.where(uh == mh_u, l ^ _SIGN, _SIGN)
        ml_u = torch.amax(lo_key, dim=axis)
        mh_u = mh_u.squeeze(axis)
    return mh_u ^ _SIGN, ml_u ^ _SIGN


def u64pair_to_int(h, l) -> int:
    """Host-side: collapse a (hi, lo) pair (or arrays thereof) to Python
    int / numpy uint64 for interop with the scalar codec."""
    h = (np.asarray(h).astype(np.int64) & 0xFFFFFFFF).astype(np.uint64)
    l = (np.asarray(l).astype(np.int64) & 0xFFFFFFFF).astype(np.uint64)
    out = (h << np.uint64(32)) | l
    return int(out) if out.ndim == 0 else out


def i64pair_to_int(h, l) -> int:
    """Host-side: collapse a (hi, lo) pair to the SIGNED int64 the wire
    carries — the scalar codec's ``read_long`` is ``>q``."""
    out = np.asarray(u64pair_to_int(h, l), dtype=np.uint64)
    signed = out.view(np.int64)
    return int(signed) if signed.ndim == 0 else signed
