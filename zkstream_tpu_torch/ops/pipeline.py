"""The receive tick decode: batched wire decode for a stream fleet.

One call = one "network tick" for B connections: slice every complete
frame out of every stream, parse every reply header, and reduce the
per-stream routing counts and session checkpoints — the vectorised
equivalent of running the reference's decode loop
(lib/zk-streams.js:39-99) and connected-state drain
(lib/connection-fsm.js:213-229) once per connection.

Two implementations share :func:`_assemble`, so the routing/stats
semantics cannot diverge: ``wire_pipeline_step`` (plain torch) and
``wire_pipeline_step_kernel`` (the scan + header parse in kernel K1,
ops/wire_scan.py).  ``wire_pipeline_step_auto`` takes K1 for every
CUDA tensor and the plain version for a CPU tensor.

``wire_full_decode`` is the same step with the GET_DATA bodies fused
in (kernel K2, ops/full_scan.py, on a CUDA tensor) and returns them as
``GetDataBodies``; ``getdata_bodies`` is its reference semantics.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .frame_scan import frame_cursor_scan
from .headers import parse_reply_headers, stream_stats
from .wire_scan import wire_scan


class WireStats(NamedTuple):
    """Per-stream results of one pipeline step (all shaped [B] unless
    noted)."""

    starts: torch.Tensor        # int32 [B, F] frame body offsets, -1 pad
    sizes: torch.Tensor         # int32 [B, F] frame body lengths
    xids: torch.Tensor          # int32 [B, F] reply xids (0 where pad)
    errs: torch.Tensor          # int32 [B, F] reply error codes
    zxid_hi: torch.Tensor       # int32 [B, F] per-reply zxid, high word
    zxid_lo: torch.Tensor       # int32 [B, F] per-reply zxid, low word
    n_frames: torch.Tensor      # int32 [B]
    n_replies: torch.Tensor     # int32 [B]
    n_notifications: torch.Tensor  # int32 [B]
    n_pings: torch.Tensor       # int32 [B]
    n_errors: torch.Tensor      # int32 [B]
    max_zxid_hi: torch.Tensor   # int32 [B] session checkpoint, high word
    max_zxid_lo: torch.Tensor   # int32 [B] session checkpoint, low word
    bad: torch.Tensor           # bool [B] BAD_LENGTH or short-frame seen
    resid: torch.Tensor         # int32 [B] partial-frame cursor


def _assemble(headers, starts, sizes, counts, bad, resid) -> WireStats:
    """Shared tail of both variants: routing reductions over parsed
    headers + WireStats assembly.  A frame too short to hold the
    16-byte reply header is a protocol violation (scalar codec:
    BAD_DECODE) — flagged via ``bad``, never misparsed."""
    stats = stream_stats(headers)
    return WireStats(
        starts=starts,
        sizes=sizes,
        xids=headers['xid'],
        errs=headers['err'],
        zxid_hi=headers['zxid_hi'],
        zxid_lo=headers['zxid_lo'],
        n_frames=counts,
        n_replies=stats['n_replies'],
        n_notifications=stats['n_notifications'],
        n_pings=stats['n_pings'],
        n_errors=stats['n_errors'],
        max_zxid_hi=stats['max_zxid_hi'],
        max_zxid_lo=stats['max_zxid_lo'],
        bad=bad | torch.any(headers['short'], dim=1),
        resid=resid,
    )


def _stats_from_scan(r) -> WireStats:
    """WireStats from a K1 scan-result dict."""
    valid = r['starts'] >= 0
    short = valid & (r['sizes'] < 16)
    headers = {
        'valid': valid & ~short,
        'short': short,
        'xid': r['xid'],
        'zxid_hi': r['zxid_hi'],
        'zxid_lo': r['zxid_lo'],
        'err': r['err'],
    }
    return _assemble(headers, r['starts'], r['sizes'], r['counts'],
                     r['bad'], r['resid'])


def wire_pipeline_step(buf, lens, max_frames: int = 32) -> WireStats:
    """Decode one tick of B streams with plain torch ops.

    Args:
      buf: uint8 [B, L] accumulated bytes per connection.
      lens: int32 [B] valid byte counts.
      max_frames: per-stream frame bound for this tick.
    """
    starts, sizes, counts, bad, resid = frame_cursor_scan(
        buf, lens, max_frames)
    headers = parse_reply_headers(buf, starts, sizes)
    return _assemble(headers, starts, sizes, counts, bad, resid)


def wire_pipeline_step_kernel(buf, lens, max_frames: int = 32) -> WireStats:
    """Same step with the scan + header parse in kernel K1; only the
    [B, F] -> [B] routing reductions stay torch ops."""
    return _stats_from_scan(wire_scan(buf, lens, max_frames))


def wire_pipeline_step_auto(buf, lens, max_frames: int = 32) -> WireStats:
    """K1 for every CUDA tensor, the plain version for a CPU tensor."""
    if buf.device.type == 'cuda':
        return wire_pipeline_step_kernel(buf, lens, max_frames=max_frames)
    return wire_pipeline_step(buf, lens, max_frames=max_frames)


class GetDataBodies(NamedTuple):
    """The GET_DATA slice of :class:`.replies.ReplyBodies` —
    field for field the planes ``parse_reply_bodies`` emits for that
    layout."""

    data_len: torch.Tensor     # int32 [B, F] raw jute length (0/-1 ok)
    data: torch.Tensor         # uint8 [B, F, max_data] zero-padded
    data_mask: torch.Tensor    # bool [B, F, max_data]
    data_ok: torch.Tensor      # bool [B, F] field extent fit the frame
    stat_after_data: 'object'  # replies.StatPlanes


def getdata_bodies(buf, st: WireStats, max_data: int) -> GetDataBodies:
    """The GET_DATA planes via the plain body parser — the reference
    semantics :func:`wire_full_decode` must match."""
    from . import replies as R

    frame_ok, p, end = R._frame_extent(st.starts, st.sizes)
    return GetDataBodies(*R._getdata_planes(buf, frame_ok, p, end,
                                            max_data))


def wire_full_decode(buf, lens, max_frames: int = 32,
                     max_data: int = 16):
    """The tick decode plus the GET_DATA bodies: kernel K2 (or its
    plain version, for a CPU tensor) and the elementwise unpack of its
    words.  Returns ``(WireStats, GetDataBodies)``, equal to
    :func:`wire_pipeline_step` + :func:`getdata_bodies`."""
    from ..protocol.consts import MAX_PACKET
    from .full_scan import full_scan
    from .replies import _STAT_FIELDS, StatPlanes

    r = full_scan(buf, lens, max_frames, max_data)
    st = _stats_from_scan(r)

    frame_ok = (r['starts'] >= 0) & (r['sizes'] >= 16)
    draw = r['dlen_raw']
    # the kernel's clamp, before any extent arithmetic
    nb = draw.clamp(0, MAX_PACKET + 1)
    # the _ustring_at extent rule: p+4+n <= end, with p = start+16
    data_ok = frame_ok & (20 + nb <= r['sizes'])
    data_len = torch.where(data_ok, draw, 0)
    n_ok = torch.where(data_ok, nb, 0)
    # BE words -> bytes, masked to the field extent and, as
    # slice_var_bytes masks them, to bytes inside the row.  The shifts
    # 24, 16, 8, 0 are made on the device: a host list copied in would
    # be a pageable copy, which a CUDA graph capture refuses
    shifts = 24 - 8 * torch.arange(4, dtype=torch.int32, device=buf.device)
    B, F = draw.shape
    byts = ((r['data_words'][..., None] >> shifts) & 0xFF).reshape(
        B, F, max_data)
    pos = torch.arange(max_data, dtype=torch.int32, device=buf.device)
    first = torch.where(data_ok, r['starts'] + 20, 0)
    data_mask = (pos < n_ok[..., None]) & (first[..., None] + pos
                                           < buf.shape[1])
    data = torch.where(data_mask, byts, 0).to(torch.uint8)

    stat_ok = frame_ok & (20 + nb + 68 <= r['sizes'])
    sw = r['stat_words']
    # one source of truth for the Stat layout: the kernel writes word
    # rel//4 (+1 for the low half of 64-bit fields)
    vals = {}
    for name, rel, is_long in _STAT_FIELDS:
        k = rel // 4
        if is_long:
            vals[name + '_hi'] = sw[:, :, k]
            vals[name + '_lo'] = sw[:, :, k + 1]
        else:
            vals[name] = sw[:, :, k]
    stat = StatPlanes(valid=stat_ok, **vals)
    return st, GetDataBodies(data_len=data_len, data=data,
                             data_mask=data_mask, data_ok=data_ok,
                             stat_after_data=stat)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``'cuda'`` (the default of
    every entry point) raises when no card is present: nothing carries
    on silently on the CPU."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'CUDA device requested but torch.cuda.is_available() is '
            "False; pass device='cpu' to run the plain version")
    if dev.type not in ('cuda', 'cpu'):
        raise ValueError('unsupported device %s' % (dev,))
    return dev


def batch_to_device(buf_np, lens_np, device='cuda'):
    """Copy a numpy ``uint8 [B, L]`` batch and ``int32 [B]`` lengths
    onto ``device`` (through pinned host memory for a CUDA device)."""
    dev = resolve_device(device)
    buf = torch.from_numpy(np.ascontiguousarray(buf_np, dtype=np.uint8))
    lens = torch.from_numpy(np.ascontiguousarray(lens_np, dtype=np.int32))
    if dev.type == 'cpu':
        return buf.clone(), lens.clone()
    buf, lens = buf.pin_memory(), lens.pin_memory()
    return (buf.to(dev, non_blocking=True),
            lens.to(dev, non_blocking=True))


def wirestats_to_numpy(st: WireStats) -> dict:
    """Host numpy copy of every WireStats field."""
    return {f: getattr(st, f).cpu().numpy() for f in st._fields}
