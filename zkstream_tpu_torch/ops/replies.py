"""Batched opcode-specific reply-body decode (plain torch).

The scalar codec parses each reply body with a per-opcode reader
(``records._RESP_READERS``; reference: lib/zk-buffer.js:281-370).  This
module is the tensor restatement, the port of
``zkstream_tpu.ops.replies``:

- ``EXISTS`` / ``SET_DATA``: a bare 68-byte Stat record
  (reference: lib/zk-buffer.js:428-442);
- ``GET_DATA``: buffer(data) then Stat (lib/zk-buffer.js:353-357);
- ``CREATE``: ustring path (lib/zk-buffer.js:333-335);
- ``NOTIFICATION``: type:int32, state:int32, path ustring
  (lib/zk-buffer.js:364-370);
- children and ACL lists (:func:`parse_list_bodies`,
  lib/zk-buffer.js:337-351,372-426).

Every layout is parsed speculatively at every frame and the consumer
picks the view matching each frame's opcode from its host-side
xid -> opcode map.  All reads are mask-clamped: invalid frames and
out-of-extent offsets yield zeros, and every gather offset is clamped to
``[0, L-1]``, so a byte past a row's length (or past ``L``) only ever
lands in a masked output.

64-bit Stat fields are (hi, lo) int32 pairs, as in :mod:`bytesops`.
Offsets stay int32, as in the reference, so both wrap the same way.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..protocol.consts import MAX_PACKET, REPLY_HDR
from .bytesops import be_i32_at, be_i64pair_at

#: Serialized Stat width: 6 longs + 5 ints
#: (reference: lib/zk-buffer.js:428-442).
STAT_WIRE = 68

#: (field name, byte offset within the Stat, is 64-bit) in wire order.
_STAT_FIELDS = (
    ('czxid', 0, True),
    ('mzxid', 8, True),
    ('ctime', 16, True),
    ('mtime', 24, True),
    ('version', 32, False),
    ('cversion', 36, False),
    ('aversion', 40, False),
    ('ephemeralOwner', 44, True),
    ('dataLength', 52, False),
    ('numChildren', 56, False),
    ('pzxid', 60, True),
)


class StatPlanes(NamedTuple):
    """A batched Stat: one int32 [B, F] plane per 32-bit field, (hi, lo)
    plane pairs per 64-bit field, plus the validity mask."""

    czxid_hi: torch.Tensor
    czxid_lo: torch.Tensor
    mzxid_hi: torch.Tensor
    mzxid_lo: torch.Tensor
    ctime_hi: torch.Tensor
    ctime_lo: torch.Tensor
    mtime_hi: torch.Tensor
    mtime_lo: torch.Tensor
    version: torch.Tensor
    cversion: torch.Tensor
    aversion: torch.Tensor
    ephemeralOwner_hi: torch.Tensor
    ephemeralOwner_lo: torch.Tensor
    dataLength: torch.Tensor
    numChildren: torch.Tensor
    pzxid_hi: torch.Tensor
    pzxid_lo: torch.Tensor
    valid: torch.Tensor


def _zero_where_not(valid, x):
    return torch.where(valid, x, 0)


def parse_stats(buf, off, valid) -> StatPlanes:
    """Parse a Stat record at absolute byte offset ``off`` of each
    stream.

    Args:
      buf: uint8 [B, L] stream bytes.
      off: int32 [B, F] absolute offset of each frame's Stat.
      valid: bool [B, F] which (stream, frame) slots hold a Stat whose
        extent really lies within the frame; fields are 0 elsewhere.
    """
    off = _zero_where_not(valid, off)
    out = {}
    for name, rel, is_long in _STAT_FIELDS:
        if is_long:
            hi, lo = be_i64pair_at(buf, off + rel)
            out[name + '_hi'] = _zero_where_not(valid, hi)
            out[name + '_lo'] = _zero_where_not(valid, lo)
        else:
            out[name] = _zero_where_not(valid, be_i32_at(buf, off + rel))
    return StatPlanes(valid=valid, **out)


def slice_var_bytes(buf, off, lens, max_len: int):
    """Gather a variable-width byte field (buffer payload or ustring
    text) from each frame into a dense [B, F, max_len] tensor.

    Args:
      buf: uint8 [B, L] stream bytes.
      off: int32 [B, F] absolute start of the field's bytes.
      lens: int32 [B, F] field byte counts (callers pass the already
        clamped-to->=0 jute length).
      max_len: static output width; longer fields truncate (visible to
        callers via ``lens``).

    Returns:
      (data, mask): uint8 [B, F, max_len] zero-padded and its validity
      mask.
    """
    B, L = buf.shape
    F = off.shape[1]
    pos = torch.arange(max_len, dtype=torch.int32, device=buf.device)
    idx = off[..., None] + pos
    mask = (pos < lens[..., None]) & (idx < L) & (off[..., None] >= 0)
    # torch.gather does not broadcast: flatten the [F, max_len] offsets
    # of a row into one index row of the [B, L] buffer
    flat = torch.where(mask, idx, 0).to(torch.int64).reshape(B, -1)
    data = torch.gather(buf, 1, flat).reshape(B, F, max_len)
    return torch.where(mask, data, 0).to(torch.uint8), mask


def _ustring_at(buf, off, valid, frame_end, max_len: int):
    """Parse a jute buffer/ustring (int32 length + bytes) at ``off``.
    Negative length decodes as empty (reference:
    lib/jute-buffer.js:99-100).  Returns (raw_len, bytes, mask, ok)
    where ``ok`` means the field's extent fits inside the frame."""
    off = _zero_where_not(valid, off)
    raw = _zero_where_not(valid, be_i32_at(buf, off))
    # Clamp BEFORE the extent arithmetic: a wire-controlled length near
    # INT32_MAX would wrap ``off + 4 + n`` negative and make a field
    # that overruns the frame look valid.  No legal field can exceed
    # MAX_PACKET, so the clamp never changes a legal decode.
    n = raw.clamp(0, MAX_PACKET + 1)
    ok = valid & (off + 4 + n <= frame_end)
    n = _zero_where_not(ok, n)
    data, mask = slice_var_bytes(buf, off + 4, n, max_len)
    return _zero_where_not(ok, raw), data, mask, ok


class ReplyBodies(NamedTuple):
    """Speculative parse of every fixed-layout reply body at every
    frame.  Select the view matching each frame's opcode:

    - EXISTS / SET_DATA -> ``stat0``
    - GET_DATA          -> ``data_len``/``data``/``data_mask`` +
      ``stat_after_data`` (its ``valid`` also proves the buffer field
      fit the frame)
    - CREATE            -> ``str0_len``/``str0``/``str0_mask``
    - NOTIFICATION      -> ``ntype``/``nstate`` +
      ``npath_len``/``npath``/``npath_mask``
    """

    stat0: StatPlanes
    data_len: torch.Tensor
    data: torch.Tensor
    data_mask: torch.Tensor
    data_ok: torch.Tensor      # buffer field extent fit the frame
    stat_after_data: StatPlanes
    str0_len: torch.Tensor
    str0: torch.Tensor
    str0_mask: torch.Tensor
    str0_ok: torch.Tensor      # ustring extent fit the frame
    ntype: torch.Tensor
    nstate: torch.Tensor
    npath_len: torch.Tensor
    npath: torch.Tensor
    npath_mask: torch.Tensor
    npath_ok: torch.Tensor     # notification path extent fit the frame


def _frame_extent(starts, sizes):
    """(frame_ok, payload start, frame end) of every frame slot."""
    frame_ok = (starts >= 0) & (sizes >= REPLY_HDR)
    start = _zero_where_not(frame_ok, starts)
    end = start + _zero_where_not(frame_ok, sizes)
    return frame_ok, start + REPLY_HDR, end


def _getdata_planes(buf, frame_ok, p, end, max_data: int):
    """The GET_DATA layout at payload start ``p``: buffer, then Stat.
    Returns (data_len, data, data_mask, data_ok, stat_after_data), the
    field order of ``ops.pipeline.GetDataBodies``."""
    data_len, data, data_mask, data_ok = _ustring_at(
        buf, p, frame_ok, end, max_data)
    stat_off = p + 4 + data_len.clamp(min=0)
    stat = parse_stats(buf, stat_off,
                       data_ok & (stat_off + STAT_WIRE <= end))
    return data_len, data, data_mask, data_ok, stat


def parse_reply_bodies(buf, starts, sizes, max_data: int = 128,
                       max_path: int = 128,
                       getdata=None) -> ReplyBodies:
    """Parse all fixed-layout reply-body interpretations of every frame.

    Args:
      buf: uint8 [B, L] stream bytes.
      starts: int32 [B, F] frame body offsets (-1 = no frame); the
        reply header sits at the body start, opcode payloads begin 16
        bytes in.
      sizes: int32 [B, F] frame body lengths.
      max_data: static width for the GET_DATA payload bytes.
      max_path: static width for CREATE/NOTIFICATION path bytes.
      getdata: an ``ops.pipeline.GetDataBodies`` already computed for
        these frames at ``max_data`` (kernel K2's unpacked planes); its
        GET_DATA view is taken as is, not parsed a second time.
    """
    frame_ok, p, end = _frame_extent(starts, sizes)

    # EXISTS / SET_DATA: Stat at payload start.
    stat0 = parse_stats(buf, p, frame_ok & (p + STAT_WIRE <= end))

    # GET_DATA: buffer then Stat.
    if getdata is None:
        getdata = _getdata_planes(buf, frame_ok, p, end, max_data)
    data_len, data, data_mask, data_ok, stat_after_data = getdata

    # CREATE: ustring at payload start — the buffer layout again, so
    # when the plane widths match it IS the GET_DATA view: reuse it.
    if max_path == max_data:
        str0_len, str0, str0_mask, str0_ok = (data_len, data,
                                              data_mask, data_ok)
    else:
        str0_len, str0, str0_mask, str0_ok = _ustring_at(
            buf, p, frame_ok, end, max_path)

    # NOTIFICATION: type:int32, state:int32, path ustring
    # (reference: lib/zk-buffer.js:364-370).
    n_ok = frame_ok & (p + 8 <= end)
    np_ = _zero_where_not(n_ok, p)
    ntype = _zero_where_not(n_ok, be_i32_at(buf, np_))
    nstate = _zero_where_not(n_ok, be_i32_at(buf, np_ + 4))
    npath_len, npath, npath_mask, npath_ok = _ustring_at(
        buf, p + 8, n_ok, end, max_path)

    return ReplyBodies(
        stat0=stat0,
        data_len=data_len, data=data, data_mask=data_mask,
        data_ok=data_ok,
        stat_after_data=stat_after_data,
        str0_len=str0_len, str0=str0, str0_mask=str0_mask,
        str0_ok=str0_ok,
        ntype=ntype, nstate=nstate,
        npath_len=npath_len, npath=npath, npath_mask=npath_mask,
        npath_ok=npath_ok,
    )


class ListBodies(NamedTuple):
    """Speculative parse of the list-shaped reply bodies at every
    frame — children lists (GET_CHILDREN / GET_CHILDREN2) and ACL lists
    (GET_ACL) — bounded by static (max_children, max_name) /
    (max_acls, max_scheme, max_id).

    ``ch_ok`` / ``acl_ok`` mean the whole list fits the bounds AND lies
    within the frame; a False slot must take the scalar fallback.
    Element length planes hold the **decoded** byte count — clamped to
    >= 0, because a negative jute length decodes as an empty string
    (lib/jute-buffer.js:99-100) — so wherever the ok mask is set, every
    length lies in [0, max_*]."""

    ch_count: torch.Tensor        # int32 [B, F]
    ch_len: torch.Tensor          # int32 [B, F, K] decoded lengths >= 0
    ch_bytes: torch.Tensor        # uint8 [B, F, K, S]
    ch_ok: torch.Tensor           # bool [B, F]
    stat_after_children: StatPlanes   # GET_CHILDREN2 trailing Stat
    acl_count: torch.Tensor       # int32 [B, F]
    acl_perms: torch.Tensor       # int32 [B, F, A]
    acl_scheme_len: torch.Tensor  # int32 [B, F, A]
    acl_scheme: torch.Tensor      # uint8 [B, F, A, SS]
    acl_id_len: torch.Tensor      # int32 [B, F, A]
    acl_id: torch.Tensor          # uint8 [B, F, A, SI]
    acl_ok: torch.Tensor          # bool [B, F]
    stat_after_acl: StatPlanes    # GET_ACL trailing Stat


def _scan_ustring(buf, cur, active, frame_end, max_len: int):
    """One jute-string step of a sequential list walk: parse the
    (int32 len, bytes) at ``cur`` where ``active``; an element is ok
    when its extent fits the frame AND its length fits ``max_len``
    (list elements never truncate: the whole frame falls back instead).
    Returns (len, bytes, ok, next_cur) where ``len`` is the DECODED
    byte count — a negative jute length decodes as empty, so the plane
    reports 0, not the raw wire value."""
    at = _zero_where_not(active, cur)
    raw = _zero_where_not(active, be_i32_at(buf, at))
    n = raw.clamp(min=0)
    ok = active & (cur + 4 + n <= frame_end) & (n <= max_len)
    data, _mask = slice_var_bytes(buf, cur + 4, _zero_where_not(ok, n),
                                  max_len)
    return (_zero_where_not(ok, n), data, ok,
            torch.where(ok, cur + 4 + n, cur))


def parse_list_bodies(buf, starts, sizes,
                      max_children: int = 16, max_name: int = 64,
                      max_acls: int = 4, max_scheme: int = 16,
                      max_id: int = 64) -> ListBodies:
    """Parse the children-list and ACL-list interpretations of every
    frame.

    A list is a *sequential* layout — element k's offset depends on
    every earlier length — so the walk is a Python loop over the static
    ``max_children`` / ``max_acls`` steps of masked gathers.
    """
    frame_ok, p, end = _frame_extent(starts, sizes)

    have = frame_ok & (p + 4 <= end)
    count = _zero_where_not(have, be_i32_at(buf, _zero_where_not(have, p)))

    # -- children: count, then count x ustring --
    cur, ok = p + 4, have & (count >= 0) & (count <= max_children)
    ch_len, ch_bytes = [], []
    for k in range(max_children):
        active = ok & (k < count)
        raw, data, elem_ok, cur = _scan_ustring(
            buf, cur, active, end, max_name)
        ok = ok & (~active | elem_ok)
        ch_len.append(raw)
        ch_bytes.append(data)
    stat_after_children = parse_stats(
        buf, cur, ok & (cur + STAT_WIRE <= end))

    # -- ACL: count, then count x (perms:int32, scheme, id) --
    acur, aok = p + 4, have & (count >= 0) & (count <= max_acls)
    perms, slens, sbts, ilens, ibts = [], [], [], [], []
    for k in range(max_acls):
        active = aok & (k < count)
        at = _zero_where_not(active, acur)
        pm_ok = active & (acur + 4 <= end)
        perms.append(_zero_where_not(pm_ok, be_i32_at(buf, at)))
        acur = torch.where(pm_ok, acur + 4, acur)
        sraw, sdata, s_ok, acur = _scan_ustring(
            buf, acur, pm_ok, end, max_scheme)
        iraw, idata, i_ok, acur = _scan_ustring(
            buf, acur, s_ok, end, max_id)
        aok = aok & (~active | (pm_ok & s_ok & i_ok))
        slens.append(sraw)
        sbts.append(sdata)
        ilens.append(iraw)
        ibts.append(idata)
    stat_after_acl = parse_stats(
        buf, acur, aok & (acur + STAT_WIRE <= end))

    B, F = starts.shape

    def stack(planes, *tail):
        # [B, F, ...] x steps -> [B, F, steps, ...]; an empty walk
        # (a zero bound) still has the static shape
        if planes:
            return torch.stack(planes, dim=2)
        dtype = torch.uint8 if tail else torch.int32
        return torch.zeros((B, F, 0) + tail, dtype=dtype,
                           device=buf.device)

    return ListBodies(
        ch_count=_zero_where_not(ok, count),
        ch_len=stack(ch_len), ch_bytes=stack(ch_bytes, max_name),
        ch_ok=ok,
        stat_after_children=stat_after_children,
        acl_count=_zero_where_not(aok, count),
        acl_perms=stack(perms),
        acl_scheme_len=stack(slens),
        acl_scheme=stack(sbts, max_scheme),
        acl_id_len=stack(ilens),
        acl_id=stack(ibts, max_id),
        acl_ok=aok,
        stat_after_acl=stat_after_acl,
    )


# -- host-side views (numpy in, records out) --

def stat_from_planes(planes, b: int, f: int):
    """Collapse one (stream, frame) slot of a :class:`StatPlanes` (as
    host numpy arrays) into the scalar codec's ``Stat`` record."""
    from ..protocol.records import Stat
    from .bytesops import i64pair_to_int

    def i64(name):
        return i64pair_to_int(getattr(planes, name + '_hi')[b, f],
                              getattr(planes, name + '_lo')[b, f])

    def i32(name):
        return int(getattr(planes, name)[b, f])

    return Stat(
        czxid=i64('czxid'), mzxid=i64('mzxid'),
        ctime=i64('ctime'), mtime=i64('mtime'),
        version=i32('version'), cversion=i32('cversion'),
        aversion=i32('aversion'),
        ephemeralOwner=i64('ephemeralOwner'),
        dataLength=i32('dataLength'), numChildren=i32('numChildren'),
        pzxid=i64('pzxid'))
