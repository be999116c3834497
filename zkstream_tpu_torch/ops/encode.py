"""Batched wire ENCODE: field planes -> framed reply streams (plain torch).

The decode pipeline (ops/pipeline.py) turns [B, L] byte streams into
header field planes; this is its inverse — given per-frame fields, emit
length-prefixed ZooKeeper reply frames for a whole fleet of streams.
It restates the scalar encoder's header pack (reference:
lib/zk-buffer.js:186-231 writes len/xid/zxid/err the same way for the
``isServer`` codec mode, lib/zk-streams.js:121-148) as a scatter of byte
planes at cumulative frame offsets.  The port of
``zkstream_tpu.ops.encode``; it stays plain torch ops on either device.

Use cases: fake-server fleets for testing, and the dp-sharded
encode->decode loop (parallel/sharded.py ``sharded_wire_roundtrip``).
"""

from __future__ import annotations

import torch

#: Reply header bytes: len prefix (4) + xid (4) + zxid (8) + err (4).
_HDR = 20


def _be_bytes(word):
    """int32 [..., 1] -> four big-endian byte planes [..., 4] (uint8)."""
    shifts = torch.arange(24, -1, -8, dtype=torch.int32, device=word.device)
    return ((word >> shifts) & 0xFF).to(torch.uint8)


def build_reply_streams(xid, zxid_hi, zxid_lo, err, body_sizes,
                        out_len: int):
    """Encode a fleet of reply streams.

    Args:
      xid, zxid_hi, zxid_lo, err: int32 [B, F] per-frame header fields.
      body_sizes: int32 [B, F] reply body length per frame INCLUDING
        the 16-byte header (the value that goes in the length prefix);
        < 16 marks the frame absent (not emitted).  Body bytes beyond
        the header are zero-filled.
      out_len: output width L; frames past it are dropped.

    Returns:
      (buf, lens): uint8 [B, out_len] streams and int32 [B] byte counts
      — the inputs of :func:`..pipeline.wire_pipeline_step`.  Absent
      frames are compacted away: a later decode yields the emitted
      frames left-packed in order.
    """
    valid = body_sizes >= 16
    sizes = torch.where(valid, body_sizes, 0)
    frame_sizes = torch.where(valid, sizes + 4, 0)
    ends = torch.cumsum(frame_sizes, dim=1, dtype=torch.int32)
    starts = ends - frame_sizes
    fits = valid & (ends <= out_len)
    lens = torch.amax(torch.where(fits, ends, 0), dim=1).to(torch.int32)

    # [B, F, 20] header byte values...
    hdr = torch.cat([_be_bytes(sizes[..., None]), _be_bytes(xid[..., None]),
                     _be_bytes(zxid_hi[..., None]),
                     _be_bytes(zxid_lo[..., None]),
                     _be_bytes(err[..., None])], dim=-1)
    # ...scattered at each frame's cumulative offset into the flat
    # [B * out_len] batch; a dropped frame's bytes are parked in one
    # spare byte past its end, cut off below, so the batch the decode
    # (kernel K1) reads stays contiguous
    B = xid.shape[0]
    cols = starts[..., None].to(torch.int64) + torch.arange(
        _HDR, dtype=torch.int64, device=xid.device)
    rows = torch.arange(B, dtype=torch.int64, device=xid.device)
    flat = torch.where(fits[..., None], rows[:, None, None] * out_len + cols,
                       B * out_len)
    buf = torch.zeros((B * out_len + 1,), dtype=torch.uint8,
                      device=xid.device)
    buf.index_put_((flat,), hdr)
    return buf[:-1].view(B, out_len), lens
