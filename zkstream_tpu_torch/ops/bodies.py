"""Batched frame-body extraction: the last step of a full decode.

After :mod:`frame_scan` locates frames and :mod:`headers` parses the
16-byte reply headers, consumers that want the opcode-specific payload
need the body bytes themselves (what the scalar codec hands to
``records.read_response``, reference: lib/zk-streams.js:74-79).  This
op slices every frame's body out of the stream batch into a dense
padded tensor in one gather.  The port of ``zkstream_tpu.ops.bodies``.
"""

from __future__ import annotations

import torch


def slice_frame_bodies(buf, starts, sizes, max_body: int,
                       skip_header: bool = False):
    """Gather frame bodies into a padded [B, F, max_body] tensor.

    Args:
      buf: uint8 [B, L] stream bytes.
      starts: int32 [B, F] body start offsets (-1 = no frame), as
        produced by the scans / kernel K1.
      sizes: int32 [B, F] body byte counts.
      max_body: width of the output's trailing axis; longer bodies are
        truncated to it (truncation is visible via ``sizes``).
      skip_header: drop the leading 16-byte reply header, yielding just
        the opcode-specific payload (sizes still count the header).

    Returns:
      (bodies, mask): uint8 [B, F, max_body] zero-padded bytes and
      bool [B, F, max_body] validity mask.
    """
    B, L = buf.shape
    F = starts.shape[1]
    hdr = 16 if skip_header else 0
    valid = starts >= 0
    base = torch.where(valid, starts, 0) + hdr
    pos = torch.arange(max_body, dtype=torch.int32, device=buf.device)
    # [B, F, max_body] absolute byte positions; the mask kills reads
    # past each frame's real extent
    idx = base[..., None] + pos
    mask = valid[..., None] & (pos < (sizes[..., None] - hdr)) & (idx < L)
    # torch.gather wants an index no larger than its input on the other
    # dims, so gather on buf with the index flattened to [B, F*max_body];
    # every index the mask rejects gathers from position 0 and is zeroed
    gidx = torch.where(mask, idx, 0).to(torch.int64).reshape(B, F * max_body)
    bodies = torch.gather(buf, 1, gidx).reshape(B, F, max_body)
    return torch.where(mask, bodies, 0).to(torch.uint8), mask
