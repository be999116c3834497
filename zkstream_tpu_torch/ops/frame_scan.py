"""Frame-boundary discovery over a batch of streams (plain torch).

The reference finds frame boundaries with a sequential accumulator loop
— read 4-byte length, slice, repeat (lib/zk-streams.js:39-64), guarding
length < 0 or > 16 MiB (lib/zk-streams.js:23,47-53).

``frame_cursor_scan`` decodes a batch of independent streams in
lockstep: one step advances every stream's cursor by its current frame
length, so the loop length is max-frames-per-stream while the work per
step is vectorised across the batch.  This is the plain version of
kernel K1 (``ops/wire_scan.py``), which does the same walk with one
CUDA thread per stream.
"""

from __future__ import annotations

import torch

from ..protocol.consts import MAX_PACKET
from .bytesops import be_i32_at


def frame_cursor_scan(buf, lens, max_frames: int):
    """Lockstep frame scan over a batch of streams.

    Args:
      buf: uint8 [B, L] — each row is one connection's accumulated bytes.
      lens: int32 [B] — valid byte count per row.
      max_frames: bound on frames per stream (loop length).

    Returns:
      starts: int32 [B, max_frames] — body start offset per frame, -1
        where no frame.
      sizes: int32 [B, max_frames] — body length per frame, 0 where none.
      counts: int32 [B] — complete frames found per stream.
      bad: bool [B] — a negative/oversized length prefix was seen
        (the BAD_LENGTH protocol error, lib/zk-streams.js:47-53).
      resid: int32 [B] — cursor after the last complete frame.
    """
    B = buf.shape[0]
    lens = lens.to(torch.int32)
    cur = torch.zeros_like(lens)
    bad = lens < 0
    starts, sizes = [], []
    for _ in range(max_frames):
        has_prefix = cur + 4 <= lens
        ln = torch.where(has_prefix, be_i32_at(buf, cur), 0)
        is_bad = has_prefix & ((ln < 0) | (ln > MAX_PACKET))
        # a bad ln may wrap cur + 4 + ln; ~is_bad masks that lane
        complete = has_prefix & ~is_bad & ~bad & (cur + 4 + ln <= lens)
        starts.append(torch.where(complete, cur + 4, -1))
        sizes.append(torch.where(complete, ln, 0))
        cur = torch.where(complete, cur + 4 + ln, cur)
        bad = bad | is_bad
    if max_frames:
        starts = torch.stack(starts, dim=1)
        sizes = torch.stack(sizes, dim=1)
    else:
        starts = torch.zeros((B, 0), dtype=torch.int32, device=buf.device)
        sizes = torch.zeros_like(starts)
    counts = (starts >= 0).sum(dim=1, dtype=torch.int32)
    return starts, sizes, counts, bad, cur
