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

``frame_starts_pointer_doubling`` finds every frame of a *single* long
stream in O(log L) parallel steps: every byte position speculatively
computes its successor "if a frame started here, the next would start
at i + 4 + len(i)", and frame starts are the positions reachable from 0
in that successor graph, found by pointer doubling.  Plain torch ops on
either device; ``parallel/seqscan.py``'s checks hold the sequence-
parallel scan against it.
"""

from __future__ import annotations

import math

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


def frame_starts_pointer_doubling(buf, n):
    """All frame starts of one stream in O(log L) parallel steps.

    Args:
      buf: uint8 [L] — a single stream's bytes.
      n: int scalar (or 0-d tensor) — valid byte count.

    Returns:
      is_start: bool [L] — True at each offset where a complete frame's
        4-byte length prefix begins.
      bad: bool 0-d — a reachable position had an invalid length prefix.

    The successor map saturates at sentinel L for incomplete/invalid
    positions (and ``f[L] = L``), so reachability never escapes the
    buffer; positions past a bad prefix are unreachable, matching the
    sequential decoder's stop-at-error behaviour.
    """
    L = buf.shape[0]
    idx = torch.arange(L, dtype=torch.int32, device=buf.device)
    ln = be_i32_at(buf[None, :], idx[None, :])[0]
    has_prefix = idx + 4 <= n
    ln = torch.where(has_prefix, ln, 0)
    invalid = has_prefix & ((ln < 0) | (ln > MAX_PACKET))
    complete = has_prefix & ~invalid & (idx + 4 + ln <= n)
    succ = torch.where(complete, idx + 4 + ln, L).to(torch.int32)

    # Reachability from position 0 by pointer doubling: after k rounds
    # every position within 2^k frame-hops of 0 is marked.
    f = torch.cat([succ, torch.full((1,), L, dtype=torch.int32,
                                    device=buf.device)]).to(torch.int64)
    reach = torch.zeros((L + 1,), dtype=torch.int32, device=buf.device)
    reach[0] = 1
    rounds = max(1, math.ceil(math.log2(max(2, L))))
    for _ in range(rounds):
        # scatter-max of the reach mask at the successors, then square
        # f.  Out of place: the source is read whole before any write,
        # as the JAX scatter reads it (an in-place scatter_reduce_ whose
        # source views the same tensor would not)
        reach = reach.scatter_reduce(0, f[:-1], reach[:-1], reduce='amax')
        f = f[f]
    reached = reach[:L].to(torch.bool)
    return reached & complete, torch.any(reached & invalid)
