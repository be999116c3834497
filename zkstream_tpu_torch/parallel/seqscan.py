"""Sequence-parallel frame scan: one long stream sharded on its byte axis.

The reference's decoder is inherently serial — each frame's position
depends on the previous frame's length (lib/zk-streams.js:39-64).  To
scan a stream larger than one device holds, shard the byte axis over
the mesh's ``sp`` axis and hand the frame cursor across shard
boundaries around a ring, as the JAX package's ``ppermute`` ring does:

1. **Halo exchange** — each shard gets the first 4 bytes of its right
   neighbour (the last shard wraps to shard 0's), so a length prefix
   straddling a boundary is readable locally.
2. **Ring propagation** — shard 0 starts with cursor 0; each shard,
   once it knows its entry cursor, walks its local frames and forwards
   its exit cursor to the right neighbour.  After ``max(p - 1, 1)``
   ring steps every shard knows where its first frame begins, even when
   one frame body spans whole shards (the cursor passes through).
   Each shard walks exactly once, when it adopts an entry; the
   ``valid`` flags, the offered cursors (``-1`` = none) and the walk
   state live on the devices, and the walk itself (ops/seq_walk.py)
   decides whether to adopt, so a ring step makes no host round trip.
   Before the first step every shard builds its chunk's tile exit map
   (``seq_walk_prepare``), which needs no entry, so the shards build
   theirs at once; a walk then takes one hop a tile of its chunk, not
   one a frame.  Every map stays on its own shard: the ring
   still hands one int32 cursor a step.
3. **Local mark** — each shard emits the frame-start mask of its chunk;
   the mask count and ``bad`` sum over the shards.

The ``sp`` axis stays inside one process (parallel/mesh.py), so the
ring's hops are copies between this process's devices — none at all
when the shards share one card.  There the whole scan is one program
(``ops/tick_graph.Program``): captured once per ``(N, p, tile)`` into a
CUDA graph and replayed, as the JAX package jits it once per ``N`` with
``n`` traced.  ``n`` is the program's int32 input on the card, which the
chunk-walk kernels read there, so one graph serves every ``n``.
"""

from __future__ import annotations

import torch

from ..ops import seq_walk as SW
from ..ops.tick_graph import Program
from .mesh import Mesh


def seq_parallel_frame_scan(mesh: Mesh, tile: int = SW.DEFAULT_TILE):
    """Build the sp-sharded scan for ``mesh``, its chunk walks cut into
    tiles of ``tile`` bytes (ops/seq_walk.py).

    Returns ``scan(buf, n) -> (is_start, total_frames, bad)``: ``buf``
    is uint8 ``[N]`` with N divisible by the sp axis size (chunks of 4
    bytes or more), ``n`` the valid length; ``is_start`` is bool ``[N]``
    marking each complete frame's prefix offset, ``total_frames`` an
    int32 and ``bad`` a bool scalar, all on the first sp device.

    On a mesh with no process group whose shards share one device the
    scan is one :class:`~..ops.tick_graph.Program` a buffer shape (on a
    card, one CUDA graph replay a call; ``scan.graphed`` is True): the
    call stages ``buf`` and ``n`` into the program's inputs and returns
    copies of its outputs, which later calls leave alone.  Otherwise it
    runs its ring eagerly.  ``scan.program`` is the program.
    """
    p = mesh.shape['sp']
    devs = mesh.sp_devices

    def local(buf, n):
        # n: the valid length, an int32 scalar on the first sp device,
        # read by the walks on their devices alone (no host read)
        C = buf.shape[0] // p
        chunks = [buf[i * C:(i + 1) * C].to(d) for i, d in enumerate(devs)]
        # the halo: shard i reads the first 4 bytes of shard i + 1
        ext = [torch.cat([chunks[i], chunks[(i + 1) % p][:4].to(devs[i])])
               for i in range(p)]
        ns = [n.to(d) for d in devs]
        base = [i * C for i in range(p)]
        state = [SW.new_state(C, d, tile) for d in devs]
        for i in range(p):
            SW.seq_walk_prepare(ext[i], base[i], ns[i], state[i])
        # shard 0 learns its entry (cursor 0) at the start
        SW.seq_walk(ext[0], base[0], ns[0],
                    torch.zeros((), dtype=torch.int32, device=devs[0]),
                    state[0])
        for _ in range(max(p - 1, 1)):
            # every shard offers its exit once it has walked, else -1;
            # all offers are taken before any shard adopts
            snd = [torch.where(s.valid != 0, s.exit, -1) for s in state]
            for i in range(p):
                SW.seq_walk(ext[i], base[i], ns[i],
                            snd[(i - 1) % p].to(devs[i]), state[i])
        first = devs[0]
        mask = torch.cat([s.mask.to(first) for s in state])
        total = torch.stack([s.mask.sum(dtype=torch.int32).to(first)
                             for s in state]).sum(dtype=torch.int32)
        bad = torch.stack([s.bad.to(first) for s in state]).any()
        return mask, total, bad

    prog = Program(local, devs[0], graphed=mesh.one_device,
                   static=('seq_parallel_frame_scan', p, tile))

    def scan(buf, n):
        N = buf.shape[0]
        n = int(n)
        if N % p or N // p < 4:
            raise ValueError('a stream of %d bytes does not split into %d '
                             'chunks of 4 bytes or more' % (N, p))
        if not 0 <= n <= 2**31 - 1:
            raise ValueError('n must lie in [0, 2^31)')
        return prog(buf, n)

    scan.program, scan.graphed = prog, prog.graphed
    return scan
