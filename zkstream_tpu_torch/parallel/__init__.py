"""Distributed data plane: mesh construction and sharded wire decode.

The reference's "distributed" machinery is a client-side ensemble pool
over raw TCP (lib/client.js:88-118) — there are no collectives to
translate.  What does shard is the data plane built in
:mod:`zkstream_tpu_torch.ops`: a fleet of connection streams decodes
data-parallel over a mesh of devices, global session statistics reduce
with sums and an unsigned-64 max, and a single long stream can be
scanned sequence-parallel along its byte axis with a ring carrying the
frame cursor across shard boundaries.  The port of
``zkstream_tpu.parallel``, with the same public names.

- :mod:`mesh` — the port's single-controller ``(dp, sp)`` mesh.
- :mod:`sharded` — dp-sharded batched decode + the reductions.
- :mod:`seqscan` — byte-axis sequence-parallel frame scan (the cursor
  ring, its chunk walk in ops/seq_walk.py).

On a mesh with no process group whose shards share one device, each
sharded step, roundtrip and scan is one program (ops/tick_graph.py:
on a card, one CUDA graph replay a call), as the JAX package jits it.
- :mod:`multihost` — the process group and per-process placement.
- :mod:`fleet` — :class:`MeshFleetIngest` and
  :class:`MultihostFleetIngest`, the runtime consumers.
"""

from .fleet import MeshFleetIngest, MultihostFleetIngest
from .mesh import make_mesh
from .multihost import host_local_wire_batch, initialize
from .sharded import sharded_wire_roundtrip, sharded_wire_step
from .seqscan import seq_parallel_frame_scan

__all__ = ['MeshFleetIngest', 'MultihostFleetIngest',
           'host_local_wire_batch', 'initialize',
           'make_mesh', 'sharded_wire_roundtrip', 'sharded_wire_step',
           'seq_parallel_frame_scan']
