"""Multi-process entry points for the sharded data plane.

One process per host, each driving its own devices; the processes join
one ``torch.distributed`` process group.  The single-process mesh code
in this package works unchanged once three things hold:

1. every process has called :func:`initialize` (the process group);
2. the mesh is built with :func:`~.mesh.make_mesh` after it, so it
   spans the group: the global ``dp`` axis is each process's devices,
   rank-major, and only the scalar reductions cross processes;
3. per-process inputs are placed on the process's own shards with
   :func:`host_local_wire_batch` rather than shipped to one process.

The reference has no analogue — its "distributed backend" is a TCP
client pool against a server ensemble (SURVEY.md §5) — but a fleet
proxy decoding connection streams on every host is the scale story the
data plane is built for.  The port of ``zkstream_tpu.parallel.multihost``
(``jax.distributed`` becomes ``torch.distributed``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join (or start) the multi-process group.

    ``coordinator_address`` is ``host:port`` of rank 0's rendezvous;
    omitted arguments take the ``env://`` defaults (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  The backend is NCCL
    when the process drives CUDA devices, gloo otherwise.  Call once per
    process, before building the mesh.
    """
    backend = 'nccl' if torch.cuda.is_available() else 'gloo'
    kw = {}
    if num_processes is not None:
        kw['world_size'] = num_processes
    if process_id is not None:
        kw['rank'] = process_id
    init = ('tcp://' + coordinator_address if coordinator_address
            else 'env://')
    dist.init_process_group(backend, init_method=init, **kw)


def host_local_wire_batch(mesh: Mesh, local_buf, local_lens):
    """Place this process's stream batch on its own dp shards.

    Each process passes the ``[b, L]`` uint8 bytes and ``[b]`` int32
    lengths of ITS OWN connections (b = global B / process count); the
    result is, per local dp shard in row order, ``(bufs, lens)`` lists
    of tensors on the shards' devices — no stream byte leaves the
    process.  Feed them straight to ``sharded_wire_step(mesh, ...)``.
    """
    def place(x, dtype):
        t = torch.from_numpy(np.ascontiguousarray(x, dtype=dtype))
        # a CPU shard gets its own copy, as a device shard does
        return [s.clone() if s.device.type == 'cpu' else s
                for s in mesh.shard_rows(t)]

    return place(local_buf, np.uint8), place(local_lens, np.int32)
