"""The port's device mesh: a ``(dp, sp)`` grid this process drives.

A 2-D ``dp x sp`` mesh covers the data plane's parallelism: ``dp``
shards the connection-stream batch (data parallel), ``sp`` shards the
byte axis of one long stream (sequence parallel).  Axes of size 1 are
always present so the same code works at any scale.

JAX's ``Mesh`` is a single-controller grid: one process drives all of
its devices and ``shard_map`` runs the local step on each.  A torch
``DeviceMesh`` has one process per mesh position and cannot say that
one process owns a fleet and eight shards, so the port keeps its own
:class:`Mesh`: the grid of the ``torch.device``s this process drives
(repeats allowed — several logical shards may share one card), plus,
when the mesh spans processes, a ``torch.distributed`` process group.
Then the global ``dp`` axis is the local one times the world size,
rank-major (as ``jax.devices()`` orders processes), and the ``sp`` axis
stays inside a process.  Collectives run in two steps: over the local
shards with torch ops, then, where there is a group, one
``dist.all_reduce`` over it (NCCL for CUDA devices, gloo for CPU ones,
as the group was initialised).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """A ``(dp, sp)`` grid of this process's devices.

    Attributes:
      devices: object array ``[local dp, sp]`` of ``torch.device``.
      group: the process group the ``dp`` axis spans, or None.
      world_size: the group's size (1 without a group).
      shape: ``{'dp': local dp x world size, 'sp': sp}``, as JAX's.
    """

    def __init__(self, devices: np.ndarray, group=None):
        self.devices = devices
        self.group = group
        self.world_size = 1 if group is None else dist.get_world_size(group)
        self.local_dp, sp = devices.shape
        self.shape = {'dp': self.local_dp * self.world_size, 'sp': sp}

    @property
    def first(self) -> torch.device:
        """The first shard's device: where global results land."""
        return self.devices[0, 0]

    @property
    def dp_devices(self) -> list:
        """One device per local ``dp`` shard (the ``sp`` axis's first;
        a dp-sharded step is replicated over ``sp`` in JAX)."""
        return [self.devices[i, 0] for i in range(self.local_dp)]

    @property
    def sp_devices(self) -> list:
        """One device per ``sp`` shard (the first ``dp`` row)."""
        return [self.devices[0, j] for j in range(self.shape['sp'])]

    @property
    def one_device(self) -> bool:
        """No process group, and every shard on one device: the mesh's
        steps are then one program each (``ops/tick_graph.Program``, one
        CUDA graph replay a call on a card)."""
        return self.group is None and len(set(self.devices.flat)) == 1

    def has_cuda(self) -> bool:
        return any(d.type == 'cuda' for d in self.devices.flat)

    def shard_rows(self, x) -> list:
        """Split this process's rows ``x [b, ...]`` over the local dp
        shards, in row order, each on its shard's device."""
        b = x.shape[0]
        if b % self.local_dp:
            raise ValueError('%d rows do not divide over %d local dp '
                             'shards' % (b, self.local_dp))
        k = b // self.local_dp
        return [x[i * k:(i + 1) * k].to(d)
                for i, d in enumerate(self.dp_devices)]

    def _reduce(self, t, op):
        """``dist.all_reduce`` of ``t`` (on the first device) over the
        group, if any; the result on the first device."""
        if self.group is None:
            return t
        coll = self.first if dist.get_backend(self.group) == 'nccl' \
            else torch.device('cpu')
        r = t.to(coll).clone()
        if coll.type == 'cuda':
            with torch.cuda.device(coll):
                dist.all_reduce(r, op=op, group=self.group)
        else:
            dist.all_reduce(r, op=op, group=self.group)
        return r.to(self.first)

    def psum(self, parts) -> torch.Tensor:
        """Sum of the local shards' int32 ``parts`` (equal shapes), then
        over the group."""
        local = torch.stack([p.to(self.first) for p in parts]).sum(
            dim=0, dtype=torch.int32)
        return self._reduce(local, dist.ReduceOp.SUM)

    def pmax(self, parts) -> torch.Tensor:
        """Max of the local shards' int32 ``parts``, then over the
        group."""
        local = torch.stack([p.to(self.first) for p in parts]).amax(dim=0)
        return self._reduce(local, dist.ReduceOp.MAX)


def _devices(devices) -> list:
    """The devices a mesh is built over: by default every CUDA device of
    the process (raises without one)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'make_mesh() defaults to every CUDA device of the process, '
                'and torch.cuda.is_available() is False; pass devices=')
        return [torch.device('cuda', i)
                for i in range(torch.cuda.device_count())]
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == 'cuda':
            if not torch.cuda.is_available():
                raise RuntimeError('CUDA device %s requested but '
                                   'torch.cuda.is_available() is False'
                                   % (d,))
            if d.index is None:
                d = torch.device('cuda', torch.cuda.current_device())
        elif d.type != 'cpu':
            raise ValueError('unsupported device %s' % (d,))
        out.append(d)
    if not out:
        raise ValueError('a mesh needs at least one device')
    return out


def make_mesh(dp: int | None = None, sp: int = 1, devices=None) -> Mesh:
    """Build a ``(dp, sp)`` mesh over ``devices`` (default: every CUDA
    device of the process; repeats allowed).

    With ``dp=None`` the data-parallel axis absorbs every device not
    used by ``sp``.  When ``torch.distributed`` is initialised the mesh
    spans the default group: ``dp`` then counts the devices of every
    process, ``len(devices)`` on each.
    """
    devices = _devices(devices)
    group = (dist.group.WORLD if dist.is_available() and dist.is_initialized()
             else None)
    world = dist.get_world_size(group) if group is not None else 1
    n = len(devices) * world
    if dp is None:
        if n % sp:
            raise ValueError(f'{n} devices not divisible by sp={sp}')
        dp = n // sp
    if dp * sp != n:
        raise ValueError(f'dp*sp = {dp * sp} != {n} devices')
    if len(devices) % sp:
        raise ValueError(f'the sp axis (sp={sp}) stays inside one process, '
                         f'which drives {len(devices)} devices')
    arr = np.empty((len(devices) // sp, sp), dtype=object)
    for k, d in enumerate(devices):
        arr[k // sp, k % sp] = d
    return Mesh(arr, group)
