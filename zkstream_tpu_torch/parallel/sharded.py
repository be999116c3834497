"""Data-parallel sharded wire decode with collective reductions.

Shards the ``[B, L]`` stream batch over the mesh's ``dp`` axis; each
shard runs the local tick decode and the global session summary (total
frames/notifications, fleet-wide max zxid) reduces over the shards and,
where the mesh spans processes, over its process group — ``psum`` and
an unsigned-64 ``pmax`` on (hi, lo) pairs, as the JAX package's
``shard_map`` step does.  The fleet-wide max zxid is what a multi-host
session manager would persist as its resume checkpoint, the
distributed analogue of lib/zk-session.js:229-235.

The JAX local step is the jnp ``wire_pipeline_step``; here it is
:func:`~zkstream_tpu_torch.ops.pipeline.wire_pipeline_step_auto`,
because the port's plain version serves CPU tensors only: a CUDA shard
launches kernel K1.  The semantics are the same; the code path differs.

On a mesh with no process group whose shards all sit on one device,
each built step is one program (``ops/tick_graph.Program``), as the JAX
package jits its ``shard_map``: on a card every shard's K1, the
reductions and the concatenations are captured once per input shape into
a CUDA graph, and a call stages its arguments and replays it.  A mesh
with a group or over several devices runs the chain eagerly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.bytesops import u64pair_reduce_max
from ..ops.encode import build_reply_streams
from ..ops.pipeline import WireStats, wire_pipeline_step_auto
from ..ops.tick_graph import Program
from .mesh import Mesh


class GlobalWireStats(NamedTuple):
    """Fleet-wide reductions (int32 scalars on the mesh's first
    device, equal on every process)."""

    total_frames: torch.Tensor
    total_notifications: torch.Tensor
    total_errors: torch.Tensor
    max_zxid_hi: torch.Tensor
    max_zxid_lo: torch.Tensor


_SIGN = -0x80000000


def _u64_axis_max(mesh: Mesh, h, l):
    """Unsigned 64-bit max of the local shards' (hi, lo) int32 winners
    (``h``, ``l``: one scalar per shard) across the mesh, without 64-bit
    lanes: flip signs so a signed max orders like an unsigned one, take
    the max of hi, then the max of lo among the winners, the losers
    keyed at the ``sign`` sentinel.  Each max runs over the local shards
    and then over the group."""
    uh = [x ^ _SIGN for x in h]
    mh = mesh.pmax(uh)
    lo_key = [torch.where(u.to(mesh.first) == mh, x.to(mesh.first) ^ _SIGN,
                          _SIGN) for u, x in zip(uh, l)]
    ml = mesh.pmax(lo_key)
    return mh ^ _SIGN, ml ^ _SIGN


def fleet_globals(mesh: Mesh, stats) -> torch.Tensor:
    """The fleet-global reductions of the shards' ``WireStats``: int32
    ``[7]`` on the first device — total frames, replies, notifications,
    pings, errors, and the max zxid's hi and lo words."""
    sums = mesh.psum([torch.stack([
        s.n_frames.sum(dtype=torch.int32), s.n_replies.sum(dtype=torch.int32),
        s.n_notifications.sum(dtype=torch.int32),
        s.n_pings.sum(dtype=torch.int32), s.n_errors.sum(dtype=torch.int32)])
        for s in stats])
    hl = [u64pair_reduce_max(s.max_zxid_hi, s.max_zxid_lo) for s in stats]
    gh, gl = _u64_axis_max(mesh, [h for h, _ in hl], [l for _, l in hl])
    return torch.cat([sums, gh.reshape(1), gl.reshape(1)])


def _shards(mesh: Mesh, x) -> list:
    """Per-shard tensors: ``x`` itself when it is already a list of
    them (``host_local_wire_batch``), else this process's rows split
    over the local dp shards."""
    if isinstance(x, (list, tuple)):
        if len(x) != mesh.local_dp:
            raise ValueError('%d shards for %d local dp shards'
                             % (len(x), mesh.local_dp))
        return list(x)
    return mesh.shard_rows(x)


def _cat_stats(mesh: Mesh, per) -> WireStats:
    """Per-stream outputs of the shards, concatenated in row order on
    the first device."""
    return WireStats(*[torch.cat([getattr(s, f).to(mesh.first) for s in per])
                       for f in WireStats._fields])


def sharded_wire_step(mesh: Mesh, max_frames: int = 32):
    """Build the dp-sharded pipeline step for ``mesh``.

    Returns ``step(buf, lens) -> (WireStats, GlobalWireStats)``:
    ``buf`` is uint8 ``[B, L]`` (this process's rows, B divisible by its
    local dp shards) or the per-shard lists of
    :func:`~.multihost.host_local_wire_batch`.  Per-stream outputs come
    back per shard, concatenated in row order on the first shard's
    device; the global stats are scalars there, equal on every process.

    On a one-device mesh with no group (``step.graphed``) the step is
    one :class:`~..ops.tick_graph.Program` an input shape (one CUDA
    graph replay a call on a card): a call stages ``buf`` and ``lens``
    into the program's inputs and returns copies of its outputs, which
    later calls leave alone.  ``step.program`` is the program.
    """

    def local(buf, lens):
        per = [wire_pipeline_step_auto(b, n, max_frames=max_frames)
               for b, n in zip(_shards(mesh, buf), _shards(mesh, lens))]
        g = fleet_globals(mesh, per)
        return _cat_stats(mesh, per), GlobalWireStats(
            total_frames=g[0], total_notifications=g[2], total_errors=g[4],
            max_zxid_hi=g[5], max_zxid_lo=g[6])

    return _program(mesh, local, ('sharded_wire_step', max_frames))


def _program(mesh: Mesh, fn, static: tuple):
    """``fn`` as the mesh's program, exposed as a plain function with
    ``program`` and ``graphed`` attributes."""
    prog = Program(fn, mesh.first, graphed=mesh.one_device, static=static)

    def call(*args):
        return prog(*args)

    call.program, call.graphed = prog, prog.graphed
    return call


def sharded_wire_roundtrip(mesh: Mesh, out_len: int,
                           max_frames: int | None = None):
    """Build the dp-sharded encode->decode loop for ``mesh``.

    Each shard encodes its rows of per-frame field planes into wire
    streams (ops/encode.py) and decodes them back (the tick decode, K1
    on a CUDA shard); the fleet-wide frame count sums over the mesh.
    Returns ``loop(xid, zhi, zlo, err, sizes) -> (WireStats,
    total_frames)`` with all plane inputs int32 ``[B, F]``, B divisible
    by the local dp shards.

    ``out_len`` has no safe default: frames past it are dropped by the
    encoder, so the caller sizes it for the largest row.  ``max_frames``
    defaults to the plane width F, which cannot under-decode.

    A one-device mesh with no group makes the loop one program, as
    :func:`sharded_wire_step` does.
    """

    def local(xid, zhi, zlo, err, sizes):
        F = max_frames if max_frames is not None else sizes.shape[1]
        per = []
        for planes in zip(*(_shards(mesh, p)
                            for p in (xid, zhi, zlo, err, sizes))):
            buf, lens = build_reply_streams(*planes, out_len=out_len)
            per.append(wire_pipeline_step_auto(buf, lens, max_frames=F))
        total = mesh.psum([s.n_frames.sum(dtype=torch.int32) for s in per])
        return _cat_stats(mesh, per), total

    return _program(mesh, local,
                    ('sharded_wire_roundtrip', out_len, max_frames))
