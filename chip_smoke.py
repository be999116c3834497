#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (zkstream_tpu_torch) on one CUDA card.

Run from the repository root on a machine with an H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. Build kernels K1 and K2 and the sequence-parallel scan's chunk walk
   (one library from
   ``zkstream_tpu_torch/csrc/wire_scan.cu``) with nvcc for sm_90a into
   ``build/`` and print ptxas's register/spill/shared-memory report of
   each, each kernel's launch geometry at the bench shape, and the K2
   blocks the card holds at once (its persistent grid).  Beside the
   nvcc build, and at the same time, build the host codec tier with
   gcc/g++ into ``build/``: the C-ABI frame scanner
   (``csrc/zkwire.cpp``) and the C-extension codec
   (``csrc/zkwire_ext.c``, against the interpreter's ``Python.h``), and
   print their paths and ABI numbers.  Either one missing is a failure:
   there is no quiet fall back to the Python codec.
2. Hold K1 against its plain torch version on the card, exactly
   (integer planes, tolerance 0): the deployed-shaped corpus (16384
   streams x 64 mixed-opcode frames, ~247 MiB, seed 42), an
   adversarial batch (bad prefixes, short frames, truncated tails,
   empty and full rows, odd B, lens > L, lens < 0) and the ring-edge
   batch (``corpus.ring_fleet``: fields straddling K2's stage
   boundaries, a frame longer than the ring, rows at every 16-byte
   alignment, lens > L, lens < 0, lens = 0).  Both batches have more
   than twice as many rows as K2 keeps warps resident, so in phase 5
   every warp walks a second row after one that stopped early.
3. The tick decode ``wire_pipeline_step_auto`` on the corpus (it must
   launch K1 and equal the plain step), ``entry()``, and the timings:
   K1 and the plain version by CUDA events in turns (plain, kernel,
   kernel, plain), the host->device copy of the tick batch, K1 at the
   ingest's bucket shape (2048 x 16384), and K1's bound at both shapes
   from the bytes it must move at 3.35 TB/s, with its share (bound /
   time); then K1's latency floor, K1 on 256 rows whose batch was
   evicted from L2.  A kernel's time (``ms``) is that of wrapper calls
   back to back, host overhead included where it exceeds the kernel's
   (the bucket); its device time (``device_ms``: the host queues the
   launches behind a spin kernel, so its launch overhead is not
   counted) is printed beside it.
4. The main path: ``FleetIngest(device='cuda', body_mode='host',
   bypass_bytes=0, warm='block', max_frames=64)`` serves 1,024
   stand-in connections fed their corpus streams in three chunks cut
   at seeded offsets, plus one connection carrying a bad length
   prefix — twice: first with ``PacketCodec(use_native=False)``
   codecs (packets assembled by the Python loop), then with
   ``use_native=True`` codecs, the reference's default, where every
   routed stream with frames goes to the C extension in one call
   (``_assemble_ext``, counted here) and the Python loop never runs.
   In each run every delivery must equal the pure-Python scalar
   drain's, the bad prefix must give BAD_LENGTH, and K1's launches
   (counted from 0 just before the run) must equal the ingest's device
   ticks, with no K2 launch.  Each run prints its mean tick, the
   device half a tick, the host-routing share, the time in packet
   assembly (and in the C calls) and the garbage collector's pauses.
   A third run repeats the C one with the script's own heap (corpus,
   xid maps, the scalar drain's packets) frozen out of the collector's
   reach (``gc.freeze()``), which shows what those pauses cost.
5. Hold K2 against its plain torch version on the card, exactly: the
   corpus at ``max_data=256`` (its GET_DATA payloads are exactly 256
   B, so every data frame fits), the adversarial batch, and a
   GET_DATA-adversarial batch (``corpus.getdata_fleet``: -1 empty
   buffers, truncated Stats, lengths that overrun the frame or sit
   near INT32_MAX, header-only frames) and the ring-edge batch.
   ``wire_full_decode`` on the corpus must equal
   ``wire_pipeline_step`` + ``getdata_bodies``.
6. Timings: K2 (wrapper calls and device time, as in phase 3) and its
   plain version by CUDA events in turns at the corpus shape, K2's
   bound at 3.35 TB/s and its share, K2 at the ingest's bucket shape
   with its bound and share, and there the device-body tick step (K2
   + the torch body parse + the pack) with its parts, each timed
   alone: the decode, K2,
   ``parse_reply_bodies``, ``parse_list_bodies``, the pack, and the
   readback of the packed arrays.
7. The device-body path: ``FleetIngest(device='cuda',
   body_mode='device', bypass_bytes=0, warm='block', max_frames=64)``
   serves the same 1,025 connections as phase 4, with
   ``use_native=True`` codecs (their bodies come from the planes, not
   the C extension; the bad stream's fallback uses it).  Every delivery must
   equal the scalar codec's, the bad prefix must give BAD_LENGTH, K2's
   launches (counted from 0 just before this phase) must equal the
   device ticks, K1 must not launch, and no body may fall back to the
   scalar reader (the corpus fits the default widths).
8. The sharded tick decode (parallel/sharded.py): ``sharded_wire_step``
   on the corpus over ``make_mesh()`` (every card of the machine: dp=1
   here) and over ``make_mesh(dp=4, devices=[cuda:0] * 4)`` (four
   logical shards on the one card).  Each must equal
   ``wire_pipeline_step_auto`` on the whole batch field for field
   (tolerance 0), its globals the unsigned-64 max and sums of that
   result, and K1's launches the shard count; ``sharded_wire_roundtrip``
   at dp=4 must return every encoded frame.  Both sharded steps are
   timed beside the single-device one.
9. The sequence-parallel scan (parallel/seqscan.py) of one stream, the
   valid bytes of the corpus's first 1,024 rows concatenated (65,536
   frames), at sp=1 and sp=4 on the card: the mask must equal
   ``frame_starts_pointer_doubling`` and the plain cursor walk, the
   chunk-walk kernel must equal its plain version on every chunk
   (tolerance 0), and the chunk-walk launches (counted from 0 just
   before the sp=4 scan) must be one a shard a ring step.  Also a
   stream whose one frame spans whole shards and one with a bad
   prefix.  The scan and one whole-stream walk (warm and with the
   stream evicted from L2) are timed.
10. ``MeshFleetIngest`` over ``make_mesh(dp=4, devices=[cuda:0] * 4)``
   serves phase 4's 1,025 connections twice: host bodies with C codecs
   (K1 launches = 4 x device ticks, no K2) and device bodies (K2
   launches = 4 x device ticks, no K1, no body fallback).  Every packet
   must equal the scalar drain's and the bad prefix give BAD_LENGTH;
   each tick's ``global_stats['total_frames']`` must equal the frames
   of the rows it routed, and ``fleet_max_zxid`` the largest zxid among
   the delivered replies.
11. ``MultihostFleetIngest`` over a one-rank NCCL process group
   (``parallel.initialize`` on 127.0.0.1 and a free port; the backend
   is printed and must be ``nccl``): the same connections on a fixed
   5 ms cadence, ``local_rows`` = 1,028 (a multiple of dp = 4),
   ``stream_len`` 16384 (more than a corpus row).  ``stop(after_ticks=N)``
   must leave ``launch_count == tick_count == N``, K1 launched 4 x N
   times, and every packet equal.  The group is destroyed before the
   report.

The last lines are the card's name and power limit, one JSON object of
kernels, and ``{"ok": true, "device": {...}}``.  Without a CUDA device
(or without the rest of the repository beside it) the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import gc
import json
import os
import struct
import subprocess
import sys
import sysconfig
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM published memory rate
B_CORPUS = 16384               # streams per tick, as bench.py's corpus
FRAMES = 64
FLEET = 1024                   # live connections in the ingest phases
SEED = 42
MAX_DATA = 256                 # FleetIngest's default GET_DATA width
# The ring-edge and adversarial batches: odd B, more than twice the warps
# K2 keeps resident (4,224 on an H100 at these geometries), so every warp
# walks a second row after one that stopped early; the ring's L % 16 == 4.
RING_B, RING_L = 9001, 6004
ADV_B, ADV_L = 9001, 512
FLOOR_ROWS = 256               # K1's latency floor: eight warps' rows
SPIN_CYCLES = 20_000_000       # _device_ms's spin, about 10 ms at 2 GHz


def _log(msg: str) -> None:
    print(msg, flush=True)


def _time_ms(torch, fn, n: int) -> float:
    """Mean device time of ``fn`` over ``n`` back-to-back calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _device_ms(torch, fn, n: int, warm: bool = True) -> tuple:
    """``(device ms, host ms)``: the mean device time of ``fn`` over
    ``n`` back-to-back calls without the host's launch overhead, and the
    mean host time of one call.  A spin kernel holds the stream while
    the host queues all ``n`` calls, so the CUDA events around them see
    the kernels run back to back, and the host clock around the queueing
    sees the calls alone.  Where a wrapper's host time (allocations,
    checks, the ctypes call) exceeds its kernel's, :func:`_time_ms`
    counts the host time and this does not.  If the host took longer to
    queue the calls than the spin lasted, the spin is doubled and the
    timing taken again.  ``warm`` makes one untimed call first."""
    if warm:
        fn()
    spin = SPIN_CYCLES
    for _ in range(4):
        held, a, b = (torch.cuda.Event(enable_timing=True)
                      for _ in range(3))
        torch.cuda.synchronize()
        t = time.perf_counter()
        held.record()
        torch.cuda._sleep(spin)
        a.record()
        t_call = time.perf_counter()
        for _ in range(n):
            fn()
        t_end = time.perf_counter()
        queued_ms = (t_end - t) * 1e3
        b.record()
        b.synchronize()
        if queued_ms < held.elapsed_time(a):
            return a.elapsed_time(b) / n, (t_end - t_call) * 1e3 / n
        spin *= 2
    raise RuntimeError('the host could not queue %d calls ahead of the '
                       'device' % n)


def _cold_ms(torch, fn, n: int = 10) -> float:
    """Mean device time of one call of ``fn`` whose inputs sit in device
    memory and not in the 50 MB L2: before each call, timed alone by
    :func:`_device_ms`, 256 MiB are written over."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device='cuda')
    fn()
    total = 0.0
    for _ in range(n):
        flush.zero_()
        total += _device_ms(torch, fn, 1, warm=False)[0]
    return total / n


def _equal_dicts(torch, want: dict, got: dict, what: str) -> int:
    """Assert every plane equal; return the max absolute difference."""
    err = 0
    for k in want:
        a, b = want[k], got[k]
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError('%s: %s shape/dtype %s %s vs %s %s' % (
                what, k, tuple(a.shape), a.dtype, tuple(b.shape), b.dtype))
        d = (a.to(torch.int64) - b.to(torch.int64)).abs()
        e = int(d.max()) if d.numel() else 0
        if e:
            raise AssertionError('%s: plane %s differs (max |d| %d)'
                                 % (what, k, e))
        err = max(err, e)
    return err


class StandIn:
    """A connection as the fleet ingest sees it: a codec, a state and
    the ``ingestDeliver`` event."""

    def __init__(self, codec):
        self.codec = codec
        self.got: list = []
        self.err = None

    def is_in_state(self, state: str) -> bool:
        return state == 'connected' and self.err is None

    def emit(self, event: str, pkts, err) -> None:
        if event != 'ingestDeliver':
            raise AssertionError('unexpected event %r' % (event,))
        self.got.extend(pkts)
        if err is not None:
            self.err = err


def _scalar_drain(PacketCodec, chunks, xid_map):
    """The per-socket pure-Python scalar drain of one connection's
    chunks."""
    codec = _codec(PacketCodec, xid_map, use_native=False)
    pkts, code = [], None
    for piece in chunks:
        try:
            pkts += codec.decode(piece)
        except Exception as e:      # the codec's protocol error
            pkts += getattr(e, 'packets', [])
            code = e.code
            break
    return pkts, code


def _check_fleet(conns, wants) -> int:
    """Every connection's deliveries equal the scalar drain's; returns
    the packet count."""
    n_pkts = 0
    for i, (conn, (want_pkts, want_code)) in enumerate(zip(conns, wants)):
        code = getattr(conn.err, 'code', None)
        if conn.got != want_pkts or code != want_code:
            raise AssertionError('connection %d: %d packets (err %s) vs '
                                 'scalar %d (err %s)' % (
                                     i, len(conn.got), code,
                                     len(want_pkts), want_code))
        n_pkts += len(conn.got)
    code = getattr(conns[-1].err, 'code', None)
    if code != 'BAD_LENGTH':
        raise AssertionError('bad-prefix connection raised %r' % (code,))
    return n_pkts


def _timed(ing, step_s: list) -> None:
    """Time the device half of each tick (staging fill, H2D copy, the
    step, pack, readbacks) on the host clock around its synchronize."""
    run_step = ing._run_step

    def timed_step(bk, active):
        t = time.perf_counter()
        out = run_step(bk, active)
        step_s.append(time.perf_counter() - t)
        return out

    ing._run_step = timed_step


def _count_assembly(ing) -> dict:
    """Count the streams ``_assemble_stream`` is given with frames and the
    calls of the C path ``_assemble_ext``, and time both on the host
    clock (``stream_s`` includes ``ext_s``).  A stream with frames takes
    either ``_assemble_ext`` or the Python loop, so equal counts mean
    the loop never ran."""
    counts = {'with_frames': 0, 'ext': 0, 'stream_s': 0.0, 'ext_s': 0.0}
    assemble, assemble_ext = ing._assemble_stream, ing._assemble_ext

    def counted_stream(conn, buf, st, bd, i, n):
        counts['with_frames'] += n > 0
        t = time.perf_counter()
        out = assemble(conn, buf, st, bd, i, n)
        counts['stream_s'] += time.perf_counter() - t
        return out

    def counted_ext(*args):
        counts['ext'] += 1
        t = time.perf_counter()
        out = assemble_ext(*args)
        counts['ext_s'] += time.perf_counter() - t
        return out

    ing._assemble_stream = counted_stream
    ing._assemble_ext = counted_ext
    return counts


class _GcPauses:
    """The interpreter's garbage-collector pauses while installed: their
    total seconds and their count by generation."""

    def __init__(self):
        self.s, self.n, self._t = 0.0, [0, 0, 0], 0.0

    def __call__(self, phase, info):
        if phase == 'start':
            self._t = time.perf_counter()
        else:
            self.s += time.perf_counter() - self._t
            self.n[info['generation']] += 1

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


def _codec(PacketCodec, xid_map, use_native: bool):
    c = PacketCodec(use_native=use_native)
    c.handshaking = False
    c.xid_map.update(xid_map)
    return c


async def _serve(ing, conns, chunks):
    """Register ``conns`` with the ingest, feed each its chunks one
    round per loop cycle, and run the loop until every slot drains."""
    for c in conns:
        ing.register(c)
    for k in range(3):
        for conn, ch in zip(conns, chunks):
            if ch[k]:
                ing.feed(conn, ch[k])
        await asyncio.sleep(0)
    loop = asyncio.get_running_loop()
    deadline = loop.time() + 300.0
    while ing._scheduled or any(buf for _c, buf in ing._slots.values()):
        if loop.time() > deadline:
            raise AssertionError('ingest did not drain in 300 s')
        await asyncio.sleep(0.001)


def _host_run(FleetIngest, W, K2, PacketCodec, xmaps, chunks, wants,
              use_native: bool, freeze: bool, what: str, smi: str) -> dict:
    """Phase 4: serve the fleet once through a host-body
    ``FleetIngest(device='cuda')`` with ``PacketCodec(use_native=...)``
    stand-ins, check it against the scalar drain, the launch counts and
    the assembly route, and print the tick's breakdown.  ``freeze``
    moves every object alive before the run (the corpus, its xid maps,
    the scalar drain's packets: the script's own heap) out of the
    garbage collector's reach with ``gc.freeze()`` for the run, so its
    collections scan only what the ingest allocates."""
    import torch

    conns = [StandIn(_codec(PacketCodec, m, use_native)) for m in xmaps]
    if any((c.codec.ext is not None) != use_native for c in conns):
        raise AssertionError('%s: C extension present is not %s'
                             % (what, use_native))
    torch.cuda.synchronize()
    ing = FleetIngest(device='cuda', body_mode='host', bypass_bytes=0,
                      warm='block', max_frames=FRAMES)
    step_s: list = []
    _timed(ing, step_s)
    counts = _count_assembly(ing)
    # warm='block' warms the bucket inside the first tick: time it
    warm_s: list = []
    try_warm = ing._try_warm

    def timed_warm(key):
        t = time.perf_counter()
        out = try_warm(key)
        warm_s.append(time.perf_counter() - t)
        return out

    ing._try_warm = timed_warm
    if freeze:
        gc.collect()
        gc.freeze()
    W.launches = K2.launches = 0
    t0 = time.perf_counter()
    try:
        with _GcPauses() as pauses:
            asyncio.run(_serve(ing, conns, chunks))
    finally:
        if freeze:
            gc.unfreeze()
    wall = time.perf_counter() - t0
    launches, k2_host = W.launches, K2.launches
    if not (ing.ticks > 0 and launches == ing.ticks and k2_host == 0
            and ing.ticks_scalar == 0 and ing.ticks_warming == 0):
        raise AssertionError(
            '%s: ingest ticks %d (scalar %d, warming %d) vs K1 launches %d, '
            'K2 launches %d' % (what, ing.ticks, ing.ticks_scalar,
                                ing.ticks_warming, launches, k2_host))
    want_ext = counts['with_frames'] if use_native else 0
    if not (counts['with_frames'] > 0 and counts['ext'] == want_ext):
        raise AssertionError(
            '%s: %d streams with frames routed, %d through _assemble_ext '
            '(expected %d)' % (what, counts['with_frames'], counts['ext'],
                               want_ext))
    n_pkts = _check_fleet(conns, wants)
    tick_ms = ing.tick_hist.sum() / max(ing.tick_hist.count(), 1)
    dev_ms = sum(step_s) * 1e3 / len(step_s)
    per_tick = 1e3 / ing.ticks
    _log('# phase 4 (%s) on %s: %d connections, %d packets equal to the '
         'pure-Python scalar drain, bad prefix -> %s; %d device ticks = %d '
         'K1 launches, 0 K2; %d streams with frames routed, %d through '
         '_assemble_ext; mean tick %.3f ms, of which the device half '
         '(stage, copy, K1, pack, readback) %.3f ms per tick: %s; host '
         'routing %.3f ms a tick, %.1f %% of it, of which packet assembly '
         '%.3f ms a tick (the C calls %.3f ms); the bucket warm-up inside '
         'the first tick %.3f ms; garbage-collector pauses in the run %.3f '
         'ms a tick (collections by generation %s); phase wall %.2f s'
         % (what, smi, len(conns), n_pkts,
            getattr(conns[-1].err, 'code', None), ing.ticks, launches,
            counts['with_frames'], counts['ext'], tick_ms, dev_ms,
            ' '.join('%.3f' % (x * 1e3) for x in step_s), tick_ms - dev_ms,
            100.0 * (1.0 - dev_ms / tick_ms), counts['stream_s'] * per_tick,
            counts['ext_s'] * per_tick, sum(warm_s) * 1e3,
            pauses.s * per_tick, pauses.n, wall))
    return {'tick_ms': tick_ms, 'device_ms': dev_ms,
            'routing_share': 1.0 - dev_ms / tick_ms, 'launches': launches}


def _count_mesh_ticks(ing) -> list:
    """Record, per device tick of a mesh ingest, ``[the fleet-global
    frame total, the frames of the rows the tick routed]``."""
    seen = []
    unpack, route = ing._unpack, ing._route_stream

    def counted_unpack(ints, byts):
        out = unpack(ints, byts)
        seen.append([ing.global_stats['total_frames'], 0])
        return out

    def counted_route(conn, buf, st, bd, i):
        seen[-1][1] += int(st.n_frames[i])
        return route(conn, buf, st, bd, i)

    ing._unpack, ing._route_stream = counted_unpack, counted_route
    return seen


def _check_globals(ing, seen, conns, what: str) -> None:
    """Each device tick's fleet total equals the frames of the rows it
    routed, and the fleet max the largest delivered reply zxid."""
    if not seen or any(g != r for g, r in seen):
        raise AssertionError('%s: per-tick global totals vs routed frames %s'
                             % (what, seen))
    best = max(p['zxid'] for c in conns for p in c.got if p['xid'] >= 0)
    if ing.fleet_max_zxid != best:
        raise AssertionError('%s: fleet_max_zxid %d, largest delivered '
                             'reply zxid %d' % (what, ing.fleet_max_zxid,
                                                best))


def _mesh_run(PAR, W, K2, PacketCodec, xmaps, chunks, wants, mesh,
              body_mode: str, smi: str) -> dict:
    """Phase 10: serve the fleet once through ``MeshFleetIngest`` on
    ``mesh`` (C codecs) and check packets, launches and globals."""
    import torch

    conns = [StandIn(_codec(PacketCodec, m, True)) for m in xmaps]
    torch.cuda.synchronize()
    ing = PAR.MeshFleetIngest(mesh=mesh, body_mode=body_mode, warm='block',
                              max_frames=FRAMES)
    step_s: list = []
    _timed(ing, step_s)
    seen = _count_mesh_ticks(ing)
    dp = mesh.shape['dp']
    W.launches = K2.launches = 0
    t0 = time.perf_counter()
    asyncio.run(_serve(ing, conns, chunks))
    wall = time.perf_counter() - t0
    k1, k2 = W.launches, K2.launches
    want = (0, dp * ing.ticks) if body_mode == 'device' else \
        (dp * ing.ticks, 0)
    if not (ing.ticks > 0 and (k1, k2) == want and ing.ticks_scalar == 0
            and ing.ticks_warming == 0):
        raise AssertionError(
            'mesh %s: %d device ticks (scalar %d, warming %d) over dp=%d, '
            'K1 %d and K2 %d launches' % (body_mode, ing.ticks,
                                          ing.ticks_scalar, ing.ticks_warming,
                                          dp, k1, k2))
    if body_mode == 'device' and ing.body_fallbacks:
        raise AssertionError('mesh: %d bodies fell back to the scalar '
                             'reader' % ing.body_fallbacks)
    n_pkts = _check_fleet(conns, wants)
    _check_globals(ing, seen, conns, 'mesh %s' % body_mode)
    tick_ms = ing.tick_hist.sum() / max(ing.tick_hist.count(), 1)
    dev_ms = sum(step_s) * 1e3 / len(step_s)
    _log('# phase 10 (%s bodies, dp=%d on one card) on %s: %d connections, '
         '%d packets equal to the scalar drain, bad prefix -> %s, '
         'body_fallbacks %d; %d device ticks, K1 %d and K2 %d launches; '
         'per-tick global frames %s = routed rows\' frames; fleet max zxid '
         '%d; mean tick %.3f ms, of which the sharded device half (stage, '
         'copies, %d kernels, reductions, pack, readback) %.3f ms: %s; '
         'phase wall %.2f s'
         % (body_mode, dp, smi, len(conns), n_pkts,
            getattr(conns[-1].err, 'code', None), ing.body_fallbacks,
            ing.ticks, k1, k2, [g for g, _r in seen], ing.fleet_max_zxid,
            tick_ms, dp, dev_ms, ' '.join('%.3f' % (x * 1e3) for x in step_s),
            wall))
    return {'tick_ms': tick_ms, 'device_ms': dev_ms, 'k1': k1, 'k2': k2,
            'ticks': ing.ticks}


def _multihost_run(PAR, W, K2, PacketCodec, xmaps, chunks, wants, dev,
                   smi: str) -> dict:
    """Phase 11: ``MultihostFleetIngest`` over a one-rank NCCL group."""
    import socket

    import torch
    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    PAR.initialize('127.0.0.1:%d' % port, num_processes=1, process_id=0)
    init_s = time.perf_counter() - t0
    try:
        backend = dist.get_backend()
        if backend != 'nccl':
            raise AssertionError('process group backend %r, not nccl'
                                 % (backend,))
        mesh = PAR.make_mesh(dp=4, devices=[dev] * 4)
        if mesh.group is None or mesh.world_size != 1:
            raise AssertionError('the mesh does not span the group')
        rows = -(-len(xmaps) // 4) * 4
        proxy = PAR.MultihostFleetIngest(
            mesh=mesh, local_rows=rows, stream_len=16384,
            tick_interval=0.005, body_mode='host', max_frames=FRAMES)
        conns = [StandIn(_codec(PacketCodec, m, True)) for m in xmaps]
        seen = _count_mesh_ticks(proxy)
        tick_s: list = []
        mh_tick = proxy._mh_tick

        def timed_tick():
            t = time.perf_counter()
            mh_tick()
            tick_s.append(time.perf_counter() - t)

        proxy._mh_tick = timed_tick

        async def run():
            proxy.warmup_tick()
            proxy.start()
            for c in conns:
                proxy.register(c)
            for k in range(3):
                for conn, ch in zip(conns, chunks):
                    if ch[k]:
                        proxy.feed(conn, ch[k])
                await asyncio.sleep(0.01)
            loop = asyncio.get_running_loop()
            deadline = loop.time() + 300.0
            while any(b for _c, b in proxy._slots.values()):
                if loop.time() > deadline:
                    raise AssertionError('proxy did not drain in 300 s')
                await asyncio.sleep(0.005)
            stop_at = proxy.tick_count + 2
            await proxy.stop(after_ticks=stop_at)
            return stop_at

        torch.cuda.synchronize()
        W.launches = K2.launches = 0
        t0 = time.perf_counter()
        stop_at = asyncio.run(run())
        wall = time.perf_counter() - t0
        k1, k2 = W.launches, K2.launches
        if not (proxy.launch_count == proxy.tick_count == stop_at
                and k1 == 4 * stop_at and k2 == 0 and proxy.ticks > 0):
            raise AssertionError(
                'multihost: launch_count %d, tick_count %d, stop %d, K1 %d, '
                'K2 %d launches' % (proxy.launch_count, proxy.tick_count,
                                    stop_at, k1, k2))
        n_pkts = _check_fleet(conns, wants)
        _check_globals(proxy, seen, conns, 'multihost')
    finally:
        dist.destroy_process_group()
    _log('# phase 11 on %s: process group backend %s (world 1, init %.2f '
         's); mesh dp=4 on one card; %d connections in %d slots, %d packets '
         'equal to the scalar drain, bad prefix -> %s; stop(after_ticks=%d) '
         '-> launch_count %d = tick_count %d (%d with frames), K1 %d '
         'launches = 4 x %d, K2 %d; fleet max zxid %d; tick %.3f ms mean '
         '(%.3f ms max) on the 5 ms cadence; phase wall %.2f s; group '
         'destroyed'
         % (smi, backend, init_s, len(conns), rows, n_pkts,
            getattr(conns[-1].err, 'code', None), stop_at,
            proxy.launch_count, proxy.tick_count, proxy.ticks, k1, stop_at,
            k2, proxy.fleet_max_zxid, sum(tick_s) * 1e3 / len(tick_s),
            max(tick_s) * 1e3, wall))
    return {'k1': k1, 'ticks': proxy.tick_count, 'backend': backend}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing run', file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from zkstream_tpu_torch import corpus
    from zkstream_tpu_torch import parallel as PAR
    from zkstream_tpu_torch.entry import entry
    from zkstream_tpu_torch.io.ingest import FleetIngest
    from zkstream_tpu_torch.ops import full_scan as K2
    from zkstream_tpu_torch.ops import pipeline as P
    from zkstream_tpu_torch.ops import replies as R
    from zkstream_tpu_torch.ops import seq_walk as SW
    from zkstream_tpu_torch.ops import wire_scan as W
    from zkstream_tpu_torch.protocol.framing import PacketCodec
    from zkstream_tpu_torch.utils import native as N

    t_start = time.perf_counter()
    dev = P.resolve_device('cuda')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _log('# card: %s (torch %s, CUDA %s)' % (smi, torch.__version__,
                                              torch.version.cuda))

    # -- 1. build: nvcc for the kernels and gcc/g++ for the host codec
    # tier, all started together --
    t0 = time.perf_counter()
    py_h = os.path.join(sysconfig.get_paths()['include'], 'Python.h')
    if not os.path.exists(py_h):
        raise RuntimeError('%s is missing: the C-extension codec cannot '
                           'build' % (py_h,))
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        kernels = pool.submit(W.load)
        scanner = pool.submit(N.ensure_lib)
        ext = pool.submit(N.ensure_ext)
        kernels.result()
        scanner, ext = scanner.result(), ext.result()
    K2.load()
    SW.load()
    if scanner is None or ext is None:
        raise RuntimeError('host codec tier did not build (scanner %r, '
                           'extension %r); see the compiler output above'
                           % (scanner, ext))
    _log('# phase 1 build: %.2f s; host codec tier: scanner %s (ABI %d), '
         'extension %s %s (ABI %d), Python.h %s' % (
             time.perf_counter() - t0, scanner._name,
             scanner.zkwire_abi_version(), ext.__name__, ext.__file__,
             ext.abi_version(), py_h))
    for line in W.build_report().splitlines():
        if ('registers' in line or 'spill' in line or 'smem' in line
                or 'Compiling entry' in line):
            _log('# ptxas: ' + line.strip())
    l_corpus = corpus.slot_schedule(FRAMES)[1]
    geo = K2.launch_config(B_CORPUS, l_corpus, FRAMES)
    k2_resident = K2.resident_blocks(dev, geo['warps'], geo['smem_bytes'])
    _log('# launch geometry at %d x %d: K1 %s; K2 %s (dynamic shared '
         'memory per block, not in ptxas\'s report), %d blocks resident '
         'on the card (%d an SM), so a persistent grid of %d' % (
             B_CORPUS, l_corpus, W.launch_config(B_CORPUS), geo,
             k2_resident, k2_resident //
             torch.cuda.get_device_properties(dev).multi_processor_count,
             K2.launch_config(B_CORPUS, l_corpus, FRAMES,
                              k2_resident)['blocks']))

    # -- 2. K1 against its plain version --
    t0 = time.perf_counter()
    buf_np, lens_np, slots, maps = corpus.fleet(B_CORPUS, SEED, FRAMES)
    _log('# corpus: B=%d L=%d (%.1f MiB) built in %.2f s' % (
        buf_np.shape[0], buf_np.shape[1], buf_np.nbytes / 2**20,
        time.perf_counter() - t0))
    db, dl = P.batch_to_device(buf_np, lens_np, dev)
    got = W.wire_scan(db, dl, FRAMES)
    want = W.wire_scan_plain(db, dl, FRAMES)
    torch.cuda.synchronize()
    err = _equal_dicts(torch, want, got, 'corpus')
    frames_found = int(got['counts'].sum())
    if frames_found != B_CORPUS * FRAMES or bool(got['bad'].any()):
        raise AssertionError('corpus decode: %d frames, bad=%s'
                             % (frames_found, bool(got['bad'].any())))
    abuf, alens = corpus.adversarial(seed=1, B=ADV_B, L=ADV_L)
    da, dal = P.batch_to_device(abuf, alens, dev)
    err = max(err, _equal_dicts(torch, W.wire_scan_plain(da, dal, FRAMES),
                                W.wire_scan(da, dal, FRAMES),
                                'adversarial'))
    n_bad = int(W.wire_scan(da, dal, FRAMES)['bad'].sum())
    rcfg = K2.launch_config(RING_B, RING_L, FRAMES)
    rbuf, rlens = corpus.ring_fleet(SEED, RING_B, RING_L,
                                    rcfg['stage_bytes'], rcfg['stages'])
    # K2's warps on these batches, each of which must walk two rows or more
    k2_warps = {}
    for what, B, L in (('adversarial', ADV_B, ADV_L),
                       ('ring edges', RING_B, RING_L)):
        c = K2.launch_config(B, L, FRAMES)
        c = K2.launch_config(B, L, FRAMES, K2.resident_blocks(
            dev, c['warps'], c['smem_bytes']))
        k2_warps[what] = c['blocks'] * c['warps']
        if B <= 2 * k2_warps[what]:
            raise AssertionError('%s: %d rows for %d resident K2 warps; '
                                 'some warp walks one row only'
                                 % (what, B, k2_warps[what]))
    dr, drl = P.batch_to_device(rbuf, rlens, dev)
    for f in (1, 16, FRAMES):
        err = max(err, _equal_dicts(torch, W.wire_scan_plain(dr, drl, f),
                                    W.wire_scan(dr, drl, f),
                                    'ring edges, %d frames' % f))
    _log('# phase 2 K1 == plain: corpus %d frames, adversarial B=%d '
         '(%d bad rows), ring edges %d x %d (stages of %d B) at 1, 16 and '
         '%d frames; max |d| %d' % (frames_found, abuf.shape[0], n_bad,
                                    RING_B, RING_L, rcfg['stage_bytes'],
                                    FRAMES, err))

    # -- 3. tick decode, entry and timings --
    before = W.launches
    st = P.wire_pipeline_step_auto(db, dl, max_frames=FRAMES)
    if W.launches != before + 1:
        raise AssertionError('wire_pipeline_step_auto did not launch K1')
    want_st = P.wirestats_to_numpy(P.wire_pipeline_step(db, dl, FRAMES))
    got_st = P.wirestats_to_numpy(st)
    for f in want_st:
        np.testing.assert_array_equal(want_st[f], got_st[f], err_msg=f)
    fn, args = entry(device='cuda')
    est = P.wirestats_to_numpy(fn(*args))
    if not ((est['n_frames'] > 0).all() and not est['bad'].any()
            and est['starts'].shape == (args[0].shape[0], 64)):
        raise AssertionError('entry() step gave unexpected stats')

    # the live fleet of phases 4 and 7: the corpus's first FLEET streams
    # and one more connection, two good frames then a bad length prefix
    streams = [buf_np[i].tobytes() for i in range(FLEET)]
    xmaps = maps[:FLEET]
    streams.append(streams[0][:slots[2]['off']] + b'\xff\xff\xff\xf9xx')
    xmaps.append(dict(maps[0]))
    # the bucket the ingest stages all of them in, whole, in both modes
    Bp, Lb = FleetIngest(device='cuda', max_frames=FRAMES)._bucket(
        len(streams), max(len(x) for x in streams))
    ibuf = np.zeros((Bp, Lb), np.uint8)
    ilens = np.zeros((Bp,), np.int32)
    for i, x in enumerate(streams):
        ibuf[i, :len(x)] = np.frombuffer(x, np.uint8)
        ilens[i] = len(x)

    def k1():
        W.wire_scan(db, dl, FRAMES)

    def plain():
        W.wire_scan_plain(db, dl, FRAMES)

    def step():
        P.wire_pipeline_step_auto(db, dl, max_frames=FRAMES)

    k1()
    plain()
    step()
    p1 = _time_ms(torch, plain, 3)
    k_a = _time_ms(torch, k1, 50)
    k_b = _time_ms(torch, k1, 50)
    p2 = _time_ms(torch, plain, 3)
    k_ms, plain_ms = (k_a + k_b) / 2, (p1 + p2) / 2
    k_dev, k_host = _device_ms(torch, k1, 50)
    step_ms = _time_ms(torch, step, 20)
    stage = torch.from_numpy(buf_np).pin_memory()
    dst = torch.empty_like(db)
    dst.copy_(stage, non_blocking=True)
    h2d_ms = _time_ms(torch, lambda: dst.copy_(stage, non_blocking=True),
                      10)
    del stage, dst
    bound_b = W.bound_bytes(B_CORPUS, FRAMES, frames_found)
    bound_ms = bound_b / HBM_BYTES_PER_S * 1e3
    ib, il = P.batch_to_device(ibuf, ilens, dev)
    k1_bucket = W.wire_scan(ib, il, FRAMES)
    _equal_dicts(torch, W.wire_scan_plain(ib, il, FRAMES), k1_bucket,
                 'K1 bucket')
    k1b_bound_b = W.bound_bytes(Bp, FRAMES, int(k1_bucket['counts'].sum()))
    k1b_bound_ms = k1b_bound_b / HBM_BYTES_PER_S * 1e3
    k1b_ms = _time_ms(torch, lambda: W.wire_scan(ib, il, FRAMES), 50)
    k1b_dev, k1b_host = _device_ms(torch,
                                   lambda: W.wire_scan(ib, il, FRAMES), 50)
    del ib, il, k1_bucket
    # K1's latency floor: one row's chain of FRAMES dependent round trips
    # to device memory, with next to nothing else in flight
    fb, fl = P.batch_to_device(buf_np[:FLOOR_ROWS], lens_np[:FLOOR_ROWS], dev)
    floor_ms = _cold_ms(torch, lambda: W.wire_scan(fb, fl, FRAMES))
    del fb, fl
    _log('# phase 3 on %s: K1 %.4f ms a wrapper call back to back (turns '
         '%.4f %.4f), %.4f ms device time, %.4f ms host time a call; bound '
         '%.4f ms (%d bytes at 3.35 '
         'TB/s), bound share %.3f (%.3f of device time); plain %.4f ms '
         '(turns %.4f %.4f), auto step %.4f ms, H2D copy of the %.1f MiB '
         'batch %.4f ms (%.1f GB/s); at the ingest bucket %d x %d: K1 %.4f '
         'ms a wrapper call, %.4f ms device time, %.4f ms host time a '
         'call, bound %.4f ms (%d bytes), bound share %.3f (%.3f of device '
         'time); latency floor '
         '(K1 on %d rows, the batch evicted from L2) %.4f ms, %.3f us a '
         'frame step' % (
             smi, k_ms, k_a, k_b, k_dev, k_host, bound_ms, bound_b,
             bound_ms / k_ms,
             bound_ms / k_dev, plain_ms, p1, p2, step_ms,
             buf_np.nbytes / 2**20, h2d_ms, buf_np.nbytes / h2d_ms / 1e6,
             Bp, Lb, k1b_ms, k1b_dev, k1b_host, k1b_bound_ms, k1b_bound_b,
             k1b_bound_ms / k1b_ms, k1b_bound_ms / k1b_dev, FLOOR_ROWS,
             floor_ms, floor_ms * 1e3 / FRAMES))

    # -- 4. the main path: live fleet ingest --
    rng = np.random.RandomState(SEED + 1)
    chunks = []
    for s in streams:
        a, b = sorted(rng.randint(0, len(s) + 1, 2).tolist())
        chunks.append([s[:a], s[a:b], s[b:]])
    wants = [_scalar_drain(PacketCodec, ch, m)
             for ch, m in zip(chunks, xmaps)]
    del db, dl, da, dal, dr, drl, got, want, st
    host_runs = {}
    for tier, use_native, freeze in (
            ('Python codecs', False, False), ('C codecs', True, False),
            ('C codecs, setup heap frozen', True, True)):
        host_runs[tier] = _host_run(
            FleetIngest, W, K2, PacketCodec, xmaps, chunks, wants,
            use_native, freeze, tier, smi)
    py_run, c_run = host_runs['Python codecs'], host_runs['C codecs']
    launches = c_run['launches']
    _log('# phase 4 side by side on %s: mean tick %.3f ms (Python codecs) '
         'vs %.3f ms (C codecs), %.2fx, and %.3f ms (C codecs, setup heap '
         'frozen); device half %.3f vs %.3f ms; host routing %.1f %% vs '
         '%.1f %% of the tick' % (
             smi, py_run['tick_ms'], c_run['tick_ms'],
             py_run['tick_ms'] / c_run['tick_ms'],
             host_runs['C codecs, setup heap frozen']['tick_ms'],
             py_run['device_ms'], c_run['device_ms'],
             100 * py_run['routing_share'], 100 * c_run['routing_share']))

    # -- 5. K2 against its plain version --
    t0 = time.perf_counter()
    db, dl = P.batch_to_device(buf_np, lens_np, dev)
    got2 = K2.full_scan(db, dl, FRAMES, MAX_DATA)
    want2 = K2.full_scan_plain(db, dl, FRAMES, MAX_DATA)
    torch.cuda.synchronize()
    err2 = _equal_dicts(torch, want2, got2, 'K2 corpus')
    data_frames = int((got2['dlen_raw'] == MAX_DATA).sum())
    want_data = B_CORPUS * sum(s['kind'] == 'data' for s in slots)
    if data_frames != want_data:
        raise AssertionError('K2 corpus: %d GET_DATA frames of %d bytes, '
                             'expected %d' % (data_frames, MAX_DATA,
                                              want_data))
    bound2_b = K2.bound_bytes(want2, MAX_DATA)
    del got2, want2
    da, dal = P.batch_to_device(abuf, alens, dev)
    err2 = max(err2, _equal_dicts(
        torch, K2.full_scan_plain(da, dal, FRAMES, MAX_DATA),
        K2.full_scan(da, dal, FRAMES, MAX_DATA), 'K2 adversarial'))
    gbuf, glens = corpus.getdata_fleet(seed=7, B=1024, L=2048,
                                       max_data=MAX_DATA)
    dg, dgl = P.batch_to_device(gbuf, glens, dev)
    err2 = max(err2, _equal_dicts(
        torch, K2.full_scan_plain(dg, dgl, FRAMES, MAX_DATA),
        K2.full_scan(dg, dgl, FRAMES, MAX_DATA), 'K2 getdata'))
    dr, drl = P.batch_to_device(rbuf, rlens, dev)
    for f, md in ((1, MAX_DATA), (16, 20), (FRAMES, MAX_DATA)):
        err2 = max(err2, _equal_dicts(
            torch, K2.full_scan_plain(dr, drl, f, md),
            K2.full_scan(dr, drl, f, md),
            'K2 ring edges, %d frames, max_data %d' % (f, md)))
    st_k, gd_k = P.wire_full_decode(db, dl, FRAMES, MAX_DATA)
    st_p = P.wire_pipeline_step(db, dl, FRAMES)
    gd_p = P.getdata_bodies(db, st_p, MAX_DATA)
    for f in st_p._fields:
        if not torch.equal(getattr(st_p, f), getattr(st_k, f)):
            raise AssertionError('wire_full_decode: WireStats.%s' % f)
    for f in gd_p._fields[:-1]:
        if not torch.equal(getattr(gd_p, f), getattr(gd_k, f)):
            raise AssertionError('wire_full_decode: GetDataBodies.%s' % f)
    for f in gd_p.stat_after_data._fields:
        if not torch.equal(getattr(gd_p.stat_after_data, f),
                           getattr(gd_k.stat_after_data, f)):
            raise AssertionError('wire_full_decode: stat_after_data.%s'
                                 % f)
    del st_k, gd_k, st_p, gd_p
    _log('# phase 5 K2 == plain: corpus %d GET_DATA frames of %d B, '
         'adversarial B=%d (%d resident warps), getdata B=%d, ring edges '
         '%d x %d (%d resident warps) at (frames, max_data) (1, %d), '
         '(16, 20), (%d, %d); max |d| %d; wire_full_decode == '
         'wire_pipeline_step + getdata_bodies on the corpus (%.2f s)' % (
             data_frames, MAX_DATA, abuf.shape[0], k2_warps['adversarial'],
             gbuf.shape[0], RING_B, RING_L, k2_warps['ring edges'],
             MAX_DATA, FRAMES, MAX_DATA, err2, time.perf_counter() - t0))

    # -- 6. K2 timings --
    def k2():
        K2.full_scan(db, dl, FRAMES, MAX_DATA)

    def k2_plain():
        K2.full_scan_plain(db, dl, FRAMES, MAX_DATA)

    k2()
    k2_plain()
    p1 = _time_ms(torch, k2_plain, 3)
    k_a = _time_ms(torch, k2, 20)
    k_b = _time_ms(torch, k2, 20)
    p2 = _time_ms(torch, k2_plain, 3)
    k2_ms, k2_plain_ms = (k_a + k_b) / 2, (p1 + p2) / 2
    k2_dev, k2_host = _device_ms(torch, k2, 20)
    bound2_ms = bound2_b / HBM_BYTES_PER_S * 1e3
    del db, dl, da, dal, dg, dgl, dr, drl
    # the bucket the ingest stages all 1,025 whole streams in
    ding = FleetIngest(device='cuda', body_mode='device', max_frames=FRAMES)
    ib, il = P.batch_to_device(ibuf, ilens, dev)
    k2b_want = K2.full_scan_plain(ib, il, FRAMES, MAX_DATA)
    _equal_dicts(torch, k2b_want, K2.full_scan(ib, il, FRAMES, MAX_DATA),
                 'K2 bucket')
    k2b_bound_b = K2.bound_bytes(k2b_want, MAX_DATA)
    k2b_bound_ms = k2b_bound_b / HBM_BYTES_PER_S * 1e3
    del k2b_want

    def dstep():
        ding._step(ib, il)

    def k2_bucket():
        K2.full_scan(ib, il, FRAMES, MAX_DATA)

    # the step's parts: the decode (K2, its unpack, the reductions), the
    # fixed-layout and list body parses, the pack, each timed alone;
    # then the two pinned readbacks
    st_b, gd_b = P.wire_full_decode(ib, il, FRAMES, MAX_DATA)
    bd_b = R.parse_reply_bodies(ib, st_b.starts, st_b.sizes,
                                max_data=MAX_DATA, max_path=ding.max_path,
                                getdata=gd_b)
    lb_b = R.parse_list_bodies(ib, st_b.starts, st_b.sizes)

    def decode():
        P.wire_full_decode(ib, il, FRAMES, MAX_DATA)

    def replies():
        R.parse_reply_bodies(ib, st_b.starts, st_b.sizes, max_data=MAX_DATA,
                             max_path=ding.max_path, getdata=gd_b)

    def lists():
        R.parse_list_bodies(ib, st_b.starts, st_b.sizes)

    def pack():
        ding._pack_bodies(st_b, bd_b, lb_b)

    ints, byts = ding._step(ib, il)
    h_ints = torch.empty(ints.shape, dtype=ints.dtype, pin_memory=True)
    h_byts = torch.empty(byts.shape, dtype=byts.dtype, pin_memory=True)

    def readback():
        h_ints.copy_(ints, non_blocking=True)
        h_byts.copy_(byts, non_blocking=True)

    for fn in (dstep, decode, replies, lists, pack, readback):
        fn()
    dstep_ms = _time_ms(torch, dstep, 5)
    k2b_ms = _time_ms(torch, k2_bucket, 20)
    k2b_dev, k2b_host = _device_ms(torch, k2_bucket, 20)
    decode_ms = _time_ms(torch, decode, 10)
    replies_ms = _time_ms(torch, replies, 5)
    lists_ms = _time_ms(torch, lists, 5)
    pack_ms = _time_ms(torch, pack, 5)
    rb_ms = _time_ms(torch, readback, 5)
    dstep_ms = (dstep_ms + _time_ms(torch, dstep, 5)) / 2
    n_ints, n_byts = ints.shape[1], byts[0].numel()
    rb_mb = (ints.numel() * 4 + byts.numel()) / 1e6
    del ib, il, ding, ints, byts, h_ints, h_byts, st_b, gd_b, bd_b, lb_b
    _log('# phase 6 on %s: K2 %.4f ms a wrapper call back to back (turns '
         '%.4f %.4f), %.4f ms device time, %.4f ms host time a call, plain '
         '%.4f ms (turns %.4f %.4f), K2 bound %.4f ms (%d bytes at 3.35 TB/s), bound share '
         '%.3f (%.3f of device time) at %d x %d, max_data %d; at the ingest '
         'bucket %d x %d: K2 %.4f ms a wrapper call, %.4f ms device time, '
         '%.4f ms host time a call, bound %.4f ms (%d bytes), bound share %.3f (%.3f of device '
         'time); device-body step (K2 + torch bodies + pack) %.4f ms: '
         'decode (K2, unpack, reductions) %.4f ms, parse_reply_bodies %.4f '
         'ms, parse_list_bodies %.4f ms, pack %.4f ms; packed %d int32 + '
         '%d uint8 per row, their readback (%.1f MB) %.4f ms (%.1f GB/s)'
         % (smi, k2_ms, k_a, k_b, k2_dev, k2_host, k2_plain_ms, p1, p2,
            bound2_ms,
            bound2_b, bound2_ms / k2_ms, bound2_ms / k2_dev, B_CORPUS,
            FRAMES, MAX_DATA, Bp, Lb, k2b_ms, k2b_dev, k2b_host, k2b_bound_ms,
            k2b_bound_b, k2b_bound_ms / k2b_ms, k2b_bound_ms / k2b_dev,
            dstep_ms, decode_ms, replies_ms, lists_ms, pack_ms, n_ints,
            n_byts, rb_mb, rb_ms, rb_mb / rb_ms))

    # -- 7. the device-body path: live fleet ingest --
    conns = [StandIn(_codec(PacketCodec, m, True)) for m in xmaps]
    torch.cuda.synchronize()
    ing = FleetIngest(device='cuda', body_mode='device', bypass_bytes=0,
                      warm='block', max_frames=FRAMES)
    dstep_s: list = []
    _timed(ing, dstep_s)
    W.launches = K2.launches = 0
    t0 = time.perf_counter()
    asyncio.run(_serve(ing, conns, chunks))
    dwall = time.perf_counter() - t0
    k2_launches, k1_dev = K2.launches, W.launches
    if not (ing.ticks > 0 and k2_launches == ing.ticks and k1_dev == 0
            and ing.ticks_scalar == 0 and ing.ticks_warming == 0):
        raise AssertionError('device-body ticks %d (scalar %d, warming %d) '
                             'vs K2 launches %d, K1 launches %d' % (
                                 ing.ticks, ing.ticks_scalar,
                                 ing.ticks_warming, k2_launches, k1_dev))
    if ing.body_fallbacks:
        raise AssertionError('%d bodies fell back to the scalar reader'
                             % ing.body_fallbacks)
    dn_pkts = _check_fleet(conns, wants)
    dtick_ms = ing.tick_hist.sum() / max(ing.tick_hist.count(), 1)
    _log('# phase 7 on %s: %d connections, %d packets equal to the scalar '
         'codec, bad prefix -> %s, body_fallbacks %d; %d device ticks = %d '
         'K2 launches, %d K1 launches; mean tick %.3f ms, of which the '
         'device half (stage, copy, K2, torch bodies, pack, two readbacks) '
         '%.3f ms per tick: %s; phase wall %.2f s'
         % (smi, len(conns), dn_pkts, getattr(conns[-1].err, 'code', None),
            ing.body_fallbacks, ing.ticks, k2_launches, k1_dev, dtick_ms,
            sum(dstep_s) * 1e3 / len(dstep_s),
            ' '.join('%.3f' % (x * 1e3) for x in dstep_s), dwall))

    # -- 8. the sharded tick decode --
    from zkstream_tpu_torch.ops.bytesops import u64pair_reduce_max

    t0 = time.perf_counter()
    db, dl = P.batch_to_device(buf_np, lens_np, dev)
    ref = P.wire_pipeline_step_auto(db, dl, max_frames=FRAMES)
    rh, rl = u64pair_reduce_max(ref.max_zxid_hi, ref.max_zxid_lo)
    want_g = [int(ref.n_frames.sum()), int(ref.n_notifications.sum()),
              int(ref.n_errors.sum()), int(rh), int(rl)]
    single_ms = _time_ms(
        torch, lambda: P.wire_pipeline_step_auto(db, dl, max_frames=FRAMES),
        20)
    mesh4 = PAR.make_mesh(dp=4, devices=[dev] * 4)
    sharded = {}
    for name, mesh in (('make_mesh()', PAR.make_mesh()),
                       ('dp=4 on one card', mesh4)):
        step = PAR.sharded_wire_step(mesh, max_frames=FRAMES)
        torch.cuda.synchronize()
        W.launches = 0
        st8, g8 = step(db, dl)
        torch.cuda.synchronize()
        dp = mesh.shape['dp']
        if W.launches != dp:
            raise AssertionError('%s: %d K1 launches for %d shards'
                                 % (name, W.launches, dp))
        for f in ref._fields:
            if not torch.equal(getattr(ref, f), getattr(st8, f)):
                raise AssertionError('%s: sharded WireStats.%s differs from '
                                     'the single-device step' % (name, f))
        if [int(x) for x in g8] != want_g:
            raise AssertionError('%s: globals %s, single-device reductions %s'
                                 % (name, [int(x) for x in g8], want_g))
        sharded[name] = (dp, W.launches,
                         _time_ms(torch, lambda: step(db, dl), 20))
    del st8, g8, ref
    rng8 = np.random.RandomState(SEED + 8)

    def plane(lo, hi):
        return torch.from_numpy(rng8.randint(
            lo, hi, (B_CORPUS, FRAMES)).astype(np.int32)).to(dev)
    _rst, rtotal = PAR.sharded_wire_roundtrip(mesh4, out_len=FRAMES * 52)(
        plane(1, 1 << 20), plane(0, 1 << 16), plane(0, 1 << 20),
        torch.zeros((B_CORPUS, FRAMES), dtype=torch.int32, device=dev),
        plane(16, 48))
    if int(rtotal) != B_CORPUS * FRAMES:
        raise AssertionError('roundtrip: %d of %d frames'
                             % (int(rtotal), B_CORPUS * FRAMES))
    del _rst, db, dl
    _log('# phase 8 on %s: sharded_wire_step == wire_pipeline_step_auto '
         'field for field on %d x %d, globals %s == its reductions; %s; '
         'single-device step %.4f ms; sharded_wire_roundtrip at dp=4: %d '
         'frames = B x F (%.2f s)'
         % (smi, B_CORPUS, FRAMES, want_g,
            '; '.join('%s: dp=%d, %d K1 launches, %.4f ms a step'
                      % (k, v[0], v[1], v[2]) for k, v in sharded.items()),
            single_ms, int(rtotal), time.perf_counter() - t0))

    # -- 9. the sequence-parallel scan --
    from zkstream_tpu_torch.ops.frame_scan import (
        frame_starts_pointer_doubling)

    t0 = time.perf_counter()

    def padded(s: bytes, sp: int):
        N = -(-(len(s) + 8) // (4 * sp)) * 4 * sp
        pad = np.zeros(N, np.uint8)
        pad[:len(s)] = np.frombuffer(s, np.uint8)
        return pad

    sw_err = [0]

    def chunk_check(pad, sp: int, n: int) -> int:
        """Each chunk's kernel walk from its true entry == the plain
        walk (the largest difference of exit, flags and mask kept in
        ``sw_err``); returns the frames found."""
        C, entry, found = len(pad) // sp, 0, 0
        for i in range(sp):
            ext = np.concatenate([pad[i * C:(i + 1) * C],
                                  pad[((i + 1) % sp) * C:][:4]])
            end = min(i * C + C, n)
            q, m, b = SW.walk_plain(torch.from_numpy(ext), i * C, end, n,
                                    entry)
            st = SW.new_state(C, dev)
            SW.seq_walk(torch.from_numpy(ext).to(dev), i * C, end, n,
                        torch.tensor(entry, dtype=torch.int32, device=dev),
                        st)
            e = max(abs(int(st.exit) - q), abs(int(st.valid) - 1),
                    int(bool(st.bad) != b),
                    int((st.mask.cpu() != m).sum()))
            sw_err[0] = max(sw_err[0], e)
            if e:
                raise AssertionError('chunk walk %d of %d: kernel (%d, %s) '
                                     'vs plain (%d, %s), max |d| %d' % (
                                         i, sp, int(st.exit), bool(st.bad),
                                         q, b, e))
            entry = q
            found += int(m.sum())
        return found

    def scan_check(s: bytes, sp: int, what: str):
        """The sp scan of ``s`` on the card == the plain scan (CPU
        shards) == pointer doubling, and each chunk's walk == plain."""
        pad = padded(s, sp)
        dpad = torch.from_numpy(pad).to(dev)
        scan = PAR.seq_parallel_frame_scan(
            PAR.make_mesh(dp=1, sp=sp, devices=[dev] * sp))
        torch.cuda.synchronize()
        SW.launches = 0
        got = scan(dpad, len(s))
        torch.cuda.synchronize()
        launches = SW.launches
        if launches != 1 + max(sp - 1, 1) * sp:
            raise AssertionError('%s sp=%d: %d chunk-walk launches'
                                 % (what, sp, launches))
        want = PAR.seq_parallel_frame_scan(PAR.make_mesh(
            dp=1, sp=sp, devices=['cpu'] * sp))(torch.from_numpy(pad), len(s))
        dbl, dbad = frame_starts_pointer_doubling(dpad, len(s))
        for a, b in zip(want, got):
            if not torch.equal(a, b.cpu()):
                raise AssertionError('%s sp=%d: scan differs from the plain '
                                     'scan' % (what, sp))
        if not (torch.equal(dbl.cpu(), want[0]) and bool(dbad) == bool(
                want[2])):
            raise AssertionError('%s sp=%d: scan differs from pointer '
                                 'doubling' % (what, sp))
        if chunk_check(pad, sp, len(s)) != int(want[1]):
            raise AssertionError('%s sp=%d: chunk walks miscount' % (what,
                                                                     sp))
        return scan, dpad, got, launches

    stream = b''.join(buf_np[i, :lens_np[i]].tobytes() for i in range(FLEET))
    n9 = len(stream)
    pad1 = padded(stream, 1)
    tp = time.perf_counter()
    q_full, mask_full, bad_full = SW.walk_plain(
        torch.from_numpy(np.concatenate([pad1, pad1[:4]])), 0, n9, n9, 0)
    plain_walk_ms = (time.perf_counter() - tp) * 1e3
    frames9 = int(mask_full.sum())
    if frames9 != FLEET * FRAMES or bad_full or q_full != n9:
        raise AssertionError('plain walk: %d frames, bad %s, exit %d'
                             % (frames9, bad_full, q_full))
    scans = {}
    for sp in (1, 4):
        scan, dpad, got, sp_launches = scan_check(stream, sp, 'corpus')
        if int(got[1]) != frames9 or bool(got[2]) or not torch.equal(
                got[0].cpu()[:n9], mask_full[:n9]):
            raise AssertionError('sp=%d: the scan != the plain cursor walk'
                                 % sp)
        scan(dpad, n9)
        scans[sp] = (sp_launches,
                     _time_ms(torch, lambda: scan(dpad, n9), 3))
        del dpad, got
    sw_launches = scans[4][0]
    body = struct.pack('>iqi', 5, 42, 0) + bytes(range(256)) * 8
    span = (struct.pack('>i', len(body)) + body + struct.pack('>i', 16)
            + struct.pack('>iqi', 6, 43, 0))
    _sc, _d, sgot, _l = scan_check(span, 4, 'spanning')
    bad9 = stream[:slots[3]['off']] + struct.pack('>i', -7) + stream[:4096]
    _sc, _d, bgot, _l = scan_check(bad9, 4, 'bad prefix')
    if int(sgot[1]) != 2 or bool(sgot[2]) or int(bgot[1]) != 3 \
            or not bool(bgot[2]):
        raise AssertionError('spanning / bad-prefix streams: %d frames (bad '
                             '%s), %d frames (bad %s)' % (
                                 int(sgot[1]), bool(sgot[2]), int(bgot[1]),
                                 bool(bgot[2])))
    # one whole-stream walk: warm, and with the stream evicted from L2
    ext1 = torch.from_numpy(np.concatenate([pad1, pad1[:4]])).to(dev)
    st1 = SW.new_state(len(pad1), dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)

    def walk():
        st1.valid.zero_()
        SW.seq_walk(ext1, 0, n9, n9, zero, st1)

    walk()
    if not torch.equal(st1.mask.cpu()[:n9], mask_full[:n9]) \
            or int(st1.exit) != q_full:
        raise AssertionError('whole-stream kernel walk != plain walk')
    walk_ms = _time_ms(torch, walk, 3)
    walk_cold_ms = _cold_ms(torch, walk, 3)
    walk_bound_b = SW.bound_bytes(frames9, len(pad1))
    walk_bound_ms = walk_bound_b / HBM_BYTES_PER_S * 1e3
    del ext1, st1
    # the walk is one dependent round trip a frame and nothing else in
    # flight: warm, each is an L2 hit; cold, a device-memory access
    _log('# phase 9 on %s: one stream of %d bytes (%d frames); sp scan == '
         'plain scan == pointer doubling == plain cursor walk, every chunk '
         'walk == plain (tolerance 0), at sp=1 (%d launches) and sp=4 (%d '
         'launches = 1 + 3 ring steps x 4 shards); spanning frame and bad '
         'prefix at sp=4 too; scan %.3f ms (sp=1), %.3f ms (sp=4); one '
         'whole-stream kernel walk %.3f ms warm (%.1f ns a frame), %.3f ms '
         'with the stream evicted from L2 (%.1f ns a frame: one dependent '
         'round trip a frame, its latency floor), plain walk on the host '
         '%.1f ms; bound %.4f ms (%d bytes at 3.35 TB/s); K1\'s step on 256 '
         'rows, for comparison, %.1f ns; %.2f s'
         % (smi, n9, frames9, scans[1][0], sw_launches, scans[1][1],
            scans[4][1], walk_ms, walk_ms * 1e6 / frames9, walk_cold_ms,
            walk_cold_ms * 1e6 / frames9, plain_walk_ms, walk_bound_ms,
            walk_bound_b, floor_ms * 1e6 / FRAMES, time.perf_counter() - t0))

    # -- 10. MeshFleetIngest, four shards on the card --
    mesh_runs = {
        mode: _mesh_run(PAR, W, K2, PacketCodec, xmaps, chunks, wants,
                        mesh4, mode, smi) for mode in ('host', 'device')}

    # -- 11. MultihostFleetIngest over a one-rank NCCL group --
    mh = _multihost_run(PAR, W, K2, PacketCodec, xmaps, chunks, wants, dev,
                        smi)

    # -- report --
    kernels = [{
        'name': 'K1 wire_scan (frame scan + reply-header parse)',
        'route': 'cuda',
        'source': 'zkstream_tpu_torch/csrc/wire_scan.cu',
        'replaces': W.REPLACES,
        'launches': launches,
        'max_abs_err': err,
        'equal': err == 0,
        'ms': k_ms,
        'device_ms': k_dev,
        'plain_ms': plain_ms,
        'bound_ms': bound_ms,
        'bound_by': 'bytes',
        'bound_share': bound_ms / k_ms,
        'library_ms': None,
        'bucket': {'shape': [Bp, Lb], 'ms': k1b_ms, 'device_ms': k1b_dev,
                   'bound_ms': k1b_bound_ms,
                   'bound_share': k1b_bound_ms / k1b_ms},
        'launches_by_path': {
            'phase 4 FleetIngest, C codecs': launches,
            'phase 8 sharded_wire_step dp=4': sharded['dp=4 on one card'][1],
            'phase 10 MeshFleetIngest host bodies': mesh_runs['host']['k1'],
            'phase 11 MultihostFleetIngest': mh['k1']},
    }, {
        'name': 'K2 full_scan (K1 + GET_DATA body words)',
        'route': 'cuda',
        'source': 'zkstream_tpu_torch/csrc/wire_scan.cu',
        'replaces': K2.REPLACES,
        'launches': k2_launches,
        'max_abs_err': err2,
        'equal': err2 == 0,
        'ms': k2_ms,
        'device_ms': k2_dev,
        'plain_ms': k2_plain_ms,
        'bound_ms': bound2_ms,
        'bound_by': 'bytes',
        'bound_share': bound2_ms / k2_ms,
        'library_ms': None,
        'bucket': {'shape': [Bp, Lb], 'ms': k2b_ms, 'device_ms': k2b_dev,
                   'bound_ms': k2b_bound_ms,
                   'bound_share': k2b_bound_ms / k2b_ms},
        'launches_by_path': {
            'phase 7 FleetIngest device bodies': k2_launches,
            'phase 10 MeshFleetIngest device bodies':
                mesh_runs['device']['k2']},
    }, {
        'name': 'seq_walk (the sequence-parallel scan\'s chunk walk)',
        'route': 'cuda',
        'source': 'zkstream_tpu_torch/csrc/wire_scan.cu',
        'replaces': SW.REPLACES,
        'launches': sw_launches,
        'max_abs_err': sw_err[0],
        'equal': sw_err[0] == 0,
        'ms': walk_ms,
        'cold_ms': walk_cold_ms,
        'plain_ms': plain_walk_ms,
        'plain_on': 'host CPU (the plain walk serves CPU tensors only)',
        'bound_ms': walk_bound_ms,
        'bound_by': 'bytes',
        'bound_share': walk_bound_ms / walk_ms,
        'ns_a_frame': walk_ms * 1e6 / frames9,
        'cold_ns_a_frame': walk_cold_ms * 1e6 / frames9,
        'library_ms': None,
        'shape': {'bytes': n9, 'frames': frames9},
    }]
    _log('# total %.1f s' % (time.perf_counter() - t_start))
    print(smi)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
