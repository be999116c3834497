#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (zkstream_tpu_torch) on one CUDA card.

Run from the repository root on a machine with an H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. Build kernels K1 and K2 and the sequence-parallel scan's chunk walk
   (its exit map, hop chain and mark kernels; one library from
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
   logical shards on the one card), each one program (its first call
   captures it and replays it once).  Each must equal
   ``wire_pipeline_step_auto`` on the whole batch field for field
   (tolerance 0), its globals the unsigned-64 max and sums of that
   result, and K1's launches a replay the shard count;
   ``sharded_wire_roundtrip`` at dp=4 must return every encoded frame
   with 4 K1 launches.  Both sharded steps are timed beside the
   single-device one: a whole call (staging, replay, result copies) and
   the replay alone.
9. The sequence-parallel scan (parallel/seqscan.py) of one stream, the
   valid bytes of the corpus's first 1,024 rows concatenated (65,536
   frames), at sp=1 and sp=4 on the card: the mask must equal the plain
   scan (CPU shards), ``frame_starts_pointer_doubling`` and the plain
   cursor walk; every chunk's tile exit map (``seq_walk_prepare``) must
   equal ``tile_exits_plain`` and every chunk's walk (hop chain + mark)
   ``walk_plain`` (tolerance 0), the kernels reading ``n`` on the card;
   the launches (counted from 0 just before each scan: its capture and
   one replay) must be one exit map a chunk and two walk launches a
   shard a ring step.  The scan's one program then serves ``n`` = 0, a
   frame's middle and the stream's end, each one replay with those
   launches, each equal to pointer doubling.  The same on a stream whose one frame spans
   whole shards and on one with a bad prefix; each sp=4 chunk's map and
   walk again at 16-byte tiles (every frame spans tiles); and the map
   and walk on random small chunks and entries (before, inside and past
   the chunk, saturated).
   Timed: the scan (a whole call and its replay) and its replay at sp=1
   and sp=4 at 16, 32 and 64 KiB tiles (each checked against the plain
   cursor walk), and one whole-stream exit map
   and walk at five tile sizes, warm and with the stream evicted from
   L2, beside their bounds: the walk's (4 bytes a frame's prefix read,
   the mask written) and this design's floor (the stream read).
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
12. Live clients on the card: 1,024 of the port's ``Client`` (the
   largest cell of ``CROSSOVER.md``) against one port ``ZKServer`` on
   127.0.0.1, in memory (``db=ZKDatabase()``, no WAL), as
   ``bench.py``'s client-ops cells run, but with a 120 s session
   timeout (``LIVE_SESSION_TIMEOUT_MS``: pings time out after an eighth
   of it, and 3.75 s was too short for 1,024 sessions on one loop).
   The soft fd limit is raised first (``utils.fdlimit.raise_nofile``)
   and the phase fails with ``headroom_error``'s message if the 2,048
   sockets do not fit; the transport tiers resolved on both sides are
   printed.  Each client first runs the op surface of the reference's
   ingest parity workload (``tests/test_ingest.py::_workload``) in its
   own subtree ``/f/<i>`` and records its observations as plain tuples;
   then ``bench.py``'s mixed workload (get, set and create on 64-byte
   data; 8, 4 and 2 ops a client) and its watch fan-out (every client
   watches ``/b``; one set fires 1,024 notifications and their re-arm
   reads).  Three runs, each on a fresh server: the scalar drain
   (``ingest=None``, C codecs: the reference's default), then one
   shared ``FleetIngest(device='cuda', bypass_bytes=0, warm='block',
   max_frames=4)`` in ``body_mode='host'`` and in ``body_mode='device'``
   (default widths), each prewarmed before the first client connects.
   Every client's observations in the ingest runs must equal the scalar
   run's, every fan-out watcher must fire exactly once, K1's launches
   (from 0 before the run) must equal the host-body run's device ticks
   with no K2, K2's the device-body run's with no K1, and neither run
   may take a scalar, warming or fragmentation tick or fall back to a
   scalar body reader.  Each run prints its connect time, ops/s with
   p50/p99 by op kind, the fan-out time, the mean tick and its device
   half.  Last, ``entry.dryrun_multichip(4, devices=[cuda:0] * 4)``
   serves its live fleets through both mesh ingests on the card.
13. The ensemble under a leader SIGKILL: three runs, each on a fresh
   ensemble of three port member processes (``ProcMember`` spawning
   ``server/member_worker.py``; election and quorum commit on, a WAL
   each in a temporary directory), with 1,024 port ``Client``s spread
   across the members (the scalar drain; one shared
   ``FleetIngest(device='cuda', bypass_bytes=0, warm='block',
   max_frames=4)`` with host bodies, then device bodies), with the
   redial delays of the process-tier schedules (100 ms growing to 1 s,
   in monitor mode too; 10 s a dial) and a 120 s session.  Each client
   writes its own ``/f/<i>`` and watches ``/b``, and the fleet's heap
   is then frozen out of the collector's reach; then phase 12's mixed
   workload (8 gets of ``/b``, 4 sets of its own node, 2 creates under
   it, interleaved), and when half the fleet's ops are done the leader
   ``find_leader`` names gets SIGKILL.  An op felled by the failover is
   retried until it completes on the survivors (its latency runs from
   the first attempt).  Then one ``set('/b')`` through a client of the
   new leader.  Printed per run: time to elect, time until every
   session is connected again with its old id, expired sessions (must
   be 0), ops/s and p50/p99 by op before and after the kill, the
   fan-out time to 1,024 watchers, the mean tick and its device half,
   the launch counts and each survivor's ``zk_elections_total``.
   Gates: every acknowledged write reads back from the new leader,
   every watcher fired exactly once (and not before the set), the
   fleet's histories (one per client, and the elections) pass the
   port's ``check_history`` against the tree recovered from the new
   leader's WAL, K1 launches equal the host-body run's device ticks
   and K2's the device-body run's (the other kernel 0), and no body
   falls back to the scalar reader.  The device-body run also runs
   ``python -m zkstream_tpu_torch -s <new leader> --codec ingest get
   /f/0`` as a subprocess, which must exit 0.  Last, the seeded
   campaigns on the card: ``run_ensemble_schedule`` over the first 8
   seeds from 0 whose ``FaultPlan`` drives a batch-regime ingest and
   ``run_concurrent_schedule(clients=3)`` over the first 4 of them,
   ``device='cuda'``: every schedule ``ok``, K1 launches equal to the
   ingests' device ticks.
14. The port's bench (``zkstream_tpu_torch.bench``) in-process on
   ``cuda:0``.  Its flagship at its own corpus (``bench._fleet()``:
   16384 streams x 64 frames, seed 42, the reference bench's shape):
   the scalar tick and full-decode baselines and the C-extension full
   decode, then ``bench_tensor`` — the tick (K1), the toy-width full
   decode (K2 + ``parse_reply_bodies``) and the deployed-width one (K2 +
   both body parses), each one program (a CUDA graph replay a call, the
   corpus staged into its inputs once), each timed as the min of 4
   rounds — and its three gates (every plane against the corpus's
   ground truth and the scalar codec's packets, the list planes against
   the scalar walks), on the outputs of a replay.  K1's launches,
   counted from 0 just before ``bench_tensor``, must equal the tick
   candidate's calls (warm-up replay included; the capture's eager
   warm-up run is counted apart), K2's the two full-decode candidates'
   calls.  The bench's three metric lines are printed, and each part of
   a candidate timed alone, as wrapper calls and replayed as a program
   of its own.  Then its client-ops cells at ``CLIENT_SCALES`` (32 and 128
   port ``Client``s against a port ``ZKServer``; Python codecs, C codecs
   and ``FleetIngest(device='cuda', body_mode='host', max_frames=8,
   bypass_bytes=0)``), one run each: K1's launches, from 0 before each
   ingest run, must equal its device ticks (at least one), K2 none.
   Last, the port's C load generator, built from ``csrc/loadgen.c``:
   one 1,000-session count-mode ``zkloadgen`` run at its default thread
   count (two or more) against a port ``ZKServer``, bracketed by a port
   ``Client``'s writes.  It must exit 0 inside ``LG_TIMEOUT``, connect
   every session, and its op counts must reconcile with the server's
   zxid advance, its fan-out SET fire the Python client's watch.
15. The port's measuring tools (``zkstream_tpu_torch/tools/``) on
   ``cuda:0``, with the script's heap frozen out of the collector's
   reach.  ``sweep_crossover.run_cell`` at 32, 256 and 1,024
   connections (``max_frames`` 16, and 4 at 1,024) for ``native``,
   ``ingest`` (K1), ``ingest-auto`` (``FleetIngest``'s shipped dispatch
   defaults) and ``ingest-py-dev`` (K2), one round of the get workload
   each: no cell may raise, every get is counted, every fan-out storm
   fires all ``n`` watchers, and each ingest cell's K1 launches equal
   its host-body device ticks and its K2 launches its device-body ones
   (the other kernel 0); the ``ingest-auto`` cells print their routing
   fractions.  Then ``diag_ingest`` at 32 clients x 15 creates (its
   per-phase split printed; K1 launches = its device ticks),
   ``crossover_encode`` at 128 and 1,024 connections (the device bytes
   held to the host encoder's before any timing), ``bench_linearize
   --rounds 1`` (exit 0) and a short ``profile_hotpath`` decode run.
   K1 and K2 launches, from 0 at the phase's start, must equal the sum
   of its ingests' device ticks of each body mode.
16. The tick program as a CUDA graph.  ``FleetIngest`` and the one-card
   ``MeshFleetIngest`` capture each shape bucket's tick program once,
   when the bucket warms (``FleetIngest._compile``,
   ``ops/tick_graph.py``), and every device tick of phases 4, 7, 10 and
   12-15 is one replay of it, whose K1 or K2 launches are counted per
   replay.  Here, for host and device bodies, at a 32-client tick (the
   first two frames of 32 corpus streams, ``max_frames`` 16) and at
   phase 4's 2048 x 16384 bucket, and at that bucket over four dp
   shards of the card: the bucket's warm (the eager warm-up run and the capture)
   in ms and the graph memory pool's bytes after it; one replayed tick's
   packed ints and bytes, which must equal the eager chain's on the same
   staged inputs bit for bit, with exactly one K1 or K2 launch a shard
   counted; then, eager chain against replay, the kernels a tick and
   their device ms as ``torch.profiler`` traces them, the tick's time on
   the card (CUDA events around ticks back to back), the host's time a
   tick, and the device half (staging, copies, tick, readbacks,
   synchronize) on the host clock.
17. The JAX package's other one-card ``jax.jit`` programs, each one
   ``ops/tick_graph.Program`` captured once per key: ``sharded_wire_step``
   (dp=1, and dp=4 on the card) and ``sharded_wire_roundtrip`` (dp=4) at
   the corpus (16384 x 64), ``seq_parallel_frame_scan`` (sp=1 and 4) on
   phase 9's stream, and the bench's ``tick``, ``full`` and
   ``full-deployed``.  For each: the entry's warm (the eager warm-up run
   and the capture) in ms and the graph pool's bytes; one replay, with
   its launches counted (K1 a shard, K2 once, the scan's exit maps and
   walks), equal to the eager chain on the same staged inputs bit for
   bit; then, eager chain against replay, the kernels a call and their
   device ms (``torch.profiler``), the time on the card (CUDA events
   around calls back to back) and the host's time a call, and a whole
   call (staging, replay, result copies) and its staging alone.
18. A bucket that fails to warm.  64 corpus streams (the first two
   frames of each) through one ``FleetIngest(device='cuda',
   warm='block', bypass_bytes=0)`` over two shape buckets, in host and
   in device bodies: bucket A (16 streams) fails its capture for real
   (a tensor made from a host list in its step, a pageable copy), is
   logged once at error level and latches onto the scalar drain (both
   its ticks in ``ticks_scalar``, no K1 or K2 launch, no retry); bucket
   B (48 streams) then captures on the same ingest and replays, one K1
   or K2 launch a tick.  Every packet of both equals the pure-Python
   scalar drain's.  Printed: A's failed warm, B's warm, a scalar-drained
   tick of A and a replayed tick of B on the host clock, and B's replay
   on the card.  The main-path phases (4, 7, 10-16) fail if a warm
   failed in them.

What still runs eagerly: a mesh over several cards, phase 11's
``MultihostFleetIngest`` (a process group), and phases 2-6's direct
calls of the kernels' wrappers, which time the kernels themselves.

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
LIVE_CLIENTS = 1024            # phase 12: CROSSOVER.md's largest cell
LIVE_OPS_TOTAL = 1920          # bench.py's OPS_TOTAL, fleet-wide per kind
LIVE_TIMEOUT = 180.0           # phase 12: the longest any one wait may take
# Phase 12's session timeout, ms.  A client's ping times out after an
# eighth of it (io/connection.py); with 1,024 sessions and the server on
# one event loop, replies on the card machine's host took longer than the
# 3.75 s that bench.py's 30 s timeout allows, so the session is given 120 s
# (15 s for a ping).
LIVE_SESSION_TIMEOUT_MS = 120000


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
    total seconds, the longest, and their count by generation."""

    def __init__(self):
        self.s, self.n, self._t, self.max = 0.0, [0, 0, 0], 0.0, 0.0

    def __call__(self, phase, info):
        if phase == 'start':
            self._t = time.perf_counter()
        else:
            d = time.perf_counter() - self._t
            self.s += d
            self.max = max(self.max, d)
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


def _stat_obs(stat) -> tuple:
    """Stat fields that are equal across two fresh servers running the
    same op sequence (times are wall-clock; zxids depend on how the
    sessions interleave)."""
    return (stat.version, stat.cversion, stat.dataLength,
            stat.numChildren, stat.ephemeralOwner == 0)


async def _until(cond, what: str) -> None:
    loop = asyncio.get_running_loop()
    deadline = loop.time() + LIVE_TIMEOUT
    while not cond():
        if loop.time() > deadline:
            raise AssertionError('phase 12: %s did not happen in %.0f s'
                                 % (what, LIVE_TIMEOUT))
        await asyncio.sleep(0.01)


async def _live_workload(c, root: str, ZKError, CreateFlag) -> list:
    """The op surface and watcher sequence of the reference's ingest
    parity workload (``tests/test_ingest.py::_workload``), rooted at
    ``root``, recorded as plain tuples."""
    obs: list = []
    events: list = []
    # futures, not polling: 1,024 clients polling a condition every few
    # milliseconds would load the loop they share with the server
    loop = asyncio.get_running_loop()
    first, changed = loop.create_future(), loop.create_future()

    def on_event(evt, *a):
        events.append((evt, bytes(a[0]) if evt == 'dataChanged' and a
                       else None))
        for fut, hit in ((first, True), (changed, evt == 'dataChanged')):
            if hit and not fut.done():
                fut.set_result(None)

    w = c.watcher(root + '/w')
    for evt in ('created', 'deleted', 'dataChanged'):
        w.on(evt, lambda *a, _e=evt: on_event(_e, *a))
    # the first arm on a missing node emits 'deleted'
    await asyncio.wait_for(first, LIVE_TIMEOUT)
    obs.append(('create', await c.create(root + '/w', b'v0')))
    data, stat = await c.get(root + '/w')
    obs.append(('get', data, _stat_obs(stat)))
    stat = await c.set(root + '/w', b'v1' * 40)
    obs.append(('set', _stat_obs(stat)))
    data, stat = await c.get(root + '/w')
    obs.append(('get2', data, _stat_obs(stat)))
    obs.append(('exists', _stat_obs(await c.stat(root + '/w'))))
    children, stat = await c.list(root)
    obs.append(('ls', sorted(children), _stat_obs(stat)))
    obs.append(('acl', tuple((int(a.perms), a.id.scheme, a.id.id)
                             for a in await c.get_acl(root + '/w'))))
    try:
        await c.get(root + '/missing')
    except ZKError as e:
        obs.append(('err', e.code))
    obs.append(('seq', await c.create(
        root + '/q-', b'',
        flags=CreateFlag.SEQUENTIAL | CreateFlag.EPHEMERAL)))
    await c.sync(root + '/w')
    # a ping that joins the session's keep-alive ping in flight resolves
    # with no latency of its own (both packages' connection.ping)
    latency = await c.ping()
    obs.append(('ping', latency is None or latency >= 0))
    await asyncio.wait_for(changed, LIVE_TIMEOUT)
    obs.append(('events', events[:3]))
    return obs


def _pcts(lat: list) -> tuple:
    """p50 and p99 of ``lat`` (ms), as bench.py's ``_percentiles``."""
    lat = sorted(lat)
    return tuple(lat[min(len(lat) - 1, int(p / 100.0 * len(lat)))]
                 for p in (50, 99))


async def _lag_monitor(lag: list) -> None:
    """Record the event loop's longest lag behind a 10 ms ticker in
    ``lag[0]``: how long any one callback or collection held the loop,
    the thing a session's ping timeout measures."""
    loop = asyncio.get_running_loop()
    while True:
        t = loop.time()
        await asyncio.sleep(0.01)
        lag[0] = max(lag[0], loop.time() - t - 0.01)


async def _live_serve(ingest, n: int, what: str, pauses) -> dict:
    """One phase-12 run on a fresh in-memory server: ``n`` port clients
    through ``ingest`` (None: the per-socket scalar drain) run the parity
    workload, the mixed workload and the watch fan-out.  A progress line
    after each step carries the loop's longest lag and the collector's
    pauses so far (``pauses``: a ``_GcPauses``)."""
    from zkstream_tpu_torch import Client, CreateFlag, ZKError
    from zkstream_tpu_torch.io import transport
    from zkstream_tpu_torch.server import ZKDatabase, ZKServer

    loop = asyncio.get_running_loop()
    out: dict = {}
    lag = [0.0]
    t_run = loop.time()

    def step(name: str) -> None:
        _log('# phase 12 (%s) %s done at %.2f s: longest loop lag %.3f s, '
             'collector pauses %.3f s (longest %.3f s, by generation %s)'
             % (what, name, loop.time() - t_run, lag[0], pauses.s,
                pauses.max, pauses.n))

    monitor = loop.create_task(_lag_monitor(lag))
    srv = await ZKServer(db=ZKDatabase()).start()
    clients: list = []
    try:
        if ingest is not None:
            # warm the buckets before any session exists: a warm inside
            # a tick delays every session's replies behind it
            bp = 8
            while bp <= n:
                for nb in (None, 512, 1024):
                    await ingest.prewarm(bp, nb)
                bp *= 2
        t0 = loop.time()
        clients = [Client(address='127.0.0.1', port=srv.port,
                          session_timeout=LIVE_SESSION_TIMEOUT_MS,
                          ingest=ingest, use_native_codec=True)
                   for _ in range(n)]
        for c in clients:
            c.start()
        await asyncio.gather(*[c.wait_connected(timeout=LIVE_TIMEOUT)
                               for c in clients])
        out['connect_s'] = loop.time() - t0
        step('connect')
        if any(c.current_connection().ingest is not ingest
               for c in clients):
            raise AssertionError('a connection does not drain through the '
                                 'run\'s ingest')
        chosen = transport.probe().chosen
        ct = clients[0].transport_tier
        tiers = {'client': 'asyncio' if ct is None else ct.backend,
                 'server': ('asyncio' if srv.transport_tier is None
                            else srv.transport_tier.backend),
                 'server ingress': ('asyncio' if srv.ingress is None
                                    else '%s x %d shards' % (
                                        srv.ingress.backend,
                                        srv.ingress.nshards))}
        if tiers['client'] != chosen or tiers['server'] != chosen:
            raise AssertionError('transport tiers %s, probe() chose %s'
                                 % (tiers, chosen))
        out['tiers'] = tiers

        await clients[0].create('/f', b'')
        await asyncio.gather(*[c.create('/f/%d' % i, b'')
                               for i, c in enumerate(clients)])
        t0 = loop.time()
        out['obs'] = await asyncio.gather(*[
            _live_workload(c, '/f/%d' % i, ZKError, CreateFlag)
            for i, c in enumerate(clients)])
        out['parity_s'] = loop.time() - t0
        step('parity workload')

        # bench.py's mixed workload on 64-byte data
        await clients[0].create('/b', b'x' * 64)
        for _ in range(5):
            await asyncio.gather(*[c.get('/b') for c in clients])
        per = max(8, LIVE_OPS_TOTAL // n)
        seqs = [0] * n

        async def timed(op, k):
            lat = []
            for _ in range(k):
                t = loop.time()
                await op()
                lat.append((loop.time() - t) * 1000.0)
            return lat

        def mk_create(c, i):
            async def run():
                seqs[i] += 1
                await c.create('/c%d-%d' % (i, seqs[i]), b'')
            return run

        ops = {}
        for name, of, k in (
                ('get', lambda c, i: lambda: c.get('/b'), per),
                ('set', lambda c, i: lambda: c.set('/b', b'y' * 64),
                 per // 2),
                ('create', mk_create, per // 4)):
            t0 = loop.time()
            lats = await asyncio.gather(*[timed(of(c, i), k)
                                          for i, c in enumerate(clients)])
            dt = loop.time() - t0
            flat = [x for lat in lats for x in lat]
            p50, p99 = _pcts(flat)
            ops[name] = {'ops_per_sec': len(flat) / dt, 'p50_ms': p50,
                         'p99_ms': p99, 'ops': len(flat)}
            step(name)
        out['ops'] = ops

        # the watch fan-out: arming a dataChanged watch on an existing
        # node emits once (the arming read); wait those out, then one set
        fired = [0] * n
        for i, c in enumerate(clients):
            c.watcher('/b').on('dataChanged', lambda *a, _i=i:
                               fired.__setitem__(_i, fired[_i] + 1))
        await _until(lambda: all(fired), 'every arm-time emit')
        await asyncio.sleep(0.2)
        fired[:] = [0] * n
        t0 = loop.time()
        await clients[0].set('/b', b'z' * 64)
        await _until(lambda: all(fired), 'the fan-out to every watcher')
        out['fanout_ms'] = (loop.time() - t0) * 1000.0
        await asyncio.sleep(0.5)    # the re-arm reads land; none re-fires
        twice = [i for i, f in enumerate(fired) if f != 1]
        if twice:
            raise AssertionError('fan-out: %d watchers fired other than once '
                                 '(first: client %d, %d times)'
                                 % (len(twice), twice[0], fired[twice[0]]))
        step('fan-out')
        out['lag_s'] = lag[0]
    finally:
        monitor.cancel()
        await asyncio.gather(*[c.close() for c in clients])
        await srv.stop()
    return out


def _live_phase(W, K2, smi: str) -> dict:
    """Phase 12: 1,024 live port clients against the port's server, the
    scalar drain then the fleet ingest with host and with device
    bodies; returns each run's measurements and kernel launches."""
    import torch

    from zkstream_tpu_torch.io import ingress, transport
    from zkstream_tpu_torch.io.ingest import FleetIngest
    from zkstream_tpu_torch.utils import fdlimit

    n = LIVE_CLIENTS
    need = 2 * n + 256          # both ends of every session, plus spares
    soft, hard = fdlimit.raise_nofile(need + 256)
    err = fdlimit.headroom_error(need)
    if err:
        raise RuntimeError('phase 12 needs %d descriptors: %s' % (need, err))
    tp, ip = transport.probe(refresh=True), ingress.probe(refresh=True)
    if tp.uring and tp.chosen != 'uring' and tp.forced is None:
        raise AssertionError('io_uring answers but the tier chose %s'
                             % (tp.chosen,))
    _log('# phase 12 setup: soft/hard fd limit %d/%d; transport probe: '
         'chose %s (uring %s: %s; mmsg %s: %s; forced %s); ingress probe: '
         'chose %s (uring %s: %s; reuseport %s)' % (
             soft, hard, tp.chosen, tp.uring, tp.uring_reason, tp.mmsg,
             tp.mmsg_reason, tp.forced, ip.chosen, ip.uring,
             ip.uring_reason, ip.reuseport))
    runs: dict = {}
    for mode in ('scalar', 'host', 'device'):
        ing = None
        if mode != 'scalar':
            ing = FleetIngest(device='cuda', body_mode=mode, bypass_bytes=0,
                              warm='block', max_frames=4)
        step_s: list = []
        if ing is not None:
            _timed(ing, step_s)
        torch.cuda.synchronize()
        W.launches = K2.launches = 0
        t0 = time.perf_counter()
        with _GcPauses() as pauses:
            out = asyncio.run(_live_serve(ing, n, mode, pauses))
        wall = time.perf_counter() - t0
        out['k1'], out['k2'] = W.launches, K2.launches
        runs[mode] = out
        line = ('# phase 12 (%s) on %s: %d clients connected in %.3f s '
                '(tiers %s); parity workload %.3f s; ' % (
                    mode, smi, n, out['connect_s'], out['tiers'],
                    out['parity_s']))
        line += '; '.join(
            '%s %.1f ops/s p50 %.3f ms p99 %.3f ms (%d ops)' % (
                k, v['ops_per_sec'], v['p50_ms'], v['p99_ms'], v['ops'])
            for k, v in out['ops'].items())
        line += '; fan-out to %d watchers %.3f ms' % (n, out['fanout_ms'])
        if ing is not None:
            want_k1 = ing.ticks if mode == 'host' else 0
            want_k2 = ing.ticks if mode == 'device' else 0
            if not (ing.ticks > 0 and out['k1'] == want_k1
                    and out['k2'] == want_k2 and ing.ticks_scalar == 0
                    and ing.ticks_warming == 0 and ing.ticks_frag == 0
                    and ing.frames_routed > 0 and ing.body_fallbacks == 0):
                raise AssertionError(
                    'phase 12 (%s): ticks %d (scalar %d, warming %d, frag '
                    '%d), frames routed %d, body fallbacks %d; K1 %d, K2 %d '
                    'launches' % (mode, ing.ticks, ing.ticks_scalar,
                                  ing.ticks_warming, ing.ticks_frag,
                                  ing.frames_routed, ing.body_fallbacks,
                                  out['k1'], out['k2']))
            if out['obs'] != runs['scalar']['obs']:
                bad = [i for i, (a, b) in enumerate(
                    zip(out['obs'], runs['scalar']['obs'])) if a != b]
                raise AssertionError(
                    'phase 12 (%s): %d clients observed other than in the '
                    'scalar run; client %d: %r vs %r' % (
                        mode, len(bad), bad[0], out['obs'][bad[0]],
                        runs['scalar']['obs'][bad[0]]))
            tick_ms = ing.tick_hist.sum() / max(ing.tick_hist.count(), 1)
            out['tick_ms'] = tick_ms
            out['device_ms'] = sum(step_s) * 1e3 / max(len(step_s), 1)
            line += ('; %d device ticks = %d %s launches (%d %s), %d frames '
                     'routed, 0 scalar/warming/frag ticks, 0 body fallbacks; '
                     'mean tick %.3f ms, of which the device half %.3f ms; '
                     'every observation equal to the scalar run\'s' % (
                         ing.ticks, ing.ticks,
                         'K1' if mode == 'host' else 'K2',
                         out['k2'] if mode == 'host' else out['k1'],
                         'K2' if mode == 'host' else 'K1',
                         ing.frames_routed, tick_ms, out['device_ms']))
        _log(line + '; every fan-out watcher fired once; longest loop lag '
             '%.3f s; collector pauses %.3f s (longest %.3f s); run wall '
             '%.2f s' % (out['lag_s'], pauses.s, pauses.max, wall))
        out['gc_s'], out['wall_s'] = pauses.s, wall
    return runs


# -- phase 13: the ensemble under a leader SIGKILL --------------------

#: The interleaved op sequence each phase-13 client runs: phase 12's
#: mixed workload (8 gets, 4 sets, 2 creates a client), with the sets on
#: the client's own node so no watcher of /b fires before the failover
ENS_SEQUENCE = ('get', 'get', 'set', 'create', 'get', 'get', 'set',
                'get', 'get', 'set', 'create', 'get', 'get', 'set')
#: first seeds from 0 whose plan drives a batch-regime FleetIngest
#: (``FaultPlan.randomized(seed).ingest_mode == 'batch'``)
ENS_CAMPAIGN_SEEDS = 8
ENS_CONCURRENT_SEEDS = 4


async def _ens_op(c, kind: str, i: int, k: int, h, rec: list, errs: list,
                  kill: list, AMBIGUOUS, ZKError, ZKProtocolError) -> None:
    """One workload op of client ``i`` (its ``k``-th), retried through
    the failover until it completes: the latency is from its first
    attempt to its success, what the user waits.  Only the failover's
    outcome-unknown errors (``AMBIGUOUS``: a lost connection, which is
    also what ``ZKNotConnectedError`` carries, a ping or deadline
    timeout) and ``EPOCH_FENCED`` are retried, and only once the leader
    has been killed (``kill[0]``, the loop time of the SIGKILL): any
    other error, and any error at all before the kill, is raised.  Each
    retried error goes into ``errs`` as (loop time, code).  Every
    attempt that fails outcome-unknown is recorded as ambiguous in the
    client's history ``h``; a success is recorded as acked."""
    sid = c.session.session_id
    own = '/f/%d' % (i,)
    path = '%s/c%d' % (own, k) if kind == 'create' else own
    data = b'v%d' % (k,)
    loop = asyncio.get_running_loop()
    t0 = loop.time()
    tried = False
    while True:
        try:
            if kind == 'get':
                await asyncio.wait_for(c.get('/b'), LIVE_TIMEOUT)
            elif kind == 'set':
                stat = await asyncio.wait_for(c.set(own, data),
                                              LIVE_TIMEOUT)
                h.op('SET_DATA', own, 'ok', zxid=stat.mzxid,
                     session_id=sid)
                h.acked_set(own, k, sid, zxid=stat.mzxid)
            else:
                await asyncio.wait_for(c.create(path, b''), LIVE_TIMEOUT)
                h.acked_create(path, b'', sid)
            break
        except (ZKError, ZKProtocolError) as e:
            if kind == 'create' and e.code == 'NODE_EXISTS' and tried:
                # the earlier, outcome-unknown attempt applied
                h.acked_create(path, b'', sid)
                break
            now = loop.time()
            if kill[0] is None or now < kill[0]:
                raise AssertionError(
                    'phase 13: client %d %s failed before the leader was '
                    'killed: %r' % (i, kind, e)) from e
            fenced = e.code == 'EPOCH_FENCED'
            if e.code not in AMBIGUOUS and not fenced:
                raise
            errs.append((now, e.code))
            # a fenced write was never applied; the rest may have been
            if kind != 'get' and not fenced:
                h.ambiguous(kind, path, session_id=sid)
        tried = True
        if c.is_connected():
            await asyncio.sleep(0.05)
        else:
            # wait for the redial rather than spin 1,024 failing ops on
            # the loop that must carry the reconnections
            await c.wait_connected(timeout=LIVE_TIMEOUT, fail_fast=False)
    rec.append((kind, loop.time(), (loop.time() - t0) * 1000.0))


def _ens_ops(recs: list, t0: float, t_kill: float, t_end: float) -> dict:
    """ops/s and p50/p99 by kind, before and after the kill (an op is on
    the side its completion fell)."""
    out = {}
    for side, after, dt in (('before', False, t_kill - t0),
                            ('after', True, t_end - t_kill)):
        for kind in ('get', 'set', 'create'):
            lat = [ms for k, t, ms in recs
                   if k == kind and (t >= t_kill) == after]
            p50, p99 = _pcts(lat) if lat else (float('nan'),) * 2
            out['%s %s' % (kind, side)] = {
                'ops_per_sec': len(lat) / max(dt, 1e-9), 'p50_ms': p50,
                'p99_ms': p99, 'ops': len(lat)}
    return out


async def _ensemble_serve(ingest, n: int, what: str, pauses,
                          cli_check: bool) -> dict:
    """One phase-13 run: a fresh three-process port ensemble (election
    and quorum commit on, a WAL each), ``n`` port clients through
    ``ingest`` (None: the scalar drain) spread across the members, the
    mixed workload with the elected leader SIGKILLed halfway, the
    post-failover fan-out, and the gates."""
    import shutil
    import tempfile

    from zkstream_tpu_torch import Client
    from zkstream_tpu_torch.io.backoff import BackoffPolicy
    from zkstream_tpu_torch.io.invariants import (AMBIGUOUS_CODES, History,
                                                  check_history)
    from zkstream_tpu_torch.protocol.errors import ZKError, ZKProtocolError
    from zkstream_tpu_torch.server.election import (ProcMember, _scrape_mntr,
                                                    allocate_ports,
                                                    find_leader)
    from zkstream_tpu_torch.server.persist import recover_state
    from zkstream_tpu_torch.server.store import ZKDatabase

    loop = asyncio.get_running_loop()
    out: dict = {}
    lag = [0.0]
    t_run = loop.time()

    def step(name: str) -> None:
        _log('# phase 13 (%s) %s done at %.2f s: longest loop lag %.3f s, '
             'collector pauses %.3f s (longest %.3f s)'
             % (what, name, loop.time() - t_run, lag[0], pauses.s,
                pauses.max))

    root = tempfile.mkdtemp(prefix='zkchip13-')
    ports = allocate_ports(6)
    fleet = [ProcMember(i, os.path.join(root, 'm%d' % i), ports[2 * i],
                        ports[2 * i + 1]) for i in range(3)]
    monitor = loop.create_task(_lag_monitor(lag))
    clients: list = []
    try:
        t0 = loop.time()
        for m in fleet:
            m.spawn(fleet)
        for m in fleet:
            await m.wait_ready()
        leader, epoch = await find_leader(fleet, min_epoch=1)
        out['spawn_s'] = loop.time() - t0
        step('spawn (leader %d at epoch %d)' % (leader, epoch))
        if ingest is not None:
            bp = 8
            while bp <= n:
                for nb in (None, 512, 1024):
                    await ingest.prewarm(bp, nb)
                bp *= 2
        addrs = [('127.0.0.1', m.client_port) for m in fleet]
        t0 = loop.time()
        # the process tier's redial delays (election.py
        # run_process_schedule), in monitor mode too: a session that
        # lost its member redials within a second, where the defaults
        # back off towards 30 s while the survivors elect.  A dial is
        # given 10 s, not 2: a dead member refuses at once, and a live
        # one answers behind this loop's lags of several seconds
        redial = BackoffPolicy(timeout=10000, retries=4, delay=100,
                               cap=1000)
        clients = [Client(servers=addrs[i % 3:] + addrs[:i % 3],
                          shuffle_backends=False,
                          session_timeout=LIVE_SESSION_TIMEOUT_MS,
                          ingest=ingest, use_native_codec=True,
                          connect_policy=redial, default_policy=redial)
                   for i in range(n)]
        expired = [0] * n
        # connection edges: a session that detaches once the fleet is
        # connected and before the kill fails the run (nothing but the
        # kill may drop a connection); after the kill, who lost its
        # member, and when it was attached again
        kill = [None]
        armed = [False]
        early: list = []
        lost = [0] * n
        back = [0.0] * n

        def on_disconnect(i):
            if kill[0] is not None:
                lost[i] = 1
            elif armed[0]:
                early.append(i)

        def on_connect(i):
            if kill[0] is not None:
                back[i] = loop.time()
        for i, c in enumerate(clients):
            c.on('expire', lambda _i=i: expired.__setitem__(_i, 1))
            c.on('disconnect', lambda _i=i: on_disconnect(_i))
            c.on('connect', lambda _i=i: on_connect(_i))
            c.start()
        # fail_fast=False: a client whose first dials time out keeps
        # dialing (monitor mode) rather than fail the wait
        await asyncio.gather(*[c.wait_connected(timeout=LIVE_TIMEOUT,
                                                fail_fast=False)
                               for c in clients])
        out['connect_s'] = loop.time() - t0
        armed[0] = True
        if any(c.current_connection().ingest is not ingest
               for c in clients):
            raise AssertionError('a connection does not drain through the '
                                 'run\'s ingest')
        sids = [c.session.session_id for c in clients]
        on_leader = sum(c.current_connection().backend.port
                        == fleet[leader].client_port for c in clients)
        step('connect (%d sessions on the leader)' % (on_leader,))

        # 1. every client writes its own /f/<i> and watches /b
        hs = [History() for _ in range(n)]
        await clients[0].create('/f', b'')
        await clients[0].create('/b', b'x' * 64)
        made = await asyncio.gather(*[c.create('/f/%d' % (i,), b'')
                                      for i, c in enumerate(clients)])
        for i, p in enumerate(made):
            hs[i].acked_create(p, b'', sids[i])
        # arming a dataChanged watch on an existing node emits once (the
        # arming read): wait those out; from then on a fire is a change
        fired = [0] * n
        target = [loop.create_future()]

        def on_fire(i, data, stat):
            fired[i] += 1
            hs[i].watch_fire('/b', 'dataChanged', stat.mzxid)
            if all(fired) and not target[0].done():
                target[0].set_result(None)
        for i, c in enumerate(clients):
            c.watcher('/b').on('dataChanged',
                               lambda d, s, _i=i: on_fire(_i, d, s))
        await asyncio.wait_for(target[0], LIVE_TIMEOUT)
        await asyncio.sleep(0.2)
        fired[:] = [0] * n
        for h in hs:      # the arming reads are not changes of /b
            h.records[:] = [r for r in h.records if r['kind'] != 'watch']
        # the fleet's long-lived state (clients, sessions, watchers) out
        # of the collector's reach from here, as a serving process would
        # freeze its heap after start-up (phase 12 leaves it unfrozen);
        # main() unfreezes after the phase
        gc.collect()
        gc.freeze()
        step('create + watch')

        # 2-4. the mixed workload, the leader SIGKILLed halfway
        recs: list = []
        errs: list = []
        half = n * len(ENS_SEQUENCE) // 2
        halfway = loop.create_future()
        done = [0]

        async def client_run(i, c):
            for k, kind in enumerate(ENS_SEQUENCE):
                await _ens_op(c, kind, i, k, hs[i], recs, errs, kill,
                              AMBIGUOUS_CODES, ZKError, ZKProtocolError)
                done[0] += 1
                if done[0] >= half and not halfway.done():
                    halfway.set_result(None)

        t_work = loop.time()
        work = asyncio.gather(*[client_run(i, c)
                                for i, c in enumerate(clients)])
        # an op that fails before halfway ends the run with its error
        await asyncio.wait([halfway, work], timeout=LIVE_TIMEOUT,
                           return_when=asyncio.FIRST_COMPLETED)
        if work.done():
            await work
        if not halfway.done():
            raise AssertionError('phase 13 (%s): the workload did not reach '
                                 'halfway in %.0f s' % (what, LIVE_TIMEOUT))
        if early:
            raise AssertionError(
                'phase 13 (%s): %d sessions detached before the leader was '
                'killed (first: client %d)' % (what, len(early), early[0]))
        t_kill = kill[0] = loop.time()
        fleet[leader].kill()
        new_leader, new_epoch = await find_leader(
            [m for m in fleet if m.member_id != leader],
            min_epoch=epoch + 1, timeout=LIVE_TIMEOUT)
        out['elect_s'] = loop.time() - t_kill
        step('election (member %d at epoch %d)' % (new_leader, new_epoch))

        async def resumed():
            # one poller for the fleet, not one a client
            while not all(c.is_connected() and (not lost[i] or back[i])
                          for i, c in enumerate(clients)):
                await asyncio.sleep(0.02)
            return max([back[i] for i in range(n) if lost[i]]
                       or [loop.time()])
        t_back = await asyncio.wait_for(resumed(), LIVE_TIMEOUT)
        out['resume_s'] = t_back - t_kill
        out['reconnected'] = sum(lost)
        await asyncio.wait_for(work, LIVE_TIMEOUT)
        t_end = loop.time()
        out['ops'] = _ens_ops(recs, t_work, t_kill, t_end)
        # _ens_op raises on an error before the kill, so the first count
        # is 0 on every run that gets here; both are printed
        out['errors_before'] = sum(t < t_kill for t, _code in errs)
        out['errors_after'] = len(errs) - out['errors_before']
        out['error_codes'] = sorted(set(code for _t, code in errs))
        out['expired'] = sum(expired) + sum(
            c.session.session_id != s for c, s in zip(clients, sids))
        if out['expired']:
            raise AssertionError('phase 13 (%s): %d sessions expired or '
                                 'were replaced' % (what, out['expired']))
        step('workload (errors: %d before the kill, %d after it, retried: '
             '%s)' % (out['errors_before'], out['errors_after'],
                      ', '.join(out['error_codes']) or 'none'))

        # 5. one set on the new leader, fanned out to every watcher (the
        # watches re-armed on the survivors; /b has not changed since)
        await asyncio.sleep(0.5)
        if any(fired):
            raise AssertionError('phase 13 (%s): %d watchers fired before '
                                 'the post-failover set' % (what,
                                                            sum(fired)))
        fan = target[0] = loop.create_future()
        writer = Client(servers=[addrs[new_leader]],
                        session_timeout=LIVE_SESSION_TIMEOUT_MS)
        writer.start()
        try:
            await writer.wait_connected(timeout=LIVE_TIMEOUT)
            t0 = loop.time()
            await writer.set('/b', b'z' * 64)
            await asyncio.wait_for(fan, LIVE_TIMEOUT)
            out['fanout_ms'] = (loop.time() - t0) * 1000.0
            await asyncio.sleep(0.5)    # re-arm reads land; none re-fires
            twice = [i for i, f in enumerate(fired) if f != 1]
            if twice:
                raise AssertionError(
                    'phase 13 (%s) fan-out: %d watchers fired other than '
                    'once (first: client %d, %d times)' % (
                        what, len(twice), twice[0], fired[twice[0]]))
            step('fan-out')

            # every acknowledged write reads back from the new leader
            await writer.sync('/')
            want = {}
            for h in hs:
                for r in h.of_kind('ack'):
                    if r['op'] == 'create':
                        want.setdefault(r['path'], b'')
                    elif r['op'] == 'set':
                        want[r['path']] = b'v%d' % (r['index'],)
            paths = sorted(want)
            got = await asyncio.gather(*[writer.get(p) for p in paths])
            missing = [p for p, (d, _s) in zip(paths, got)
                       if bytes(d) != want[p]]
            if missing:
                raise AssertionError(
                    'phase 13 (%s): %d acknowledged writes do not read '
                    'back from the new leader (first %s: %r)' % (
                        what, len(missing), missing[0], want[missing[0]]))
            out['acked'] = len(paths)
            step('read-back of %d acknowledged writes' % (len(paths),))
        finally:
            await writer.close()

        # the fleet's histories against the new leader's recovered tree
        rec = recover_state(fleet[new_leader].wal_dir)
        rdb = ZKDatabase()
        rdb.nodes, rdb.zxid = rec.nodes, rec.zxid
        eh = History()
        eh.election(leader, epoch)
        eh.election(new_leader, new_epoch)
        viol = check_history(eh, rdb)
        for i, h in enumerate(hs):
            viol += ['client %d: %s' % (i, v) for v in check_history(h, rdb)]
        if viol:
            raise AssertionError('phase 13 (%s): check_history: %d '
                                 'violations, first %s'
                                 % (what, len(viol), viol[0]))
        step('check_history on the recovered tree')
        out['elections'] = {}
        for m in fleet:
            if m.alive():
                rows = await _scrape_mntr(m.client_port,
                                          timeout=LIVE_TIMEOUT)
                out['elections'][m.member_id] = int(
                    rows.get('zk_elections_total', -1))
        if cli_check:
            out['cli'] = await loop.run_in_executor(
                None, _cli_get, addrs[new_leader][1], want['/f/0'])
        out['lag_s'] = lag[0]
        out['leader'], out['new_leader'] = leader, new_leader
        out['on_leader'] = on_leader
    finally:
        monitor.cancel()
        t0 = loop.time()
        await asyncio.gather(*[c.close() for c in clients])
        for m in fleet:
            m.kill()
        shutil.rmtree(root, ignore_errors=True)
        out['teardown_s'] = loop.time() - t0
    return out


def _cli_get(port: int, want: bytes) -> float:
    """``python -m zkstream_tpu_torch -s <member> --codec ingest get
    /f/0`` as a subprocess (on the card, the CLI's default device): it
    must exit 0 and print the node's data.  Returns its wall seconds."""
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, '-m', 'zkstream_tpu_torch', '-s',
         '127.0.0.1:%d' % (port,), '--codec', 'ingest', 'get', '/f/0'],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, timeout=120)
    if r.returncode != 0 or r.stdout.rstrip(b'\n') != want:
        raise AssertionError('phase 13 CLI get exited %d, printed %r '
                             '(want %r); stderr %r' % (
                                 r.returncode, r.stdout, want,
                                 r.stderr[-2000:]))
    return time.perf_counter() - t0


class _IngestsMade:
    """While installed, every ``FleetIngest`` the port builds (the
    campaigns build theirs inside the schedule) is kept in ``made``.
    The hook wraps the class's own ``__init__``, so it sees every
    instance whatever module imported the class, and where."""

    def __enter__(self):
        from zkstream_tpu_torch.io.ingest import FleetIngest

        init = self._init = FleetIngest.__init__
        made = self.made = []

        def kept(ing, *a, **kw):
            init(ing, *a, **kw)
            made.append(ing)
        FleetIngest.__init__ = kept
        return self

    def __exit__(self, *exc):
        from zkstream_tpu_torch.io.ingest import FleetIngest

        FleetIngest.__init__ = self._init


def _campaigns(W, K2, smi: str, device: str = 'cuda') -> dict:
    """The seeded ensemble campaigns on the card: ``run_ensemble_schedule``
    over the first seeds whose plan drives a batch-regime ingest, and
    ``run_concurrent_schedule(clients=3)`` over the first of them."""
    from zkstream_tpu_torch.io.faults import (FaultPlan,
                                              run_concurrent_schedule,
                                              run_ensemble_schedule)

    seeds = []
    s = 0
    while len(seeds) < ENS_CAMPAIGN_SEEDS:
        if FaultPlan.randomized(s).ingest_mode == 'batch':
            seeds.append(s)
        s += 1
    out = {}
    for name, fn, ss in (
            ('run_ensemble_schedule', run_ensemble_schedule, seeds),
            ('run_concurrent_schedule(clients=3)',
             lambda seed, device: run_concurrent_schedule(
                 seed, clients=3, device=device),
             seeds[:ENS_CONCURRENT_SEEDS])):
        W.launches = K2.launches = 0
        t0 = time.perf_counter()
        with _IngestsMade() as kept:
            results = [asyncio.run(fn(seed, device=device)) for seed in ss]
        bad = [(r.seed, r.violations) for r in results if not r.ok]
        if bad:
            raise AssertionError('phase 13 %s: schedules not ok: %r'
                                 % (name, bad))
        ticks = sum(ing.ticks for ing in kept.made)
        if not kept.made or W.launches != ticks or K2.launches:
            raise AssertionError(
                'phase 13 %s: %d ingests, %d device ticks, K1 %d and K2 %d '
                'launches' % (name, len(kept.made), ticks, W.launches,
                              K2.launches))
        out[name] = {'seeds': ss, 'ticks': ticks, 'k1': W.launches,
                     'wall_s': time.perf_counter() - t0}
        _log('# phase 13 campaign %s on %s: seeds %s all ok; %d ingests, '
             '%d device ticks = %d K1 launches, 0 K2; %.2f s' % (
                 name, smi, ss, len(kept.made), ticks, W.launches,
                 out[name]['wall_s']))
    return out


def _ensemble_phase(W, K2, smi: str, device: str = 'cuda',
                    n: int = LIVE_CLIENTS) -> dict:
    """Phase 13: three runs on a fresh three-process port ensemble each
    (scalar drain, host bodies through K1, device bodies through K2),
    the leader SIGKILLed mid-workload, then the seeded campaigns."""
    import torch

    from zkstream_tpu_torch.io.ingest import FleetIngest

    t_phase = time.perf_counter()
    runs: dict = {}
    for mode in ('scalar', 'host', 'device'):
        ing = None
        if mode != 'scalar':
            ing = FleetIngest(device=device, body_mode=mode,
                              bypass_bytes=0, warm='block', max_frames=4)
        step_s: list = []
        if ing is not None:
            _timed(ing, step_s)
        if device == 'cuda':
            torch.cuda.synchronize()
        W.launches = K2.launches = 0
        t0 = time.perf_counter()
        with _GcPauses() as pauses:
            out = asyncio.run(_ensemble_serve(ing, n, mode, pauses,
                                              cli_check=mode == 'device'))
        wall = time.perf_counter() - t0
        out['k1'], out['k2'] = W.launches, K2.launches
        runs[mode] = out
        line = ('# phase 13 (%s) on %s: 3 member processes up and a leader '
                'in %.3f s; %d clients connected in %.3f s (%d on the '
                'leader, member %d); leader SIGKILLed halfway: elected '
                'member %d in %.3f s, the %d sessions that lost their '
                'member back with their old ids in %.3f s, %d expired; ' % (
                    mode, smi, out['spawn_s'], n, out['connect_s'],
                    out['on_leader'], out['leader'], out['new_leader'],
                    out['elect_s'], out['reconnected'], out['resume_s'],
                    out['expired']))
        line += '; '.join(
            '%s %.1f ops/s p50 %.3f ms p99 %.3f ms (%d ops)' % (
                k, v['ops_per_sec'], v['p50_ms'], v['p99_ms'], v['ops'])
            for k, v in out['ops'].items())
        line += ('; op errors before the kill %d (0 detaches), after it %d '
                 '(retried: %s); post-failover fan-out to %d watchers %.3f '
                 'ms, each fired once; %d acknowledged writes read back '
                 'from the new leader; check_history clean on %d client '
                 'histories against its recovered tree; zk_elections_total '
                 'by member %s' % (
                     out['errors_before'], out['errors_after'],
                     ', '.join(out['error_codes']) or 'none', n,
                     out['fanout_ms'], out['acked'], n, out['elections']))
        if ing is not None:
            want_k1 = ing.ticks if mode == 'host' else 0
            want_k2 = ing.ticks if mode == 'device' else 0
            if not (ing.ticks > 0 and out['k1'] == want_k1
                    and out['k2'] == want_k2 and ing.frames_routed > 0
                    and ing.body_fallbacks == 0):
                raise AssertionError(
                    'phase 13 (%s): ticks %d (scalar %d, warming %d, frag '
                    '%d), frames routed %d, body fallbacks %d; K1 %d, K2 %d '
                    'launches' % (mode, ing.ticks, ing.ticks_scalar,
                                  ing.ticks_warming, ing.ticks_frag,
                                  ing.frames_routed, ing.body_fallbacks,
                                  out['k1'], out['k2']))
            out['tick_ms'] = (ing.tick_hist.sum()
                              / max(ing.tick_hist.count(), 1))
            out['device_ms'] = sum(step_s) * 1e3 / max(len(step_s), 1)
            line += ('; %d device ticks = %d %s launches (0 %s), %d frames '
                     'routed, 0 body fallbacks; mean tick %.3f ms, of which '
                     'the device half %.3f ms' % (
                         ing.ticks, ing.ticks,
                         'K1' if mode == 'host' else 'K2',
                         'K2' if mode == 'host' else 'K1',
                         ing.frames_routed, out['tick_ms'],
                         out['device_ms']))
        if 'cli' in out:
            line += ('; `python -m zkstream_tpu_torch --codec ingest get '
                     '/f/0` exited 0 in %.2f s' % (out['cli'],))
        _log(line + '; longest loop lag %.3f s; collector pauses %.3f s; '
             'teardown %.2f s; run wall %.2f s' % (
                 out['lag_s'], pauses.s, out['teardown_s'], wall))
        out['wall_s'] = wall
    camp = _campaigns(W, K2, smi, device)
    _log('# phase 13 wall %.2f s' % (time.perf_counter() - t_phase))
    return {'runs': runs, 'campaigns': camp}


# -- phase 14: the port's bench and the C load generator ---------------

#: Sessions of phase 14's load-generator run, and its time limit (s).
LG_SESSIONS = 1000
LG_COUNT = 4
LG_TIMEOUT = 120.0


def _bench_flagship(W, K2, bench, smi: str, device: str) -> dict:
    """Phase 14a: the bench's flagship in-process at its own corpus
    (``bench._fleet()``, B x 64 frames, seed 42): the scalar and C
    baselines, ``bench_tensor`` (K1 and K2 launches counted from 0 just
    before it) and its three gates.  Prints the bench's three metric
    lines."""
    import torch

    t0 = time.perf_counter()
    buf, lens, streams, slots = bench._fleet()
    t_fleet = time.perf_counter() - t0
    t0 = time.perf_counter()
    scalar = bench.bench_scalar(streams)
    scalar_full, pkts = bench.bench_scalar_full(streams, slots)
    ext_full = bench.bench_ext_full(streams, slots)
    if ext_full is None:
        raise RuntimeError('phase 14: the C-extension codec did not build')
    t_base = time.perf_counter() - t0
    dev = torch.device(device)
    if device == 'cuda':
        torch.cuda.synchronize()
    calls: dict = {}
    W.launches = K2.launches = 0
    t0 = time.perf_counter()
    tick, full, deployed = bench.bench_tensor(buf, lens, streams, pkts,
                                              slots, device=dev,
                                              calls=calls)
    t_tensor = time.perf_counter() - t0
    k1, k2 = W.launches, K2.launches
    want = ((calls['tick'], calls['full'] + calls['full-deployed'])
            if device == 'cuda' else (0, 0))
    if (k1, k2) != want:
        raise AssertionError('phase 14: bench_tensor launched K1 %d and K2 '
                             '%d times; its candidates made %r calls'
                             % (k1, k2, calls))
    lines = bench.metric_lines(tick, full, deployed, scalar, scalar_full,
                               dict(bench._card(dev), backend=dev.type))
    for line in lines:
        print(json.dumps(line), flush=True)
    parts = (_flagship_parts(W, K2, bench, buf, lens) if device == 'cuda'
             else {})
    _log('# phase 14 bench flagship on %s: corpus %d x %d (%.1f MiB) built '
         'in %.2f s; baselines %.2f s: scalar tick %.2f MiB/s, scalar full '
         'decode %.2f MiB/s, C-extension full decode %.2f MiB/s; '
         'bench_tensor %.2f s: tick (K1) %.2f MiB/s = %.3fx scalar, toy '
         'full decode (K2) %.2f MiB/s = %.3fx, deployed full decode (K2 + '
         'body parse) %.2f MiB/s = %.3fx (%.3fx the C extension); calls %s; '
         'launches K1 %d, K2 %d; every gate passed'
         % (smi, buf.shape[0], buf.shape[1], buf.nbytes / 2**20, t_fleet,
            t_base, scalar, scalar_full, ext_full, t_tensor, tick,
            tick / scalar, full, full / scalar_full, deployed,
            deployed / scalar_full, deployed / ext_full, calls, k1, k2))
    if parts:
        _log('# phase 14 where a flagship call goes on %s (ms, after the '
             'counted run: wrapper calls back to back / replays of the part '
             'as its own program): %s'
             % (smi, ', '.join('%s %.4f / %.4f' % (k, *v)
                               for k, v in parts.items())))
    return {'k1': k1, 'k2': k2, 'calls': calls, 'lines': lines,
            'parts_ms': parts,
            'scalar': scalar, 'scalar_full': scalar_full,
            'ext_full': ext_full}


def _flagship_parts(W, K2, bench, buf, lens) -> dict:
    """The mean ms of each part of the bench's three candidates at its
    corpus, each part timed alone (CUDA events around 20 calls back to
    back): K1, the tick's torch reductions, K2 and its unpack at both
    widths, and the two body parses; ``{part: (wrapper calls, replays of
    the part as its own program)}``."""
    import torch

    from zkstream_tpu_torch.ops import pipeline as P
    from zkstream_tpu_torch.ops import replies as R
    from zkstream_tpu_torch.ops import tick_graph as TG

    db, dl = P.batch_to_device(buf, lens, 'cuda')
    F = bench.FRAMES
    r = W.wire_scan(db, dl, F)
    st16, gd16 = P.wire_full_decode(db, dl, F, 16)
    st, gd = P.wire_full_decode(db, dl, F, bench.DEP_DATA)
    parts = {
        'K1 wire_scan': lambda: W.wire_scan(db, dl, F),
        'tick reductions (_stats_from_scan)':
            lambda: P._stats_from_scan(r),
        'K2 full_scan max_data=16': lambda: K2.full_scan(db, dl, F, 16),
        'wire_full_decode max_data=16 (K2 + unpack)':
            lambda: P.wire_full_decode(db, dl, F, 16),
        'parse_reply_bodies toy':
            lambda: R.parse_reply_bodies(db, st16.starts, st16.sizes,
                                         max_data=16, max_path=8,
                                         getdata=gd16),
        'K2 full_scan max_data=256':
            lambda: K2.full_scan(db, dl, F, bench.DEP_DATA),
        'wire_full_decode max_data=256 (K2 + unpack)':
            lambda: P.wire_full_decode(db, dl, F, bench.DEP_DATA),
        'parse_reply_bodies deployed':
            lambda: R.parse_reply_bodies(db, st.starts, st.sizes,
                                         max_data=bench.DEP_DATA,
                                         max_path=bench.DEP_PATH,
                                         getdata=gd),
        'parse_list_bodies deployed':
            lambda: R.parse_list_bodies(
                db, st.starts, st.sizes, max_children=bench.DEP_CHILDREN,
                max_name=bench.DEP_NAME, max_acls=bench.DEP_ACLS,
                max_scheme=bench.DEP_SCHEME, max_id=bench.DEP_ID),
    }
    out = {}
    with TG.recording():
        for name, fn in parts.items():
            fn()
            run = TG.Program(fn, db.device).entry().run
            out[name] = (_time_ms(torch, fn, 20), _time_ms(torch, run, 20))
            del run
    return out


def _bench_client_ops(W, K2, bench, smi: str, device: str) -> dict:
    """Phase 14b: the bench's client-ops cells at ``CLIENT_SCALES``, one
    run per scale and codec mode, the ingest arm on ``device``; K1's
    launches (from 0 before each ingest run) must equal the arm's device
    ticks, K2 must not launch."""
    import torch

    cells = {}
    k1 = 0
    for n in bench.CLIENT_SCALES:
        for mode in ('python', 'native', 'ingest'):
            if device == 'cuda':
                torch.cuda.synchronize()
            W.launches = K2.launches = 0
            r = asyncio.run(bench._client_ops_run(mode, n, device=device))
            if mode == 'ingest':
                want = r['ingest_ticks'] if device == 'cuda' else 0
                if (W.launches, K2.launches) != (want, 0):
                    raise AssertionError(
                        'phase 14 client ops at %d: K1 %d and K2 %d '
                        'launches for %d device ticks'
                        % (n, W.launches, K2.launches, r['ingest_ticks']))
                if r['ingest_ticks'] == 0:
                    raise AssertionError('phase 14 client ops at %d: the '
                                         'ingest arm took no device tick'
                                         % (n,))
                k1 += W.launches
            cells[(n, mode)] = r
        _log('# phase 14 client ops at %d clients on %s: get / set / create '
             'ops/s %s; ingest arm: %d device ticks (warming %d, scalar %d) '
             '= K1 launches' % (
                 n, smi, ', '.join('%s %s / %s / %s' % (
                     m, cells[(n, m)]['get']['ops_per_sec'],
                     cells[(n, m)]['set']['ops_per_sec'],
                     cells[(n, m)]['create']['ops_per_sec'])
                     for m in ('python', 'native', 'ingest')),
                 cells[(n, 'ingest')]['ingest_ticks'],
                 cells[(n, 'ingest')]['ingest_warming_ticks'],
                 cells[(n, 'ingest')]['ingest_scalar_ticks']))
    return {'k1': k1, 'cells': cells}


async def _loadgen_parity(lg, sessions: int, count: int) -> dict:
    """A count-mode ``zkloadgen`` run of ``sessions`` sessions at its
    default thread count against the port's ``ZKServer``, bracketed by a
    port ``Client``'s writes, as the load generator's parity test does:
    its op counts must reconcile with the server's zxid advance, and its
    fan-out SET must fire the watch the Python client armed."""
    from zkstream_tpu_torch import Client
    from zkstream_tpu_torch.server import ZKServer

    srv = await ZKServer().start()
    c = Client(servers=[('127.0.0.1', srv.port)], shuffle_backends=False,
               session_timeout=30000)
    c.start()
    proc = None
    try:
        await c.wait_connected(timeout=10)
        await c.create('/parity', b'seed')
        fired = asyncio.Event()
        c.watcher('/parity').on('dataChanged', lambda *a: fired.set())
        await asyncio.sleep(0.05)     # let the watch arm land
        before = (await c.set('/parity', b'a')).mzxid
        cmd = lg.argv([('127.0.0.1', srv.port)], sessions, count=count,
                      mix='get=50,set=50', path='/parity',
                      ensure_path=False, arm_watch=True, fanout_sets=2,
                      pipeline=4, close_sessions=True)
        t0 = time.perf_counter()
        proc = await asyncio.create_subprocess_exec(
            *cmd, stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.PIPE)
        out, err = await asyncio.wait_for(proc.communicate(), LG_TIMEOUT)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError('phase 14: zkloadgen exited %d: %r %r'
                                 % (proc.returncode, out[-2000:],
                                    err[-2000:]))
        s = json.loads(out.decode().strip().splitlines()[-1])
        after = (await c.set('/parity', b'b')).mzxid
        ops = s['ops']
        writes = ops['SET_DATA']['count'] - ops['SET_DATA']['errors']
        checks = {
            'threads >= 2': s['threads'] >= 2,
            'every session connected': s['connected'] == sessions,
            'mix ops = sessions x count + fan-out rounds':
                ops['GET_DATA']['count'] + ops['SET_DATA']['count']
                == sessions * count + s['fanout']['rounds'],
            'no errors': s['errors'] == {'connect': 0, 'io': 0, 'proto': 0},
            'no zxid-floor violation': s['zxid']['floor_violations'] == 0,
            'zxid advance = acked writes + 1': after - before == writes + 1,
            'acked-write max zxid inside the bracket':
                before < s['zxid']['acked_write_max_zxid'] < after,
            'fan-out delivered = expected':
                s['fanout']['rounds'] == 2
                and s['fanout']['delivered'] == s['fanout']['expected'],
        }
        await asyncio.wait_for(fired.wait(), 5)
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise AssertionError('phase 14 zkloadgen: %s; summary %s'
                                 % (failed, json.dumps(s)))
        return {'summary': s, 'wall_s': wall, 'zxid_advance': after - before,
                'writes': writes}
    finally:
        if proc is not None and proc.returncode is None:
            proc.kill()
            await proc.wait()
        try:
            await asyncio.wait_for(c.close(), 5)
        except Exception:
            c.pool.stop()
        await srv.stop()


def _bench_phase(W, K2, smi: str, device: str = 'cuda') -> dict:
    """Phase 14: the port's bench (its flagship and client-ops cells) and
    one 1,000-session run of the port's C load generator."""
    from zkstream_tpu_torch import bench
    from zkstream_tpu_torch.utils import loadgen as lg
    from zkstream_tpu_torch.utils import native as N

    t_phase = time.perf_counter()
    flag = _bench_flagship(W, K2, bench, smi, device)
    t0 = time.perf_counter()
    ops = _bench_client_ops(W, K2, bench, smi, device)
    t_ops = time.perf_counter() - t0
    t0 = time.perf_counter()
    binary = N.build_loadgen()
    if binary is None:
        raise RuntimeError('phase 14: csrc/loadgen.c did not build')
    t_build = time.perf_counter() - t0
    lgr = asyncio.run(_loadgen_parity(lg, LG_SESSIONS, LG_COUNT))
    s = lgr['summary']
    _log('# phase 14 zkloadgen %s (built in %.2f s): %d sessions on %d '
         'threads against the port\'s ZKServer, exit 0 in %.2f s; handshake '
         'wall %s s; %d gets + %d sets (%d fan-out rounds, %d/%d delivered) '
         '= %d x %d + 2; zxid advance %d = %d acked writes + 1; client ops '
         'cells %.2f s; phase wall %.2f s'
         % (binary, t_build, s['connected'], s['threads'], lgr['wall_s'],
            s['handshake'].get('wall_s'),
            s['ops']['GET_DATA']['count'], s['ops']['SET_DATA']['count'],
            s['fanout']['rounds'], s['fanout']['delivered'],
            s['fanout']['expected'], LG_SESSIONS, LG_COUNT,
            lgr['zxid_advance'], lgr['writes'], t_ops,
            time.perf_counter() - t_phase))
    return {'flagship': flag, 'client_ops': ops, 'loadgen': lgr}


# -- phase 15: the port's measuring tools -----------------------------

#: Phase 15's sweep cells: fleet sizes and modes (one round, get).
TOOLS_CONNS = (32, 256, 1024)
TOOLS_MODES = ('native', 'ingest', 'ingest-auto', 'ingest-py-dev')


#: Phase 15's routing cells, ``ingest-auto`` gets at the shipped
#: constants: (active clients, sessions in all, frames a stream).  One
#: well below ``FleetIngest.BYPASS_BYTES`` a tick and one well above it
#: (at least 2x from it in the H100 sweep's medians), and a fleet of
#: 1,024 sessions with 64 active, its fill well under ``FRAG_ENTER``
#: (PERF.md section 5, "Crossover on the H100, graphed ticks").
TOOLS_ROUTING = {'below': (32, 32, 16), 'above': (512, 512, 16),
                 'frag': (64, 1024, 4)}
#: the least share of the 'above' cell's routed ticks on the device:
#: its scalar ticks are the first three or four, while the byte average
#: climbs past 1.25 x the threshold (the H100 sweep: 3-4 of 19-24
#: ticks, 0.833-0.870 on the device)
TOOLS_ABOVE_DEVICE = 0.75


def _tools_cell(SC, mode: str, n: int, device, smi: str, want: dict,
                fleet: int = 0) -> dict:
    """One ``sweep_crossover`` cell of phase 15 (gets), held to its
    counts: every get and storm delivered, and its K1 (host bodies) or
    K2 (``ingest-py-dev``) launches equal to its device ticks, which are
    added to ``want``."""
    t0 = time.perf_counter()
    idle = max(0, fleet - n)
    r = asyncio.run(SC.run_cell(mode, n, 'get', device, idle))
    g, fo = r['get'], r['fanout']
    if g['count'] != g['expected']:
        raise AssertionError('phase 15 %s at %d: %d of %d gets '
                             'counted' % (mode, n, g['count'],
                                          g['expected']))
    if fo['fired'] != [n] * SC.STORMS:
        raise AssertionError('phase 15 %s at %d: storms fired %s, '
                             'not %d each' % (mode, n, fo['fired'], n))
    line = ('# phase 15 sweep %s at %d%s on %s: %.1f get ops/s (p50 '
            '%.3f, p99 %.3f ms), fan-out best %.2f ms; %.2f s'
            % (mode, n, ' (+%d idle)' % idle if idle else '', smi,
               g['ops_per_sec'], g['p50_ms'], g['p99_ms'], fo['best_ms'],
               time.perf_counter() - t0))
    ing = r.get('ingest')
    if ing is not None:
        k2_mode = mode == 'ingest-py-dev'
        got = (ing['k1_launches'], ing['k2_launches'])
        if got != ((0, ing['ticks']) if k2_mode else (ing['ticks'], 0)):
            raise AssertionError(
                'phase 15 %s at %d: K1 %d and K2 %d launches for %d '
                'device ticks' % ((mode, n) + got + (ing['ticks'],)))
        want['k2' if k2_mode else 'k1'] += ing['ticks']
        total = max(1, ing['ticks'] + ing['scalar_ticks']
                    + ing['warming_ticks'])
        ing['fill'] = ing['frames'] / total / (n + idle)
        line += ('; ticks %d device, %d scalar (%d frag), %d warming '
                 '(device %.3f, scalar %.3f, frag %.3f of ticks), '
                 '%.1f frames a device tick, %.1f bytes a tick, fill '
                 '%.4f, tick p50/p99 %s ms; K1 %d, K2 %d'
                 % (ing['ticks'], ing['scalar_ticks'],
                    ing['frag_ticks'], ing['warming_ticks'],
                    ing['ticks'] / total,
                    ing['scalar_ticks'] / total,
                    ing['frag_ticks'] / total,
                    ing['frames_per_tick'], ing['bytes_per_tick'],
                    ing['fill'],
                    '%s/%s' % (ing['tick_ms']['p50'],
                               ing['tick_ms']['p99'])
                    if 'tick_ms' in ing else '-', got[0], got[1]))
    _log(line)
    return r


def _tools_routing(SC, device, smi: str, want: dict) -> None:
    """Phase 15's hold on the shipped dispatch policy: a cell below the
    byte threshold drains every tick through the scalar codec, one above
    it runs its ticks on the device (K1 launches = device ticks), and a
    fragmented fleet's ticks meet the guard."""
    from zkstream_tpu_torch.io.ingest import FleetIngest as FI

    _log('# phase 15 shipped dispatch constants: BYPASS_BYTES %d, '
         'FRAG_MIN_FLEET %d, FRAG_ENTER %.2f, FRAG_EXIT %.2f'
         % (FI.BYPASS_BYTES, FI.FRAG_MIN_FLEET, FI.FRAG_ENTER,
            FI.FRAG_EXIT))
    for what, (n, fleet, frames) in TOOLS_ROUTING.items():
        SC.MAX_FRAMES = frames
        ing = _tools_cell(SC, 'ingest-auto', n, device, smi, want,
                          fleet)['ingest']
        routed = ing['ticks'] + ing['scalar_ticks'] + ing['warming_ticks']
        if what == 'below':
            ok = ing['ticks'] == 0 and ing['scalar_ticks'] > 0
        elif what == 'above':
            ok = ing['ticks'] >= TOOLS_ABOVE_DEVICE * routed
        else:
            ok = ing['frag_ticks'] > 0
        if not ok:
            raise AssertionError(
                'phase 15 routing, %s: ingest-auto at %d of %d sessions '
                'routed %d device, %d scalar (%d frag), %d warming ticks '
                'at %.1f bytes a tick, fill %.4f'
                % (what, n, fleet, ing['ticks'], ing['scalar_ticks'],
                   ing['frag_ticks'], ing['warming_ticks'],
                   ing['bytes_per_tick'], ing['fill']))
        _log('# phase 15 routing %s: held (%.1f bytes a tick against %d, '
             'fill %.4f against %.2f)' % (what, ing['bytes_per_tick'],
                                          FI.BYPASS_BYTES, ing['fill'],
                                          FI.FRAG_ENTER))


def _tools_phase(W, K2, smi: str, device: str = 'cuda') -> dict:
    """Phase 15: the tools of ``zkstream_tpu_torch/tools/`` driven on
    ``device``, and the shipped dispatch policy held on its routing
    cells; returns the K1 and K2 launches of its ingests."""
    from zkstream_tpu_torch.tools import (bench_linearize, crossover_encode,
                                         diag_ingest, profile_hotpath)
    from zkstream_tpu_torch.tools import sweep_crossover as SC

    t_phase = time.perf_counter()
    W.launches = K2.launches = 0
    want = {'k1': 0, 'k2': 0}
    for n in TOOLS_CONNS:
        SC.MAX_FRAMES = 4 if n >= 1024 else 16
        for mode in TOOLS_MODES:
            _tools_cell(SC, mode, n, device, smi, want)
    _tools_routing(SC, device, smi, want)
    SC.MAX_FRAMES = 16
    t0 = time.perf_counter()
    d = asyncio.run(diag_ingest.run(32, 15, device))
    if d['creates'] != 32 * 15 or d['k1'] != d['device_ticks'] \
            or not d['device_ticks'] or d['run_k1'] != d['run_ticks']:
        raise AssertionError('phase 15 diag_ingest: %d creates, K1 %d for '
                             '%d device ticks (%d for %d in the whole run)'
                             % (d['creates'], d['k1'], d['device_ticks'],
                                d['run_k1'], d['run_ticks']))
    want['k1'] += d['run_ticks']
    _log('# phase 15 diag_ingest on %s: 32 clients x 15 creates, %.1f ops/s, '
         '%d device ticks, %.3f ms a tick (other than the timed parts '
         '%.3f ms in all); %.2f s' % (smi, d['ops_per_sec'],
                                      d['device_ticks'],
                                      d['tick_ms'] / d['device_ticks'],
                                      d['other_ms'],
                                      time.perf_counter() - t0))
    t0 = time.perf_counter()
    crossover_encode.main(['--conns', '128,1024', '--device', device])
    _log('# phase 15 crossover_encode at 128 and 1,024: device bytes equal '
         'to the host encoder\'s; %.2f s' % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    rc = bench_linearize.main(['--rounds', '1'])
    if rc != 0:
        raise AssertionError('phase 15 bench_linearize exited %d' % (rc,))
    t1 = time.perf_counter()
    profile_hotpath.main(['--frames', '500', '--reps', '3'])
    _log('# phase 15 bench_linearize %.2f s, profile_hotpath %.2f s'
         % (t1 - t0, time.perf_counter() - t1))
    got = {'k1': W.launches, 'k2': K2.launches}
    if got != want:
        raise AssertionError('phase 15: launches %s, device ticks %s'
                             % (got, want))
    _log('# phase 15 wall %.2f s; K1 %d and K2 %d launches = the ingests\' '
         'device ticks' % (time.perf_counter() - t_phase, got['k1'],
                           got['k2']))
    return got


# -- phase 16: the tick program as a CUDA graph --------------------------

#: Phase 16's cells: rows, frames a stream and ticks timed.  "32
#: clients" is a crossover cell's tick (32 streams, a few hundred bytes
#: each, ``max_frames`` 16); "bucket" phase 4's 1,025 whole streams in
#: the 2048 x 16384 bucket.
GRAPH_TICKS = {'32 clients': 10, 'bucket': 5}


def _pool_bytes(torch, pool) -> int:
    """Bytes the caching allocator holds in the graph memory pool
    ``pool`` (0 before the first capture)."""
    if pool is None:
        return 0
    return sum(seg['total_size'] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get('segment_pool_id', ())) == tuple(pool))


def _profile_ticks(torch, fn, n: int) -> tuple:
    """``(kernels, device ms)`` a call of ``fn`` as ``torch.profiler``
    traces the card over ``n`` calls: the kernels (copies and memsets
    not counted) and the device time of everything it ran; ``(None,
    None)`` when the trace holds no device event."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return None, None
    kernels = [e for e in dev if not e.name.startswith(('Memcpy', 'Memset'))]
    return (len(kernels) / n,
            sum(e.time_range.elapsed_us() for e in dev) / 1e3 / n)


def _host_ms(torch, fn, n: int) -> float:
    """Host time of one call of ``fn`` (its launches queued, not run),
    the mean over ``n`` calls back to back."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    ms = (time.perf_counter() - t) * 1e3 / n
    torch.cuda.synchronize()
    return ms


class _Eager:
    """Inside the block, ``ing``'s ticks on ``bk`` run the eager chain
    the graph was captured from (the tree before graphs), for
    comparison only."""

    def __init__(self, ing, bk):
        self.ing, self.bk = ing, bk

    def __enter__(self):
        self.graph, self.bk.graph = self.bk.graph, None
        self.ing._graphed = lambda: False

    def __exit__(self, *exc):
        self.bk.graph = self.graph
        del self.ing._graphed


def _graph_cell(PAR, W, K2, FleetIngest, mesh, what: str, mode: str, rows,
                frames: int, n: int, smi: str) -> dict:
    """One phase-16 cell: warm the bucket (capture included), then hold
    a replayed tick to the eager chain's on the same staged inputs, and
    time both."""
    import torch

    from zkstream_tpu_torch.ops import tick_graph as TG

    kw = dict(body_mode=mode, max_frames=frames, warm='block',
              bypass_bytes=0)
    ing = (PAR.MeshFleetIngest(mesh=mesh, **kw) if mesh is not None
           else FleetIngest(device='cuda', **kw))
    key = ing._bucket(len(rows), max(len(r) for r in rows))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bk = ing._compile(key)
    compile_ms = (time.perf_counter() - t0) * 1e3
    pool = _pool_bytes(torch, ing._graph_pool)
    shards = 1 if mesh is None else mesh.shape['dp']
    mod = K2 if mode == 'device' else W
    if bk.graph.launches != {mod.__name__: shards}:
        raise AssertionError('phase 16 %s: the graph holds %s'
                             % (what, bk.graph.launches))
    active = [(None, bytearray(r)) for r in rows]
    W.launches = K2.launches = 0
    got = [np.array(x) for x in ing._run_step(bk, active) if x is not None]
    if (W.launches, K2.launches) != ((0, shards) if mode == 'device'
                                     else (shards, 0)):
        raise AssertionError('phase 16 %s: one replay counted K1 %d, K2 %d'
                             % (what, W.launches, K2.launches))
    with _Eager(ing, bk), TG.recording():
        want = [np.array(x) for x in ing._run_step(bk, active)
                if x is not None]
    if len(got) != len(want) or not all(
            np.array_equal(a, b) for a, b in zip(want, got)):
        raise AssertionError('phase 16 %s: the replayed tick differs from '
                             'the eager chain' % (what,))
    step = ing._step_fn(mode == 'device')

    def replay():
        bk.graph.replay()

    def eager():
        step(*bk.inputs())

    out = {'shape': list(key), 'compile_ms': compile_ms,
           'warm_ms': bk.graph.warm_ms, 'capture_ms': bk.graph.capture_ms,
           'pool_bytes': pool,
           'packed': [list(a.shape) for a in got]}
    with TG.recording():
        for name, fn in (('eager', eager), ('replay', replay)):
            fn()
            kernels, dev_ms = _profile_ticks(torch, fn, min(n, 3))
            out[name] = {'kernels': kernels, 'device_ms': dev_ms,
                         'tick_ms': _time_ms(torch, fn, n),
                         'host_ms': _host_ms(torch, fn, n)}
        half = {}
        for name in ('eager', 'replay'):
            ctx = _Eager(ing, bk) if name == 'eager' else None
            if ctx is not None:
                ctx.__enter__()
            try:
                ing._run_step(bk, active)
                t = time.perf_counter()
                for _ in range(n):
                    ing._run_step(bk, active)
                half[name] = (time.perf_counter() - t) * 1e3 / n
            finally:
                if ctx is not None:
                    ctx.__exit__()
        out['eager']['device_half_ms'] = half['eager']
        out['replay']['device_half_ms'] = half['replay']
    del ing, bk
    e, r = out['eager'], out['replay']
    _log('# phase 16 %s on %s: bucket %s; replayed tick == eager chain bit '
         'for bit (packed %s); warm %.3f ms (eager warm-up run %.3f, '
         'capture %.3f), graph pool %d bytes after it; kernels a tick '
         '(torch.profiler) eager %s, replay %s; device ms a tick eager %s, '
         'replay %s; tick on the card (CUDA events, %d back to back) eager '
         '%.4f ms, replay %.4f ms; host ms a tick eager %.4f, replay %.4f; '
         'device half (stage, copies, tick, readbacks, synchronize) eager '
         '%.4f ms, replay %.4f ms'
         % (what, smi, out['shape'], out['packed'], compile_ms,
            out['warm_ms'], out['capture_ms'], pool, e['kernels'],
            r['kernels'],
            'not measured' if e['device_ms'] is None else '%.4f' % e['device_ms'],
            'not measured' if r['device_ms'] is None else '%.4f' % r['device_ms'],
            n, e['tick_ms'], r['tick_ms'], e['host_ms'], r['host_ms'],
            e['device_half_ms'], r['device_half_ms']))
    return out


def _graph_phase(PAR, W, K2, FleetIngest, dev, smi: str, streams,
                 first_frames: int) -> dict:
    """Phase 16: each body mode's tick as one CUDA graph replay against
    the eager chain it was captured from, at a 32-client tick and at the
    2048 x 16384 bucket, and at the bucket on four dp shards of the
    card."""
    t0 = time.perf_counter()
    mesh4 = PAR.make_mesh(dp=4, devices=[dev] * 4)
    shapes = {'32 clients': ([s[:first_frames] for s in streams[:32]], 16),
              'bucket': (streams, FRAMES)}
    cells = {}
    for mesh_name, mesh, names in (
            ('FleetIngest', None, ('32 clients', 'bucket')),
            ('MeshFleetIngest dp=4', mesh4, ('bucket',))):
        for shape in names:
            rows, frames = shapes[shape]
            for mode in ('host', 'device'):
                what = '%s, %s bodies, %s' % (mesh_name, mode, shape)
                cells[what] = _graph_cell(PAR, W, K2, FleetIngest, mesh,
                                          what, mode, rows, frames,
                                          GRAPH_TICKS[shape], smi)
    _log('# phase 16 on %s: %d cells, %.2f s' % (smi, len(cells),
                                                time.perf_counter() - t0))
    return cells


# -- phase 17: the JAX package's other one-card programs -----------------

#: Calls timed in each phase-17 cell (the deployed-width full decode's
#: eager chain takes ~66 ms a call).
PROGRAM_CALLS = 10


def _leaves(out) -> list:
    from torch.utils._pytree import tree_flatten
    return tree_flatten(out)[0]


def _program_cell(prog, args, per: dict, what: str, smi: str) -> dict:
    """One phase-17 cell: build ``prog``'s entry for ``args`` (its warm
    and capture), stage ``args``, hold one replay, with ``per`` launches
    counted, to the eager chain on the same staged inputs bit for bit;
    then time the eager chain, the replay and a whole call (staging,
    replay, result copies), and the staging alone."""
    import torch

    from zkstream_tpu_torch.ops import tick_graph as TG

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e = prog.entry(*args)
    compile_ms = (time.perf_counter() - t0) * 1e3
    pool = _pool_bytes(torch, prog.pool)
    if e.graph.launches != per:
        raise AssertionError('phase 17 %s: the graph holds %s, not %s'
                             % (what, e.graph.launches, per))
    e.stage(*args)
    before = {k: TG.launch_count(k) for k in per}
    got = [t.clone() for t in _leaves(e.run())]
    torch.cuda.synchronize()
    counted = {k: TG.launch_count(k) - before[k] for k in per}
    if counted != per:
        raise AssertionError('phase 17 %s: one replay counted %s'
                             % (what, counted))
    with TG.recording():
        want = _leaves(prog.fn(*e.inputs))
    if len(want) != len(got) or not all(
            torch.equal(a, b) for a, b in zip(want, got)):
        raise AssertionError('phase 17 %s: the replay differs from the '
                             'eager chain' % (what,))
    out_bytes = sum(t.numel() * t.element_size() for t in got)
    del want, got

    def eager():
        prog.fn(*e.inputs)

    def call():
        prog(*args)

    def stage():
        e.stage(*args)
    n = PROGRAM_CALLS
    out = {'compile_ms': compile_ms, 'warm_ms': e.graph.warm_ms,
           'capture_ms': e.graph.capture_ms, 'pool_bytes': pool,
           'output_bytes': out_bytes, 'launches': per}
    with TG.recording():
        for name, fn in (('eager', eager), ('replay', e.run)):
            fn()
            kernels, dev_ms = _profile_ticks(torch, fn, 3)
            out[name] = {'kernels': kernels, 'device_ms': dev_ms,
                         'ms': _time_ms(torch, fn, n),
                         'host_ms': _host_ms(torch, fn, n)}
        call()
        out['call'] = {'ms': _time_ms(torch, call, n),
                       'host_ms': _host_ms(torch, call, n)}
        out['stage_ms'] = _time_ms(torch, stage, n)
    e_, r = out['eager'], out['replay']
    _log('# phase 17 %s on %s: replay == eager chain bit for bit, %s '
         'launches a replay; warm %.3f ms (eager warm-up run %.3f, capture '
         '%.3f), graph pool %d bytes; kernels a call (torch.profiler) eager '
         '%s, replay %s; device ms a call eager %s, replay %s; on the card '
         '(CUDA events, %d back to back) eager %.4f ms, replay %.4f ms, a '
         'whole call %.4f ms (staging %.4f ms, result copies of %d bytes); '
         'host ms a call eager %.4f, replay %.4f, whole call %.4f'
         % (what, smi, per, compile_ms, out['warm_ms'], out['capture_ms'],
            pool, e_['kernels'], r['kernels'],
            'not measured' if e_['device_ms'] is None
            else '%.4f' % e_['device_ms'],
            'not measured' if r['device_ms'] is None
            else '%.4f' % r['device_ms'],
            n, e_['ms'], r['ms'], out['call']['ms'], out['stage_ms'],
            out_bytes, e_['host_ms'], r['host_ms'], out['call']['host_ms']))
    return out


def _program_phase(PAR, bench, W, K2, SW, dev, smi: str, buf, lens,
                   stream: bytes) -> dict:
    """Phase 17: the sharded step (dp=1, and dp=4 on the card), the
    roundtrip (dp=4), the sp scan (sp=1, 4) and the bench's three
    candidates, each as one CUDA graph replay against the eager chain it
    was captured from, at the bench corpus and phase 9's stream."""
    import torch

    from zkstream_tpu_torch.ops import pipeline as P
    from zkstream_tpu_torch.ops import tick_graph as TG

    t0 = time.perf_counter()
    db, dl = P.batch_to_device(buf, lens, dev)
    k1, k2 = {W.__name__: 1}, {K2.__name__: 1}
    rng = np.random.RandomState(SEED + 17)
    planes = [torch.from_numpy(rng.randint(lo, hi, (B_CORPUS, FRAMES))
                               .astype(np.int32)).to(dev)
              for lo, hi in ((1, 1 << 20), (0, 1 << 16), (0, 1 << 20),
                             (0, 1), (16, 48))]
    fns = bench.candidate_fns()

    def cells():
        for dp in (1, 4):
            mesh = PAR.make_mesh(dp=dp, devices=[dev] * dp)
            yield ('sharded_wire_step dp=%d' % dp,
                   PAR.sharded_wire_step(mesh, max_frames=FRAMES).program,
                   (db, dl), {W.__name__: dp})
        yield ('sharded_wire_roundtrip dp=4',
               PAR.sharded_wire_roundtrip(
                   PAR.make_mesh(dp=4, devices=[dev] * 4),
                   out_len=FRAMES * 52).program,
               tuple(planes), {W.__name__: 4})
        for sp in (1, 4):
            pad = torch.from_numpy(_seq_padded(stream, sp)).to(dev)
            yield ('seq_parallel_frame_scan sp=%d' % sp,
                   PAR.seq_parallel_frame_scan(PAR.make_mesh(
                       dp=1, sp=sp, devices=[dev] * sp)).program,
                   (pad, len(stream)),
                   {SW.__name__: 2 * (1 + max(sp - 1, 1) * sp),
                    SW.__name__ + ':prepare_launches': sp})
        for name in ('tick', 'full', 'full-deployed'):
            yield ('bench %s' % name,
                   TG.Program(fns[name], dev, static=(name,)), (db, dl),
                   k1 if name == 'tick' else k2)

    out = {}
    for what, prog, args, per in cells():
        out[what] = _program_cell(prog, args, per, what, smi)
        del prog, args
        torch.cuda.empty_cache()
    _log('# phase 17 on %s: %d programs, %.2f s'
         % (smi, len(out), time.perf_counter() - t0))
    return out


# -- phase 18: a bucket that fails to warm ---------------------------------

#: Phase 18's streams: bucket A takes the first LATCH_A of LATCH_STREAMS
#: corpus streams (the first two frames of each), bucket B the rest.
LATCH_STREAMS = 64
LATCH_A = 16
LATCH_TICKS = 20               # replays / scalar drains timed a mode


class _WarmErrors:
    """The port's error-level records that name a failed warm, while
    installed."""

    def __enter__(self):
        import logging

        self.records = []
        self._handler = logging.Handler(logging.ERROR)
        self._handler.emit = self.records.append
        self._logger = logging.getLogger('zkstream_tpu_torch')
        self._logger.addHandler(self._handler)
        return self

    def __exit__(self, *exc):
        self._logger.removeHandler(self._handler)

    def failed(self) -> list:
        return [r.getMessage() for r in self.records
                if 'failed to warm' in r.getMessage()]


class _NoFailedWarm:
    """A main-path phase run inside the block fails if a warm of any
    port ingest failed there (its bucket latched onto the scalar drain,
    or a kernel's error kept for its ticks to raise).  The hook wraps
    the class's own ``_try_warm``, so it sees every ingest, mesh ingests
    and those the phase builds deep inside included, and holds none of
    them."""

    def __init__(self, what: str):
        self.what = what

    def __enter__(self):
        from zkstream_tpu_torch.io.ingest import FleetIngest

        try_warm = self._try_warm = FleetIngest._try_warm
        failed = self.failed = []

        def noted(ing, key):
            out = try_warm(ing, key)
            if out is None or isinstance(out, BaseException):
                failed.append((type(ing).__name__, key, repr(out)))
            return out
        FleetIngest._try_warm = noted
        return self

    def __exit__(self, exc_type, *_exc):
        from zkstream_tpu_torch.io.ingest import FleetIngest

        FleetIngest._try_warm = self._try_warm
        if exc_type is None and self.failed:
            raise AssertionError('%s: %d warms failed (ingest, bucket, '
                                 'outcome): %s' % (
                                     self.what, len(self.failed),
                                     self.failed))


def _latch_run(FleetIngest, W, K2, PacketCodec, mode: str, rows, xmaps,
               smi: str) -> dict:
    """One phase-18 run in ``mode`` bodies: bucket A's capture fails (a
    tensor made from a host list in its step, a pageable copy), then
    bucket B warms on the same ingest; every packet is held to the
    scalar drain's."""
    import torch

    class Unsafe(FleetIngest):
        """The tick program, with a pageable copy in bucket ``bad``'s."""
        bad = None

        def _step(self, buf, lens):
            ints, byts = super()._step(buf, lens)
            if tuple(buf.shape) == self.bad:
                ints = ints + torch.tensor([0], dtype=torch.int32,
                                           device=buf.device)
            return ints, byts

    L = max(len(r) for r in rows)
    ing = Unsafe(device='cuda', body_mode=mode, bypass_bytes=0,
                 warm='block', max_frames=16,
                 min_len=1 << (L - 1).bit_length())
    mod = K2 if mode == 'device' else W
    warms: dict = {}
    try_warm = ing._try_warm

    def timed_warm(key):
        t = time.perf_counter()
        out = try_warm(key)
        warms.setdefault(key, []).append((time.perf_counter() - t) * 1e3)
        return out

    ing._try_warm = timed_warm
    key_a = ing._bucket(LATCH_A, L)
    key_b = ing._bucket(len(rows) - LATCH_A, L)
    ing.bad = key_a
    halves = [[r[:len(r) // 2], r[len(r) // 2:], b''] for r in rows]
    wants = [_scalar_drain(PacketCodec, ch, m)
             for ch, m in zip(halves, xmaps)]
    conns = [StandIn(_codec(PacketCodec, m, True)) for m in xmaps]
    out = {'buckets': {'A': list(key_a), 'B': list(key_b)}}
    torch.cuda.synchronize()
    for name, sl, key in (('A', slice(0, LATCH_A), key_a),
                          ('B', slice(LATCH_A, None), key_b)):
        n0, s0 = ing.ticks, ing.ticks_scalar
        W.launches = K2.launches = 0
        with _WarmErrors() as logged:
            asyncio.run(_serve(ing, conns[sl], halves[sl]))
        torch.cuda.synchronize()
        out[name] = {'ticks': ing.ticks - n0,
                     'ticks_scalar': ing.ticks_scalar - s0,
                     'k1': W.launches, 'k2': K2.launches,
                     'warm_ms': warms[key],
                     'errors_logged': logged.failed()}
        for i, (c, want) in enumerate(zip(conns[sl], wants[sl])):
            if c.got != want[0] or getattr(c.err, 'code', None) != want[1]:
                raise AssertionError(
                    'phase 18 %s bodies, bucket %s: connection %d got %d '
                    'packets, the scalar drain %d' % (
                        mode, name, i, len(c.got), len(want[0])))
    a, b = out['A'], out['B']
    if not (ing._exec.get(key_a, 0) is None and a['ticks'] == 0
            and a['ticks_scalar'] == 2 and a['k1'] == a['k2'] == 0
            and len(a['warm_ms']) == 1 and len(a['errors_logged']) == 1
            and repr(key_a) in a['errors_logged'][0]):
        raise AssertionError('phase 18 %s bodies: bucket A did not latch '
                             'once onto the scalar drain: %s' % (mode, a))
    bk = ing._exec[key_b]
    launched = (b['k1'], b['k2'])
    if not (bk is not None and bk.graph is not None
            and bk.graph.launches == {mod.__name__: 1}
            and b['ticks'] == 2 and b['ticks_scalar'] == 0
            and launched == ((0, 2) if mode == 'device' else (2, 0))
            and not b['errors_logged'] and len(b['warm_ms']) == 1):
        raise AssertionError('phase 18 %s bodies: bucket B after the '
                             'failed capture: %s, graph %s' % (
                                 mode, b, bk and bk.graph and
                                 bk.graph.launches))

    # then, timed: ticks of each stream's first half again (the packets
    # thrown away), scalar-drained in A and replayed in B; the mean of
    # the ingest's own tick times (tick_hist)
    async def timed(idx):
        h = ing.tick_hist
        s0, c0 = h.sum(), h.count()
        for _ in range(LATCH_TICKS):
            for i in idx:
                conns[i].codec.xid_map.update(xmaps[i])
                ing.feed(conns[i], halves[i][0])
            ing._tick()
            for i in idx:
                ing._slots[id(conns[i])][1].clear()
                conns[i].got, conns[i].err = [], None
        if h.count() - c0 != LATCH_TICKS:
            raise AssertionError('phase 18 %s bodies: %d of %d timed ticks '
                                 'routed work' % (mode, h.count() - c0,
                                                  LATCH_TICKS))
        return (h.sum() - s0) / LATCH_TICKS

    out['A']['drain_ms'] = asyncio.run(timed(range(LATCH_A)))
    out['B']['replay_tick_ms'] = asyncio.run(
        timed(range(LATCH_A, len(rows))))
    out['B']['replay_ms'] = _time_ms(torch, bk.graph.replay, LATCH_TICKS)
    _log('# phase 18 (%s bodies) on %s: bucket A %s failed its capture in '
         '%.3f ms, logged once (%r), latched: %d ticks all scalar, K1 %d, '
         'K2 %d, every packet == the scalar drain; bucket B %s captured '
         'after it on the same ingest (warm %.3f ms): %d ticks = %d %s '
         'launches, one replay a tick; a scalar-drained tick of A %.3f ms '
         '(mean of %d), a replayed tick of B %.3f ms (mean of %d), '
         'its replay %.4f ms on the card' % (
             mode, smi, key_a, a['warm_ms'][0], a['errors_logged'][0],
             a['ticks_scalar'], a['k1'], a['k2'], key_b, b['warm_ms'][0],
             b['ticks'], max(launched), 'K2' if mode == 'device' else 'K1',
             a['drain_ms'], LATCH_TICKS, b['replay_tick_ms'], LATCH_TICKS,
             b['replay_ms']))
    return out


def _latch_phase(FleetIngest, W, K2, PacketCodec, streams, xmaps,
                 first_frames: int, smi: str) -> dict:
    """Phase 18: a bucket that fails to warm latches onto the scalar
    drain, and the next bucket of the same ingest still captures and
    replays, in both body modes."""
    t0 = time.perf_counter()
    rows = [s[:first_frames] for s in streams[:LATCH_STREAMS]]
    out = {mode: _latch_run(FleetIngest, W, K2, PacketCodec, mode, rows,
                            xmaps[:LATCH_STREAMS], smi)
           for mode in ('host', 'device')}
    _log('# phase 18 on %s: %.2f s' % (smi, time.perf_counter() - t0))
    return out


# -- phase 9: the sequence-parallel scan and its chunk walk -------------

SEQ_TILES = (1 << 12, 1 << 13, 1 << 14, 1 << 15, 1 << 16)  # the sweep
SEQ_SCAN_TILES = (1 << 14, 1 << 15, 1 << 16)  # the scan's sweep
SEQ_SMALL_TILE = 16            # a tile every corpus frame spans
SEQ_RANDOM_CHUNKS = 160        # random small chunks, kernels == plain


def _seq_padded(s: bytes, sp: int):
    """``s`` zero-padded to a multiple of 4 x sp bytes, 8 bytes or more
    past its end."""
    N = -(-(len(s) + 8) // (4 * sp)) * 4 * sp
    pad = np.zeros(N, np.uint8)
    pad[:len(s)] = np.frombuffer(s, np.uint8)
    return pad


def _seq_phase(PAR, SW, dev, smi: str, stream: bytes, bad_at: int,
               frames: int) -> dict:
    """Phase 9: the sp scan of ``stream`` (``frames`` complete frames)
    and its chunk-walk kernels, held against their plain versions and
    timed.  ``bad_at`` is a frame start at which a bad-prefix stream
    is cut."""
    import torch
    from zkstream_tpu_torch.ops import tick_graph as TG
    from zkstream_tpu_torch.ops.frame_scan import (
        frame_starts_pointer_doubling)

    t0 = time.perf_counter()
    err = {'prepare': 0, 'walk': 0}

    def on_card(n: int):
        return torch.tensor(n, dtype=torch.int32, device=dev)

    def prepared(ext_d, base, end, n, tile):
        """A state whose exit map the kernel built (``n`` read on the
        card, the chunk's end ``end`` = min(base + C, n) computed there),
        held to ``tile_exits_plain`` on the same card tensor (tolerance
        0)."""
        st = SW.new_state(ext_d.shape[0] - 4, dev, tile)
        SW.seq_walk_prepare(ext_d, base, on_card(n), st)
        want = SW.tile_exits_plain(ext_d, base, end, n, tile)
        e = int((st.exits.long() - want.long()).abs().max())
        err['prepare'] = max(err['prepare'], e)
        if e:
            raise AssertionError('exit map at base %d, end %d, n %d, tile '
                                 '%d: max |d| %d from tile_exits_plain'
                                 % (base, end, n, tile, e))
        return st

    def walk_check(ext, base, end, n, entry, tile):
        """One chunk's map and walk from ``entry`` on the card ==
        ``walk_plain``; returns the exit and the frames found."""
        q, m, b = SW.walk_plain(ext, base, end, n, entry)
        ext_d = ext.to(dev)
        st = prepared(ext_d, base, end, n, tile)
        SW.seq_walk(ext_d, base, on_card(n), on_card(entry), st)
        e = max(abs(int(st.exit) - q), abs(int(st.valid) - 1),
                int(bool(st.bad) != b), int((st.mask.cpu() != m).sum()))
        err['walk'] = max(err['walk'], e)
        if e:
            raise AssertionError('chunk walk at base %d, end %d, n %d, '
                                 'entry %d, tile %d: kernel (%d, %s) vs '
                                 'plain (%d, %s), max |d| %d' % (
                                     base, end, n, entry, tile,
                                     int(st.exit), bool(st.bad), q, b, e))
        return q, int(m.sum())

    def chunk_check(pad, sp: int, n: int, tile: int) -> int:
        """Each chunk from its true entry; returns the frames found."""
        C, entry, found = len(pad) // sp, 0, 0
        for i in range(sp):
            ext = torch.from_numpy(np.concatenate(
                [pad[i * C:(i + 1) * C], pad[((i + 1) % sp) * C:][:4]]))
            entry, k = walk_check(ext, i * C, min(i * C + C, n), n, entry,
                                  tile)
            found += k
        return found

    def scan_check(s: bytes, sp: int, what: str):
        """The sp scan of ``s`` on the card (its first call: the
        program's capture and one replay) == the plain scan (CPU
        shards) == pointer doubling, with exactly one exit map a chunk
        and two walk launches a shard a ring step counted for the
        replay; each chunk's map and walk == plain."""
        pad = _seq_padded(s, sp)
        dpad = torch.from_numpy(pad).to(dev)
        scan = PAR.seq_parallel_frame_scan(
            PAR.make_mesh(dp=1, sp=sp, devices=[dev] * sp))
        torch.cuda.synchronize()
        SW.launches = SW.prepare_launches = 0
        got = scan(dpad, len(s))
        torch.cuda.synchronize()
        counts = (SW.prepare_launches, SW.launches)
        if counts != (sp, 2 * (1 + max(sp - 1, 1) * sp)):
            raise AssertionError('%s sp=%d: %d exit-map and %d walk launches'
                                 % (what, sp, *counts))
        want = PAR.seq_parallel_frame_scan(PAR.make_mesh(
            dp=1, sp=sp, devices=['cpu'] * sp))(torch.from_numpy(pad), len(s))
        dbl, dbad = frame_starts_pointer_doubling(dpad, len(s))
        for a, b in zip(want, got):
            if not torch.equal(a, b.cpu()):
                raise AssertionError('%s sp=%d: scan differs from the plain '
                                     'scan' % (what, sp))
        if not (torch.equal(dbl.cpu(), want[0])
                and bool(dbad) == bool(want[2])):
            raise AssertionError('%s sp=%d: scan differs from pointer '
                                 'doubling' % (what, sp))
        if chunk_check(pad, sp, len(s), SW.DEFAULT_TILE) != int(want[1]):
            raise AssertionError('%s sp=%d: chunk walks miscount'
                                 % (what, sp))
        return scan, dpad, got, counts

    n9 = len(stream)
    pad1 = _seq_padded(stream, 1)
    ext_np = np.concatenate([pad1, pad1[:4]])
    tp = time.perf_counter()
    q_full, mask_full, bad_full = SW.walk_plain(torch.from_numpy(ext_np), 0,
                                                n9, n9, 0)
    plain_walk_ms = (time.perf_counter() - tp) * 1e3
    if int(mask_full.sum()) != frames or bad_full or q_full != n9:
        raise AssertionError('plain walk: %d frames, bad %s, exit %d'
                             % (int(mask_full.sum()), bad_full, q_full))
    marks = {'plain walk': time.perf_counter() - t0}
    scans = {}
    for sp in (1, 4):
        scan, dpad, got, counts = scan_check(stream, sp, 'corpus')
        if int(got[1]) != frames or bool(got[2]) or not torch.equal(
                got[0].cpu()[:n9], mask_full[:n9]):
            raise AssertionError('sp=%d: the scan != the plain cursor walk'
                                 % sp)
        # one program serves every n of the stream's length: 0, a frame's
        # middle and the end, each one replay, each == pointer doubling
        for n in (0, n9 // 2 + 1, n9):
            SW.launches = SW.prepare_launches = 0
            part = scan(dpad, n)
            torch.cuda.synchronize()
            dbl, dbad = frame_starts_pointer_doubling(dpad, n)
            if (SW.prepare_launches, SW.launches) != counts or not (
                    torch.equal(dbl, part[0])
                    and bool(dbad) == bool(part[2])
                    and int(part[1]) == int(dbl.sum())):
                raise AssertionError('sp=%d at n=%d: launches %d + %d, or '
                                     'the scan != pointer doubling'
                                     % (sp, n, SW.prepare_launches,
                                        SW.launches))
        if len(scan.program.entries) != 1:
            raise AssertionError('sp=%d: %d programs for one stream length'
                                 % (sp, len(scan.program.entries)))
        entry = scan.program.entry(dpad, n9)
        entry.stage(dpad, n9)
        with TG.recording():
            scans[sp] = {'counts': counts,
                         'ms': _time_ms(torch, lambda: scan(dpad, n9), 5),
                         'replay_ms': _time_ms(torch, entry.run, 5)}
        del dpad, got, part, entry
        marks['sp=%d' % sp] = time.perf_counter() - t0
    # the scan at sp=1 and sp=4 at each tile of the sweep: wall time a
    # call (host launches included) and device time
    scan_tiles = {}
    for tile in SEQ_SCAN_TILES:
        for sp in (1, 4):
            dpad = torch.from_numpy(_seq_padded(stream, sp)).to(dev)
            scan = PAR.seq_parallel_frame_scan(
                PAR.make_mesh(dp=1, sp=sp, devices=[dev] * sp), tile)
            got = scan(dpad, n9)
            if int(got[1]) != frames or bool(got[2]) or not torch.equal(
                    got[0].cpu()[:n9], mask_full[:n9]):
                raise AssertionError('sp=%d, tile %d: the scan != the plain '
                                     'cursor walk' % (sp, tile))
            # the program's replay on the staged stream: the scan's own
            # time, no staging or result copies
            run = scan.program.entry(dpad, n9).run
            with TG.recording():
                scan_tiles[(tile, sp)] = {
                    'ms': _time_ms(torch, run, 5),
                    'device_ms': _device_ms(torch, run, 5)[0]}
            del dpad, got, scan, run
    marks['scan tile sweep'] = time.perf_counter() - t0
    # every chunk of the sp=4 cut again at a tile every frame spans
    small = chunk_check(_seq_padded(stream, 4), 4, n9, SEQ_SMALL_TILE)
    if small != frames:
        raise AssertionError('tile %d: %d frames' % (SEQ_SMALL_TILE, small))
    body = struct.pack('>iqi', 5, 42, 0) + bytes(range(256)) * 8
    span = (struct.pack('>i', len(body)) + body + struct.pack('>i', 16)
            + struct.pack('>iqi', 6, 43, 0))
    _sc, _d, sgot, _c = scan_check(span, 4, 'spanning')
    bad9 = stream[:bad_at] + struct.pack('>i', -7) + stream[:4096]
    _sc, _d, bgot, _c = scan_check(bad9, 4, 'bad prefix')
    if int(sgot[1]) != 2 or bool(sgot[2]) or int(bgot[1]) != 3 \
            or not bool(bgot[2]):
        raise AssertionError('spanning / bad-prefix streams: %d frames (bad '
                             '%s), %d frames (bad %s)' % (
                                 int(sgot[1]), bool(sgot[2]), int(bgot[1]),
                                 bool(bgot[2])))
    marks['tile %d, spanning, bad prefix' % SEQ_SMALL_TILE] = \
        time.perf_counter() - t0
    # random small chunks of the stream and of sparse junk, at small tiles,
    # from entries inside, before (a zero first byte too) and past the
    # chunk, and saturated
    rng = np.random.RandomState(SEED + 9)
    for _ in range(SEQ_RANDOM_CHUNKS):
        C = int(rng.choice([1, 7, 40, 300, 1000]))
        tile = int(rng.choice([8, 16, 64, 256]))
        if rng.rand() < 0.5:
            base = int(rng.randint(0, n9 - C))
            ext = ext_np[base:base + C + 4].copy()
            n = int(rng.choice([n9, base + rng.randint(0, C + 8)]))
        else:
            ext = np.where(rng.rand(C + 4) < 0.3, rng.randint(0, 256, C + 4),
                           0).astype(np.uint8)
            if rng.rand() < 0.3:
                ext[rng.randint(C)] = rng.choice([0x80, 0xff])
            base, n = int(rng.randint(0, 100)), int(rng.randint(0, 300))
        if rng.rand() < 0.3:
            ext[0] = 0
        # (entries before the chunk start near it: from far before, a
        # zero first byte makes the plain walk take 4 bytes a step)
        for entry in (base + int(rng.randint(0, C)), base,
                      max(base - int(rng.randint(1, 400)), 0),
                      max(base - 4, 0), base + C + 1, SW.SATURATED):
            walk_check(torch.from_numpy(ext), base, min(base + C, n), n,
                       entry, tile)
    marks['random chunks'] = check_s = time.perf_counter() - t0

    # one whole-stream walk (sp=1's chunk) at each tile: the exit map, the
    # walk (hop chain + mark), warm and with the stream evicted from L2
    ext1 = torch.from_numpy(ext_np).to(dev)
    L1 = len(pad1)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    n9d = on_card(n9)
    tiles = {}
    for tile in SEQ_TILES:
        st = SW.new_state(L1, dev, tile)

        def prep():
            SW.seq_walk_prepare(ext1, 0, n9d, st)

        def walk():
            st.valid.zero_()
            SW.seq_walk(ext1, 0, n9d, zero, st)

        def both():
            prep()
            walk()
        both()
        if not torch.equal(st.mask.cpu()[:n9], mask_full[:n9]) \
                or int(st.exit) != q_full or bool(st.bad):
            raise AssertionError('whole-stream walk at tile %d != the plain '
                                 'walk' % tile)
        tiles[tile] = {
            'prepare_ms': _time_ms(torch, prep, 5),
            'prepare_device_ms': _device_ms(torch, prep, 5)[0],
            'prepare_cold_ms': _cold_ms(torch, prep, 5),
            'walk_ms': _time_ms(torch, walk, 5),
            'walk_device_ms': _device_ms(torch, walk, 5)[0],
            'walk_cold_ms': _cold_ms(torch, walk, 5),
            'both_ms': _time_ms(torch, both, 5),
            'both_cold_ms': _cold_ms(torch, both, 5)}
        del st
    dt = tiles[SW.DEFAULT_TILE]
    tp = time.perf_counter()
    SW.tile_exits_plain(ext1, 0, n9, n9, SW.DEFAULT_TILE)
    torch.cuda.synchronize()
    plain_map_ms = (time.perf_counter() - tp) * 1e3
    geo = SW.launch_config(L1)
    del ext1
    walk_bound_ms = SW.bound_bytes(L1, frames) / HBM_BYTES_PER_S * 1e3
    stream_bound_ms = SW.stream_bound_bytes(L1) / HBM_BYTES_PER_S * 1e3
    prep_bound_ms = SW.prepare_bound_bytes(L1) / HBM_BYTES_PER_S * 1e3
    _log('# phase 9 on %s: one stream of %d bytes (%d frames); sp scan == '
         'plain scan == pointer doubling == plain cursor walk, every exit '
         'map == tile_exits_plain and every chunk walk == walk_plain '
         '(tolerance 0) at sp=1 (%d exit-map + %d walk launches) and sp=4 '
         '(%d + %d = 4 chunks + 2 x (1 + 3 ring steps x 4 shards)), at tile '
         '%d, and the sp=4 chunks\' maps and walks at tile %d; spanning '
         'frame and bad prefix at sp=4 too; %d random small chunks; one '
         'program a stream length served n = 0, a frame\'s middle and '
         'the end (== pointer doubling); checks %.1f s (done at: %s); scan '
         '%.4f ms a call (staging, replay, result copies), replay %.4f ms '
         '(sp=1); %.4f ms, replay %.4f ms (sp=4), one card' % (
             smi, n9, frames, *scans[1]['counts'], *scans[4]['counts'],
             SW.DEFAULT_TILE, SEQ_SMALL_TILE, SEQ_RANDOM_CHUNKS, check_s,
             ', '.join('%s %.1f s' % kv for kv in marks.items()),
             scans[1]['ms'], scans[1]['replay_ms'], scans[4]['ms'],
             scans[4]['replay_ms']))
    for (tile, sp), t in scan_tiles.items():
        _log('# phase 9 scan at sp=%d, tile %d on %s: %.4f ms a replay '
             '(device %.4f ms), one card' % (sp, tile, smi, t['ms'],
                                             t['device_ms']))
    for tile, t in tiles.items():
        _log('# phase 9 whole-stream walk at tile %d on %s: exit map %.4f '
             'ms (device %.4f, out of L2 %.4f), walk %.4f ms (device %.4f, '
             'out of L2 %.4f), both %.4f ms (out of L2 %.4f)' % (
                 tile, smi, t['prepare_ms'], t['prepare_device_ms'],
                 t['prepare_cold_ms'], t['walk_ms'], t['walk_device_ms'],
                 t['walk_cold_ms'], t['both_ms'], t['both_cold_ms']))
    _log('# phase 9 at tile %d: geometry %s; bounds at 3.35 TB/s: exit map '
         '%.4f ms (%d bytes), walk %.4f ms (%d bytes: 4 bytes a frame\'s '
         'prefix read and the mask written once), this design\'s floor '
         '%.4f ms (%d bytes: the stream read and the mask written once); '
         'walk %.4f ms warm, bound share %.4f; exit map + walk %.4f ms warm, '
         'bound share %.4f; plain exit map (torch, on the card) %.1f ms, '
         'plain walk on the host %.1f ms; %.2f s' % (
             SW.DEFAULT_TILE, geo, prep_bound_ms,
             SW.prepare_bound_bytes(L1), walk_bound_ms,
             SW.bound_bytes(L1, frames), stream_bound_ms,
             SW.stream_bound_bytes(L1), dt['walk_ms'],
             walk_bound_ms / dt['walk_ms'], dt['both_ms'],
             walk_bound_ms / dt['both_ms'], plain_map_ms, plain_walk_ms,
             time.perf_counter() - t0))
    return {'scans': scans, 'err': err, 'tiles': tiles, 'bytes': n9,
            'frames': frames, 'plain_walk_ms': plain_walk_ms,
            'plain_map_ms': plain_map_ms, 'walk_bound_ms': walk_bound_ms,
            'stream_bound_ms': stream_bound_ms,
            'prepare_bound_ms': prep_bound_ms, 'scan_tiles': scan_tiles}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing run', file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from zkstream_tpu_torch import corpus
    from zkstream_tpu_torch import parallel as PAR
    from zkstream_tpu_torch.entry import dryrun_multichip, entry
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
    missing = [f for f in N.EXT_TRANSPORT_CALLS if not hasattr(ext, f)]
    if missing:
        raise RuntimeError('the C extension lacks its transport calls %s'
                           % (missing,))
    _log('# phase 1 build: %.2f s; host codec tier: scanner %s (ABI %d), '
         'extension %s %s (ABI %d, transport calls %s), Python.h %s' % (
             time.perf_counter() - t0, scanner._name,
             scanner.zkwire_abi_version(), ext.__name__, ext.__file__,
             ext.abi_version(), ', '.join(N.EXT_TRANSPORT_CALLS), py_h))
    for line in W.build_report().splitlines():
        if ('registers' in line or 'spill' in line or 'smem' in line
                or 'Compiling entry' in line):
            _log('# ptxas: ' + line.strip())
    l_corpus = corpus.slot_schedule(FRAMES)[1]
    geo = K2.launch_config(B_CORPUS, l_corpus, FRAMES)
    k2_resident = K2.resident_blocks(dev, geo['warps'], geo['smem_bytes'])
    _log('# launch geometry at %d x %d: K1 %s; K2 %s (dynamic shared '
         'memory per block, not in ptxas\'s report), %d blocks resident '
         'on the card (%d an SM), so a persistent grid of %d; the chunk '
         'walk on a 16 MiB chunk: %s' % (
             B_CORPUS, l_corpus, W.launch_config(B_CORPUS), geo,
             k2_resident, k2_resident //
             torch.cuda.get_device_properties(dev).multi_processor_count,
             K2.launch_config(B_CORPUS, l_corpus, FRAMES,
                              k2_resident)['blocks'],
             SW.launch_config(1 << 24)))

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

    # -- 4. the main path: live fleet ingest.  Each main-path phase
    # fails if a warm failed in it (_NoFailedWarm) --
    rng = np.random.RandomState(SEED + 1)
    chunks = []
    for s in streams:
        a, b = sorted(rng.randint(0, len(s) + 1, 2).tolist())
        chunks.append([s[:a], s[a:b], s[b:]])
    wants = [_scalar_drain(PacketCodec, ch, m)
             for ch, m in zip(chunks, xmaps)]
    del db, dl, da, dal, dr, drl, got, want, st
    host_runs = {}
    with _NoFailedWarm('phase 4'):
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
    with _NoFailedWarm('phase 7'):
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
    from zkstream_tpu_torch.ops import tick_graph as TG
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
        st8, g8 = step(db, dl)           # the capture, then one replay
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
        with TG.recording():
            sharded[name] = (dp, W.launches,
                             _time_ms(torch, lambda: step(db, dl), 20),
                             _time_ms(torch, step.program.entry(db, dl).run,
                                      20))
    del st8, g8, ref, step
    rng8 = np.random.RandomState(SEED + 8)

    def plane(lo, hi):
        return torch.from_numpy(rng8.randint(
            lo, hi, (B_CORPUS, FRAMES)).astype(np.int32)).to(dev)
    rt = PAR.sharded_wire_roundtrip(mesh4, out_len=FRAMES * 52)
    W.launches = 0
    _rst, rtotal = rt(
        plane(1, 1 << 20), plane(0, 1 << 16), plane(0, 1 << 20),
        torch.zeros((B_CORPUS, FRAMES), dtype=torch.int32, device=dev),
        plane(16, 48))
    if int(rtotal) != B_CORPUS * FRAMES or W.launches != 4:
        raise AssertionError('roundtrip: %d of %d frames, %d K1 launches'
                             % (int(rtotal), B_CORPUS * FRAMES, W.launches))
    del _rst, db, dl, rt
    _log('# phase 8 on %s: sharded_wire_step == wire_pipeline_step_auto '
         'field for field on %d x %d, globals %s == its reductions; %s; '
         'single-device step %.4f ms; sharded_wire_roundtrip at dp=4: %d '
         'frames = B x F, 4 K1 launches a replay (%.2f s)'
         % (smi, B_CORPUS, FRAMES, want_g,
            '; '.join('%s: dp=%d, %d K1 launches a replay, %.4f ms a call '
                      '(staging, replay, result copies), %.4f ms a replay'
                      % (k, *v) for k, v in sharded.items()),
            single_ms, int(rtotal), time.perf_counter() - t0))

    # -- 9. the sequence-parallel scan and its chunk walk --
    stream = b''.join(buf_np[i, :lens_np[i]].tobytes() for i in range(FLEET))
    seq9 = _seq_phase(PAR, SW, dev, smi, stream, slots[3]['off'],
                      FLEET * FRAMES)
    del stream

    # -- 10. MeshFleetIngest, four shards on the card --
    with _NoFailedWarm('phase 10'):
        mesh_runs = {
            mode: _mesh_run(PAR, W, K2, PacketCodec, xmaps, chunks, wants,
                            mesh4, mode, smi) for mode in ('host', 'device')}

    # -- 11. MultihostFleetIngest over a one-rank NCCL group --
    with _NoFailedWarm('phase 11'):
        mh = _multihost_run(PAR, W, K2, PacketCodec, xmaps, chunks, wants,
                            dev, smi)

    # -- 12. live clients against the port's server.  The heap the
    # earlier phases leave (the corpus, its xid maps, the scalar drain's
    # packets) is the script's, not the fleet's: frozen out of the
    # collector's reach, so phase 12's collections walk only what the
    # live fleet allocates, as they would in a process serving it
    gc.collect()
    gc.freeze()
    try:
        with _NoFailedWarm('phase 12'):
            live = _live_phase(W, K2, smi)
    finally:
        gc.unfreeze()
    t0 = time.perf_counter()
    SW.launches = SW.prepare_launches = 0
    dry = dryrun_multichip(4, devices=[dev] * 4)
    torch.cuda.synchronize()
    dry_sw = (SW.prepare_launches, SW.launches)
    if dry_sw != (4, 2 * (1 + 3 * 4)):
        raise AssertionError('dryrun_multichip(4): %d exit-map and %d '
                             'chunk-walk launches' % dry_sw)
    _log('# phase 12 dryrun_multichip(4) on %s, live fleets through both '
         'mesh ingests: %s; its sp=4 scan: %d exit-map and %d chunk-walk '
         'launches; %.2f s' % (smi, dry, *dry_sw, time.perf_counter() - t0))

    # -- 13. the ensemble under a leader SIGKILL, then the campaigns --
    gc.collect()
    gc.freeze()
    try:
        with _NoFailedWarm('phase 13'):
            ens = _ensemble_phase(W, K2, smi)
    finally:
        gc.unfreeze()

    # -- 14. the port's bench and the C load generator --
    with _NoFailedWarm('phase 14'):
        bench14 = _bench_phase(W, K2, smi)

    # -- 15. the port's measuring tools --
    gc.collect()
    gc.freeze()
    try:
        with _NoFailedWarm('phase 15'):
            tools15 = _tools_phase(W, K2, smi)
    finally:
        gc.unfreeze()

    # -- 16. the tick program as a CUDA graph --
    with _NoFailedWarm('phase 16'):
        graphs16 = _graph_phase(PAR, W, K2, FleetIngest, dev, smi, streams,
                                slots[2]['off'])

    # -- 17. the JAX package's other one-card programs as CUDA graphs --
    from zkstream_tpu_torch import bench
    stream = b''.join(buf_np[i, :lens_np[i]].tobytes() for i in range(FLEET))
    programs17 = _program_phase(PAR, bench, W, K2, SW, dev, smi, buf_np,
                                lens_np, stream)
    del stream

    # -- 18. a bucket that fails to warm latches onto the scalar drain --
    latch18 = _latch_phase(FleetIngest, W, K2, PacketCodec, streams, xmaps,
                           slots[2]['off'], smi)

    # -- report --
    seq_t = seq9['tiles'][SW.DEFAULT_TILE]
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
        'tick_graph': {k: v for k, v in graphs16.items()
                       if 'host bodies' in k},
        'programs': {k: v for k, v in programs17.items()
                     if W.__name__ in v['launches']},
        'launches_by_path': {
            'phase 4 FleetIngest, C codecs': launches,
            'phase 8 sharded_wire_step dp=4 (one replay)':
                sharded['dp=4 on one card'][1],
            'phase 10 MeshFleetIngest host bodies': mesh_runs['host']['k1'],
            'phase 11 MultihostFleetIngest': mh['k1'],
            'phase 12 live Clients, FleetIngest host bodies':
                live['host']['k1'],
            'phase 13 ensemble leader SIGKILL, FleetIngest host bodies':
                ens['runs']['host']['k1'],
            'phase 13 run_ensemble_schedule campaign':
                ens['campaigns']['run_ensemble_schedule']['k1'],
            'phase 13 run_concurrent_schedule(clients=3) campaign':
                ens['campaigns']['run_concurrent_schedule(clients=3)']['k1'],
            'phase 14 bench_tensor tick candidate':
                bench14['flagship']['k1'],
            'phase 14 client-ops cells, FleetIngest host bodies':
                bench14['client_ops']['k1'],
            'phase 15 sweep_crossover ingest and ingest-auto cells, '
            'diag_ingest': tools15['k1'],
            'phase 18 bucket B after a failed capture, host bodies':
                latch18['host']['B']['k1']},
        'latched_bucket': latch18['host'],
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
        'tick_graph': {k: v for k, v in graphs16.items()
                       if 'device bodies' in k},
        'programs': {k: v for k, v in programs17.items()
                     if K2.__name__ in v['launches']},
        'launches_by_path': {
            'phase 7 FleetIngest device bodies': k2_launches,
            'phase 10 MeshFleetIngest device bodies':
                mesh_runs['device']['k2'],
            'phase 12 live Clients, FleetIngest device bodies':
                live['device']['k2'],
            'phase 13 ensemble leader SIGKILL, FleetIngest device bodies':
                ens['runs']['device']['k2'],
            'phase 14 bench_tensor full-decode candidates':
                bench14['flagship']['k2'],
            'phase 15 sweep_crossover ingest-py-dev cells': tools15['k2'],
            'phase 18 bucket B after a failed capture, device bodies':
                latch18['device']['B']['k2']},
        'latched_bucket': latch18['device'],
    }, {
        'name': 'seq_walk_prepare (the chunk walk\'s tile exit map)',
        'route': 'cuda',
        'source': 'zkstream_tpu_torch/csrc/wire_scan.cu',
        'replaces': SW.REPLACES,
        'launches': seq9['scans'][4]['counts'][0],
        'max_abs_err': seq9['err']['prepare'],
        'equal': seq9['err']['prepare'] == 0,
        'ms': seq_t['prepare_ms'],
        'device_ms': seq_t['prepare_device_ms'],
        'cold_ms': seq_t['prepare_cold_ms'],
        'plain_ms': seq9['plain_map_ms'],
        'plain_on': 'the card (torch pointer doubling)',
        'bound_ms': seq9['prepare_bound_ms'],
        'bound_by': 'bytes',
        'bound_share': seq9['prepare_bound_ms'] / seq_t['prepare_ms'],
        'library_ms': None,
        'tile': SW.DEFAULT_TILE,
        'shape': {'bytes': seq9['bytes'], 'frames': seq9['frames']},
        'launches_by_path': {
            'phase 9 sp scan, sp=1': seq9['scans'][1]['counts'][0],
            'phase 9 sp scan, sp=4': seq9['scans'][4]['counts'][0],
            'phase 12 dryrun_multichip(4)': dry_sw[0]},
    }, {
        'name': 'seq_walk (the chunk walk: hop chain + per-tile mark)',
        'route': 'cuda',
        'source': 'zkstream_tpu_torch/csrc/wire_scan.cu',
        'replaces': SW.REPLACES,
        'launches': seq9['scans'][4]['counts'][1],
        'max_abs_err': seq9['err']['walk'],
        'equal': seq9['err']['walk'] == 0,
        'ms': seq_t['walk_ms'],
        'device_ms': seq_t['walk_device_ms'],
        'cold_ms': seq_t['walk_cold_ms'],
        'with_exit_map_ms': seq_t['both_ms'],
        'with_exit_map_cold_ms': seq_t['both_cold_ms'],
        'plain_ms': seq9['plain_walk_ms'],
        'plain_on': 'host CPU (the plain walk serves CPU tensors only)',
        'bound_ms': seq9['walk_bound_ms'],
        'bound_by': 'bytes',
        'bound_share': seq9['walk_bound_ms'] / seq_t['walk_ms'],
        'with_exit_map_bound_share':
            seq9['walk_bound_ms'] / seq_t['both_ms'],
        'design_floor_ms': seq9['stream_bound_ms'],
        'design_floor_by': 'bytes: the stream read and the mask written '
                           'once, as this design\'s mark reads the stream',
        'library_ms': None,
        'tile': SW.DEFAULT_TILE,
        'shape': {'bytes': seq9['bytes'], 'frames': seq9['frames']},
        'scan_ms': {'sp=1': seq9['scans'][1]['ms'],
                    'sp=4': seq9['scans'][4]['ms']},
        'scan_replay_ms': {'sp=1': seq9['scans'][1]['replay_ms'],
                           'sp=4': seq9['scans'][4]['replay_ms']},
        'programs': {k: v for k, v in programs17.items()
                     if SW.__name__ in v['launches']},
        'scan_by_tile': {
            '%d sp=%d' % k: v for k, v in seq9['scan_tiles'].items()},
        'launches_by_path': {
            'phase 9 sp scan, sp=1': seq9['scans'][1]['counts'][1],
            'phase 9 sp scan, sp=4': seq9['scans'][4]['counts'][1],
            'phase 12 dryrun_multichip(4)': dry_sw[1]},
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
