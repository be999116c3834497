#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (zkstream_tpu_torch) on one CUDA card.

Run from the repository root on a machine with an H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. Build kernels K1 and K2 (one library from
   ``zkstream_tpu_torch/csrc/wire_scan.cu``) with nvcc for sm_90a into
   ``build/`` and print ptxas's register/spill/shared-memory report of
   each, each kernel's launch geometry at the bench shape, and the K2
   blocks the card holds at once (its persistent grid).
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
   prefix.  Every delivery must equal the scalar codec's, and K1's
   launches (counted from 0 just before this phase) must equal the
   ingest's device ticks; K2 is not launched.
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
   serves the same 1,025 connections as phase 4.  Every delivery must
   equal the scalar codec's, the bad prefix must give BAD_LENGTH, K2's
   launches (counted from 0 just before this phase) must equal the
   device ticks, K1 must not launch, and no body may fall back to the
   scalar reader (the corpus fits the default widths).

The last lines are the card's name and power limit, one JSON object of
kernels, and ``{"ok": true, "device": {...}}``.  Without a CUDA device
(or without the rest of the repository beside it) the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys
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
    """The per-socket scalar drain of one connection's chunks."""
    codec = _codec(PacketCodec, xid_map)
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


def _codec(PacketCodec, xid_map):
    c = PacketCodec()
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing run', file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from zkstream_tpu_torch import corpus
    from zkstream_tpu_torch.entry import entry
    from zkstream_tpu_torch.io.ingest import FleetIngest
    from zkstream_tpu_torch.ops import full_scan as K2
    from zkstream_tpu_torch.ops import pipeline as P
    from zkstream_tpu_torch.ops import replies as R
    from zkstream_tpu_torch.ops import wire_scan as W
    from zkstream_tpu_torch.protocol.framing import PacketCodec

    t_start = time.perf_counter()
    dev = torch.device('cuda')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _log('# card: %s (torch %s, CUDA %s)' % (smi, torch.__version__,
                                              torch.version.cuda))

    # -- 1. build --
    t0 = time.perf_counter()
    W.load()
    K2.load()
    _log('# phase 1 build: %.2f s' % (time.perf_counter() - t0))
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
    conns = [StandIn(_codec(PacketCodec, m)) for m in xmaps]
    del db, dl, da, dal, dr, drl, got, want, st
    torch.cuda.synchronize()
    ing = FleetIngest(device='cuda', body_mode='host', bypass_bytes=0,
                      warm='block', max_frames=FRAMES)
    step_s: list = []
    _timed(ing, step_s)
    W.launches = K2.launches = 0
    t0 = time.perf_counter()
    asyncio.run(_serve(ing, conns, chunks))
    wall = time.perf_counter() - t0
    launches, k2_host = W.launches, K2.launches
    if not (ing.ticks > 0 and launches == ing.ticks and k2_host == 0
            and ing.ticks_scalar == 0 and ing.ticks_warming == 0):
        raise AssertionError('ingest ticks %d (scalar %d, warming %d) vs '
                             'K1 launches %d, K2 launches %d' % (
                                 ing.ticks, ing.ticks_scalar,
                                 ing.ticks_warming, launches, k2_host))
    n_pkts = _check_fleet(conns, wants)
    code = getattr(conns[-1].err, 'code', None)
    tick_ms = ing.tick_hist.sum() / max(ing.tick_hist.count(), 1)
    _log('# phase 4 on %s: %d connections, %d packets equal to the scalar '
         'codec, bad prefix -> %s; %d device ticks = %d K1 launches; '
         'mean tick %.3f ms, of which the device half (stage, copy, K1, '
         'pack, readback) %.3f ms per tick: %s; phase wall %.2f s'
         % (smi, len(conns), n_pkts, code, ing.ticks, launches, tick_ms,
            sum(step_s) * 1e3 / len(step_s),
            ' '.join('%.3f' % (x * 1e3) for x in step_s), wall))

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
    conns = [StandIn(_codec(PacketCodec, m)) for m in xmaps]
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
