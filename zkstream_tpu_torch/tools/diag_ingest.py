"""Diagnose the FleetIngest per-tick latency tail: the port's copy of
the JAX package's ``tools/diag_ingest.py``.

Runs the bench's create workload through a host-body ``FleetIngest``
on ``--device`` (``bypass_bytes=0``, ``max_frames=16``, as the
reference) with every tick phase timed, then prints the tick
distribution, the per-bucket step times and the worst device halves
with their batch shapes — enough to tell bucket warm-up churn from the
device half's pacing from host assembly cost.  The phases of the device
ticks in the measured loop:

  staging   the ingest's ``staging_s``: the streams copied into the
            bucket's rows (``_fill_staging``)
  h2d       the rest of ``_run_step`` up to ``_launch`` (the
            host-to-device copies, closed by a synchronize on the card)
  step      ``_launch``: on the card one replay of the bucket's CUDA
            graph (K1, the reductions and the pack), on the CPU the
            eager step; a synchronize closes it
  readback  the rest of ``_run_step`` (the pinned readback and its wait)
  unpack    the ingest's ``unpack_s`` (``_unpack``)
  route     the ingest's ``route_s`` (``_route_stream``), of which its
            ``assemble_s`` built the packets (``_assemble_stream``; the
            C codec's ``_assemble_ext`` where the connections carry it)

The host phases are the ingest's own counters (``zkstream_ingest_phase_s``);
only the device half is split here, by ``_run_step`` and ``_launch``
wrapped on the class for the run and restored after it, with the
synchronizes the ingest's hot path never takes.  The interpreter's
collector pauses (``gc.callbacks``) land inside the other phases; those
that fell inside a device half are reported as ``gc``.

Usage: python -m zkstream_tpu_torch.tools.diag_ingest [clients]
           [ops_per_client] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import asyncio
import gc
import time

TICKS: list[dict] = []

#: the non-overlapping parts of a device tick, in order
PHASES = ('staging', 'h2d', 'step', 'readback', 'unpack', 'route')
#: the ingest's counters of the host phases
_COUNTERS = {'staging': 'staging_s', 'unpack': 'unpack_s',
             'route': 'route_s', 'assemble': 'assemble_s'}

#: the device half in flight (its part sums, under ``half``) and the
#: step's bounds (``h2d``, ``step``: clock readings)
_cur: dict = {'half': None}


def _add(phase: str, dt: float) -> None:
    half = _cur['half']
    if half is not None:
        half[phase] = half.get(phase, 0.0) + dt


class _GcPauses:
    """Collector pauses while installed: their total seconds, and the
    share that fell inside a device half (added to it as ``gc``)."""

    def __init__(self):
        self.s, self._t = 0.0, 0.0

    def __call__(self, phase, info):
        if phase == 'start':
            self._t = time.perf_counter()
            return
        d = time.perf_counter() - self._t
        self.s += d
        _add('gc', d)


def instrument(FleetIngest):
    """Split every device half of ``FleetIngest`` into ``TICKS``;
    returns the function that restores the class."""
    import torch

    names = ('_run_step', '_launch')
    saved = {n: FleetIngest.__dict__[n] for n in names}
    orig = {n: getattr(FleetIngest, n) for n in names}
    now = time.perf_counter

    def sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def _run_step(self, bk, active):
        half = _cur['half'] = {}
        staged = self.staging_s
        t0 = now()
        try:
            out = orig['_run_step'](self, bk, active)
        finally:
            _cur['half'] = None
        t_end = now()
        staging = self.staging_s - staged
        half.update(h2d=_cur['h2d'] - t0 - staging,
                    step=_cur['step'] - _cur['h2d'],
                    readback=t_end - _cur['step'])
        TICKS.append({'kind': 'step_call', 'dt': t_end - t0,
                      'shape': tuple(bk.stage_buf.shape),
                      'n_bufs': len(active),
                      'nbytes': sum(len(b) for _c, b in active),
                      'staging': staging, 'phases': half})
        return out

    def _launch(self, bk):
        sync(self)
        _cur['h2d'] = now()
        out = orig['_launch'](self, bk)
        sync(self)
        _cur['step'] = now()
        return out

    FleetIngest._run_step = _run_step
    FleetIngest._launch = _launch

    def restore():
        for n, v in saved.items():
            setattr(FleetIngest, n, v)
    return restore


def _counts(ingest) -> dict:
    """The ingest's tick census and phase counters, to take a delta."""
    out = {k: getattr(ingest, a) for k, a in _COUNTERS.items()}
    out.update(ticks=ingest.ticks, tick_ms=ingest.tick_hist.sum(),
               routed_ticks=ingest.tick_hist.count())
    return out


async def run(n_clients: int = 32, n_ops: int = 15,
              device='cuda') -> dict:
    """The create workload through an instrumented ingest; prints the
    reference's lines and the phase split, and returns them."""
    from .. import Client
    from ..io.ingest import FleetIngest
    from ..ops import wire_scan
    from ..ops.pipeline import resolve_device
    from ..server import ZKServer

    resolve_device(device)
    TICKS.clear()
    k1_run = wire_scan.launches
    restore = instrument(FleetIngest)
    ingest = srv = None
    clients = []
    pauses = _GcPauses()
    try:
        ingest = FleetIngest(body_mode='host', max_frames=16,
                             bypass_bytes=0, device=device)
        srv = await ZKServer().start()
        clients = [Client(address='127.0.0.1', port=srv.port,
                          session_timeout=30000, ingest=ingest)
                   for _ in range(n_clients)]
        for c in clients:
            c.start()
        await asyncio.gather(*[c.wait_connected(timeout=30)
                               for c in clients])
        await clients[0].create('/b', b'x' * 64)
        for bp in (8, 16, n_clients):
            await ingest.prewarm(bp)
        for _ in range(5):
            await asyncio.gather(*[c.get('/b') for c in clients])
        TICKS.clear()

        loop = asyncio.get_running_loop()
        lat: list[float] = []

        async def one(c, i):
            for s in range(n_ops):
                t0 = loop.time()
                await c.create('/c%d-%d' % (i, s), b'')
                lat.append((loop.time() - t0) * 1000.0)
        k1 = wire_scan.launches
        c0 = _counts(ingest)
        gc.callbacks.append(pauses)
        t0 = loop.time()
        try:
            await asyncio.gather(*[one(c, i) for i, c in enumerate(clients)])
        finally:
            gc.callbacks.remove(pauses)
        dt = loop.time() - t0
        k1 = wire_scan.launches - k1
        counts = {k: v - c0[k] for k, v in _counts(ingest).items()}
        conn = clients[0].current_connection()
        c_ext = conn is not None and conn.codec.ext is not None
    finally:
        restore()
        await asyncio.gather(*[c.close() for c in clients])
        if srv is not None:
            await srv.stop()
        if ingest is not None:
            ingest.close()
    res = _report(lat, dt, k1, pauses.s, counts, c_ext)
    # the whole run's device ticks and launches, warm-up rounds included
    res.update(run_ticks=ingest.ticks, run_k1=wire_scan.launches - k1_run)
    return res


def _report(lat: list, dt: float, k1: int, gc_s: float, counts: dict,
            c_ext: bool) -> dict:
    """Print and return the run's numbers: ``counts`` is the ingest's
    change over the loop (:func:`_counts`), ``c_ext`` whether its
    connections assembled through the C codec."""
    lat.sort()
    res = {'ops_per_sec': len(lat) / dt, 'p50_ms': lat[len(lat) // 2],
           'p99_ms': lat[int(len(lat) * 0.99)], 'max_ms': lat[-1],
           'creates': len(lat)}
    print(f'create: {res["ops_per_sec"]:.1f} ops/s  '
          f'p50={res["p50_ms"]:.3f} ms  p99={res["p99_ms"]:.3f} ms  '
          f'max={res["max_ms"]:.3f} ms')
    steps = [t for t in TICKS if t['kind'] == 'step_call']
    n_dev = counts['ticks']
    print(f'{counts["routed_ticks"]} ticks ({n_dev} device ticks), '
          f'{len(steps)} step calls, K1 launches {k1}')
    shapes: dict = {}
    for s in steps:
        shapes.setdefault(s['shape'], []).append(s['dt'] * 1e3)
    for sh, dts in sorted(shapes.items()):
        first, srt = dts[0], sorted(dts)
        print(f'  bucket {sh}: n={len(dts)} first={first:.2f}ms '
              f'p50={srt[len(srt) // 2]:.2f}ms max={srt[-1]:.2f}ms')
    # every routed tick of the loop: device ticks where the buckets
    # were warmed before it (a bypass or warming tick would add its
    # scalar drain here, and to ``other``)
    tick_ms = counts['tick_ms']
    split = {p: sum(t['phases'].get(p, 0.0) for t in steps) * 1e3
             for p in ('h2d', 'step', 'readback', 'gc')}
    for p in ('staging', 'unpack', 'route', 'assemble'):
        split[p] = counts[p] * 1e3
    split['assemble_ext'] = split['assemble'] if c_ext else 0.0
    other = tick_ms - sum(split[p] for p in PHASES)
    n = max(1, n_dev)
    print('per-phase split of %d device ticks (ms in all / a tick): %s; '
          'other %.3f / %.4f; tick %.3f / %.4f; route holds assembly '
          '%.3f (C ext %.3f); collector pauses %.3f in device halves, '
          '%.3f in all'
          % (n_dev, ', '.join('%s %.3f / %.4f' % (p, split[p],
                                                   split[p] / n)
                              for p in PHASES),
             other, other / n, tick_ms, tick_ms / n, split['assemble'],
             split['assemble_ext'], split['gc'], gc_s * 1e3))
    steps.sort(key=lambda t: -t['dt'])
    print('worst 10 device halves:')
    for t in steps[:10]:
        print(f'  dt={t["dt"]*1e3:8.2f} ms  n_bufs={t["n_bufs"]:4d} '
              f'bytes={t["nbytes"]:6d}  staging={t["staging"]*1e3:.2f} '
              + ' '.join('%s=%.2f' % (p, t['phases'][p] * 1e3)
                         for p in PHASES if p in t['phases']))
    res.update(ticks=counts['routed_ticks'], device_ticks=n_dev, k1=k1,
               tick_ms=tick_ms, phases_ms=split, other_ms=other,
               gc_ms=gc_s * 1e3,
               buckets={'%dx%d' % sh: len(d) for sh, d in shapes.items()})
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument('clients', type=int, nargs='?', default=32)
    ap.add_argument('ops_per_client', type=int, nargs='?', default=15)
    ap.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    args = ap.parse_args(argv)
    asyncio.run(run(args.clients, args.ops_per_client, args.device))


if __name__ == '__main__':
    main()
