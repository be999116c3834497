"""Diagnose the FleetIngest per-tick latency tail: the port's copy of
the JAX package's ``tools/diag_ingest.py``.

Runs the bench's create workload through a host-body ``FleetIngest``
on ``--device`` (``bypass_bytes=0``, ``max_frames=16``, as the
reference) with every tick phase timed, then prints the tick
distribution, the per-bucket step times and the worst ticks with their
batch shapes — enough to tell bucket warm-up churn from the device
half's pacing from host assembly cost.  The phases, wrapped on the
class for the run and restored after it (``io/ingest.py`` is not
edited):

  staging   ``_fill_staging``: the streams copied into the bucket's rows
  h2d       the rest of ``_run_step`` up to ``_launch`` (the
            host-to-device copies, closed by a synchronize on the card)
  step      ``_launch``: on the card one replay of the bucket's CUDA
            graph (K1, the reductions and the pack), on the CPU the
            eager step; a synchronize closes it
  readback  the rest of ``_run_step`` (the pinned readback and its wait)
  unpack    ``_unpack``
  route     ``_route_stream`` (of which ``_assemble_stream``, of which
            ``_assemble_ext``)

and the interpreter's collector pauses (``gc.callbacks``), which land
inside the other phases.

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

#: the tick being timed (its phase dict, under ``tick``) and the step in
#: flight's part boundaries (``fill``, ``h2d``, ``step``: clock readings)
_cur: dict = {'tick': None}


def _add(phase: str, dt: float) -> None:
    tick = _cur['tick']
    if tick is not None:
        tick[phase] = tick.get(phase, 0.0) + dt


class _GcPauses:
    """Collector pauses while installed: their total seconds, and the
    share that fell inside a tick (added to that tick as ``gc``)."""

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
    """Time every tick phase of ``FleetIngest`` into ``TICKS``; returns
    the function that restores the class."""
    import torch

    names = ('_tick', '_fill_staging', '_run_step', '_launch', '_unpack',
             '_route_stream', '_assemble_stream', '_assemble_ext')
    saved = {n: FleetIngest.__dict__[n] for n in names}
    orig = {n: getattr(FleetIngest, n) for n in names}
    now = time.perf_counter

    def sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def _tick(self):
        n_bufs = sum(1 for _c, b in self._slots.values() if b)
        nbytes = sum(len(b) for _c, b in self._slots.values())
        phases = _cur['tick'] = {}
        t0 = now()
        try:
            orig['_tick'](self)
        finally:
            _cur['tick'] = None
        TICKS.append({'kind': 'tick', 'dt': now() - t0, 'n_bufs': n_bufs,
                      'nbytes': nbytes, 'ticks': self.ticks,
                      'scalar': self.ticks_scalar, 'phases': phases})

    def _fill_staging(bk, active):
        orig['_fill_staging'](bk, active)
        _cur['fill'] = now()

    def _run_step(self, bk, active):
        t0 = now()
        out = orig['_run_step'](self, bk, active)
        t_end = now()
        _add('staging', _cur['fill'] - t0)
        _add('h2d', _cur['h2d'] - _cur['fill'])
        _add('step', _cur['step'] - _cur['h2d'])
        _add('readback', t_end - _cur['step'])
        TICKS.append({'kind': 'step_call', 'dt': t_end - t0,
                      'shape': tuple(bk.stage_buf.shape)})
        return out

    def _launch(self, bk):
        sync(self)
        _cur['h2d'] = now()
        out = orig['_launch'](self, bk)
        sync(self)
        _cur['step'] = now()
        return out

    def timed(name, phase):
        fn = orig[name]

        def wrapper(*a):
            t0 = now()
            try:
                return fn(*a)
            finally:
                _add(phase, now() - t0)
        return wrapper

    FleetIngest._tick = _tick
    FleetIngest._fill_staging = staticmethod(_fill_staging)
    FleetIngest._run_step = _run_step
    FleetIngest._launch = _launch
    FleetIngest._unpack = timed('_unpack', 'unpack')
    FleetIngest._route_stream = timed('_route_stream', 'route')
    FleetIngest._assemble_stream = timed('_assemble_stream', 'assemble')
    FleetIngest._assemble_ext = timed('_assemble_ext', 'assemble_ext')

    def restore():
        for n, v in saved.items():
            setattr(FleetIngest, n, v)
    return restore


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
        gc.callbacks.append(pauses)
        t0 = loop.time()
        try:
            await asyncio.gather(*[one(c, i) for i, c in enumerate(clients)])
        finally:
            gc.callbacks.remove(pauses)
        dt = loop.time() - t0
        k1 = wire_scan.launches - k1
    finally:
        restore()
        await asyncio.gather(*[c.close() for c in clients])
        if srv is not None:
            await srv.stop()
        if ingest is not None:
            ingest.close()
    res = _report(lat, dt, k1, pauses.s)
    # the whole run's device ticks and launches, warm-up rounds included
    res.update(run_ticks=ingest.ticks, run_k1=wire_scan.launches - k1_run)
    return res


def _report(lat: list, dt: float, k1: int, gc_s: float) -> dict:
    lat.sort()
    res = {'ops_per_sec': len(lat) / dt, 'p50_ms': lat[len(lat) // 2],
           'p99_ms': lat[int(len(lat) * 0.99)], 'max_ms': lat[-1],
           'creates': len(lat)}
    print(f'create: {res["ops_per_sec"]:.1f} ops/s  '
          f'p50={res["p50_ms"]:.3f} ms  p99={res["p99_ms"]:.3f} ms  '
          f'max={res["max_ms"]:.3f} ms')
    ticks = [t for t in TICKS if t['kind'] == 'tick']
    steps = [t for t in TICKS if t['kind'] == 'step_call']
    dev = [t for t in ticks if 'step' in t['phases']]
    print(f'{len(ticks)} ticks ({len(dev)} device ticks), '
          f'{len(steps)} step calls, K1 launches {k1}')
    shapes: dict = {}
    for s in steps:
        shapes.setdefault(s['shape'], []).append(s['dt'] * 1e3)
    for sh, dts in sorted(shapes.items()):
        first, srt = dts[0], sorted(dts)
        print(f'  bucket {sh}: n={len(dts)} first={first:.2f}ms '
              f'p50={srt[len(srt) // 2]:.2f}ms max={srt[-1]:.2f}ms')
    tick_ms = sum(t['dt'] for t in dev) * 1e3
    split = {p: sum(t['phases'].get(p, 0.0) for t in dev) * 1e3
             for p in PHASES + ('assemble', 'assemble_ext', 'gc')}
    other = tick_ms - sum(split[p] for p in PHASES)
    n = max(1, len(dev))
    print('per-phase split of %d device ticks (ms in all / a tick): %s; '
          'other %.3f / %.4f; tick %.3f / %.4f; route holds assembly '
          '%.3f (C ext %.3f); collector pauses %.3f in ticks, %.3f in all'
          % (len(dev), ', '.join('%s %.3f / %.4f' % (p, split[p],
                                                      split[p] / n)
                                 for p in PHASES),
             other, other / n, tick_ms, tick_ms / n, split['assemble'],
             split['assemble_ext'], split['gc'], gc_s * 1e3))
    ticks.sort(key=lambda t: -t['dt'])
    print('worst 10 ticks:')
    for t in ticks[:10]:
        print(f'  dt={t["dt"]*1e3:8.2f} ms  n_bufs={t["n_bufs"]:4d} '
              f'bytes={t["nbytes"]:6d}  '
              + ' '.join('%s=%.2f' % (p, t['phases'][p] * 1e3)
                         for p in PHASES if p in t['phases']))
    res.update(ticks=len(ticks), device_ticks=len(dev), k1=k1,
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
