"""Crossover sweep: where does the batched device plane win end-to-end?
The port's copy of the JAX package's ``tools/sweep_crossover.py``.

Measures the port's full client stack against its in-process server
across fleet sizes x client receive paths:

  python         pure-Python scalar codec — the reference-idiom
                 baseline (an interpreted per-socket drain)
  native         C-extension scalar codec, per-socket drain
  ingest         FleetIngest, device framing (kernel K1 on a card) + C
                 slice assembly, both dispatch guards off
  ingest-auto    FleetIngest at its shipped dispatch policy (the byte
                 threshold and the fragmentation guard decide per tick)
  ingest-py      FleetIngest with the C codec disabled on its
                 connections: device framing + plane assembly — the
                 no-native-toolchain regime
  ingest-py-dev  the no-toolchain regime with the full tensor plane:
                 bodies from device planes (kernel K2 on a card)

Any mode takes a ``-nocork`` suffix (e.g. ``native-nocork``): same
codec path with the outbound tick-cork (io/sendplane.py) disabled on
both the clients and the in-process server — isolates the cork.  A
``-legacy`` suffix additionally disables the single-pass Python
encode tier (ZKSTREAM_NO_FASTENC): cork off + per-field JuteWriter
encode, i.e. the pre-outbound-plane path for that codec mode.

Workloads per cell (``--workload``): ``get`` (default) runs
concurrent gets plus a notification fan-out storm; ``write`` is
SET_DATA/CREATE-dominated (2 sets : 1 create).

``--fleet N`` tops each cell up to N sessions with idle ones: connected
clients on the same ingest that hold their session and only keep it
alive, so ticks carry a few streams of a large fleet (the regime the
fragmentation guard routes).  The ``--conns`` sizes stay the active
clients; the default adds none, and the cell is the reference's.

Every cell also reports the flush-batch-size distributions
(zookeeper_flush_batch_frames/_bytes, client and server planes) and —
for ingest modes — the routing counters, the bytes a tick, the ingest
tick-duration histogram (zkstream_ingest_tick_ms p50/p99), and the K1
and K2 launches the cell made (``ops/wire_scan.launches``,
``ops/full_scan.launches``, before and after; 0 on the CPU, where the
plain versions run), so regime flips show as distribution shifts, not
just tick counts.

The ingest runs on ``--device`` (``cuda`` default; without a card
every cell raises unless ``--device cpu`` is given).  Emits one JSON
line per cell to stdout:

  python -m zkstream_tpu_torch.tools.sweep_crossover [--conns 32,256]
      [--modes ...] [--rounds 3] [--paired A[,A2...],B]
      [--workload get|write] [--max-frames 16] [--fleet N]
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import statistics
import time

GETS_TOTAL = 2048        # total get ops per cell, split over the fleet
STORMS = 5               # fan-out storms per cell
MAX_FRAMES = 16          # ingest per-stream frame bound (--max-frames)
#: Each client's session timeout, ms.  A ping times out after an eighth
#: of it; the reference's 60 s left 7.5 s, and on the H100 machine's
#: host 1,024 sessions sharing one event loop with their server lost
#: sessions to that in 3 of 15 cells (PERF.md, "Crossover on the H100").
SESSION_TIMEOUT_MS = 120000


def _pct(xs, p):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(p / 100.0 * len(xs)))]


def _make_ingest(mode: str, device):
    """``(ingest or None, client kwargs)`` for a base mode, with the
    reference's arguments."""
    from ..io.ingest import FleetIngest

    if mode == 'ingest':
        # the raw device path: both guards off, so the table shows
        # what the batched pipeline itself does at every fleet size
        return FleetIngest(body_mode='host', max_frames=MAX_FRAMES,
                           bypass_bytes=0, frag_guard=False,
                           device=device), {}
    if mode == 'ingest-auto':
        # the SHIPPED dispatch policy: byte threshold + fragmentation
        # guard decide per tick between device and scalar
        return FleetIngest(body_mode='host', max_frames=MAX_FRAMES,
                           device=device), {}
    if mode == 'ingest-py':
        return FleetIngest(body_mode='host', max_frames=MAX_FRAMES,
                           bypass_bytes=0, device=device), \
            {'use_native_codec': False}
    if mode == 'ingest-py-dev':
        # the no-toolchain regime with the full tensor plane: bodies
        # come from device planes instead of a Python re-parse
        return FleetIngest(body_mode='device', max_frames=MAX_FRAMES,
                           bypass_bytes=0, min_len=1024, max_data=128,
                           max_path=64, device=device), \
            {'use_native_codec': False}
    if mode == 'native':
        return None, {'use_native_codec': True}
    if mode == 'python':
        return None, {'use_native_codec': False}
    raise ValueError(mode)


def _count_bytes(ingest) -> list:
    """Count the bytes ``ingest`` is handed (batched and pass-through);
    returns the one-element total."""
    total = [0]
    feed, note = ingest.feed, ingest.note_direct

    def counted_feed(conn, data):
        total[0] += len(data)
        feed(conn, data)

    def counted_note(nbytes, nframes):
        total[0] += nbytes
        note(nbytes, nframes)
    ingest.feed, ingest.note_direct = counted_feed, counted_note
    return total


async def run_cell(mode: str, n_conns: int, workload: str = 'get',
                   device='cuda', idle: int = 0) -> dict:
    """One cell: ``n_conns`` clients run the workload, beside ``idle``
    clients that only hold their sessions."""
    from .. import Client
    from ..io.sendplane import scrape_flush_cells
    from ..ops import full_scan, wire_scan
    from ..ops.pipeline import resolve_device
    from ..server import ZKServer
    from ..utils.metrics import Collector

    device = resolve_device(device)
    cork = None
    legacy = False
    cell_mode = mode
    if mode.endswith('-legacy'):
        cork = False
        legacy = True
        mode = mode[:-len('-legacy')]
    elif mode.endswith('-nocork'):
        cork = False
        mode = mode[:-len('-nocork')]

    ingest, kw = _make_ingest(mode, device)
    nbytes = _count_bytes(ingest) if ingest is not None else None
    # the cell's kernel launches count from here (warm-up builds the
    # kernel and launches nothing)
    mark = (wire_scan.launches, full_scan.launches)

    loop = asyncio.get_running_loop()
    # -legacy: per-field JuteWriter encode (codecs read the env at
    # construction, which happens while the cell's clients connect)
    prev_fastenc = os.environ.get('ZKSTREAM_NO_FASTENC')
    if legacy:
        os.environ['ZKSTREAM_NO_FASTENC'] = '1'
    collector = Collector()
    if ingest is not None:
        ingest.bind_metrics(collector)
    srv = await ZKServer(cork=cork, collector=collector).start()
    clients = [Client(address='127.0.0.1', port=srv.port,
                      session_timeout=SESSION_TIMEOUT_MS, ingest=ingest,
                      cork=cork, collector=collector, **kw)
               for _ in range(n_conns + idle)]
    for c in clients:
        c.start()
    fleet, clients = clients, clients[:n_conns]
    out = {'mode': cell_mode, 'conns': n_conns,
           'workload': workload}
    if idle:
        out['idle'] = idle
    try:
        await asyncio.gather(*[c.wait_connected(timeout=60)
                               for c in fleet])
        await clients[0].create('/b', b'x' * 64)
        if ingest is not None:
            bp = 8
            while bp < len(fleet):
                await ingest.prewarm(bp)
                await ingest.prewarm(bp, 512)
                await ingest.prewarm(bp, 1024)
                bp *= 2
            await ingest.prewarm(len(fleet))
            await ingest.prewarm(len(fleet), 512)
            await ingest.prewarm(len(fleet), 1024)

        # warm steady state
        for _ in range(3):
            await asyncio.gather(*[c.get('/b') for c in clients])

        if workload == 'write':
            # -- SET_DATA/CREATE-dominated (2 sets : 1 create) --
            per = max(6, GETS_TOTAL // n_conns)
            lat = []

            async def writer(c, ci):
                seq = 0
                for i in range(per):
                    t0 = loop.time()
                    if i % 3 == 2:
                        seq += 1
                        await c.create('/wr%d-%d' % (ci, seq), b'')
                    else:
                        await c.set('/b', b'y' * 64, version=-1)
                    lat.append((loop.time() - t0) * 1000.0)
            t0 = loop.time()
            await asyncio.gather(*[writer(c, i)
                                   for i, c in enumerate(clients)])
            dt = loop.time() - t0
            out['write'] = {
                'ops_per_sec': round(len(lat) / dt, 1),
                'p50_ms': round(_pct(lat, 50), 3),
                'p99_ms': round(_pct(lat, 99), 3),
                'count': len(lat), 'expected': per * n_conns}
            out['flush'] = scrape_flush_cells(collector)
            _scrape_ingest(out, ingest, collector, mark, nbytes)
            return out

        # -- concurrent gets --
        per = max(4, GETS_TOTAL // n_conns)
        lat: list[float] = []

        async def getter(c):
            for _ in range(per):
                t0 = loop.time()
                await c.get('/b')
                lat.append((loop.time() - t0) * 1000.0)
        t0 = loop.time()
        await asyncio.gather(*[getter(c) for c in clients])
        dt = loop.time() - t0
        out['get'] = {
            'ops_per_sec': round(len(lat) / dt, 1),
            'p50_ms': round(_pct(lat, 50), 3),
            'p99_ms': round(_pct(lat, 99), 3),
            'count': len(lat), 'expected': per * n_conns}

        # -- notification fan-out storm --
        fired = [0]
        got_all = [None]

        def on_fire(*a):
            fired[0] += 1
            if fired[0] >= n_conns and got_all[0] is not None \
                    and not got_all[0].done():
                got_all[0].set_result(None)
        for c in clients:
            c.watcher('/b').on('dataChanged', on_fire)
        # arming emits once per client; swallow those.  Bounded wait:
        # one dead client of a 1,024-conn fleet must fail the cell
        # loudly, not hang the sweep forever
        deadline = loop.time() + 120
        await asyncio.sleep(0.1)
        while fired[0] < n_conns:
            if loop.time() > deadline:
                raise TimeoutError(
                    'only %d/%d watchers armed' % (fired[0], n_conns))
            await asyncio.sleep(0.1)
        storm_dts = []
        storm_fired = []
        for s in range(STORMS):
            await asyncio.sleep(0.3)   # let every watch re-arm
            fired[0] = 0
            got_all[0] = loop.create_future()
            t0 = loop.time()
            await clients[0].set('/b', b'z%d' % s)
            await asyncio.wait_for(got_all[0], 30)
            storm_dts.append(loop.time() - t0)
            storm_fired.append(fired[0])
        best = min(storm_dts)
        out['fanout'] = {
            'events': n_conns,
            'best_events_per_sec': round(n_conns / best, 1),
            'best_ms': round(best * 1000.0, 2),
            'fired': storm_fired}
        out['flush'] = scrape_flush_cells(collector)
        _scrape_ingest(out, ingest, collector, mark, nbytes)
    finally:
        if legacy:
            if prev_fastenc is None:
                os.environ.pop('ZKSTREAM_NO_FASTENC', None)
            else:
                os.environ['ZKSTREAM_NO_FASTENC'] = prev_fastenc
        await asyncio.gather(*[c.close() for c in fleet])
        await srv.stop()
        if ingest is not None:
            ingest.close()
    return out


def _scrape_ingest(out: dict, ingest, collector, mark, nbytes) -> None:
    """Ingest cell stats: routing counters plus the tick-duration
    DISTRIBUTION (zkstream_ingest_tick_ms) — a regime flip must show
    as a latency-shape shift, not only a tick-count shift.  Beside the
    counters, the K1 and K2 launches since ``mark``."""
    from ..ops import full_scan, wire_scan

    if ingest is None:
        return
    ticks = ingest.ticks + ingest.ticks_scalar + ingest.ticks_warming
    out['ingest'] = {
        'ticks': ingest.ticks,
        'scalar_ticks': ingest.ticks_scalar,
        'warming_ticks': ingest.ticks_warming,
        'frag_ticks': ingest.ticks_frag,
        'frames': ingest.frames_routed,
        'frames_per_tick': round(
            ingest.frames_routed / max(1, ingest.ticks), 1),
        'bytes': nbytes[0],
        'bytes_per_tick': round(nbytes[0] / max(1, ticks), 1),
        'body_fallbacks': ingest.body_fallbacks,
        'k1_launches': wire_scan.launches - mark[0],
        'k2_launches': full_scan.launches - mark[1]}
    try:
        th = collector.get_collector('zkstream_ingest_tick_ms')
    except ValueError:
        return
    n = th.count()
    if n:
        out['ingest']['tick_ms'] = {
            'count': n,
            'p50': round(th.percentile(50), 3),
            'p99': round(th.percentile(99), 3)}


def _sign_test_p(wins: int, losses: int) -> float:
    """Two-sided exact sign test — the package's shared implementation
    (utils/metrics.py)."""
    from ..utils.metrics import sign_test_p

    return sign_test_p(wins, losses)


def _cell(mode: str, n: int, workload: str, device, rnd: int,
          idle: int = 0) -> dict:
    """One cell in its own event loop; an exception becomes the cell's
    ``error`` (a sweep runs on)."""
    t0 = time.time()
    try:
        r = asyncio.run(run_cell(mode, n, workload, device, idle))
    except Exception as e:
        r = {'mode': mode, 'conns': n, 'error': repr(e)}
    r['cell_s'] = round(time.time() - t0, 1)
    r['round'] = rnd
    print('#', json.dumps(r), flush=True)
    return r


def run_paired(mode_a, mode_b: str, conns: list[int],
               rounds: int, workload: str = 'get',
               device='cuda', fleet: int = 0) -> list[dict]:
    """Paired comparison: run the modes back-to-back within each
    round — adjacent in time, same host conditions — and judge each
    fleet size on the per-round SIGN of the delta rather than best-of-N
    point estimates.  ``mode_a`` is one mode or a tuple of modes, each
    paired with the same round's ``mode_b`` cell.  ``fleet`` tops each
    size up to that many sessions with idle ones.  Emits (and returns)
    one summary JSON per mode and fleet size: win counts, every paired
    delta, the exact sign-test p-value, the median bytes and frames a
    tick (over every routed tick) and the fill (frames a tick over the
    fleet size), and the dispatch-policy routing fractions over every
    round (how often the guard/threshold actually sent ticks to the
    scalar drain)."""
    metric = 'write' if workload == 'write' else 'get'
    modes_a = (mode_a,) if isinstance(mode_a, str) else tuple(mode_a)
    keys = [(a, n) for a in modes_a for n in conns]
    deltas: dict[tuple, list[float]] = {k: [] for k in keys}
    #: (mode, n) -> per-pair bytes a tick, frames a tick, fill; and the
    #: ingest counters summed over those pairs
    ticks: dict[tuple, dict] = {k: {'bytes': [], 'frames': [],
                                    'fill': []} for k in keys}
    counts: dict[tuple, dict] = {}
    #: (mode, n) -> plane -> [frames, flushes] pooled over EVERY round
    #: (a last-round sample would misrepresent the batch-size
    #: distribution the summary line is cited for; full per-round
    #: percentiles stay on the '#' cell lines)
    flush_acc: dict[tuple, dict] = {}
    for rnd in range(rounds):
        for n in conns:
            idle = max(0, fleet - n)
            cell = {mode: _cell(mode, n, workload, device, rnd, idle)
                    for mode in modes_a + (mode_b,)}
            b = cell[mode_b]
            for mode in modes_a:
                a = cell[mode]
                if 'error' in a or 'error' in b:
                    continue
                ops_a = a[metric]['ops_per_sec']
                ops_b = b[metric]['ops_per_sec']
                if ops_b <= 0 or ops_a <= 0:   # a silently idle cell
                    continue                   # must skip its pair,
                                               # not void the sweep
                k = (mode, n)
                for plane, st in (a.get('flush') or {}).items():
                    row = flush_acc.setdefault(k, {}).setdefault(
                        plane, [0.0, 0])
                    row[0] += st['frames_mean'] * st['flushes']
                    row[1] += st['flushes']
                deltas[k].append((ops_a - ops_b) / ops_b * 100.0)
                ing = a.get('ingest')
                if ing is None:
                    continue
                routed = max(1, ing['ticks'] + ing['scalar_ticks']
                             + ing['warming_ticks'])
                ticks[k]['bytes'].append(ing['bytes_per_tick'])
                ticks[k]['frames'].append(ing['frames'] / routed)
                ticks[k]['fill'].append(ing['frames'] / routed
                                        / (n + idle))
                acc = counts.setdefault(k, dict.fromkeys(
                    ('ticks', 'scalar_ticks', 'warming_ticks',
                     'frag_ticks', 'frames'), 0))
                for f in acc:
                    acc[f] += ing[f]
    summaries = []
    for mode, n in keys:
        k = (mode, n)
        ds = deltas[k]
        wins = sum(1 for d in ds if d > 0)
        losses = sum(1 for d in ds if d < 0)
        mean = sum(ds) / len(ds) if ds else 0.0
        routing = None
        if k in counts:
            c = counts[k]
            total = max(1, c['ticks'] + c['scalar_ticks']
                        + c['warming_ticks'])
            routing = {
                'device_frac': round(c['ticks'] / total, 3),
                'scalar_frac': round(c['scalar_ticks'] / total, 3),
                'frag_frac': round(c['frag_ticks'] / total, 3),
                'frames_per_tick': round(
                    c['frames'] / max(1, c['ticks']), 1)}
        med = {f: statistics.median(v) if v else None
               for f, v in ticks[k].items()}
        s = {
            'paired': '%s-vs-%s' % (mode, mode_b),
            'workload': workload,
            'conns': n,
            'fleet': max(fleet, n),
            'pairs': len(ds),
            'wins': wins,
            'losses': losses,
            'mean_delta_pct': round(mean, 2),
            'deltas_pct': [round(d, 2) for d in ds],
            'sign_p': round(_sign_test_p(wins, losses), 4),
            'bytes_per_tick_median': med['bytes'],
            'frames_per_tick_median': (
                None if med['frames'] is None
                else round(med['frames'], 2)),
            'fill_median': (None if med['fill'] is None
                            else round(med['fill'], 4)),
            'routing': routing,
            'flush': {plane: {'flushes': int(row[1]),
                              'frames_mean': round(row[0] / row[1], 2)}
                      for plane, row in flush_acc.get(k, {}).items()
                      if row[1]} or None,
        }
        print(json.dumps(s), flush=True)
        summaries.append(s)
    return summaries


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument('--conns', default='32,64,128,256,512')
    ap.add_argument('--modes', default='python,native,ingest,ingest-py')
    ap.add_argument('--max-frames', type=int, default=16)
    ap.add_argument('--rounds', type=int, default=3,
                    help='interleaved rounds per cell; best get-ops '
                         'round is reported (scheduling noise swings '
                         'single runs)')
    ap.add_argument('--paired', default=None, metavar='A[,A2...],B',
                    help='paired-design comparison of each mode A with '
                         'the last mode B (e.g. ingest-auto,native or '
                         'native,native-nocork): per-round deltas + '
                         'exact sign test per fleet size')
    ap.add_argument('--workload', default='get',
                    choices=('get', 'write'),
                    help='get: concurrent gets + fan-out storm; '
                         'write: SET_DATA/CREATE-dominated')
    ap.add_argument('--fleet', type=int, default=0,
                    help='top each cell up to this many sessions with '
                         'idle ones (0: none)')
    ap.add_argument('--device', default='cuda', choices=('cuda', 'cpu'),
                    help='where the ingest modes run their ticks')
    args = ap.parse_args(argv)
    from ..ops.pipeline import resolve_device

    resolve_device(args.device)       # no card: raise before any cell
    global MAX_FRAMES
    MAX_FRAMES = args.max_frames
    conns = [int(x) for x in args.conns.split(',')]
    if args.paired:
        *modes_a, mode_b = args.paired.split(',')
        if not modes_a:
            ap.error('--paired needs at least two modes')
        run_paired(tuple(modes_a), mode_b, conns, args.rounds,
                   args.workload, args.device, args.fleet)
        return
    modes = args.modes.split(',')
    best: dict = {}
    metric = 'write' if args.workload == 'write' else 'get'
    for rnd in range(args.rounds):
        for n in conns:
            for mode in modes:
                r = _cell(mode, n, args.workload, args.device, rnd,
                          max(0, args.fleet - n))
                key = (mode, n)
                if 'error' in r:
                    best.setdefault(key, r)
                elif (key not in best or 'error' in best[key]
                        or r[metric]['ops_per_sec']
                        > best[key][metric]['ops_per_sec']):
                    best[key] = r
    for n in conns:
        for mode in modes:
            print(json.dumps(best[(mode, n)]), flush=True)


if __name__ == '__main__':
    main()
