"""Run one cell once and print its result line.

    python3 -m zkbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The run: the server process starts (``servers.py``); the client
process builds one ``FleetIngest(device='cuda')`` with the arguments
the configuration states (``configs/<config>.json``, ``"ingest"``; the
shipped defaults for any it leaves out) and warms the cell's shape
buckets (``cells/<cell>.json``); the fleet's port ``Client`` sessions
connect, sharing it; the mix loads its data and starts
(``traffic/<generator>.py``), runs ``warmup_s``, and then the window of
``--seconds`` opens.  ``setup_s`` is the time from this process's start
to the window's opening.  At the window's close no
session issues another op and the ops in flight are waited for (a
minute at most: a late answer is late, not wrong); the end-to-end
numbers come from the recorded ops.  With ``--trace 1`` the window is
profiled (``devtrace.py``) and the per-layer metrics are read
(``metrics/<name>.py``) in place of the end-to-end ones.

Then the plain reference judges the run: every reply recorded, and the
data as the server serves it and as its write-ahead log recovers it.
Each compared number is printed with its limit as the last lines on
standard error and under ``checks``, the last key of the result line.

Without a CUDA device, or with fewer than the cell's chips, the run
exits 2 and prints no result; if JAX or the JAX package is loaded when
the window has closed, it exits 3 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import asyncio  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402

from . import spec  # noqa: E402
from .servers import Servers, admin_word  # noqa: E402

#: Modules that may not be loaded in the process that prints a result,
#: by whole top-level name.
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'zkstream_tpu')
#: How long the ops in flight at the window's close may take to settle.
GRACE_S = 60.0
#: How long the fleet may take to connect.
CONNECT_S = 120.0


class NoCard(RuntimeError):
    """No CUDA device, or fewer than the cell asks for."""


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def cache_dirs(root) -> None:
    """Every build and kernel cache of the program in fixed folders of
    the checkout, so that only a checkout's first run builds."""
    build = os.path.join(str(root), 'build')
    os.environ['TRITON_CACHE_DIR'] = os.path.join(build, 'triton-cache')
    os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(build,
                                                      'torch-extensions')
    os.environ['CUDA_CACHE_PATH'] = os.path.join(build, 'cuda-cache')


def _ingest_counts(ingest, hist) -> dict:
    from zkstream_tpu_torch.ops import wire_scan

    return {'ticks': ingest.ticks, 'ticks_scalar': ingest.ticks_scalar,
            'ticks_warming': ingest.ticks_warming,
            'ticks_frag': ingest.ticks_frag,
            'frames_routed': ingest.frames_routed,
            'tick_ms_sum': hist.sum(), 'tick_ms_count': hist.count(),
            'k1_launches': wire_scan.launches}


async def _wal_counts(port: int) -> dict:
    rows = dict(line.split('\t', 1) for line in
                (await admin_word(port, b'mntr')).splitlines()
                if '\t' in line)
    return {'appends': int(rows.get('zk_wal_last_index', 0)),
            'fsyncs': int(rows.get('zk_wal_fsyncs', 0))}


def _host() -> dict:
    """This process's CPU seconds, and the seconds the hypervisor took
    from the machine's CPUs (``/proc/stat``'s steal)."""
    t = os.times()
    with open('/proc/stat') as f:
        steal = int(f.readline().split()[8]) / os.sysconf('SC_CLK_TCK')
    return {'client_cpu_s': t.user + t.system, 'steal_s': steal}


def _delta(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in a}


async def _fleet(cell, mix, servers, ingest, collector):
    """The fleet's clients, connected."""
    from zkstream_tpu_torch import Client

    host, port = servers.addrs()[0]
    clients = [Client(address=host, port=port,
                      session_timeout=cell.config['session_timeout_ms'],
                      ingest=ingest, collector=collector)
               for _ in range(mix.n_clients)]
    for c in clients:
        c.start()
    await asyncio.gather(*[c.wait_connected(timeout=CONNECT_S)
                           for c in clients])
    return clients


async def _readback(mix, servers) -> list:
    """Every server's view of the data, each through a fresh client of
    its own (no ingest)."""
    from zkstream_tpu_torch import Client

    out = []
    for host, port in servers.addrs():
        c = Client(address=host, port=port)
        c.start()
        try:
            await c.wait_connected(timeout=CONNECT_S)
            out.append(await mix.readback(c))
        finally:
            await c.close()
    return out


async def _drive(cell, mix, servers, ingest, torch, seconds, trace,
                 grace_s, fault):
    from zkstream_tpu_torch import Client
    from zkstream_tpu_torch.utils.metrics import Collector

    from . import faults
    from .devtrace import Tracer
    from .instruments import GcPauses, LoopLag

    loop = asyncio.get_running_loop()
    collector = Collector()
    ingest.bind_metrics(collector)
    hist = ingest.tick_hist
    phases = {'ready_s': time.perf_counter() - T_START}
    warm = cell.cell['prewarm']
    for n in warm['streams']:
        if n > 2 * mix.n_clients:
            continue               # a fleet cut down for a test
        for nbytes in warm['bytes']:
            await ingest.prewarm(n, nbytes)
    phases['prewarm_s'] = time.perf_counter() - T_START
    clients = await _fleet(cell, mix, servers, ingest, collector)
    phases['connect_s'] = time.perf_counter() - T_START
    out = {'connected': len(clients), 'phases': phases}
    try:
        await mix.preload(clients)
        phases['preload_s'] = time.perf_counter() - T_START
        undo = faults.plant(fault) if fault else None
        tracer = lag = None
        if trace:
            tracer = Tracer(torch)
            tracer.install(loop, ingest, Client)
            lag = LoopLag()
            lag.start()
        # set-up's garbage is collected in set-up, not in the window
        gc.collect()
        mix.start(clients)
        await asyncio.sleep(cell.traffic['warmup_s'])
        server_port = servers.procs[0].client_port
        with GcPauses(keep=bool(trace)) as gc_pauses:
            if trace:
                tracer.start()
                wal0 = await _wal_counts(server_port)
            cpu0 = servers.cpu_s()
            h0 = _host()
            i0 = _ingest_counts(ingest, hist)
            if trace:
                tracer.open_window()
            w0 = time.perf_counter()
            await asyncio.sleep(seconds)
            w1 = time.perf_counter()
            if trace:
                tracer.close_window()
            i1 = _ingest_counts(ingest, hist)
            h1 = _host()
            cpu1 = servers.cpu_s()
            if trace:
                wal1 = await _wal_counts(server_port)
                tracer.stop()
        mix.stop(w1)
        await mix.drain(grace_s)
        if undo is not None:
            undo()
        out.update(mix.window(w0, w1))
        out['errors'] = mix.error_kinds()
        out['setup_s'] = w0 - T_START
        out['ingest'] = _delta(i0, i1)
        out['window_s'] = w1 - w0
        out['server_cpu_s'] = [b - a for a, b in zip(cpu0, cpu1)]
        out['host'] = _delta(h0, h1)
        out['gc'] = {'s': gc_pauses.s, 'max_s': gc_pauses.max,
                     'by_generation': gc_pauses.n}
        if torch.cuda.is_available():
            out['memory_peak_bytes'] = torch.cuda.max_memory_allocated()
        if trace:
            await lag.stop()
            tracer.uninstall()
            out['trace'] = tracer.read(w0, w1)
            out['gc_s'] = gc_pauses.seconds_in(w0, w1)
            out['lag_ms'] = [d * 1e3 for d in lag.lateness_in(w0, w1)]
            out['wal'] = _delta(wal0, wal1)
    finally:
        await asyncio.wait_for(
            asyncio.gather(*[c.close() for c in clients],
                           return_exceptions=True), CONNECT_S)
        ingest.close()
    out['readbacks'] = await _readback(mix, servers)
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: int,
             device: str = 'cuda', fault: str | None = None,
             sessions: int | None = None, records: int | None = None,
             grace_s: float = GRACE_S):
    """One run of cell ``workload``: ``(result, checks)``.  The harness
    tests call it with ``device='cpu'`` and a smaller fleet."""
    cell = spec.find_cell(workload)
    cache_dirs(spec.ROOT)
    # the port's host codec libraries, built before any process uses
    # them: a checkout's first run would otherwise serve on the Python
    # codecs while they build
    from zkstream_tpu_torch.utils import native

    native.ensure_lib()
    native.ensure_ext()
    tmp = tempfile.mkdtemp(prefix='zkbench-')
    servers = Servers(tmp)
    try:
        import torch

        if device == 'cuda' and not (torch.cuda.is_available()
                                     and torch.cuda.device_count()
                                     >= cell.chips):
            raise NoCard('cell %s needs %d CUDA device(s); this machine '
                         'has %d' % (workload, cell.chips,
                                     torch.cuda.device_count()
                                     if torch.cuda.is_available() else 0))
        from zkstream_tpu_torch.io.ingest import FleetIngest
        from zkstream_tpu_torch.server.persist import recover_state
        from zkstream_tpu_torch.utils import fdlimit

        fleet = sessions or cell.config['sessions']
        fdlimit.raise_nofile(8 * fleet + 1024)
        mix = spec.generator(cell.traffic).Mix(cell, seed, sessions,
                                               records)
        # the ingest at its shipped defaults, but for what the
        # configuration states (configs/<config>.json, "ingest")
        ingest = FleetIngest(device=device,
                             **cell.config.get('ingest', {}))
        servers.ready()
        out = asyncio.run(_drive(cell, mix, servers, ingest, torch,
                                 seconds, trace, grace_s, fault))
        servers.stop()
        recovered = [mix.recovered(recover_state(p.wal_dir).nodes)
                     for p in servers.procs]
        checks = mix.check(out.pop('readbacks'), recovered)
    finally:
        servers.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    return _result(cell, out, checks, trace, torch), checks


def _result(cell, out: dict, checks: dict, trace: int, torch) -> dict:
    if trace:
        ctx = types.SimpleNamespace(
            window_s=out['window_s'], lag_ms=out['lag_ms'],
            gc_s=out['gc_s'], ingest=out['ingest'], trace=out['trace'],
            server_cpu_s=out['server_cpu_s'], wal=out['wal'])
        metrics = {}
        for m in cell.per_layer:
            v = spec.metric_reader(m['name'])(ctx)
            if v is not None:
                metrics[m['name']] = {'value': v, 'unit': m['unit']}
    else:
        metrics = {m['name']: {'value': out[m['name']], 'unit': m['unit']}
                   for m in cell.end_to_end}
    cuda = torch.cuda.is_available()
    device = {'platform': 'gpu' if cuda else 'cpu',
              'kind': torch.cuda.get_device_name(0) if cuda else 'cpu',
              'count': cell.chips,
              'memory_peak_bytes': out.get('memory_peak_bytes', 0)}
    res = {'correct': all(v <= lim for v, lim in checks.values()),
           'attempted': out['attempted'], 'failed': out['failed'],
           'metrics': metrics, 'device': device}
    if trace:
        device['busy_s'] = out['trace']['busy_s']
        device['window_s'] = out['trace']['window_s']
        res['breakdown'] = {'device_ops': out['trace']['device_ops'],
                            'idle_gaps': out['trace']['idle_gaps']}
    res['checks'] = {k: {'value': v, 'limit': lim}
                     for k, (v, lim) in checks.items()}
    res['_run'] = out
    return res


def _report(res: dict) -> None:
    """The run's own numbers on standard error, before the checks."""
    out = res.pop('_run')
    log('# samples %d (attempted %d, failed %d, p50 %.3f ms); settled '
        '%.3f ops/s; connected %d sessions' % (
            out['samples'], out['attempted'], out['failed'], out['p50_ms'],
            out['ops_per_s'], out['connected']))
    log('# set-up, seconds from the start of the process: %s' % (
        json.dumps(out['phases']),))
    log('# window %.6f s; ingest in the window %s' % (
        out['window_s'], json.dumps(out['ingest'])))
    if out.get('errors'):
        log('# op errors by kind %s' % (json.dumps(out['errors']),))
    log('# server cpu s in the window %s; collector pauses in the window '
        '%s' % (out['server_cpu_s'], json.dumps(out['gc'])))
    log('# host in the window %s' % (json.dumps(out['host']),))
    if 'trace' in out:
        t = out['trace']
        log('# trace: K1 replays %d, K1 device s %.6f, K1 bytes %d; '
            'device busy %.6f s of %.6f s; replays by bucket %s' % (
                t['k1_replays'], t['k1_device_s'], t['k1_bytes'],
                t['busy_s'], t['window_s'], json.dumps(t['buckets'])))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog='python3 -m zkbench.run')
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    ap.add_argument('--fault', default=None,
                    help='plant a fault under the run (faults.py): the '
                         'controls and the fault tests, never a '
                         'measured run')
    args = ap.parse_args(argv)
    try:
        res, checks = run_cell(args.workload, args.seed, args.seconds,
                               args.trace, fault=args.fault)
    except NoCard as e:
        log(str(e))
        return 2
    loaded = sorted({m.split('.')[0] for m in sys.modules}
                    & set(FORBIDDEN))
    if loaded:
        log('loaded after the window: %s' % (', '.join(loaded),))
        return 3
    _report(res)
    for name, (v, lim) in checks.items():
        log('check %s %s limit %s' % (name, v, lim))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
