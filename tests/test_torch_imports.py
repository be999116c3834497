"""The port stands alone: importing every ``zkstream_tpu_torch`` module
loads neither JAX nor anything of ``zkstream_tpu``, and its entry
points refuse to run on the CPU unless asked to."""

import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import zkstream_tpu_torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    names = ['zkstream_tpu_torch']
    for info in pkgutil.walk_packages(zkstream_tpu_torch.__path__,
                                      'zkstream_tpu_torch.'):
        names.append(info.name)
    return names


def test_every_module_is_found():
    mods = _modules()
    for name in ('zkstream_tpu_torch.io.ingest',
                 'zkstream_tpu_torch.ops.wire_scan',
                 'zkstream_tpu_torch.ops.full_scan',
                 'zkstream_tpu_torch.ops.replies',
                 'zkstream_tpu_torch.protocol.framing',
                 'zkstream_tpu_torch.utils.native',
                 'zkstream_tpu_torch.utils.metrics',
                 'zkstream_tpu_torch.ops.seq_walk',
                 'zkstream_tpu_torch.ops.encode',
                 'zkstream_tpu_torch.ops.bodies',
                 'zkstream_tpu_torch.parallel',
                 'zkstream_tpu_torch.parallel.mesh',
                 'zkstream_tpu_torch.parallel.sharded',
                 'zkstream_tpu_torch.parallel.seqscan',
                 'zkstream_tpu_torch.parallel.multihost',
                 'zkstream_tpu_torch.parallel.fleet',
                 'zkstream_tpu_torch.corpus', 'zkstream_tpu_torch.entry',
                 'zkstream_tpu_torch.client',
                 'zkstream_tpu_torch.utils.aio',
                 'zkstream_tpu_torch.utils.events',
                 'zkstream_tpu_torch.utils.fsm',
                 'zkstream_tpu_torch.utils.trace',
                 'zkstream_tpu_torch.utils.fdlimit',
                 'zkstream_tpu_torch.utils.blackbox',
                 'zkstream_tpu_torch.io.backoff',
                 'zkstream_tpu_torch.io.transport',
                 'zkstream_tpu_torch.io.sendplane',
                 'zkstream_tpu_torch.io.overload',
                 'zkstream_tpu_torch.io.connection',
                 'zkstream_tpu_torch.io.watcher',
                 'zkstream_tpu_torch.io.session',
                 'zkstream_tpu_torch.io.pool',
                 'zkstream_tpu_torch.io.cache',
                 'zkstream_tpu_torch.io.ingress',
                 'zkstream_tpu_torch.server',
                 'zkstream_tpu_torch.server.persist',
                 'zkstream_tpu_torch.server.store',
                 'zkstream_tpu_torch.server.watchtable',
                 'zkstream_tpu_torch.server.server',
                 'zkstream_tpu_torch.server.replication',
                 'zkstream_tpu_torch.server.election',
                 'zkstream_tpu_torch.server.member_worker',
                 'zkstream_tpu_torch.io.faults',
                 'zkstream_tpu_torch.io.invariants',
                 'zkstream_tpu_torch.analysis',
                 'zkstream_tpu_torch.analysis.core',
                 'zkstream_tpu_torch.analysis.spans',
                 'zkstream_tpu_torch.analysis.ackorder',
                 'zkstream_tpu_torch.analysis.drift',
                 'zkstream_tpu_torch.analysis.faultorder',
                 'zkstream_tpu_torch.analysis.locks',
                 'zkstream_tpu_torch.analysis.loopblock',
                 'zkstream_tpu_torch.analysis.linearize',
                 'zkstream_tpu_torch.cli',
                 'zkstream_tpu_torch.__main__',
                 'zkstream_tpu_torch.bench',
                 'zkstream_tpu_torch.utils.loadgen',
                 'zkstream_tpu_torch.tools',
                 'zkstream_tpu_torch.tools.read_worker',
                 'zkstream_tpu_torch.tools.bench_linearize',
                 'zkstream_tpu_torch.tools.profile_hotpath',
                 'zkstream_tpu_torch.tools.asan_check',
                 'zkstream_tpu_torch.tools.crossover_encode',
                 'zkstream_tpu_torch.tools.diag_ingest',
                 'zkstream_tpu_torch.tools.sweep_crossover',
                 'zkstream_tpu_torch.tools.cover'):
        assert name in mods


@pytest.mark.parametrize('script', ['modules', 'chip_smoke', 'native',
                                    'parallel', 'client', 'bench'])
def test_imports_load_no_jax(script):
    if script == 'bench':
        # the bench's flagship stages on the CPU at a tiny B, the load
        # generator's build and argv, and the read worker's codec
        body = ('from zkstream_tpu_torch import bench\n'
                'from zkstream_tpu_torch.utils import loadgen\n'
                'from zkstream_tpu_torch.tools import read_worker\n'
                'bench.B = 2\n'
                'buf, lens, streams, slots = bench._fleet()\n'
                'mibs, pkts = bench.bench_scalar_full(streams, slots)\n'
                "bench.bench_tensor(buf, lens, streams, pkts, slots, "
                "device='cpu')\n"
                "loadgen.argv([('127.0.0.1', 1)], 1)\n"
                'read_worker._setup_path()\n'
                'from zkstream_tpu_torch.protocol.framing import '
                'PacketCodec\n')
    elif script == 'modules':
        body = 'import importlib\n' + ''.join(
            'importlib.import_module(%r)\n' % m for m in _modules())
    elif script == 'parallel':
        # the mesh plane imported and run end to end on CPU shards
        body = ('import zkstream_tpu_torch.parallel\n'
                'import zkstream_tpu_torch.ops.seq_walk\n'
                'from zkstream_tpu_torch.entry import dryrun_multichip\n'
                "dryrun_multichip(2, device='cpu')\n")
    elif script == 'client':
        # the client stack against the port's own server over TCP: one
        # create and one get through a port Client, with the C tiers
        body = ('import asyncio\n'
                'from zkstream_tpu_torch import Client\n'
                'from zkstream_tpu_torch.server import ZKServer\n'
                'from zkstream_tpu_torch.utils import native\n'
                'native.ensure_ext()\n'
                'async def main():\n'
                '    srv = await ZKServer().start()\n'
                "    c = Client(address='127.0.0.1', port=srv.port)\n"
                '    c.start()\n'
                '    try:\n'
                '        await c.wait_connected(timeout=10)\n'
                "        await c.create('/x', b'v')\n"
                "        assert (await c.get('/x'))[0] == b'v'\n"
                '    finally:\n'
                '        await c.close()\n'
                '        await srv.stop()\n'
                'asyncio.run(main())\n')
    elif script == 'native':
        # the host codec tier built, loaded and used: the C extension's
        # setup pulls in the port's records and consts only
        body = ('from zkstream_tpu_torch.utils import native\n'
                'from zkstream_tpu_torch.protocol.framing import '
                'PacketCodec\n'
                'assert native.ensure_lib() is not None\n'
                'ext = native.ensure_ext()\n'
                "assert ext.__name__ == '_zkwire_ext_torch'\n"
                'c = PacketCodec(use_native=True)\n'
                'c.handshaking = False\n'
                "c.xid_map[1] = 'DELETE'\n"
                "assert c.decode(bytes.fromhex('00000010' '00000001'\n"
                "                              '0000000000000009'\n"
                "                              '00000000')) == [\n"
                "    {'xid': 1, 'zxid': 9, 'err': 'OK', "
                "'opcode': 'DELETE'}]\n")
    else:
        # chip_smoke's imports, without running it
        body = ('import importlib.util\n'
                "spec = importlib.util.spec_from_file_location('cs', %r)\n"
                'mod = importlib.util.module_from_spec(spec)\n'
                'spec.loader.exec_module(mod)\n'
                % os.path.join(_ROOT, 'chip_smoke.py'))
    code = body + (
        'import sys\n'
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'zkstream_tpu' or "
        "m.startswith('zkstream_tpu.'))\n"
        'assert not bad, bad\n'
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env['PYTHONPATH'] = _ROOT
    res = subprocess.run([sys.executable, '-c', code], cwd=_ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith('ok')


@pytest.mark.parametrize('script', ['packages', 'member', 'bench_wal'])
def test_server_side_loads_no_torch(script):
    """The package, its client, server, CLI and analysis modules load no
    torch (the ingest defers it), and neither does a running ensemble
    member: a member process, spawned again after every SIGKILL, pays
    for no torch import it never uses.  ``FleetIngest`` and ``ops/``
    still import it.  The bench's host-only families (``--wal`` here,
    through ``main()`` at a small size) load none either."""
    if script == 'bench_wal':
        body = ('import os\n'
                "os.environ['ZKSTREAM_BENCH_WAL_ROUNDS'] = '1'\n"
                'from zkstream_tpu_torch import bench\n'
                'bench.OPS_TOTAL = 32\n'
                'bench.WAL_SCALES = (4,)\n'
                "sys.argv = ['bench', '--wal']\n"
                'bench.main()\n'
                "assert 'torch' not in sys.modules\n")
    elif script == 'packages':
        body = ('import zkstream_tpu_torch\n'
                'import zkstream_tpu_torch.client\n'
                'import zkstream_tpu_torch.server\n'
                'import zkstream_tpu_torch.cli\n'
                'import zkstream_tpu_torch.analysis\n'
                'import zkstream_tpu_torch.io.faults\n'
                'import zkstream_tpu_torch.io.ingest\n'
                "assert 'torch' not in sys.modules\n"
                'from zkstream_tpu_torch.io.ingest import FleetIngest\n'
                "FleetIngest(device='cpu')\n"
                "assert 'torch' in sys.modules\n")
    else:
        # the member worker's main() in a thread until it serves
        # clients: READY means it recovered, elected itself and serves
        body = ('import io, socket, tempfile, threading, time\n'
                'from zkstream_tpu_torch.server import member_worker\n'
                'from zkstream_tpu_torch.server.election import '
                'allocate_ports\n'
                'cport, eport = allocate_ports(2)\n'
                "sys.argv = ['member_worker.py', '0', tempfile.mkdtemp(), "
                'str(cport), str(eport)]\n'
                'out, sys.stdout = sys.stdout, io.StringIO()\n'
                'threading.Thread(target=member_worker.main, '
                'daemon=True).start()\n'
                'deadline = time.monotonic() + 60\n'
                "while 'READY' not in sys.stdout.getvalue():\n"
                '    assert time.monotonic() < deadline\n'
                '    time.sleep(0.05)\n'
                'sys.stdout = out\n'
                "socket.create_connection(('127.0.0.1', cport)).close()\n"
                "assert 'torch' not in sys.modules\n")
    code = ('import sys\n' + body
            + "print('ok', flush=True)\nimport os\nos._exit(0)\n")
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env['PYTHONPATH'] = _ROOT
    res = subprocess.run([sys.executable, '-c', code], cwd=_ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith('ok')


@pytest.mark.parametrize('what', ['entry', 'ingest', 'ingest_device',
                                  'batch', 'mesh', 'mesh_ingest',
                                  'multihost_ingest', 'dryrun',
                                  'schedule', 'cli', 'sweep_cell',
                                  'encode_batch', 'diag'])
def test_default_device_raises_without_card(what):
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default device is valid')
    import asyncio

    from zkstream_tpu_torch import cli
    from zkstream_tpu_torch.entry import dryrun_multichip, entry
    from zkstream_tpu_torch.io.ingest import FleetIngest
    from zkstream_tpu_torch.ops.pipeline import batch_to_device
    from zkstream_tpu_torch.parallel import (MeshFleetIngest,
                                             MultihostFleetIngest, make_mesh)
    from zkstream_tpu_torch.tools import (crossover_encode, diag_ingest,
                                         sweep_crossover)

    import numpy as np

    call = {'entry': entry, 'ingest': FleetIngest,
            'ingest_device': lambda: FleetIngest(body_mode='device'),
            'batch': lambda: batch_to_device(
                np.zeros((2, 8), np.uint8), np.zeros((2,), np.int32)),
            'mesh': make_mesh, 'mesh_ingest': MeshFleetIngest,
            'multihost_ingest': MultihostFleetIngest,
            'dryrun': lambda: dryrun_multichip(2),
            'schedule': lambda: asyncio.run(_batch_schedule()),
            'cli': lambda: cli.main(['--codec', 'ingest', 'ping']),
            'sweep_cell': lambda: asyncio.run(
                sweep_crossover.run_cell('native', 2)),
            'encode_batch': lambda: crossover_encode.bench_device_batch(
                8, 1, 1),
            'diag': lambda: asyncio.run(diag_ingest.run(2, 1))}
    with pytest.raises(RuntimeError, match='CUDA'):
        call[what]()


async def _batch_schedule():
    """The first seeded ensemble schedule whose plan drives a batch-
    regime ``FleetIngest``, on the default device."""
    from zkstream_tpu_torch.io.faults import FaultPlan, run_ensemble_schedule

    seed = next(s for s in range(200)
                if FaultPlan.randomized(s).ingest_mode == 'batch')
    return await run_ensemble_schedule(seed)


def test_cpu_entry_runs_plain_version():
    from zkstream_tpu_torch.entry import entry
    from zkstream_tpu_torch.ops import wire_scan

    fn, args = entry(device='cpu')
    before = wire_scan.launches
    st = fn(*args)
    assert wire_scan.launches == before        # no kernel on the CPU
    assert int(st.n_frames.min()) > 0 and not bool(st.bad.any())
