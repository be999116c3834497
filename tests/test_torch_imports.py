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
                 'zkstream_tpu_torch.corpus', 'zkstream_tpu_torch.entry'):
        assert name in mods


@pytest.mark.parametrize('script', ['modules', 'chip_smoke', 'native',
                                    'parallel'])
def test_imports_load_no_jax(script):
    if script == 'modules':
        body = 'import importlib\n' + ''.join(
            'importlib.import_module(%r)\n' % m for m in _modules())
    elif script == 'parallel':
        # the mesh plane imported and run end to end on CPU shards
        body = ('import zkstream_tpu_torch.parallel\n'
                'import zkstream_tpu_torch.ops.seq_walk\n'
                'from zkstream_tpu_torch.entry import dryrun_multichip\n'
                "dryrun_multichip(2, device='cpu')\n")
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


@pytest.mark.parametrize('what', ['entry', 'ingest', 'ingest_device',
                                  'batch', 'mesh', 'mesh_ingest',
                                  'multihost_ingest', 'dryrun'])
def test_default_device_raises_without_card(what):
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default device is valid')
    from zkstream_tpu_torch.entry import dryrun_multichip, entry
    from zkstream_tpu_torch.io.ingest import FleetIngest
    from zkstream_tpu_torch.ops.pipeline import batch_to_device
    from zkstream_tpu_torch.parallel import (MeshFleetIngest,
                                             MultihostFleetIngest, make_mesh)

    import numpy as np

    call = {'entry': entry, 'ingest': FleetIngest,
            'ingest_device': lambda: FleetIngest(body_mode='device'),
            'batch': lambda: batch_to_device(
                np.zeros((2, 8), np.uint8), np.zeros((2,), np.int32)),
            'mesh': make_mesh, 'mesh_ingest': MeshFleetIngest,
            'multihost_ingest': MultihostFleetIngest,
            'dryrun': lambda: dryrun_multichip(2)}
    with pytest.raises(RuntimeError, match='CUDA'):
        call[what]()


def test_cpu_entry_runs_plain_version():
    from zkstream_tpu_torch.entry import entry
    from zkstream_tpu_torch.ops import wire_scan

    fn, args = entry(device='cpu')
    before = wire_scan.launches
    st = fn(*args)
    assert wire_scan.launches == before        # no kernel on the CPU
    assert int(st.n_frames.min()) > 0 and not bool(st.bad.any())
