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
                 'zkstream_tpu_torch.corpus', 'zkstream_tpu_torch.entry'):
        assert name in mods


@pytest.mark.parametrize('script', ['modules', 'chip_smoke'])
def test_imports_load_no_jax(script):
    if script == 'modules':
        body = 'import importlib\n' + ''.join(
            'importlib.import_module(%r)\n' % m for m in _modules())
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
                                  'batch'])
def test_default_device_raises_without_card(what):
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default device is valid')
    from zkstream_tpu_torch.entry import entry
    from zkstream_tpu_torch.io.ingest import FleetIngest
    from zkstream_tpu_torch.ops.pipeline import batch_to_device

    import numpy as np

    call = {'entry': entry, 'ingest': FleetIngest,
            'ingest_device': lambda: FleetIngest(body_mode='device'),
            'batch': lambda: batch_to_device(
                np.zeros((2, 8), np.uint8), np.zeros((2,), np.int32))}
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
