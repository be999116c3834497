"""The port's measuring tools (``zkstream_tpu_torch/tools/``) held to the
JAX package's ``tools/`` on the same seeded input, on the CPU.

The reference's ``sweep_crossover`` pins JAX to one CPU device when it
is imported, so its cells run in a subprocess; the other reference
tools are loaded from their files in this process."""

import asyncio
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from zkstream_tpu_torch.tools import (bench_linearize, crossover_encode,
                                     diag_ingest, profile_hotpath)
from zkstream_tpu_torch.tools import sweep_crossover as SC

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ref_tool(name: str):
    """The JAX package's ``tools/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        '_reference_tool_' + name, os.path.join(_ROOT, 'tools', name + '.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- bench_linearize ---------------------------------------------------------

_LIN_CELLS = [(length, length, clients)
              for length, clients in bench_linearize.CELLS] + [
    (7, 120, 3), (11, 300, 5)]


@pytest.mark.parametrize('seed,length,clients', _LIN_CELLS)
def test_bench_linearize_histories_and_verdicts(seed, length, clients):
    ref = _ref_tool('bench_linearize')
    from zkstream_tpu.analysis.linearize import check_linearizable as ref_check

    from zkstream_tpu_torch.analysis.linearize import check_linearizable

    h, finals = bench_linearize.synth_history(seed, length, clients)
    rh, rfinals = ref.synth_history(seed, length, clients)
    assert h.records == rh.records and finals == rfinals
    assert check_linearizable(h, finals) == [] == ref_check(rh, rfinals)
    # a read that observed data nobody wrote: both checkers flag it
    read = next(r for r in h.records if r['kind'] == 'settle'
                and r['status'] == 'ok' and r['data'] is not None)
    i = h.records.index(read)
    h.records[i] = dict(read, data=b'forged')
    rh.records[i] = dict(rh.records[i], data=b'forged')
    got, want = check_linearizable(h, finals), ref_check(rh, rfinals)
    assert got and len(got) == len(want)


def test_bench_linearize_main_exits_0(capsys):
    assert bench_linearize.main(['--rounds', '1']) == 0
    out = capsys.readouterr().out
    assert out.count(' ok\n') == len(bench_linearize.CELLS)
    assert (bench_linearize.CELL_BUDGET_MS,
            bench_linearize.CAMPAIGN_BUDGET_MS) == (2000.0, 250.0)


# -- profile_hotpath ---------------------------------------------------------

@pytest.mark.parametrize('frames,data_len', [(1, 0), (64, 64), (300, 17)])
def test_profile_hotpath_corpora_and_tiers(frames, data_len):
    ref = _ref_tool('profile_hotpath')
    from zkstream_tpu.protocol.framing import FrameDecoder as RefDecoder
    from zkstream_tpu.protocol.framing import PacketCodec as RefCodec

    from zkstream_tpu_torch.protocol.framing import FrameDecoder
    from zkstream_tpu_torch.utils import native

    stream = profile_hotpath.mk_stream(frames, data_len)
    assert stream == ref.mk_stream(frames, data_len)
    assert profile_hotpath.mk_encode_corpora(frames, data_len) == \
        ref.mk_encode_corpora(frames, data_len)

    rc = RefCodec(use_native=False)
    rc.handshaking = False
    rc.xid_map = {i + 1: 'GET_DATA' for i in range(frames)}
    want = rc.decode(stream)
    assert len(want) == frames
    assert list(FrameDecoder(use_native=False).feed(stream)) == \
        list(RefDecoder(use_native=False).feed(stream))
    assert profile_hotpath.tier_codec(stream, frames, False) == want
    assert native.ensure_ext() is not None
    assert profile_hotpath.tier_codec(stream, frames, True) == want


@pytest.mark.parametrize('mode', ['decode', 'encode', 'ingress'])
def test_profile_hotpath_main_runs(mode, capsys):
    argv = ['--frames', '40', '--reps', '1']
    if mode != 'decode':
        argv.append('--' + mode)
    profile_hotpath.main(argv)
    out = capsys.readouterr().out
    want = {'decode': 'full-decode (C ext)', 'encode': 'C extension',
            'ingress': 'drain_recv (C, one call)'}[mode]
    assert want in out


# -- crossover_encode --------------------------------------------------------

@pytest.mark.parametrize('n,frames', [(8, 1), (128, 1), (16, 3)])
def test_crossover_encode_device_bytes_equal_reference(n, frames):
    import jax.numpy as jnp

    from zkstream_tpu.ops.encode import build_reply_streams

    f = crossover_encode.batch_fields(n, frames)
    buf, lens = build_reply_streams(
        *[jnp.asarray(f[k]) for k in ('xid', 'zxid_hi', 'zxid_lo', 'err',
                                      'body_sizes')], out_len=frames * 24)
    buf, lens = np.asarray(buf), np.asarray(lens)
    want = [buf[i, :lens[i]].tobytes() for i in range(n)]
    assert crossover_encode.device_streams(n, frames, 'cpu') == want
    assert crossover_encode.host_streams(f) == want
    r = crossover_encode.bench_device_batch(n, frames, 1, device='cpu')
    assert r['bytes_equal_host'] and r['platform'] == 'cpu'


def test_crossover_encode_main_cpu(capsys):
    crossover_encode.main(['--conns', '8', '--reps', '2', '--device', 'cpu'])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r['what'] for r in lines] == [
        'host_fanout_encode_once', 'host_replies_c', 'host_replies_py',
        'device_batch_encode']


# -- sweep_crossover ---------------------------------------------------------

_GETS = 256

_REF_KEYS = r'''
import asyncio, importlib.util, json, sys
spec = importlib.util.spec_from_file_location('ref_sweep',
                                              'tools/sweep_crossover.py')
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
mod.GETS_TOTAL = %d


def keys(d):
    return {k: sorted(v) if isinstance(v, dict) and k != 'flush' else None
            for k, v in d.items()}


out = {}
for mode in ('native', 'ingest-auto'):
    for workload in ('get', 'write'):
        r = asyncio.run(mod.run_cell(mode, 8, workload))
        out['%%s/%%s' %% (mode, workload)] = keys(r)
print(json.dumps(out))
''' % _GETS


@pytest.fixture(scope='module')
def reference_cell_keys():
    """The keys (and sub-keys) of the reference's cells at 8
    connections, for a scalar and an ingest mode and each workload."""
    env = dict(os.environ, JAX_PLATFORMS='cpu', PYTHONPATH=_ROOT)
    res = subprocess.run([sys.executable, '-c', _REF_KEYS], cwd=_ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


_MODES = ('python', 'native', 'ingest', 'ingest-auto', 'ingest-py',
          'ingest-py-dev', 'native-nocork', 'ingest-legacy')


@pytest.mark.parametrize('workload', ['get', 'write'])
@pytest.mark.parametrize('mode', _MODES)
def test_sweep_cell_cpu(mode, workload, reference_cell_keys, monkeypatch):
    monkeypatch.setattr(SC, 'GETS_TOTAL', _GETS)
    n = 8
    r = asyncio.run(SC.run_cell(mode, n, workload, device='cpu'))
    base = mode.split('-nocork')[0].split('-legacy')[0]
    ref = reference_cell_keys['%s/%s' % (
        'native' if base in ('python', 'native') else 'ingest-auto',
        workload)]
    assert set(ref) <= set(r)
    for k, sub in ref.items():
        if sub is not None:
            assert set(sub) <= set(r[k]), k
    assert (r['mode'], r['conns'], r['workload']) == (mode, n, workload)
    ops = r[workload]
    assert ops['count'] == ops['expected'] == max(
        4 if workload == 'get' else 6, _GETS // n) * n
    assert ops['ops_per_sec'] > 0
    if workload == 'get':
        assert r['fanout']['fired'] == [n] * SC.STORMS
        assert r['fanout']['events'] == n
    ing = r.get('ingest')
    assert (ing is not None) == base.startswith('ingest')
    if ing is None:
        return
    assert ing['frag_ticks'] <= ing['scalar_ticks']
    assert ing['frames_per_tick'] == round(
        ing['frames'] / max(1, ing['ticks']), 1)
    assert ing['frames'] >= ops['count'] + (
        SC.STORMS * n if workload == 'get' else 0)
    assert ing['bytes'] > 0 and ing['bytes_per_tick'] > 0
    assert ing['k1_launches'] == ing['k2_launches'] == 0   # plain versions
    assert ing['tick_ms']['count'] >= 1
    if base == 'ingest-auto':
        # 8 connections stay far below the byte threshold: every tick
        # is the pass-through drain
        assert ing['ticks'] == 0 and ing['scalar_ticks'] > 0
    else:
        assert ing['ticks'] > 0 and ing['scalar_ticks'] == 0
        assert ing['frag_ticks'] == 0


def test_sweep_paired_and_main_cpu(monkeypatch, capsys):
    monkeypatch.setattr(SC, 'GETS_TOTAL', 64)
    s = SC.run_paired('ingest-auto', 'native', [8], 2, device='cpu')
    assert len(s) == 1 and s[0]['pairs'] == 2
    assert s[0]['wins'] + s[0]['losses'] <= 2
    assert s[0]['routing']['device_frac'] == 0.0
    assert 0.0 < s[0]['sign_p'] <= 1.0
    capsys.readouterr()
    SC.main(['--conns', '8', '--modes', 'native,ingest', '--rounds', '1',
             '--workload', 'write', '--device', 'cpu'])
    lines = capsys.readouterr().out.splitlines()
    best = [json.loads(x) for x in lines if not x.startswith('#')]
    assert [(r['mode'], r['conns']) for r in best] == [('native', 8),
                                                       ('ingest', 8)]
    assert all('error' not in r for r in best)


# -- diag_ingest -------------------------------------------------------------

def test_diag_ingest_phase_split_sums_to_tick():
    from zkstream_tpu_torch.io.ingest import FleetIngest

    before = dict(FleetIngest.__dict__)
    r = asyncio.run(diag_ingest.run(8, 15, device='cpu'))
    assert r['creates'] == 8 * 15 and r['device_ticks'] > 0
    parts = sum(r['phases_ms'][p] for p in diag_ingest.PHASES)
    assert abs(r['tick_ms'] - parts) <= 0.10 * r['tick_ms']
    assert r['phases_ms']['step'] > 0 and r['phases_ms']['route'] > 0
    assert r['phases_ms']['assemble'] <= r['phases_ms']['route']
    assert r['k1'] == 0                       # the plain version ran
    # the class is as it was before the run
    assert all(FleetIngest.__dict__[k] is v for k, v in before.items())


# -- asan_check --------------------------------------------------------------

@pytest.mark.parametrize('mode', ['asan', 'ubsan'])
def test_asan_check_storm_exits_0(mode):
    env = dict(os.environ, ASAN_ROUNDS='300', PYTHONPATH=_ROOT)
    argv = [sys.executable, '-m', 'zkstream_tpu_torch.tools.asan_check']
    if mode == 'ubsan':
        argv.append('--ubsan')
    res = subprocess.run(argv, cwd=_ROOT, env=env, capture_output=True,
                         text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    assert 'valid corpora: OK' in res.stdout
    assert 'mutation storm (300 rounds x 2 calls): no %s reports' % (
        mode.upper(),) in res.stdout


# -- cover -------------------------------------------------------------------

def test_cover_counts_the_port_package():
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    res = subprocess.run(
        [sys.executable, 'zkstream_tpu_torch/tools/cover.py',
         'tests/test_torch_bytesops.py', '-q', '-p', 'no:cacheprovider',
         '-p', 'no:xdist', '-p', 'no:randomly'],
        cwd=_ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    rows = {ln.split()[0]: ln.split()[1:] for ln in res.stdout.splitlines()
            if ln.startswith(('zkstream_tpu', 'TOTAL'))}
    hit, total, _pct = rows['zkstream_tpu_torch/ops/bytesops.py']
    assert 0 < int(hit) <= int(total)
    assert not any(k.startswith('zkstream_tpu/') for k in rows)
    assert int(rows['TOTAL'][0]) > 0
