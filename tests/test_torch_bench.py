"""The port's bench (zkstream_tpu_torch/bench.py) against the JAX
package's root ``bench.py``, on the CPU at a small ``B``.

- ``bench_tensor`` on ``device='cpu'`` (the plain versions of K1 and
  K2): its tick, toy-width and deployed-width planes, as the gates see
  them, equal field for field (tolerance 0: every plane is integer or
  bool) the JAX package's ``wire_pipeline_step``,
  ``parse_reply_bodies`` and ``parse_list_bodies`` on CPU JAX over the
  same ``_fleet`` bytes;
- ``bench_scalar_full``'s packets equal the reference bench's;
- the three gates pass on the port's planes and raise on a copy with
  one corrupted field;
- ``main()`` raises without a card unless ``--device cpu`` is given,
  and with it prints the reference's three metric lines, flagship last;
- the smallest cell of each host-only family runs on the port and
  returns the reference cell's keys.
"""

from __future__ import annotations

import asyncio
import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as RB
from zkstream_tpu.ops import pipeline as JP
from zkstream_tpu.ops import replies as JR
from zkstream_tpu_torch import bench as TB
from zkstream_tpu_torch.ops import pipeline as TP

from test_torch_ingest import _norm

SMALL_B = 8


def _same(want, got, path):
    """Every field of two (nested) NamedTuples equal, array for array
    (``got`` holds torch tensors on the CPU)."""
    if hasattr(want, '_fields'):
        assert type(want).__name__ == type(got).__name__, path
        assert want._fields == got._fields, path
        for f in want._fields:
            _same(getattr(want, f), getattr(got, f), path + '.' + f)
        return
    w, g = np.asarray(want), got.numpy()
    assert w.shape == g.shape, (path, w.shape, g.shape)
    assert w.dtype == g.dtype, (path, w.dtype, g.dtype)
    np.testing.assert_array_equal(w, g, err_msg=path)


@pytest.fixture(scope='module')
def run():
    """One ``bench_tensor`` run on the CPU at ``B = 8``, with the
    planes its tick candidate returned and those its gates read."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TB, 'B', SMALL_B)
        seen = {}
        real_gate = TB._gate_differential
        real_tick = TP.wire_pipeline_step_auto

        def gate(st, bd, lb, pkts, slots, max_data, max_path):
            seen[max_data] = (st, bd, lb)
            return real_gate(st, bd, lb, pkts, slots, max_data=max_data,
                             max_path=max_path)

        def tick(buf, lens, max_frames=32):
            seen['tick'] = real_tick(buf, lens, max_frames=max_frames)
            return seen['tick']

        mp.setattr(TB, '_gate_differential', gate)
        mp.setattr(TP, 'wire_pipeline_step_auto', tick)
        buf, lens, streams, slots = TB._fleet()
        _mibs, pkts = TB.bench_scalar_full(streams, slots)
        calls = {}
        mibs = TB.bench_tensor(buf, lens, streams, pkts, slots,
                               device='cpu', calls=calls)
    return {'buf': buf, 'lens': lens, 'streams': streams, 'slots': slots,
            'pkts': pkts, 'seen': seen, 'mibs': mibs, 'calls': calls}


@pytest.fixture(scope='module')
def ref(run):
    """The JAX package's planes over the same bytes."""
    jb, jl = jnp.asarray(run['buf']), jnp.asarray(run['lens'])
    st = JP.wire_pipeline_step(jb, jl, max_frames=RB.FRAMES)
    return {
        'st': st,
        16: JR.parse_reply_bodies(jb, st.starts, st.sizes, max_data=16,
                                  max_path=8),
        RB.DEP_DATA: JR.parse_reply_bodies(
            jb, st.starts, st.sizes, max_data=RB.DEP_DATA,
            max_path=RB.DEP_PATH),
        'lb': JR.parse_list_bodies(
            jb, st.starts, st.sizes, max_children=RB.DEP_CHILDREN,
            max_name=RB.DEP_NAME, max_acls=RB.DEP_ACLS,
            max_scheme=RB.DEP_SCHEME, max_id=RB.DEP_ID),
    }


def test_constants_are_the_reference_benchs():
    for name in ('B', 'FRAMES', 'REPEATS', 'DEP_DATA', 'DEP_PATH',
                 'DEP_CHILDREN', 'DEP_NAME', 'DEP_ACLS', 'DEP_SCHEME',
                 'DEP_ID', 'DATA_LEN', 'CH2_N', 'CH_N', 'ACL_N',
                 'SCALAR_FULL_STREAMS', 'CHECK_STREAMS', 'CLIENT_SCALES',
                 'OPS_TOTAL'):
        assert getattr(TB, name) == getattr(RB, name), name


def test_fleet_and_schedule_equal_reference(monkeypatch):
    for m in (RB, TB):
        monkeypatch.setattr(m, 'B', 5)
    want = RB._fleet()
    got = TB._fleet()
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] and got[3] == want[3]
    assert TB._slot_schedule() == RB._slot_schedule()
    assert TB._xid_maps(got[2], got[3]) == RB._xid_maps(want[2], want[3])


def test_bench_tensor_timed_every_candidate(run):
    tick, full, deployed = run['mibs']
    assert tick > 0 and full > 0 and deployed > 0
    reps = max(6, TB.REPEATS // 3)
    assert run['calls'] == {'tick': 1 + 4 * reps, 'full': 1 + 4 * reps,
                            'full-deployed': 1 + 4 * max(4, reps // 5)}


def test_tick_planes_equal_jax(run, ref):
    _same(ref['st'], run['seen']['tick'], 'tick')


@pytest.mark.parametrize('width', [16, RB.DEP_DATA],
                         ids=['toy', 'deployed'])
def test_full_decode_planes_equal_jax(run, ref, width):
    st, bd, lb = run['seen'][width]
    _same(ref['st'], st, 'st')
    _same(ref[width], bd, 'bodies')
    if width == RB.DEP_DATA:
        _same(ref['lb'], lb, 'lists')
    else:
        assert lb is None


def test_scalar_full_packets_equal_reference(run, monkeypatch):
    monkeypatch.setattr(RB, 'B', SMALL_B)
    buf, lens, streams, slots = RB._fleet()
    _mibs, want = RB.bench_scalar_full(streams, slots)
    assert len(want) == SMALL_B and len(want[0]) == RB.FRAMES
    assert _norm(run['pkts']) == _norm(want)


def test_scalar_baselines_run(run):
    assert TB.bench_scalar(run['streams']) > 0
    ext = TB.bench_ext_full(run['streams'], run['slots'])
    assert ext is None or ext > 0


def _corrupt(planes, field, index, how):
    """A copy of ``planes`` with one element of ``field`` changed."""
    t = getattr(planes, field).clone()
    t[index] = how(t[index])
    return planes._replace(**{field: t})


def _slot(run, kinds):
    return next(f for f, s in enumerate(run['slots']) if s['kind'] in kinds)


@pytest.mark.parametrize('gate', ['planes', 'differential',
                                  'list_agreement'])
def test_gates_pass_and_catch_one_corrupted_field(run, monkeypatch, gate):
    monkeypatch.setattr(TB, 'B', SMALL_B)
    st, bd, lb = run['seen'][RB.DEP_DATA]
    fd = _slot(run, ('data',))
    fc = _slot(run, ('children', 'children2'))
    if gate == 'planes':
        TB._gate_planes(st, bd, lb, run['slots'])
        bad = _corrupt(bd, 'data_len', (3, fd), lambda x: x + 1)
        with pytest.raises(AssertionError):
            TB._gate_planes(st, bad, lb, run['slots'])
    elif gate == 'differential':
        TB._gate_differential(st, bd, lb, run['pkts'], run['slots'],
                              max_data=RB.DEP_DATA, max_path=RB.DEP_PATH)
        bad = _corrupt(bd, 'data', (2, fd, 7), lambda x: x ^ 1)
        with pytest.raises(AssertionError):
            TB._gate_differential(st, bad, lb, run['pkts'], run['slots'],
                                  max_data=RB.DEP_DATA,
                                  max_path=RB.DEP_PATH)
    else:
        TB._gate_list_agreement(lb, run['streams'], run['slots'])
        bad = _corrupt(lb, 'ch_count', (1, fc), lambda x: x + 1)
        with pytest.raises(AssertionError):
            TB._gate_list_agreement(bad, run['streams'], run['slots'])


def test_main_raises_without_a_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default device is valid')
    monkeypatch.setattr(sys, 'argv', ['bench'])
    with pytest.raises(RuntimeError, match='CUDA'):
        TB.main()


def test_main_on_cpu_prints_the_reference_lines(monkeypatch, capsys):
    """``--device cpu`` at ``B = 8``: the three metric lines with the
    reference's names, units and fields (plus ``device`` and
    ``power_limit``), the flagship last; the client-ops cells run with
    their ingest arm on the CPU."""
    monkeypatch.setattr(sys, 'argv', ['bench', '--device', 'cpu'])
    monkeypatch.setattr(TB, 'B', SMALL_B)
    monkeypatch.setattr(TB, 'CLIENT_SCALES', (8,))
    monkeypatch.setattr(TB, 'OPS_TOTAL', 64)
    TB.main()
    out, err = capsys.readouterr()
    lines = [json.loads(x) for x in out.strip().splitlines()]
    names = [x['metric'] for x in lines]
    assert names[:2] == ['wire_decode_throughput',
                         'wire_full_decode_toy_width']
    assert names[-1] == 'wire_full_decode_throughput'
    # the client-ops headline goes to stderr, as the reference's does
    assert '"metric": "client_get_ops_per_sec"' in err
    for x in (lines[0], lines[1], lines[-1]):
        assert x['unit'] == 'MiB/s' and x['value'] > 0
        assert x['vs_baseline'] > 0
        assert x['backend'] == 'cpu'
        assert x['power_limit'] is None and x['device']
    assert lines[-1]['widths'] == 'data256/path256/ch16x64/acl4'
    assert lines[-1]['corpus'].startswith('mixed-opcode %dx%d'
                                          % (SMALL_B, RB.FRAMES))
    assert 'kernel launches in bench_tensor on cpu: K1 0' in err
    cells = [json.loads(x.split(' ', 2)[2]) for x in err.splitlines()
             if x.startswith('# client_ops {')]
    ingest = [c for c in cells if c['mode'] == 'ingest']
    assert ingest and all(c['ingest_ticks'] > 0 for c in ingest)


def test_device_argument(monkeypatch):
    for argv, want in ((['bench'], 'cuda'),
                       (['bench', '--device', 'cpu'], 'cpu'),
                       (['bench', '--device', 'cuda'], 'cuda')):
        monkeypatch.setattr(sys, 'argv', argv)
        assert TB._device_arg() == want
    monkeypatch.setattr(sys, 'argv', ['bench', '--device', 'tpu'])
    with pytest.raises(SystemExit):
        TB._device_arg()


def test_every_host_family_dispatches(monkeypatch):
    """Each host-only flag reaches its family function, none of them
    probes a device, and the reference's families are all there."""
    ran = []
    for flag, fn in TB._HOST_FAMILIES:
        monkeypatch.setattr(TB, fn, lambda fn=fn: ran.append(fn))
        monkeypatch.setattr(sys, 'argv', ['bench', flag])
        TB.main()
    assert ran == [fn for _f, fn in TB._HOST_FAMILIES]
    assert all(hasattr(RB, fn) for fn in ran)
    monkeypatch.setattr(TB, 'bench_client_ops',
                        lambda **kw: ran.append(kw))
    monkeypatch.setattr(sys, 'argv', ['bench', '--write', '--device',
                                      'cpu'])
    TB.main()
    assert ran[-1] == {'write_heavy': True, 'device': 'cpu'}


# -- the host-only families: smallest cell, reference keys -------------

def _keys(x, depth=2):
    """The key structure of a cell (dicts to ``depth``)."""
    if isinstance(x, dict) and depth:
        return {k: _keys(v, depth - 1) for k, v in x.items()}
    if isinstance(x, list) and x and isinstance(x[0], dict) and depth:
        return [_keys(x[0], depth - 1)]
    return None


def _batched(pkg):
    """The batched transport backend ``pkg``'s probe picks (after its C
    extension is built), or 'asyncio'."""
    import importlib

    importlib.import_module(pkg + '.utils.native').ensure_ext()
    p = importlib.import_module(pkg + '.io.transport').probe()
    return 'uring' if p.uring else ('mmsg' if p.mmsg else 'asyncio')


def _cell(M, pkg, family):
    from importlib import import_module

    Collector = import_module(pkg + '.utils.metrics').Collector
    if family == 'wal':
        return M._client_ops_run('python', M.WAL_SCALES[0],
                                 write_heavy=True, wal='always')
    if family == 'election':
        return M._election_round(M.ELECTION_SCALES[0])
    if family == 'quorum':
        return M._quorum_round(M.QUORUM_SCALES[0], True)
    if family == 'multi':
        return M._multi_round(M.MULTI_BATCHES[0])
    if family == 'reconfig':
        return M._reconfig_round(0)
    if family in ('traceov', 'write'):
        return M._client_ops_run('python', M.TRACE_SCALES[0],
                                 write_heavy=True)
    if family == 'blackbox':
        return M._client_ops_run('python', M.BLACKBOX_SCALES[0],
                                 write_heavy=True, wal='tick')
    if family == 'overload':
        return M._overload_defense_round(True)
    if family == 'transport':
        return M.transport_cell(M.TRANSPORT_SCALES[0], 'write',
                                _batched(pkg), collector=Collector(),
                                events=4)
    if family == 'ingress':
        return M.transport_cell(M.INGRESS_SCALES[0], 'fanout', 'asyncio',
                                collector=Collector(), events=4,
                                ingress_shards=2,
                                ingress_backend=_batched(pkg),
                                time_arms=True)
    if family == 'fanout':
        return M.fanout_cell(M.FANOUT_SESSIONS[0], M.FANOUT_WATCHERS[0],
                             True, collector=Collector())
    if family == 'read':
        return M._read_cell(M.READ_MEMBERS[0], M.READ_SESSIONS[0],
                            'mixed', 0.5)
    if family == 'million':
        return M._loadgen_fleet_cell(1, 200, duration=0.5, idle_ping=1.0,
                                     arm_watch=True, fanout_sets=1,
                                     setwatches_storm=True, pipeline=1)
    raise AssertionError(family)


#: keys whose nested content follows the run's timing (which phases a
#: tick ledger saw, which op kinds a histogram counted)
_TIMING_SHAPED = ('tick_ledger', 'op_latency_hist', 'flush_batches', 'ops',
                  'members_at_peak', 'caps', 'wal_stats')


@pytest.mark.parametrize('family', [
    'wal', 'election', 'quorum', 'multi', 'reconfig', 'traceov',
    'blackbox',
    # each package's defense cell waits out its three stalled clients'
    # closes (5 s apiece): about 30 s for the pair
    pytest.param('overload', marks=pytest.mark.slow),
    'transport', 'ingress', 'fanout', 'read', 'million', 'write'])
def test_host_family_smallest_cell_has_reference_keys(monkeypatch,
                                                      family):
    for M in (RB, TB):
        monkeypatch.setattr(M, 'OPS_TOTAL', 64)
        monkeypatch.setattr(M, 'QUORUM_OPS', 20)
        monkeypatch.setattr(M, 'RECONFIG_MIN_OPS', 5)
        monkeypatch.setattr(M, 'RECONFIG_CAP_OPS', 40)
    if family == 'traceov':
        monkeypatch.setenv('ZKSTREAM_NO_SERVER_TRACE', '1')
    cells = {}
    for name, M, pkg in (('port', TB, 'zkstream_tpu_torch'),
                         ('reference', RB, 'zkstream_tpu')):
        if name == 'reference':
            # the reference's tools/loadgen.c hangs in its connect phase
            # at two threads or more (ROADMAP queue 3); one thread
            # gives its cell's keys all the same.  The port's ran at
            # its default thread count above.
            monkeypatch.setenv('ZKSTREAM_LOADGEN_THREADS', '1')
        cells[name] = asyncio.run(_cell(M, pkg, family))
        assert cells[name] is not None, name
    port, want = cells['port'], cells['reference']
    assert set(port) == set(want)
    for k in want:
        if k not in _TIMING_SHAPED:
            assert _keys(port[k]) == _keys(want[k]), k
    if family == 'million':
        assert port['rc'] == 0 and port['connected'] == 200
    if family == 'read':
        assert port['driver'] == 'c'
