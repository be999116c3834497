"""The JAX package's one-card ``jax.jit`` programs as the port runs them
(``ops/tick_graph.Program``), checked on the CPU.

On a card the sharded step and roundtrip (``parallel/sharded.py``) and
the sequence-parallel scan (``parallel/seqscan.py``) are each captured
once per key into a CUDA graph and replayed.  A capture records a fixed
sequence of launches, so what it records must not read device values on
the host (the scan's ``n`` above all), make tensors from host data,
produce data-dependent shapes or copy across devices.  Here each
program's function runs as it runs on a card, the kernels' outputs (K1's
plain version, and the plain chunk walk's final state, computed
beforehand) injected where they launch, under the dispatch mode of
``tests/test_torch_tick_graph.py`` that flags every such op, and its
outputs are held to the JAX package's on the same seeded inputs,
tolerance 0.  The program cache itself (keys, staging, outputs that
later calls leave alone, which meshes are graphed) runs the same way on
the CPU, where a program runs its function eagerly, and is checked
here; capture and replay run on the card (tests/test_torch_cuda.py).
"""

import random
import struct

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from test_torch_parallel import _fleet, _reply_frame  # noqa: E402
from test_torch_tick_graph import _CaptureCheck  # noqa: E402
from zkstream_tpu import parallel as JP  # noqa: E402
from zkstream_tpu_torch import parallel as PAR  # noqa: E402
from zkstream_tpu_torch.ops import encode as TE  # noqa: E402
from zkstream_tpu_torch.ops import pipeline as TP  # noqa: E402
from zkstream_tpu_torch.ops import seq_walk as SW  # noqa: E402
from zkstream_tpu_torch.ops import tick_graph as TG  # noqa: E402
from zkstream_tpu_torch.ops import wire_scan as TW  # noqa: E402
from zkstream_tpu_torch.parallel import sharded as TS  # noqa: E402
from zkstream_tpu_torch.parallel.mesh import Mesh  # noqa: E402


def _cpu_mesh(dp=1, sp=1):
    return PAR.make_mesh(dp=dp, sp=sp, devices=['cpu'] * (dp * sp))


def _np_out(out):
    from torch.utils._pytree import tree_flatten
    return [t.numpy() for t in tree_flatten(out)[0]]


def _same(want, got):
    """JAX outputs ``want`` and the port's ``got``, leaf for leaf,
    tolerance 0."""
    w = [np.asarray(x) for x in jax.tree_util.tree_leaves(want)]
    g = _np_out(got)
    assert len(w) == len(g)
    for a, b in zip(w, g):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# -- the programs as a card captures them --------------------------------

def _step_case(seed):
    buf, lens = _fleet(random.Random(seed), B=16, L=256)
    want = JP.sharded_wire_step(JP.make_mesh(dp=4, sp=2), max_frames=8)(
        jnp.asarray(buf), jnp.asarray(lens))
    fn = PAR.sharded_wire_step(_cpu_mesh(dp=4), max_frames=8)
    return fn, (torch.from_numpy(buf), torch.from_numpy(lens)), want


def _roundtrip_planes(seed):
    rng = np.random.RandomState(seed)
    sizes = rng.randint(0, 40, (16, 6)).astype(np.int32)
    return [rng.randint(1, 1 << 20, (16, 6)).astype(np.int32),
            rng.randint(0, 1 << 16, (16, 6)).astype(np.int32),
            rng.randint(0, 1 << 20, (16, 6)).astype(np.int32),
            np.zeros((16, 6), np.int32), sizes]


def _roundtrip_case(seed):
    planes = _roundtrip_planes(seed)
    want = JP.sharded_wire_roundtrip(JP.make_mesh(dp=4, sp=2), out_len=512)(
        *map(jnp.asarray, planes))
    fn = PAR.sharded_wire_roundtrip(_cpu_mesh(dp=4), out_len=512)
    return fn, tuple(map(torch.from_numpy, planes)), want


def _scan_stream(seed):
    rng = random.Random(seed)
    s = b''.join(_reply_frame(rng.randrange(1, 100), rng.randrange(1 << 40),
                              0, bytes(rng.randrange(256) for _ in
                                       range(rng.randrange(0, 90))))
                 for _ in range(24))
    return s + struct.pack('>i', 999)          # a truncated tail


#: The scan cases' stream length: more than any ``_scan_stream``
#: (at most 24 x 110 + 4 bytes), divisible by 4 x 8.
_SCAN_N = 3200


def _scan_pad(s, sp, N=None):
    N = N or ((len(s) + 4 * sp - 1) // (4 * sp) + 1) * 4 * sp
    pad = np.zeros(N, np.uint8)
    pad[:len(s)] = np.frombuffer(s, np.uint8)
    return pad


def _jax_scan(pad, n, sp):
    return JP.seq_parallel_frame_scan(JP.make_mesh(dp=8 // sp, sp=sp))(
        jnp.asarray(pad), jnp.int32(n))


def _scan_case(sp, n_of):
    def case(seed):
        s = _scan_stream(seed)
        pad = _scan_pad(s, sp, N=_SCAN_N)
        n = n_of(s)
        fn = PAR.seq_parallel_frame_scan(_cpu_mesh(sp=sp), tile=16)
        return fn, (torch.from_numpy(pad), n), _jax_scan(pad, n, sp)
    return case


_CASES = {
    'step dp=4': _step_case,
    'roundtrip dp=4': _roundtrip_case,
    'scan sp=1': _scan_case(1, len),
    'scan sp=4': _scan_case(4, len),
    'scan sp=4 mid-frame n': _scan_case(4, lambda s: len(s) // 2 + 1),
}


def _inject_k1(monkeypatch, inputs, out_len=None):
    """The sharded programs' K1 launches, in shard order, answered with
    the plain version's outputs on the same shard inputs (for the
    roundtrip, the streams its encoder makes)."""
    mesh = _cpu_mesh(dp=4)
    if out_len is None:
        F = 8
        shards = list(zip(mesh.shard_rows(inputs[0]),
                          mesh.shard_rows(inputs[1])))
    else:
        F = inputs[0].shape[1]
        shards = [TE.build_reply_streams(*p, out_len=out_len)
                  for p in zip(*(mesh.shard_rows(x) for x in inputs))]
    outs = iter([TW.wire_scan_plain(b, n, F) for b, n in shards])

    def k1(b, n, f):
        return next(outs)
    monkeypatch.setattr(TS, 'wire_pipeline_step_auto',
                        TP.wire_pipeline_step_kernel)
    monkeypatch.setattr(TP, 'wire_scan', k1)


def _inject_walk(monkeypatch, ext_of, n, sp, C, tile):
    """The scan's chunk-walk launches answered with in-place copies of
    the plain walk's states, computed beforehand: each chunk's exit map
    (``tile_exits_plain``) and its walk from its true entry (the exit of
    the chunk before it)."""
    pre, entry = [], 0
    for i in range(sp):
        ext, base = ext_of(i), i * C
        end = min(base + C, n)
        q, mask, bad = SW.walk_plain(ext, base, end, n, entry)
        pre.append((SW.tile_exits_plain(ext, base, end, n, tile),
                    torch.ones((), dtype=torch.int32),
                    torch.tensor(q, dtype=torch.int32), mask,
                    torch.tensor(bad)))
        entry = q

    def prepare(ext, base, n_dev, state):
        state.exits.copy_(pre[base // C][0])

    def walk(ext, base, n_dev, rcv, state):
        _exits, valid, q, mask, bad = pre[base // C]
        for dst, src in ((state.valid, valid), (state.exit, q),
                         (state.mask, mask), (state.bad, bad)):
            dst.copy_(src)
    monkeypatch.setattr(SW, 'seq_walk_prepare', prepare)
    monkeypatch.setattr(SW, 'seq_walk', walk)


@pytest.mark.parametrize('name', sorted(_CASES))
def test_program_dispatches_no_unsafe_op(monkeypatch, name):
    """The function a card captures for each program, its kernels'
    outputs injected, dispatches no op a capture refuses (no host read
    of ``n``, no cross-device copy), equals the JAX program on the same
    inputs, tolerance 0, and is the same op sequence on other data of
    the key: the fixed program a replay repeats."""
    seqs = []
    for seed in (0, 1):
        fn, args, want = _CASES[name](seed)
        e = fn.program.entry(*args)
        e.stage(*args)
        with monkeypatch.context() as m:
            if name.startswith('scan'):
                pad, n = args
                sp = fn.program.static[1]
                C = pad.shape[0] // sp

                def ext_of(i):
                    return torch.cat([pad[i * C:(i + 1) * C],
                                      pad[((i + 1) % sp) * C:][:4]])
                _inject_walk(m, ext_of, n, sp, C, 16)
            else:
                _inject_k1(m, e.inputs, 512 if name.startswith('round')
                           else None)
            with _CaptureCheck() as check:
                got = fn.program.fn(*e.inputs)
        assert check.unsafe == []
        _same(want, got)
        seqs.append(check.ops)
    assert seqs[0] == seqs[1] and len(seqs[0]) > 10


# -- the cache --------------------------------------------------------

class _Ops(TorchDispatchMode):
    """Every aten op dispatched, by name."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _ops(fn, *args):
    with _Ops() as rec:
        fn(*args)
    return rec.ops


def test_one_entry_per_key_over_calls():
    """Calls of one key share one entry; another shape, or other static
    arguments, is another key; a host int is keyed as the int32 scalar
    it is staged into, not by its value."""
    mesh = _cpu_mesh(dp=4)
    step = PAR.sharded_wire_step(mesh, max_frames=8)
    for seed in (20, 21, 22):
        buf, lens = _fleet(random.Random(seed), B=16, L=256)
        step(torch.from_numpy(buf), torch.from_numpy(lens))
    assert len(step.program.entries) == 1
    buf, lens = _fleet(random.Random(23), B=8, L=512)
    step(torch.from_numpy(buf), torch.from_numpy(lens))
    assert len(step.program.entries) == 2
    other = PAR.sharded_wire_step(mesh, max_frames=16)
    assert other.program.key((torch.from_numpy(buf),)) != \
        step.program.key((torch.from_numpy(buf),))
    scan = PAR.seq_parallel_frame_scan(_cpu_mesh(sp=4))
    pad = torch.from_numpy(_scan_pad(_scan_stream(3), 4, N=4096))
    for n in (0, 100, 4096):
        scan(pad, n)
    assert len(scan.program.entries) == 1


@pytest.mark.parametrize('kind', ['step', 'host shards', 'roundtrip',
                                  'scan'])
def test_staging_copies_each_other_argument_once(kind):
    """A program call whose arguments are its inputs copies nothing; a
    call with other tensors copies each one once (a host int is filled
    in once), and otherwise dispatches exactly what the first does."""
    mesh = _cpu_mesh(dp=4)
    if kind == 'scan':
        fn = PAR.seq_parallel_frame_scan(_cpu_mesh(sp=4))
        args = (torch.from_numpy(_scan_pad(_scan_stream(4), 4, N=_SCAN_N)),
                1000)
        staged = ['aten.copy_.default', 'aten.fill_.Scalar']
    elif kind == 'roundtrip':
        fn = PAR.sharded_wire_roundtrip(mesh, out_len=512)
        args = tuple(map(torch.from_numpy, _roundtrip_planes(5)))
        staged = ['aten.copy_.default'] * 5
    else:
        fn = PAR.sharded_wire_step(mesh, max_frames=8)
        buf, lens = _fleet(random.Random(6), B=16, L=256)
        args = (torch.from_numpy(buf), torch.from_numpy(lens))
        if kind == 'host shards':
            args = PAR.host_local_wire_batch(mesh, buf, lens)
        staged = ['aten.copy_.default'] * (8 if kind == 'host shards' else 2)
    prog = fn.program
    prog(*args)
    e = prog.entry(*args)
    own = _ops(prog, *e.inputs)
    other = _ops(prog, *args)
    assert other == staged + own


def test_a_result_outlives_later_calls():
    """A program's outputs are overwritten by its next run (a replay on
    a card; here the staged inputs a view of them aliases), so a call
    returns copies: an earlier result is unchanged by a later call on
    other data.  The same for the sharded step's and the scan's
    results."""
    prog = TG.Program(lambda a: (a[:2], a.sum()), 'cpu')
    x = torch.arange(4, dtype=torch.int32)
    first = prog(x)
    prog(x + 10)
    assert first[0].tolist() == [0, 1] and int(first[1]) == 6
    e = prog.entry(x)
    assert e.run()[0].data_ptr() == e.inputs[0].data_ptr()  # aliased
    step = PAR.sharded_wire_step(_cpu_mesh(dp=4), max_frames=8)
    a, b = (_fleet(random.Random(s), B=16, L=256) for s in (30, 31))
    r1 = step(*map(torch.from_numpy, a))
    keep = [t.clone() for t in jax.tree_util.tree_leaves(r1)]
    step(*map(torch.from_numpy, b))
    for t, k in zip(jax.tree_util.tree_leaves(r1), keep):
        assert torch.equal(t, k)
    scan = PAR.seq_parallel_frame_scan(_cpu_mesh(sp=4))
    pad = torch.from_numpy(_scan_pad(_scan_stream(7), 4, N=_SCAN_N))
    m1, t1, _b1 = scan(pad, _SCAN_N)
    keep = (m1.clone(), t1.clone())
    scan(pad, 0)
    assert torch.equal(m1, keep[0]) and torch.equal(t1, keep[1])


def test_which_meshes_are_graphed():
    """One program a key where the mesh has no process group and every
    shard sits on one device; a mesh over several devices or with a
    group runs eagerly (``graphed`` false, no entries), and its scan
    still equals the JAX package's."""
    one_card = Mesh(np.array([[torch.device('cuda', 0)]] * 4, dtype=object))
    two_cards = Mesh(np.array([[torch.device('cuda', 0)],
                               [torch.device('cuda', 1)]], dtype=object))
    sp_two = Mesh(np.array([[torch.device('cuda', 0),
                             torch.device('cuda', 1)]], dtype=object))
    grouped = _cpu_mesh(sp=4)
    grouped.group = object()                   # a process group stand-in
    cases = {'cpu dp=4': (_cpu_mesh(dp=4), True),
             'cpu sp=4': (_cpu_mesh(sp=4), True),
             'cuda:0 x 4': (one_card, True),
             'cuda:0, cuda:1 dp': (two_cards, False),
             'cuda:0, cuda:1 sp': (sp_two, False),
             'group': (grouped, False)}
    for name, (mesh, graphed) in cases.items():
        for fn in (PAR.sharded_wire_step(mesh),
                   PAR.sharded_wire_roundtrip(mesh, out_len=64),
                   PAR.seq_parallel_frame_scan(mesh)):
            assert fn.graphed is graphed and fn.program.graphed is graphed, \
                name
    s = _scan_stream(8)
    pad = _scan_pad(s, 4)
    scan = PAR.seq_parallel_frame_scan(grouped)
    _same(_jax_scan(pad, len(s), 4), scan(torch.from_numpy(pad), len(s)))
    assert scan.program.entries == {}


@pytest.mark.parametrize('sp', [1, 4, 8])
def test_scan_at_one_n_many_lengths_matches_jax(sp):
    """One scan program at one N serves every ``n``: 0, a prefix's
    middle, a frame's middle, a frame boundary, the stream's end and N
    (the cases of tests/test_torch_parallel.py, at several ``n``), each
    equal to the JAX package's ``seq_parallel_frame_scan``."""
    rng = random.Random(40 + sp)
    s, starts = b'', []
    for _ in range(20):
        starts.append(len(s))
        s += _reply_frame(rng.randrange(1, 100), rng.randrange(1 << 40), 0,
                          bytes(rng.randrange(256)
                                for _ in range(rng.randrange(0, 70))))
    N = 4 * sp * (len(s) // (4 * sp) + 3)
    pad = _scan_pad(s, sp, N=N)
    scan = PAR.seq_parallel_frame_scan(
        PAR.make_mesh(dp=8 // sp, sp=sp, devices=[torch.device('cpu')] * 8))
    for n in (0, 2, starts[5] + 9, starts[7], len(s), N):
        got = scan(torch.from_numpy(pad), n)
        _same(_jax_scan(pad, n, sp), got)
        if n <= len(s):   # (past it, the zero padding reads as frames)
            want = [x for x in starts if x + 4 <= n and
                    x + 4 + struct.unpack('>i', s[x:x + 4])[0] <= n]
            assert np.nonzero(got[0].numpy())[0].tolist() == want
    assert len(scan.program.entries) == 1
    with pytest.raises(ValueError):
        scan(torch.from_numpy(pad), -1)
    with pytest.raises(ValueError):
        scan(torch.from_numpy(pad), 2**31)


def test_launch_counters_by_record_key():
    """A wrapper counts a launch on any of its counters (the chunk walk's
    ``prepare_launches`` beside ``launches``); a recording thread notes
    it under ``module:counter`` instead, and ``launch_count`` reads a
    counter by that key, as a replay adds it."""
    key = SW.__name__ + ':prepare_launches'
    before = SW.prepare_launches, SW.launches
    try:
        TG.count_launch(SW.__name__, 'prepare_launches')
        assert TG.launch_count(key) == before[0] + 1
        with TG.recording() as rec:
            TG.count_launch(SW.__name__, 'prepare_launches')
            TG.count_launch(SW.__name__)
        assert rec == {key: 1, SW.__name__: 1}
        assert (SW.prepare_launches, SW.launches) == (before[0] + 1,
                                                      before[1])
        assert TG.launch_count(SW.__name__) == before[1]
    finally:
        SW.prepare_launches, SW.launches = before
