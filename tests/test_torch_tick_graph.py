"""The tick program that ``FleetIngest`` captures into a CUDA graph once
per shape bucket (``FleetIngest._compile``, ``ops/tick_graph.py``),
checked on the CPU.

A capture records a fixed sequence of launches, so the step it records
must not read device values on the host, make tensors from host data,
produce data-dependent shapes or copy across devices.  Here the step
runs as it runs on a card — kernel K1's or K2's output (its plain
version's, computed beforehand) injected where the kernel launches, the
rest the same torch ops — under a dispatch mode that flags every such
op, for both body modes at the default widths and for ``MeshFleetIngest``
at dp=4, and its packed arrays are held to the plain step's and the JAX
tick program's.  The GET_DATA unpack's byte shifts, now made on the
device, are held to the host-list version and ``wire_full_decode`` to
``getdata_bodies`` and the JAX reference.  Tolerance 0 throughout: every
plane is an integer or bool plane.  The capture and replay themselves
run on the card (tests/test_torch_cuda.py).
"""

import asyncio
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from test_torch_ingest import _batch, _device_fleet
from test_torch_replies import _same
from zkstream_tpu.io.ingest import FleetIngest as RefIngest
from zkstream_tpu.ops import pipeline as JP
from zkstream_tpu_torch import corpus
from zkstream_tpu_torch.io.ingest import FleetIngest
from zkstream_tpu_torch.ops import full_scan as TK2
from zkstream_tpu_torch.ops import pipeline as TP
from zkstream_tpu_torch.ops import tick_graph as TG
from zkstream_tpu_torch.ops import wire_scan as TW
from zkstream_tpu_torch.parallel import MeshFleetIngest, make_mesh
from zkstream_tpu_torch.protocol.framing import PacketCodec

#: aten ops a CUDA graph capture refuses or records wrongly: a tensor
#: made from host data (a pageable copy), a device value read on the
#: host, and shapes that depend on the data
_UNSAFE = ('lift_fresh', '_local_scalar_dense', 'nonzero', 'masked_select',
           'unique', '_unique')


class _CaptureCheck(TorchDispatchMode):
    """Records every aten op dispatched (``ops``) and those a capture
    cannot hold (``unsafe``), copies across devices included."""

    def __init__(self):
        super().__init__()
        self.ops, self.unsafe = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        self.ops.append(str(func))
        if name.startswith(_UNSAFE):
            self.unsafe.append(str(func))
        elif name == '_to_copy' and kwargs.get('device') is not None \
                and torch.device(kwargs['device']) != args[0].device:
            self.unsafe.append('%s to %s' % (func, kwargs['device']))
        elif name == 'copy_' and args[0].device != args[1].device:
            self.unsafe.append('%s from %s' % (func, args[1].device))
        return func(*args, **kwargs)


def _rows(seed):
    """Streams of every body layout the device mode parses (some past
    the widths), the bad prefix, and GET_DATA rows."""
    streams = _device_fleet(seed)[0]
    buf, lens = corpus.getdata_fleet(seed, 3, 1024, 64)
    return streams + [r[:n].tobytes() for r, n in zip(buf, lens)]


def _ingest(kind):
    """A CPU ingest at the default widths: ``host``/``device`` bodies,
    or ``mesh-host``/``mesh-device`` on four CPU shards."""
    mode = kind.split('-')[-1]
    if kind.startswith('mesh'):
        return MeshFleetIngest(mesh=make_mesh(dp=4, devices=['cpu'] * 4),
                               device='cpu', body_mode=mode)
    return FleetIngest(device='cpu', body_mode=mode)


def _staged(ing, rows):
    """The bucket for ``rows``, warmed and staged as a tick stages it."""
    bk = ing._compile(ing._bucket(len(rows), max(map(len, rows))))
    active = [(None, bytearray(r)) for r in rows]
    ing._fill_staging(bk, active)
    if hasattr(bk, 'place'):
        bk.place(len(active))
    return bk


def _flat(out):
    """A step's output (packed arrays, per shard for a mesh) as a flat
    list of numpy arrays."""
    if isinstance(out, torch.Tensor):
        return [out.numpy()]
    return [a for x in out if x is not None for a in _flat(x)]


def _cuda_path(monkeypatch, ing, bufs_lens):
    """Run ``ing``'s steps as they run on a card: the tick launches K1
    (host bodies) or K2 (device bodies) on each input batch, whose
    outputs, their plain versions' on ``bufs_lens``, are injected."""
    F = ing.max_frames
    k1 = {b.data_ptr(): TW.wire_scan_plain(b, n, F) for b, n in bufs_lens}
    k2 = {b.data_ptr(): TK2.full_scan_plain(b, n, F, ing.max_data)
          for b, n in bufs_lens}
    monkeypatch.setattr(TP, 'wire_pipeline_step_auto',
                        TP.wire_pipeline_step_kernel)
    monkeypatch.setattr(TP, 'wire_scan', lambda b, n, f: k1[b.data_ptr()])
    monkeypatch.setattr(TK2, 'full_scan',
                        lambda b, n, f, d: k2[b.data_ptr()])


def _inputs(bk):
    bufs, lens = bk.inputs()
    if isinstance(bufs, torch.Tensor):
        return [(bufs, lens)]
    return list(zip(bufs, lens))


@pytest.mark.parametrize('kind', ['host', 'device', 'mesh-host',
                                  'mesh-device'])
def test_captured_step_dispatches_no_unsafe_op(monkeypatch, kind):
    """The step a card captures dispatches no op a capture refuses, packs
    what the plain step packs, and is the same op sequence on other data
    in the same bucket: the fixed program a replay repeats."""
    ing = _ingest(kind)
    step = ing._step_fn(ing.body_mode == 'device')
    seqs = []
    for seed in (0, 1):
        bk = _staged(ing, _rows(seed))
        want = _flat(step(*bk.inputs()))
        with monkeypatch.context() as m:
            _cuda_path(m, ing, _inputs(bk))
            with _CaptureCheck() as check:
                got = _flat(step(*bk.inputs()))
        assert check.unsafe == []
        assert len(got) == len(want)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(w, g)
        seqs.append(check.ops)
    assert seqs[0] == seqs[1] and len(seqs[0]) > 20


@pytest.mark.parametrize('body_mode', ['host', 'device'])
def test_captured_step_packs_like_jax(monkeypatch, body_mode):
    """The step a card captures (kernel output injected) packs what the
    JAX tick program packs on the same zero-padded batch, at the
    default widths."""
    rows = _rows(2)
    ing = FleetIngest(device='cpu', body_mode=body_mode)
    Bp, L = ing._bucket(len(rows), max(map(len, rows)))
    buf, lens = _batch(rows, Bp, L)
    tb, tl = torch.from_numpy(buf), torch.from_numpy(lens)
    ref = RefIngest(body_mode=body_mode, bypass_bytes=0, warm='block',
                    placement='host')
    want = ref._compile_or_latch(ref._bucket(len(rows), L))(buf, lens)
    want = [np.asarray(x) for x in
            (want if body_mode == 'device' else (want,))]
    _cuda_path(monkeypatch, ing, [(tb, tl)])
    got = _flat(ing._step(tb, tl))
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and w.shape == g.shape
        np.testing.assert_array_equal(w, g)


_FULL_INPUTS = {
    'getdata': lambda: corpus.getdata_fleet(3, 16, 1024, 64),
    'getdata_wide': lambda: corpus.getdata_fleet(8, 24, 2048, 256),
    'corpus': lambda: corpus.fleet(B=12, seed=4, frames=16)[:2],
    'adversarial': lambda: corpus.adversarial(5),
}


@pytest.mark.parametrize('name', sorted(_FULL_INPUTS))
def test_full_decode_unpack_bytes_as_before(name):
    """``wire_full_decode``'s payload bytes, unpacked with shifts made on
    the device, equal the unpack with the shifts copied from a host
    list, ``getdata_bodies`` and the JAX reference."""
    buf, lens = _FULL_INPUTS[name]()
    tb, tl = torch.from_numpy(buf), torch.from_numpy(lens)
    F, D = 16, 64
    st, gd = TP.wire_full_decode(tb, tl, max_frames=F, max_data=D)
    words = TK2.full_scan_plain(tb, tl, F, D)['data_words']
    host_shifts = torch.tensor([24, 16, 8, 0], dtype=torch.int32)
    before = ((words[..., None] >> host_shifts) & 0xFF).reshape(
        *words.shape[:2], D)
    assert torch.equal(gd.data,
                       torch.where(gd.data_mask, before, 0).to(torch.uint8))
    _same(TP.getdata_bodies(tb, st, D), gd, 'plain')
    jb = jnp.asarray(buf)
    jst = JP.wire_pipeline_step(jb, jnp.asarray(lens), max_frames=F)
    _same(jst, st, 'stats')
    _same(JP.getdata_bodies_jnp(jb, jst, D), gd, 'getdata')


def test_launches_recorded_apart_per_thread():
    """A launch counts at once, or, while its thread records (a capture
    and its warm-up), in the record only; another thread's launches
    meanwhile count as usual."""
    before = TW.launches
    TG.count_launch(TW.__name__)
    assert TW.launches == before + 1
    with TG.recording() as rec:
        TG.count_launch(TW.__name__)
        TG.count_launch(TK2.__name__)
        t = threading.Thread(target=TG.count_launch, args=(TW.__name__,))
        t.start()
        t.join()
        with TG.recording() as inner:
            TG.count_launch(TW.__name__)
        TG.count_launch(TW.__name__)
    assert rec == {TW.__name__: 2, TK2.__name__: 1}
    assert inner == {TW.__name__: 1}
    assert TW.launches == before + 2
    TW.launches = before


class _Conn:
    def __init__(self, xid_map=None):
        self.codec = PacketCodec(use_native=False)
        self.codec.handshaking = False
        self.codec.xid_map.update(xid_map or {})
        self.got = []

    def is_in_state(self, state):
        return state == 'connected'

    def emit(self, _event, pkts, err):
        self.got.append((pkts, err))


def test_graphed_bucket_without_its_graph_raises(monkeypatch, caplog):
    """Where ticks are graphed, a bucket with no captured program
    raises instead of running the eager chain; a capture that fails is
    a warm failure, as the reference's failed compile: logged once at
    error level, the bucket latched onto the scalar drain (its ticks in
    ``ticks_scalar``, no retry), and the side stream and graph pool the
    capture used retired."""
    ing = FleetIngest(device='cpu', warm='block', bypass_bytes=0,
                      min_len=1 << 13)
    bk = ing._warm_bucket(ing._bucket(8, 256))
    monkeypatch.setattr(ing, '_graphed', lambda: True)
    with pytest.raises(RuntimeError, match='no captured tick program'):
        ing._launch(bk)

    captures = []

    class Refused:
        def __init__(self, *a):
            captures.append(a[2:])
            raise TG.CaptureError('operation not permitted when stream '
                                  'is capturing')

    monkeypatch.setattr(TG, 'TickGraph', Refused)
    monkeypatch.setattr(torch.cuda, 'Stream', lambda _d: object())
    monkeypatch.setattr(torch.cuda, 'graph_pool_handle', lambda: object())
    buf, lens, _slots, maps = corpus.fleet(B=2, seed=7, frames=16)
    conns = [_Conn(m) for m in maps]
    halves = [(r[:n // 2].tobytes(), r[n // 2:n].tobytes())
              for r, n in zip(buf, lens)]

    async def ticks():
        for c in conns:
            ing.register(c)
        for half in (0, 1):
            for c, h in zip(conns, halves):
                ing.feed(c, h[half])
            ing._tick_impl()

    with caplog.at_level('ERROR', logger='zkstream_tpu_torch'):
        asyncio.run(ticks())
    errors = [r for r in caplog.records if 'failed to warm' in r.message]
    assert len(errors) == 1 and 'capturing' in errors[0].message
    assert len(captures) == 1
    assert ing._graph_stream is None and ing._graph_pool is None
    assert list(ing._exec.values()) == [None]
    assert ing.ticks == 0 and ing.ticks_scalar == 2
    for c, m, h in zip(conns, maps, halves):
        codec = _Conn(m).codec
        assert c.got == [(codec.decode(x), None) for x in h]


class _KernelFailed(RuntimeError):
    pass


@pytest.mark.parametrize('warm', ['block', 'background'])
@pytest.mark.parametrize('fails', ['build', 'launch', 'capture'])
def test_card_warm_failure_latches_only_a_failed_capture(
        monkeypatch, caplog, fails, warm):
    """On a card only a failed capture of the torch program around the
    kernel latches its bucket onto the scalar drain.  A kernel that
    fails to build (``_load_kernel``) or to launch (the eager run before
    capture) is logged, kept and raised by ``prewarm`` and by every
    tick that needs the bucket, with no retry: the scalar codec never
    serves the card's ticks.  The card's pieces are stubbed (a CUDA
    ingest whose buckets, side stream, pool and capture are host
    stand-ins)."""
    import zkstream_tpu_torch.io.ingest as ingest_mod

    ing = FleetIngest(device='cpu', warm=warm, bypass_bytes=0,
                      min_len=1 << 13)
    ing.device = torch.device('cuda')
    bucket = ingest_mod._Bucket
    monkeypatch.setattr(ingest_mod, '_Bucket', lambda Bp, L, F, _d, *w:
                        bucket(Bp, L, F, torch.device('cpu'), *w))
    builds = []

    def load():
        builds.append(1)
        if fails == 'build':
            raise _KernelFailed('nvcc exited with 1')

    monkeypatch.setattr(ing, '_load_kernel', load)

    class Stub:
        def __init__(self, *_a):
            if fails == 'launch':
                raise _KernelFailed('CUDA error: an illegal memory access')
            raise TG.CaptureError('operation not permitted when stream '
                                  'is capturing')

    monkeypatch.setattr(TG, 'TickGraph', Stub)
    monkeypatch.setattr(torch.cuda, 'Stream', lambda _d: object())
    monkeypatch.setattr(torch.cuda, 'graph_pool_handle', lambda: object())
    buf, lens, _slots, maps = corpus.fleet(B=2, seed=7, frames=16)
    conns = [_Conn(m) for m in maps]
    halves = [(r[:n // 2].tobytes(), r[n // 2:n].tobytes())
              for r, n in zip(buf, lens)]
    key = ing._bucket(2, int(lens.max()))

    async def run():
        if fails == 'capture':
            await ing.prewarm(2, int(lens.max()))
        else:
            with pytest.raises(RuntimeError, match='failed to warm') as e:
                await ing.prewarm(2, int(lens.max()))
            assert isinstance(e.value.__cause__, _KernelFailed)
        for c in conns:
            ing.register(c)
        for half in (0, 1):
            for c, h in zip(conns, halves):
                ing.feed(c, h[half])
            if fails == 'capture':
                ing._tick_impl()
            else:
                with pytest.raises(RuntimeError, match='failed to warm'):
                    ing._tick_impl()

    with caplog.at_level('ERROR', logger='zkstream_tpu_torch'):
        asyncio.run(run())
    ing.close()
    errors = [r for r in caplog.records if 'failed to warm' in r.message]
    assert len(errors) == 1 and repr(key) in errors[0].message
    assert len(builds) == 1 and ing.ticks == 0
    if fails == 'capture':
        assert ing._exec == {key: None} and ing.ticks_scalar == 2
        for c, m, h in zip(conns, maps, halves):
            codec = _Conn(m).codec
            assert c.got == [(codec.decode(x), None) for x in h]
    else:
        assert isinstance(ing._exec[key], _KernelFailed)
        assert ing.ticks_scalar == 0 and all(c.got == [] for c in conns)
        assert all(len(ing._slots[id(c)][1]) == lens[i]
                   for i, c in enumerate(conns))
