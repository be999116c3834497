"""Kernels K1 and K2 and the chunk walk against their plain versions on
a CUDA card, the mesh plane's sharded steps against the unsharded ones,
the ticks on the card against the same ticks on the CPU, and live port
clients against the port's server through ``FleetIngest`` on the card
against the scalar drain (no
JAX here, so the file also runs where only the port is installed:
``python -m pytest --noconftest tests/test_torch_cuda.py``).  Every
test is marked ``cuda`` and skips without a card; the decision is made
in a fixture.  Tolerance 0: every plane is an integer or bool plane."""

import numpy as np
import pytest
import torch

from zkstream_tpu_torch import corpus
from zkstream_tpu_torch.ops import full_scan as TK2
from zkstream_tpu_torch.ops import pipeline as TP
from zkstream_tpu_torch.ops import wire_scan as TW


def _corpus_small():
    buf, lens, _slots, _maps = corpus.fleet(B=257, seed=5, frames=32)
    return buf, lens


def _random_bytes():
    rng = np.random.RandomState(3)
    buf = rng.randint(0, 256, (64, 300)).astype(np.uint8)
    buf[:, :2] = 0                       # small first prefixes
    lens = rng.randint(-4, 340, (64,)).astype(np.int32)
    return buf, lens


def _ring(seed, B, L):
    """``corpus.ring_fleet`` at the stage size K2 takes for ``[B, L]``."""
    cfg = TK2.launch_config(B, L, 64)
    return corpus.ring_fleet(seed, B, L, cfg['stage_bytes'], cfg['stages'])


_INPUTS = {
    'adversarial': lambda: corpus.adversarial(0),
    'adversarial_odd': lambda: corpus.adversarial(1, B=17, L=256),
    'random_bytes': _random_bytes,
    'corpus': _corpus_small,
    # K2's ring edges: L % 16 == 4 and B not a multiple of 8 warps
    'ring': lambda: _ring(0, 96, 6004),
    'ring_odd': lambda: _ring(1, 61, 4700),
}

#: K2's inputs: K1's plus GET_DATA-layout fleets at both widths
_K2_INPUTS = dict(_INPUTS, **{
    'getdata16': lambda: corpus.getdata_fleet(0, 13, 512, 16),
    'getdata256': lambda: corpus.getdata_fleet(7, 64, 4096, 256),
})


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (K1 has no CPU mode)')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('name', sorted(_INPUTS))
@pytest.mark.parametrize('max_frames', [1, 16, 64])
def test_k1_matches_plain_on_card(cuda_device, name, max_frames):
    buf, lens = _INPUTS[name]()
    db, dl = TP.batch_to_device(buf, lens, cuda_device)
    before = TW.launches
    got = TW.wire_scan(db, dl, max_frames)
    torch.cuda.synchronize()
    assert TW.launches == before + 1
    want = TW.wire_scan_plain(db, dl, max_frames)
    for k in want:
        assert torch.equal(want[k], got[k]), k


@pytest.mark.cuda
def test_auto_step_takes_k1_on_card(cuda_device):
    buf, lens = corpus.adversarial(2)
    db, dl = TP.batch_to_device(buf, lens, cuda_device)
    before = TW.launches
    got = TP.wirestats_to_numpy(TP.wire_pipeline_step_auto(db, dl, 8))
    assert TW.launches == before + 1
    want = TP.wirestats_to_numpy(TP.wire_pipeline_step(db, dl, 8))
    for f in want:
        np.testing.assert_array_equal(want[f], got[f], err_msg=f)


@pytest.mark.cuda
@pytest.mark.parametrize('name', sorted(_K2_INPUTS))
@pytest.mark.parametrize('max_data', [16, 256])
def test_k2_matches_plain_on_card(cuda_device, name, max_data):
    buf, lens = _K2_INPUTS[name]()
    db, dl = TP.batch_to_device(buf, lens, cuda_device)
    before = TK2.launches, TW.launches
    got = TK2.full_scan(db, dl, 16, max_data)
    torch.cuda.synchronize()
    assert (TK2.launches, TW.launches) == (before[0] + 1, before[1])
    want = TK2.full_scan_plain(db, dl, 16, max_data)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(want[k], got[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['ring', 'ring_odd'])
@pytest.mark.parametrize('max_frames', [0, 1, 16, 64])
@pytest.mark.parametrize('max_data', [0, 20, 256])
def test_k2_ring_edges_on_card(cuda_device, name, max_frames, max_data):
    """K2 on the ring-edge rows at every walk depth and at data widths
    with no words, with a width not a multiple of 4 words (scalar
    stores), and the main path's."""
    buf, lens = _K2_INPUTS[name]()
    db, dl = TP.batch_to_device(buf, lens, cuda_device)
    before = TK2.launches
    got = TK2.full_scan(db, dl, max_frames, max_data)
    torch.cuda.synchronize()
    assert TK2.launches == before + 1
    want = TK2.full_scan_plain(db, dl, max_frames, max_data)
    for k in want:
        assert torch.equal(want[k], got[k]), k


#: Batches with more than twice as many rows as K2 keeps warps resident
#: (4,224 on an H100 at their geometries): odd B, every row kind repeated
_MANY_ROWS = {
    'adversarial': lambda: corpus.adversarial(4, B=9001, L=512),
    'ring': lambda: _ring(2, 9001, 6004),
}


@pytest.mark.cuda
@pytest.mark.parametrize('name', sorted(_MANY_ROWS))
@pytest.mark.parametrize('max_frames,max_data', [(16, 20), (64, 256)])
def test_k2_warps_walk_several_rows(cuda_device, name, max_frames,
                                    max_data):
    """Every warp of K2's persistent grid walks two rows or more, rows
    that stop early (bad prefixes, incomplete frames, lens < 0 or > L)
    followed by others: the ring's copies are drained, its mbarrier
    phases carried and the next row's stages started across rows."""
    buf, lens = _MANY_ROWS[name]()
    B, L = buf.shape
    cfg = TK2.launch_config(B, L, max_frames)
    cfg = TK2.launch_config(B, L, max_frames, TK2.resident_blocks(
        cuda_device, cfg['warps'], cfg['smem_bytes']))
    assert B > 2 * cfg['blocks'] * cfg['warps']
    db, dl = TP.batch_to_device(buf, lens, cuda_device)
    got = TK2.full_scan(db, dl, max_frames, max_data)
    want = TK2.full_scan_plain(db, dl, max_frames, max_data)
    for k in want:
        assert torch.equal(want[k], got[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['getdata256', 'corpus', 'adversarial',
                                  'ring'])
def test_full_decode_on_card_equals_cpu(cuda_device, name):
    buf, lens = _K2_INPUTS[name]()
    cpu = TP.wire_full_decode(*TP.batch_to_device(buf, lens, 'cpu'),
                              max_frames=32, max_data=256)
    card = TP.wire_full_decode(*TP.batch_to_device(buf, lens, cuda_device),
                               max_frames=32, max_data=256)

    def flat(t):
        for x in t:
            if hasattr(x, '_fields'):
                yield from flat(x)
            else:
                yield x
    for a, b in zip(flat(cpu), flat(card)):
        assert torch.equal(a, b.cpu())


@pytest.mark.cuda
def test_device_body_tick_launches_k2_only(cuda_device):
    """A CUDA device-body tick, one replay of the bucket's graph, is one
    K2 launch (no K1) and packs what the same tick packs on the CPU."""
    from zkstream_tpu_torch.io.ingest import FleetIngest

    buf, _lens, _slots, _maps = corpus.fleet(B=12, seed=2, frames=16)
    rows = [bytearray(r.tobytes()) for r in buf]
    rows += [bytearray(r[:n].tobytes()) for r, n in
             zip(*corpus.getdata_fleet(4, 4, 1024, 64))]
    kw = dict(body_mode='device', max_frames=16, max_data=64,
              max_path=32, max_children=6, max_name=12)
    key = (16, 4096)
    card = FleetIngest(device='cuda', **kw)
    bk = card._compile(key)
    before = TK2.launches, TW.launches
    got = card._run_step(bk, [(None, r) for r in rows])
    assert (TK2.launches, TW.launches) == (before[0] + 1, before[1])
    cpu = FleetIngest(device='cpu', **kw)
    want = cpu._run_step(cpu._warm_bucket(key), [(None, r) for r in rows])
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_host_body_tick_routes_through_c_codec_on_card(cuda_device):
    """A CUDA host-body tick launches K1 once and, with ``use_native=True``
    codecs, hands every stream's frame-complete slice to the C extension
    (``_assemble_ext``), delivering what the pure-Python codec decodes."""
    import asyncio

    from zkstream_tpu_torch.io.ingest import FleetIngest
    from zkstream_tpu_torch.protocol.framing import PacketCodec

    buf, _lens, _slots, maps = corpus.fleet(B=12, seed=6, frames=16)

    class Conn:
        def __init__(self, xid_map, use_native):
            self.codec = PacketCodec(use_native=use_native)
            self.codec.handshaking = False
            self.codec.xid_map.update(xid_map)
            self.got, self.err = [], None

        def is_in_state(self, state):
            return state == 'connected' and self.err is None

        def emit(self, _event, pkts, err):
            self.got += pkts
            self.err = err or self.err

    want = []
    for row, m in zip(buf, maps):
        want.append(Conn(m, False).codec.decode(row.tobytes()))
    ing = FleetIngest(device='cuda', body_mode='host', max_frames=16,
                      bypass_bytes=0, warm='block')
    calls = []
    assemble_ext = ing._assemble_ext
    ing._assemble_ext = lambda *a: calls.append(a[4]) or assemble_ext(*a)
    conns = [Conn(m, True) for m in maps]
    assert all(c.codec.ext is not None for c in conns)

    async def serve():
        for c, row in zip(conns, buf):
            ing.register(c)
            ing.feed(c, row.tobytes())
        while ing._scheduled or any(b for _c, b in ing._slots.values()):
            await asyncio.sleep(0.001)

    before = TK2.launches, TW.launches
    asyncio.run(serve())
    assert ing.ticks == 1
    assert (TK2.launches, TW.launches) == (before[0], before[1] + 1)
    assert sorted(calls) == list(range(len(conns)))
    for c, w in zip(conns, want):
        assert c.err is None and c.got == w


def _walk_streams():
    """Streams for the chunk walk: corpus rows concatenated, one frame
    spanning whole chunks, a bad prefix, a truncated frame, and a tail
    shorter than a prefix."""
    import struct

    buf, lens, _slots, _maps = corpus.fleet(B=8, seed=9, frames=16)
    s = b''.join(r[:n].tobytes() for r, n in zip(buf, lens))

    def frame(body):
        return struct.pack('>i', 16 + len(body)) + b'\x00' * 16 + body
    return {
        'corpus': s,
        'spanning': frame(b'x' * 3000) + frame(b''),
        'bad': s[:1000] + struct.pack('>i', -7) + s[:600],
        'truncated': s[:2000] + struct.pack('>i', 900) + b'\x00' * 100,
        'short_tail': s + b'\x00\x00',
    }


@pytest.mark.cuda
@pytest.mark.parametrize('sp', [1, 3, 4])
@pytest.mark.parametrize('name', sorted(_walk_streams()))
def test_seq_scan_and_chunk_walk_match_plain_on_card(cuda_device, sp, name):
    """The sp scan on ``sp`` shards of one card equals the same scan on
    CPU shards (the plain walk) and the pointer-doubling scan, with one
    exit-map launch a chunk and two walk launches (hop chain, mark) a
    shard a ring step; each chunk's map and walk, launched alone from
    its true entry, equal ``tile_exits_plain`` and the plain walk."""
    from zkstream_tpu_torch.ops import seq_walk as SW
    from zkstream_tpu_torch.ops.frame_scan import (
        frame_starts_pointer_doubling)
    from zkstream_tpu_torch.parallel import make_mesh, seq_parallel_frame_scan

    s = _walk_streams()[name]
    N = -(-(len(s) + 8) // (4 * sp)) * 4 * sp
    pad = np.zeros(N, np.uint8)
    pad[:len(s)] = np.frombuffer(s, np.uint8)
    mesh = make_mesh(dp=1, sp=sp, devices=[cuda_device] * sp)
    before = SW.launches, SW.prepare_launches
    got = seq_parallel_frame_scan(mesh)(torch.from_numpy(pad).to(cuda_device),
                                        len(s))
    torch.cuda.synchronize()
    assert SW.prepare_launches == before[1] + sp
    assert SW.launches == before[0] + 2 * (1 + max(sp - 1, 1) * sp)
    want = seq_parallel_frame_scan(make_mesh(dp=1, sp=sp, devices=['cpu'] * sp))(
        torch.from_numpy(pad), len(s))
    for a, b in zip(want, got):
        assert torch.equal(a, b.cpu())
    dbl, dbad = frame_starts_pointer_doubling(torch.from_numpy(pad), len(s))
    assert torch.equal(dbl, want[0]) and bool(dbad) == bool(want[2])
    C = N // sp
    entry = 0
    nd = torch.tensor(len(s), dtype=torch.int32, device=cuda_device)
    for i in range(sp):
        ext = torch.from_numpy(np.concatenate([pad[i * C:(i + 1) * C],
                                               pad[((i + 1) % sp) * C:][:4]]))
        end = min(i * C + C, len(s))
        q, mask, bad = SW.walk_plain(ext, i * C, end, len(s), entry)
        st = SW.new_state(C, cuda_device)
        ext_d = ext.to(cuda_device)
        SW.seq_walk_prepare(ext_d, i * C, nd, st)
        assert torch.equal(st.exits.cpu(), SW.tile_exits_plain(
            ext, i * C, end, len(s), st.tile))
        SW.seq_walk(ext_d, i * C, nd,
                    torch.tensor(entry, dtype=torch.int32,
                                 device=cuda_device), st)
        assert (int(st.valid), int(st.exit), bool(st.bad)) == (1, q, bad)
        assert torch.equal(st.mask.cpu(), mask)
        entry = q


@pytest.mark.cuda
@pytest.mark.parametrize('tile', [8, 16, 64, 1 << 15])
def test_exit_map_and_chunk_walk_match_plain_on_random_chunks(cuda_device,
                                                              tile):
    """The exit-map kernel == ``tile_exits_plain`` and the hop chain +
    mark == ``walk_plain`` on random chunks (frames of a stream, sparse
    junk, a zero first byte), from entries inside, before and past the
    chunk and saturated, with ``n`` (on the device; the kernels' chunk
    end is ``min(base + C, n)``) inside, before or past it."""
    from zkstream_tpu_torch.ops import seq_walk as SW

    s = _walk_streams()['corpus']
    rng = np.random.RandomState(tile)
    zero = torch.zeros((), dtype=torch.int32, device=cuda_device)
    for _ in range(60):
        C = int(rng.choice([1, 7, 40, 300, 1000, 5000]))
        if rng.rand() < 0.5:
            base = int(rng.randint(0, len(s) - C - 4))
            ext = np.frombuffer(s[base:base + C + 4], np.uint8).copy()
            n = int(rng.choice([len(s), base + rng.randint(0, C + 8)]))
        else:
            ext = np.where(rng.rand(C + 4) < 0.3, rng.randint(0, 256, C + 4),
                           0).astype(np.uint8)
            base, n = int(rng.randint(0, 100)), int(rng.randint(0, 300))
        if rng.rand() < 0.3:
            ext[0] = 0
        end = min(base + C, n)
        t = torch.from_numpy(ext)
        d = t.to(cuda_device)
        nd = zero + n
        # (entries before the chunk start near it: from far before, a
        # zero first byte makes both walks take 4 bytes a step)
        for entry in (base + int(rng.randint(0, C)), base,
                      max(base - int(rng.randint(1, 400)), 0),
                      max(base - 4, 0), base + C + 1, SW.SATURATED):
            st = SW.new_state(C, cuda_device, tile)
            SW.seq_walk_prepare(d, base, nd, st)
            assert torch.equal(st.exits.cpu(), SW.tile_exits_plain(
                t, base, end, n, tile))
            SW.seq_walk(d, base, nd, zero + entry, st)
            q, mask, bad = SW.walk_plain(t, base, end, n, entry)
            assert (int(st.valid), int(st.exit), bool(st.bad)) == \
                (1, q, bad), (C, base, end, n, entry)
            assert torch.equal(st.mask.cpu(), mask)
            # a second offer is not adopted: the state keeps its walk
            SW.seq_walk(d, base, nd, zero + base, st)
            assert int(st.exit) == q and torch.equal(st.mask.cpu(), mask)


@pytest.mark.cuda
def test_chunk_walk_on_card_needs_its_exit_map(cuda_device):
    """A walk on the card whose state was never prepared, or was
    prepared for another chunk, raises; nothing walks serially.  A card's
    walk reads ``n`` on the device only: a host int raises."""
    from zkstream_tpu_torch.ops import seq_walk as SW

    ext = torch.zeros(64 + 4, dtype=torch.uint8, device=cuda_device)
    st = SW.new_state(64, cuda_device)
    zero = torch.zeros((), dtype=torch.int32, device=cuda_device)
    n = zero + 64
    before = SW.launches
    with pytest.raises(RuntimeError, match='not prepared'):
        SW.seq_walk(ext, 0, n, zero, st)
    SW.seq_walk_prepare(ext, 0, n, st)
    with pytest.raises(RuntimeError, match='not prepared'):
        SW.seq_walk(ext, 4, n, zero, st)
    with pytest.raises(ValueError, match='int32 0-d tensor'):
        SW.seq_walk(ext, 0, 64, zero, st)
    assert SW.launches == before and int(st.valid) == 0


@pytest.mark.cuda
@pytest.mark.parametrize('dp', [1, 4])
def test_sharded_step_equals_unsharded_on_card(cuda_device, dp):
    """``sharded_wire_step`` over ``dp`` shards of one card launches K1
    once a shard and equals the unsharded step bit for bit; the globals
    equal the reductions of the unsharded result."""
    from zkstream_tpu_torch.ops.bytesops import u64pair_reduce_max
    from zkstream_tpu_torch.parallel import make_mesh, sharded_wire_step

    buf, lens = _corpus_small()
    db, dl = TP.batch_to_device(buf[:256], lens[:256], cuda_device)
    mesh = make_mesh(dp=dp, devices=[cuda_device] * dp)
    before = TW.launches
    st, g = sharded_wire_step(mesh, max_frames=32)(db, dl)
    assert TW.launches == before + dp
    want = TP.wire_pipeline_step_auto(db, dl, max_frames=32)
    for f in want._fields:
        assert torch.equal(getattr(want, f), getattr(st, f)), f
    h, lo = u64pair_reduce_max(want.max_zxid_hi, want.max_zxid_lo)
    assert [int(x) for x in g] == [
        int(want.n_frames.sum()), int(want.n_notifications.sum()),
        int(want.n_errors.sum()), int(h), int(lo)]


@pytest.mark.cuda
@pytest.mark.parametrize('body_mode', ['host', 'device'])
def test_mesh_tick_equals_cpu_mesh_tick_on_card(cuda_device, body_mode):
    """A mesh tick over 4 shards of one card, one replay of the graph of
    the whole sharded step, launches its kernel (K1 or K2) once a shard
    and packs what the same tick packs on 4 CPU shards."""
    from zkstream_tpu_torch.parallel import MeshFleetIngest, make_mesh

    buf, _lens, _slots, _maps = corpus.fleet(B=12, seed=2, frames=16)
    rows = [(None, bytearray(r.tobytes())) for r in buf]
    kw = dict(body_mode=body_mode, max_frames=16, max_data=64, max_path=32,
              max_children=6, max_name=12)
    key = (16, 4096)
    card = MeshFleetIngest(mesh=make_mesh(devices=[cuda_device] * 4), **kw)
    bk = card._compile(key)
    assert bk.graph is not None
    before = TK2.launches, TW.launches
    got = card._run_step(bk, rows)
    k2, k1 = (4, 0) if body_mode == 'device' else (0, 4)
    assert (TK2.launches, TW.launches) == (before[0] + k2, before[1] + k1)
    cpu = MeshFleetIngest(mesh=make_mesh(devices=['cpu'] * 4), **kw)
    want = cpu._run_step(cpu._warm_bucket(key), rows)
    for a, b in zip(want, got):
        if a is not None:
            np.testing.assert_array_equal(a, b)


def _graph_ingest(kind, device):
    """An ingest whose ticks are graphed: ``host``/``device`` bodies,
    or ``mesh-host``/``mesh-device`` on four shards of the one card."""
    from zkstream_tpu_torch.io.ingest import FleetIngest
    from zkstream_tpu_torch.parallel import MeshFleetIngest, make_mesh

    mode = kind.split('-')[-1]
    kw = dict(body_mode=mode, max_frames=16, max_data=64, max_path=32,
              max_children=6, max_name=12)
    if kind.startswith('mesh'):
        return MeshFleetIngest(mesh=make_mesh(devices=[device] * 4), **kw)
    return FleetIngest(device=device, **kw)


def _eager_view(ing, out):
    """The eager chain's output as ``_run_step`` reads it back: a mesh
    step's per-shard ints (and bytes, with device bodies), or a
    ``FleetIngest`` step's ``(ints, bytes-or-None)``."""
    if hasattr(ing, 'mesh'):
        ints, byts = out if ing.body_mode == 'device' else (out, None)
        return ing._local_view(ints), (None if byts is None
                                       else ing._local_view(byts))
    ints, byts = out
    return ints.cpu().numpy(), None if byts is None else byts.cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['host', 'device', 'mesh-host',
                                  'mesh-device'])
def test_replay_equals_eager_chain_on_card(cuda_device, kind):
    """A bucket's graph replayed for a long tick and then a shorter one
    (stale bytes left in the staging rows) packs what the eager chain
    packs on the same staged inputs, counts its kernel's launches per
    replay (once a shard) and none at capture, whose warm-up run is
    counted apart."""
    from zkstream_tpu_torch.ops import tick_graph as TG

    buf, _lens, _slots, _maps = corpus.fleet(B=12, seed=2, frames=16)
    long_rows = [bytearray(r.tobytes()) for r in buf]
    gbuf, glens = corpus.getdata_fleet(4, 4, 1024, 64)
    short_rows = [bytearray(r[:max(n - 30, 0)].tobytes())
                  for r, n in zip(gbuf, glens)]
    ing = _graph_ingest(kind, cuda_device)
    mod = TK2 if ing.body_mode == 'device' else TW
    per_tick = 4 if kind.startswith('mesh') else 1
    before = TW.launches, TK2.launches
    bk = ing._compile((16, 4096))
    assert (TW.launches, TK2.launches) == before
    assert bk.graph.launches == {mod.__name__: per_tick}
    assert bk.graph.warm_launches == {mod.__name__: per_tick}
    for rows in (long_rows, short_rows):
        n0 = mod.launches
        got = [None if x is None else np.array(x)
               for x in ing._run_step(bk, [(None, r) for r in rows])]
        assert mod.launches == n0 + per_tick
        with TG.recording():
            want = _eager_view(ing, ing._step_fn(
                ing.body_mode == 'device')(*bk.inputs()))
        for w, g in zip(want, got):
            if w is not None:
                np.testing.assert_array_equal(w, g)


@pytest.mark.cuda
def test_tick_replays_while_another_bucket_captures(cuda_device):
    """The warm thread captures one bucket (held mid-capture) while the
    loop thread replays another's graph: those ticks equal the CPU's,
    count one K1 launch each, and the held bucket then captures and
    replays as well."""
    import asyncio
    import threading

    from zkstream_tpu_torch.io.ingest import FleetIngest

    buf, _lens, _slots, _maps = corpus.fleet(B=12, seed=3, frames=16)
    active = [(None, bytearray(r.tobytes())) for r in buf]
    maxlen = max(len(b) for _c, b in active)
    held, go = threading.Event(), threading.Event()

    class HeldCapture(FleetIngest):
        def _step(self, buf, lens):
            out = super()._step(buf, lens)
            if buf.shape[1] == key_b[1] and \
                    torch.cuda.is_current_stream_capturing():
                held.set()
                assert go.wait(120)
            return out

    ing = HeldCapture(device='cuda', body_mode='host', max_frames=16,
                      bypass_bytes=0)
    key_a = ing._bucket(len(active), maxlen)
    key_b = (key_a[0], 2 * key_a[1])
    cpu = FleetIngest(device='cpu', body_mode='host', max_frames=16)
    want = cpu._run_step(cpu._warm_bucket(key_a), active)[0]

    async def run():
        await ing.prewarm(len(active), maxlen)
        ev = ing._start_warm(key_b)
        for _ in range(12000):
            if held.is_set():
                break
            await asyncio.sleep(0.01)
        assert held.is_set()
        n0 = TW.launches
        ticks = [np.array(ing._run_step(ing._exec[key_a], active)[0])
                 for _ in range(3)]
        assert TW.launches == n0 + 3 and not ev.is_set()
        go.set()
        await ev.wait()
        bk_b = ing._exec[key_b]
        assert bk_b.graph is not None
        ticks.append(np.array(ing._run_step(bk_b, active)[0]))
        assert TW.launches == n0 + 4
        return ticks

    try:
        ticks = asyncio.run(run())
    finally:
        go.set()
        ing.close()
    for t in ticks:
        np.testing.assert_array_equal(want, t)


async def _live_fleet(ingest, n: int) -> list:
    """``n`` port clients against a fresh port server, each running an
    op surface and a watcher sequence in its own subtree; returns each
    client's observations as plain tuples."""
    import asyncio

    from zkstream_tpu_torch import Client, CreateFlag, ZKError
    from zkstream_tpu_torch.server import ZKDatabase, ZKServer

    async def until(cond):
        for _ in range(3000):
            if cond():
                return
            await asyncio.sleep(0.01)
        raise AssertionError('condition never became true')

    def st(s):
        return (s.version, s.cversion, s.dataLength, s.numChildren)

    async def work(c, root):
        obs, events = [], []
        w = c.watcher(root + '/w')
        for evt in ('created', 'deleted', 'dataChanged'):
            w.on(evt, lambda *a, _e=evt: events.append(_e))
        await until(lambda: events)
        obs.append(await c.create(root + '/w', b'v0'))
        data, s = await c.get(root + '/w')
        obs.append((data, st(s)))
        obs.append(st(await c.set(root + '/w', b'v1' * 40)))
        children, s = await c.list(root)
        obs.append((sorted(children), st(s)))
        obs.append(tuple((int(a.perms), a.id.scheme)
                         for a in await c.get_acl(root + '/w')))
        try:
            await c.get(root + '/missing')
        except ZKError as e:
            obs.append(e.code)
        obs.append(await c.create(root + '/q-', b'',
                                  flags=CreateFlag.SEQUENTIAL))
        await until(lambda: 'dataChanged' in events)
        obs.append(events[:3])
        return obs

    srv = await ZKServer(db=ZKDatabase()).start()
    clients = []
    try:
        if ingest is not None:
            for bp in (8, 16, 32):
                await ingest.prewarm(bp)
        clients = [Client(address='127.0.0.1', port=srv.port,
                          session_timeout=30000, ingest=ingest)
                   for _ in range(n)]
        for c in clients:
            c.start()
        await asyncio.gather(*[c.wait_connected(timeout=30)
                               for c in clients])
        await clients[0].create('/f', b'')
        for i, c in enumerate(clients):
            await c.create('/f/%d' % i, b'')
        return await asyncio.gather(*[work(c, '/f/%d' % i)
                                      for i, c in enumerate(clients)])
    finally:
        await asyncio.gather(*[c.close() for c in clients])
        await srv.stop()


@pytest.mark.cuda
@pytest.mark.parametrize('body_mode', ['host', 'device'])
def test_live_clients_drain_through_kernel_on_card(cuda_device, body_mode):
    """Port clients against the port's server through one
    ``FleetIngest(device='cuda')`` observe what the scalar drain gives,
    and every device tick launches the body mode's kernel once."""
    import asyncio

    from zkstream_tpu_torch.io import FleetIngest

    want = asyncio.run(_live_fleet(None, 24))
    ing = FleetIngest(device='cuda', body_mode=body_mode, bypass_bytes=0,
                      warm='block', max_frames=4)
    k1, k2 = TW.launches, TK2.launches
    got = asyncio.run(_live_fleet(ing, 24))
    assert got == want
    launched = (TW.launches - k1, TK2.launches - k2)
    assert ing.ticks > 0 and ing.frames_routed > 0
    assert launched == ((ing.ticks, 0) if body_mode == 'host'
                        else (0, ing.ticks))
    assert ing.ticks_scalar == ing.ticks_warming == ing.ticks_frag == 0
    assert ing.body_fallbacks == 0


async def _ensemble_failover(ingest, n: int) -> dict:
    """``n`` port clients through ``ingest`` on the in-process port
    ``ZKEnsemble(3)``: each writes its own node, the leader member is
    killed, a successor is elected, and every client writes again on the
    survivors with its old session."""
    import asyncio

    from zkstream_tpu_torch import Client
    from zkstream_tpu_torch.io.invariants import AMBIGUOUS_CODES
    from zkstream_tpu_torch.protocol.errors import ZKError, ZKProtocolError
    from zkstream_tpu_torch.server import ZKEnsemble

    ens = await ZKEnsemble(3, heartbeat_ms=30, seed=1).start()
    clients = [Client(servers=ens.addresses(), shuffle_backends=False,
                      session_timeout=20000, ingest=ingest)
               for _ in range(n)]
    expired = []
    try:
        for i, c in enumerate(clients):
            c.on('expire', lambda _i=i: expired.append(_i))
            c.start()
        await asyncio.gather(*[c.wait_connected(timeout=20)
                               for c in clients])
        sids = [c.session.session_id for c in clients]
        await asyncio.gather(*[c.create('/n%d' % i, b'v0')
                               for i, c in enumerate(clients)])
        elected = asyncio.get_running_loop().create_future()
        ens.election.on('elected', lambda m, e, d: (
            not elected.done() and elected.set_result((m, e))))
        await ens.kill(ens.leader_idx)
        member, epoch = await asyncio.wait_for(elected, 20)

        async def again(i, c):
            # only the failover's outcome-unknown errors are retried
            for _ in range(100):
                try:
                    return await c.set('/n%d' % i, b'v1')
                except (ZKError, ZKProtocolError) as e:
                    if (e.code not in AMBIGUOUS_CODES
                            and e.code != 'EPOCH_FENCED'):
                        raise
                    await asyncio.sleep(0.1)
            raise AssertionError('client %d never wrote again' % (i,))
        await asyncio.gather(*[again(i, c) for i, c in enumerate(clients)])
        got = [bytes((await c.get('/n%d' % i))[0])
               for i, c in enumerate(clients)]
        return {'epoch': epoch, 'got': got, 'expired': expired,
                'same_sessions': [c.session.session_id for c in clients]
                == sids}
    finally:
        await asyncio.gather(*[c.close() for c in clients])
        await ens.stop()


@pytest.mark.cuda
def test_ensemble_leader_kill_through_kernel_on_card(cuda_device):
    """Port clients through one ``FleetIngest(device='cuda')`` ride a
    leader kill on the in-process port ensemble: a successor is
    elected, no session expires, every write after the failover lands,
    and every device tick launched K1 once (K2 never)."""
    import asyncio

    from zkstream_tpu_torch.io import FleetIngest

    ing = FleetIngest(device='cuda', body_mode='host', bypass_bytes=0,
                      warm='block', max_frames=4)
    k1, k2 = TW.launches, TK2.launches
    out = asyncio.run(_ensemble_failover(ing, 24))
    assert out['epoch'] >= 1
    assert out['expired'] == [] and out['same_sessions']
    assert out['got'] == [b'v1'] * 24
    assert ing.ticks > 0 and ing.frames_routed > 0
    assert (TW.launches - k1, TK2.launches - k2) == (ing.ticks, 0)


@pytest.mark.cuda
def test_failed_capture_raises_on_its_tick(cuda_device):
    """A bucket whose capture fails (a tensor made from a host list in
    the step: a pageable copy, which capture refuses) is a warm failure:
    the tick that needs it raises, no packet is delivered, no launch is
    counted and nothing runs the eager chain in the graph's place.  (Last
    in the file: the capture error is left behind on its stream.)"""
    import asyncio

    from zkstream_tpu_torch.io.ingest import FleetIngest
    from zkstream_tpu_torch.protocol.framing import PacketCodec

    class Unsafe(FleetIngest):
        def _step(self, buf, lens):
            ints, byts = super()._step(buf, lens)
            return ints + torch.tensor([0], dtype=torch.int32,
                                       device=buf.device), byts

    class Conn:
        def __init__(self, xid_map):
            self.codec = PacketCodec(use_native=False)
            self.codec.handshaking = False
            self.codec.xid_map.update(xid_map)
            self.got = []

        def is_in_state(self, state):
            return state == 'connected'

        def emit(self, _event, pkts, err):
            self.got.append((pkts, err))

    buf, _lens, _slots, maps = corpus.fleet(B=4, seed=7, frames=16)
    ing = Unsafe(device='cuda', body_mode='host', max_frames=16,
                 bypass_bytes=0, warm='block')
    conns = [Conn(m) for m in maps]

    async def tick():
        for c, row in zip(conns, buf):
            ing.register(c)
            ing.feed(c, row.tobytes())
        n0 = TW.launches
        with pytest.raises(RuntimeError, match='failed to warm'):
            ing._tick_impl()
        assert TW.launches == n0
        with pytest.raises(RuntimeError, match='failed to warm'):
            ing._tick_impl()

    asyncio.run(tick())
    assert all(c.got == [] for c in conns) and ing.ticks == 0
    assert len(ing._exec) == 1 and all(
        isinstance(v, BaseException) for v in ing._exec.values())


def _program_calls(kind, dev):
    """A program on ``dev`` (``kind``: the sharded step at dp=1 or 4, the
    roundtrip at dp=4, the scan at sp=1 or 4) and three calls' arguments
    of one key (for the scan, one N and three n: 0, mid-frame and the
    stream's end), made from seeds."""
    from zkstream_tpu_torch.parallel import (make_mesh,
                                             seq_parallel_frame_scan,
                                             sharded_wire_roundtrip,
                                             sharded_wire_step)

    name, k = kind.split('-')
    k = int(k)
    if name == 'scan':
        s = _walk_streams()['corpus']
        N = -(-(len(s) + 8) // (4 * k)) * 4 * k
        pad = np.zeros(N, np.uint8)
        pad[:len(s)] = np.frombuffer(s, np.uint8)
        buf = torch.from_numpy(pad).to(dev)
        fn = seq_parallel_frame_scan(make_mesh(dp=1, sp=k, devices=[dev] * k))
        return fn, [(buf, n) for n in (0, len(s) // 2 + 3, len(s))]
    mesh = make_mesh(dp=k, devices=[dev] * k)
    if name == 'step':
        calls = []
        for seed in (5, 6, 7):
            buf, lens, _slots, _maps = corpus.fleet(B=64, seed=seed, frames=32)
            calls.append(tuple(TP.batch_to_device(buf, lens, dev)))
        return sharded_wire_step(mesh, max_frames=32), calls
    rng = np.random.RandomState(11)
    calls = []
    for _ in range(3):
        planes = [rng.randint(lo, hi, (64, 8)).astype(np.int32)
                  for lo, hi in ((1, 1 << 20), (0, 1 << 16), (0, 1 << 20),
                                 (0, 1), (0, 48))]
        calls.append(tuple(torch.from_numpy(p).to(dev) for p in planes))
    return sharded_wire_roundtrip(mesh, out_len=512), calls


def _leaves(out):
    from torch.utils._pytree import tree_flatten
    return tree_flatten(out)[0]


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['step-1', 'step-4', 'roundtrip-4',
                                  'scan-1', 'scan-4'])
def test_program_replays_equal_eager_chain_on_card(cuda_device, kind):
    """A one-card program is captured once for its key (one entry over
    three calls on other data; for the scan, three ``n`` of one N) and
    every call replays it, counting its launches per replay: K1 once a
    shard; at sp the scan's sp exit maps and 2 x (1 + max(sp - 1, 1) x
    sp) walk launches.  Each replay equals the eager chain on the same
    staged inputs bit for bit and the same program on CPU shards, and a
    returned result is not overwritten by later calls."""
    from zkstream_tpu_torch.ops import seq_walk as SW
    from zkstream_tpu_torch.ops import tick_graph as TG

    fn, calls = _program_calls(kind, cuda_device)
    cpu_fn, cpu_calls = _program_calls(kind, torch.device('cpu'))
    k = int(kind.split('-')[1])
    per = ({SW.__name__: 2 * (1 + max(k - 1, 1) * k),
            SW.__name__ + ':prepare_launches': k} if kind.startswith('scan')
           else {TW.__name__: k})
    prog = fn.program
    assert fn.graphed and prog.graphed
    kept = []
    for args, cpu_args in zip(calls, cpu_calls):
        before = {key: TG.launch_count(key) for key in per}
        got = fn(*args)
        torch.cuda.synchronize()
        assert {key: TG.launch_count(key) - before[key]
                for key in per} == per
        e = prog.entry(*args)
        assert e.graph.launches == per and e.graph.warm_launches == per
        with TG.recording():
            want = prog.fn(*e.inputs)
        for a, b in zip(_leaves(want), _leaves(got)):
            assert torch.equal(a, b)
        for a, b in zip(_leaves(cpu_fn(*cpu_args)), _leaves(got)):
            assert torch.equal(a, b.cpu())
        kept.append((got, [t.clone() for t in _leaves(got)]))
    assert len(prog.entries) == 1
    for got, copy in kept:
        for a, b in zip(_leaves(got), copy):
            assert torch.equal(a, b)
