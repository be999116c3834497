"""The port's mesh plane against the JAX package's, on 8 CPU shards.

The JAX side runs on conftest's 8 virtual CPU devices; the port's on a
mesh of 8 ``torch.device('cpu')`` shards (the plain versions).  Same
numpy inputs, made from a seed, tolerance 0: ``make_mesh`` shapes and
errors, ``sharded_wire_step`` (every WireStats field and
GlobalWireStats), ``sharded_wire_roundtrip``, ``seq_parallel_frame_scan``
(the cases of tests/test_parallel.py plus a truncated tail and a tail
shorter than a prefix), and the plain chunk walk against ``_walk``.
"""

import random
import struct

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from zkstream_tpu import parallel as JP  # noqa: E402
from zkstream_tpu.ops.pipeline import wire_pipeline_step as j_step  # noqa: E402
from zkstream_tpu.parallel.seqscan import _walk  # noqa: E402
from zkstream_tpu_torch import parallel as TP  # noqa: E402
from zkstream_tpu_torch.ops import seq_walk as SW  # noqa: E402
from zkstream_tpu_torch.ops.bytesops import u64pair_to_int  # noqa: E402
from zkstream_tpu_torch.protocol.framing import FrameDecoder  # noqa: E402

CPU8 = [torch.device('cpu')] * 8


def _reply_frame(xid, zxid, err, body=b''):
    hdr = struct.pack('>iqi', xid, zxid, err)
    return struct.pack('>i', len(hdr) + len(body)) + hdr + body


def _fleet(rng, B, L):
    buf = np.zeros((B, L), np.uint8)
    lens = np.zeros((B,), np.int32)
    for i in range(B):
        s = b''
        for _ in range(rng.randrange(0, 6)):
            xid = rng.choice([-1, -2, rng.randrange(1, 1000)])
            zxid = rng.randrange(0, 1 << 63) if xid >= 0 else -1
            s += _reply_frame(xid, zxid, rng.choice([0, -101]),
                              bytes(rng.randrange(256)
                                    for _ in range(rng.randrange(20))))
        if i % 5 == 3:
            s += struct.pack('>i', -7)              # a bad prefix
        buf[i, :len(s)] = np.frombuffer(s, np.uint8)
        lens[i] = len(s)
    return buf, lens


def test_mesh_shapes_and_errors():
    m = TP.make_mesh(devices=CPU8)
    assert m.shape == JP.make_mesh().shape == {'dp': 8, 'sp': 1}
    m = TP.make_mesh(sp=4, devices=CPU8)
    assert m.shape == JP.make_mesh(sp=4).shape == {'dp': 2, 'sp': 4}
    assert m.devices.shape == (2, 4) and m.world_size == 1
    assert m.group is None and m.first == torch.device('cpu')
    for kw in ({'dp': 3, 'sp': 2}, {'sp': 3}, {'dp': 16}):
        with pytest.raises(ValueError):
            TP.make_mesh(devices=CPU8, **kw)
        with pytest.raises(ValueError):
            JP.make_mesh(**kw)
    with pytest.raises(ValueError, match='unsupported'):
        TP.make_mesh(devices=['meta'])


def test_make_mesh_default_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default mesh is valid')
    with pytest.raises(RuntimeError, match='CUDA'):
        TP.make_mesh()
    with pytest.raises(RuntimeError, match='CUDA'):
        TP.make_mesh(devices=['cuda:0'])


@pytest.mark.parametrize('seed', [10, 11])
@pytest.mark.parametrize('dp', [8, 4, 1])
def test_sharded_wire_step_matches_jax(seed, dp):
    buf, lens = _fleet(random.Random(seed), B=16, L=256)
    want, wg = JP.sharded_wire_step(JP.make_mesh(dp=dp, sp=8 // dp),
                                    max_frames=8)(jnp.asarray(buf),
                                                  jnp.asarray(lens))
    mesh = TP.make_mesh(dp=dp, sp=8 // dp, devices=CPU8)
    got, g = TP.sharded_wire_step(mesh, max_frames=8)(
        torch.from_numpy(buf), torch.from_numpy(lens))
    for f in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      getattr(got, f).numpy(), err_msg=f)
    for f in wg._fields:
        assert getattr(g, f).dtype == torch.int32 and \
            getattr(g, f).shape == ()
        assert int(getattr(wg, f)) == int(getattr(g, f)), f
    ref = j_step(jnp.asarray(buf), jnp.asarray(lens), max_frames=8)
    assert int(g.total_frames) == int(jnp.sum(ref.n_frames)) > 0
    best = max(u64pair_to_int(ref.max_zxid_hi[i], ref.max_zxid_lo[i])
               for i in range(16))
    assert u64pair_to_int(g.max_zxid_hi, g.max_zxid_lo) == best


def test_sharded_step_takes_host_local_shards():
    buf, lens = _fleet(random.Random(13), B=16, L=256)
    mesh = TP.make_mesh(dp=8, devices=CPU8)
    gbuf, glens = TP.host_local_wire_batch(mesh, buf, lens)
    assert len(gbuf) == 8 and all(b.shape == (2, 256) for b in gbuf)
    buf[:] = 0                        # the shards own their bytes
    got, g = TP.sharded_wire_step(mesh, max_frames=8)(gbuf, glens)
    want, wg = JP.sharded_wire_step(JP.make_mesh(dp=8), max_frames=8)(
        *JP.host_local_wire_batch(JP.make_mesh(dp=8),
                                  *_fleet(random.Random(13), 16, 256)))
    np.testing.assert_array_equal(np.asarray(want.n_frames),
                                  got.n_frames.numpy())
    assert int(wg.total_frames) == int(g.total_frames)
    with pytest.raises(ValueError, match='divide'):
        TP.host_local_wire_batch(mesh, buf[:12], lens[:12])


def test_sharded_roundtrip_matches_jax():
    rng = np.random.RandomState(4)
    B, F, L = 16, 6, 512

    def mk(lo, hi):
        return rng.randint(lo, hi, (B, F)).astype(np.int32)
    sizes = mk(16, 40)
    sizes[0, 2], sizes[5, 0] = 0, 3            # absent frames
    planes = (mk(1, 1 << 20), mk(0, 1 << 16), mk(0, 1 << 20),
              np.zeros((B, F), np.int32), sizes)
    want, wt = JP.sharded_wire_roundtrip(JP.make_mesh(dp=8), max_frames=F,
                                         out_len=L)(*map(jnp.asarray, planes))
    got, total = TP.sharded_wire_roundtrip(
        TP.make_mesh(dp=8, devices=CPU8), out_len=L)(
            *map(torch.from_numpy, planes))
    for f in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      getattr(got, f).numpy(), err_msg=f)
    assert int(total) == int(wt) == B * F - 2


def _scan_both(s, sp=8, n=None):
    """The sp-sharded scan of stream ``s`` through both packages."""
    N = ((len(s) + 4 * sp - 1) // (4 * sp) + 1) * 4 * sp
    pad = np.zeros(N, np.uint8)
    pad[:len(s)] = np.frombuffer(s, np.uint8)
    n = len(s) if n is None else n
    want = JP.seq_parallel_frame_scan(JP.make_mesh(dp=8 // sp, sp=sp))(
        jnp.asarray(pad), jnp.int32(n))
    got = TP.seq_parallel_frame_scan(TP.make_mesh(
        dp=8 // sp, sp=sp, devices=CPU8))(torch.from_numpy(pad), n)
    np.testing.assert_array_equal(np.asarray(want[0]), got[0].numpy())
    assert int(want[1]) == int(got[1]) and bool(want[2]) == bool(got[2])
    assert got[0].dtype == torch.bool and got[1].dtype == torch.int32
    return np.nonzero(got[0].numpy())[0].tolist(), int(got[1]), bool(got[2])


@pytest.mark.parametrize('sp', [8, 4, 1])
def test_seq_parallel_scan_matches_decoder(sp):
    rng = random.Random(11)
    for trial in range(6):
        s, exp = b'', []
        for _ in range(rng.randrange(1, 30)):
            exp.append(len(s))
            s += _reply_frame(rng.randrange(1, 100), rng.randrange(1 << 40),
                              0, bytes(rng.randrange(256) for _ in
                                       range(rng.randrange(0, 120))))
        if trial % 3 == 1:
            s += struct.pack('>i', 999)       # truncated tail, no body
        elif trial % 3 == 2:
            s += b'\x00\x00'                  # tail shorter than a prefix
        starts, total, bad = _scan_both(s, sp)
        assert starts == exp and total == len(exp) and not bad
        assert len(FrameDecoder(use_native=False).feed(s)) == len(exp)


def test_seq_parallel_scan_frame_spanning_whole_shards():
    body = bytes(range(256)) * 2
    s = _reply_frame(5, 42, 0, body) + _reply_frame(6, 43, 0)
    assert _scan_both(s) == ([0, 4 + 16 + 512], 2, False)


def test_seq_parallel_scan_bad_prefix():
    s = _reply_frame(1, 1, 0) + struct.pack('>i', -7) + b'\x00' * 20
    starts, total, bad = _scan_both(s)
    assert starts == [0] and total == 1 and bad


def test_seq_parallel_scan_truncated_frame_mid_stream():
    # a frame cut short stops the whole stream's decode: later shards
    # see a saturated entry and mark nothing
    s = (_reply_frame(1, 1, 0, b'x' * 40) + struct.pack('>i', 300)
         + b'\x00' * 200)
    assert _scan_both(s) == ([0], 1, False)
    # n shorter than the buffer: frames past n are not complete
    s = b''.join(_reply_frame(i, i, 0, b'y' * 30) for i in range(1, 9))
    _scan_both(s, n=len(s) - 5)
    _scan_both(s, n=3)


@pytest.mark.parametrize('seed', range(3))
def test_plain_chunk_walk_matches_walk(seed):
    """``seq_walk.walk_plain`` against the JAX ``_walk`` on random
    chunks, bases, ends and entry cursors (entries before the chunk
    included, whose reads clamp)."""
    rng = random.Random(seed)
    walk = jax.jit(_walk)                 # one compile per chunk width
    for _ in range(150):
        C = rng.choice([1, 7, 40])
        ext = np.frombuffer(bytes(rng.randrange(256) if rng.random() < .3
                                  else 0 for _ in range(C + 4)),
                            np.uint8).copy()
        if rng.random() < 0.3:
            ext[rng.randrange(C)] = rng.choice([0x80, 0xff])
        base = rng.randrange(0, 100)
        n = rng.randrange(0, 300)
        end = min(base + C, n)
        entry = rng.choice([rng.randrange(0, 200), base,
                            SW.SATURATED])
        q, mask, bad = walk(jnp.asarray(ext), jnp.int32(base),
                            jnp.int32(end), jnp.int32(n), jnp.int32(entry))
        got = SW.walk_plain(torch.from_numpy(ext), base, end, n, entry)
        assert (got[0], got[2]) == (int(q), bool(bad))
        np.testing.assert_array_equal(np.asarray(mask), got[1].numpy())


def test_seq_walk_ring_step_adopts_once():
    """The ring step's adopt rule on the CPU: no walk without an offered
    entry, one walk on the first offer, none after."""
    ext = torch.from_numpy(np.frombuffer(
        _reply_frame(1, 1, 0) + b'\x00' * 8, np.uint8).copy())
    C = ext.shape[0] - 4
    st = SW.new_state(C, 'cpu')
    before = SW.launches
    SW.seq_walk(ext, 0, C, torch.tensor(-1, dtype=torch.int32), st)
    assert int(st.valid) == 0 and int(st.exit) == -1
    SW.seq_walk(ext, 0, 20, torch.tensor(0, dtype=torch.int32), st)
    assert (int(st.valid), int(st.exit), bool(st.bad)) == (1, 20, False)
    assert st.mask.nonzero().flatten().tolist() == [0]
    SW.seq_walk(ext, 0, 20, torch.tensor(4, dtype=torch.int32), st)
    assert int(st.exit) == 20                  # walked once only
    assert SW.launches == before               # no kernel on the CPU
    with pytest.raises(ValueError):
        SW.seq_walk(ext, 0, 20, torch.tensor(0), st)   # int64 cursor
