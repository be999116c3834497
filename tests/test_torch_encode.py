"""The port's encoder and helper ops against the JAX package's.

``build_reply_streams`` as tests/test_encode.py tests it (the
encode->decode roundtrip, byte agreement with the scalar codec,
interleaved absent frames, the overflow drop), ``slice_frame_bodies``
with and without ``skip_header``, and ``frame_starts_pointer_doubling``
(a reachable bad prefix included): the same numpy inputs, made from a
seed, through both packages, tolerance 0 (integer and bool planes).
"""

import random
import struct

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from zkstream_tpu.ops.bodies import slice_frame_bodies as j_slice  # noqa: E402
from zkstream_tpu.ops.encode import build_reply_streams as j_build  # noqa: E402
from zkstream_tpu.ops.frame_scan import (  # noqa: E402
    frame_starts_pointer_doubling as j_doubling)
from zkstream_tpu_torch.ops import (  # noqa: E402
    build_reply_streams, frame_cursor_scan, frame_starts_pointer_doubling,
    slice_frame_bodies, wire_pipeline_step)
from zkstream_tpu_torch.protocol.framing import FrameDecoder  # noqa: E402


def _planes(rng, B, F):
    """int32 [B, F] planes (xid, zxid hi/lo, err, sizes) as numpy; rows
    carry a random count of frames, the rest absent (sizes 0)."""
    p = {k: np.zeros((B, F), np.int32)
         for k in ('xid', 'zhi', 'zlo', 'err', 'sizes')}
    for i in range(B):
        for j in range(rng.randrange(0, F + 1)):
            p['xid'][i, j] = rng.choice([-2, -1, rng.randrange(1, 1 << 20)])
            z = rng.randrange(0, 1 << 48)
            p['zhi'][i, j] = z >> 32
            p['zlo'][i, j] = np.uint32(z & 0xFFFFFFFF).astype(np.int32)
            p['err'][i, j] = rng.choice([0, 0, -101])
            p['sizes'][i, j] = 16 + rng.randrange(0, 40)
    return [p[k] for k in ('xid', 'zhi', 'zlo', 'err', 'sizes')]


def _both(planes, out_len):
    """The encoded streams from the port and from the JAX package."""
    got = build_reply_streams(*map(torch.from_numpy, planes),
                              out_len=out_len)
    want = j_build(*map(jnp.asarray, planes), out_len=out_len)
    np.testing.assert_array_equal(np.asarray(want[0]), got[0].numpy())
    np.testing.assert_array_equal(np.asarray(want[1]), got[1].numpy())
    assert got[0].dtype == torch.uint8 and got[1].dtype == torch.int32
    assert got[0].is_contiguous()       # kernel K1 reads it as it is
    return got


@pytest.mark.parametrize('seed', [0, 1])
def test_encode_decode_roundtrip(seed):
    rng = random.Random(seed)
    B, F, L = 16, 8, 512
    planes = _planes(rng, B, F)
    xid, _zhi, _zlo, err, sizes = planes
    buf, lens = _both(planes, L)
    out = wire_pipeline_step(buf, lens, max_frames=F)
    valid = sizes >= 16
    np.testing.assert_array_equal(out.n_frames.numpy(), valid.sum(axis=1))
    np.testing.assert_array_equal(out.xids.numpy(), np.where(valid, xid, 0))
    np.testing.assert_array_equal(out.errs.numpy(), np.where(valid, err, 0))
    np.testing.assert_array_equal(out.sizes.numpy(),
                                  np.where(valid, sizes, 0))
    assert not out.bad.any()
    np.testing.assert_array_equal(out.resid.numpy(), lens.numpy())


def test_encode_matches_scalar_codec():
    rng = random.Random(7)
    B, F, L = 8, 6, 400
    planes = _planes(rng, B, F)
    xid, zhi, zlo, err, sizes = planes
    buf, lens = _both(planes, L)
    hdr = struct.Struct('>iqi')
    for i in range(B):
        bodies = list(FrameDecoder(use_native=False).feed(
            bytes(buf[i, :int(lens[i])].numpy())))
        want = [(int(xid[i, j]), (int(zhi[i, j]) << 32)
                 | (int(zlo[i, j]) & 0xFFFFFFFF), int(err[i, j]),
                 int(sizes[i, j])) for j in range(F) if sizes[i, j] >= 16]
        assert len(bodies) == len(want)
        for body, (wx, wz, we, wsz) in zip(bodies, want):
            assert len(body) == wsz
            x, z, e = hdr.unpack_from(body, 0)
            assert (x, z & 0xFFFFFFFFFFFFFFFF, e) == \
                (wx, wz & 0xFFFFFFFFFFFFFFFF, we)


def test_encode_compacts_interleaved_absent_frames():
    z = np.zeros((1, 3), np.int32)
    planes = [np.asarray([[7, 8, 9]], np.int32), z, z, z,
              np.asarray([[16, 0, 20]], np.int32)]
    buf, lens = _both(planes, 64)
    assert int(lens[0]) == 20 + 24
    out = wire_pipeline_step(buf, lens, max_frames=3)
    assert int(out.n_frames[0]) == 2
    assert out.xids[0].tolist() == [7, 9, 0]
    assert out.sizes[0].tolist() == [16, 20, 0]


def test_encode_drops_overflowing_frames():
    z = np.zeros((1, 3), np.int32)
    planes = [np.asarray([[1, 2, 3]], np.int32), z, z, z,
              np.full((1, 3), 16, np.int32)]
    buf, lens = _both(planes, 45)
    assert int(lens[0]) == 40           # two frames fit, the third drops
    out = wire_pipeline_step(buf, lens, max_frames=3)
    assert int(out.n_frames[0]) == 2
    assert out.xids[0].tolist() == [1, 2, 0]


def _stream(rng, n, max_body):
    s = b''
    for _ in range(n):
        body = bytes(rng.randrange(256)
                     for _ in range(rng.randrange(0, max_body)))
        hdr = struct.pack('>iqi', rng.randrange(1, 1000),
                          rng.randrange(1 << 40), 0)
        s += struct.pack('>i', len(hdr) + len(body)) + hdr + body
    return s


def _batch(streams, L):
    buf = np.zeros((len(streams), L), np.uint8)
    lens = np.zeros((len(streams),), np.int32)
    for i, s in enumerate(streams):
        s = s[:L]
        buf[i, :len(s)] = np.frombuffer(s, np.uint8)
        lens[i] = len(s)
    return buf, lens


@pytest.mark.parametrize('skip_header', [False, True])
@pytest.mark.parametrize('max_body', [8, 32, 48])
def test_slice_frame_bodies_matches_jax(skip_header, max_body):
    rng = random.Random(21 + max_body)
    B, L, F = 12, 300, 6
    buf, lens = _batch([_stream(rng, rng.randrange(0, 6), 40)
                        for _ in range(B)], L)
    starts, sizes, *_ = frame_cursor_scan(torch.from_numpy(buf),
                                          torch.from_numpy(lens), F)
    got = slice_frame_bodies(torch.from_numpy(buf), starts, sizes,
                             max_body=max_body, skip_header=skip_header)
    want = j_slice(jnp.asarray(buf), jnp.asarray(starts.numpy()),
                   jnp.asarray(sizes.numpy()), max_body=max_body,
                   skip_header=skip_header)
    assert got[0].dtype == torch.uint8 and got[1].dtype == torch.bool
    np.testing.assert_array_equal(np.asarray(want[0]), got[0].numpy())
    np.testing.assert_array_equal(np.asarray(want[1]), got[1].numpy())
    # and the bytes are the frames' own
    hdr = 16 if skip_header else 0
    for i in range(B):
        for j in range(F):
            s, n = int(starts[i, j]), int(sizes[i, j])
            if s < 0 or n <= hdr:
                assert not got[1][i, j].any()
                continue
            w = buf[i, s + hdr:s + n][:max_body]
            np.testing.assert_array_equal(got[0][i, j, :len(w)].numpy(), w)
            assert int(got[1][i, j].sum()) == len(w)


def _doubling_both(pad, n):
    got = frame_starts_pointer_doubling(torch.from_numpy(pad), n)
    want = j_doubling(jnp.asarray(pad), jnp.int32(n))
    np.testing.assert_array_equal(np.asarray(want[0]), got[0].numpy())
    assert bool(want[1]) == bool(got[1])
    return np.nonzero(got[0].numpy())[0].tolist(), bool(got[1])


@pytest.mark.parametrize('seed', range(4))
def test_pointer_doubling_matches_jax_and_decoder(seed):
    rng = random.Random(5 + seed)
    s = _stream(rng, rng.randrange(1, 20), 32)
    if seed % 2:
        s += b'\x00\x00'                 # a tail shorter than a prefix
    L = len(s) + (16 - len(s) % 16) % 16 + 16
    pad = np.zeros(L, np.uint8)
    pad[:len(s)] = np.frombuffer(s, np.uint8)
    got, bad = _doubling_both(pad, len(s))
    exp, off = [], 0
    for b in FrameDecoder(use_native=False).feed(s):
        exp.append(off)
        off += 4 + len(b)
    assert got == exp and not bad


def test_pointer_doubling_bad_prefix_reachable():
    s = (struct.pack('>i', 16) + struct.pack('>iqi', 1, 1, 0)
         + struct.pack('>i', -1) + b'\x00' * 8)
    pad = np.zeros(64, np.uint8)
    pad[:len(s)] = np.frombuffer(s, np.uint8)
    got, bad = _doubling_both(pad, len(s))
    assert bad and got == [0]
    # random bytes: unreachable bad prefixes do not count
    rng = np.random.RandomState(9)
    for n in (0, 3, 57, 200):
        _doubling_both(rng.randint(0, 256, 200).astype(np.uint8), n)
