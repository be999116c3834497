"""The port's bytesops against zkstream_tpu.ops.bytesops: the same
numpy inputs through the JAX function and its torch counterpart, equal
field for field (integers: tolerance 0), edge words included."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zkstream_tpu.ops import bytesops as J
from zkstream_tpu_torch.ops import bytesops as T

_EDGE_WORDS = (0, 1, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFF,
               0xFF000000, 0x00FF0000, 0x0000FF00, 0x000000FF)


def _buf(seed, B=6, L=40):
    rng = np.random.RandomState(seed)
    buf = rng.randint(0, 256, (B, L)).astype(np.uint8)
    # plant the edge words at the start of every row, big-endian
    words = np.array(_EDGE_WORDS, np.uint32)[:L // 4].astype('>u4')
    edge = np.frombuffer(words.tobytes(), np.uint8)
    buf[0, :edge.size] = edge
    return buf


def _pairs(seed, n=64):
    rng = np.random.RandomState(seed)
    edges = np.array(_EDGE_WORDS, np.uint32).view(np.int32)
    h = rng.choice(edges, n)
    l = rng.choice(edges, n)
    h[: n // 2] = rng.randint(-2**31, 2**31, n // 2, dtype=np.int64)
    return h.astype(np.int32), l.astype(np.int32)


@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('fn', ['_byte_at', 'be_i32_at', 'be_i64pair_at'])
def test_gathers_match_jax(fn, seed):
    buf = _buf(seed)
    rng = np.random.RandomState(100 + seed)
    # offsets out of range on both sides exercise the clamp
    offs = rng.randint(-6, buf.shape[1] + 6, (buf.shape[0], 9))
    offs[0, :8] = np.arange(0, 32, 4)            # the edge words
    offs = offs.astype(np.int32)
    for off in (offs, offs[:, 0]):               # [B, K] and [B]
        want = getattr(J, fn)(jnp.asarray(buf), jnp.asarray(off))
        got = getattr(T, fn)(torch.from_numpy(buf), torch.from_numpy(off))
        if fn == 'be_i64pair_at':
            for w, g in zip(want, got):
                np.testing.assert_array_equal(np.asarray(w), g.numpy())
        else:
            np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_be_i32_edge_words_signed():
    buf = _buf(0)
    off = np.arange(0, 40, 4, dtype=np.int32)[None, :].repeat(6, 0)
    got = T.be_i32_at(torch.from_numpy(buf), torch.from_numpy(off))[0]
    want = np.array(_EDGE_WORDS, np.uint32).view(np.int32)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('fn', ['u64pair_lt', 'u64pair_max'])
def test_pair_compare_match_jax(fn, seed):
    ah, al = _pairs(seed)
    bh, bl = _pairs(seed + 50)
    bh[::3] = ah[::3]                            # equal hi words
    want = getattr(J, fn)(*map(jnp.asarray, (ah, al, bh, bl)))
    got = getattr(T, fn)(*map(torch.from_numpy, (ah, al, bh, bl)))
    if fn == 'u64pair_lt':
        want, got = (want,), (got,)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize('axis', [None, 0, 1])
def test_reduce_max_match_jax(axis):
    h, l = _pairs(7, n=60)
    h, l = h.reshape(6, 10), l.reshape(6, 10)
    h[2, :] = np.int32(-1)                       # 0xFFFFFFFF ties
    want = J.u64pair_reduce_max(jnp.asarray(h), jnp.asarray(l), axis=axis)
    got = T.u64pair_reduce_max(torch.from_numpy(h), torch.from_numpy(l),
                               axis=axis)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_host_pair_helpers_match_jax():
    h, l = _pairs(9)
    np.testing.assert_array_equal(T.u64pair_to_int(h, l),
                                  J.u64pair_to_int(h, l))
    np.testing.assert_array_equal(T.i64pair_to_int(h, l),
                                  J.i64pair_to_int(h, l))
    assert T.i64pair_to_int(np.int32(-1), np.int32(-1)) == -1
    assert T.u64pair_to_int(np.int32(-2**31), np.int32(0)) == 1 << 63
