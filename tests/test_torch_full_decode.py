"""The port's tick decode with GET_DATA bodies (``wire_full_decode``,
kernel K2's plain version on the CPU) against zkstream_tpu's: the
Pallas full decode in interpret mode (``wire_full_decode_pallas``) at
the shapes tests/test_pallas.py uses, and ``wire_pipeline_step`` +
``getdata_bodies_jnp`` at wider ones.  The unpacked ``(WireStats,
GetDataBodies)`` are compared, every plane exactly (tolerance 0); the
raw ``dlen_raw``/``data_words`` are not, because at masked slots the
Pallas kernel reads its rolled, zero-padded words where the port
clamps its reads.  K2 itself is held against the plain version on the
card by tests/test_torch_cuda.py."""

import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_pipeline import _random_fleet
from test_torch_replies import _same
from zkstream_tpu.ops import pipeline as JP
from zkstream_tpu_torch import corpus
from zkstream_tpu_torch.ops import full_scan as TK2
from zkstream_tpu_torch.ops import pipeline as TP
from zkstream_tpu_torch.ops import replies as TR
from zkstream_tpu_torch.ops import wire_scan as TW


def _corpus_rows():
    buf, lens, _slots, _maps = corpus.fleet(B=16, seed=11, frames=64)
    return buf, lens


_INPUTS = {
    'getdata0': lambda: corpus.getdata_fleet(0, 13, 512, 16),
    'getdata7': lambda: corpus.getdata_fleet(7, 13, 512, 16),
    'getdata_wide': lambda: corpus.getdata_fleet(5, 24, 2048, 64),
    'adversarial': lambda: corpus.adversarial(0),
    'random': lambda: _random_fleet(4),
}


def _port(buf, lens):
    return torch.from_numpy(buf), torch.from_numpy(lens)


def _jax_reference(buf, lens, F, max_data):
    jb = jnp.asarray(buf)
    st = JP.wire_pipeline_step(jb, jnp.asarray(lens), max_frames=F)
    return st, JP.getdata_bodies_jnp(jb, st, max_data)


@pytest.mark.parametrize('seed', [0, 7])
def test_full_decode_matches_pallas_interpret(seed):
    from zkstream_tpu.ops.pipeline import wire_full_decode_pallas

    buf, lens = corpus.getdata_fleet(seed, 13, 512, 16)
    want = wire_full_decode_pallas(jnp.asarray(buf), jnp.asarray(lens),
                                   max_frames=6, max_data=16,
                                   block_rows=8, interpret=True)
    got = TP.wire_full_decode(*_port(buf, lens), max_frames=6, max_data=16)
    _same(want[0], got[0], 'stats')
    _same(want[1], got[1], 'getdata')


@pytest.mark.parametrize('name', sorted(_INPUTS))
@pytest.mark.parametrize('max_data', [16, 64])
def test_full_decode_matches_jnp(name, max_data):
    buf, lens = _INPUTS[name]()
    want = _jax_reference(buf, lens, 8, max_data)
    tb, tl = _port(buf, lens)
    got = TP.wire_full_decode(tb, tl, max_frames=8, max_data=max_data)
    _same(want[0], got[0], 'stats')
    _same(want[1], got[1], 'getdata')
    # the plain reference semantics agree on the same planes
    _same(want[1], TP.getdata_bodies(tb, got[0], max_data), 'plain')


def test_full_decode_wide_corpus():
    """The main path's widths: max_data=256, 64 frames a stream, on
    corpus rows whose 256 B GET_DATA payloads exactly fit."""
    buf, lens = _corpus_rows()
    want = _jax_reference(buf, lens, 64, 256)
    st, gd = TP.wire_full_decode(*_port(buf, lens), max_frames=64,
                                 max_data=256)
    _same(want[0], st, 'stats')
    _same(want[1], gd, 'getdata')
    get_data = np.asarray([s['kind'] == 'data'
                           for s in corpus.slot_schedule(64)[0]])
    assert bool(gd.data_ok[:, get_data].all())
    assert (gd.data_len[:, get_data] == corpus.DATA_LEN).all()
    assert bool(gd.stat_after_data.valid[:, get_data].all())


@pytest.mark.parametrize('name', ['getdata0', 'adversarial'])
def test_full_scan_plain_is_k1_plus_body_words(name):
    """On a CPU tensor ``full_scan`` is the plain version; its K1
    planes are K1's plain planes, and no launch is counted."""
    buf, lens = _INPUTS[name]()
    tb, tl = _port(buf, lens)
    before = TK2.launches, TW.launches
    got = TK2.full_scan(tb, tl, 8, 16)
    assert (TK2.launches, TW.launches) == before
    want = TK2.full_scan_plain(tb, tl, 8, 16)
    k1 = TW.wire_scan_plain(tb, tl, 8)
    assert sorted(got) == sorted(list(k1) + ['dlen_raw', 'data_words',
                                            'stat_words'])
    for k in got:
        assert torch.equal(got[k], want[k]), k
        if k in k1:
            assert torch.equal(got[k], k1[k]), k
    assert got['data_words'].shape == (buf.shape[0], 8, 4)
    assert got['stat_words'].shape == (buf.shape[0], 8, 17)


def test_full_scan_checks_inputs():
    buf = torch.zeros((2, 64), dtype=torch.uint8)
    lens = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match='multiple of 4'):
        TK2.full_scan(buf, lens, 4, 18)
    with pytest.raises(ValueError):
        TK2.full_scan(buf, lens.to(torch.int64), 4, 16)
    with pytest.raises(ValueError):
        TK2.full_scan(buf[:, :0], lens, 4, 16)


def test_bound_bytes_counts_what_the_masks_let_through():
    P = struct.Struct('>i').pack
    hdr = struct.pack('>iqi', 1, 2, 0)
    # a GET_DATA frame with 6 data bytes (2 words) and a Stat; a frame
    # whose buffer overruns it (length read, no Stat); a 10-byte frame
    body_a = hdr + P(6) + b'abcdef' + b'\x07' * 68
    body_b = hdr + P(4096) + b'zz'
    row = (P(len(body_a)) + body_a + P(len(body_b)) + body_b
           + P(10) + b'\x00' * 10)
    buf = np.zeros((2, 256), np.uint8)
    buf[0, :len(row)] = np.frombuffer(row, np.uint8)
    lens = np.asarray([len(row), 0], np.int32)
    out = TK2.full_scan_plain(*_port(buf, lens), 4, 16)
    reads = (20 * 3 + 4 * 2 + 4 * (2 + 4) + 68 * 1 + 4 * 2)
    writes = 4 * (7 + 4 + 17) * 2 * 4 + 9 * 2
    assert TK2.bound_bytes(out, 16) == reads + writes


def test_reply_bodies_take_getdata_planes():
    """``parse_reply_bodies(getdata=...)`` takes K2's GET_DATA view as
    is and equals the parse that computes it."""
    buf, lens = corpus.getdata_fleet(3, 16, 1024, 32)
    tb, tl = _port(buf, lens)
    st, gd = TP.wire_full_decode(tb, tl, max_frames=8, max_data=32)
    for max_path in (16, 32):
        want = TR.parse_reply_bodies(tb, st.starts, st.sizes, max_data=32,
                                     max_path=max_path)
        got = TR.parse_reply_bodies(tb, st.starts, st.sizes, max_data=32,
                                    max_path=max_path, getdata=gd)
        _same(want, got)
        assert got.data is gd.data
