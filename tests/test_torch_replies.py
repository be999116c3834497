"""The port's reply-body parse (zkstream_tpu_torch.ops.replies) against
zkstream_tpu's, on the cases of tests/test_replies.py: the same numpy
bytes through the JAX functions and the port's, every plane compared
exactly (tolerance 0: all planes are integer or bool)."""

import random
import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_replies import (
    MAX_ACLS,
    MAX_CHILDREN,
    MAX_DATA,
    MAX_ID,
    MAX_NAME,
    MAX_PATH,
    MAX_SCHEME,
    _build_fleet,
    _frame,
    _rand_list_packet,
    _rand_stat,
)
from zkstream_tpu.ops import pipeline as JP
from zkstream_tpu.ops import replies as JR
from zkstream_tpu.protocol import records as jrecords
from zkstream_tpu.protocol.consts import KeeperState, NotificationType
from zkstream_tpu.protocol.jute import JuteWriter
from zkstream_tpu_torch.ops import pipeline as TP
from zkstream_tpu_torch.ops import replies as TR


def _same(want, got, path='bodies'):
    """Every field of two (nested) NamedTuples equal, array for array."""
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


def _steps(buf, lens, F):
    """The JAX and port tick decode of one numpy batch."""
    jst = JP.wire_pipeline_step(jnp.asarray(buf), jnp.asarray(lens),
                                max_frames=F)
    tb, tl = torch.from_numpy(buf), torch.from_numpy(lens)
    tst = TP.wire_pipeline_step(tb, tl, max_frames=F)
    return jnp.asarray(buf), jst, tb, tst


def _one_frame_batch(body, L):
    raw = struct.pack('>i', len(body)) + body
    buf = np.zeros((1, L), np.uint8)
    buf[0, :len(raw)] = np.frombuffer(raw, np.uint8)
    return buf, np.asarray([len(raw)], np.int32)


def _list_batch(seed, n_streams=8, F=6):
    rng = random.Random(seed)
    streams = []
    for _b in range(n_streams):
        raw = b''
        for f in range(F):
            pkt, _op = _rand_list_packet(rng, f + 1)
            raw += _frame(pkt)
        streams.append(raw)
    L = max(len(s) for s in streams)
    buf = np.zeros((n_streams, L), np.uint8)
    lens = np.zeros((n_streams,), np.int32)
    for i, s in enumerate(streams):
        buf[i, :len(s)] = np.frombuffer(s, np.uint8)
        lens[i] = len(s)
    return buf, lens


_LIST_KW = dict(max_children=MAX_CHILDREN, max_name=MAX_NAME,
                max_acls=MAX_ACLS, max_scheme=MAX_SCHEME, max_id=MAX_ID)


@pytest.mark.parametrize('widths', [(MAX_DATA, MAX_PATH),
                                    (MAX_DATA, MAX_DATA)],
                         ids=['distinct', 'equal'])
@pytest.mark.parametrize('seed', [1, 2, 3])
def test_reply_bodies_match_jax(seed, widths):
    max_data, max_path = widths
    buf, lens, _maps, _pkts = _build_fleet(seed, 32, 12)
    jb, jst, tb, tst = _steps(buf, lens, 12)
    want = JR.parse_reply_bodies(jb, jst.starts, jst.sizes,
                                 max_data=max_data, max_path=max_path)
    got = TR.parse_reply_bodies(tb, tst.starts, tst.sizes,
                                max_data=max_data, max_path=max_path)
    _same(want, got)
    # the host view collapses every slot to the same Stat record
    jn = JR.StatPlanes(*(np.asarray(x) for x in want.stat_after_data))
    tn = TR.StatPlanes(*(x.numpy() for x in got.stat_after_data))
    for b in range(buf.shape[0]):
        for f in range(12):
            assert tuple(TR.stat_from_planes(tn, b, f)) == tuple(
                JR.stat_from_planes(jn, b, f))


def test_truncated_stat_not_misparsed():
    w = JuteWriter()
    jrecords.write_response(w, {'xid': 1, 'zxid': 5, 'err': 'OK',
                                'opcode': 'EXISTS',
                                'stat': _rand_stat(random.Random(0))})
    body = w.to_bytes()[:16 + 10]           # truncate mid-Stat
    buf, lens = _one_frame_batch(body, 256)
    jb, jst, tb, tst = _steps(buf, lens, 4)
    got = TR.parse_reply_bodies(tb, tst.starts, tst.sizes)
    _same(JR.parse_reply_bodies(jb, jst.starts, jst.sizes), got)
    assert int(tst.n_frames[0]) == 1
    assert not bool(got.stat0.valid[0, 0])


def test_variable_fields_clamped_to_frame():
    body = struct.pack('>iqi', -1, -1, 0)
    body += struct.pack('>ii', int(NotificationType.CREATED),
                        int(KeeperState.SYNC_CONNECTED))
    body += struct.pack('>i', 1000) + b'xy'
    buf, lens = _one_frame_batch(body, 128)
    jb, jst, tb, tst = _steps(buf, lens, 4)
    got = TR.parse_reply_bodies(tb, tst.starts, tst.sizes)
    _same(JR.parse_reply_bodies(jb, jst.starts, jst.sizes), got)
    assert int(got.npath_len[0, 0]) == 0
    assert not bool(got.npath_mask[0, 0].any())


@pytest.mark.parametrize('seed', [11, 12, 13])
def test_list_bodies_match_jax(seed):
    buf, lens = _list_batch(seed)
    jb, jst, tb, tst = _steps(buf, lens, 6)
    want = JR.parse_list_bodies(jb, jst.starts, jst.sizes, **_LIST_KW)
    got = TR.parse_list_bodies(tb, tst.starts, tst.sizes, **_LIST_KW)
    _same(want, got)
    # the random lists hit both sides of the fallback boundary
    assert got.ch_ok.any() and got.acl_ok.any()
    assert not bool(got.ch_ok.all() & got.acl_ok.all())


def _children_body(*elems, stat=True):
    body = struct.pack('>iqi', 5, 9, 0) + struct.pack('>i', len(elems))
    for e in elems:
        body += e
    return body + (b'\x00' * 68 if stat else b'')


@pytest.mark.parametrize('case', ['truncated', 'negative_len'])
def test_list_edge_cases_match_jax(case):
    P = struct.Struct('>i').pack
    if case == 'truncated':
        # count=2, first element fine, second element length 1000
        body = _children_body(P(3) + b'abc', P(1000) + b'xy', stat=False)
    else:
        # a negative element length decodes as an empty string
        body = _children_body(P(3) + b'abc', P(-109215916), P(0))
    buf, lens = _one_frame_batch(body, 128)
    jb, jst, tb, tst = _steps(buf, lens, 2)
    kw = dict(max_children=4, max_name=8)
    got = TR.parse_list_bodies(tb, tst.starts, tst.sizes, **kw)
    _same(JR.parse_list_bodies(jb, jst.starts, jst.sizes, **kw), got)
    if case == 'truncated':
        assert not bool(got.ch_ok[0, 0])
    else:
        assert bool(got.ch_ok[0, 0]) and int(got.ch_count[0, 0]) == 3
        assert got.ch_len[0, 0, :3].tolist() == [3, 0, 0]


def test_ustring_extent_cannot_wrap_on_huge_lengths():
    body = struct.pack('>iqi', 5, 9, 0)
    body += struct.pack('>i', 0x7FFFFFF4) + b'xy' + b'\x00' * 70
    buf, lens = _one_frame_batch(body, 256)
    jb, jst, tb, tst = _steps(buf, lens, 2)
    got = TR.parse_reply_bodies(tb, tst.starts, tst.sizes, max_data=16,
                                max_path=8)
    _same(JR.parse_reply_bodies(jb, jst.starts, jst.sizes, max_data=16,
                                max_path=8), got)
    assert not bool(got.data_ok[0, 0])
    assert not bool(got.stat_after_data.valid[0, 0])
    assert int(got.data_len[0, 0]) == 0 and not got.data[0, 0].any()


def test_field_helpers_match_jax():
    """parse_stats, slice_var_bytes and _ustring_at at random offsets,
    including negative ones and ones past the row end."""
    rng = np.random.RandomState(9)
    B, F, L = 6, 10, 200
    buf = rng.randint(0, 256, (B, L)).astype(np.uint8)
    buf[:, ::7] = 0                        # some small lengths
    off = rng.randint(-8, L + 8, (B, F)).astype(np.int32)
    lens = rng.randint(-3, 40, (B, F)).astype(np.int32)
    valid = rng.rand(B, F) < 0.7
    end = np.minimum(off + rng.randint(0, 90, (B, F)), L).astype(np.int32)
    jb, tb = jnp.asarray(buf), torch.from_numpy(buf)
    jo, to = jnp.asarray(off), torch.from_numpy(off)
    jv, tv = jnp.asarray(valid), torch.from_numpy(valid)
    _same(JR.parse_stats(jb, jo, jv), TR.parse_stats(tb, to, tv))
    for want, got in zip(
            JR.slice_var_bytes(jb, jo, jnp.asarray(lens), 24),
            TR.slice_var_bytes(tb, to, torch.from_numpy(lens), 24)):
        _same(want, got)
    je, te = jnp.asarray(end), torch.from_numpy(end)
    for want, got in zip(JR._ustring_at(jb, jo, jv, je, 16),
                         TR._ustring_at(tb, to, tv, te, 16)):
        _same(want, got)
