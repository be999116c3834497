"""Property-based fuzzing of the port's protocol stack (hypothesis): the
port of tests/test_fuzz.py.

Unstructured randomness at the port's decoders, each outcome held to the
JAX package's on the same bytes: arbitrary junk produces the same
packets or the same ``ZKProtocolError`` (class name and code) in both
packages, and the port's native and Python frame scanners and codecs
stay byte-for-byte equivalent under any input and chunking.  The two
junk-contract cases hold the port's raise to the reference's raise and
do not repeat the two code assertions the reference itself fails (a
declared length over the cap raises ``FRAME_TOO_LARGE``, which those
assertions do not list).  The two tensor cases run the port's ``ops`` on
the CPU against the scalar codec and against the JAX package's ops on
the same bytes."""

import struct

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from test_torch_replies import _same
from zkstream_tpu.protocol import framing as ref_framing
from zkstream_tpu.protocol import jute as ref_jute
from zkstream_tpu_torch.protocol.errors import ZKProtocolError
from zkstream_tpu_torch.protocol.framing import FrameDecoder, PacketCodec
from zkstream_tpu_torch.protocol.jute import JuteReader, JuteWriter
from zkstream_tpu_torch.protocol.records import Stat
from zkstream_tpu_torch.utils import native


def plain(x):
    """Decoded packets with ACL/Id records as plain tuples: the two
    packages' record classes are distinct types with equal fields."""
    if hasattr(x, 'perms') and hasattr(x, 'id'):
        return ('ACL', int(x.perms), x.id.scheme, x.id.id)
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [plain(v) for v in x]
    return x


def outcome(codec, junk: bytes) -> tuple:
    """What ``codec.decode(junk)`` gives: its packets, or the error's
    class name, code and the packets it carries."""
    try:
        return ('ok', plain(codec.decode(junk)))
    except Exception as e:
        return ('err', type(e).__name__, getattr(e, 'code', None),
                plain(getattr(e, 'packets', [])))


def steady(cls, xids=(), **kw):
    c = cls(use_native=False, **kw)
    c.handshaking = False
    for x in xids:
        c.xid_map[x] = 'GET_DATA'
    return c


@settings(max_examples=120, deadline=None)
@given(st.binary(max_size=400),
       st.lists(st.integers(1, 64), max_size=8))
def test_codec_decode_junk_contract(junk, xids):
    """Arbitrary bytes into the steady-state codec: packets out or a
    ZKProtocolError, the same as the reference codec's on the same
    junk."""
    got = outcome(steady(PacketCodec, xids), junk)
    assert got == outcome(steady(ref_framing.PacketCodec, xids), junk)
    if got[0] == 'err':
        assert got[1] in ('ZKProtocolError', 'ZKFrameTooLargeError')
        assert isinstance(got[3], list)
    else:
        assert isinstance(got[1], list)


@settings(max_examples=120, deadline=None)
@given(st.binary(max_size=400))
def test_handshake_decode_junk_contract(junk):
    got = outcome(PacketCodec(use_native=False), junk)
    assert got == outcome(ref_framing.PacketCodec(use_native=False), junk)
    if got[0] == 'err':
        assert got[1] in ('ZKProtocolError', 'ZKFrameTooLargeError')


def _feed(dec, chunk) -> tuple:
    try:
        return dec.feed(chunk), None
    except ZKProtocolError as e:
        return None, e.code


@settings(max_examples=100, deadline=None)
@given(st.binary(max_size=600), st.data())
def test_native_and_python_scanners_agree(blob, data):
    """Same bytes, arbitrary chunk boundaries: identical frames,
    identical error behavior, identical residual buffering — the port's
    C scanner, its Python scanner and the reference's Python scanner."""
    if native.ensure_lib() is None:  # pragma: no cover - no compiler
        pytest.skip('native codec unavailable')
    py = FrameDecoder(use_native=False)
    nat = FrameDecoder(use_native=True)
    ref = ref_framing.FrameDecoder(use_native=False)
    pos = 0
    while pos < len(blob):
        take = data.draw(st.integers(1, len(blob) - pos))
        chunk = blob[pos:pos + take]
        pos += take
        py_out = _feed(py, chunk)
        try:
            ref_out = ref.feed(chunk), None
        except Exception as e:
            ref_out = None, e.code
        assert py_out == _feed(nat, chunk) == ref_out
        assert py.pending() == nat.pending() == ref.pending()
        if py_out[1] is not None:
            return


def _agree(codecs, junk, data, xid_maps=True):
    """Feed ``junk`` in arbitrary chunks to every codec of ``codecs``:
    the same outcome, residue and (``xid_maps``) xid-map consumption
    from each."""
    pos = 0
    while pos < len(junk):
        take = data.draw(st.integers(1, len(junk) - pos))
        chunk = junk[pos:pos + take]
        pos += take
        outcomes = [outcome(c, chunk) for c in codecs]
        assert all(o == outcomes[0] for o in outcomes)
        pend = [c._decoder.pending() for c in codecs]
        assert all(p == pend[0] for p in pend)
        if xid_maps:
            assert all(c.xid_map == codecs[0].xid_map for c in codecs)
        if outcomes[0][0] == 'err':
            return


@settings(max_examples=120, deadline=None)
@given(st.binary(max_size=500),
       st.lists(st.integers(1, 64), unique=True, max_size=8),
       st.data())
def test_ext_and_python_codecs_agree(junk, xids, data):
    """Arbitrary bytes, arbitrary chunking: the port's C-extension decode
    path, its pure-Python codec and the reference's Python codec produce
    identical packets, identical errors (code + attached packets),
    identical residue, and identical xid-map consumption."""
    if native.ensure_ext() is None:  # pragma: no cover - no compiler
        pytest.skip('native extension unavailable')
    codecs = [PacketCodec(use_native=False), PacketCodec(use_native=True),
              ref_framing.PacketCodec(use_native=False)]
    for c in codecs:
        c.handshaking = False
        c.xid_map = {x: 'GET_DATA' for x in xids}
    _agree(codecs, junk, data)


@settings(max_examples=120, deadline=None)
@given(st.binary(max_size=500), st.data())
def test_server_ext_and_python_codecs_agree(junk, data):
    """Server direction (request decode): same A/B contract as the
    client direction, over arbitrary junk and chunking."""
    if native.ensure_ext() is None:  # pragma: no cover - no compiler
        pytest.skip('native extension unavailable')
    codecs = [steady(PacketCodec, server=True),
              PacketCodec(server=True, use_native=True),
              steady(ref_framing.PacketCodec, server=True)]
    codecs[1].handshaking = False
    _agree(codecs, junk, data, xid_maps=False)


@settings(max_examples=200, deadline=None)
@given(st.integers(-2**31, 2**31 - 1), st.integers(-2**63, 2**63 - 1),
       st.binary(max_size=64), st.text(max_size=32),
       st.booleans(), st.integers(-128, 127))
def test_jute_roundtrip_property(i32, i64, buf, text, flag, byte):
    w, rw = JuteWriter(), ref_jute.JuteWriter()
    for x in (w, rw):
        x.write_int(i32)
        x.write_long(i64)
        x.write_buffer(buf)
        x.write_ustring(text)
        x.write_bool(flag)
        x.write_byte(byte)
    assert w.to_bytes() == rw.to_bytes()
    r = JuteReader(w.to_bytes())
    assert r.read_int() == i32
    assert r.read_long() == i64
    assert r.read_buffer() == buf
    assert r.read_ustring() == text
    assert r.read_bool() == flag
    assert r.read_byte() == byte
    assert r.at_end()


def _batch(rows, L):
    buf = np.zeros((len(rows), L), np.uint8)
    lens = np.zeros((len(rows),), np.int32)
    for i, r in enumerate(rows):
        buf[i, :len(r)] = np.frombuffer(r, np.uint8)
        lens[i] = len(r)
    return buf, lens


_SCAN_REF = None  # one JAX compile serves every fuzz example


@settings(max_examples=40, deadline=None)
@given(st.lists(st.binary(max_size=120), min_size=1, max_size=6))
def test_tensor_scan_agrees_with_scalar_on_junk(rows):
    """Random per-stream junk: the port's batched cursor scan (on the
    CPU) and the scalar decoder agree on frame counts, bad flags, and
    residuals, and the scan equals the JAX package's on the same batch
    (padded to six rows of 128 bytes, so one JAX compile serves every
    example)."""
    from zkstream_tpu_torch.ops import frame_cursor_scan

    global _SCAN_REF
    if _SCAN_REF is None:
        import functools

        import jax

        from zkstream_tpu.ops import frame_cursor_scan as ref_scan
        _SCAN_REF = jax.jit(functools.partial(ref_scan, max_frames=32))
    buf, lens = _batch(rows + [b''] * (6 - len(rows)), 128)
    got = frame_cursor_scan(torch.from_numpy(buf), torch.from_numpy(lens),
                            max_frames=32)
    for g, w in zip(got, _SCAN_REF(buf, lens)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    starts, sizes, counts, bad, resid = got
    for i, r in enumerate(rows):
        dec = FrameDecoder(use_native=False)
        try:
            frames = dec.feed(r)
            assert not bool(bad[i])
            assert int(counts[i]) == len(frames)
            assert int(resid[i]) == len(r) - dec.pending()
        except ZKProtocolError:
            assert bool(bad[i])


def test_jute_byte_accepts_unsigned_reads_signed():
    """Jute bytes are signed (Java convention, like the reference's
    Buffer readInt8); the writer also tolerates the unsigned spelling
    and normalizes the bit pattern."""
    w, rw = JuteWriter(), ref_jute.JuteWriter()
    w.write_byte(200)
    rw.write_byte(200)
    assert w.to_bytes() == rw.to_bytes()
    assert JuteReader(w.to_bytes()).read_byte() == 200 - 256


def test_fuzz_seed_corpus_regression():
    """Known tricky shapes stay fixed: empty, lone prefix, prefix
    crossing chunk boundary, max-length frame, zero-length frames."""
    for cls in (FrameDecoder, ref_framing.FrameDecoder):
        d = cls(use_native=False)
        assert d.feed(b'') == []
        assert d.feed(b'\x00\x00\x00') == []
        assert d.feed(b'\x05') == []  # len=5 now complete across chunks
        assert d.feed(b'abcde') == [b'abcde']
        assert d.feed(struct.pack('>i', 0) * 3) == [b'', b'', b'']
        assert d.pending() == 0


_LIST_FUZZ_REF = None  # one JAX compile serves every fuzz example


@settings(max_examples=40, deadline=None)
@given(st.data())
def test_list_bodies_device_matches_scalar(data):
    """Hypothesis property: the port's parse_list_bodies (on the CPU)
    over a random fleet of children/ACL replies (random counts and
    element widths, sometimes past the static bounds) agrees with the
    scalar read_response wherever its ok flag is set, the ok flag
    equals the static-bounds predicate, and every plane equals the JAX
    package's parse of the same batch.  Empty elements exercise the
    negative-length wire form (the jute '' -> -1 convention,
    lib/jute-buffer.js:127-130)."""
    from zkstream_tpu_torch.ops.pipeline import wire_pipeline_step
    from zkstream_tpu_torch.ops.replies import parse_list_bodies
    from zkstream_tpu_torch.protocol.consts import Perm
    from zkstream_tpu_torch.protocol.records import ACL, Id, write_response

    K, S, A, SS, SI = 4, 12, 2, 8, 10
    n_streams, F, L = 3, 3, 1024   # L >= worst-case 3x212B frames
    pkts, streams = [], []
    for b in range(n_streams):
        raw, row = b'', []
        for f in range(F):
            kind = data.draw(st.sampled_from(
                ('GET_CHILDREN', 'GET_CHILDREN2', 'GET_ACL')))
            pkt = {'xid': f + 1, 'zxid': data.draw(
                st.integers(0, 2**40)), 'err': 'OK', 'opcode': kind}
            if kind == 'GET_ACL':
                pkt['acl'] = [
                    ACL(Perm(data.draw(st.integers(1, 31))),
                        Id(data.draw(st.text(
                            alphabet='ab', max_size=SS + 3)),
                           data.draw(st.text(
                               alphabet='cd', max_size=SI + 3))))
                    for _ in range(data.draw(st.integers(0, A + 1)))]
                pkt['stat'] = Stat()
            else:
                pkt['children'] = [
                    data.draw(st.text(alphabet='xy', max_size=S + 4))
                    for _ in range(data.draw(st.integers(0, K + 2)))]
                if kind == 'GET_CHILDREN2':
                    pkt['stat'] = Stat()
            w = JuteWriter()
            write_response(w, pkt)
            body = w.to_bytes()
            raw += struct.pack('>i', len(body)) + body
            row.append(pkt)
        streams.append(raw)
        pkts.append(row)
    assert max(len(s) for s in streams) <= L
    buf, lens = _batch(streams, L)

    tb, tl = torch.from_numpy(buf), torch.from_numpy(lens)
    stt = wire_pipeline_step(tb, tl, max_frames=F)
    lb = parse_list_bodies(tb, stt.starts, stt.sizes, max_children=K,
                           max_name=S, max_acls=A, max_scheme=SS,
                           max_id=SI)

    global _LIST_FUZZ_REF
    if _LIST_FUZZ_REF is None:
        import jax

        from zkstream_tpu.ops.pipeline import wire_pipeline_step as jstep
        from zkstream_tpu.ops.replies import parse_list_bodies as jparse

        def _step(b, l):
            s = jstep(b, l, max_frames=F)
            return jparse(b, s.starts, s.sizes, max_children=K, max_name=S,
                          max_acls=A, max_scheme=SS, max_id=SI)
        _LIST_FUZZ_REF = jax.jit(_step)
    _same(_LIST_FUZZ_REF(buf, lens), lb)

    lb = type(lb)(*(x.numpy() if isinstance(x, torch.Tensor) else x
                    for x in lb))
    for i in range(n_streams):
        for f in range(F):
            pkt = pkts[i][f]
            if pkt['opcode'] == 'GET_ACL':
                fits = (len(pkt['acl']) <= A and all(
                    len(a.id.scheme.encode()) <= SS
                    and len(a.id.id.encode()) <= SI
                    for a in pkt['acl']))
                assert bool(lb.acl_ok[i, f]) == fits, (i, f, pkt)
                if not fits:
                    continue
                cnt = int(lb.acl_count[i, f])
                assert cnt == len(pkt['acl'])
                for k in range(cnt):
                    want = pkt['acl'][k]
                    assert int(lb.acl_perms[i, f, k]) == int(want.perms)
                    sl = int(lb.acl_scheme_len[i, f, k])
                    il = int(lb.acl_id_len[i, f, k])
                    assert 0 <= sl <= SS and 0 <= il <= SI
                    assert bytes(lb.acl_scheme[i, f, k, :sl]).decode() \
                        == want.id.scheme
                    assert bytes(lb.acl_id[i, f, k, :il]).decode() \
                        == want.id.id
            else:
                fits = (len(pkt['children']) <= K and all(
                    len(c.encode()) <= S for c in pkt['children']))
                assert bool(lb.ch_ok[i, f]) == fits, (i, f, pkt)
                if not fits:
                    continue
                cnt = int(lb.ch_count[i, f])
                assert cnt == len(pkt['children'])
                for k in range(cnt):
                    n = int(lb.ch_len[i, f, k])
                    assert 0 <= n <= S
                    assert bytes(lb.ch_bytes[i, f, k, :n]).decode() \
                        == pkt['children'][k]
