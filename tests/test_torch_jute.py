"""Jute primitive codec tests of the port: round-trips, wire quirks,
bounds checks (reference behavior: lib/jute-buffer.js).  The port of
tests/test_jute.py; every case that encodes also holds the port's bytes
to the JAX package's ``JuteWriter``'s on the same values, and every
raise to the same error class name."""

import random

import pytest

from zkstream_tpu.protocol import jute as ref
from zkstream_tpu_torch.protocol.jute import (
    JuteReader,
    JuteTruncatedError,
    JuteValueError,
    JuteWriter,
)


def same_bytes(write_fn) -> bytes:
    """``write_fn`` applied to a port and a reference writer: the
    port's bytes, asserted equal to the reference's."""
    w, rw = JuteWriter(), ref.JuteWriter()
    write_fn(w)
    write_fn(rw)
    assert w.to_bytes() == rw.to_bytes()
    return w.to_bytes()


def same_raise(port_fn, ref_fn, cls):
    """``port_fn`` raises ``cls`` and ``ref_fn`` its reference twin."""
    with pytest.raises(cls):
        port_fn()
    with pytest.raises(getattr(ref, cls.__name__)):
        ref_fn()


def test_int_wire_format():
    assert same_bytes(lambda w: w.write_int(0x01020304)) == \
        b'\x01\x02\x03\x04'
    assert same_bytes(lambda w: w.write_int(-1)) == b'\xff\xff\xff\xff'


def test_long_wire_format():
    assert same_bytes(lambda w: w.write_long(0x0102030405060708)) == \
        b'\x01\x02\x03\x04\x05\x06\x07\x08'
    assert same_bytes(lambda w: w.write_long(-2)) == b'\xff' * 7 + b'\xfe'


def test_int_range_checks():
    same_raise(lambda: JuteWriter().write_int(1 << 31),
               lambda: ref.JuteWriter().write_int(1 << 31), JuteValueError)
    same_raise(lambda: JuteWriter().write_long(1 << 63),
               lambda: ref.JuteWriter().write_long(1 << 63),
               JuteValueError)


def test_bool_roundtrip_and_validation():
    data = same_bytes(lambda w: (w.write_bool(True), w.write_bool(False)))
    r = JuteReader(data)
    assert r.read_bool() is True
    assert r.read_bool() is False
    same_raise(lambda: JuteReader(b'\x02').read_bool(),
               lambda: ref.JuteReader(b'\x02').read_bool(), JuteValueError)


def test_byte_signed_roundtrip():
    vals = (-128, -1, 0, 1, 127)
    data = same_bytes(lambda w: [w.write_byte(v) for v in vals])
    r = JuteReader(data)
    assert [r.read_byte() for _ in range(5)] == list(vals)


def test_empty_buffer_encodes_as_minus_one():
    # Reference quirk: empty buffer -> length -1 on the wire
    # (lib/jute-buffer.js:127-130).
    assert same_bytes(lambda w: w.write_buffer(b'')) == b'\xff\xff\xff\xff'


def test_negative_length_reads_as_empty():
    # Reference quirk: negative length decodes to the empty buffer
    # (lib/jute-buffer.js:99-100).
    r = JuteReader(b'\xff\xff\xff\xff')
    assert r.read_buffer() == b''
    assert ref.JuteReader(b'\xff\xff\xff\xff').read_buffer() == b''


def test_buffer_roundtrip():
    payload = bytes(range(256))
    r = JuteReader(same_bytes(lambda w: w.write_buffer(payload)))
    assert r.read_buffer() == payload
    assert r.at_end()


def test_ustring_roundtrip_unicode():
    s = 'héllo /ζookeeper ✓'
    r = JuteReader(same_bytes(lambda w: w.write_ustring(s)))
    assert r.read_ustring() == s


def test_truncated_reads_raise():
    for data, read in ((b'\x00\x00', 'read_int'),
                       (b'\x00\x00\x00\x00', 'read_long'),
                       # declared length beyond the available bytes
                       (b'\x00\x00\x00\x09abc', 'read_buffer')):
        same_raise(getattr(JuteReader(data), read),
                   getattr(ref.JuteReader(data), read), JuteTruncatedError)


def test_length_prefixed_scopes():
    def inner(sub):
        sub.write_int(7)
        sub.write_ustring('abc')

    data = same_bytes(lambda w: w.write_length_prefixed(inner))
    # 4 (int) + 4+3 (string) = 11 bytes inside the scope.
    assert data[:4] == b'\x00\x00\x00\x0b'

    r = JuteReader(data)

    def read_inner(sub):
        assert sub.read_int() == 7
        assert sub.read_ustring() == 'abc'
        return 'done'

    assert r.read_length_prefixed(read_inner) == 'done'
    assert r.at_end()


def test_length_prefixed_scope_skips_unconsumed_bytes():
    def inner(sub):
        sub.write_int(1)
        sub.write_int(2)

    data = same_bytes(lambda w: (w.write_length_prefixed(inner),
                                 w.write_int(99)))
    r = JuteReader(data)
    # Consume only part of the scope; the reader must still land after it.
    r.read_length_prefixed(lambda sub: sub.read_int())
    assert r.read_int() == 99


def test_property_roundtrip_fuzz():
    rng = random.Random(1303)
    for _ in range(200):
        ints = [rng.randint(-(1 << 31), (1 << 31) - 1) for _ in range(3)]
        longs = [rng.randint(-(1 << 63), (1 << 63) - 1) for _ in range(3)]
        bufs = [rng.randbytes(rng.randint(0, 64)) for _ in range(2)]
        strs = [''.join(chr(rng.randint(32, 0x2FF))
                        for _ in range(rng.randint(0, 16)))
                for _ in range(2)]
        bools = [rng.random() < 0.5 for _ in range(2)]

        def write(w):
            for v in ints:
                w.write_int(v)
            for v in longs:
                w.write_long(v)
            for v in bufs:
                w.write_buffer(v)
            for v in strs:
                w.write_ustring(v)
            for v in bools:
                w.write_bool(v)

        r = JuteReader(same_bytes(write))
        assert [r.read_int() for _ in range(3)] == ints
        assert [r.read_long() for _ in range(3)] == longs
        assert [r.read_buffer() for _ in range(2)] == bufs
        assert [r.read_ustring() for _ in range(2)] == strs
        assert [r.read_bool() for _ in range(2)] == bools
        assert r.at_end()
