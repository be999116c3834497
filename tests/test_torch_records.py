"""Message-codec tests of the port, gated on the golden packet capture:
the port of tests/test_records.py.

The capture is real wire data from a ``zkCli ls /`` exchange, taken from
the reference's conformance fixture (reference: test/streams.test.js:21-56
— data fixture, not code).  Byte-exact decode of it is the codec gate
called out in SURVEY.md section 7 step 3.  Every case that encodes also
holds the port's bytes to the JAX package's ``records`` on the same
packet, and every decode to the JAX package's decode of the same bytes.
"""

import base64

import pytest

from zkstream_tpu.protocol import jute as ref_jute
from zkstream_tpu.protocol import records as ref
from zkstream_tpu_torch.protocol import records
from zkstream_tpu_torch.protocol.consts import CreateFlag, Perm
from zkstream_tpu_torch.protocol.jute import JuteReader, JuteWriter
from zkstream_tpu_torch.protocol.records import (
    ACL,
    OPEN_ACL_UNSAFE,
    Id,
    Stat,
    read_acl,
    read_request,
    read_response,
    read_stat,
    write_acl,
    write_request,
    write_response,
    write_stat,
)

# Real packet capture of "zkCli ls /" (fixture data from the reference's
# test/streams.test.js:21-27; each entry is one length-prefixed frame).
CAPTURE1 = [
    ('send', 'AAAALQAAAAAAAAAAAAAAAAAAdTAAAAAAAAAAAAAAABAAAAAAAAAAAAAAAAAA'
             'AAAAAA=='),
    ('recv', 'AAAAJQAAAAAAAHUwAVWjqFbbAAAAAAAQh19uvwgo25o9B6hUkSvqKQA='),
    ('send', 'AAAADgAAAAEAAAAIAAAAAS8A'),
    ('recv', 'AAAAKAAAAAEAAAAAAAAFFwAAAAAAAAACAAAACXpvb2tlZXBlcgAAAANmb28='),
]

EXPECTED1 = [
    {
        'protocolVersion': 0,
        'lastZxidSeen': 0,
        'timeOut': 30000,
        'sessionId': 0,
        'passwd': b'\x00' * 16,
    },
    {
        'protocolVersion': 0,
        'timeOut': 30000,
        'sessionId': int.from_bytes(base64.b64decode('AVWjqFbbAAA='), 'big',
                                    signed=True),
        'passwd': base64.b64decode('h19uvwgo25o9B6hUkSvqKQ=='),
    },
    {
        'xid': 1,
        'opcode': 'GET_CHILDREN',
        'path': '/',
        'watch': False,
    },
    {
        'xid': 1,
        'opcode': 'GET_CHILDREN',
        'err': 'OK',
        'zxid': 0x517,
        'children': ['zookeeper', 'foo'],
    },
]


def plain(x):
    """A decoded value with ACL and Id records as plain tuples: the two
    packages' record classes are distinct types with equal fields."""
    if hasattr(x, 'perms') and hasattr(x, 'id'):
        return ('ACL', int(x.perms), x.id.scheme, x.id.id)
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [plain(v) for v in x]
    return x


def ref_acl(acl: list) -> list:
    """``acl`` as the JAX package's records."""
    return [ref.ACL(a.perms, ref.Id(a.id.scheme, a.id.id)) for a in acl]


def ref_bytes(write: str, *args) -> bytes:
    """What the JAX package's ``records.<write>`` encodes for ``args``."""
    w = ref_jute.JuteWriter()
    getattr(ref, write)(w, *args)
    return w.to_bytes()


def ref_read(read: str, data: bytes, *args):
    """What the JAX package's ``records.<read>`` decodes from ``data``."""
    return getattr(ref, read)(ref_jute.JuteReader(data), *args)


def _frames():
    out = []
    for direction, b64 in CAPTURE1:
        raw = base64.b64decode(b64)
        ln = int.from_bytes(raw[:4], 'big', signed=True)
        assert ln == len(raw) - 4, 'capture frame length mismatch'
        out.append((direction, raw[4:]))
    return out


def test_decode_golden_capture():
    frames = _frames()
    xid_map: dict[int, str] = {}

    r = JuteReader(frames[0][1])
    pkt = records.read_connect_request(r)
    # Modern servers append a trailing readOnly bool the reference also
    # ignores (its fixture frame is 45 bytes, its decoder reads 44).
    assert pkt == EXPECTED1[0]
    assert pkt == ref_read('read_connect_request', frames[0][1])

    r = JuteReader(frames[1][1])
    pkt = records.read_connect_response(r)
    assert pkt == EXPECTED1[1]
    assert pkt == ref_read('read_connect_response', frames[1][1])

    r = JuteReader(frames[2][1])
    pkt = read_request(r)
    assert pkt == EXPECTED1[2]
    assert pkt == ref_read('read_request', frames[2][1])
    xid_map[pkt['xid']] = pkt['opcode']

    r = JuteReader(frames[3][1])
    pkt = read_response(r, dict(xid_map))
    assert pkt == EXPECTED1[3]
    assert pkt == ref_read('read_response', frames[3][1], xid_map)


def test_reencode_golden_request_byte_exact():
    frames = _frames()
    w = JuteWriter()
    write_request(w, EXPECTED1[2])
    assert w.to_bytes() == frames[2][1]
    assert w.to_bytes() == ref_bytes('write_request', EXPECTED1[2])


def test_reencode_golden_connect_frames():
    # The captured connect frames carry a trailing readOnly bool (newer
    # protocol revision); our encode, like the reference's, writes the
    # classic 44/36-byte forms — equal up to that final byte.
    frames = _frames()
    w = JuteWriter()
    records.write_connect_request(w, EXPECTED1[0])
    assert w.to_bytes() == frames[0][1][:-1]
    assert w.to_bytes() == ref_bytes('write_connect_request', EXPECTED1[0])
    w = JuteWriter()
    records.write_connect_response(w, EXPECTED1[1])
    assert w.to_bytes() == frames[1][1][:-1]
    assert w.to_bytes() == ref_bytes('write_connect_response',
                                     EXPECTED1[1])


def test_reencode_golden_response_byte_exact():
    frames = _frames()
    w = JuteWriter()
    write_response(w, EXPECTED1[3])
    assert w.to_bytes() == frames[3][1]
    assert w.to_bytes() == ref_bytes('write_response', EXPECTED1[3])


def test_stat_roundtrip():
    s = Stat(czxid=1, mzxid=2, ctime=1467673239251, mtime=1467673239252,
             version=3, cversion=4, aversion=5,
             ephemeralOwner=0x0155a3a856db0000, dataLength=9000,
             numChildren=2, pzxid=7)
    w = JuteWriter()
    write_stat(w, s)
    assert len(w.to_bytes()) == 68  # 5 longs, 5 ints, 1 long
    assert w.to_bytes() == ref_bytes('write_stat', ref.Stat(*s))
    assert read_stat(JuteReader(w.to_bytes())) == s
    assert ref_read('read_stat', w.to_bytes()) == s


def test_acl_roundtrip():
    acl = [ACL(Perm.READ | Perm.WRITE, Id('digest', 'u:hash')),
           ACL(Perm.ALL, Id('world', 'anyone'))]
    w = JuteWriter()
    write_acl(w, acl)
    assert w.to_bytes() == ref_bytes('write_acl', ref_acl(acl))
    assert read_acl(JuteReader(w.to_bytes())) == acl
    assert plain(ref_read('read_acl', w.to_bytes())) == plain(acl)


@pytest.mark.parametrize('pkt', [
    {'xid': 5, 'opcode': 'GET_DATA', 'path': '/a', 'watch': True},
    {'xid': 6, 'opcode': 'EXISTS', 'path': '/a/b', 'watch': False},
    {'xid': 7, 'opcode': 'GET_CHILDREN2', 'path': '/', 'watch': True},
    {'xid': 8, 'opcode': 'DELETE', 'path': '/a', 'version': 3},
    {'xid': 9, 'opcode': 'GET_ACL', 'path': '/a'},
    {'xid': 10, 'opcode': 'SET_DATA', 'path': '/a', 'data': b'xyz',
     'version': -1},
    {'xid': 11, 'opcode': 'SYNC', 'path': '/'},
    {'xid': 12, 'opcode': 'PING'},
    {'xid': 13, 'opcode': 'CLOSE_SESSION'},
    {'xid': 14, 'opcode': 'CREATE', 'path': '/a', 'data': b'd',
     'acl': list(OPEN_ACL_UNSAFE),
     'flags': CreateFlag.EPHEMERAL | CreateFlag.SEQUENTIAL},
    {'xid': 15, 'opcode': 'SET_WATCHES', 'relZxid': 1303, 'events': {
        'dataChanged': ['/a', '/b'],
        'createdOrDestroyed': ['/c'],
        'childrenChanged': [],
    }},
])
def test_request_roundtrip(pkt):
    w = JuteWriter()
    write_request(w, pkt)
    assert w.to_bytes() == ref_bytes(
        'write_request', dict(pkt, acl=ref_acl(pkt['acl'])) if 'acl' in pkt
        else pkt)
    r = JuteReader(w.to_bytes())
    got = read_request(r)
    assert r.at_end()
    assert plain(got) == plain(ref_read('read_request', w.to_bytes()))
    for k, v in pkt.items():
        if k in ('flags',):
            assert got[k] == CreateFlag(v)
        elif k == 'events':
            assert {kk: list(vv) for kk, vv in got[k].items()} == v
        else:
            assert got[k] == v


@pytest.mark.parametrize('pkt', [
    {'xid': 1, 'zxid': 10, 'err': 'OK', 'opcode': 'CREATE', 'path': '/a'},
    {'xid': 2, 'zxid': 11, 'err': 'OK', 'opcode': 'GET_DATA',
     'data': b'hello', 'stat': Stat(mzxid=11)},
    {'xid': 3, 'zxid': 12, 'err': 'OK', 'opcode': 'EXISTS',
     'stat': Stat(czxid=5)},
    {'xid': 4, 'zxid': 13, 'err': 'OK', 'opcode': 'SET_DATA',
     'stat': Stat(version=9)},
    {'xid': 5, 'zxid': 14, 'err': 'OK', 'opcode': 'GET_CHILDREN2',
     'children': ['a', 'b'], 'stat': Stat(numChildren=2)},
    {'xid': 6, 'zxid': 15, 'err': 'OK', 'opcode': 'GET_ACL',
     'acl': list(OPEN_ACL_UNSAFE), 'stat': Stat()},
    {'xid': 7, 'zxid': 16, 'err': 'OK', 'opcode': 'DELETE'},
    {'xid': -2, 'zxid': 17, 'err': 'OK', 'opcode': 'PING'},
    {'xid': -1, 'zxid': 18, 'err': 'OK', 'opcode': 'NOTIFICATION',
     'type': 'DATA_CHANGED', 'state': 'SYNC_CONNECTED', 'path': '/a'},
    {'xid': 9, 'zxid': 19, 'err': 'NO_NODE', 'opcode': 'GET_DATA'},
])
def test_response_roundtrip(pkt):
    w = JuteWriter()
    write_response(w, pkt)
    assert w.to_bytes() == ref_bytes(
        'write_response', dict(pkt, acl=ref_acl(pkt['acl']))
        if 'acl' in pkt else pkt)
    r = JuteReader(w.to_bytes())
    got = read_response(r, {pkt['xid']: pkt['opcode']})
    assert r.at_end()
    assert plain(got) == plain(ref_read('read_response', w.to_bytes(),
                                        {pkt['xid']: pkt['opcode']}))
    for k, v in pkt.items():
        assert got[k] == v


def test_response_unknown_xid_raises():
    w = JuteWriter()
    write_response(w, {'xid': 42, 'zxid': 1, 'err': 'OK', 'opcode': 'PING'})
    with pytest.raises(ValueError, match='matches no request') as ei:
        read_response(JuteReader(w.to_bytes()), {})
    with pytest.raises(ValueError) as ri:
        ref_read('read_response', w.to_bytes(), {})
    assert str(ei.value) == str(ri.value)


def test_special_xid_overrides_xid_map():
    # A NOTIFICATION (xid -1) must decode even with an empty xid map
    # (reference: lib/zk-buffer.js:288-290).
    w = JuteWriter()
    write_response(w, {'xid': -1, 'zxid': 9, 'err': 'OK',
                       'opcode': 'NOTIFICATION', 'type': 'CREATED',
                       'state': 'SYNC_CONNECTED', 'path': '/x'})
    pkt = read_response(JuteReader(w.to_bytes()), {})
    assert pkt['opcode'] == 'NOTIFICATION'
    assert pkt['type'] == 'CREATED'
    assert pkt == ref_read('read_response', w.to_bytes(), {})


def test_error_reply_has_no_body():
    # Error replies end after the header; decoding must not try to read a
    # body (reference: lib/zk-buffer.js:292,329).
    w = JuteWriter()
    write_response(w, {'xid': 3, 'zxid': 2, 'err': 'NO_NODE',
                       'opcode': 'GET_DATA'})
    assert len(w.to_bytes()) == 16
    pkt = read_response(JuteReader(w.to_bytes()), {3: 'GET_DATA'})
    assert pkt['err'] == 'NO_NODE'
    assert 'data' not in pkt
    assert pkt == ref_read('read_response', w.to_bytes(), {3: 'GET_DATA'})
