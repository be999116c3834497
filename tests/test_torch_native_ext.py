"""A/B tests: the port's C-extension codec (``csrc/zkwire_ext.c``, module
``_zkwire_ext_torch``) against the port's pure-Python codec, which is
the semantic spec, and against the JAX package's ``_zkwire_ext``.

Every decode test drives three codecs over identical bytes — the port
with ``use_native=False``, the port with ``use_native=True`` and the
reference with ``use_native=True`` — and requires identical packets,
identical buffer state, identical xid maps and identical error codes
(the two C tiers also identical error messages), including the lossy
corners.  The packets of each package carry that package's own record
classes; they are compared through :func:`_canon`.  Mirrors
tests/test_native_ext.py.
"""

from __future__ import annotations

import enum
import os
import random
import struct

import pytest

from zkstream_tpu.protocol import records as RR
from zkstream_tpu.protocol.errors import ZKProtocolError as RefProtocolError
from zkstream_tpu.protocol.framing import PacketCodec as RefCodec
from zkstream_tpu.utils import native as ref_native
from zkstream_tpu_torch.protocol import records as TR
from zkstream_tpu_torch.protocol.consts import MAX_PACKET
from zkstream_tpu_torch.protocol.errors import ZKProtocolError
from zkstream_tpu_torch.protocol.framing import PacketCodec
from zkstream_tpu_torch.utils import native


@pytest.fixture(scope='module', autouse=True)
def _built():
    if native.ensure_ext() is None or ref_native.ensure_ext() is None:
        pytest.skip('no C compiler or Python headers: the extensions '
                    'cannot build')


#: the three codecs every decode test runs: (name, class, use_native)
TIERS = (('port_py', PacketCodec, False), ('port_c', PacketCodec, True),
         ('ref_c', RefCodec, True))


def all_replies(rec):
    """Every reply layout, with ``rec``'s record classes."""
    st = rec.Stat(1, 2, 3, 4, 5, 6, 7, 0, 3, 2, 8)
    return [
        {'xid': 1, 'zxid': 100, 'opcode': 'GET_DATA', 'err': 'OK',
         'data': b'abc', 'stat': st},
        {'xid': 2, 'zxid': 101, 'opcode': 'EXISTS', 'err': 'OK',
         'stat': st},
        {'xid': 3, 'zxid': 102, 'opcode': 'SET_DATA', 'err': 'OK',
         'stat': st},
        {'xid': 4, 'zxid': 103, 'opcode': 'CREATE', 'err': 'OK',
         'path': '/a/b'},
        {'xid': 5, 'zxid': 104, 'opcode': 'GET_CHILDREN2', 'err': 'OK',
         'children': ['x', 'y'], 'stat': st},
        {'xid': 6, 'zxid': 105, 'opcode': 'GET_CHILDREN', 'err': 'OK',
         'children': []},
        {'xid': 7, 'zxid': 106, 'opcode': 'GET_ACL', 'err': 'OK',
         'acl': list(rec.OPEN_ACL_UNSAFE), 'stat': st},
        {'xid': 8, 'zxid': 107, 'opcode': 'DELETE', 'err': 'OK'},
        {'xid': 9, 'zxid': 108, 'opcode': 'GET_DATA', 'err': 'NO_NODE'},
        {'xid': -1, 'zxid': 109, 'opcode': 'NOTIFICATION', 'err': 'OK',
         'type': 'DATA_CHANGED', 'state': 'SYNC_CONNECTED', 'path': '/a'},
        {'xid': -2, 'zxid': 110, 'opcode': 'PING', 'err': 'OK'},
        {'xid': 10, 'zxid': 111, 'opcode': 'SYNC', 'err': 'OK'},
        {'xid': 11, 'zxid': 112, 'opcode': 'SET_WATCHES', 'err': 'OK'},
        {'xid': 12, 'zxid': 113, 'opcode': 'MULTI', 'err': 'OK',
         'results': [{'op': 'create', 'path': '/m'},
                     {'op': 'set_data', 'stat': st},
                     {'op': 'delete'}, {'op': 'check'},
                     {'op': 'error', 'err': 'NO_NODE'}]},
        {'xid': 13, 'zxid': 114, 'opcode': 'ADD_WATCH', 'err': 'OK'},
        {'xid': 14, 'zxid': 115, 'opcode': 'SET_WATCHES2', 'err': 'OK'},
        {'xid': 15, 'zxid': 116, 'opcode': 'CLOSE_SESSION', 'err': 'OK'},
        {'xid': -4, 'zxid': 117, 'opcode': 'AUTH', 'err': 'OK'},
    ]


def all_requests(rec):
    """Every request layout, with ``rec``'s record classes."""
    return [
        {'xid': 1, 'opcode': 'GET_DATA', 'path': '/a', 'watch': True},
        {'xid': 2, 'opcode': 'EXISTS', 'path': '/b', 'watch': False},
        {'xid': 3, 'opcode': 'GET_CHILDREN2', 'path': '/', 'watch': False},
        {'xid': 4, 'opcode': 'GET_CHILDREN', 'path': '/c', 'watch': True},
        {'xid': 5, 'opcode': 'CREATE', 'path': '/n', 'data': b'xyz',
         'acl': list(rec.OPEN_ACL_UNSAFE), 'flags': 3},
        {'xid': 6, 'opcode': 'DELETE', 'path': '/n', 'version': -1},
        {'xid': 7, 'opcode': 'SET_DATA', 'path': '/a', 'data': b'',
         'version': 4},
        {'xid': 8, 'opcode': 'GET_ACL', 'path': '/a'},
        {'xid': 9, 'opcode': 'SYNC', 'path': '/'},
        {'xid': -8, 'opcode': 'SET_WATCHES', 'relZxid': 77, 'events': {
            'dataChanged': ['/a', '/b'], 'createdOrDestroyed': [],
            'childrenChanged': ['/c']}},
        {'xid': -2, 'opcode': 'PING'},
        {'xid': 10, 'opcode': 'CLOSE_SESSION'},
        {'xid': 11, 'opcode': 'MULTI', 'ops': [
            {'op': 'create', 'path': '/m', 'data': b'd',
             'acl': list(rec.OPEN_ACL_UNSAFE), 'flags': 0},
            {'op': 'set_data', 'path': '/m', 'data': b'e', 'version': 0},
            {'op': 'check', 'path': '/m', 'version': 1},
            {'op': 'delete', 'path': '/m', 'version': -1}]},
        {'xid': 12, 'opcode': 'ADD_WATCH', 'path': '/w', 'mode': 1},
        {'xid': 13, 'opcode': 'SET_WATCHES2', 'relZxid': 5, 'events': {
            'dataChanged': ['/a'], 'createdOrDestroyed': [],
            'childrenChanged': [], 'persistent': ['/p'],
            'persistentRecursive': ['/r', '/s']}},
    ]


def encode_replies(replies, cls=PacketCodec, native_tier=False) -> bytes:
    enc = cls(server=True, use_native=native_tier)
    enc.handshaking = False
    return b''.join(enc.encode(dict(p)) for p in replies)


def encode_requests(requests, cls=PacketCodec, native_tier=False) -> bytes:
    enc = cls(use_native=native_tier)
    enc.handshaking = False
    return b''.join(enc.encode(dict(p)) for p in requests)


def xid_map_for(replies) -> dict:
    return {p['xid']: p['opcode'] for p in replies if p['xid'] > 0}


def _canon(x):
    """Packets with each package's records as plain values, so the two
    packages' outputs compare."""
    if hasattr(x, 'perms') and hasattr(x, 'id'):
        return ('ACL', int(x.perms), x.id.scheme, x.id.id)
    if hasattr(x, '_fields'):
        return (type(x).__name__,) + tuple(x)
    if isinstance(x, enum.Enum):
        return (type(x).__name__, int(x))
    if isinstance(x, dict):
        return {k: _canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_canon(v) for v in x]
    return x


def _packages(x, out=None) -> set:
    """The top-level packages of every record object inside ``x``."""
    out = set() if out is None else out
    if hasattr(x, '_fields') or hasattr(x, 'perms'):
        out.add(type(x).__module__.split('.')[0])
        if hasattr(x, 'id'):
            out.add(type(x.id).__module__.split('.')[0])
    if isinstance(x, dict):
        for v in x.values():
            _packages(v, out)
    elif isinstance(x, list):
        for v in x:
            _packages(v, out)
    return out


def run_tiers(pieces, xid_map=None, server=False, max_frame=None):
    """Decode ``pieces`` (chunks fed in order) through the three tiers
    and check they agree; return ``{tier: (codec, kind, pkts, code,
    err)}``."""
    out = {}
    for name, cls, use_native in TIERS:
        c = cls(server=server, use_native=use_native, max_frame=max_frame)
        c.handshaking = False
        if xid_map is not None:
            c.xid_map = dict(xid_map)
        assert (c.ext is not None) == use_native
        pkts, err = [], None
        try:
            for piece in pieces:
                pkts += c.decode(piece)
        except (ZKProtocolError, RefProtocolError) as e:
            pkts += getattr(e, 'packets', [])
            err = e
        out[name] = (c, 'err' if err else 'ok', pkts,
                     getattr(err, 'code', None), err)
    want = out['port_py']
    for name in ('port_c', 'ref_c'):
        c, kind, pkts, code, _e = out[name]
        assert (kind, code) == (want[1], want[3]), name
        assert _canon(pkts) == _canon(want[2]), name
        assert c._decoder.pending() == want[0]._decoder.pending(), name
        assert c.xid_map == want[0].xid_map, name
    assert str(out['port_c'][4]) == str(out['ref_c'][4])
    for name in ('port_py', 'port_c'):
        assert _packages(out[name][2]) <= {'zkstream_tpu_torch'}
    assert _packages(out['ref_c'][2]) <= {'zkstream_tpu'}
    return out


def test_extension_is_the_ports_own_build():
    ext = native.ensure_ext()
    assert ext.__name__ == '_zkwire_ext_torch'
    assert ext.abi_version() == native._EXT_ABI_VERSION
    assert os.path.dirname(ext.__file__) == native.build_dir()
    ref = ref_native.ensure_ext()
    assert ref.__name__ == '_zkwire_ext' and ref is not ext
    # ABI 2 on: the codec and the transport calls, as the reference's
    assert all(hasattr(ext, f) and hasattr(ref, f)
               for f in native.EXT_TRANSPORT_CALLS)
    assert PacketCodec(use_native=True).ext is ext


def test_all_opcodes_equivalent():
    replies = all_replies(TR)
    wire = encode_replies(replies)
    assert wire == encode_replies(all_replies(RR), RefCodec)
    out = run_tiers([wire], xid_map_for(replies))
    _c, kind, pkts, _code, _e = out['port_c']
    assert kind == 'ok' and len(pkts) == len(replies)
    assert out['port_c'][0].xid_map == {}
    assert type(pkts[0]['stat']) is TR.Stat
    assert isinstance(pkts[6]['acl'][0], TR.ACL)
    assert type(out['ref_c'][2][0]['stat']) is RR.Stat
    assert pkts[13]['results'][4] == {'op': 'error', 'err': 'NO_NODE'}


@pytest.mark.parametrize('direction', ['replies', 'requests'])
def test_byte_at_a_time_feed(direction):
    if direction == 'replies':
        replies = all_replies(TR)
        wire, xm, server = encode_replies(replies), xid_map_for(replies), \
            False
    else:
        wire, xm, server = encode_requests(all_requests(TR)), None, True
    out = run_tiers([wire[i:i + 1] for i in range(len(wire))], xm, server)
    whole = run_tiers([wire], xm, server)
    assert _canon(out['port_c'][2]) == _canon(whole['port_c'][2])
    assert out['port_c'][1] == 'ok'
    assert out['port_c'][0]._decoder.pending() == 0


def test_unknown_error_code_formats_like_python():
    replies = [{'xid': 1, 'zxid': 1, 'opcode': 'GET_DATA',
                'err': 'OK', 'data': b'', 'stat': TR.Stat()}]
    wire = bytearray(encode_replies(replies))
    struct.pack_into('>i', wire, 4 + 12, -31337)
    out = run_tiers([bytes(wire)], xid_map_for(replies))
    assert out['port_c'][2][0]['err'] == 'ERROR_-31337'


def test_bad_length_matches_scalar_contract():
    """[good frame][bad prefix]: the good frame is consumed-and-dropped,
    the buffer is left at the offending prefix, no xids are popped."""
    replies = all_replies(TR)[:1]
    good = encode_replies(replies)
    wire = good + struct.pack('>i', -5) + b'junk'
    out = run_tiers([wire], xid_map_for(replies))
    c, kind, pkts, code, _e = out['port_c']
    assert (kind, code, pkts) == ('err', 'BAD_LENGTH', [])
    assert c._decoder.pending() == len(wire) - len(good)
    assert c.xid_map == xid_map_for(replies)


@pytest.mark.parametrize('max_frame,length,code', [
    (None, -5, 'BAD_LENGTH'),
    (None, -2**31, 'BAD_LENGTH'),
    (None, MAX_PACKET + 1, 'FRAME_TOO_LARGE'),
    (None, 2**31 - 1, 'FRAME_TOO_LARGE'),
    (64, 65, 'FRAME_TOO_LARGE'),
    (64, MAX_PACKET, 'FRAME_TOO_LARGE'),
])
def test_bad_length_against_frame_too_large(max_frame, length, code):
    """What the reference raises, prefix by prefix: a negative prefix is
    BAD_LENGTH, a non-negative one over the cap is the typed
    ZKFrameTooLargeError (FRAME_TOO_LARGE) carrying the length and the
    cap — in all three tiers, with the frame before it dropped."""
    replies = [all_replies(TR)[i] for i in (7, 10)]   # DELETE, PING
    good = encode_replies(replies)
    assert len(good) == 2 * (4 + 16)    # under every cap tried
    wire = good + struct.pack('>i', length) + b'\0' * 12
    out = run_tiers([wire], xid_map_for(replies), max_frame=max_frame)
    for name in ('port_py', 'port_c', 'ref_c'):
        c, kind, pkts, got, err = out[name]
        assert (kind, got, pkts) == ('err', code, []), name
        assert c._decoder.pending() == 16
        if code == 'FRAME_TOO_LARGE':
            assert (err.length, err.cap) == (length,
                                             max_frame or MAX_PACKET)


def test_bad_body_preserves_earlier_packets():
    """[good][truncated-body][good]: packets before the bad frame ride
    on the error; the frame after it is lost in every tier."""
    replies = all_replies(TR)[:3]
    f1 = encode_replies(replies[:1])
    bad_body = struct.pack('>iqi', 2, 5, 0) + b'\x00' * 4
    f2 = struct.pack('>i', len(bad_body)) + bad_body
    f3 = encode_replies(replies[2:3])
    out = run_tiers([f1 + f2 + f3], xid_map_for(replies))
    c, kind, pkts, code, _e = out['port_c']
    assert (kind, code) == ('err', 'BAD_DECODE')
    assert len(pkts) == 1 and pkts[0]['xid'] == 1
    assert c._decoder.pending() == 0
    assert c.xid_map == {3: 'SET_DATA'}


def test_unmatched_xid_is_bad_decode():
    wire = encode_replies([{'xid': 77, 'zxid': 1, 'opcode': 'DELETE',
                            'err': 'OK'}])
    out = run_tiers([wire], {})
    assert out['port_c'][3] == 'BAD_DECODE'
    assert 'matches no request' in str(out['port_c'][4])


@pytest.mark.parametrize('opcode', ['GET_CHILDREN', 'GET_CHILDREN2',
                                    'GET_ACL'])
def test_huge_child_count_is_bad_decode_not_alloc(opcode):
    """A tiny frame claiming 2^31-1 list entries fails as BAD_DECODE in
    every tier: the C path bounds the wire-controlled count before it
    allocates."""
    body = struct.pack('>iqi', 1, 5, 0) + struct.pack('>i', 0x7FFFFFFF)
    wire = struct.pack('>i', len(body)) + body
    out = run_tiers([wire], {1: opcode})
    assert out['port_c'][3] == 'BAD_DECODE'


@pytest.mark.parametrize('ntype,state', [(99, 3), (1, 99)])
def test_unknown_notification_type_is_bad_decode(ntype, state):
    body = struct.pack('>iqi', -1, 5, 0) + struct.pack('>ii', ntype,
                                                       state) \
        + struct.pack('>i', 2) + b'/x'
    wire = struct.pack('>i', len(body)) + body
    out = run_tiers([wire], {})
    assert out['port_c'][3] == 'BAD_DECODE'


def test_handshake_stays_on_python_path():
    """While handshaking the extension must not engage: the connect
    exchange decodes through the Python codec in every tier, and a
    segment coalescing the handshake with a reply behaves the same."""
    enc = PacketCodec(server=True, use_native=False)
    hs = enc.encode({'protocolVersion': 0, 'timeOut': 30000,
                     'sessionId': 7, 'passwd': b'p' * 16})
    enc.handshaking = False
    reply = enc.encode({'xid': 1, 'zxid': 9, 'opcode': 'DELETE',
                        'err': 'OK'})

    outcomes, coalesced = [], []
    for _name, cls, use_native in TIERS:
        c = cls(use_native=use_native)
        c.xid_map = {1: 'DELETE'}
        assert c.decode(hs)[0]['sessionId'] == 7
        c.handshaking = False
        outcomes.append(c.decode(reply))
        c = cls(use_native=use_native)
        c.xid_map = {1: 'DELETE'}
        try:
            coalesced.append(('ok', c.decode(hs + reply)))
        except (ZKProtocolError, RefProtocolError) as e:
            coalesced.append(('err', e.code))
    assert outcomes == [[{'xid': 1, 'zxid': 9, 'opcode': 'DELETE',
                          'err': 'OK'}]] * 3
    assert _canon(coalesced[0]) == _canon(coalesced[1]) \
        == _canon(coalesced[2])


def test_server_direction_all_opcodes_equivalent():
    """The request decoder (C) equals the Python spec over every
    request opcode, including SET_WATCHES' lists, CREATE's ACL + flags
    and MULTI's sub-ops."""
    requests = all_requests(TR)
    wire = encode_requests(requests)
    assert wire == encode_requests(all_requests(RR), RefCodec)
    out = run_tiers([wire], server=True)
    _c, kind, pkts, _code, _e = out['port_c']
    assert kind == 'ok' and len(pkts) == len(requests)
    assert pkts[4]['flags'] == 3
    assert pkts[9]['events']['dataChanged'] == ['/a', '/b']
    assert [s['op'] for s in pkts[12]['ops']] == [
        'create', 'set_data', 'check', 'delete']


def test_layout_tables_stay_in_sync_with_spec():
    """The C codec's opcode->layout tables plus its declared punt set
    cover exactly what the port's Python spec decodes, and equal the
    reference's tables."""
    from zkstream_tpu_torch.protocol.records import (
        _EMPTY_RESPONSES,
        _REQ_READERS,
        _RESP_READERS,
    )
    lay, req, punt = (native._EXT_LAYOUTS, native._EXT_REQ_LAYOUTS,
                      native._EXT_PUNT_OPS)
    assert set(req) | punt == set(_REQ_READERS)
    assert set(lay) | punt == set(_RESP_READERS) | set(_EMPTY_RESPONSES)
    assert not punt & set(req) and not punt & set(lay)
    assert lay == ref_native._EXT_LAYOUTS
    assert req == ref_native._EXT_REQ_LAYOUTS
    assert punt == ref_native._EXT_PUNT_OPS


def test_setup_args_come_from_the_port():
    args = native.ext_setup_args()
    assert args[:3] == (TR.Stat, TR.ACL, TR.Id)
    for cls in args[:5]:
        assert cls.__module__.startswith('zkstream_tpu_torch.')
    ref = ref_native.ext_setup_args()
    assert args[5:] == ref[5:]          # the name tables agree


@pytest.mark.parametrize('op_num,expect', [
    (100, "unsupported opcode 'AUTH'"), (9999, '9999 is not a valid OpCode')])
def test_unsupported_vs_invalid_opcode_messages(op_num, expect):
    body = struct.pack('>ii', 1, op_num)
    wire = struct.pack('>i', len(body)) + body
    out = run_tiers([wire], server=True)
    for name in ('port_py', 'port_c', 'ref_c'):
        assert out[name][3] == 'BAD_DECODE'
        assert expect in str(out[name][4]), name


@pytest.mark.parametrize('case', ['unknown_op', 'bad_bool', 'huge_list',
                                  'multi_terminator'])
def test_server_direction_error_contracts(case):
    if case == 'unknown_op':
        body = struct.pack('>ii', 1, 9999)
    elif case == 'bad_bool':
        body = struct.pack('>ii', 1, 4) + struct.pack('>i', 2) + b'/a' \
            + b'\x07'
    elif case == 'huge_list':
        body = struct.pack('>ii', -8, 101) + struct.pack('>q', 0) \
            + struct.pack('>i', 0x7FFFFFFF)
    else:                      # a MULTI whose terminator names a type
        body = struct.pack('>ii', 1, 14) + struct.pack('>i?i', 2, True, -1)
    wire = struct.pack('>i', len(body)) + body
    out = run_tiers([wire], server=True)
    assert out['port_c'][3] == 'BAD_DECODE'


def test_encode_equivalence_both_directions():
    """The port's C encoders produce byte-identical frames to its
    Python encoders and to the reference's C encoders for every shape,
    and return None (Python fallback) for the shapes they skip."""
    ext = native.ensure_ext()
    for server, make in ((False, all_requests), (True, all_replies)):
        py = PacketCodec(server=server, use_native=False)
        cx = PacketCodec(server=server, use_native=True)
        rx = RefCodec(server=server, use_native=True)
        py.handshaking = cx.handshaking = rx.handshaking = False
        for p, rp in zip(make(TR), make(RR)):
            assert py.encode(dict(p)) == cx.encode(dict(p)) \
                == rx.encode(dict(rp)), p
        assert py.xid_map == cx.xid_map == rx.xid_map
    assert ext.encode_request(
        {'xid': 1, 'opcode': 'SET_WATCHES', 'relZxid': 0,
         'events': {}}) is None
    assert ext.encode_response(
        {'xid': 1, 'zxid': 1, 'opcode': 'GET_ACL', 'err': 'OK',
         'acl': list(TR.OPEN_ACL_UNSAFE), 'stat': TR.Stat()}) is None
    assert ext.encode_request(
        {'xid': 1, 'opcode': 'DELETE', 'path': '/x',
         'version': 1 << 40}) is None
    neg = {'xid': 1, 'opcode': 'CREATE', 'path': '/n', 'data': b'',
           'acl': list(TR.OPEN_ACL_UNSAFE), 'flags': -1}
    assert ext.encode_request(dict(neg)) is None
    py2 = PacketCodec(use_native=False)
    cx2 = PacketCodec(use_native=True)
    py2.handshaking = cx2.handshaking = False
    assert py2.encode(dict(neg)) == cx2.encode(dict(neg))

    hostile_acl: list = []

    class Hostile:
        def __getattr__(self, name):
            hostile_acl.clear()   # shrink the list under the C loop
            raise AttributeError(name)
    hostile_acl.extend([Hostile(), Hostile()])
    assert ext.encode_request(
        {'xid': 1, 'opcode': 'CREATE', 'path': '/n', 'data': b'',
         'acl': hostile_acl, 'flags': 0}) is None


def _random_replies(rng, rec):
    opcodes = ['GET_DATA', 'EXISTS', 'SET_DATA', 'CREATE', 'DELETE',
               'GET_CHILDREN', 'GET_CHILDREN2', 'GET_ACL', 'SYNC']
    replies, xid = [], 0
    for _ in range(rng.randrange(1, 40)):
        if rng.random() < 0.15:
            replies.append({
                'xid': -1, 'zxid': rng.randrange(1 << 40),
                'opcode': 'NOTIFICATION', 'err': 'OK',
                'type': rng.choice(['CREATED', 'DELETED', 'DATA_CHANGED',
                                    'CHILDREN_CHANGED']),
                'state': 'SYNC_CONNECTED',
                'path': '/' + 'x' * rng.randrange(1, 30)})
            continue
        xid += 1
        op = rng.choice(opcodes)
        pkt = {'xid': xid, 'zxid': rng.randrange(1 << 40), 'opcode': op,
               'err': 'OK'}
        if rng.random() < 0.2:
            pkt['err'] = 'NO_NODE'
        else:
            st = rec.Stat(*[rng.randrange(1 << 30) for _ in range(11)])
            if op == 'GET_DATA':
                pkt['data'] = rng.randbytes(rng.randrange(200))
                pkt['stat'] = st
            elif op in ('EXISTS', 'SET_DATA'):
                pkt['stat'] = st
            elif op == 'CREATE':
                pkt['path'] = '/n%d' % xid
            elif op in ('GET_CHILDREN', 'GET_CHILDREN2'):
                pkt['children'] = ['c%d' % i for i in
                                   range(rng.randrange(5))]
                if op == 'GET_CHILDREN2':
                    pkt['stat'] = st
            elif op == 'GET_ACL':
                pkt['acl'] = list(rec.OPEN_ACL_UNSAFE)
                pkt['stat'] = st
        replies.append(pkt)
    return replies


@pytest.mark.parametrize('seed', [1234, 99])
def test_randomized_fleet_equivalence(seed):
    rng = random.Random(seed)
    for _ in range(25):
        twin = random.Random()
        twin.setstate(rng.getstate())
        replies = _random_replies(rng, TR)
        ref_replies = _random_replies(twin, RR)   # the same draws
        wire = encode_replies(replies)
        # the C response encoders agree byte for byte wherever they
        # engage (None = declined, Python produced the bytes)
        assert encode_replies(replies, native_tier=True) == wire
        assert encode_replies(ref_replies, RefCodec, True) == wire
        out = run_tiers([wire], xid_map_for(replies))
        assert out['port_c'][1] == 'ok'
        cut = rng.randrange(len(wire))
        split = run_tiers([wire[:cut], wire[cut:]], xid_map_for(replies))
        assert _canon(split['port_c'][2]) == _canon(out['port_c'][2])


def test_differential_fuzz_request_decode():
    """Random, half-structured and corrupted-suffix request frames
    through all three tiers: identical packets, pre-error retention and
    error codes."""
    rng = random.Random(0xC0FFEE)
    op_nums = [1, 2, 3, 4, 5, 6, 8, 9, 11, 12, 14, -11, 101, 106, 107,
               100, 7, 13, 9999, 0, -1]
    requests = all_requests(TR)
    for _trial in range(400):
        kind = rng.random()
        if kind < 0.35:
            body = rng.randbytes(rng.randrange(0, 48))
        elif kind < 0.8:
            body = struct.pack('>ii', rng.randrange(-16, 1 << 12),
                               rng.choice(op_nums))
            body += rng.randbytes(rng.randrange(0, 40))
        else:
            base = encode_requests([rng.choice(requests)])[4:]
            cut = rng.randrange(0, len(base) + 1)
            body = base[:cut] + rng.randbytes(rng.randrange(0, 12))
        wire = b''
        if rng.random() < 0.4:
            wire += encode_requests([rng.choice(requests)])
        wire += struct.pack('>i', len(body)) + body
        run_tiers([wire], server=True)


def test_differential_fuzz_response_decode():
    """Response-direction twin of the request fuzz, with random xid
    maps: identical packets, pre-error retention, error codes and
    xid-map state."""
    rng = random.Random(0xBEEF)
    for _trial in range(400):
        xids = [rng.randrange(1, 64) for _ in range(4)]
        replies = {x: rng.choice(list(TR._RESP_READERS) +
                                 ['SYNC', 'DELETE']) for x in xids}
        kind = rng.random()
        if kind < 0.35:
            body = rng.randbytes(rng.randrange(0, 48))
        elif kind < 0.8:
            body = struct.pack(
                '>iqi', rng.choice(xids + [-1, -2, -4, -8, 999]),
                rng.randrange(-(1 << 40), 1 << 40),
                rng.choice([0, -101, -4, 7, -999]))
            body += rng.randbytes(rng.randrange(0, 40))
        else:
            base = encode_replies([
                {'xid': xids[0], 'zxid': 5, 'err': 'OK',
                 'opcode': 'GET_DATA', 'data': b'abc',
                 'stat': TR.Stat()}])[4:]
            cut = rng.randrange(0, len(base) + 1)
            body = base[:cut] + rng.randbytes(rng.randrange(0, 12))
            replies[xids[0]] = 'GET_DATA'
        wire = struct.pack('>i', len(body)) + body
        run_tiers([wire], replies)


def test_both_extensions_coexist_in_one_process():
    """The reference's ``_zkwire_ext`` and the port's
    ``_zkwire_ext_torch`` are two shared objects with their own statics:
    decoding through one after the other's setup leaves each package's
    packets carrying its own record classes, equal as tuples."""
    port, ref = native.ensure_ext(), ref_native.ensure_ext()
    replies = all_replies(TR)
    wire = encode_replies(replies)
    got = {}
    # interleave the two: each call must use its own module's statics
    for name, ext in (('port', port), ('ref', ref), ('port2', port),
                      ('ref2', ref)):
        pkts, consumed, kind, _msg = ext.decode_responses(
            wire, xid_map_for(replies), MAX_PACKET)
        assert (consumed, kind) == (len(wire), None)
        got[name] = pkts
    # re-running setup on one module does not touch the other
    ref.setup(*ref_native.ext_setup_args())
    got['port3'] = port.decode_responses(wire, xid_map_for(replies),
                                         MAX_PACKET)[0]
    for name in ('port', 'port2', 'port3'):
        assert type(got[name][0]['stat']) is TR.Stat
        assert type(got[name][6]['acl'][0]) is TR.ACL
        assert type(got[name][6]['acl'][0].id) is TR.Id
        assert type(got[name][6]['acl'][0].perms) is \
            type(TR.OPEN_ACL_UNSAFE[0].perms)
    for name in ('ref', 'ref2'):
        assert type(got[name][0]['stat']) is RR.Stat
        assert type(got[name][6]['acl'][0]) is RR.ACL
    assert got['port'][0]['stat'] == got['ref'][0]['stat']   # as tuples
    assert tuple(got['port'][0]['stat']) == tuple(got['ref'][0]['stat'])
    assert _canon(got['port']) == _canon(got['ref'])


def test_no_native_env_forces_python(monkeypatch):
    monkeypatch.setenv('ZKSTREAM_NO_NATIVE', '1')
    assert native.get_ext() is None and native.ensure_ext() is None
    c = PacketCodec()
    assert c.ext is None and c._decoder._scanner is None
