"""Framing-layer tests of the port: incremental frame slicing, length
guards, and the symmetric client/server PacketCodec (reference behavior:
lib/zk-streams.js).  The port of tests/test_framing.py; where a case
encodes, the port's bytes are held to the JAX package's codec's, and
where it decodes, the frames or the error (class name and code) to what
the JAX package gives on the same bytes."""

import pytest

from zkstream_tpu.protocol import framing as ref_framing
from zkstream_tpu.protocol import records as ref_records
from zkstream_tpu.protocol.jute import JuteWriter as RefJuteWriter
from zkstream_tpu_torch.protocol.consts import MAX_PACKET
from zkstream_tpu_torch.protocol.errors import ZKProtocolError
from zkstream_tpu_torch.protocol.framing import (FrameDecoder, PacketCodec,
                                                 frame)
from zkstream_tpu_torch.protocol.jute import JuteWriter
from zkstream_tpu_torch.protocol.records import Stat, write_response


def feed_both(*chunks) -> list:
    """The port's ``FrameDecoder`` fed ``chunks``: its frames a chunk,
    asserted equal to the reference decoder's."""
    d, rd = FrameDecoder(), ref_framing.FrameDecoder()
    got = [d.feed(c) for c in chunks]
    assert got == [rd.feed(c) for c in chunks]
    assert d.pending() == rd.pending()
    return got


def raise_both(port_fn, ref_fn):
    """The error ``port_fn`` raises, asserted to carry the class name,
    code and message of the one ``ref_fn`` raises (both on the Python
    tier: the C tiers word some messages their own way)."""
    with pytest.raises(ZKProtocolError) as ei:
        port_fn()
    with pytest.raises(Exception) as ri:
        ref_fn()
    assert type(ei.value).__name__ == type(ri.value).__name__
    assert ei.value.code == ri.value.code
    assert str(ei.value) == str(ri.value)
    return ei.value


def steady(codec_cls, **kw):
    c = codec_cls(use_native=False, **kw)
    c.handshaking = False
    return c


def test_frame_helper():
    assert frame(b'abc') == b'\x00\x00\x00\x03abc'
    assert frame(b'') == b'\x00\x00\x00\x00'
    for body in (b'abc', b'', b'x' * 300):
        assert frame(body) == ref_framing.frame(body)


def test_single_frame():
    assert feed_both(frame(b'hello')) == [[b'hello']]


def test_multiple_frames_one_chunk():
    data = frame(b'one') + frame(b'two') + frame(b'three')
    assert feed_both(data) == [[b'one', b'two', b'three']]


def test_byte_at_a_time():
    data = frame(b'slow') + frame(b'drip')
    got = feed_both(*[data[i:i + 1] for i in range(len(data))])
    assert sum(got, []) == [b'slow', b'drip']


def test_split_across_chunks():
    data = frame(b'x' * 1000)
    assert feed_both(data[:500], data[500:]) == [[], [b'x' * 1000]]


def test_negative_length_rejected():
    e = raise_both(
        lambda: FrameDecoder(use_native=False).feed(b'\xff\xff\xff\xf6'),
        lambda: ref_framing.FrameDecoder(use_native=False).feed(
            b'\xff\xff\xff\xf6'))
    assert e.code == 'BAD_LENGTH'


def test_oversized_length_rejected():
    # over-cap declarations raise the TYPED cap error (overload
    # plane): still a ZKProtocolError, but carrying length + cap so
    # the evicting side can trace what the peer declared
    too_big = (MAX_PACKET + 1).to_bytes(4, 'big')
    e = raise_both(
        lambda: FrameDecoder(use_native=False).feed(too_big),
        lambda: ref_framing.FrameDecoder(use_native=False).feed(too_big))
    assert e.code == 'FRAME_TOO_LARGE'
    assert e.length == MAX_PACKET + 1
    assert e.cap == MAX_PACKET


def test_max_packet_boundary_accepted():
    out = FrameDecoder().feed(frame(b'\x00' * MAX_PACKET))
    assert len(out) == 1 and len(out[0]) == MAX_PACKET


def test_zero_length_frame():
    assert feed_both(frame(b'') + frame(b'a')) == [[b'', b'a']]


def test_codec_client_server_handshake_and_request():
    """Drive a client codec against a server codec end to end; every
    encoded message equals the reference codecs'."""
    client, server = PacketCodec(), PacketCodec(server=True)
    rclient = ref_framing.PacketCodec()
    rserver = ref_framing.PacketCodec(server=True)

    creq = {'protocolVersion': 0, 'lastZxidSeen': 0, 'timeOut': 30000,
            'sessionId': 0, 'passwd': b'\x00' * 16}
    wire = client.encode(creq)
    assert wire == rclient.encode(creq)
    [got] = server.decode(wire)
    assert got == creq == rserver.decode(wire)[0]

    cresp = {'protocolVersion': 0, 'timeOut': 30000, 'sessionId': 0x1234,
             'passwd': b'p' * 16}
    wire = server.encode(cresp)
    assert wire == rserver.encode(cresp)
    [got] = client.decode(wire)
    assert got == cresp == rclient.decode(wire)[0]

    # Handshake complete on both ends.
    for c in (client, server, rclient, rserver):
        c.handshaking = False

    req = {'xid': 1, 'opcode': 'GET_DATA', 'path': '/x', 'watch': True}
    wire = client.encode(req)
    assert wire == rclient.encode(req)
    [got] = server.decode(wire)
    assert got == req
    assert client.xid_map[1] == 'GET_DATA'

    resp = {'xid': 1, 'zxid': 5, 'err': 'OK', 'opcode': 'GET_DATA',
            'data': b'v', 'stat': Stat()}
    wire = server.encode(resp)
    assert wire == rserver.encode(dict(resp, stat=ref_records.Stat()))
    [got] = client.decode(wire)
    assert got['data'] == b'v'
    assert got['err'] == 'OK'


def test_codec_bad_decode_raises_protocol_error():
    # A garbage frame in steady state: xid matches nothing.
    junk = frame(b'\x00\x00\x00\x63' + b'\x00' * 12)
    e = raise_both(lambda: steady(PacketCodec).decode(junk),
                   lambda: steady(ref_framing.PacketCodec).decode(junk))
    assert e.code == 'BAD_DECODE'


def test_codec_truncated_body_raises_bad_decode():
    # ConnectResponse body far too short.
    e = raise_both(
        lambda: PacketCodec(use_native=False).decode(frame(b'\x00\x00')),
        lambda: ref_framing.PacketCodec(use_native=False).decode(
            frame(b'\x00\x00')))
    assert e.code == 'BAD_DECODE'


def test_packets_before_bad_frame_are_preserved():
    # A valid notification sharing a chunk with a corrupt frame must still
    # be delivered: it rides on err.packets.
    note = {'xid': -1, 'zxid': 1, 'err': 'OK', 'opcode': 'NOTIFICATION',
            'type': 'DATA_CHANGED', 'state': 'SYNC_CONNECTED',
            'path': '/watched'}
    w, rw = JuteWriter(), RefJuteWriter()
    write_response(w, note)
    ref_records.write_response(rw, note)
    assert w.to_bytes() == rw.to_bytes()
    wire = frame(w.to_bytes()) + frame(b'\x00\x00\x00\x63' + b'\x00' * 12)
    e = raise_both(lambda: steady(PacketCodec).decode(wire),
                   lambda: steady(ref_framing.PacketCodec).decode(wire))
    assert e.code == 'BAD_DECODE'
    assert len(e.packets) == 1
    assert e.packets[0]['path'] == '/watched'


def test_xid_map_entry_consumed_by_reply():
    # One reply per xid: the map must not grow without bound.
    client = steady(PacketCodec)
    wire = client.encode({'xid': 1, 'opcode': 'PING'})
    assert wire == steady(ref_framing.PacketCodec).encode(
        {'xid': 1, 'opcode': 'PING'})
    assert 1 in client.xid_map
    w = JuteWriter()
    write_response(w, {'xid': 1, 'zxid': 1, 'err': 'OK', 'opcode': 'PING'})
    [pkt] = client.decode(frame(w.to_bytes()))
    assert pkt['opcode'] == 'PING'
    assert 1 not in client.xid_map


def test_server_mode_bad_decode_names_request():
    junk = frame(b'\x00\x00\x00\x01\x00\x00\x00\x63')
    e = raise_both(
        lambda: steady(PacketCodec, server=True).decode(junk),
        lambda: steady(ref_framing.PacketCodec, server=True).decode(junk))
    assert 'Failed to decode Request' in str(e)
