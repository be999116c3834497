"""Length-prefixed framing and the stateful packet codec.

Every ZooKeeper message travels as a 4-byte big-endian length prefix
followed by that many body bytes.  ``FrameDecoder`` is an incremental
accumulator that slices complete frames out of an arbitrary byte stream
and rejects insane lengths (negative, or over the 16 MiB cap)
(reference: lib/zk-streams.js:39-64, cap at :23).

``PacketCodec`` layers the message codec on top: it tracks whether the
link is still handshaking (connect req/resp framing differs from the
steady-state request/reply framing) and keeps the xid -> opcode map the
reply decoder needs.  ``server=True`` flips the direction
(reference: lib/zk-streams.js:28,70-71,84-85,128-129).

This is the port's own copy of ``zkstream_tpu.protocol.framing`` with
the pure-Python tiers only: the native scanner and the C-extension
codec are not loaded here.
"""

from __future__ import annotations

import os
import struct

from . import records
from .consts import MAX_PACKET
from .errors import ZKFrameTooLargeError, ZKProtocolError
from .fastencode import FastEncoder
from .jute import JuteReader, JuteWriter

_LEN = struct.Struct('>i')

MAX_FRAME_ENV = 'ZKSTREAM_MAX_FRAME'


def frame_cap_default() -> int:
    """The process-wide inbound frame-size cap (the ``jute.maxbuffer``
    analogue): ``ZKSTREAM_MAX_FRAME`` bytes, clamped to the 16 MiB
    protocol ceiling — a knob can only TIGHTEN the cap, never loosen
    the decoder's sanity bound."""
    raw = os.environ.get(MAX_FRAME_ENV)
    if raw:
        try:
            v = int(raw)
        except ValueError:
            return MAX_PACKET
        if v > 0:
            return min(v, MAX_PACKET)
    return MAX_PACKET


def resolve_frame_cap(arg: int | None) -> int:
    """Resolve an explicit constructor knob against the protocol
    ceiling (None = process default)."""
    if arg is None:
        return frame_cap_default()
    return min(int(arg), MAX_PACKET) if arg > 0 else MAX_PACKET


class FrameDecoder:
    """Incremental splitter of a byte stream into length-prefixed
    frames."""

    __slots__ = ('_buf', '_max_frame')

    def __init__(self, max_frame: int | None = None) -> None:
        self._buf = bytearray()
        #: Inbound frame cap, checked against the 4-byte prefix BEFORE
        #: any body byte is buffered — an oversized prefix raises the
        #: typed :class:`ZKFrameTooLargeError` instead of making the
        #: peer accumulate up to the prefix's claim.
        self._max_frame = resolve_frame_cap(max_frame)

    def feed(self, chunk: bytes) -> list[bytes]:
        """Absorb ``chunk``; return every complete frame body now
        available.  Raises ZKProtocolError('BAD_LENGTH') on a negative or
        oversized length prefix (reference: lib/zk-streams.js:47-53)."""
        self._buf += chunk
        frames: list[bytes] = []
        off = 0
        try:
            while len(self._buf) - off >= 4:
                (ln,) = _LEN.unpack_from(self._buf, off)
                if ln < 0:
                    raise ZKProtocolError('BAD_LENGTH',
                        'Invalid ZK packet length %d' % (ln,))
                if ln > self._max_frame:
                    raise ZKFrameTooLargeError(ln, self._max_frame)
                if len(self._buf) - off < 4 + ln:
                    break
                frames.append(bytes(self._buf[off + 4:off + 4 + ln]))
                off += 4 + ln
        finally:
            if off:
                del self._buf[:off]
        return frames

    def pending(self) -> int:
        """Bytes buffered but not yet sliced into a frame."""
        return len(self._buf)

    def take_pending(self) -> bytes:
        """Hand off the undecoded residue (a partial frame) and clear
        it — used when an external drain (the fleet ingest) takes over
        this stream mid-flight."""
        out = bytes(self._buf)
        self._buf.clear()
        return out

    def restore_pending(self, data: bytes) -> None:
        """Give residue back (the external drain returned the stream)."""
        self._buf[:0] = data


def frame(body: bytes) -> bytes:
    """Wrap an encoded message body in its length prefix."""
    return _LEN.pack(len(body)) + body


class PacketCodec:
    """Stateful bytes <-> packet-dict codec for one TCP connection.

    ``handshaking`` starts True; the connection layer flips it to False
    once the connect exchange completes, switching both directions to the
    request/reply formats (reference: lib/zk-streams.js:68,126).
    """

    def __init__(self, server: bool = False,
                 max_frame: int | None = None):
        self._decoder = FrameDecoder(max_frame=max_frame)
        self._max_frame = self._decoder._max_frame
        self._server = server
        self.handshaking = True
        #: xid -> opcode for replies in flight
        #: (reference: lib/zk-streams.js:145, connection-fsm.js:74).
        self.xid_map: dict[int, str] = {}
        # Single-pass struct-batched encode tier
        # (protocol/fastencode.py); the JuteWriter walk below stays the
        # spec and the last resort.
        self._fast = (None if os.environ.get('ZKSTREAM_NO_FASTENC')
                      == '1' else FastEncoder())

    def encode(self, pkt: dict) -> bytes:
        """Encode one outgoing packet to framed wire bytes."""
        if self._fast is not None and not self.handshaking:
            data = (self._fast.encode_response(pkt) if self._server
                    else self._fast.encode_request(pkt))
            if data is not None:
                if not self._server:
                    self.xid_map[pkt['xid']] = pkt['opcode']
                return data
        w = JuteWriter()
        if self.handshaking:
            if self._server:
                records.write_connect_response(w, pkt)
            else:
                records.write_connect_request(w, pkt)
        elif self._server:
            records.write_response(w, pkt)
        else:
            records.write_request(w, pkt)
            self.xid_map[pkt['xid']] = pkt['opcode']
        return frame(w.to_bytes())

    def take_pending(self) -> bytes:
        """See :meth:`FrameDecoder.take_pending`."""
        return self._decoder.take_pending()

    def restore_pending(self, data: bytes) -> None:
        """See :meth:`FrameDecoder.restore_pending`."""
        self._decoder.restore_pending(data)

    def decode(self, chunk: bytes) -> list[dict]:
        """Absorb incoming bytes; return the packets completed by them.

        Framing errors raise ZKProtocolError('BAD_LENGTH'); undecodable
        frame bodies raise ZKProtocolError('BAD_DECODE')
        (reference: lib/zk-streams.js:49-51,74-79,90-95).  When a later
        frame in the chunk fails, packets decoded before it are attached
        to the error as ``err.packets`` so the caller can still deliver
        them.
        """
        pkts: list[dict] = []
        for body in self._decoder.feed(chunk):
            r = JuteReader(body)
            try:
                if self.handshaking:
                    if self._server:
                        pkt = records.read_connect_request(r)
                    else:
                        pkt = records.read_connect_response(r)
                elif self._server:
                    pkt = records.read_request(r)
                else:
                    pkt = records.read_response(r, self.xid_map)
            except Exception as e:
                if isinstance(e, ZKProtocolError):
                    err = e
                else:
                    what = ('ConnectRequest' if self._server else
                            'ConnectResponse') if self.handshaking else (
                            'Request' if self._server else 'Response')
                    err = ZKProtocolError('BAD_DECODE',
                        'Failed to decode %s: %s: %s' % (
                            what, type(e).__name__, e))
                    err.__cause__ = e
                err.packets = pkts
                raise err
            pkts.append(pkt)
        return pkts
