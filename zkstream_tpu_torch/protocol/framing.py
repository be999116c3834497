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

This is the port's own copy of ``zkstream_tpu.protocol.framing``, with
the same three tiers: the C-ABI frame scanner (``csrc/zkwire.cpp``) and
the C-extension codec (``csrc/zkwire_ext.c``), both loaded by
``utils/native.py``, over the pure-Python loop, which is the semantic
spec and the fallback.  ``use_native=None`` auto-detects (never blocks
on a build), ``True`` requires the C tiers, ``False`` forces Python.
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
    frames.

    When the native scanner is available the scan runs in C++; the
    pure-Python loop is the always-present fallback and the semantic
    spec — the two are A/B-tested equivalent in
    tests/test_torch_native.py.  ``use_native=None`` auto-detects;
    True/False force a path (tests, benchmarks).
    """

    __slots__ = ('_buf', '_scanner', '_max_frame')

    def __init__(self, use_native: bool | None = None,
                 max_frame: int | None = None) -> None:
        self._buf = bytearray()
        #: Inbound frame cap, checked against the 4-byte prefix BEFORE
        #: any body byte is buffered — an oversized prefix raises the
        #: typed :class:`ZKFrameTooLargeError` instead of making the
        #: peer accumulate up to the prefix's claim.
        self._max_frame = resolve_frame_cap(max_frame)
        self._scanner = None
        if use_native is not False:
            from ..utils import native
            # auto mode (None) must never block the event loop: it
            # binds only an already-built artifact (the build proceeds
            # on a background thread for later connections).  Forced
            # mode (True, tests/tools) builds synchronously.
            lib = native.ensure_lib() if use_native else native.get_lib()
            if lib is not None:
                self._scanner = native.NativeFrameScanner(lib)
            elif use_native is True:
                raise RuntimeError('native codec unavailable')

    def feed(self, chunk: bytes) -> list[bytes]:
        """Absorb ``chunk``; return every complete frame body now
        available.  Raises ZKProtocolError('BAD_LENGTH') on a negative or
        oversized length prefix (reference: lib/zk-streams.js:47-53)."""
        self._buf += chunk
        if self._scanner is not None:
            return self._feed_native()
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

    def _feed_native(self) -> list[bytes]:
        """Native scan over the accumulated buffer (zero-copy: the
        scanner reads the bytearray in place).  Matches the Python loop
        exactly, including the BAD_LENGTH contract: complete frames
        before an invalid prefix are consumed-and-discarded and the
        buffer is left positioned at the offending prefix."""
        spans, resid, bad_at = self._scanner.scan(self._buf,
                                                  self._max_frame)
        if bad_at is not None:
            if bad_at:
                del self._buf[:bad_at]
            (ln,) = _LEN.unpack_from(self._buf, 0)
            if ln < 0:
                raise ZKProtocolError('BAD_LENGTH',
                    'Invalid ZK packet length %d' % (ln,))
            raise ZKFrameTooLargeError(ln, self._max_frame)
        frames = [bytes(self._buf[s:s + z]) for s, z in spans]
        if resid:
            del self._buf[:resid]
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
                 use_native: bool | None = None,
                 max_frame: int | None = None):
        self._decoder = FrameDecoder(use_native=use_native,
                                     max_frame=max_frame)
        #: The resolved inbound frame cap: one value drives all three
        #: decode tiers (scalar loop, native scanner, C-extension
        #: batch decode), so the rejection boundary cannot fork.
        self._max_frame = self._decoder._max_frame
        self._server = server
        self.handshaking = True
        #: xid -> opcode for replies in flight
        #: (reference: lib/zk-streams.js:145, connection-fsm.js:74).
        self.xid_map: dict[int, str] = {}
        # The C-extension codec covers both steady-state receive
        # directions — replies (client) and requests (server); only the
        # handshake exchange stays in Python.  Best-effort: an absent
        # extension degrades to the scalar path.
        self._ext = None
        if use_native is not False:
            from ..utils import native
            self._ext = (native.ensure_ext() if use_native
                         else native.get_ext())
        # Middle encode tier: single-pass struct-batched Python
        # (protocol/fastencode.py).  Runs when the C encoder is absent
        # or declines a shape; the JuteWriter walk below stays the
        # spec and the last resort.
        self._fast = (None if os.environ.get('ZKSTREAM_NO_FASTENC')
                      == '1' else FastEncoder())

    @property
    def ext(self):
        """The bound C-extension codec (or None) — exposed for the
        fleet ingest's zero-copy slice-decode fast path, which must
        honor this connection's codec selection."""
        return self._ext

    def encode(self, pkt: dict) -> bytes:
        """Encode one outgoing packet to framed wire bytes."""
        if self._ext is not None and not self.handshaking:
            # best-effort C encode: None means "shape the C side does
            # not handle" (rare opcodes, out-of-range fields) — the
            # Python encoders below are the spec and raise their own
            # validation errors; byte equality is A/B-tested.
            data = (self._ext.encode_response(pkt) if self._server
                    else self._ext.encode_request(pkt))
            if data is not None:
                if not self._server:
                    self.xid_map[pkt['xid']] = pkt['opcode']
                return data
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

    def pending(self) -> int:
        """Bytes buffered toward the next frame."""
        return len(self._decoder._buf)

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
        if self._ext is not None and not self.handshaking:
            return self._decode_ext(chunk)
        return self._decode_scalar(chunk, [])

    def _decode_scalar(self, chunk: bytes,
                       pkts: list[dict]) -> list[dict]:
        """The pure-Python decode loop, appending into ``pkts`` (the
        spec tier; also the continuation the extension path hands the
        buffer to when it punts an opcode it carries no layout for)."""
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

    def _decode_ext(self, chunk: bytes) -> list[dict]:
        """Steady-state receive via the C extension: framing + body
        decode in one native pass over the accumulation buffer.  Shares
        the FrameDecoder's buffer so handing a connection between paths
        (handshake -> steady state, ingest take/restore_pending) stays
        seamless; error semantics mirror the Python path (A/B-tested in
        tests/test_torch_native_ext.py)."""
        buf = self._decoder._buf
        buf += chunk
        try:
            if self._server:
                pkts, consumed, kind, msg = self._ext.decode_requests(
                    buf, self._max_frame)
            else:
                pkts, consumed, kind, msg = self._ext.decode_responses(
                    buf, self.xid_map, self._max_frame)
        except Exception as e:
            # Parity with the scalar path: ANY decode-side exception
            # (e.g. MemoryError) surfaces as connection-fatal
            # BAD_DECODE, never as a raw exception.
            err = ZKProtocolError('BAD_DECODE',
                'Failed to decode %s: %s: %s'
                % ('Request' if self._server else 'Response',
                   type(e).__name__, e))
            err.__cause__ = e
            err.packets = []
            raise err
        if consumed:
            del buf[:consumed]
        if kind == 'UNSUPPORTED':
            # the head of the buffer is a complete frame whose opcode
            # the C tier carries no layout for: the spec tier takes over
            # from here — it decodes the frame (or raises the spec's own
            # precise error) and everything behind it in this chunk,
            # with the scalar path's exact buffer and error semantics;
            # the next chunk re-enters the C tier
            return self._decode_scalar(b'', pkts)
        if kind is not None:
            if kind == 'BAD_LENGTH' and len(buf) >= 4:
                # scalar parity: the buffer is positioned at the
                # offending prefix — a non-negative over-cap length is
                # the typed frame-size rejection, not a corrupt prefix
                (ln,) = _LEN.unpack_from(buf, 0)
                if ln > self._max_frame and ln >= 0:
                    err = ZKFrameTooLargeError(ln, self._max_frame)
                    err.packets = pkts
                    raise err
            err = ZKProtocolError(kind, msg)
            err.packets = pkts
            raise err
        return pkts
