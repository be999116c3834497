"""The per-TCP-connection state machine.

One ``ZKConnection`` owns one socket to one ZooKeeper backend and drives
it through ``init -> connecting -> handshaking -> connected ->
closing/error -> closed`` (reference: lib/connection-fsm.js:78-351).
Responsibilities mirror the reference exactly: xid allocation, the
pending-request table, reply routing, automatic ping keepalive with
piggybacking, SET_WATCHES queueing, and failing every outstanding
request exactly once on each teardown path.

Where the reference wires Node streams and sockets together, this uses
an asyncio ``Protocol`` feeding the symmetric ``PacketCodec``; requests
are represented by ``ZKRequest`` emitters ('reply'/'error'), which the
client facade adapts to awaitables.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import Callable

from ..protocol import consts
from ..protocol.errors import ZKError, ZKPingTimeoutError, \
    ZKProtocolError, ZKThrottledError
from ..protocol.framing import PacketCodec
from ..utils.aio import set_nodelay
from ..utils.events import EventEmitter
from ..utils.fsm import FSM
from ..utils.logging import Logger
from .sendplane import SendPlane

METRIC_ZK_CONNECT_LATENCY = 'zookeeper_connect_latency_ms'


@dataclasses.dataclass(frozen=True)
class Backend:
    """One ZooKeeper server address (reference: cueball backend objects)."""

    address: str
    port: int

    @property
    def key(self) -> str:
        return '%s:%d' % (self.address, self.port)


def _finish_span(req, zxid: int | None = None, status: str = 'ok',
                 error: str | None = None) -> None:
    """Close a request's trace span, when the client attached one
    (utils/trace.py — the xid-correlated span is stamped with the
    reply zxid here, where the reply routes back by xid).  Safe on
    every settle path: a span closes once, first outcome wins."""
    span = getattr(req, 'span', None)
    if span is not None:
        span.finish(zxid=zxid, status=status, error=error)


class ZKRequest(EventEmitter):
    """One in-flight request: emits 'reply' (packet) or 'error' (exc)
    exactly once (reference: lib/connection-fsm.js:378-382).  The
    client facade may attach a trace ``span``; the connection's
    reply/error routing closes it."""

    def __init__(self, packet: dict):
        super().__init__()
        self.packet = packet
        #: Optional utils/trace.Span, attached by Client._start_op.
        self.span = None

    def as_future(self) -> asyncio.Future:
        """Adapt to an awaitable resolving to the reply packet.

        Plain ``on`` (not ``once``): reply/error fire at most once per
        request by contract, the ``done()`` guards make a double-settle
        harmless, and skipping the once-wrapper + removal scan matters
        on the per-op hot path."""
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self.on('reply', lambda pkt: fut.done() or fut.set_result(pkt))
        self.on('error', lambda err, *a: fut.done() or
                fut.set_exception(err))
        return fut


class _SocketProtocol(asyncio.Protocol):
    """Thin adapter: socket callbacks -> connection events."""

    def __init__(self, conn: 'ZKConnection'):
        self._conn = conn

    def connection_made(self, transport) -> None:
        set_nodelay(transport)
        self._conn.transport = transport
        self._conn.emit('sockConnect')

    def data_received(self, data: bytes) -> None:
        self._conn._sock_data(data)

    def eof_received(self) -> bool:
        self._conn.emit('sockEnd')
        return True  # keep half-open, like the reference's allowHalfOpen

    def connection_lost(self, exc) -> None:
        if exc is not None:
            self._conn.emit('sockError', exc)
        else:
            self._conn.emit('sockClose')


class ZKConnection(FSM):
    def __init__(self, client, backend: Backend, spare: bool = False):
        #: A spare parks after the TCP connect instead of handshaking:
        #: the ZK handshake binds the session to one connection, so a
        #: warm standby must stop just short of it.  ``promote()``
        #: resumes the normal lifecycle (pool failover skips the TCP
        #: dial; cueball's target 1 / max 3 warm set,
        #: reference: lib/client.js:108-109).
        self.spare = spare
        #: The owning client; consulted for the session during handshake
        #: (reference: lib/connection-fsm.js:174).
        self.client = client
        self.backend = backend
        # Child logger carrying this connection's address context
        # (reference: lib/connection-fsm.js:93-96); sessionId accretes
        # once connected (reference: lib/connection-fsm.js:209-211).
        self.log = getattr(client, 'log', Logger()).child(
            component='ZKConnectionFSM', zkAddress=backend.address,
            zkPort=backend.port)
        self.codec: PacketCodec | None = None
        self.transport = None
        self.session = None
        #: Optional FleetIngest: when the owning client carries one,
        #: connected-state bytes drain through the batched device
        #: pipeline instead of the per-socket scalar codec.
        self.ingest = getattr(client, 'ingest', None)
        #: Optional FaultInjector (io/faults.py): when the owning
        #: client carries one, dials, received bytes and outbound
        #: frames route through its seeded fault schedule.
        self.faults = getattr(client, 'faults', None)
        self.last_error: Exception | None = None
        self._xid = 0
        #: xid -> ZKRequest for everything awaiting a reply
        #: (reference: zcf_reqs).
        self.reqs: dict[int, ZKRequest] = {}
        self._dial_task: asyncio.Task | None = None
        #: Dial/handshake latency instrumentation: t0 set on entering
        #: 'connecting' (or on promote for a parked spare), observed
        #: into the histogram on reaching 'connected'.
        self._connect_t0: float | None = None
        #: Outbound cork (io/sendplane.py): every encoded frame goes
        #: through it; frames of one event-loop tick leave as a single
        #: transport.write — or, when the client carries a batched
        #: transport tier (io/transport.py), as part of the tick's one
        #: batched submission.  ``client.cork`` forces the cork on/off
        #: (None = process default, see sendplane.cork_default);
        #: ``client.flush_cap`` resizes the early-flush cap.
        collector = getattr(client, 'collector', None)
        self._tx = SendPlane(self._tx_write,
                             enabled=getattr(client, 'cork', None),
                             max_bytes=getattr(client, 'flush_cap',
                                               None),
                             collector=collector, plane='client',
                             tier=getattr(client, 'transport_tier',
                                          None),
                             transport_fn=lambda: self.transport)
        self._connect_latency = None
        if collector is not None:
            self._connect_latency = collector.histogram(
                METRIC_ZK_CONNECT_LATENCY,
                'TCP connect + ZK handshake latency, milliseconds, '
                'by backend')
            self.bind_fsm_metrics(collector, 'ZKConnection')
        super().__init__('init')

    # -- public controls (reference: lib/connection-fsm.js:51-76) --

    def connect(self) -> None:
        assert self.is_in_state('closed') or self.is_in_state('init')
        self.emit('connectAsserted')

    def close(self) -> None:
        if self.is_in_state('closed'):
            return
        self.emit('closeAsserted')

    def destroy(self) -> None:
        if self.is_in_state('closed'):
            return
        self.emit('destroyAsserted')

    def promote(self) -> None:
        """Turn a parked spare into a live connection: run the ZK
        handshake on the already-open socket."""
        assert self.is_in_state('parked'), self.get_state()
        self.spare = False
        # a promoted spare's latency sample measures the handshake
        # only — the TCP dial was paid when it parked
        self._connect_t0 = time.monotonic()
        self.emit('promoteAsserted')

    def next_xid(self) -> int:
        self._xid += 1
        return self._xid

    # -- states --

    def state_init(self, S) -> None:
        S.on(self, 'connectAsserted', lambda: S.goto_state('connecting'))

    def state_connecting(self, S) -> None:
        self.codec = PacketCodec(
            use_native=getattr(self.client, 'use_native_codec', None),
            max_frame=getattr(self.client, 'max_frame', None))
        self.log.debug('attempting new connection')
        self._connect_t0 = time.monotonic()

        async def dial():
            loop = asyncio.get_running_loop()
            try:
                if self.faults is not None:
                    # injected reconnect latency and/or refusal
                    await self.faults.before_connect(self.backend.key)
                await loop.create_connection(
                    lambda: _SocketProtocol(self),
                    self.backend.address, self.backend.port)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                self.emit('sockError', e)

        self._dial_task = asyncio.get_running_loop().create_task(dial())

        S.on(self, 'sockConnect', lambda: S.goto_state(
            'parked' if self.spare else 'handshaking'))

        def on_error(err):
            self.last_error = err
            S.goto_state('error')
        S.on(self, 'sockError', on_error)
        S.on(self, 'sockClose', lambda: S.goto_state('closed'))
        S.on(self, 'closeAsserted', lambda: S.goto_state('closed'))
        S.on(self, 'destroyAsserted', lambda: S.goto_state('closed'))

    def state_parked(self, S) -> None:
        """Warm spare: TCP is open, no ZK bytes exchanged.  Wakes into
        ``handshaking`` on promote; any socket activity or death tears
        it down (a ZK server must not speak first, so inbound data here
        is a protocol violation)."""
        S.on(self, 'promoteAsserted',
             lambda: S.goto_state('handshaking'))

        def on_data(_data):
            self.last_error = ZKProtocolError('UNEXPECTED_PACKET',
                'Server sent data before the handshake')
            S.goto_state('error')
        S.on(self, 'sockData', on_data)

        def on_error(err):
            self.last_error = err
            S.goto_state('error')
        S.on(self, 'sockError', on_error)

        def on_end():
            self.last_error = ZKProtocolError('CONNECTION_LOSS',
                'Connection closed unexpectedly.')
            S.goto_state('error')
        S.on(self, 'sockEnd', on_end)
        S.on(self, 'sockClose', on_end)
        S.on(self, 'closeAsserted', lambda: S.goto_state('closed'))
        S.on(self, 'destroyAsserted', lambda: S.goto_state('closed'))

    def state_handshaking(self, S) -> None:
        def on_data(data):
            try:
                pkts = self.codec.decode(data)
            except ZKProtocolError as e:
                self.last_error = e
                S.goto_state('error')
                return
            if not pkts:
                return
            # Exactly one packet may arrive during the connect phase
            # (reference: lib/connection-fsm.js:130-140).
            if len(pkts) > 1:
                self.last_error = ZKProtocolError('UNEXPECTED_PACKET',
                    'Received unexpected additional packet during '
                    'connect phase')
                S.goto_state('error')
                return
            pkt = pkts[0]
            if pkt['protocolVersion'] != consts.PROTOCOL_VERSION:
                self.last_error = ZKProtocolError('VERSION_INCOMPAT',
                    'Server version is not compatible')
                S.goto_state('error')
                return
            self.emit('packet', pkt)
        S.on(self, 'sockData', on_data)

        def on_error(err):
            self.last_error = err
            S.goto_state('error')
        S.on(self, 'sockError', on_error)

        def on_end():
            self.last_error = ZKProtocolError('CONNECTION_LOSS',
                'Connection closed unexpectedly.')
            S.goto_state('error')
        S.on(self, 'sockEnd', on_end)
        S.on(self, 'sockClose', on_end)
        S.on(self, 'closeAsserted', lambda: S.goto_state('closed'))
        S.on(self, 'destroyAsserted', lambda: S.goto_state('closed'))

        self.session = self.client.get_session()
        if self.session is None:
            S.goto_state('closed')
            return

        # Guard against a session already attaching to another connection
        # (reference: lib/connection-fsm.js:180-187, the nasty.test.js
        # monitor-mode race).
        if self.session.is_attaching():
            self.log.debug('session in state %s while handshaking',
                           self.session.get_state())
            self.last_error = ZKProtocolError('ATTACH_RACE',
                'ZKSession attaching to another connection')
            S.goto_state('error')
            return

        def on_session_state(st):
            if st == 'attached':
                S.goto_state('connected')
        S.on(self.session, 'stateChanged', on_session_state)

        self.session.attach_and_send_cr(self)

    def state_connected(self, S) -> None:
        # Handshake is over: steady-state request/reply framing from here
        # (the reference flips this per-frame via isInState checks).
        self.codec.handshaking = False
        self.log = self.log.child(
            sessionId=self.session.get_session_id())

        if self._connect_latency is not None and \
                self._connect_t0 is not None:
            self._connect_latency.observe(
                (time.monotonic() - self._connect_t0) * 1000.0,
                {'backend': self.backend.key})
            self._connect_t0 = None

        ping_interval = max(self.session.get_timeout() / 4, 2000)
        S.interval(ping_interval, self.ping)

        def deliver(pkts, err):
            for pkt in pkts:
                self.emit('packet', pkt)
                # Notifications are the session's business
                # (reference: lib/connection-fsm.js:223-224).
                if pkt['opcode'] != 'NOTIFICATION':
                    self.process_reply(pkt)
            if err is not None:
                self.last_error = err
                S.goto_state('error')

        if self.ingest is not None:
            # Fleet drain: in the ingest's BATCH regime bytes go to the
            # batched device pipeline, which routes the decoded packets
            # back through the same deliver path, so semantics cannot
            # diverge from the scalar drain below.  In its pass-through
            # (direct) regime the connection runs the per-socket drain
            # itself — the ingest only gets the byte/frame counts its
            # dispatch policy needs — so the regime where batching does
            # not pay costs one flag check over the no-ingest path.
            self.ingest.register(self)
            S.defer(lambda: self.ingest.unregister(self))

            def on_sock(data):
                ing = self.ingest
                if not ing.direct:
                    ing.feed(self, data)
                    return
                # Deliberately restates FleetIngest._deliver_direct
                # minus its emit hop: calling deliver() directly here
                # skips one event dispatch per segment, which is the
                # point of the pass-through.  Slot residue cannot
                # exist in this regime (register/flip keep it in the
                # codec), so no splice is needed.
                err = None
                try:
                    pkts = self.codec.decode(data)
                except ZKProtocolError as e:
                    pkts = getattr(e, 'packets', [])
                    err = e
                ing.note_direct(len(data), len(pkts))
                deliver(pkts, err)
            S.on(self, 'sockData', on_sock)
            S.on(self, 'ingestDeliver', deliver)
        else:
            def on_data(data):
                err = None
                try:
                    pkts = self.codec.decode(data)
                except ZKProtocolError as e:
                    # Deliver packets decoded before the bad frame first.
                    pkts = getattr(e, 'packets', [])
                    err = e
                deliver(pkts, err)
            S.on(self, 'sockData', on_data)

        def on_error(err):
            self.last_error = err
            S.goto_state('error')
        S.on(self, 'sockError', on_error)

        def on_end():
            self.last_error = ZKProtocolError('CONNECTION_LOSS',
                'Connection closed unexpectedly.')
            S.goto_state('error')
        S.on(self, 'sockEnd', on_end)
        S.on(self, 'sockClose', on_end)

        S.on(self, 'closeAsserted', lambda: S.goto_state('closing'))
        S.on(self, 'destroyAsserted', lambda: S.goto_state('closed'))

        def on_ping_timeout():
            self.last_error = ZKPingTimeoutError()
            S.goto_state('error')
        S.on(self, 'pingTimeout', on_ping_timeout)

        S.immediate(lambda: self.emit('connect'))

    def state_closing(self, S) -> None:
        """Drain outstanding requests, then send CLOSE_SESSION and wait
        for its reply (reference: lib/connection-fsm.js:263-307)."""
        close_xid: list[int | None] = [None]

        def send_close_session():
            if close_xid[0] is not None:
                return
            close_xid[0] = self.next_xid()
            self.log.info('sent CLOSE_SESSION request (xid %d)',
                          close_xid[0])
            self._write({'opcode': 'CLOSE_SESSION', 'xid': close_xid[0]})
            # the EOF must not cut ahead of the corked CLOSE_SESSION —
            # hard: a batched transport tier defers flush_now to the
            # tick submission, which would land after the write_eof
            self._tx.flush_hard()
            try:
                if self.transport and self.transport.can_write_eof():
                    self.transport.write_eof()
            except (OSError, RuntimeError):
                pass

        def on_data(data):
            try:
                pkts = self.codec.decode(data)
            except ZKProtocolError as e:
                self.last_error = e
                S.goto_state('closed')
                return
            for pkt in pkts:
                if pkt['xid'] == close_xid[0]:
                    S.goto_state('closed')
                    return
                self.process_reply(pkt)
                if not self.reqs:
                    send_close_session()
        S.on(self, 'sockData', on_data)

        def on_error(err):
            self.last_error = err
            S.goto_state('closed')
        S.on(self, 'sockError', on_error)
        S.on(self, 'sockEnd', lambda: S.goto_state('closed'))
        S.on(self, 'sockClose', lambda: S.goto_state('closed'))
        S.on(self, 'destroyAsserted', lambda: S.goto_state('closed'))

        if not self.reqs:
            send_close_session()

    def state_error(self, S) -> None:
        self.log.warning('error communicating with ZK: %s',
                         self.last_error)
        reqs, self.reqs = self.reqs, {}
        # Pending ops surface the ZK error taxonomy, never a raw OS
        # exception: a socket-level error becomes CONNECTION_LOSS with
        # the original chained as __cause__ (the clean-close straggler
        # path already spoke ZKProtocolError only).
        req_err = self.last_error
        if not isinstance(req_err, (ZKProtocolError, ZKError)):
            wrapped = ZKProtocolError(
                'CONNECTION_LOSS', 'Connection lost: %s' % (req_err,))
            wrapped.__cause__ = req_err
            req_err = wrapped
        for req in reqs.values():
            _finish_span(req, status='error',
                         error=getattr(req_err, 'code', None)
                         or type(req_err).__name__)
            req.emit('error', req_err)

        # Deliberately not scope-bound: the 'error' event must fire even
        # though we leave this state immediately
        # (reference: lib/connection-fsm.js:317-323).
        err = self.last_error
        asyncio.get_running_loop().call_soon(lambda: self.emit('error', err))

        S.goto_state('closed')

    def state_closed(self, S) -> None:
        if self._dial_task is not None and not self._dial_task.done():
            self._dial_task.cancel()
        self._dial_task = None
        gate = getattr(self, '_fault_rx_gate', None)
        if gate is not None:
            gate.close()
        if self.transport is not None:
            try:
                self.transport.abort()
            except (OSError, RuntimeError):
                pass
        self.transport = None
        # corked frames have nowhere to go once the socket is dead
        self._tx.reset()

        S.on(self, 'connectAsserted', lambda: S.goto_state('connecting'))

        def fail_stragglers():
            self.emit('close')
            # Fail any remaining outstanding requests or they would hang
            # forever (reference: lib/connection-fsm.js:338-350).
            # Their spans settle as 'abandoned': the op was evicted
            # from the pending table without a reply ever routing —
            # distinct from a request that saw a typed error — so the
            # ring can never hold an open span after teardown (the
            # chaos campaigns assert exactly that).
            err = ZKProtocolError('CONNECTION_LOSS', 'Connection closed.')
            reqs, self.reqs = self.reqs, {}
            for req in reqs.values():
                _finish_span(req, status='abandoned', error=err.code)
                req.emit('error', err)
        S.immediate(fail_stragglers)

    # -- request plumbing --

    def _sock_data(self, data: bytes) -> None:
        """Socket bytes -> 'sockData', via the fault schedule when an
        injector is installed (splits/delays/dups/mid-frame resets)."""
        if self.faults is None:
            self.emit('sockData', data)
        else:
            self.faults.rx(self, data)

    def _tx_write(self, data: bytes) -> None:
        """The send plane's sink: one coalesced buffer per flush."""
        if self.transport is not None:
            self.transport.write(data)

    def _write(self, pkt: dict) -> None:
        data = self.codec.encode(pkt)
        if self.faults is not None:
            # Per-frame fault boundary, BEFORE the cork: may truncate
            # the frame and schedule an injected reset.
            out = self.faults.tx(self, data)
            if out is None:
                return
            if out is not data:
                # A fault fired on this frame.  Its scheduled reset
                # lands next tick — deliver everything already corked
                # plus the truncated frame NOW, in stream order, so
                # the reset still targets exactly this frame (hard:
                # the batched transport tier must drain synchronously
                # or the direct write below would overtake it).
                self._tx.flush_hard()
                self._tx_write(out)
                return
        if self.transport is None:
            return
        self._tx.send(data)

    def process_reply(self, pkt: dict) -> None:
        """Route a reply to its pending request
        (reference: lib/connection-fsm.js:353-376)."""
        xid = pkt['xid']
        if xid > 0:
            # One reply settles a normal request; dropping it here
            # (rather than via per-request cleanup listeners) keeps the
            # map tight.  Reserved xids (PING/SET_WATCHES) stay: their
            # handlers manage piggybacking and pop themselves.
            req = self.reqs.pop(xid, None)
        else:
            req = self.reqs.get(xid)
        self.log.trace('server replied to xid %d err %s',
                       xid, pkt['err'])
        if req is None:
            return
        if pkt['err'] == 'OK':
            _finish_span(req, zxid=pkt.get('zxid'))
            req.emit('reply', pkt)
        else:
            _finish_span(req, zxid=pkt.get('zxid'), status='error',
                         error=pkt['err'])
            # the overloaded-member bounce gets its typed class so
            # the client's write path can key its backoff+retry on
            # isinstance instead of string-matching the code
            err = (ZKThrottledError()
                   if pkt['err'] == 'THROTTLED'
                   else ZKError(pkt['err']))
            req.emit('error', err, pkt)

    def request(self, pkt: dict) -> ZKRequest:
        """Send a normal (positive-xid) request
        (reference: lib/connection-fsm.js:384-408)."""
        if not self.is_in_state('connected'):
            raise ZKProtocolError('CONNECTION_LOSS',
                'Client must be connected to send requests')
        req = ZKRequest(pkt)
        pkt['xid'] = self.next_xid()
        self.reqs[pkt['xid']] = req
        self.log.trace('sent request xid %d opcode %s',
                       pkt['xid'], pkt['opcode'])
        self._write(pkt)
        return req

    def send(self, pkt: dict) -> None:
        """Raw send, used by the session for ConnectRequests
        (reference: lib/connection-fsm.js:410-413)."""
        self._write(pkt)

    def ping(self, cb: Callable | None = None) -> None:
        """Keep-alive ping on the reserved xid; concurrent pings
        piggyback on the in-flight one
        (reference: lib/connection-fsm.js:415-463)."""
        if not self.is_in_state('connected'):
            raise ZKProtocolError('CONNECTION_LOSS',
                'Client must be connected to send packets')
        pkt = {'xid': consts.XID_PING, 'opcode': 'PING'}
        existing = self.reqs.get(consts.XID_PING)
        if existing is not None:
            if cb:
                existing.once('reply', lambda _pkt: cb(None, None))
                existing.once('error', lambda err, *a: cb(err, None))
            return
        req = ZKRequest(pkt)
        self.reqs[consts.XID_PING] = req
        timeout_ms = max(self.session.get_timeout() / 8, 2000)
        loop = asyncio.get_running_loop()
        t1 = time.monotonic()

        def on_reply(rpkt):
            self.reqs.pop(consts.XID_PING, None)
            timer.cancel()
            latency = (time.monotonic() - t1) * 1000.0
            self.log.debug('ping ok in %d ms', latency)
            if cb:
                cb(None, latency)

        def on_error(err, *args):
            self.reqs.pop(consts.XID_PING, None)
            timer.cancel()
            if cb:
                cb(err, None)

        def on_timeout():
            req.remove_listener('reply', on_reply)
            self.emit('pingTimeout')

        req.once('reply', on_reply)
        req.once('error', on_error)
        timer = loop.call_later(timeout_ms / 1000.0, on_timeout)
        self._write(pkt)

    def set_watches(self, events: dict, rel_zxid: int,
                    cb: Callable,
                    opcode: str = 'SET_WATCHES') -> None:
        """Send SET_WATCHES on its reserved xid; a second call while one
        is in flight queues behind it
        (reference: lib/connection-fsm.js:465-499).  ``opcode`` selects
        the five-list SET_WATCHES2 variant when the session also
        replays persistent (ADD_WATCH) registrations."""
        if not self.is_in_state('connected'):
            raise ZKProtocolError('CONNECTION_LOSS',
                'Client must be connected to send packets (is in state %s)'
                % (self.get_state(),))
        pkt = {'xid': consts.XID_SET_WATCHES, 'opcode': opcode,
               'relZxid': rel_zxid, 'events': events}
        existing = self.reqs.get(consts.XID_SET_WATCHES)
        if existing is not None:
            existing.once('reply',
                lambda _pkt: self.set_watches(events, rel_zxid, cb,
                                              opcode))
            existing.once('error', lambda err, *a: cb(err))
            return
        req = ZKRequest(pkt)
        self.reqs[consts.XID_SET_WATCHES] = req

        def on_reply(rpkt):
            self.reqs.pop(consts.XID_SET_WATCHES, None)
            cb(None)

        def on_error(err, *args):
            self.reqs.pop(consts.XID_SET_WATCHES, None)
            cb(err)

        req.once('reply', on_reply)
        req.once('error', on_error)
        self._write(pkt)
