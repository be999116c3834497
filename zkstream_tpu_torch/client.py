"""The public client API.

``Client`` is the user-facing facade over the pool/connection/session
machinery (reference: lib/client.js:31-601): an event emitter
(``session``, ``connect``, ``disconnect``, ``expire``, ``failed``,
``close``) plus awaitable znode operations.  Where the reference's ops
take callbacks, these are coroutines; semantics are otherwise the same,
including ``create_with_empty_parents`` parent tolerance and the
deferred ``connect`` emission (the event only fires once the connection
is actually usable for requests).

Usage::

    client = Client(address='127.0.0.1', port=2181)
    client.start()
    await client.wait_connected()
    await client.create('/x', b'hello')
    data, stat = await client.get('/x')
    w = client.watcher('/x')
    w.on('dataChanged', lambda data, stat: ...)
    await client.close()
"""

from __future__ import annotations

import asyncio
import time

from .io.backoff import BackoffPolicy
from .io.connection import Backend, ZKConnection
from .io.pool import (
    DEFAULT_CONNECT_POLICY,
    DEFAULT_DECOHERENCE_INTERVAL,
    DEFAULT_POLICY,
    ConnectionPool,
    ReadPlane,
    Resolver,
    read_distribution_default,
    read_subset_default,
)
from .io.cache import CachePlane, cache_roots_default
from .io.session import ZKSession
from .io.watcher import ZKPersistentWatcher, ZKWatcher
from .io.overload import overload_enabled
from .protocol.consts import MAX_PACKET, CreateFlag
from .protocol.errors import ZKDeadlineError, ZKNotConnectedError, \
    ZKThrottledError
from .protocol.records import OPEN_ACL_UNSAFE, Stat
from .utils import trace as _trace
from .utils.aio import ambient_loop
from .utils.fsm import FSM, bind_transition_metrics
from .utils.logging import Logger
from .utils.metrics import Collector
from .utils.trace import OP_STAGES, TraceRing, bind_ring_metrics

METRIC_ZK_EVENT_COUNTER = 'zookeeper_events'
METRIC_ZK_DEGRADED_GAUGE = 'zookeeper_degraded'
METRIC_ZK_OP_LATENCY = 'zookeeper_op_latency_ms'
METRIC_ZK_OP_STAGE = 'zookeeper_op_stage_ms'

#: Op-stage buckets, ms: a send or an ingest hop takes microseconds, a
#: remote or resume stage up to seconds under load.
STAGE_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
                 10000.0)

#: Default session timeout, ms (reference: lib/client.js:80-83).
DEFAULT_SESSION_TIMEOUT = 30000

#: Default per-request deadline, ms.  Every znode op either completes
#: or raises a typed :class:`ZKDeadlineError` within this budget —
#: an op must never hang silently on a dead connection.  Pass
#: ``op_timeout=None`` (or ``deadline=None`` per op) for the old
#: unbounded behavior.
DEFAULT_OP_TIMEOUT = 30000

#: Sentinel: "no per-op override, use the client default".
_USE_DEFAULT = object()


class _SessionEvents:
    """A session's ``stateChanged`` listener on its client: the
    client's ``session`` and ``connect`` events at its first attach,
    ``connect``, ``disconnect`` and ``expire`` after."""

    __slots__ = ('client', 'attached')

    def __init__(self, client: 'Client'):
        self.client = client
        self.attached = False

    def __call__(self, st: str) -> None:
        client = self.client
        if st == 'attached':
            if not self.attached:
                self.attached = True
                client._emit_after_connected('session')
            client._emit_after_connected('connect')
        elif self.attached:
            if st == 'detached':
                client.emit('disconnect')
            elif st == 'expired':
                client.emit('expire')


class Client(FSM):
    def __init__(self, address: str | None = None, port: int = 2181,
                 servers: list[tuple[str, int] | dict] | None = None,
                 session_timeout: int = DEFAULT_SESSION_TIMEOUT,
                 collector: Collector | None = None,
                 connect_policy: BackoffPolicy = DEFAULT_CONNECT_POLICY,
                 default_policy: BackoffPolicy = DEFAULT_POLICY,
                 decoherence_interval: int = DEFAULT_DECOHERENCE_INTERVAL,
                 shuffle_backends: bool = True,
                 seed: int | None = None,
                 log: Logger | None = None,
                 ingest=None,
                 use_native_codec: bool | None = None,
                 on_fatal=None,
                 max_spares: int = 2,
                 op_timeout: int | None = DEFAULT_OP_TIMEOUT,
                 faults=None,
                 trace: TraceRing | None = None,
                 trace_capacity: int = 256,
                 cork: bool | None = None,
                 transport: str | None = None,
                 flush_cap: int | None = None,
                 read_distribution: bool | None = None,
                 read_subset: int | None = None,
                 resolver: Resolver | None = None,
                 max_frame: int | None = None,
                 cache: bool | str | list[str] | None = None):
        if servers is None:
            assert address is not None, 'address or servers[] required'
            backends = [Backend(address, port)]
        else:
            # Accept both (address, port) pairs and {'address', 'port'}
            # dicts — the reference's servers[] takes address/port
            # objects (reference: lib/client.js:63-76).
            backends = []
            for s in servers:
                if isinstance(s, dict):
                    backends.append(Backend(s['address'],
                                            int(s.get('port', port))))
                else:
                    a, p = s
                    backends.append(Backend(a, int(p)))

        # Injectable logger, like the reference's opts.log (reference:
        # lib/client.js:34-45); components derive context-accreting
        # children from it.
        self.log = Logger(log).child(component='ZKClient')

        #: Optional shared FleetIngest (io/ingest.py): when set, this
        #: client's connections drain through the batched device decode
        #: pipeline instead of per-socket scalar codecs.  Many clients
        #: may share one ingest — that is the point.
        self.ingest = ingest
        #: Frame-scanner selection for this client's connections:
        #: None = auto (native if built), True = force C++, False =
        #: force pure Python (benchmarks, A/B tests).
        self.use_native_codec = use_native_codec
        #: Inbound frame cap for this client's connections (README
        #: "Overload plane"): a reply whose length prefix exceeds it
        #: raises :class:`ZKFrameTooLargeError` before any buffering.
        #: None = env resolution (``ZKSTREAM_MAX_FRAME`` / the wire
        #: default); with ``ZKSTREAM_NO_OVERLOAD=1`` the cap pins to
        #: the legacy MAX_PACKET so byte streams stay bit-identical.
        self.max_frame = (max_frame if max_frame is not None
                          else (None if overload_enabled()
                                else MAX_PACKET))
        #: Outbound write coalescing for this client's connections
        #: (io/sendplane.py): None = process default (on unless
        #: ZKSTREAM_NO_CORK=1), True/False force a path (benchmarks,
        #: A/B tests).
        self.cork = cork
        #: Early-flush cap override for this client's send planes
        #: (None = ZKSTREAM_FLUSH_CAP / the 256 KiB default).
        self.flush_cap = flush_cap
        #: Optional crash-on-bug policy override: called with the
        #: exception after session teardown instead of the loud default
        #: (loop exception handler).  See ZKSession.fatal_error.
        self.on_fatal = on_fatal

        #: Optional FaultInjector (io/faults.py): threaded to every
        #: connection this client dials; None in production.
        self.faults = faults
        #: Per-request deadline, ms (None = unbounded).  Ops exceeding
        #: it raise :class:`ZKDeadlineError` instead of hanging.
        self.op_timeout = op_timeout

        self.collector = collector if collector is not None else Collector()
        #: Batched-syscall transport tier for this client's
        #: connections (io/transport.py): None when the resolved
        #: backend is 'asyncio' (the legacy per-plane writes).
        #: ``transport=`` forces a tier ('uring'|'mmsg'|'asyncio');
        #: None = the ZKSTREAM_TRANSPORT / capability-probe default.
        from .io.transport import make_tier
        self.transport_tier = make_tier(transport,
                                        collector=self.collector,
                                        plane='client')
        self.collector.counter(METRIC_ZK_EVENT_COUNTER,
            'Total number of zookeeper events')
        #: Per-op latency distribution, labelled by opcode; recorded by
        #: _await_op on every completion path (ok, error, deadline).
        self._op_latency = self.collector.histogram(
            METRIC_ZK_OP_LATENCY,
            'Client op round-trip latency, milliseconds, by opcode')
        #: ``_op_latency``'s series by opcode, each resolved at its
        #: first op (no label dict or key built an op after that).
        self._op_latency_series: dict = {}
        #: The same latency split into its stages (utils/trace.py,
        #: ``Span.stage_ms``), one series a stage resolved here.
        self._op_stages = self.collector.histogram(
            METRIC_ZK_OP_STAGE,
            'Client op latency by stage, milliseconds (send | remote | '
            'ingest | resume)', buckets=STAGE_BUCKETS).rows('stage',
                                                           OP_STAGES)
        #: Bounded in-memory span ring (utils/trace.py): one span per
        #: op, xid-correlated through the connection and stamped with
        #: the reply zxid.  Injectable so chaos campaigns and tests can
        #: dump it on failure.
        self.trace = trace if trace is not None else TraceRing(
            trace_capacity)
        bind_ring_metrics(self.trace, self.collector)
        #: Optional per-op completion hook: called with the settled
        #: Span after EVERY completion path (reply, typed error,
        #: deadline), in completion order.  The chaos campaigns'
        #: history engine (io/invariants.py) subscribes here so the
        #: recorded history cannot diverge from what the client
        #: actually observed; None in production.
        self.on_op = None

        self.session_timeout = session_timeout
        self.session: ZKSession | None = None
        self.old_session: ZKSession | None = None
        self._retry_policy = default_policy
        self._seed = seed

        self.pool = ConnectionPool(
            self, backends,
            connect_policy=connect_policy,
            default_policy=default_policy,
            decoherence_interval=decoherence_interval,
            shuffle=shuffle_backends, seed=seed,
            max_spares=max_spares)

        #: Client-side read scale-out (README "Read plane"): with
        #: more than one backend, get/exists/getACL/list fan out over
        #: per-backend read sessions while writes, watches and sync
        #: stay on the primary session — zxid-gated so the session
        #: view never goes backwards (io/pool.py ReadPlane).  None =
        #: process default (``ZKSTREAM_READ_DISTRIBUTION=1`` enables).
        enabled_reads = (read_distribution_default()
                         if read_distribution is None
                         else read_distribution)
        #: Live member list (io/pool.py Resolver, README "Dynamic
        #: membership"): ``update_backends()`` adopts a post-reconfig
        #: fleet; the read plane rebalances its dialed subset on the
        #: change while the primary session drains in place.
        self.resolver = (resolver if resolver is not None
                         else Resolver(backends))
        self.resolver.on('changed', self._on_backends_changed)
        #: Read-plane subset cap: dial at most K read sessions from
        #: the live config (None = one per backend; process default
        #: via ``ZKSTREAM_READ_SUBSET``).
        subset = (read_subset_default() if read_subset is None
                  else (read_subset if read_subset > 0 else None))
        self._read_plane = (ReadPlane(self, backends, subset=subset,
                                      resolver=self.resolver)
                            if enabled_reads and len(backends) > 1
                            else None)
        #: The newest member zxid any DISTRIBUTED read has shown this
        #: client (the primary session's own floor lives in
        #: ``session.last_zxid``); :meth:`last_seen_zxid` is the max.
        self._read_floor = 0
        #: Watch-backed client cache (io/cache.py, README "Client
        #: cache plane"): ``cache=`` names the subtree root(s) to
        #: subscribe (True = '/'); None = env resolution
        #: (``ZKSTREAM_CACHE``); ``ZKSTREAM_NO_CACHE=1`` kills it.
        #: The ctor beats the env, like every other knob ladder.
        if cache is None:
            roots = cache_roots_default()
        elif cache is True:
            roots = ['/']
        elif cache is False:
            roots = None
        elif isinstance(cache, str):
            roots = [cache]
        else:
            roots = list(cache)
        self.cache = (CachePlane(self, roots,
                                 collector=self.collector)
                      if roots else None)
        self.pool.on('stateChanged', self._on_pool_state_changed)
        # Degraded-mode surface: re-emit the pool's circuit-breaker
        # edges on the client, count them, and expose the current state
        # as a pull gauge (1 = all backends failing, parked in monitor
        # mode; 0 = healthy).
        self.pool.on('degraded', self._on_degraded)
        self.pool.on('recovered', self._on_recovered)
        try:
            self.collector.gauge(
                METRIC_ZK_DEGRADED_GAUGE, self._degraded_gauge,
                'Client degraded mode (1 = all backends failing)')
        except ValueError:
            # Shared collector across clients: the first registrant's
            # pool owns the series.
            pass

        # FSM observability (utils/fsm.py): transition counters + a
        # live current-state gauge for the client machine and the pool;
        # the session and every connection bind themselves.
        self.bind_fsm_metrics(self.collector, 'ZKClient')
        bind_transition_metrics(self.pool, self.collector,
                                'ConnectionPool')

        self._started = False
        super().__init__('normal')

    # The listeners the client registers for itself are its methods:
    # a bound method is one object, where a closure takes three.

    def _on_backends_changed(self, backends) -> None:
        self.pool.set_backends(backends)

    def _on_degraded(self) -> None:
        self._emit_tracked('degraded')

    def _on_recovered(self) -> None:
        self._emit_tracked('recovered')

    def _degraded_gauge(self) -> float:
        return 1.0 if self.pool.degraded else 0.0

    # -- lifecycle (reference: lib/client.js:127-215) --

    def state_normal(self, S) -> None:
        self._new_session()
        S.goto_on(self, 'closeAsserted', 'closing')

    def state_closing(self, S) -> None:
        """Close the session first — its closing state drains the
        connection and sends CLOSE_SESSION, which is what deletes
        ephemerals immediately instead of at expiry — then stop the
        pool before it can redial (reference: lib/client.js:135-177
        shuts session/set/resolver down concurrently and relies on the
        session winning the race; sequencing makes it deterministic)."""
        if self.session.is_in_state('closed') or \
           self.session.is_in_state('expired'):
            self._closing_done()
            return
        S.on(self.session, 'stateChanged', self._on_closing_session)
        self.session.close()

    def _closing_done(self) -> None:
        S = self._scope
        self.pool.stop()
        S.goto_state('closed')

    def _on_closing_session(self, st) -> None:
        if st in ('closed', 'expired'):
            self._closing_done()

    def state_closed(self, S) -> None:
        self.emit('close')

    def start(self) -> None:
        """Begin connecting.  Separate from __init__ so the caller
        controls which running event loop the client binds to (the
        reference starts its resolver in the constructor)."""
        assert not self._started, 'client already started'
        self._started = True
        self.pool.start()
        if self._read_plane is not None:
            self._read_plane.start()
        if self.cache is not None:
            self.cache.start()

    async def close(self) -> None:
        """Close the session cleanly and stop the pool."""
        if self.is_in_state('closed'):
            return
        loop = ambient_loop()
        fut: asyncio.Future = loop.create_future()
        self.once('close', lambda: fut.done() or fut.set_result(None))
        self.emit('closeAsserted')
        await fut
        if self.cache is not None:
            self.cache.close()
        if self._read_plane is not None:
            await self._read_plane.close()
        if self.transport_tier is not None:
            # release the tier's ring fd with the client instead of
            # waiting on cyclic GC (the plane/entry closures keep the
            # tier in a cycle); a reused client lazily re-creates it
            self.transport_tier.close()

    def update_backends(self, backends) -> bool:
        """Adopt a new live member list (README "Dynamic
        membership"): Backend objects or (address, port) pairs.
        The read plane rebalances its dialed subset immediately; the
        primary session stays where it is until its connection dies,
        then redials against the updated list.  Returns True when the
        membership actually changed."""
        return self.resolver.update(backends)

    # -- session management (reference: lib/client.js:187-273) --

    def _new_session(self) -> None:
        if not self.is_in_state('normal'):
            return
        s = ZKSession(self.session_timeout, self.collector, log=self.log,
                      retry_policy=self._retry_policy, seed=self._seed,
                      trace=self.trace)
        prev = self.session
        carried = max(
            (prev.last_zxid if prev is not None else 0),
            (prev.gate_floor if prev is not None else 0),
            self._read_floor)
        if carried > s.gate_floor:
            # client-level floor carry: a REPLACEMENT session (the old
            # one expired) must not read below what this client has
            # already observed — on ANY of its connections, the read
            # plane's included.  The handshake presents the floor as
            # lastZxidSeen, seeding the server-side zxid read gate
            # (server/server.py ReadGate); it rides gate_floor, not
            # last_zxid, so SET_WATCHES relZxid semantics are
            # untouched.
            s.gate_floor = carried
        s.fatal_handler = self.on_fatal
        self.session = s
        s.on('fatalError', self._on_session_fatal)
        s.on('stateChanged', _SessionEvents(self))

    def _on_session_fatal(self, exc) -> None:
        # Crash-on-bug escalation from the session's self-checks
        # (missed wakeup, unmatched notification): surface as the
        # terminal 'failed' event; the session teardown follows as
        # 'expire' (reference crashes the process outright,
        # lib/zk-session.js:916-919).
        self._event_track('failed')
        self.emit('failed', exc)

    def get_session(self) -> ZKSession | None:
        """The live session; a session that expired or closed is lazily
        replaced (reference: lib/client.js:264-273)."""
        if not self.is_in_state('normal'):
            return None
        if self.session.is_in_state('expired') or \
           self.session.is_in_state('closed'):
            self.old_session = self.session
            self._new_session()
        return self.session

    def _event_track(self, evt: str) -> None:
        if evt in ('session', 'connect', 'failed', 'degraded',
                   'recovered'):
            self.collector.get_collector(
                METRIC_ZK_EVENT_COUNTER).increment({'evtype': evt})

    def _emit_tracked(self, evt: str) -> None:
        self._event_track(evt)
        self.emit(evt)

    def is_degraded(self) -> bool:
        """True while the circuit breaker is open: every backend
        failed the full retry policy and the pool is parked in
        jittered monitor-mode redial."""
        return self.pool.degraded

    def _emit_after_connected(self, evt: str) -> None:
        """Defer an event until the connection can actually serve
        requests (reference: lib/client.js:237-262)."""
        conn = self.current_connection()
        if conn is None:
            return
        loop = ambient_loop()
        if conn.is_in_state('connected'):
            def fire():
                self._event_track(evt)
                self.emit(evt)
            loop.call_soon(fire)
        else:
            def on_conn_ch(cst):
                if cst == 'connected':
                    conn.remove_listener('stateChanged', on_conn_ch)
                    self._event_track(evt)
                    self.emit(evt)
            conn.on('stateChanged', on_conn_ch)

    def _on_pool_state_changed(self, st: str) -> None:
        if st == 'failed':
            def fire():
                self._event_track('failed')
                self.emit('failed', ZKNotConnectedError())
            ambient_loop().call_soon(fire)

    # -- connection access --

    def current_connection(self) -> ZKConnection | None:
        sess = self.get_session()
        if sess is None:
            return None
        return sess.get_connection()

    def is_connected(self) -> bool:
        conn = self.current_connection()
        return conn is not None and conn.is_in_state('connected')

    async def wait_connected(self, timeout: float | None = None,
                             fail_fast: bool = True) -> None:
        """Wait until the client is usable.

        Contract for ``failed``: it is an **edge event**, not a terminal
        state — it fires once when the initial retry policy exhausts on
        every backend, after which the pool keeps dialing forever in
        monitor mode (cueball's failed-state semantics, reference:
        lib/client.js:96-111) and may still recover.  With the default
        ``fail_fast=True`` this method surfaces the exhaustion as
        :class:`ZKNotConnectedError` — immediately if the pool is
        already in monitor mode, or on the ``failed`` edge while
        waiting.  With ``fail_fast=False`` policy exhaustion is ignored
        and the wait rides monitor mode until a connection lands or
        ``timeout`` expires (``asyncio.TimeoutError``)."""
        if self.is_connected():
            return
        if fail_fast and self.pool.state == 'failed':
            # 'failed' is edge-triggered; a pool already in monitor mode
            # will not re-emit it, so report the failure immediately.
            raise ZKNotConnectedError()
        loop = ambient_loop()
        fut: asyncio.Future = loop.create_future()

        def on_connect():
            if not fut.done():
                fut.set_result(None)

        def on_failed(err):
            if fail_fast and not fut.done():
                fut.set_exception(err)
        self.on('connect', on_connect)
        self.on('failed', on_failed)
        try:
            await asyncio.wait_for(fut, timeout)
        finally:
            self.remove_listener('connect', on_connect)
            self.remove_listener('failed', on_failed)

    def _conn_or_raise(self) -> ZKConnection:
        conn = self.current_connection()
        if conn is None or not conn.is_in_state('connected'):
            raise ZKNotConnectedError()
        return conn

    @staticmethod
    def _check_path(path) -> None:
        """Argument validation, matching the reference's assert-plus
        throws on bad inputs (reference: test/nasty.test.js:197-221)."""
        if not isinstance(path, str):
            raise TypeError('path must be a str, got %r' % (type(path),))
        if not path.startswith('/'):
            raise ValueError('path must start with /: %r' % (path,))

    @staticmethod
    def _check_data(data) -> None:
        if not isinstance(data, (bytes, bytearray, memoryview)):
            raise TypeError('data must be bytes, got %r' % (type(data),))

    @staticmethod
    def _check_version(version) -> None:
        # bool is an int subclass; a True/False version is always a
        # programmer error, not version 1/0.
        if not isinstance(version, int) or isinstance(version, bool):
            raise TypeError('version must be an int, got %r'
                            % (type(version),))

    # -- operations (reference: lib/client.js:318-601) --

    def _start_op(self, conn: ZKConnection, pkt: dict) -> tuple:
        """Send one traced request: the span is created before the
        write, correlated by the xid the connection assigns, and closed
        by the connection's reply/error routing (io/connection.py) with
        the reply zxid stamped on.

        A request that never makes it into the pending table (the
        connection died between the liveness check and the send) must
        not leave its span open — the ring would report a phantom
        in-flight op forever; it settles as ``abandoned`` and the
        error propagates."""
        span = self.trace.start(pkt['opcode'], pkt.get('path'))
        try:
            req = conn.request(pkt, span)
        except BaseException as e:
            span.finish(status='abandoned',
                        error=getattr(e, 'code', None)
                        or type(e).__name__)
            raise
        span.xid = pkt['xid']
        span.backend = conn.backend.key
        if conn.session is not None:
            # the request is already pending here, so the connection
            # settles this span on every teardown path; the getter
            # below cannot raise past it
            span.session_id = conn.session.get_session_id()
        return req.as_future(), span

    async def _await_op(self, fut: asyncio.Future, opcode: str,
                        path: str | None, deadline, span=None) -> dict:
        """Bound one request future by the per-request deadline.

        ``deadline`` is the per-op override in ms (``_USE_DEFAULT`` =
        the client's ``op_timeout``; ``None`` = unbounded).  On expiry
        the op fails fast with a typed :class:`ZKDeadlineError` instead
        of hanging on a dead or wedged connection; the underlying
        request is cancelled for the caller, and the connection's
        teardown paths still settle it exactly once internally.

        Every completion path (reply, error, deadline) records the
        elapsed time into the per-op latency histogram: from the span's
        call stamp to the resumption here, which ends the op's stages
        (each observed where the op reached it)."""
        ms = self.op_timeout if deadline is _USE_DEFAULT else deadline
        t0 = span._t0 if span is not None else time.perf_counter()
        if _trace.profiler_ranges:
            _trace.op_switch(None)      # the op's synchronous head ends
        try:
            if ms is None:
                return await fut
            try:
                return await asyncio.wait_for(fut, ms / 1000.0)
            except asyncio.TimeoutError:
                if span is not None:
                    span.finish(status='deadline',
                                error='DEADLINE_EXCEEDED')
                raise ZKDeadlineError(opcode, path, ms) from None
        finally:
            t = time.perf_counter()
            if _trace.profiler_ranges:
                _trace.op_switch('zk.reply')
            series = self._op_latency_series.get(opcode)
            if series is None:
                series = self._op_latency_series[opcode] = \
                    self._op_latency.series({'op': opcode})
            series.observe((t - t0) * 1000.0)
            if span is not None:
                span.t_resumed = t
                span.restamp()
                self._op_stages.observe_each(span.stage_ms())
                if self.on_op is not None:
                    self.on_op(span)

    # -- the read plane (README "Read plane") --

    def last_seen_zxid(self) -> int:
        """The newest member zxid this client has provably observed,
        across the primary session (write acks, reads, notifications
        — io/session.py tracks every reply header) and the read
        plane's distributed replies.  The client-side zxid gate
        compares every distributed read's reply header against it."""
        sess = self.session
        sess_z = 0 if sess is None else max(sess.last_zxid,
                                            sess.gate_floor)
        return max(sess_z, self._read_floor)

    async def _primary_request(self, pkt: dict, opcode: str,
                               path: str | None, deadline) -> dict:
        """One request on the primary connection (the legacy path):
        returns the full reply packet."""
        rng = _trace.profiler_ranges and _trace.op_open()
        try:
            conn = self._conn_or_raise()
            fut, span = self._start_op(conn, pkt)
            return await self._await_op(fut, opcode, path, deadline,
                                        span)
        finally:
            if rng:
                _trace.op_switch(None)

    async def _write_op(self, pkt: dict, opcode: str,
                        path: str | None, deadline) -> dict:
        """One write on the primary connection, retrying THROTTLED
        bounces (README "Overload plane").

        An overloaded member bounces new writes with a typed
        :class:`ZKThrottledError` BEFORE proposing them — the write
        provably did not happen, so a blind resend is safe (no
        at-most-once concern, unlike a timeout).  The retry backs off
        on the client's default policy (capped exponential, full
        jitter) and gives up with the last THROTTLED error once the
        policy's attempt budget is spent.  Each attempt re-resolves
        the connection and sends a FRESH packet dict — ``_start_op``
        stamps the xid into it, and a retried xid would collide in
        the pending table."""
        backoff = None
        while True:
            try:
                return await self._primary_request(dict(pkt), opcode,
                                                   path, deadline)
            except ZKThrottledError:
                if backoff is None:
                    backoff = self._retry_policy.backoff(
                        seed=self._seed)
                if backoff.attempt >= self._retry_policy.retries:
                    raise
                delay_ms = backoff.next_delay()
                self.log.debug('THROTTLED %s %s; retry %d in %dms',
                               opcode, path, backoff.attempt,
                               delay_ms)
                await asyncio.sleep(delay_ms / 1000.0)

    def _note_read_floor(self, zxid: int) -> None:
        """A distributed read showed the client member state at
        ``zxid``: raise the client floor AND the session's gate
        floor, so the next handshake (migration, replacement) seeds
        the server-side ReadGate with everything this client has
        seen — on any of its connections."""
        if zxid > self._read_floor:
            self._read_floor = zxid
        sess = self.session
        if sess is not None and zxid > sess.gate_floor:
            sess.gate_floor = zxid

    async def _read_request(self, pkt: dict, opcode: str,
                            path: str | None, deadline) -> dict:
        """Route one read: through the read plane when enabled —
        zxid-gated, so a reply from a member behind this client's
        floor (re-checked at REPLY time: a write acked while the
        read was in flight raises it) is DISCARDED and the read
        re-issued on the primary connection (never surfaced stale) —
        else the primary.  Any read-session failure (typed error,
        deadline, not-connected) also falls back to the primary: the
        distributed path may add a retry's latency, never a new
        failure mode.  The primary fallback is floor-guarded too:
        when its member trails what the plane already showed this
        client (possible inside one connection — the handshake seed
        only covers floors known at attach time), a ``sync`` barrier
        catches the member up and the read re-issues once.

        The cache plane (README "Client cache plane") consults FIRST:
        a read under a subscribed, coherent subtree returns locally —
        no wire round trip at all — and every server reply that does
        go out deposits back in, read-through."""
        cache = self.cache
        if cache is not None and path is not None:
            out = cache.lookup(opcode, path)
            if out is not None:
                # a cached serve is still one observed op: it lands
                # in the span ring (and the campaign history via
                # on_op) like any server read, flagged 'cached'
                span = self.trace.start(opcode, path)
                span.detail = 'cached'
                span.finish(zxid=out.get('zxid'))
                if self.on_op is not None:
                    self.on_op(span)
                return out
        plane = self._read_plane
        if plane is not None and plane.started:
            primary = self.pool.current_backend()
            sub = plane.pick(primary.key if primary is not None
                             else None)
            if sub is not None:
                try:
                    out = await sub._primary_request(
                        dict(pkt), opcode, path, deadline)
                except (ZKNotConnectedError, ZKDeadlineError):
                    plane.fallbacks += 1
                except Exception as e:
                    from .protocol.errors import (
                        ZKError,
                        ZKProtocolError,
                    )
                    if not isinstance(e, (ZKError, ZKProtocolError,
                                          OSError)):
                        raise
                    # a spec verdict off a possibly-stale member
                    # (error replies carry no state to gate on) or
                    # connection churn: the primary's answer is the
                    # contract
                    plane.fallbacks += 1
                else:
                    if out.get('zxid', 0) >= self.last_seen_zxid():
                        plane.distributed += 1
                        self._note_read_floor(out['zxid'])
                        return out
                    plane.bounced += 1   # stale member: never surface
        out = await self._primary_request(pkt, opcode, path, deadline)
        if plane is not None \
                and out.get('zxid', 0) < self._read_floor \
                and path is not None:
            # the primary's member trails the plane's floor: sync is
            # the bounded barrier (the member applies everything the
            # leader committed — which includes every zxid any member
            # ever showed this client), then the read re-issues fresh
            plane.bounced += 1
            await self._primary_request(
                {'opcode': 'SYNC', 'path': path}, 'SYNC', path,
                deadline)
            out = await self._primary_request(pkt, opcode, path,
                                              deadline)
        if cache is not None and path is not None:
            cache.fill(opcode, path, out)
        return out

    async def ping(self, deadline=_USE_DEFAULT) -> float:
        """Round-trip a ping; resolves to the latency in ms."""
        conn = self._conn_or_raise()
        loop = ambient_loop()
        fut: asyncio.Future = loop.create_future()
        span = self.trace.start('PING')
        span.backend = conn.backend.key

        def cb(err, latency):
            if fut.done():
                return
            if err is not None:
                span.finish(status='error',
                            error=getattr(err, 'code', None)
                            or type(err).__name__)
                fut.set_exception(err)
            else:
                span.finish()
                fut.set_result(latency)
        try:
            conn.ping(cb)
        except BaseException as e:
            # never sent: settle the span (see _start_op)
            span.finish(status='abandoned',
                        error=getattr(e, 'code', None)
                        or type(e).__name__)
            raise
        # ping's head is short: the op range covers its await's edges
        rng = _trace.profiler_ranges and _trace.op_open()
        try:
            return await self._await_op(fut, 'PING', None, deadline,
                                        span)
        finally:
            if rng:
                _trace.op_switch(None)

    async def list(self, path: str,
                   deadline=_USE_DEFAULT) -> tuple[list[str], Stat]:
        """Children of a znode, with its stat."""
        self._check_path(path)
        pkt = await self._read_request(
            {'opcode': 'GET_CHILDREN2', 'path': path, 'watch': False},
            'GET_CHILDREN2', path, deadline)
        return pkt['children'], pkt['stat']

    async def get(self, path: str,
                  deadline=_USE_DEFAULT) -> tuple[bytes, Stat]:
        self._check_path(path)
        pkt = await self._read_request(
            {'opcode': 'GET_DATA', 'path': path, 'watch': False},
            'GET_DATA', path, deadline)
        return pkt['data'], pkt['stat']

    async def create(self, path: str, data: bytes,
                     acl=None, flags: CreateFlag | int = 0,
                     deadline=_USE_DEFAULT) -> str:
        """Create a znode; resolves to the created path (which differs
        from the request path for SEQUENTIAL nodes)."""
        self._check_path(path)
        self._check_data(data)
        if acl is None:
            acl = list(OPEN_ACL_UNSAFE)
        pkt = await self._write_op({'opcode': 'CREATE', 'path': path,
                                    'data': data, 'acl': acl,
                                    'flags': CreateFlag(flags)},
                                   'CREATE', path, deadline)
        return pkt['path']

    async def create_with_empty_parents(self, path: str, data: bytes,
                                        acl=None,
                                        flags: CreateFlag | int = 0,
                                        deadline=_USE_DEFAULT) -> str:
        """Create a znode, creating any missing parents as plain
        persistent nodes with data b'null'; NODE_EXISTS on a parent is
        fine, on the leaf it is an error.  Options apply only to the
        leaf (reference: lib/client.js:412-481)."""
        from .protocol.errors import ZKError

        self._check_path(path)
        self._check_data(data)
        nodes = path.split('/')[1:]
        current = ''
        result = None
        for i, node in enumerate(nodes):
            current = current + '/' + node
            last = (i == len(nodes) - 1)
            try:
                result = await self.create(
                    current,
                    data if last else b'null',
                    acl=acl if last else None,
                    flags=flags if last else 0,
                    deadline=deadline)
            except ZKError as e:
                if last or e.code != 'NODE_EXISTS':
                    raise
        return result

    async def set(self, path: str, data: bytes,
                  version: int = -1, deadline=_USE_DEFAULT) -> Stat:
        """Set a znode's data; resolves to the new stat.  (The reference
        passes its callback a path field SET_DATA replies do not carry,
        lib/client.js:503-504 — the stat is the useful payload.)"""
        self._check_path(path)
        self._check_data(data)
        self._check_version(version)
        pkt = await self._write_op({'opcode': 'SET_DATA',
                                    'path': path, 'data': data,
                                    'version': version},
                                   'SET_DATA', path, deadline)
        return pkt['stat']

    async def delete(self, path: str, version: int,
                     deadline=_USE_DEFAULT) -> None:
        self._check_path(path)
        self._check_version(version)
        await self._write_op({'opcode': 'DELETE', 'path': path,
                              'version': version},
                             'DELETE', path, deadline)

    async def stat(self, path: str, deadline=_USE_DEFAULT) -> Stat:
        self._check_path(path)
        pkt = await self._read_request(
            {'opcode': 'EXISTS', 'path': path, 'watch': False},
            'EXISTS', path, deadline)
        return pkt['stat']

    async def get_acl(self, path: str, deadline=_USE_DEFAULT):
        self._check_path(path)
        pkt = await self._read_request(
            {'opcode': 'GET_ACL', 'path': path},
            'GET_ACL', path, deadline)
        return pkt['acl']

    async def sync(self, path: str, deadline=_USE_DEFAULT) -> None:
        """Flush the leader pipeline to the connected server
        (reference: lib/client.js:578-597).

        With the read plane on this is a REAL leader barrier for
        read-your-writes across sessions: the serving member applies
        everything the leader committed before replying, the reply
        header stamps that position into the session floor, and every
        later distributed read is zxid-gated above it — so state
        another session wrote before this sync can never be missed by
        a follower- or observer-served read afterwards."""
        self._check_path(path)
        await self._primary_request(
            {'opcode': 'SYNC', 'path': path}, 'SYNC', path, deadline)

    async def multi(self, ops: list, deadline=_USE_DEFAULT) -> list:
        """One all-or-nothing MULTI transaction (opcode 14): ``ops``
        is a list of sub-op dicts — ``{'op': 'create', 'path', 'data',
        'acl'?, 'flags'?}``, ``{'op': 'delete', 'path', 'version'?}``,
        ``{'op': 'set_data', 'path', 'data', 'version'?}``,
        ``{'op': 'check', 'path', 'version'}`` — applied as ONE server
        transaction sharing one WAL record and one group-fsync slot
        (server/store.py ``ZKDatabase.multi``).  Resolves to the
        per-op results in order (created path / new Stat / None);
        raises :class:`~.protocol.errors.ZKMultiError` when the batch
        was rejected — then NO sub-op was applied.

        :meth:`transaction` is the builder-style sugar over this."""
        from .protocol.errors import ZKMultiError
        from .protocol.records import MULTI_OPS

        wire_ops = []
        for op in ops:
            name = op.get('op')
            if name not in MULTI_OPS:
                raise ValueError('unsupported multi sub-op %r'
                                 % (name,))
            self._check_path(op['path'])
            sub = {'op': name, 'path': op['path']}
            if name == 'create':
                self._check_data(op.get('data', b''))
                sub['data'] = op.get('data', b'')
                sub['acl'] = (list(op['acl']) if op.get('acl')
                              else list(OPEN_ACL_UNSAFE))
                sub['flags'] = CreateFlag(op.get('flags', 0))
            elif name == 'set_data':
                self._check_data(op['data'])
                self._check_version(op.get('version', -1))
                sub['data'] = op['data']
                sub['version'] = op.get('version', -1)
            else:                     # delete / check
                self._check_version(op.get('version', -1))
                sub['version'] = op.get('version', -1)
            wire_ops.append(sub)
        pkt = await self._write_op({'opcode': 'MULTI',
                                    'ops': wire_ops},
                                   'MULTI', None, deadline)
        results = pkt['results']
        if any(r['op'] == 'error' for r in results):
            raise ZKMultiError(results)
        out: list = []
        for r in results:
            if r['op'] == 'create':
                out.append(r['path'])
            elif r['op'] == 'set_data':
                out.append(r['stat'])
            else:
                out.append(None)
        return out

    def transaction(self) -> 'Transaction':
        """A builder for one MULTI transaction::

            t = client.transaction()
            t.create('/a', b'x').set('/b', b'y').delete('/old')
            results = await t.commit()
        """
        return Transaction(self)

    def watcher(self, path: str) -> ZKWatcher:
        self._check_path(path)
        sess = self.get_session()
        if sess is None:
            # The client is closing or closed.
            raise ZKNotConnectedError()
        return sess.watcher(path)

    async def add_watch(self, path: str, recursive: bool = False,
                        deadline=_USE_DEFAULT) -> ZKPersistentWatcher:
        """Arm a persistent watch (ADD_WATCH, opcode 106) on ``path``
        — ``recursive=True`` for PERSISTENT_RECURSIVE, matching the
        whole subtree.  Resolves to the session's
        :class:`~.io.watcher.ZKPersistentWatcher` emitter: unlike
        :meth:`watcher`'s one-shot engine it survives fires with no
        re-arm read, and it replays across reconnects via
        SET_WATCHES2.  The registration is made BEFORE the round
        trip, so even if the arm races a disconnect the next
        reconnect's replay arms it — the returned emitter is live
        either way (the raised error tells the caller the first arm
        did not confirm)."""
        self._check_path(path)
        sess = self.get_session()
        if sess is None:
            raise ZKNotConnectedError()
        w = sess.persistent_watcher(path, recursive)
        await self._primary_request(
            {'opcode': 'ADD_WATCH', 'path': path,
             'mode': 1 if recursive else 0},
            'ADD_WATCH', path, deadline)
        return w

    def remove_persistent_watch(self, path: str) -> None:
        """Drop a persistent registration client-side.  The
        server-side subscription dies with the connection's next
        reconnect (it is simply not replayed); there is no wire op
        to remove it eagerly, matching the reference's lack of
        checkWatches support."""
        self._check_path(path)
        sess = self.get_session()
        if sess is not None:
            sess.drop_persistent_watcher(path)


class Transaction:
    """Builder sugar over :meth:`Client.multi` (the kazoo/Curator
    transaction shape): queue sub-ops, then ``await commit()`` — the
    whole batch applies as one server transaction or not at all."""

    def __init__(self, client: Client):
        self._client = client
        self.ops: list[dict] = []

    def create(self, path: str, data: bytes = b'', acl=None,
               flags: CreateFlag | int = 0) -> 'Transaction':
        self.ops.append({'op': 'create', 'path': path, 'data': data,
                         'acl': acl, 'flags': flags})
        return self

    def set(self, path: str, data: bytes,
            version: int = -1) -> 'Transaction':
        self.ops.append({'op': 'set_data', 'path': path, 'data': data,
                         'version': version})
        return self

    def delete(self, path: str, version: int = -1) -> 'Transaction':
        self.ops.append({'op': 'delete', 'path': path,
                         'version': version})
        return self

    def check(self, path: str, version: int) -> 'Transaction':
        self.ops.append({'op': 'check', 'path': path,
                         'version': version})
        return self

    async def commit(self, deadline=_USE_DEFAULT) -> list:
        return await self._client.multi(self.ops, deadline=deadline)
