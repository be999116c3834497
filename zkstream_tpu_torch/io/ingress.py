"""Shared-nothing ingress: per-core accept shards + batched receive
drain beneath the unchanged request-dispatch path.

The send path leaves the kernel as one submission chain per corked
tick (io/transport.py), but ingress was still ONE ``asyncio.start_server``
loop doing one ``reader.read()`` task wakeup per connection per tick —
and the tick ledger (PROFILE.md "Where a busy tick goes") says
decode+dispatch eats the majority of every busy tick at every
write-heavy fleet size.  At 10k+ live sessions the per-connection
stream machinery (protocol ``data_received`` → ``StreamReader`` feed →
task wakeup → ``read()`` copy) is the real ceiling: O(connections)
Python-level wakeups and buffer hops per tick before a single request
byte is decoded.  Same thesis as the transport tier — PAPERS.md's
RPCAcc / transparent-InfiniBand-under-netty line batches beneath an
unchanged API — applied to the receive direction.

Two halves, built together:

**Accept shards.**  The listening endpoint becomes N shards over the
one replicated store — ``SO_REUSEPORT`` listeners where the kernel
supports it (the kernel then spreads incoming connections across the
shard listeners by 4-tuple hash), a single-listener round-robin
dispatcher handoff elsewhere.  A connection's shard is its affinity
key for the whole serving plane: its watch-table fan-out shard, its
fan-out buffer, and its send-plane cork all key off the same shard
(server/watchtable.py ``add_conn``), so one connection's state never
crosses shards on the hot path.  Writes still serialize through the
one leader store (the lock-guarded apply, zxid order preserved) and
the fsync/quorum ``CommitBarrier`` stays ONE barrier per tick across
every shard — sharding the ingress never weakens the ack contract.

**Batched receive drain.**  Accepted sockets are adopted with their
transport's reading PAUSED; the plane registers its own readiness
callback per fd.  A readable connection marks itself dirty on its
shard and the shard schedules ONE drain callback for the tick
boundary; the drain then moves every dirty connection's bytes out of
the kernel in one batched call —

- ``uring``  — one io_uring submission per drain: one RECVMSG SQE per
  dirty connection, ONE ``io_uring_enter`` submits and reaps the wave
  (csrc/zkwire_ext.c ``uring_recv``; the multishot-recv upgrade is
  declared there and carried until a >= 5.19 kernel can measure it).
  Requires Linux >= 5.1 — capability-gated OFF on this image's 4.4
  kernel, exactly like the transport tier's uring arm.
- ``mmsg``   — the whole dirty set in ONE C call
  (``zkwire_ext.drain_recv``: flat fds array, one ``recv(2)`` per fd
  inside the call — TCP has no cross-fd ``recvmmsg``, so the kernel
  crossing count stays O(dirty conns) while the Python-level
  submission count drops to O(dirty shards)); a pure-Python
  ``os.read`` loop when the extension is not (yet) built.
- ``asyncio`` — the single-loop validator: ``asyncio.start_server``
  plus the per-connection ``reader.read()`` task, exactly yesterday's
  path (``shards=1`` resolves here too).

Knobs, capability-probed and env-forced exactly like io/transport.py
(forcing falls DOWN the order, never up):

- ``ZKSTREAM_INGRESS=uring|mmsg|asyncio`` / ``ZKServer(ingress_backend=)``
- ``ZKSTREAM_INGRESS_SHARDS=N`` / ``ZKServer(ingress_shards=)`` /
  ``ZKEnsemble(ingress_shards=)`` — default sized from the CPU count
  (capped at :data:`MAX_DEFAULT_SHARDS`); ``1`` keeps the single-loop
  validator.
- ``ZKSTREAM_RX_BUF`` — receive buffer per drained connection per
  drain (the former hardcoded ``read(65536)``), both paths.

Correctness contract (tests/test_torch_ingress.py holds every backend to
identical per-connection frame streams over the full opcode corpus):

- **Per-connection frame order is arrival order.**  One drain reads
  each dirty fd once, in dirty order; bytes feed the connection's
  codec exactly as the validator's ``read()`` loop would, partial
  frames at any byte offset included (the codec accumulates).
- **Fault injection stays a per-frame boundary BEFORE the batch.**
  Each connection's drained bytes pass the injector's ``server_rx``
  hook individually before any decode (io/faults.py) — the send
  plane's rule mirrored on the receive side — so an injected
  split/delay/reset perturbs one connection's stream without
  reordering it, on every
  backend.
- **EOF and dead sockets close the connection** exactly as the
  validator's empty read does.

Observability: ``zookeeper_recv_syscalls_total{plane,backend}``
counts receive submissions per backend (O(dirty conns) per drain on
mmsg — honest: the C call still crosses the kernel once per fd —
O(1) enters on uring, one per ``read()`` on the validator) and
``zookeeper_recv_drain_depth`` histograms connections covered per
batched drain (the O(dirty-shards)-submissions-per-tick number).
``mntr`` reports ``zk_ingress_shards`` / ``zk_ingress_backend`` and a
per-shard connection census.  Scraped by ``bench.py --ingress``
(`make bench-ingress`).
"""

from __future__ import annotations

import asyncio
import dataclasses
import errno
import logging
import os
import socket
import struct
import sys

from ..utils.aio import ambient_loop

log = logging.getLogger('zkstream_tpu_torch.ingress')

#: Fallback order: forcing an unavailable tier falls DOWN this list.
BACKENDS = ('uring', 'mmsg', 'asyncio')

METRIC_RECV_SYSCALLS = 'zookeeper_recv_syscalls_total'
METRIC_RECV_DRAIN_DEPTH = 'zookeeper_recv_drain_depth'

#: Connections per batched receive drain (1 = the drain bought
#: nothing that tick; the interesting mass is 2+).
DEPTH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096)

#: Receive buffer per connection per drain — the former hardcoded
#: ``reader.read(65536)`` magic number, now a documented knob
#: (``ZKSTREAM_RX_BUF``).  Level-triggered readiness re-fires when a
#: connection had more than one buffer pending, so a small value
#: costs extra drains, never lost bytes.
DEFAULT_RX_BUF = 65536

#: Default shard-count ceiling: enough accept shards to keep one
#: shard's dirty set small under a connection storm, few enough that
#: an idle tick schedules almost nothing (and that a many-core box
#: does not pay 64 idle listeners per member).
MAX_DEFAULT_SHARDS = 8

#: io_uring receive-ring depth per plane (drains wider than this
#: submit in waves — still one enter syscall per wave).
URING_DEPTH = 1024

#: recv errnos that mean "nothing to read right now" (level-triggered
#: readiness raced a drain that already emptied the socket): skip the
#: connection, never close it.
_SOFT_ERRNOS = frozenset({errno.EAGAIN, errno.EWOULDBLOCK,
                          errno.EINTR})


@dataclasses.dataclass(frozen=True)
class Probe:
    """What the ingress capability probe found (``zk_ingress_backend``
    and the pytest skip markers read this)."""

    platform: str
    reuseport: bool
    reuseport_reason: str
    uring: bool
    uring_reason: str
    mmsg: bool
    mmsg_reason: str
    forced: str | None
    chosen: str

    def available(self, backend: str) -> bool:
        if backend == 'uring':
            return self.uring
        if backend == 'mmsg':
            return self.mmsg
        return True


#: Cached CAPABILITY results only — the env force is re-read on every
#: probe() call (like io/transport.py), so tests and the chaos CLI
#: can flip ZKSTREAM_INGRESS mid-process.
_caps_cache: tuple | None = None


def _probe_reuseport() -> tuple[bool, str]:
    """Can this kernel spread accepts across per-shard listeners?"""
    if not hasattr(socket, 'SO_REUSEPORT'):
        return False, 'SO_REUSEPORT not exposed'
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    except OSError as e:
        return False, 'setsockopt: %s' % (e.strerror or e,)
    finally:
        s.close()
    return True, 'ok'


def _probe_uring() -> tuple[bool, str]:
    """Can this process batch receives through an io_uring?  Needs
    Linux, the native extension with the recv arm (``uring_recv``),
    and a kernel that answers io_uring_setup (>= 5.1)."""
    if not sys.platform.startswith('linux'):
        return False, 'not linux'
    from ..utils.native import get_ext
    ext = get_ext()
    if ext is None:
        return False, 'native ext unavailable (build pending or off)'
    if not hasattr(ext, 'uring_recv'):
        return False, 'native ext predates uring recv support'
    try:
        ring = ext.uring_create(8)
    except OSError as e:
        return False, 'io_uring_setup: %s' % (e.strerror or e,)
    ext.uring_close(ring)
    return True, 'ok'


def _probe_mmsg() -> tuple[bool, str]:
    if sys.platform.startswith('win'):
        return False, 'not posix'
    return True, 'ok'


def probe(refresh: bool = False) -> Probe:
    """Resolve the process's ingress tier: capability probe (cached;
    ``refresh=True`` re-probes after a mid-process native build) plus
    the env force, re-read every call."""
    global _caps_cache
    if _caps_cache is None or refresh:
        _caps_cache = (_probe_reuseport(), _probe_uring(),
                       _probe_mmsg())
    (rp_ok, rp_why), (uring_ok, uring_why), (mmsg_ok, mmsg_why) = \
        _caps_cache
    forced = os.environ.get('ZKSTREAM_INGRESS') or None
    if forced is not None and forced not in BACKENDS:
        forced = None
    order = BACKENDS[BACKENDS.index(forced):] if forced else BACKENDS
    chosen = 'asyncio'
    for b in order:
        if (b == 'uring' and uring_ok) or (b == 'mmsg' and mmsg_ok) \
                or b == 'asyncio':
            chosen = b
            break
    return Probe(platform=sys.platform, reuseport=rp_ok,
                 reuseport_reason=rp_why, uring=uring_ok,
                 uring_reason=uring_why, mmsg=mmsg_ok,
                 mmsg_reason=mmsg_why, forced=forced, chosen=chosen)


def backend_default() -> str:
    """The process-wide rx backend (env force resolved against the
    probe) — what a knobless ZKServer runs."""
    return probe().chosen


def resolve_backend(arg: str | None) -> str:
    """Resolve an explicit constructor knob ('uring'|'mmsg'|'asyncio',
    None = process default) against availability, falling down the
    tier order like the env force does."""
    if arg is None:
        return backend_default()
    if arg not in BACKENDS:
        raise ValueError('unknown ingress backend %r (choose from '
                         '%s)' % (arg, '|'.join(BACKENDS)))
    p = probe()
    for b in BACKENDS[BACKENDS.index(arg):]:
        if p.available(b):
            return b
    return 'asyncio'


def shards_default() -> int:
    """Process-wide shard count: ``ZKSTREAM_INGRESS_SHARDS`` when set
    and positive, else sized from the CPU count (one accept shard per
    core, capped at :data:`MAX_DEFAULT_SHARDS`)."""
    try:
        n = int(os.environ.get('ZKSTREAM_INGRESS_SHARDS', ''))
    except ValueError:
        n = 0
    if n > 0:
        return n
    return max(1, min(os.cpu_count() or 1, MAX_DEFAULT_SHARDS))


def resolve_shards(arg: int | None) -> int:
    """Resolve a constructor shard knob (None = process default)."""
    if arg is None:
        return shards_default()
    if arg < 1:
        raise ValueError('ingress_shards must be >= 1 (1 = the '
                         'single-loop validator)')
    return arg


def rx_buf_default() -> int:
    """Receive-buffer size per drained connection: ``ZKSTREAM_RX_BUF``
    (bytes) when set and positive, else :data:`DEFAULT_RX_BUF`."""
    try:
        v = int(os.environ.get('ZKSTREAM_RX_BUF', ''))
    except ValueError:
        return DEFAULT_RX_BUF
    return v if v > 0 else DEFAULT_RX_BUF


class _IngressShard:
    """One accept shard's state: its listener (SO_REUSEPORT mode), the
    connections it owns, and the per-tick dirty set."""

    __slots__ = ('idx', 'conns', 'dirty', 'scheduled')

    def __init__(self, idx: int) -> None:
        self.idx = idx
        self.conns: set = set()
        self.dirty: list = []
        self.scheduled = False


class _ShardProtocol(asyncio.streams.FlowControlMixin):
    """The adopted socket's protocol: pauses transport reading the
    instant the connection exists (receive belongs to the shard
    drain, not the stream machinery) and routes connection teardown
    back to the ServerConnection.  FlowControlMixin supplies the
    drain helper a StreamWriter needs."""

    def __init__(self, plane: 'IngressPlane', shard_idx: int):
        super().__init__()
        self.plane = plane
        self.shard_idx = shard_idx
        self.conn = None

    def connection_made(self, transport) -> None:
        # pause before the transport's own (queued) reader
        # registration runs; the plane claims the fd one callback
        # later (see IngressPlane._adopted)
        transport.pause_reading()
        self.plane._protocols.add(self)
        self.conn = self.plane._adopted(transport, self,
                                        self.shard_idx)

    def data_received(self, data: bytes) -> None:
        # unreachable while reading is paused; kept as a safety net
        # for exotic transports — same feed path, same semantics
        conn = self.conn
        if conn is not None and not conn.closed and not conn.feed(data):
            conn.close()

    def eof_received(self) -> bool:
        return False        # close the transport; connection_lost runs

    def connection_lost(self, exc) -> None:
        super().connection_lost(exc)
        conn, self.conn = self.conn, None
        if conn is not None:
            conn.close()
        self.plane._proto_lost(self)


class IngressPlane:
    """One member's sharded ingress: N accept shards, each draining
    its dirty connections in one batched receive per busy tick.

    Owned by :class:`~..server.server.ZKServer`; ``None`` on a server
    whose resolved backend is ``asyncio`` (the single-loop validator
    keeps ``asyncio.start_server``)."""

    def __init__(self, server, shards: int, backend: str,
                 collector=None):
        assert backend in ('uring', 'mmsg'), backend
        assert shards >= 1
        self.server = server
        self.backend = backend
        self.nshards = shards
        self.rx_buf = rx_buf_default()
        self.reuseport = probe().reuseport
        self.shards = [_IngressShard(i) for i in range(shards)]
        self.port = 0
        self._lsocks: list[socket.socket] = []
        self._rr = 0             # dispatcher-handoff round-robin
        self._adopting: set = set()
        #: Live adopted protocols: what ``wait_closed`` drains —
        #: ZKServer.stop awaits every severed connection's
        #: ``connection_lost``, mirroring what the validator path's
        #: handler-task teardown provided (a stop that completed in
        #: zero loop iterations would let an in-process client keep
        #: believing it is connected).
        self._protocols: set = set()
        self._closed_waiters: list = []
        #: Stale-readiness suppression: a drain runs at the tick
        #: boundary AFTER the iteration's readiness events were
        #: reported, so the event for the bytes it just consumed is
        #: still in the ready queue and would re-dirty the connection
        #: into an EAGAIN drain next tick — measured at exactly 2x
        #: the recv count.  Each drained connection skips ONE
        #: readiness event; the skips clear at the head of the next
        #: iteration (before its fresh events run), so no real event
        #: is ever lost — level-triggered epoll re-reports anything
        #: still pending.
        self._skip_clear: list = []
        self._skip_scheduled = False
        self._uring = None
        self._uring_dead = False
        self.syscalls = 0        # lifetime receive submissions
        self.drains = 0          # batched drain rounds
        self._recv_ctr = None
        self._depth_hist = None
        #: per-backend label dicts, keyed by what a drain actually
        #: ran (a uring plane that latches down mid-life must account
        #: under mmsg, not under its configured tier)
        self._labels = {b: {'plane': 'server', 'backend': b}
                        for b in BACKENDS}
        if collector is not None:
            self._recv_ctr = collector.counter(
                METRIC_RECV_SYSCALLS,
                'Receive submissions issued by the ingress plane, by '
                'plane and backend')
            self._depth_hist = collector.histogram(
                METRIC_RECV_DRAIN_DEPTH,
                'Connections covered per batched receive drain, by '
                'plane and backend', buckets=DEPTH_BUCKETS)

    @property
    def running(self) -> bool:
        return bool(self._lsocks)

    # -- listeners ------------------------------------------------------

    def start(self, host: str, port: int) -> None:
        """Bind and register the shard listeners.  SO_REUSEPORT mode
        binds one listener per shard on the same port (the kernel
        spreads accepts); dispatcher mode binds one listener and
        hands accepted sockets round-robin to the shards."""
        assert not self._lsocks, 'ingress already started'
        loop = ambient_loop()
        n_listen = self.nshards if self.reuseport else 1
        self.port = port
        for k in range(n_listen):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            try:
                # what asyncio.start_server sets on POSIX: without it
                # a stop()/restart() on the same port can hit
                # EADDRINUSE from the closed connections' TIME_WAIT
                s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                if self.reuseport:
                    s.setsockopt(socket.SOL_SOCKET,
                                 socket.SO_REUSEPORT, 1)
                s.setblocking(False)
                s.bind((host, self.port))
                s.listen(self.server.BACKLOG)
            except OSError:
                s.close()
                for other in self._lsocks:
                    try:
                        loop.remove_reader(other.fileno())
                    except (OSError, ValueError, RuntimeError):
                        pass
                    other.close()
                self._lsocks = []
                raise
            if self.port == 0:
                self.port = s.getsockname()[1]
            self._lsocks.append(s)
            loop.add_reader(s.fileno(), self._on_accept, s,
                            k if self.reuseport else None)

    def stop(self) -> None:
        """Close the shard listeners (connections are the server's to
        sever) and release the receive ring."""
        loop = ambient_loop()
        for s in self._lsocks:
            try:
                loop.remove_reader(s.fileno())
            except (OSError, ValueError, RuntimeError):
                pass
            s.close()
        self._lsocks = []
        for t in list(self._adopting):
            t.cancel()
        if self._uring is not None:
            from ..utils.native import get_ext
            ext = get_ext()
            if ext is not None:
                try:
                    ext.uring_close(self._uring)
                except (OSError, ValueError):
                    pass
            self._uring = None

    def _proto_lost(self, proto: _ShardProtocol) -> None:
        self._protocols.discard(proto)
        if not self._protocols and self._closed_waiters:
            waiters, self._closed_waiters = self._closed_waiters, []
            for w in waiters:
                if not w.done():
                    w.set_result(None)

    async def wait_closed(self) -> None:
        """Wait for every adopted connection's transport teardown to
        complete (``connection_lost`` ran) — the sharded twin of the
        validator path's wait-for-handlers semantics.  The caller has
        already severed the connections; this only yields until the
        loop processed their closes."""
        while self._protocols:
            w = ambient_loop().create_future()
            self._closed_waiters.append(w)
            await w
        # the validator's stop returned only after the per-connection
        # handler tasks unwound — one task wakeup past connection_lost
        # — which is also what let an in-process peer's transport poll
        # the FIN before stop() returned.  Match that tail.
        for _ in range(3):
            await asyncio.sleep(0)

    # -- accept ---------------------------------------------------------

    def _on_accept(self, lsock: socket.socket,
                   shard_idx: int | None) -> None:
        """One listener's readiness callback: drain the accept queue.
        SO_REUSEPORT listeners pin their accepts to their own shard;
        the dispatcher listener hands off round-robin."""
        srv = self.server
        while True:
            try:
                sock, _addr = lsock.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return          # listener closed under the callback
            if srv.faults is not None and srv.faults.accept_refuse():
                # injected accept-loop refusal: RST, like the
                # validator path's transport.abort() — accounted
                # through the same shed helper (traced + counted)
                srv.note_shed('accept_refuse')
                self._rst_close(sock)
                continue
            ov = srv.overload
            delay = 0.0
            if ov is not None:
                # admission (io/overload.py): the global cap and this
                # accept's shard cap, checked BEFORE adoption — an
                # over-cap socket costs one RST, never a transport
                k_probe = (shard_idx if shard_idx is not None
                           else self._rr % self.nshards)
                why = ov.admit(len(srv.conns),
                               len(self.shards[k_probe].conns),
                               self.nshards)
                if why is not None:
                    srv.note_shed(why)
                    self._rst_close(sock)
                    continue
                delay = ov.pace_delay()
            try:
                sock.setblocking(False)
                sock.setsockopt(socket.IPPROTO_TCP,
                                socket.TCP_NODELAY, 1)
            except OSError:
                pass
            if shard_idx is None:
                k = self._rr % self.nshards
                self._rr += 1
            else:
                k = shard_idx
            task = asyncio.ensure_future(self._adopt(sock, k, delay))
            self._adopting.add(task)
            task.add_done_callback(self._adopting.discard)

    @staticmethod
    def _rst_close(sock: socket.socket) -> None:
        """Shed one accepted-but-never-adopted socket: linger-0 close
        (RST) so the peer learns immediately and no FIN state lingers
        through a connection flood."""
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                            struct.pack('ii', 1, 0))
        except OSError:
            pass
        sock.close()

    async def _adopt(self, sock: socket.socket, shard_idx: int,
                     delay: float = 0.0) -> None:
        """Wrap one accepted socket in an asyncio transport (the send
        plane, fault gates and teardown paths all speak transport) —
        reading paused from birth; the shard drain owns receive.
        ``delay`` is the handshake pacer's verdict: an over-window
        accept adopts late, flattening a dial wave."""
        loop = ambient_loop()
        if delay > 0.0:
            await asyncio.sleep(delay)
            if not self.running:
                self.server.note_shed('pacer_shutdown')
                try:
                    sock.close()
                except OSError:
                    pass
                return
        try:
            await loop.connect_accepted_socket(
                lambda: _ShardProtocol(self, shard_idx), sock)
        except (OSError, RuntimeError, asyncio.CancelledError):
            try:
                sock.close()
            except OSError:
                pass

    def _adopted(self, transport, proto: _ShardProtocol,
                 shard_idx: int):
        """Protocol handshake done (synchronously, inside
        ``connection_made``): build the ServerConnection and register
        the fd with the shard drain."""
        from ..server.server import ServerConnection
        loop = ambient_loop()
        writer = asyncio.StreamWriter(transport, proto, None, loop)
        srv = self.server
        conn = ServerConnection(srv, None, writer)
        conn._ingress = self
        conn._ingress_shard = shard_idx
        srv.conns.add(conn)
        self.shards[shard_idx].conns.add(conn)
        sock = transport.get_extra_info('socket')
        fd = -1
        if sock is not None:
            try:
                fd = sock.fileno()
            except (OSError, ValueError):
                fd = -1
        conn._rx_fd = fd
        # Claiming the fd must happen ONE callback later: the
        # selector transport queued its own reader registration at
        # construction, behind connection_made — and (3.10) that
        # registration checks only _closing, not _paused, so it will
        # re-take the fd after this method returns.  _claim_fd runs
        # after it and installs the drain's callback through the
        # loop's _add_reader (the public add_reader refuses
        # transport-owned fds; the private call replaces an existing
        # registration atomically — the transport itself uses it).
        # A chunk landing in that one-callback window arrives via
        # data_received, which feeds the same decode path.  Loops
        # without _add_reader (proactor) stay on protocol push.
        if fd >= 0 and hasattr(loop, '_add_reader'):
            loop.call_soon(self._claim_fd, conn)
        else:
            conn._rx_fd = -1
            transport.resume_reading()
        return conn

    def _claim_fd(self, conn) -> None:
        fd = conn._rx_fd
        if conn.closed or fd < 0:
            return
        try:
            ambient_loop()._add_reader(fd, self._on_readable, conn)
        except (OSError, ValueError, RuntimeError):
            conn._rx_fd = -1

    def forget(self, conn) -> None:
        """Connection closed: unregister its readiness callback and
        drop it from its shard (ServerConnection.close calls in)."""
        fd, conn._rx_fd = conn._rx_fd, -1
        if fd >= 0:
            # the private-API twin of the registration in _adopted
            # (the transport's own close() also unregisters the fd,
            # so a remove after transport teardown is a no-op)
            try:
                remove = getattr(ambient_loop(), '_remove_reader',
                                 None)
                if remove is not None:
                    remove(fd)
            except (OSError, ValueError, RuntimeError):
                pass
        shard = self.shards[conn._ingress_shard]
        shard.conns.discard(conn)

    # -- rx pause (the overload plane's inflight throttle) --------------

    def pause_rx(self, conn) -> None:
        """Stop draining one connection (io/overload.py): unregister
        its readiness callback so it can never go dirty — the kernel
        socket buffer then fills and TCP flow control pushes back on
        the client.  No user-space queue forms; that is the point."""
        fd = conn._rx_fd
        if fd < 0:
            return
        try:
            remove = getattr(ambient_loop(), '_remove_reader', None)
            if remove is not None:
                remove(fd)
        except (OSError, ValueError, RuntimeError):
            pass

    def resume_rx(self, conn) -> None:
        """Re-register a paused connection's reader and force one
        drain: bytes that arrived during the pause already sit in the
        kernel buffer, and a level-triggered selector only reports
        them to a registered reader."""
        if conn.closed or conn._rx_fd < 0:
            return
        try:
            ambient_loop()._add_reader(conn._rx_fd, self._on_readable,
                                       conn)
        except (OSError, ValueError, RuntimeError):
            conn._rx_fd = -1
            return
        conn._rx_skip = False
        if not conn._rx_dirty:
            conn._rx_dirty = True
            shard = self.shards[conn._ingress_shard]
            shard.dirty.append(conn)
            if not shard.scheduled:
                shard.scheduled = True
                ambient_loop().call_soon(self._drain_shard, shard)

    # -- the batched drain ----------------------------------------------

    def _on_readable(self, conn) -> None:
        """One connection's readiness callback: mark dirty, schedule
        the shard's one drain for the tick boundary.  Level-triggered
        readiness re-fires while a drain is pending — the dirty flag
        makes that a no-op."""
        if conn._rx_dirty or conn.closed or conn._rx_paused:
            return
        if conn._rx_skip:
            # the event for bytes a drain already consumed this
            # iteration: swallow exactly one
            conn._rx_skip = False
            return
        conn._rx_dirty = True
        shard = self.shards[conn._ingress_shard]
        shard.dirty.append(conn)
        if not shard.scheduled:
            shard.scheduled = True
            ambient_loop().call_soon(self._drain_shard, shard)

    def _drain_shard(self, shard: _IngressShard) -> None:
        """One shard's tick drain: every dirty connection's pending
        bytes leave the kernel in one batched receive, then feed the
        decode path per connection, in dirty order."""
        shard.scheduled = False
        dirty, shard.dirty = shard.dirty, []
        conns = []
        fds = []
        for conn in dirty:
            conn._rx_dirty = False
            if conn.closed or conn._rx_fd < 0 or conn._rx_paused:
                # a paused connection's bytes wait in the kernel;
                # resume_rx re-dirties it when the throttle lifts
                continue
            conns.append(conn)
            fds.append(conn._rx_fd)
        if not fds:
            return
        ledger = self.server.ledger
        if ledger is not None:
            # the tick's rx_drain phase: kernel-to-user time only
            # (decode + dispatch lands in decode_apply inside feed)
            ledger.enter('rx_drain')
        try:
            results, nsys, backend = self._drain_fds(fds)
        finally:
            if ledger is not None:
                ledger.exit()
        for conn in conns:
            conn._rx_skip = True
        self._skip_clear.extend(conns)
        if not self._skip_scheduled:
            self._skip_scheduled = True
            ambient_loop().call_soon(self._clear_skips)
        self.drains += 1
        self.syscalls += nsys
        labels = self._labels[backend]
        if self._recv_ctr is not None and nsys:
            self._recv_ctr.increment(labels, by=nsys)
        if self._depth_hist is not None:
            self._depth_hist.observe(len(fds), labels)
        for conn, res in zip(conns, results):
            if conn.closed:
                continue        # an earlier feed's handler closed it
            if isinstance(res, int):
                if -res in _SOFT_ERRNOS:
                    continue    # raced an already-drained socket
                conn.close()    # dead socket: same as a failed read
                continue
            if not res:
                conn.close()    # EOF — the validator's empty read
                continue
            # one connection's failure must not take the rest of the
            # batch with it: the validator isolated a raising handler
            # to its own task, and the shared drain is no weaker
            try:
                keep = conn.feed(res)
            except Exception:
                log.exception('ingress: dispatch failed; closing '
                              'connection')
                keep = False
            if not keep:
                conn.close()
                continue
            ov = self.server.overload
            if ov is not None and not conn.closed:
                # the drain is the natural per-conn-per-tick boundary
                # for the hard tx watermark: a reply backlog that
                # outgrew it evicts here
                ov.check_tx(conn)

    def _clear_skips(self) -> None:
        """Head of the next loop iteration: un-skip every connection
        a drain marked — fresh readiness events (appended behind this
        callback) then flow normally."""
        self._skip_scheduled = False
        conns, self._skip_clear = self._skip_clear, []
        for conn in conns:
            conn._rx_skip = False

    def _drain_fds(self, fds: list[int]
                   ) -> tuple[list, int, str]:
        """Move the dirty set's bytes out of the kernel; returns
        (per-fd bytes-or-negative-errno, receive submissions issued,
        backend that carried them)."""
        if self.backend == 'uring':
            out = self._drain_uring(fds)
            if out is not None:
                return out
            # ring creation failed after probe said OK (fd limits,
            # seccomp, pre-5.6 RECVMSG): latch down to the batch call
        from ..utils.native import get_ext
        ext = get_ext()
        if ext is not None and hasattr(ext, 'drain_recv'):
            # ONE C call for the whole dirty set: one recv(2) per fd
            # inside it, zero per-fd Python dispatch
            return ext.drain_recv(fds, self.rx_buf), len(fds), 'mmsg'
        results: list = []
        nbuf = self.rx_buf
        for fd in fds:
            try:
                results.append(os.read(fd, nbuf))
            except BlockingIOError:
                results.append(-errno.EAGAIN)
            except OSError as e:
                results.append(-(e.errno or 1))
        return results, len(fds), 'mmsg'

    def _drain_uring(self, fds: list[int]
                     ) -> tuple[list, int, str] | None:
        if self._uring_dead:
            return None
        from ..utils.native import get_ext
        ext = get_ext()
        if ext is None or not hasattr(ext, 'uring_recv'):
            return None
        if self._uring is None:
            try:
                self._uring = ext.uring_create(URING_DEPTH)
            except OSError:
                self._uring_dead = True
                return None
        try:
            results, enters = ext.uring_recv(self._uring, fds,
                                             self.rx_buf)
        except OSError:
            self._uring_dead = True
            return None
        return results, enters, 'uring'

    # -- introspection --------------------------------------------------

    def shard_census(self) -> list[int]:
        """Connections per shard (the mntr per-shard census rows)."""
        return [len(s.conns) for s in self.shards]


def make_plane(server, shards: int | None, backend: str | None,
               collector=None) -> IngressPlane | None:
    """Build one server's ingress plane, or None when the resolved
    configuration is the single-loop validator (``shards=1`` or a
    resolved ``asyncio`` backend — ``asyncio.start_server`` then
    serves exactly as before)."""
    nshards = resolve_shards(shards)
    resolved = resolve_backend(backend)
    if nshards <= 1 or resolved == 'asyncio':
        return None
    return IngressPlane(server, nshards, resolved,
                        collector=collector)


def scrape_recv_cells(collector) -> dict:
    """Summarize the receive-direction counters for bench cells
    (bench.py --ingress): submissions by backend plus drain-depth
    distribution — the rx sibling of the transport tier's syscall
    scrape."""
    out: dict = {}
    try:
        ctr = collector.get_collector(METRIC_RECV_SYSCALLS)
    except ValueError:
        ctr = None
    if ctr is not None:
        by_backend = {}
        for key in ctr.label_keys():
            labels = dict(key)
            if labels.get('plane') == 'server':
                by_backend[labels.get('backend', '?')] = \
                    ctr.value(labels)
        if by_backend:
            out['recv_syscalls'] = by_backend
    try:
        dep = collector.get_collector(METRIC_RECV_DRAIN_DEPTH)
    except ValueError:
        dep = None
    if dep is not None:
        # every server-plane backend series (a uring plane latched
        # down mid-cell reports under both tiers — the scrape must
        # cover all of a cell's drains, like the syscalls scrape)
        by_backend = {}
        for key in dep.label_keys():
            labels = dict(key)
            if labels.get('plane') != 'server':
                continue
            n = dep.count(labels)
            if n:
                by_backend[labels.get('backend', '?')] = {
                    'drains': n,
                    'mean': round(dep.sum(labels) / n, 1),
                    'p99': round(dep.percentile(99, labels), 1)}
        if by_backend:
            out['drain_depth'] = by_backend
    return out
