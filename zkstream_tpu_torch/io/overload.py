"""The overload plane: admission control, rx/tx backpressure, and
slow-consumer defense.

The planes before it built the throughput for wide fan-out (sharded
ingress, batched transport, observer read scale-out) but nothing
bounded what a member *accepts*: a handshake wave, a pipelining
client, a corrupt 4-byte length prefix, or — worst — a stalled
subscriber socket that the watch table will happily buffer a
100k-watcher notification storm into until the member OOMs.  Real
ZooKeeper ships ``RequestThrottler``, ``maxClientCnxns`` and
``jute.maxbuffer`` for exactly this; this module is that contract for
this stack, threaded through every tier as *watermarks* rather than
queues:

- **Admission** — a global connection cap (``ZKSTREAM_MAX_CONNS``) and
  a derived per-ingress-shard cap; over-cap sockets are shed
  pre-adoption through :meth:`ZKServer.shed_client` (traced span +
  metric — never the silent abort the old accept path did).  A
  token-window **handshake pacer** (``ZKSTREAM_ACCEPT_PACE`` accepts
  per 50 ms window) converts a SYN/handshake wave into a deferred
  trickle instead of a thundering adoption storm.
- **Rx backpressure** — the inbound frame cap lives in
  protocol/framing.py (``ZKSTREAM_MAX_FRAME``, typed
  :class:`~..protocol.errors.ZKFrameTooLargeError` *before* buffering);
  this module adds the per-connection inflight throttle: when one
  drain decodes ``ZKSTREAM_MAX_INFLIGHT`` or more requests from a
  single connection, the plane *pauses that connection's rx* — the
  ingress plane removes its reader (stops marking it dirty), the
  validator loop parks on an event — and resumes a few ms later.  No
  queue is built: the kernel socket buffer fills and TCP flow control
  pushes back on the client, exactly the batched-drain shape the
  sharded ingress was built around.
- **Tx watermarks** — per-connection buffered-bytes accounting spans
  the send plane's cork, the transport tier's queued chunks and the
  asyncio transport's own buffer (``SendPlane.buffered_bytes``).  At
  the **soft** watermark (``ZKSTREAM_TX_SOFT``) watch notifications —
  the one legally lossy channel: the client re-syncs via SET_WATCHES —
  are dropped for that connection and counted.  At the **hard**
  watermark (``ZKSTREAM_TX_HARD``) the connection is evicted with a
  traced, typed close (the buffered bytes are *discarded*, not
  flushed: flushing into a wedged socket is how the bloat happened),
  so one stalled subscriber can never wedge a wide fan-out.
- **Global write throttle** — when the member-wide aggregate of
  tx-buffered bytes crosses ``ZKSTREAM_MEM_SOFT`` the member enters a
  degraded mode: new writes bounce with the typed wire code
  ``THROTTLED`` (definite failure — NOT applied; the client backs off
  and retries under its session retry policy) while reads keep
  flowing.  The aggregate is memoized per event-loop tick so the
  write hot path never does an O(conns) walk per op.

``ZKSTREAM_NO_OVERLOAD=1`` (or ``ZKServer(overload=False)``) is the
validator: with the plane off the byte-stream and chaos behavior are
bit-identical to the pre-overload stack (asserted in
tests/test_torch_overload.py), which bisects whether a regression lives in
the plane or under it.

Everything observable: ``zk_throttled_ops_total``,
``zk_evicted_slow_consumers``, ``zk_notifications_dropped_total``, a
``zk_conn_tx_buffered_bytes`` histogram, OVERLOAD spans in the trace
ring, mntr census rows, and a blackbox ``overload`` frame on every
watermark crossing (the flight recorder, utils/blackbox.py).
"""

from __future__ import annotations

import dataclasses
import os
import time

from ..protocol.consts import MAX_PACKET
from ..utils.aio import ambient_loop

#: Env knobs (all also constructor-settable on ZKServer).  Documented
#: in README.md — the zkanalyze drift checker gates that.
NO_OVERLOAD_ENV = 'ZKSTREAM_NO_OVERLOAD'
MAX_CONNS_ENV = 'ZKSTREAM_MAX_CONNS'
MAX_INFLIGHT_ENV = 'ZKSTREAM_MAX_INFLIGHT'
TX_SOFT_ENV = 'ZKSTREAM_TX_SOFT'
TX_HARD_ENV = 'ZKSTREAM_TX_HARD'
MEM_SOFT_ENV = 'ZKSTREAM_MEM_SOFT'
ACCEPT_PACE_ENV = 'ZKSTREAM_ACCEPT_PACE'

#: Metric names (registered on the server's collector when present).
METRIC_THROTTLED = 'zk_throttled_ops_total'
METRIC_EVICTED = 'zk_evicted_slow_consumers'
METRIC_NOTIF_DROPPED = 'zk_notifications_dropped_total'
METRIC_TX_BUFFERED = 'zk_conn_tx_buffered_bytes'

#: Histogram buckets for per-connection tx-buffered bytes: spans the
#: cork flush cap (~64 KiB) up past the default hard watermark.
TX_BUCKETS = (1024, 8192, 65536, 262144, 1048576,
              4 * 1024 * 1024, 16 * 1024 * 1024)

#: How long a paused connection's reader stays removed before the
#: drain resumes.  Long enough for the replies of the oversized batch
#: to flush and for the kernel buffer to exert TCP backpressure;
#: short enough to be invisible to a well-behaved client.
RX_PAUSE_S = 0.005

#: Aggregate tx-buffered bytes memo lifetime.  One event-loop tick of
#: writes shares a single O(conns) walk.
AGG_MEMO_S = 0.005


def overload_enabled() -> bool:
    """Global kill switch (mirrors ``ZKSTREAM_NO_WATCHTABLE`` /
    ``ZKSTREAM_NO_ELECTION``): ``ZKSTREAM_NO_OVERLOAD=1`` turns the
    whole plane off for A/B bisection."""
    return os.environ.get(NO_OVERLOAD_ENV) != '1'


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw:
        try:
            return int(raw)
        except ValueError:
            return default
    return default


def _sid(conn) -> str | None:
    """The connection's session id in the span convention ('%016x',
    matching ZKSession.get_session_id); None before the handshake."""
    sid = getattr(conn, 'session_id', None)
    return '%016x' % (sid,) if sid is not None else None


@dataclasses.dataclass
class OverloadConfig:
    """The plane's knob inventory.  ``0`` disables the specific limit
    (the plane's accounting still runs — the metrics stay live).

    Defaults are sized for the test/bench rig, not production: caps
    generous enough that no existing test ever trips them, watermarks
    low enough that the overload tests trip them cheaply."""

    #: Global connection cap (``maxClientCnxns`` analogue, but
    #: member-wide; the per-shard cap is derived as cap/nshards).
    max_conns: int = 4096
    #: Per-connection inflight-request throttle: a single rx drain
    #: decoding this many requests pauses that connection's reader.
    max_inflight: int = 256
    #: Soft per-connection tx watermark: above it, watch notifications
    #: for that connection are dropped (legally lossy channel).
    tx_soft: int = 1 * 1024 * 1024
    #: Hard per-connection tx watermark: above it, the connection is
    #: evicted with a traced, typed close and its buffer discarded.
    tx_hard: int = 4 * 1024 * 1024
    #: Global soft memory watermark over the aggregate of all
    #: connections' tx-buffered bytes: above it new writes bounce
    #: with ``THROTTLED`` while reads keep flowing.
    mem_soft: int = 64 * 1024 * 1024
    #: Handshake pacer: accepted connections admitted per window
    #: (0 = unpaced).  Overflow accepts are deferred, not refused.
    accept_pace: int = 0
    #: Pacer window, in seconds.
    accept_window_s: float = 0.05

    @classmethod
    def resolve(cls, max_conns: int | None = None,
                max_inflight: int | None = None,
                tx_soft: int | None = None,
                tx_hard: int | None = None,
                mem_soft: int | None = None,
                accept_pace: int | None = None) -> 'OverloadConfig':
        """Constructor args beat env beats defaults (the same ladder
        every other subsystem knob uses)."""
        d = cls()
        cfg = cls(
            max_conns=max_conns if max_conns is not None
            else _env_int(MAX_CONNS_ENV, d.max_conns),
            max_inflight=max_inflight if max_inflight is not None
            else _env_int(MAX_INFLIGHT_ENV, d.max_inflight),
            tx_soft=tx_soft if tx_soft is not None
            else _env_int(TX_SOFT_ENV, d.tx_soft),
            tx_hard=tx_hard if tx_hard is not None
            else _env_int(TX_HARD_ENV, d.tx_hard),
            mem_soft=mem_soft if mem_soft is not None
            else _env_int(MEM_SOFT_ENV, d.mem_soft),
            accept_pace=accept_pace if accept_pace is not None
            else _env_int(ACCEPT_PACE_ENV, d.accept_pace),
        )
        # A hard watermark below the soft one is a config bug; repair
        # rather than raise (env strings come from operators).
        if cfg.tx_hard and cfg.tx_soft and cfg.tx_hard < cfg.tx_soft:
            cfg.tx_hard = cfg.tx_soft
        return cfg


class OverloadPlane:
    """One member's overload state: admission census, pacer window,
    per-connection rx pause bookkeeping, tx watermark checks, and the
    memoized global aggregate.  Owned by :class:`ZKServer`; ``None``
    when the plane is disabled (every call site null-checks, so the
    disabled path adds zero work to the hot loops)."""

    __slots__ = ('server', 'cfg', 'sheds', 'throttled_writes',
                 'evictions', 'notifications_dropped',
                 'persistent_evictions', 'rx_pauses',
                 '_throttled_on', '_win_start', '_win_n', '_agg',
                 '_agg_at', '_ctr_throttled', '_ctr_evicted',
                 '_ctr_dropped', '_hist_tx')

    def __init__(self, server, cfg: OverloadConfig | None = None,
                 collector=None):
        self.server = server
        self.cfg = cfg if cfg is not None else OverloadConfig.resolve()
        self.sheds = 0
        self.throttled_writes = 0
        self.evictions = 0
        self.notifications_dropped = 0
        self.persistent_evictions = 0
        self.rx_pauses = 0
        self._throttled_on = False
        self._win_start = 0.0
        self._win_n = 0
        self._agg = 0
        self._agg_at = -1.0
        self._ctr_throttled = None
        self._ctr_evicted = None
        self._ctr_dropped = None
        self._hist_tx = None
        if collector is not None:
            self._ctr_throttled = collector.counter(
                METRIC_THROTTLED,
                'Write ops bounced with THROTTLED at the global '
                'memory watermark')
            self._ctr_evicted = collector.counter(
                METRIC_EVICTED,
                'Connections evicted at the hard tx watermark or '
                'shed at admission')
            self._ctr_dropped = collector.counter(
                METRIC_NOTIF_DROPPED,
                'Watch notifications dropped at the soft tx '
                'watermark (client re-syncs via SET_WATCHES)')
            self._hist_tx = collector.histogram(
                METRIC_TX_BUFFERED,
                'Per-connection tx-buffered bytes (plane + tier + '
                'transport) sampled at watermark checks',
                buckets=TX_BUCKETS)

    # -- admission -------------------------------------------------

    def admit(self, total: int, shard_n: int | None = None,
              nshards: int = 1) -> str | None:
        """Admission verdict for one accepted socket: ``None`` to
        adopt, else the shed reason.  ``total`` is the member-wide
        census, ``shard_n`` the owning shard's census (sharded
        ingress only)."""
        cap = self.cfg.max_conns
        if cap > 0:
            if total >= cap:
                return 'conn_cap'
            if shard_n is not None and nshards > 1:
                # Ceil-divided so the caps sum to >= the global cap
                # and a lopsided hash can't strand capacity.
                if shard_n >= -(-cap // nshards):
                    return 'shard_cap'
        return None

    def pace_delay(self) -> float:
        """Handshake pacer: seconds to defer this accept's adoption
        (0.0 = admit now).  A sliding token window — the first
        ``accept_pace`` accepts in a window go straight through,
        the rest are pushed into subsequent windows, flattening a
        handshake wave into a trickle the session layer can absorb."""
        pace = self.cfg.accept_pace
        if pace <= 0:
            return 0.0
        now = time.monotonic()
        w = self.cfg.accept_window_s
        if now - self._win_start >= w:
            self._win_start = now
            self._win_n = 0
        self._win_n += 1
        if self._win_n <= pace:
            return 0.0
        windows_ahead = (self._win_n - 1) // pace
        return max(0.0, (self._win_start + windows_ahead * w) - now)

    def count_shed(self, reason: str) -> None:
        self.sheds += 1
        if self._ctr_evicted is not None:
            self._ctr_evicted.increment({'reason': 'shed:%s' % reason})

    # -- rx backpressure -------------------------------------------

    def after_drain(self, conn, npkts: int) -> None:
        """Called after one rx drain decoded ``npkts`` requests from
        ``conn``.  An oversized batch pauses the connection's reader:
        no queue forms — the kernel socket buffer fills and TCP flow
        control reaches back to the client."""
        cap = self.cfg.max_inflight
        if cap <= 0 or npkts < cap or conn.closed:
            return
        if getattr(conn, '_rx_paused', False):
            return
        conn._rx_paused = True
        self.rx_pauses += 1
        srv = self.server
        if srv.trace is not None:
            srv.trace.note('OVERLOAD', kind='server',
                           detail='rx_pause', batch=npkts,
                           session_id=_sid(conn))
        ingress = getattr(conn, '_ingress', None)
        if ingress is not None:
            ingress.pause_rx(conn)
        loop = ambient_loop()
        loop.call_later(RX_PAUSE_S, self._resume_rx, conn)

    def _resume_rx(self, conn) -> None:
        if not getattr(conn, '_rx_paused', False):
            return
        conn._rx_paused = False
        if conn.closed:
            return
        ingress = getattr(conn, '_ingress', None)
        if ingress is not None:
            ingress.resume_rx(conn)
        else:
            gate = getattr(conn, '_rx_resume', None)
            if gate is not None:
                gate.set()

    # -- tx watermarks ---------------------------------------------

    def tx_buffered(self, conn) -> int:
        return conn._tx.buffered_bytes()

    def allow_notification(self, conn) -> bool:
        """Soft-watermark gate on the fan-out path: ``False`` means
        drop this connection's watch notification (and count it) —
        the one legally lossy channel, since a reconnecting client
        re-arms via SET_WATCHES and re-reads what it watched."""
        soft = self.cfg.tx_soft
        if soft <= 0 or conn.closed:
            return True
        b = conn._tx.buffered_bytes()
        if b < soft:
            return True
        self.notifications_dropped += 1
        first = not getattr(conn, '_notif_dropping', False)
        conn._notif_dropping = True
        if self._ctr_dropped is not None:
            self._ctr_dropped.increment()
        srv = self.server
        if first and srv.trace is not None:
            # One span per drop *episode*, not per dropped frame — a
            # 100k fan-out against a stalled socket must not flood
            # the trace ring.
            srv.trace.note('OVERLOAD', kind='server',
                           detail='notif_drop', nbytes=b,
                           session_id=_sid(conn))
        return False

    def allow_persistent_notification(self, conn) -> bool:
        """The soft-watermark gate for PERSISTENT-watch subscribers
        (server/watchtable.py ``_fan_persistent``).  The one-shot
        drop contract above is UNSAFE here: a one-shot client re-arms
        and re-reads on reconnect anyway, but a persistent subscriber
        — a watch-backed cache — relies on the invalidation stream
        being gap-free, and a silently dropped frame would leave it
        serving stale data forever with no signal.  So instead of a
        gap the stalled subscriber is EVICTED on the spot (typed
        close, same as the hard watermark): the client observes a
        connection loss, marks its cached subtree stale, re-dials,
        replays via SET_WATCHES2 and re-syncs — coherence preserved
        at the cost of one reconnect."""
        soft = self.cfg.tx_soft
        if soft <= 0 or conn.closed:
            return True
        b = conn._tx.buffered_bytes()
        if b < soft:
            return True
        self.persistent_evictions += 1
        self.evict(conn, 'persistent_gap', buffered=b)
        return False

    def check_tx(self, conn) -> bool:
        """Hard-watermark check, called where tx bytes accumulate
        (fan-out flush, ingress drain).  Returns ``True`` if the
        connection was evicted."""
        if conn.closed:
            return False
        b = conn._tx.buffered_bytes()
        if self._hist_tx is not None:
            self._hist_tx.observe(b)
        if b < self.cfg.tx_soft or b > self.cfg.tx_soft * 2:
            # Cheap hysteresis for the drop-episode marker: well
            # below soft clears it so a later stall traces anew.
            if b < self.cfg.tx_soft:
                conn._notif_dropping = False
        hard = self.cfg.tx_hard
        if hard > 0 and b >= hard:
            self.evict(conn, 'tx_hard', buffered=b)
            return True
        return False

    def evict(self, conn, reason: str, buffered: int | None = None) \
            -> None:
        """Slow-consumer eviction: a traced, typed close that
        *discards* the buffered tx bytes (flushing into the wedged
        socket is how the bloat happened) and aborts the transport.
        The client observes a connection loss, re-dials a healthy
        member and re-syncs watches — the fan-out to everyone else
        proceeds unbloated."""
        if conn.closed:
            return
        self.evictions += 1
        if self._ctr_evicted is not None:
            self._ctr_evicted.increment({'reason': reason})
        srv = self.server
        if srv.trace is not None:
            srv.trace.note('OVERLOAD', kind='server',
                           detail='evict:%s' % reason,
                           session_id=_sid(conn), nbytes=buffered)
        if srv.blackbox is not None:
            srv.blackbox.capture('overload')
        conn.evicted = reason
        sess = getattr(conn, 'session', None)
        if sess is not None:
            # the session event: a resuming connection (any member)
            # can see WHY its predecessor died and that watches may
            # have been dropped — re-sync via SET_WATCHES
            sess.overload_evicted = reason
        conn.abort()

    # -- global write throttle -------------------------------------

    def aggregate_tx(self) -> int:
        """Member-wide tx-buffered bytes, memoized for one tick."""
        now = time.monotonic()
        if now - self._agg_at < AGG_MEMO_S:
            return self._agg
        total = 0
        for c in self.server.conns:
            if not c.closed:
                total += c._tx.buffered_bytes()
        self._agg = total
        self._agg_at = now
        return total

    def write_throttled(self) -> bool:
        """``True`` when the member is over its global memory
        watermark: new writes must bounce ``THROTTLED`` (reads keep
        flowing).  Crossings in either direction cut a blackbox
        ``overload`` frame — the flight recorder keeps the moment
        the member entered and left degraded mode."""
        soft = self.cfg.mem_soft
        if soft <= 0:
            return False
        over = self.aggregate_tx() >= soft
        if over != self._throttled_on:
            self._throttled_on = over
            srv = self.server
            if srv.trace is not None:
                srv.trace.note('OVERLOAD', kind='server',
                               detail='throttle_on' if over
                               else 'throttle_off',
                               nbytes=self._agg)
            if srv.blackbox is not None:
                srv.blackbox.capture('overload')
        return over

    def count_throttled(self, op: str) -> None:
        self.throttled_writes += 1
        if self._ctr_throttled is not None:
            self._ctr_throttled.increment({'op': op})

    # -- observability ---------------------------------------------

    def mntr_rows(self) -> list:
        return [
            ('zk_overload_sheds', self.sheds),
            ('zk_overload_rx_pauses', self.rx_pauses),
            ('zk_overload_throttled_writes', self.throttled_writes),
            ('zk_overload_evictions', self.evictions),
            ('zk_overload_notifications_dropped',
             self.notifications_dropped),
            ('zk_overload_persistent_evictions',
             self.persistent_evictions),
            ('zk_overload_tx_buffered_bytes', self.aggregate_tx()),
            ('zk_overload_max_frame',
             getattr(self.server, 'max_frame', MAX_PACKET)),
        ]
