"""The in-process asyncio ZooKeeper server.

Speaks the same wire protocol as the client through the symmetric
``PacketCodec(server=True)`` — the capability the reference's stream
codec advertises for building fake test servers
(reference: lib/zk-streams.js:28,70-71,84-85) but cannot actually
deliver (its reply encoder is missing).  This one is complete enough to
run the whole client test suite against: handshake with session
create/resume, the full request set, one-shot server-side watches with
correct locality, SET_WATCHES catch-up by relZxid, and session
migration between ensemble members.

``ZKEnsemble`` runs N servers on localhost as a simulated quorum: one
leader ``ZKDatabase`` sequences every write into a commit log, and each
follower serves reads/watches from its own ``ReplicaStore`` replaying
that log with injectable lag — so followers can genuinely trail the
leader, stale reads are possible, and the ``sync`` op has observable
meaning (see store.py).
"""

from __future__ import annotations

import asyncio
import logging
import os
import time

from ..protocol.consts import MAX_PACKET, XID_NOTIFICATION, CreateFlag
from ..protocol.errors import ZKFrameTooLargeError, ZKProtocolError
from ..io.ingress import METRIC_RECV_SYSCALLS, make_plane, \
    rx_buf_default
from ..io.overload import OverloadConfig, OverloadPlane, \
    overload_enabled
from ..io.sendplane import SendPlane
from ..protocol.framing import PacketCodec, resolve_frame_cap
from ..utils.aio import set_nodelay
from ..utils.metrics import TickLedger
from ..utils.trace import TRACE_SCHEMA, TraceRing, server_trace_default
from .store import ReplicaStore, ZKDatabase, ZKOpError, ZKServerSession
from .watchtable import WatchTable, watchtable_default

log = logging.getLogger('zkstream_tpu_torch.server')

#: ZooKeeper four-letter admin words this server answers (raw bytes,
#: no length prefix, sent as a connection's very first payload).
#: ``trce`` is this stack's own: the member's span ring as JSON
#: (trace_schema-stamped), so ``timeline --live`` can merge rings
#: scraped from OS-process members.
ADMIN_WORDS = frozenset((b'ruok', b'mntr', b'stat', b'srvr', b'trce'))

#: The dynamic-membership admin channel (README "Dynamic membership"):
#: ``rcfg <action> [args]\n`` — four-letter-word framing (raw bytes as
#: the connection's first payload) but argument-bearing, so the word
#: buffers through its newline before dispatch.  Leader-only; replies
#: one text line and closes, mntr-style.
RECONFIG_WORD = b'rcfg'

METRIC_RECONFIG = 'zookeeper_reconfig_ms'
RECONFIG_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                    100.0, 250.0, 1000.0)


def _csv(members) -> str:
    """Member-id list as the admin/mntr text form ('-' when empty)."""
    return ','.join(str(m) for m in members) or '-'


def _parse_members(s: str) -> tuple:
    """Inverse of :func:`_csv` for ``rcfg`` argument lists."""
    if s == '-':
        return ()
    return tuple(int(x) for x in s.split(',') if x != '')


def _config_desc(voters, old_voters, observers, phase) -> str:
    """The one-line member inventory ``zk_config_members`` carries."""
    desc = 'voters=%s' % (_csv(voters),)
    if old_voters:
        desc += ' old_voters=%s' % (_csv(old_voters),)
    if observers:
        desc += ' observers=%s' % (_csv(observers),)
    return desc + ' phase=%s' % (phase,)

#: Member span-ring capacity: deep enough to hold a campaign's recent
#: window (decode + per-txn chain + fan-out), fixed memory.
MEMBER_RING_CAPACITY = 512

# ---------------------------------------------------------------------
# The zxid read gate: session-consistent reads off non-leader members.
# ---------------------------------------------------------------------

METRIC_READ_GATE_WAIT = 'zookeeper_read_gate_wait_ms'
READ_GATE_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                     25.0, 50.0, 100.0, 250.0)

#: How long a gated read may block waiting for this member to apply
#: the session's floor before it BOUNCES (a typed CONNECTION_LOSS the
#: client retries on a fresher member) — the read plane's analogue of
#: the quorum gate's degrade window: a parked replica must delay
#: reads, never wedge them (``ZKSTREAM_READ_GATE_WAIT_MS``).
DEFAULT_READ_GATE_WAIT_MS = 100.0


def read_gate_enabled() -> bool:
    """Global kill switch (``ZKSTREAM_NO_READ_GATE=1``): the ungated
    read path stays available as the env-gated validator arm — the
    one ``analysis/linearize.py check_session_reads`` exists to
    catch."""
    return os.environ.get('ZKSTREAM_NO_READ_GATE') != '1'


def read_gate_wait_ms() -> float:
    try:
        v = float(os.environ.get('ZKSTREAM_READ_GATE_WAIT_MS', ''))
    except ValueError:
        return DEFAULT_READ_GATE_WAIT_MS
    return v if v > 0 else DEFAULT_READ_GATE_WAIT_MS


def observers_default() -> int:
    """Default observer count for a new ``ZKEnsemble``
    (``ZKSTREAM_OBSERVERS``)."""
    try:
        n = int(os.environ.get('ZKSTREAM_OBSERVERS', ''))
    except ValueError:
        return 0
    return max(0, n)


class ReadGate:
    """Session-consistent follower/observer reads (README "Read
    plane"): a read must never show a session state OLDER than what
    the session has already observed.  Every reply header stamps the
    serving member's applied zxid into ``session.last_zxid`` (the
    handshake's ``lastZxidSeen`` seeds it), and a read arriving at a
    member whose store trails that floor parks here — re-dispatched
    the moment the member's replica applies through the floor, or
    bounced with a typed CONNECTION_LOSS after ``wait_ms`` so the
    client can retry on a fresher member.  Leader-view members
    (``store is db``) are always current and never gate.

    Observability: ``zk_read_zxid_gate_blocks`` / ``_bounces`` mntr
    rows, the ``zookeeper_read_gate_wait_ms`` histogram, and a
    READ_GATE span per gated read in the member's trace ring."""

    def __init__(self, server: 'ZKServer', collector=None,
                 wait_ms: float | None = None):
        self.server = server
        self.wait_ms = (wait_ms if wait_ms is not None
                        else read_gate_wait_ms())
        self.blocks = 0
        self.bounces = 0
        #: parked reads: [floor, conn, pkt, t0, timer_handle]
        self._pending: list = []
        self._store = None
        self._hist = None
        if collector is not None:
            self._hist = collector.histogram(
                METRIC_READ_GATE_WAIT,
                'Zxid read-gate wait before serve or bounce, ms',
                buckets=READ_GATE_BUCKETS)

    def defer(self, conn, pkt: dict, floor: int) -> None:
        """Park one read whose serving member trails the session
        floor.  The store-event subscription (one listener set per
        member, armed lazily) re-dispatches it when the replica
        applies through the floor; the timer bounds the wait."""
        self.blocks += 1
        self._subscribe()
        from ..utils.aio import ambient_loop
        entry = [floor, conn, pkt, time.perf_counter(), None]
        entry[4] = ambient_loop().call_later(
            self.wait_ms / 1000.0, self._bounce, entry)
        self._pending.append(entry)

    # -- store following (survives repoint) --

    def _subscribe(self) -> None:
        store = self.server.store
        if self._store is store:
            return
        self._unsubscribe()
        self._store = store
        for ev in ('created', 'deleted', 'dataChanged',
                   'childrenChanged'):
            store.on(ev, self._on_store_event)

    def _unsubscribe(self) -> None:
        if self._store is None:
            return
        for ev in ('created', 'deleted', 'dataChanged',
                   'childrenChanged'):
            self._store.remove_listener(ev, self._on_store_event)
        self._store = None

    def _on_store_event(self, _path, _zxid) -> None:
        if self._pending:
            self._drain()

    def _settle(self, entry, *, bounced: bool) -> None:
        floor, conn, pkt, t0, timer = entry
        if timer is not None:
            timer.cancel()
        dur_ms = (time.perf_counter() - t0) * 1000.0
        if self._hist is not None:
            self._hist.observe(dur_ms)
        trace = self.server.trace
        if trace is not None:
            trace.note('READ_GATE', pkt.get('path'), zxid=floor,
                       kind='server',
                       detail='bounce' if bounced else 'block',
                       duration_ms=round(dur_ms, 3))

    def _drain(self) -> None:
        """Re-dispatch every parked read the member has caught up
        past, in arrival order (runs inside the store's apply, the
        same dispatch point as watch fan-out)."""
        z = self.server.store.zxid
        ready = [e for e in self._pending if e[0] <= z]
        if not ready:
            return
        self._pending = [e for e in self._pending if e[0] > z]
        for entry in ready:
            self._settle(entry, bounced=False)
            conn, pkt = entry[1], entry[2]
            if conn.closed:
                continue
            conn._handle_request(pkt)

    def _bounce(self, entry) -> None:
        """The bounded wait expired with the member still behind: a
        typed CONNECTION_LOSS reply — outcome-unknown to the client's
        ambiguity accounting, retryable on a fresher member — never a
        stale payload."""
        if entry not in self._pending:
            return
        self._pending.remove(entry)
        entry[4] = None              # the timer IS this callback
        self.bounces += 1
        self._settle(entry, bounced=True)
        conn, pkt = entry[1], entry[2]
        if not conn.closed:
            conn._reply(pkt['xid'], pkt['opcode'],
                        err='CONNECTION_LOSS')

    def reset(self) -> None:
        """Drop every parked read (repoint/stop: the connections are
        being closed; their sessions re-dial and retry)."""
        pending, self._pending = self._pending, []
        for entry in pending:
            if entry[4] is not None:
                entry[4].cancel()
        self._unsubscribe()


class ServerConnection:
    """One accepted client socket: handshake, request dispatch, and this
    connection's watch tables."""

    def __init__(self, server: 'ZKServer', reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self.server = server
        self.db = server.db          # the leader: writes + sessions
        self.store = server.store    # this member's view: reads + watches
        self.reader = reader
        self.writer = writer
        self.codec = PacketCodec(server=True,
                                 max_frame=server.max_frame)
        self.session: ZKServerSession | None = None
        #: One-shot watch tables, local to this connection (they die
        #: with the server, exactly like real ZK's).  With the server's
        #: WatchTable enabled (the default) these dicts are the
        #: per-connection view of the same registrations the table's
        #: reverse index holds — always mutate both through the
        #: ``_arm_*``/``_disarm_*`` helpers.
        self.data_watches: dict[str, bool] = {}
        self.child_watches: dict[str, bool] = {}
        #: Persistent watches (ADD_WATCH, opcode 106): path -> True
        #: when the subscription is PERSISTENT_RECURSIVE.  These
        #: survive fires — nothing in the dispatch path pops them —
        #: and mirror the WatchTable's persistent/recursive reverse
        #: indexes exactly like the one-shot dicts above.
        self.persistent_watches: dict[str, bool] = {}
        self.closed = False
        self._subscribed = False
        #: Sharded fan-out state (server/watchtable.py): notifications
        #: buffered for this connection within the current tick, and
        #: the shard this connection drains through.
        self._fanout_buf: list[bytes] = []
        self._fanout_shard = 0
        #: First-bytes buffer for four-letter admin word detection: a
        #: real ZK handshake starts with a 4-byte big-endian length
        #: (0x00 0x00 0x00 0x2c-ish), which can never collide with an
        #: ASCII admin word, so the first four bytes decide the
        #: connection's fate exactly once.
        self._admin_buf = b''
        self._admin_checked = False
        #: Sharded-ingress state (io/ingress.py): the owning plane
        #: (None on the single-loop validator path), this
        #: connection's accept shard — the affinity key its watch
        #: fan-out shard reuses — and the raw fd + dirty flag the
        #: shard's batched receive drain keys on.
        self._ingress = None
        self._ingress_shard: int | None = None
        self._rx_fd = -1
        self._rx_dirty = False
        self._rx_skip = False
        #: Overload-plane state (io/overload.py): rx paused (reader
        #: removed / validator loop parked) after an inflight storm,
        #: the validator's resume event, the notification-drop
        #: episode marker, and the eviction reason (None = never
        #: evicted).
        self._rx_paused = False
        self._rx_resume: asyncio.Event | None = None
        self._notif_dropping = False
        self.evicted: str | None = None
        #: Outbound cork (io/sendplane.py): replies and notifications
        #: of one event-loop tick leave as a single writer.write (a
        #: pipelined request batch is answered with one segment) —
        #: or, when the server carries a batched transport tier
        #: (io/transport.py), as this connection's slice of the
        #: tick's ONE batched submission across every dirty
        #: connection.  When the leader database carries a WAL, the
        #: plane gates on it: corked acks wait (in order) for the
        #: off-loop group fsync covering their txns, so no ack byte
        #: reaches the transport before its txn is on disk and the
        #: event loop never blocks on the device (server/persist.py
        #: sync='tick').  With a quorum gate attached the barrier is
        #: the CommitBarrier composition: the same corked tick also
        #: waits for a majority of mirrors to hold the txns — one
        #: wait covers both halves (server/replication.py).
        self._tx = SendPlane(self._tx_write, enabled=server.cork,
                             max_bytes=server.flush_cap,
                             collector=server.collector, plane='server',
                             barrier=server.ack_barrier,
                             ledger=server.ledger,
                             tier=server.transport_tier,
                             transport_fn=lambda: getattr(
                                 self.writer, 'transport', None))

    @property
    def session_id(self):
        """This connection's session id, None before the handshake —
        what OVERLOAD trace spans name the victim by."""
        sess = self.session
        return sess.id if sess is not None else None

    # -- wire helpers --

    def _tx_write(self, data: bytes) -> None:
        try:
            self.writer.write(data)
        except (ConnectionError, RuntimeError):
            pass

    def _write_bytes(self, data: bytes) -> None:
        if self.closed:
            return
        # notifications buffered by the watch table this tick must
        # leave before any later reply: the wire never shows a reply
        # overtaking an earlier notification (ZooKeeper's watch-
        # before-read-result guarantee)
        if self._fanout_buf:
            self._drain_fanout()
        fi = self.server.faults
        if fi is not None and fi.server_tx(self, data,
                                           pre=self._tx.flush_hard):
            return   # the injector took over delivery (split/delay/RST)
        self._tx.send(data)

    def _drain_fanout(self) -> None:
        """Move this connection's buffered (already fault-screened)
        notifications into the send plane, joined, in event order."""
        buf = self._fanout_buf
        if not buf:
            return
        data = buf[0] if len(buf) == 1 else b''.join(buf)
        buf.clear()          # the list object is reused across ticks
        self._tx.send(data)

    def _preflush_fanout(self) -> None:
        """Fault-injection pre-flush: everything this connection has
        corked — buffered notifications AND the plane — hits the wire
        before an injected delivery, so a faulted frame cannot
        reorder (the send plane's boundary rule)."""
        self._drain_fanout()
        self._tx.flush_hard()

    def _send(self, pkt: dict) -> None:
        if self.closed:
            return
        self.server.packets_sent += 1
        self._write_bytes(self.codec.encode(pkt))

    def _reply(self, xid: int, opcode: str, err: str = 'OK',
               **body) -> None:
        if self.server.drop_replies:
            return
        if self.server.drop_pings and opcode == 'PING':
            return
        # the header zxid is this MEMBER's last applied transaction —
        # a lagging follower honestly reports its own position
        z = self.store.zxid
        sess = self.session
        if sess is not None and z > sess.last_zxid:
            # the session has now SEEN this member state: the zxid
            # read gate's floor (ReadGate) advances with every reply
            sess.last_zxid = z
        pkt = {'xid': xid, 'zxid': z, 'err': err, 'opcode': opcode}
        pkt.update(body)
        self._send(pkt)

    def notify(self, ntype: str, path: str, zxid: int,
               persistent: bool = False) -> None:
        """Send one watch notification directly (the SET_WATCHES
        catch-up path; event-driven fan-out goes through the server's
        WatchTable instead).  The bytes come from the server-owned
        encode cache/memo, shared across subscribers.

        ``persistent=True`` applies the persistent-subscriber
        overload contract: the soft watermark EVICTS instead of
        dropping (a silent gap would wedge a watch-backed cache
        stale — io/overload.py ``allow_persistent_notification``)."""
        if self.closed:
            return
        ov = self.server.overload
        if ov is not None:
            # soft tx watermark: a stalled one-shot subscriber loses
            # watch notifications (the legally lossy channel) before
            # it can bloat the member; a stalled PERSISTENT
            # subscriber is evicted instead — never a silent gap;
            # the hard watermark evicts either outright
            if persistent:
                if not ov.allow_persistent_notification(self):
                    return
            elif not ov.allow_notification(self):
                return
            if ov.check_tx(self):
                return
        self.server.packets_sent += 1
        self._write_bytes(
            self.server.encode_notification(ntype, path, zxid))

    # -- watch dispatch (store change events -> this connection) --

    def _subscribe(self) -> None:
        if self._subscribed:
            return
        self._subscribed = True
        if self.server.watch_table is not None:
            # table mode (default): the server's one listener set per
            # store consults the reverse index; this connection only
            # joins a fan-out shard
            self.server.watch_table.add_conn(self)
            return
        # emitter fallback (ZKSTREAM_NO_WATCHTABLE=1): per-connection
        # store listeners, each event filtered against this
        # connection's own dicts — the validator path.  Node-change
        # events come from THIS member's store (a watch on a lagging
        # follower fires when the follower applies the transaction).
        self.store.on('created', self._on_created)
        self.store.on('deleted', self._on_deleted)
        self.store.on('dataChanged', self._on_data_changed)
        self.store.on('childrenChanged', self._on_children_changed)

    def _unsubscribe(self) -> None:
        if not self._subscribed:
            return
        self._subscribed = False
        if self.server.watch_table is not None:
            self.server.watch_table.remove_conn(self)
            return
        self.store.remove_listener('created', self._on_created)
        self.store.remove_listener('deleted', self._on_deleted)
        self.store.remove_listener('dataChanged', self._on_data_changed)
        self.store.remove_listener('childrenChanged',
                                   self._on_children_changed)

    def _on_created(self, path: str, zxid: int) -> None:
        if self.data_watches.pop(path, None):
            self.notify('CREATED', path, zxid)
        if self._persistent_hit(path, False):
            self.notify('CREATED', path, zxid, persistent=True)

    def _on_deleted(self, path: str, zxid: int) -> None:
        if self.data_watches.pop(path, None):
            self.notify('DELETED', path, zxid)
        if self.child_watches.pop(path, None):
            self.notify('DELETED', path, zxid)
        if self._persistent_hit(path, False):
            self.notify('DELETED', path, zxid, persistent=True)

    def _on_data_changed(self, path: str, zxid: int) -> None:
        if self.data_watches.pop(path, None):
            self.notify('DATA_CHANGED', path, zxid)
        if self._persistent_hit(path, False):
            self.notify('DATA_CHANGED', path, zxid, persistent=True)

    def _on_children_changed(self, path: str, zxid: int) -> None:
        if self.child_watches.pop(path, None):
            self.notify('CHILDREN_CHANGED', path, zxid)
        # recursive subscribers never get CHILDREN_CHANGED: they see
        # the child's own CREATED/DELETED instead (upstream semantics)
        if self._persistent_hit(path, True):
            self.notify('CHILDREN_CHANGED', path, zxid, persistent=True)

    def _persistent_hit(self, path: str, exact_only: bool) -> bool:
        """Emitter-fallback persistent-watch match: True when this
        connection holds a persistent watch on ``path`` itself, or —
        unless ``exact_only`` — a PERSISTENT_RECURSIVE watch on any
        ancestor.  Never consumes: the subscription survives fires."""
        pw = self.persistent_watches
        if not pw:
            return False
        if path in pw:
            if exact_only:
                # CHILDREN_CHANGED goes only to exact PERSISTENT
                # subscriptions, not recursive ones
                return not pw[path]
            return True
        if exact_only:
            return False
        p = path
        while len(p) > 1:
            i = p.rfind('/')
            p = p[:i] if i > 0 else '/'
            if pw.get(p):
                return True
        return False

    # -- watch arming (both paths: connection dict + table index) --

    def _arm_data(self, path: str) -> None:
        if path not in self.data_watches:
            self.data_watches[path] = True
            if self.server.watch_table is not None:
                self.server.watch_table.arm('data', path, self)

    def _arm_child(self, path: str) -> None:
        if path not in self.child_watches:
            self.child_watches[path] = True
            if self.server.watch_table is not None:
                self.server.watch_table.arm('child', path, self)

    def _disarm_data(self, path: str) -> None:
        if self.data_watches.pop(path, None):
            if self.server.watch_table is not None:
                self.server.watch_table.disarm('data', path, self)

    def _disarm_child(self, path: str) -> None:
        if self.child_watches.pop(path, None):
            if self.server.watch_table is not None:
                self.server.watch_table.disarm('child', path, self)

    def _arm_persistent(self, path: str, recursive: bool) -> None:
        prev = self.persistent_watches.get(path)
        if prev is recursive:
            return
        if prev is not None:
            # mode change (PERSISTENT <-> PERSISTENT_RECURSIVE):
            # re-home the subscription in the other reverse index
            self._disarm_persistent(path)
        self.persistent_watches[path] = recursive
        if self.server.watch_table is not None:
            self.server.watch_table.arm_persistent(path, self, recursive)

    def _disarm_persistent(self, path: str) -> None:
        recursive = self.persistent_watches.pop(path, None)
        if recursive is not None:
            if self.server.watch_table is not None:
                self.server.watch_table.disarm_persistent(
                    path, self, recursive)

    # -- lifecycle --

    async def run(self) -> None:
        """The single-loop validator's receive pump (the sharded
        ingress plane never calls this — its per-shard batched drain
        feeds :meth:`feed` directly)."""
        rx_buf = self.server.rx_buf
        ctr = self.server._recv_ctr
        labels = self.server._recv_labels
        try:
            while not self.closed:
                if self._rx_paused:
                    # inflight throttle (io/overload.py): park the
                    # pump instead of reading — the kernel buffer
                    # fills and TCP pushes back on the client
                    gate = self._rx_resume = asyncio.Event()
                    await gate.wait()
                    self._rx_resume = None
                    continue
                data = await self.reader.read(rx_buf)
                if not data:
                    break
                if ctr is not None:
                    # the rx-direction syscall accounting's validator
                    # arm: one wakeup, one read per connection
                    ctr.increment(labels)
                if not self.feed(data):
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            self.close()

    def feed(self, data: bytes) -> bool:
        """Decode + dispatch one received chunk (any byte offset: the
        codec accumulates partial frames).  Both receive paths end
        here — the validator's ``read()`` loop above and the ingress
        plane's batched drain.  Returns False when the connection is
        done (admin word served, undecodable input).

        Fault injection happens HERE, per connection-chunk, BEFORE
        any decode — the receive-side mirror of the send plane's
        before-the-cork rule: an injected split/delay/reset perturbs
        this connection's stream identically on every rx backend."""
        fi = self.server.faults
        if fi is not None and fi.server_rx(self, data):
            return True   # the injector took over delivery
        return self._feed(data)

    def _feed(self, data: bytes) -> bool:
        """The injector-free half of :meth:`feed` (fault gates
        deliver their delayed segments through this, so a faulted
        chunk is never re-screened)."""
        if not self._admin_checked:
            # ZooKeeper four-letter words arrive raw (no length
            # prefix) as the connection's first bytes.
            self._admin_buf += data
            if len(self._admin_buf) < 4:
                return True
            self._admin_checked = True
            word = self._admin_buf[:4]
            if word == RECONFIG_WORD:
                # argument-bearing admin word: keep buffering until
                # the line's newline arrives (re-arming the check so
                # the next chunk lands back here)
                if b'\n' not in self._admin_buf:
                    self._admin_checked = False
                    return True
                line = self._admin_buf.split(b'\n', 1)[0]
                self._handle_reconfig(
                    line[4:].decode('utf-8', 'replace').strip())
                # keep the connection open: unlike the synchronous
                # words, the reply may await a quorum — the handler
                # task writes it and closes
                return True
            if word in ADMIN_WORDS:
                self._handle_admin(word.decode('ascii'))
                return False
            # not an admin word: replay everything buffered
            # through the normal codec path
            data, self._admin_buf = self._admin_buf, b''
        # the tick ledger's decode_apply phase covers the
        # whole decode + dispatch burst (store apply and WAL
        # append included; nested sync/flush phases subtract)
        ledger = self.server.ledger
        if ledger is not None:
            ledger.enter('decode_apply')
        try:
            try:
                pkts = self.codec.decode(data)
            except ZKFrameTooLargeError as e:
                # the jute.maxbuffer analogue: the length prefix is
                # rejected BEFORE the frame buffers; the close is a
                # traced, typed eviction, not a silent drop
                ov = self.server.overload
                if ov is not None:
                    ov.evict(self, 'frame_too_large',
                             buffered=e.length)
                else:
                    log.debug('server: oversized frame: %s', e)
                return False
            except ZKProtocolError as e:
                log.debug('server: undecodable input: %s', e)
                return False
            ov = self.server.overload
            if ov is not None and pkts:
                # an inflight storm — one drain decoding a whole
                # pipelined burst — pauses this connection's rx
                ov.after_drain(self, len(pkts))
            trace = self.server.trace
            if trace is not None and pkts and not (
                    len(pkts) == 1
                    and pkts[0].get('opcode') == 'PING'):
                # bare keepalive pings skip the ring: at fleet
                # scale they are most batches, and recording
                # them would wash the txn chains out of the
                # bounded window (and cost a span per ping)
                trace.note('SRV_DECODE', kind='server',
                           batch=len(pkts), nbytes=len(data))
            # Outstanding accounting is batch-scoped: a
            # pipelined read delivers N requests at once, and
            # every one is outstanding until its handler
            # replies.  (Handlers are synchronous today, so a
            # concurrent mntr scrape observes nonzero only
            # across a handler that awaits — e.g. via an
            # injected fault gate — but the accounting stays
            # correct if handlers ever grow await points.)
            self.server.outstanding += len(pkts)
            remaining = len(pkts)
            try:
                for pkt in pkts:
                    self.server.packets_received += 1
                    if self.codec.handshaking:
                        self._handle_connect(pkt)
                    else:
                        self._handle_request(pkt)
                    self.server.outstanding -= 1
                    remaining -= 1
                    if self.closed:
                        break
            finally:
                # a close/raise mid-batch must still retire
                # the unhandled remainder from the gauge
                self.server.outstanding -= remaining
        finally:
            if ledger is not None:
                ledger.exit()
        ov = self.server.overload
        if ov is not None and not self.closed:
            # the validator twin of the ingress drain's hard-watermark
            # boundary (io/ingress.py): a reply backlog that outgrew
            # ZKSTREAM_TX_HARD evicts here too — a pipelined reader
            # that stops draining must not bloat the member just
            # because this server runs without the sharded ingress
            if ov.check_tx(self):
                return False
        return True

    def _handle_admin(self, word: str) -> None:
        """Serve one four-letter admin word: raw text reply, then
        close — real ZK's mntr/ruok/stat/srvr contract.  Synchronous:
        ``transport.close`` flushes the buffered reply before the FIN
        on both receive paths."""
        text = self.server.admin_text(word)
        try:
            self.writer.write(text.encode('utf-8'))
        except (ConnectionError, RuntimeError):
            pass
        self.close()

    def _handle_reconfig(self, args: str) -> None:
        """Serve one ``rcfg`` admin line.  Unlike the synchronous
        four-letter words, ``apply`` awaits the joint-quorum commit —
        so the handler runs as a task; reply text, then close."""
        async def _run() -> None:
            try:
                text = await self.server.reconfig_admin(args)
            except Exception as e:
                text = 'error %s\n' % (e,)
            if self.closed:
                return
            try:
                self.writer.write(text.encode('utf-8'))
            except (ConnectionError, RuntimeError):
                pass
            self.close()
        from ..utils.aio import ambient_loop
        self._rcfg_task = ambient_loop().create_task(_run())

    def close(self) -> None:
        if self.closed:
            return
        # corked replies (e.g. the CLOSE_SESSION ack) and buffered
        # notifications must beat the FIN — and their durability
        # barrier, taken synchronously
        self._drain_fanout()
        self._tx.flush_hard()
        self.closed = True
        self._unsubscribe()
        if self._ingress is not None:
            self._ingress.forget(self)
        if self.session is not None and self.session.owner is self:
            self.session.owner = None
        self.server.conns.discard(self)
        try:
            self.writer.close()
        except (ConnectionError, RuntimeError):
            pass

    def abort(self) -> None:
        """The evicting close (io/overload.py): DISCARD everything
        buffered for this connection and reset the transport —
        flushing into the wedged socket is exactly how the bloat
        happened, so unlike :meth:`close` nothing is drained."""
        if self.closed:
            return
        self.closed = True
        self._fanout_buf.clear()
        self._tx.reset()
        self._unsubscribe()
        if self._ingress is not None:
            self._ingress.forget(self)
        if self.session is not None and self.session.owner is self:
            self.session.owner = None
        self.server.conns.discard(self)
        gate = self._rx_resume
        if gate is not None:
            gate.set()      # the parked validator pump exits its loop
        try:
            t = getattr(self.writer, 'transport', None)
            if t is not None:
                t.abort()
            else:
                self.writer.close()
        except (ConnectionError, RuntimeError):
            pass

    # -- handshake (session create / resume / migrate) --

    def _handle_connect(self, pkt: dict) -> None:
        timeout = pkt['timeOut']
        if pkt['sessionId'] == 0:
            sess = self.db.create_session(timeout)
        else:
            sess = self.db.resume_session(pkt['sessionId'], pkt['passwd'])
            if sess is None:
                # Unknown/expired session: zero id tells the client its
                # session is gone.
                self._send({'protocolVersion': 0, 'timeOut': timeout,
                            'sessionId': 0, 'passwd': b'\x00' * 16})
                self.codec.handshaking = False
                return
            # Session migration: drop the previous serving connection.
            if sess.owner is not None and sess.owner is not self:
                sess.owner.close()
        # the handshake's lastZxidSeen seeds the zxid read-gate floor:
        # what this session observed through OTHER members (or a
        # previous session of the same client) must not be readable
        # backwards here — the cross-process half of the session-view
        # contract (in-process members share the session object)
        seen = pkt.get('lastZxidSeen', 0)
        if seen > sess.last_zxid:
            sess.last_zxid = seen
        sess.owner = self
        self.session = sess
        self._send({'protocolVersion': 0, 'timeOut': sess.timeout,
                    'sessionId': sess.id, 'passwd': sess.passwd})
        self.codec.handshaking = False
        self._subscribe()

    # -- request dispatch --

    def _handle_request(self, pkt: dict) -> None:
        if self.session is None or self.session.expired:
            self._reply(pkt['xid'], pkt['opcode'], err='SESSION_EXPIRED')
            return
        self.db.touch_session(self.session)
        op = pkt['opcode']
        xid = pkt['xid']
        try:
            handler = getattr(self, '_op_' + op.lower(), None)
            if handler is None:
                self._reply(xid, op, err='UNIMPLEMENTED')
                return
            handler(pkt)
        except ZKOpError as e:
            # Failed reads with a watch flag still arm existence watches
            # where the protocol says so (handled inside the op); other
            # failures just carry the code.
            self._reply(xid, op, err=e.code)

    def _op_ping(self, pkt: dict) -> None:
        self._reply(pkt['xid'], 'PING')

    def _check_fence(self) -> None:
        """Epoch fence (server/election.py): a deposed member — one
        still serving at an epoch the quorum has moved past — must
        bounce writes with a typed error, never apply them."""
        fence = self.server.fence
        if fence is not None and fence():
            raise ZKOpError('EPOCH_FENCED')

    def _check_throttle(self, op: str) -> None:
        """Global memory watermark (io/overload.py): a member whose
        aggregate tx backlog crossed ``ZKSTREAM_MEM_SOFT`` is in
        degraded mode — new writes bounce with the typed THROTTLED
        error (definite failure, nothing applied; the client backs
        off and retries) while reads keep flowing."""
        ov = self.server.overload
        if ov is not None and ov.write_throttled():
            ov.count_throttled(op)
            raise ZKOpError('THROTTLED')

    def _gated(self, pkt: dict) -> bool:
        """True when the zxid read gate parked this read: the serving
        member's replica trails what this session has already seen, so
        serving now could show the session an older state.  The gate
        re-dispatches the packet once the replica catches up, or
        bounces it after the bounded wait (ReadGate).  Leader-view
        members are always current; ``ZKSTREAM_NO_READ_GATE=1`` keeps
        the ungated path as the env-gated validator arm."""
        gate = self.server.read_gate
        if gate is None or self.store is self.db:
            return False
        floor = self.session.last_zxid
        if self.store.zxid >= floor:
            return False
        gate.defer(self, pkt, floor)
        return True

    def _op_create(self, pkt: dict) -> None:
        self._check_fence()
        self._check_throttle('CREATE')
        path = self.db.create(pkt['path'], pkt['data'], pkt['acl'],
                              CreateFlag(pkt['flags']), self.session)
        # a write through this member catches its store up through the
        # transaction (real ZK: the follower commits before replying),
        # so the author can always read their own write here
        self.store.catch_up()
        self._reply(pkt['xid'], 'CREATE', path=path)

    def _op_delete(self, pkt: dict) -> None:
        self._check_fence()
        self._check_throttle('DELETE')
        self.db.delete(pkt['path'], pkt['version'])
        self.store.catch_up()
        self._reply(pkt['xid'], 'DELETE')

    def _op_get_data(self, pkt: dict) -> None:
        if self._gated(pkt):
            return
        try:
            data, stat = self.store.get_data(pkt['path'])
        except ZKOpError:
            raise
        if pkt.get('watch'):
            self._arm_data(pkt['path'])
        self._reply(pkt['xid'], 'GET_DATA', data=data, stat=stat)

    def _op_set_data(self, pkt: dict) -> None:
        self._check_fence()
        self._check_throttle('SET_DATA')
        stat = self.db.set_data(pkt['path'], pkt['data'], pkt['version'])
        self.store.catch_up()
        self._reply(pkt['xid'], 'SET_DATA', stat=stat)

    def _op_exists(self, pkt: dict) -> None:
        if self._gated(pkt):
            return
        try:
            stat = self.store.exists(pkt['path'])
        except ZKOpError:
            # EXISTS with watch on a missing node arms an existence
            # watch that fires CREATED later.
            if pkt.get('watch'):
                self._arm_data(pkt['path'])
            raise
        if pkt.get('watch'):
            self._arm_data(pkt['path'])
        self._reply(pkt['xid'], 'EXISTS', stat=stat)

    def _op_get_children(self, pkt: dict) -> None:
        if self._gated(pkt):
            return
        children, stat = self.store.get_children(pkt['path'])
        if pkt.get('watch'):
            self._arm_child(pkt['path'])
        self._reply(pkt['xid'], 'GET_CHILDREN', children=children)

    def _op_get_children2(self, pkt: dict) -> None:
        if self._gated(pkt):
            return
        children, stat = self.store.get_children(pkt['path'])
        if pkt.get('watch'):
            self._arm_child(pkt['path'])
        self._reply(pkt['xid'], 'GET_CHILDREN2', children=children,
                    stat=stat)

    def _op_get_acl(self, pkt: dict) -> None:
        if self._gated(pkt):
            return
        acl, stat = self.store.get_acl(pkt['path'])
        self._reply(pkt['xid'], 'GET_ACL', acl=acl, stat=stat)

    def _op_multi(self, pkt: dict) -> None:
        """One all-or-nothing MULTI transaction (opcode 14): the
        whole batch is ONE leader transaction — one WAL record, one
        group-fsync slot, one replication push element (store.py
        ``ZKDatabase.multi``).  The reply always decodes a result
        body: a rejected batch carries per-op error results (the
        failing op's code, RUNTIME_INCONSISTENCY elsewhere) with NO
        sub-op applied."""
        self._check_fence()
        self._check_throttle('MULTI')
        results = self.db.multi(pkt['ops'], self.session)
        self.store.catch_up()
        self._reply(pkt['xid'], 'MULTI', results=results)

    def _op_sync(self, pkt: dict) -> None:
        # Flush replication: this member applies everything the leader
        # has committed before replying, so a read issued after the
        # sync reply cannot see state older than the sync point —
        # the guarantee the reference test relies on
        # (multi-node.test.js:107-165).  sync_flush, not catch_up: a
        # cross-process member must fetch the leader's log first.
        self.store.sync_flush()
        self._reply(pkt['xid'], 'SYNC')

    def _op_close_session(self, pkt: dict) -> None:
        self.db.close_session(self.session.id)
        self._reply(pkt['xid'], 'CLOSE_SESSION')
        self.close()

    def _op_set_watches(self, pkt: dict) -> None:
        """Re-arm watches after reconnect, sending catch-up
        notifications for anything that moved past relZxid."""
        self._replay_one_shot(pkt['relZxid'], pkt['events'])
        self._reply(pkt['xid'], 'SET_WATCHES')

    def _op_set_watches2(self, pkt: dict) -> None:
        """SET_WATCHES2 (opcode 107): the five-list replay — the
        legacy three one-shot kinds plus ``persistent`` and
        ``persistentRecursive``.  Persistent re-arms always succeed
        (the subscription survives the reconnect); the catch-up nudge
        tells the subscriber its gap, so a watch-backed cache knows to
        refetch rather than trust its pre-disconnect contents."""
        rel = pkt['relZxid']
        events = pkt['events']
        self._replay_one_shot(rel, events)
        z = self.store.zxid
        for path in events.get('persistent', ()):
            self._arm_persistent(path, False)
            node = self.store.nodes.get(path)
            if node is None:
                self.notify('DELETED', path, z, persistent=True)
            elif node.mzxid > rel:
                self.notify('DATA_CHANGED', path, node.mzxid,
                            persistent=True)
        for path in events.get('persistentRecursive', ()):
            self._arm_persistent(path, True)
            # a subtree gap cannot be replayed per-node without a
            # change journal; one nudge at the subtree root marks the
            # whole span dirty and the subscriber refetches
            if z > rel:
                self.notify('DATA_CHANGED', path, z, persistent=True)
        self._reply(pkt['xid'], 'SET_WATCHES2')

    def _op_add_watch(self, pkt: dict) -> None:
        """ADD_WATCH (opcode 106): arm a persistent (mode 0) or
        persistent-recursive (mode 1) watch.  Unlike every other watch
        arm, this one is not a side effect of a read — it is its own
        round trip, and it survives fires without re-arm."""
        mode = pkt['mode']
        if mode not in (0, 1):
            raise ZKOpError('BAD_ARGUMENTS')
        self._arm_persistent(pkt['path'], mode == 1)
        self._reply(pkt['xid'], 'ADD_WATCH')

    def _replay_one_shot(self, rel: int, events: dict) -> None:
        # catch-up decisions run against THIS member's view: a node
        # change the member has not applied yet fires later through the
        # re-armed watch table when the replica applies it
        z = self.store.zxid
        for path in events.get('dataChanged', ()):
            node = self.store.nodes.get(path)
            if node is None:
                self.notify('DELETED', path, z)
            elif node.mzxid > rel:
                # moved past relZxid: the catch-up notification IS the
                # one-shot fire — it consumes any pre-existing arm
                # instead of re-arming
                self._disarm_data(path)
                self.notify('DATA_CHANGED', path, node.mzxid)
            else:
                self._arm_data(path)
        for path in events.get('createdOrDestroyed', ()):
            node = self.store.nodes.get(path)
            if node is None:
                # Missing node: the watcher may have seen it alive, so
                # send DELETED (real ZK does the same for exist watches
                # — it cannot know the node never existed either).
                self.notify('DELETED', path, z)
            elif node.czxid > rel:
                self.notify('CREATED', path, node.czxid)
            else:
                self._arm_data(path)
        for path in events.get('childrenChanged', ()):
            node = self.store.nodes.get(path)
            if node is None:
                self.notify('DELETED', path, z)
            elif node.pzxid > rel:
                self._disarm_child(path)
                self.notify('CHILDREN_CHANGED', path, node.pzxid)
            else:
                self._arm_child(path)


class ZKServer:
    """One listening endpoint — a quorum member.  Writes and sessions
    go to the leader ``db``; reads and watches are served from this
    member's ``store`` (the leader's own tree for a standalone server
    or the ensemble leader, a :class:`~.store.ReplicaStore` for a
    follower)."""

    def __init__(self, db: ZKDatabase | None = None,
                 host: str = '127.0.0.1', port: int = 0,
                 store=None, cork: bool | None = None,
                 collector=None, durability: str | None = None,
                 wal_dir: str | None = None,
                 watchtable: bool | None = None,
                 fanout_shards: int | None = None,
                 member: str | None = None,
                 trace: bool | None = None,
                 transport: str | None = None,
                 flush_cap: int | None = None,
                 ingress_shards: int | None = None,
                 ingress_backend: str | None = None,
                 blackbox: bool | None = None,
                 blackbox_dir: str | None = None,
                 overload: bool | None = None,
                 overload_config: OverloadConfig | None = None,
                 max_frame: int | None = None):
        #: Durability plane (server/persist.py).  When this server
        #: owns its database (``db=None``) and a WAL directory is
        #: resolved — the ``wal_dir`` argument or ``ZKSTREAM_WAL_DIR``
        #: — the database is recovered from disk and every committed
        #: txn is logged before its ack; ``durability`` picks the
        #: fsync policy ('always' | 'tick' | 'never', default 'tick').
        #: ``ZKSTREAM_NO_WAL=1`` is the global kill switch.  An
        #: ensemble attaches its WAL once on the shared database
        #: instead (ZKEnsemble); followers carry none.
        self._owns_wal = False
        if db is None:
            from .persist import (
                default_wal_dir,
                open_wal_database,
                wal_enabled,
            )
            resolved = wal_dir or default_wal_dir()
            if resolved and wal_enabled():
                db = open_wal_database(resolved,
                                       sync=durability or 'tick',
                                       collector=collector)
                self._owns_wal = True
            else:
                db = ZKDatabase()
        self.db = db
        self.store = store if store is not None else self.db
        self.host = host
        self.port = port
        #: This member's id within its ensemble ('0' standalone /
        #: leader; ZKEnsemble numbers its members) — the label every
        #: span on this member's ring carries, and what the merged
        #: timeline names it by.
        self.member = member if member is not None else '0'
        #: The server-side trace plane (utils/trace.py): this member's
        #: bounded span ring plus the per-tick phase ledger
        #: (utils/metrics.TickLedger).  None = process default
        #: (``ZKSTREAM_NO_SERVER_TRACE=1`` disables), True/False
        #: force — the A/B knob `bench.py --traceov` pairs on.
        enabled_trace = (server_trace_default() if trace is None
                         else trace)
        self.trace = (TraceRing(MEMBER_RING_CAPACITY,
                                member=self.member)
                      if enabled_trace else None)
        self.ledger = TickLedger(collector) if enabled_trace else None
        if enabled_trace:
            if self.store is self.db:
                # leader/standalone member: the shared database's
                # COMMIT spans, the WAL's append/fsync spans and its
                # loop-blocking sync time all belong to this ring
                self.db.trace = self.trace
                wal = getattr(self.db, 'wal', None)
                if wal is not None:
                    wal.trace = self.trace
                    wal.ledger = self.ledger
            else:
                # follower: the replica's APPLY spans land here (the
                # RemoteReplicaStore of an OS-process follower
                # included — same attribute)
                self.store.trace = self.trace
        #: Outbound write coalescing for accepted connections
        #: (io/sendplane.py): None = process default, True/False force.
        self.cork = cork
        #: Early-flush cap for accepted connections' planes (None =
        #: ZKSTREAM_FLUSH_CAP / the 256 KiB default).
        self.flush_cap = flush_cap
        #: Optional utils/metrics.Collector: when set, accepted
        #: connections record their flush-batch-size histograms here.
        self.collector = collector
        #: Batched-syscall transport tier (io/transport.py): one
        #: submission queue shared by every accepted connection's
        #: send plane — a corked tick's replies and fan-out flushes
        #: leave in ONE batched syscall chain on the uring backend
        #: (one writev per dirty conn, submitted in one C call, on
        #: mmsg).  None when the resolved backend is 'asyncio' (the
        #: env-gated validator: ZKSTREAM_TRANSPORT=asyncio).
        #: ``transport=`` forces a tier like the cork/codec knobs.
        from ..io.transport import make_tier
        self.transport_tier = make_tier(transport, collector=collector,
                                        plane='server',
                                        ledger=self.ledger)
        #: Shared-nothing ingress (io/ingress.py): N accept shards,
        #: each draining its dirty connections' bytes in ONE batched
        #: receive per busy tick, replacing the per-connection
        #: ``reader.read`` task wakeup.  None = the single-loop
        #: validator (``ingress_shards=1`` / ``ZKSTREAM_INGRESS_
        #: SHARDS=1`` / a resolved ``asyncio`` backend via
        #: ``ZKSTREAM_INGRESS``), which keeps ``asyncio.start_server``
        #: exactly as before.  ``rx_buf`` is the receive-buffer size
        #: both paths read with (``ZKSTREAM_RX_BUF``, formerly the
        #: hardcoded 65536).
        self.rx_buf = rx_buf_default()
        self.ingress = make_plane(self, ingress_shards,
                                  ingress_backend,
                                  collector=collector)
        #: rx-direction syscall accounting for the validator path
        #: (the ingress plane counts its own drains): one increment
        #: per ``reader.read`` wakeup, same metric, same label keys.
        self._recv_ctr = None
        self._recv_labels = {'plane': 'server', 'backend': 'asyncio'}
        if collector is not None:
            self._recv_ctr = collector.counter(
                METRIC_RECV_SYSCALLS,
                'Receive submissions issued by the ingress plane, by '
                'plane and backend')
        self._server: asyncio.base_events.Server | None = None
        self.conns: set[ServerConnection] = set()
        #: Fault-injection knobs for tests: swallow pings (forces the
        #: client's ping-timeout path) or swallow every reply (forces
        #: in-flight requests to hang until teardown).
        self.drop_pings = False
        self.drop_replies = False
        #: Optional seeded FaultInjector (io/faults.py): accept-loop
        #: refusals and reply-path splits/delays/mid-frame resets.
        self.faults = None
        #: one-slot encode cache for the emitter-fallback notification
        #: path ((type, path, zxid), wire bytes), filled via the
        #: dedicated connection-independent codec below (the bytes are
        #: shared across subscribers, so no per-connection codec may
        #: encode them); the watch table replaces it with a per-tick
        #: memo (server/watchtable.py)
        self._notif_cache: tuple[tuple, bytes] | None = None
        self._notif_codec = PacketCodec(server=True)
        self._notif_codec.handshaking = False
        #: The serving plane's sharded watch fan-out
        #: (server/watchtable.py): a reverse (kind, path) → subscriber
        #: index consulted once per store event, with per-shard corked
        #: notification flushes.  None = process default
        #: (``ZKSTREAM_NO_WATCHTABLE=1`` falls back to the
        #: per-connection emitter path), True/False force.
        enabled = watchtable_default() if watchtable is None \
            else watchtable
        if fanout_shards is None and self.ingress is not None:
            # ingress affinity: one fan-out shard per accept shard,
            # so a connection's arms, fan-out buffer and send-plane
            # cork all key off the shard that drains it
            fanout_shards = self.ingress.nshards
        self.watch_table = WatchTable(self, shards=fanout_shards,
                                      collector=collector) \
            if enabled else None
        #: Session expiry is dispatched once per member through the
        #: session's ``owner`` pointer (the session-id → connection
        #: map the database already maintains) — O(1) per expiry, not
        #: one callback per connection.
        self.db.on('sessionExpired', self._on_session_expired)
        #: Introspection counters for the four-letter admin words
        #: (mntr/stat/srvr): requests decoded, replies/notifications
        #: sent, and requests decoded but not yet replied (batch-
        #: scoped: a pipelined read's whole batch counts until each
        #: member's handler returns).
        self.packets_received = 0
        self.packets_sent = 0
        self.outstanding = 0
        #: Election plane (server/election.py).  ``role`` is this
        #: member's current quorum role (leader | follower |
        #: electing); ``fence`` an optional callable — True while this
        #: member is deposed at a stale epoch, making every write
        #: through it bounce with a typed EPOCH_FENCED error instead
        #: of being applied against history the quorum moved past.
        #: ``elections`` counts role resolutions on THIS member;
        #: ``elections_ref`` (set by an ElectionCoordinator) supplies
        #: the ensemble-wide count the mntr row prefers.
        self.role = 'leader' if self.store is self.db else 'follower'
        self.fence = None
        self.elections = 0
        self.elections_ref = None
        #: Quorum-commit gate (server/replication.py QuorumGate):
        #: when attached, accepted connections' acks gate on it
        #: ALONGSIDE the WAL's group fsync (CommitBarrier) — a corked
        #: tick waits once for both.  A ZKEnsemble wires one shared
        #: gate over its follower stores; the OS-process leader wires
        #: its ReplicationService's.  None = fsync-only barrier (the
        #: standalone / validator arm).
        self.quorum = None
        #: Zxid read gate (README "Read plane"): reads through this
        #: member park until its replica has applied everything the
        #: session already observed, or bounce after the bounded wait
        #: — the session view never goes backwards
        #: (analysis/linearize.py check_session_reads is the
        #: acceptance).  None = ``ZKSTREAM_NO_READ_GATE=1``, the
        #: env-gated ungated validator the checker must catch.
        self.read_gate = (ReadGate(self, collector=collector)
                          if read_gate_enabled() else None)
        #: The overload plane (io/overload.py): admission caps +
        #: handshake pacer, the per-connection inflight rx throttle,
        #: tx watermarks with slow-consumer eviction, and the global
        #: memory watermark that bounces writes THROTTLED.  None =
        #: ``ZKSTREAM_NO_OVERLOAD=1`` (or ``overload=False``), the
        #: validator arm with the pre-overload byte-stream — which is
        #: why ``max_frame`` pins to MAX_PACKET when the plane is off.
        enabled_ov = (overload_enabled() if overload is None
                      else overload)
        self.max_frame = (resolve_frame_cap(max_frame) if enabled_ov
                          else MAX_PACKET)
        self.overload = (OverloadPlane(self, cfg=overload_config,
                                       collector=collector)
                         if enabled_ov else None)
        #: Per-instance listen backlog (shadows the class default):
        #: ``ZKSTREAM_LISTEN_BACKLOG`` > the kernel's somaxconn clamp
        #: > the class default — see the note at the class attribute.
        self.BACKLOG = self._resolve_backlog()
        #: ``zookeeper_reconfig_ms`` histogram (lazy: registered on
        #: the first membership change this member drives, so the
        #: steady-state metric inventory is unchanged when dynamic
        #: membership is never exercised).
        self._rcfg_hist = None
        #: The ``zk_uptime_ms`` epoch (construction, like real ZK's
        #: server start).
        self._started_at = time.monotonic()
        #: The black-box plane (utils/blackbox.py): a crash-durable
        #: flight recorder co-tenant in this member's WAL directory —
        #: only a member with one has somewhere durable to write.
        #: ``blackbox=`` forces on/off (``ZKSTREAM_NO_BLACKBOX=1`` is
        #: the process default / kill switch); ``blackbox_dir=`` gives
        #: a member without its own WAL (ensemble followers share the
        #: leader's log; OS-process members own a wal_dir either way)
        #: a ring of its own.
        from ..utils.blackbox import (
            BlackBoxRecorder,
            blackbox_enabled,
            slow_op_ms,
        )
        enabled_bb = (blackbox_enabled() if blackbox is None
                      else blackbox)
        bb_dir = blackbox_dir
        if bb_dir is None and self._owns_wal:
            bb_dir = self.db.wal.dir
        self.blackbox = (BlackBoxRecorder(bb_dir, member=self.member,
                                          server=self,
                                          collector=collector)
                         if enabled_bb and bb_dir else None)
        if self.blackbox is not None and self.trace is not None:
            # the slow-op digest: spans settled on this member's ring
            # at/over the threshold get their causal chain persisted
            self.trace.slow_ms = slow_op_ms()
            self.trace.on_slow = self.blackbox.slow_span

    @property
    def ack_barrier(self):
        """What accepted connections' send planes gate acks on: the
        database's WAL (group fsync), composed with the quorum gate
        when one is attached — ack-order contract: no reply byte may
        reach the transport before BOTH have cleared."""
        wal = getattr(self.db, 'wal', None)
        q = self.quorum
        if q is not None and q.enabled:
            from .replication import CommitBarrier
            return CommitBarrier(wal, q)
        return wal

    def encode_notification(self, ntype: str, path: str,
                            zxid: int) -> bytes:
        """Wire bytes for one notification, shared across subscribers:
        the watch table's per-tick memo when the table is on, the
        legacy depth-1 cache on the emitter fallback."""
        if self.watch_table is not None:
            return self.watch_table.encode(ntype, path, zxid)
        key = (ntype, path, zxid)
        cache = self._notif_cache
        if cache is not None and cache[0] == key:
            return cache[1]
        data = self._notif_codec.encode(
            {'xid': XID_NOTIFICATION, 'zxid': zxid, 'err': 'OK',
             'opcode': 'NOTIFICATION', 'type': ntype,
             'state': 'SYNC_CONNECTED', 'path': path})
        self._notif_cache = (key, data)
        return data

    def _on_session_expired(self, session_id: int) -> None:
        """One callback per member per expiry: the expiring session's
        ``owner`` pointer names the serving connection directly, so no
        connection scan happens (and members not serving the session
        do nothing)."""
        sess = self.db.sessions.get(session_id)
        owner = getattr(sess, 'owner', None)
        if owner is not None and owner in self.conns:
            owner.close()
            return
        if sess is None:
            # a mirror that already dropped the entry (cross-process
            # member): fall back to the scan — rare, never hot
            for c in list(self.conns):
                if c.session is not None and c.session.id == session_id:
                    c.close()

    #: Listen backlog: the asyncio default (100) drops handshakes
    #: under a thundering herd of reconnects at fleet scale.  The old
    #: default here (1024) was set against Python-client waves; the C
    #: loadgen's measured handshake storms arrive faster than one
    #: accept sweep drains, so the default now matches the kernel's
    #: own clamp (``net.core.somaxconn``, 4096 on the profiled host —
    #: anything above it is silently truncated anyway).  Override
    #: with ``ZKSTREAM_LISTEN_BACKLOG``; PROFILE.md round 19 has the
    #: wave numbers this was re-derived from.
    BACKLOG = 1024

    @staticmethod
    def _resolve_backlog() -> int:
        env = os.environ.get('ZKSTREAM_LISTEN_BACKLOG')
        if env:
            try:
                return max(1, int(env))
            except ValueError:
                pass
        try:
            with open('/proc/sys/net/core/somaxconn') as f:
                return max(ZKServer.BACKLOG, int(f.read().strip()))
        except (OSError, ValueError):
            return ZKServer.BACKLOG

    async def start(self) -> 'ZKServer':
        # Million-session enabler: lift the soft fd limit to what the
        # admitted-connection ceiling needs, and say WHICH limit binds
        # when the host cap wins (never a bare EMFILE mid-accept).
        from ..utils import fdlimit
        max_conns = (self.overload.cfg.max_conns
                     if self.overload is not None else None)
        if max_conns:
            fdlimit.raise_nofile(max_conns + 256)
            err = fdlimit.headroom_error(max_conns)
            if err:
                log.warning('%s (admission ceiling %d will shed '
                            'above the fd fit)', err, max_conns)
        if self.blackbox is not None:
            self.blackbox.start(asyncio.get_running_loop())
        if self.ingress is not None:
            # sharded ingress: per-shard SO_REUSEPORT listeners (or
            # the dispatcher handoff) + batched receive drains; the
            # single-loop asyncio.start_server path below stays the
            # env-gated validator
            self.ingress.start(self.host, self.port)
            self.port = self.ingress.port
            log.info('ZK server listening on %s:%d (%d ingress '
                     'shards, %s)', self.host, self.port,
                     self.ingress.nshards, self.ingress.backend)
            return self
        self._server = await asyncio.start_server(
            self._on_client, self.host, self.port,
            backlog=self.BACKLOG)
        self.port = self._server.sockets[0].getsockname()[1]
        log.info('ZK server listening on %s:%d', self.host, self.port)
        return self

    def note_shed(self, reason: str) -> None:
        """Account one pre-adoption shed: traced span + metric — the
        bookkeeping half every shed path shares (the validator's
        :meth:`shed_client` below and the ingress plane's RST shed,
        io/ingress.py)."""
        if self.trace is not None:
            self.trace.note('OVERLOAD', kind='server',
                            detail='shed:%s' % (reason,))
        if self.overload is not None:
            self.overload.count_shed(reason)

    def shed_client(self, writer: asyncio.StreamWriter,
                    reason: str) -> None:
        """Shed one just-accepted client: account it, then abort the
        transport (RST, no FIN handshake to babysit) — never the old
        bare ``transport.abort()`` with no trace or metric."""
        self.note_shed(reason)
        try:
            writer.transport.abort()
        except (ConnectionError, RuntimeError):
            pass

    async def _on_client(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter) -> None:
        if self.faults is not None and self.faults.accept_refuse():
            # Injected accept-loop refusal: the member is listening
            # but sheds this client (overload / half-dead member).
            self.shed_client(writer, 'accept_refuse')
            return
        ov = self.overload
        if ov is not None:
            why = ov.admit(len(self.conns))
            if why is not None:
                self.shed_client(writer, why)
                return
            delay = ov.pace_delay()
            if delay > 0.0:
                # handshake pacer: over-window accepts adopt late,
                # flattening a dial wave into a trickle
                await asyncio.sleep(delay)
                if not self.listening:
                    self.shed_client(writer, 'pacer_shutdown')
                    return
        set_nodelay(writer)
        conn = ServerConnection(self, reader, writer)
        self.conns.add(conn)
        await conn.run()

    async def stop(self) -> None:
        """Kill the server: stop listening and sever every connection.
        Sessions live in the database and keep their expiry clocks
        running — exactly what a crashed ensemble member looks like.
        A WAL this server opened itself is closed (final fsync, fd
        released) — ``restart`` reopens it; an ensemble's shared WAL
        belongs to the ensemble (ZKEnsemble.stop)."""
        if self.ingress is not None:
            # listeners first: no accept can land between severing
            # the fleet and releasing the port
            self.ingress.stop()
        if self.read_gate is not None:
            self.read_gate.reset()   # parked reads die with the conns
        for conn in list(self.conns):
            conn.close()
        self.conns.clear()
        if self._server is not None:
            self._server.close()
            # In Python >= 3.12.1 wait_closed also waits for all client
            # handlers to return, so connections must be severed first.
            await self._server.wait_closed()
            self._server = None
        if self.ingress is not None:
            # the sharded twin of wait_closed: every severed
            # connection's transport teardown has run before stop()
            # returns, so an in-process peer observes the close
            await self.ingress.wait_closed()
        if self.blackbox is not None:
            # clean stop: cancel the cadence, drain queued frames and
            # flush one fsynced final frame (a SIGKILL never gets
            # here — the ring's torn tail is that story)
            self.blackbox.stop()
        if self._owns_wal and not self.db.wal.closed:
            self.db.wal.close()
        if self.transport_tier is not None:
            # release the tier's io_uring fd + mmaps with the server:
            # connection/plane/entry closures hold the tier in
            # reference cycles, so GC-time release is unreliable at
            # chaos-campaign churn rates.  restart() lazily
            # re-creates the ring on the next submission.
            self.transport_tier.close()

    async def restart(self, from_disk: bool = False) -> 'ZKServer':
        """Bring a killed member back on its old port; a rejoining
        member first applies everything the leader committed while it
        was down, like a real follower resync.

        ``from_disk=True`` models the harsher death: the process (not
        just the listener) died, so RAM is gone and the member comes
        back from its write-ahead log — newest valid snapshot plus
        the replayed tail (server/persist.py).  Standalone/leader
        only; it requires a WAL and drops every session, exactly like
        a real restart."""
        assert self._server is None and (
            self.ingress is None or not self.ingress.running), \
            'server still running'
        if from_disk:
            assert self.store is self.db, \
                'restart-from-disk rebuilds the leader database'
            self.db.recover_from_disk()
        elif self.db.wal is not None and self.db.wal.closed:
            self.db.wal.reopen()     # stop() closed it with the member
        self.store.catch_up()
        if self.blackbox is not None:
            self.blackbox.start(asyncio.get_running_loop())
        if self.ingress is not None:
            self.ingress.start(self.host, self.port)
            return self
        self._server = await asyncio.start_server(
            self._on_client, self.host, self.port,
            backlog=self.BACKLOG)
        return self

    @property
    def address(self) -> tuple[str, int]:
        return (self.host, self.port)

    @property
    def listening(self) -> bool:
        """True while this member accepts connections — on whichever
        receive path it runs (the sharded ingress plane or the
        single-loop validator's asyncio server).  The election
        coordinator's liveness probe reads this."""
        return (self._server is not None
                or (self.ingress is not None and self.ingress.running))

    # -- four-letter admin words (ruok / mntr / stat / srvr) --

    def watch_count(self) -> int:
        """Armed one-shot watches across this member's connections —
        the watch table's maintained counter (O(1) per scrape); the
        emitter fallback keeps the legacy O(connections) sum."""
        if self.watch_table is not None:
            return self.watch_table.count
        return sum(len(c.data_watches) + len(c.child_watches)
                   for c in self.conns)

    def persistent_watch_count(self) -> int:
        """Armed PERSISTENT (non-recursive) watches on this member."""
        if self.watch_table is not None:
            return self.watch_table.persistent_count
        return sum(sum(1 for r in c.persistent_watches.values()
                       if not r)
                   for c in self.conns)

    def recursive_watch_count(self) -> int:
        """Armed PERSISTENT_RECURSIVE watches on this member."""
        if self.watch_table is not None:
            return self.watch_table.recursive_count
        return sum(sum(1 for r in c.persistent_watches.values() if r)
                   for c in self.conns)

    def mode(self) -> str:
        return 'standalone' if self.store is self.db else 'follower'

    def current_epoch(self) -> int:
        """The leadership epoch this member serves under (the shared
        database's for in-process members, the mirror's accepted
        epoch for an OS-process follower)."""
        return getattr(self.db, 'epoch', 0)

    def elections_total(self) -> int:
        ref = self.elections_ref
        return ref.elections if ref is not None else self.elections

    def repoint(self, db, store=None, role: str | None = None) -> None:
        """Leadership failover (server/election.py): swap this
        member's backing database/store while the listener keeps its
        port.  Every accepted connection is closed — its session and
        watch state belonged to the dead leader; clients reconnect,
        resume or re-create sessions, and SET_WATCHES re-arms — and
        the event subscriptions (session expiry, watch-table store
        listeners, trace wiring) move to the new storage."""
        for conn in list(self.conns):
            conn.close()
        self.conns.clear()
        if self.read_gate is not None:
            # parked reads belonged to the closed connections; the
            # gate re-follows the new store lazily
            self.read_gate.reset()
        self.db.remove_listener('sessionExpired',
                                self._on_session_expired)
        self.db = db
        self.store = store if store is not None else db
        self.db.on('sessionExpired', self._on_session_expired)
        if self.watch_table is not None:
            self.watch_table.rebind_store(self.store)
        if self.trace is not None:
            if self.store is self.db:
                self.db.trace = self.trace
                wal = getattr(self.db, 'wal', None)
                if wal is not None:
                    wal.trace = self.trace
                    wal.ledger = self.ledger
            else:
                self.store.trace = self.trace
        if role is not None:
            self.role = role
        else:
            self.role = ('leader' if self.store is self.db
                         else 'follower')

    # -- dynamic membership (README "Dynamic membership") --

    def _installed_config(self) -> dict | None:
        """The membership config this member can see: the database's
        own (leader / in-process members sharing it), else the one
        mirrored over replication (an OS-process follower's
        RemoteLeader)."""
        db = self.db
        if getattr(db, 'voter_ids', None) is not None:
            return db.config_snapshot()
        return getattr(getattr(self.store, 'leader', None),
                       'config', None)

    def reconfig_status(self) -> str:
        """One ``rcfg status`` reply line — answerable by any member,
        like the four-letter words."""
        cfg = self._installed_config()
        if cfg is None:
            return 'version=0 phase=static voters=- observers=-\n'
        return 'version=%d phase=%s voters=%s observers=%s\n' % (
            cfg['version'], cfg.get('phase') or 'final',
            _csv(cfg['voters']), _csv(cfg.get('observers') or ()))

    def _observe_reconfig(self, t0: float) -> None:
        if self.collector is not None and self._rcfg_hist is None:
            self._rcfg_hist = self.collector.histogram(
                METRIC_RECONFIG,
                'Membership reconfiguration latency (propose through '
                'commit), ms', buckets=RECONFIG_BUCKETS)
        if self._rcfg_hist is not None:
            self._rcfg_hist.observe(
                (time.perf_counter() - t0) * 1000.0)

    async def reconfig_admin(self, args: str) -> str:
        """Serve one ``rcfg`` admin line against this member.

        Actions: ``status`` (any member) · ``propose <voters-csv>
        [<observers-csv>]`` (leader-only: land the reconfig record —
        for a voter change that is the JOINT record, and this call
        deliberately stops there, which is what lets a chaos schedule
        SIGKILL the ensemble mid-joint) · ``commit`` (leader-only:
        finish an open joint window) · ``apply <voters-csv>
        [<observers-csv>]`` (leader-only: propose, await the joint
        record's quorum, commit, await the final record's quorum).
        Observer lists default to the current observers minus any
        member promoted into the new voter set."""
        parts = args.split()
        action = parts[0] if parts else 'status'
        if action == 'status':
            return self.reconfig_status()
        db = self.db
        if self.role != 'leader' \
                or not hasattr(db, 'propose_reconfig') \
                or (self.fence is not None and self.fence()):
            # a RemoteLeader handle has no propose_reconfig either:
            # followers answer status only, real-ZK style
            return 'error not leader\n'
        t0 = time.perf_counter()
        try:
            if action == 'commit':
                entry = db.commit_reconfig()
                self._observe_reconfig(t0)
                return 'committed version=%d voters=%s\n' % (
                    entry[1], _csv(entry[4]))
            if action not in ('propose', 'apply'):
                return 'error unknown action %r\n' % (action,)
            if len(parts) < 2:
                return 'error %s needs a voter list\n' % (action,)
            voters = _parse_members(parts[1])
            observers = (_parse_members(parts[2]) if len(parts) > 2
                         else tuple(i for i in db.observer_ids
                                    if i not in voters))
            entry = db.propose_reconfig(voters, observers)
        except ValueError as e:
            return 'error %s\n' % (e,)
        if action == 'propose' or entry[2] == 'final':
            self._observe_reconfig(t0)
            return '%s version=%d phase=%s zxid=0x%x\n' % (
                'proposed' if action == 'propose' else 'applied',
                entry[1], entry[2], entry[6])
        # apply, joint phase: both configs must majority-hold the
        # joint record before the final record may land
        q = self.quorum
        if q is not None and q.enabled:
            await q.wait(entry[6])
        final = db.commit_reconfig()
        if q is not None and q.enabled:
            await q.wait(final[6])
        self._observe_reconfig(t0)
        return 'applied version=%d voters=%s\n' % (
            final[1], _csv(final[4]))

    def monitor_stats(self) -> list[tuple[str, object]]:
        """The ``mntr`` key/value inventory (ordered), real-ZK key
        names where an equivalent exists."""
        ephemerals = sum(len(s.ephemerals)
                         for s in self.db.sessions.values())
        data_size = sum(len(n.data)
                        for n in self.store.nodes.values())
        wal = getattr(self.db, 'wal', None)
        wal_rows = [] if wal is None else [
            ('zk_wal_sync', wal.sync),
            ('zk_wal_last_index', wal.next_index),
            ('zk_wal_fsyncs', wal.fsyncs),
            ('zk_wal_sync_errors', wal.sync_errors),
            ('zk_wal_snapshots', wal.snapshots_taken),
        ]
        # quorum-commit rows (server/replication.py QuorumGate): the
        # majority floor, degraded (quorum-unconfirmed) releases and
        # epoch-fenced stale acks
        q = self.quorum
        quorum_rows = [] if q is None or not q.enabled else [
            ('zk_quorum_members', q.total),
            ('zk_quorum_zxid', '0x%x' % (q.quorum_zxid_floor,)),
            ('zk_quorum_degraded', q.degraded_releases),
            ('zk_quorum_stale_acks', q.stale_acks),
        ]
        # dynamic-membership rows (README "Dynamic membership"): the
        # installed config's version, member inventory and the count
        # of completed reconfigurations
        cfg = self._installed_config()
        config_rows = [] if cfg is None else [
            ('zk_config_version', cfg['version']),
            ('zk_config_members', _config_desc(
                cfg['voters'], cfg.get('old_voters'),
                cfg.get('observers') or (),
                cfg.get('phase') or 'final')),
            ('zk_reconfig_total',
             getattr(self.db, 'reconfig_total', 0)),
        ]
        # zxid read-gate rows (README "Read plane"): reads parked
        # until this member caught up, and parked reads bounced to a
        # fresher member after the bounded wait
        rg = self.read_gate
        gate_rows = [] if rg is None else [
            ('zk_read_zxid_gate_blocks', rg.blocks),
            ('zk_read_zxid_gate_bounces', rg.bounces),
        ]
        # MULTI rows: batches applied and mean batch width
        batches = getattr(self.db, 'multi_batches', 0)
        subops = getattr(self.db, 'multi_subops', 0)
        multi_rows = [
            ('zk_multi_batches', batches),
            ('zk_multi_batch_size',
             round(subops / batches, 2) if batches else 0),
        ]
        # the tick ledger + trace-ring rows (the per-tick plane
        # decomposition, README "Causal tracing"): tick count, each
        # phase's per-tick p99, and how often the bounded span ring
        # wrapped
        tick_rows: list[tuple[str, object]] = []
        if self.trace is not None:
            tick_rows.append(('zk_trace_ring_dropped',
                              self.trace.dropped))
        # black-box plane rows (utils/blackbox.py): the slow-op count
        # is ALWAYS present (0 with the recorder off — the clean-
        # schedule invariant asserts on it either way); frame/byte
        # rows only when a recorder is actually writing
        bb = self.blackbox
        blackbox_rows: list[tuple[str, object]] = [
            ('zk_slow_ops_total', 0 if bb is None else bb.slow_ops),
        ]
        if bb is not None:
            blackbox_rows += [
                ('zk_blackbox_frames', bb.frames),
                ('zk_blackbox_bytes', bb.bytes_written),
            ]
        if self.ledger is not None:
            tick_rows.append(('zk_tick_count', self.ledger.ticks))
            for phase in TickLedger.PHASES:
                p99 = self.ledger.phase_p99(phase)
                if p99 is not None:
                    tick_rows.append(
                        ('zk_tick_phase_ms_p99{phase="%s"}' % (phase,),
                         round(p99, 4)))
        return [
            ('zk_version', 'zkstream_tpu_torch'),
            ('zk_uptime_ms',
             int((time.monotonic() - self._started_at) * 1000)),
            ('zk_server_state', self.mode()),
            ('zk_member_role', self.role),
            ('zk_epoch', self.current_epoch()),
            ('zk_elections_total', self.elections_total()),
            ('zk_znode_count', len(self.store.nodes)),
            ('zk_watch_count', self.watch_count()),
            ('zk_persistent_watches', self.persistent_watch_count()),
            ('zk_recursive_watches', self.recursive_watch_count()),
            ('zk_outstanding_requests', self.outstanding),
            ('zk_num_alive_connections', len(self.conns)),
            ('zk_packets_received', self.packets_received),
            ('zk_packets_sent', self.packets_sent),
            ('zk_ephemerals_count', ephemerals),
            ('zk_approximate_data_size', data_size),
            ('zk_sessions', len(self.db.sessions)),
            ('zk_session_table_size',
             sum(1 for s in self.db.sessions.values()
                 if not s.expired and not s.closed)),
            ('zk_zxid', '0x%x' % (self.store.zxid,)),
            ('zk_fanout_shards',
             0 if self.watch_table is None
             else self.watch_table.nshards),
            ('zk_transport_backend',
             'asyncio' if self.transport_tier is None
             else self.transport_tier.backend),
            ('zk_ingress_shards',
             1 if self.ingress is None else self.ingress.nshards),
            ('zk_ingress_backend',
             'asyncio' if self.ingress is None
             else self.ingress.backend),
        ] + self._ingress_census_rows() \
            + (self.overload.mntr_rows()
               if self.overload is not None else []) \
            + multi_rows + gate_rows \
            + quorum_rows + config_rows + tick_rows + blackbox_rows \
            + wal_rows

    def _ingress_census_rows(self) -> list[tuple[str, object]]:
        """Per-shard connection census (sharded ingress only): how
        evenly the kernel (SO_REUSEPORT) or the dispatcher spread the
        fleet across accept shards."""
        if self.ingress is None:
            return []
        return [('zk_ingress_shard_conns{shard="%d"}' % (i,), n)
                for i, n in enumerate(self.ingress.shard_census())]

    def admin_text(self, word: str) -> str:
        """Render one four-letter word's reply text."""
        if word == 'ruok':
            return 'imok'
        if word == 'mntr':
            return ''.join('%s\t%s\n' % kv
                           for kv in self.monitor_stats())
        if word == 'trce':
            # this member's span ring as JSON — the scrape `timeline
            # --live` merges across members (schema-stamped; an
            # OS-process member answers it like any admin word)
            import json
            return json.dumps({
                'trace_schema': TRACE_SCHEMA,
                'member': self.member,
                'dropped': (0 if self.trace is None
                            else self.trace.dropped),
                'spans': ([] if self.trace is None
                          else self.trace.dump()),
            }) + '\n'
        if word in ('stat', 'srvr'):
            lines = ['Zookeeper version: zkstream_tpu_torch (in-process)']
            if word == 'stat':
                lines.append('Clients:')
                for c in self.conns:
                    sid = c.session.id if c.session is not None else 0
                    peer = c.writer.get_extra_info('peername')
                    addr = ('%s:%d' % (peer[0], peer[1])
                            if peer else 'unknown')
                    lines.append(' /%s[1](sid=0x%x)' % (addr, sid))
                lines.append('')
            lines += [
                'Latency min/avg/max: 0/0/0',
                'Received: %d' % (self.packets_received,),
                'Sent: %d' % (self.packets_sent,),
                'Connections: %d' % (len(self.conns),),
                'Outstanding: %d' % (self.outstanding,),
                'Zxid: 0x%x' % (self.store.zxid,),
                'Mode: %s' % (self.mode(),),
                'Node count: %d' % (len(self.store.nodes),),
            ]
            return '\n'.join(lines) + '\n'
        raise ValueError('unknown admin word %r' % (word,))


class ZKEnsemble:
    """N quorum members on localhost (reference analogue:
    test/multi-node.test.js's three real servers on distinct ports).
    Member 0 is the leader; members 1.. are followers, each with its
    own :class:`~.store.ReplicaStore` replaying the leader's commit
    log.  With the default ``lag=0`` replication is synchronous (a
    perfect network); ``set_lag`` makes a follower genuinely trail the
    leader — stale reads included — which is what gives ``sync`` its
    meaning."""

    def __init__(self, count: int = 3, host: str = '127.0.0.1',
                 lag: float | None = 0.0,
                 wal_dir: str | None = None,
                 durability: str | None = None,
                 collector=None, wal_segment_bytes: int | None = None,
                 watchtable: bool | None = None,
                 election: bool | None = None,
                 heartbeat_ms: int | None = None,
                 seed: int | None = None,
                 transport: str | None = None,
                 quorum: bool | None = None,
                 ingress_shards: int | None = None,
                 observers: int | None = None):
        #: One WAL for the whole ensemble, attached to the shared
        #: leader database (followers hold replica views of the same
        #: history; a per-member log would just write it N times).
        #: With a wal_dir the ensemble RECOVERS from it — a fresh
        #: ZKEnsemble over yesterday's directory is restart-from-disk.
        if wal_dir:
            from .persist import open_wal_database, wal_enabled
            if wal_enabled():
                kw = {}
                if wal_segment_bytes is not None:
                    kw['segment_bytes'] = wal_segment_bytes
                self.db = open_wal_database(
                    wal_dir, sync=durability or 'tick',
                    collector=collector, **kw)
            else:
                self.db = ZKDatabase()
        else:
            self.db = ZKDatabase()
        #: Quorum-commit gate built BEFORE the follower stores: its
        #: push-time stamp must run ahead of the stores' synchronous
        #: applies on the 'committed' edge, or every zk_quorum_ack_ms
        #: sample would measure the gap to the NEXT commit instead.
        #: The read scale-out plane (README "Read plane"): the VOTING
        #: membership is members ``0..count-1``; ``observers`` extra
        #: members receive the same replication feed and serve
        #: reads/watches/sessions but never vote, never count toward
        #: the quorum-commit majority, and never win an election — so
        #: read capacity scales without widening the write quorum.
        self.voters = count
        self.observer_count = (observers if observers is not None
                               else observers_default())
        #: Construction parameters retained for runtime membership
        #: changes (README "Dynamic membership"): a joining member is
        #: built exactly like a boot-time one.
        self._host = host
        self._lag = lag
        self._watchtable = watchtable
        self._transport = transport
        self._ingress_shards = ingress_shards
        self._collector = collector
        #: Black-box co-tenancy: every member (followers and
        #: observers included — they carry no WAL of their own) gets
        #: a per-member flight-recorder ring in the ensemble's one
        #: wal_dir; distinct member ids keep the files apart.
        self._blackbox_dir = wal_dir if (wal_dir and self.db.wal
                                         is not None) else None
        #: Quorum-commit: the ack barrier's membership is the VOTERS
        #: alone — attaching observers must not widen (or shrink) the
        #: majority a write waits for.
        from .replication import QuorumGate
        self.quorum = QuorumGate(self.db, count, enabled=quorum,
                                 collector=collector)
        if self.quorum.enabled:
            self.db.on('committed',
                       lambda: self.quorum.note_pushed(self.db.zxid))
        self.servers = [
            ZKServer(self.db, host=host,
                     store=None if i == 0 else ReplicaStore(self.db,
                                                            lag=lag),
                     watchtable=watchtable, member=str(i),
                     transport=transport,
                     ingress_shards=ingress_shards,
                     blackbox_dir=self._blackbox_dir)
            for i in range(count + self.observer_count)]
        for s in self.servers[count:]:
            # an observer owns its own replica, watch table and
            # ingress shards (notification fan-out and receive drain
            # scale with the observer fleet), but its role never
            # changes: elections are the voters' business
            s.role = 'observer'
        #: Quorum leader election (server/election.py): on by default;
        #: ``election=False`` / ``ZKSTREAM_NO_ELECTION=1`` keeps the
        #: static member-0 leader as the env-gated validator path.
        #: The coordinator probes leader liveness on a jittered
        #: backoff and elects the highest (epoch, zxid, member) among
        #: live, unpartitioned VOTERS when a quorum is reachable —
        #: observers never enter a ballot.
        from .election import ElectionCoordinator, election_enabled
        enabled_election = (election_enabled() if election is None
                            else election)
        self.election = (ElectionCoordinator(
            self.servers, self.db, heartbeat_ms=heartbeat_ms,
            seed=seed, collector=collector, voters=count)
            if enabled_election else None)
        #: Quorum-commit wiring (server/replication.py QuorumGate,
        #: constructed above the servers list): the leader's ack
        #: gates on a majority of follower stores having applied the
        #: txn, alongside the WAL's group fsync — on by default at
        #: >= 2 members (``quorum=False`` / ``ZKSTREAM_NO_QUORUM=1``
        #: keeps the fsync-only barrier as the A/B validator arm).
        #: Each follower store's apply hook is its piggybacked
        #: applied-zxid vote.
        if self.quorum.enabled:
            gate = self.quorum
            for s in self.servers:
                s.quorum = gate
            for i in range(1, count):
                self.servers[i].store.on_applied = (
                    lambda z, v='member:%d' % i:
                    gate.note_ack(v, z, self.db.epoch))
            # QUORUM_ACK spans land on the founding leader's ring
            gate.trace = self.servers[0].trace
        #: Dynamic membership (README "Dynamic membership"): the boot
        #: config installs as version 0 unless WAL recovery already
        #: adopted a later one; from here on the database's
        #: config-change hook re-derives the quorum gate's NAMED
        #: voter sets and the election coordinator's ballot sets on
        #: every reconfig record — joint phase included, where both
        #: planes require majorities of BOTH configs.
        if self.db.voter_ids is None:
            self.db.install_config({
                'version': 0, 'phase': 'final',
                'voters': tuple(range(count)),
                'old_voters': None,
                'observers': tuple(range(
                    count, count + self.observer_count)),
            })
        self.db.on_config_change = (
            lambda phase, entry: self._config_changed())
        self._config_changed()

    def _config_changed(self) -> None:
        """Re-derive every membership consumer from the database's
        installed config: the quorum gate's named voter sets (member
        0's vote is the shared database itself — its store IS the db,
        always current, so ``leader_key`` stays ``member:0`` whoever
        holds the leader role), the election coordinator's ballot
        sets, and the ensemble's voting-member count."""
        db = self.db
        if db.voter_ids is None:
            return
        self.voters = len(db.voter_ids)
        old = db.old_voter_ids
        if self.quorum.enabled:
            self.quorum.total = (max(len(db.voter_ids), len(old))
                                 if old is not None
                                 else len(db.voter_ids))
            self.quorum.set_config(
                {'member:%d' % i for i in db.voter_ids},
                ({'member:%d' % i for i in old}
                 if old is not None else None),
                leader_key='member:0')
        if self.election is not None:
            self.election.set_config(
                set(db.voter_ids),
                set(old) if old is not None else None)

    @property
    def leader_idx(self) -> int:
        """The current leader member's index (0 on the static path)."""
        return 0 if self.election is None else self.election.leader_idx

    def install_faults(self, injector) -> None:
        """Install one seeded FaultInjector on every member (the chaos
        campaign's server-side fault source)."""
        for s in self.servers:
            s.faults = injector

    def set_lag(self, idx: int, lag: float | None) -> None:
        """Change follower ``idx``'s replication lag (0 = synchronous,
        seconds = timed delay, None = hold until sync/write)."""
        store = self.servers[idx].store
        if not isinstance(store, ReplicaStore):
            raise ValueError('member %d is the leader' % (idx,))
        store.lag = lag

    async def start(self) -> 'ZKEnsemble':
        for s in self.servers:
            await s.start()
        if self.election is not None:
            self.election.start()
        return self

    async def stop(self) -> None:
        """Full-ensemble death: every member stops and the WAL (when
        configured) is closed — a fresh ZKEnsemble over the same
        ``wal_dir`` is the restart-from-disk path."""
        if self.election is not None:
            self.election.stop()
        self.quorum.close()
        for s in self.servers:
            await s.stop()
        # full-ensemble death: in-flight expiry timers die with it —
        # one firing after the WAL below closes would try to log the
        # session_close edge into a closed log (the read plane's
        # per-backend read sessions made this race common at teardown)
        for sess in self.db.sessions.values():
            if sess.expiry_handle is not None:
                sess.expiry_handle.cancel()
                sess.expiry_handle = None
        if self.db.wal is not None:
            self.db.wal.close()

    async def kill(self, idx: int) -> None:
        await self.servers[idx].stop()

    async def restart(self, idx: int) -> None:
        """Bring a killed member back on its old port; a rejoining
        follower first syncs with the leader, like a real one — and
        with election on, an ex-leader rejoins the CURRENT epoch as a
        follower, never as the leader it once was."""
        await self.servers[idx].restart()
        db = self.db
        if db.voter_ids is not None:
            is_voter = idx in db.voter_ids or (
                db.old_voter_ids is not None
                and idx in db.old_voter_ids)
        else:
            is_voter = idx < self.voters
        if not is_voter:
            self.servers[idx].role = 'observer'
        elif self.election is not None:
            self.election.note_restart(idx)

    def addresses(self) -> list[tuple[str, int]]:
        return [s.address for s in self.servers]

    # -- runtime membership changes (README "Dynamic membership") --

    def _spawn_member(self) -> 'ZKServer':
        """Build one joining member exactly like a boot-time one: a
        fresh replica bootstraps from a live snapshot of the shared
        database (the attach-at-tail path — the ensemble has
        history), wired to the shared quorum gate."""
        idx = len(self.servers)
        s = ZKServer(self.db, host=self._host,
                     store=ReplicaStore(self.db, lag=self._lag),
                     watchtable=self._watchtable, member=str(idx),
                     transport=self._transport,
                     ingress_shards=self._ingress_shards,
                     blackbox_dir=self._blackbox_dir)
        if self.quorum.enabled:
            s.quorum = self.quorum
        if self.election is not None:
            el = self.election
            s.elections_ref = el
            s.fence = (lambda i=idx: i in el.deposed)
        self.servers.append(s)
        return s

    async def add_observer(self) -> int:
        """Observer JOIN under traffic: a new member starts serving a
        snapshot-bootstrapped replica, then a single final-phase
        reconfig record (no quorum implications) makes the join
        durable and visible — client resolvers rebalance on the
        config-change notification.  Returns the new index."""
        s = self._spawn_member()
        s.role = 'observer'
        idx = len(self.servers) - 1
        await s.start()
        self.observer_count += 1
        db = self.db
        db.propose_reconfig(db.voter_ids, db.observer_ids + (idx,))
        return idx

    async def remove_observer(self, idx: int) -> None:
        """Observer LEAVE: the reconfig record announces the removal
        first (resolvers rebalance away), then the member drains —
        open connections close, parking their in-flight read
        sessions for client-side migration — and its replica
        detaches from the commit feed."""
        s = self.servers[idx]
        if s.role != 'observer':
            raise ValueError('member %d is a voter' % (idx,))
        db = self.db
        if idx not in db.observer_ids:
            raise ValueError('member %d is not in the config'
                             % (idx,))
        db.propose_reconfig(
            db.voter_ids,
            tuple(i for i in db.observer_ids if i != idx))
        await s.stop()
        if isinstance(s.store, ReplicaStore):
            s.store.detach()
        self.observer_count -= 1

    async def reconfig_voters(self, new_voters,
                              observers=None) -> None:
        """Voter-set change with joint-majority handoff: the joint
        record installs C_old+C_new — from its append until the
        final record's, quorum commit and elections require
        majorities of BOTH sets, and a removed member can neither
        ack a quorum nor win a ballot (config-fenced).  A NEW voter
        index must already be a running member (``add_voter`` /
        ``replace_voter`` handle join-and-promote).  Leader
        self-removal is legal: the final record commits under the
        outgoing leader, which then hands off by election among
        C_new."""
        db = self.db
        new_voters = tuple(sorted(new_voters))
        obs = (tuple(observers) if observers is not None
               else tuple(i for i in db.observer_ids
                          if i not in new_voters))
        was_voters = db.voter_ids or ()
        gate = self.quorum
        # promote ack wiring FIRST: the joint record's own commit
        # needs C_new's majority to be audible
        for i in new_voters:
            if i == 0 or i in was_voters or i >= len(self.servers):
                continue
            s = self.servers[i]
            store = s.store
            if gate.enabled and isinstance(store, ReplicaStore) \
                    and store.on_applied is None:
                store.on_applied = (
                    lambda z, v='member:%d' % i:
                    gate.note_ack(v, z, self.db.epoch))
            s.role = 'follower'
        entry = db.propose_reconfig(new_voters, obs)
        if entry[2] == 'final':
            return
        if gate.enabled:
            await gate.wait(entry[6])
        final = db.commit_reconfig()
        if gate.enabled:
            await gate.wait(final[6])
        # demoted voters leave the ack wiring (the gate's config
        # fence already discards them) and serve on as observers
        for i in was_voters:
            if i in new_voters or i >= len(self.servers):
                continue
            s = self.servers[i]
            if isinstance(s.store, ReplicaStore):
                s.store.on_applied = None
            s.role = 'observer'
        if self.election is not None \
                and self.election.leader_idx not in new_voters:
            await self.election.elect('reconfig')

    async def add_voter(self) -> int:
        """Join-and-promote: start a fresh member (observer-style
        snapshot bootstrap), then widen the voter set through one
        joint window.  Returns the new member's index."""
        s = self._spawn_member()
        idx = len(self.servers) - 1
        await s.start()
        await self.reconfig_voters(self.db.voter_ids + (idx,))
        return idx

    async def remove_voter(self, idx: int) -> None:
        """Shrink the voter set through one joint window (leader
        self-removal included — see :meth:`reconfig_voters`)."""
        await self.reconfig_voters(
            tuple(i for i in self.db.voter_ids if i != idx))

    async def replace_voter(self, old_idx: int) -> int:
        """One joint window swaps a fresh member in for ``old_idx``
        — the add and the remove hand off atomically.  Returns the
        new member's index."""
        s = self._spawn_member()
        idx = len(self.servers) - 1
        await s.start()
        await self.reconfig_voters(
            tuple(i for i in self.db.voter_ids if i != old_idx)
            + (idx,))
        return idx
