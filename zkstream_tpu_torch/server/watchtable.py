"""Sharded watch fan-out: the server-owned subscription table.

The emitter dispatch this replaces made every accepted connection
register four store listeners and filter every change event against its
own watch dicts — one ``dataChanged`` cost O(all connections) Python
callbacks even when a single connection watched the path, and each
subscriber's notification was its own plane write.  At fleet scale that
is the serving plane's whole budget: the ROADMAP's million-session box
cannot spend a callback per connection per mutation.

The :class:`WatchTable` inverts the index.  One listener per store
event consults ``(kind, path) → subscriber set`` — O(watchers-on-path),
not O(connections) — encodes the notification once per distinct
``(type, path, zxid)`` within the tick (a per-tick memo, so interleaved
event kinds cannot thrash a depth-1 cache), and buffers the shared
bytes per subscriber.  Connections are assigned round-robin to K
shards; each shard schedules ONE flush callback per busy tick and
drains its dirty connections' notification batches as one joined
``SendPlane.send`` per connection — the send plane's per-connection cork
generalized to per-shard scheduling, so a 100k-watcher event costs K
``call_soon``s instead of 100k, and every connection's notifications of
the tick leave in one segment (further coalesced with its replies by
the existing plane, durability barrier included).

Ordering contract (identical to the emitter path per connection):

- notifications append in store-event order;
- a reply sent after a notification was buffered drains the buffer
  first (``ServerConnection._write_bytes``), so the wire never shows a
  later reply overtaking an earlier notification — the ZooKeeper
  guarantee that a client sees the watch event before any read result
  reflecting the new state;
- fault injection stays a per-frame boundary BEFORE the shard cork
  (same rule as the send plane's): an injected delivery pre-flushes
  the connection's buffered notifications and its plane, so a faulted
  frame cannot reorder.

``ZKSTREAM_NO_WATCHTABLE=1`` (or ``ZKServer(watchtable=False)``)
disables the table and falls back to the per-connection emitter path —
the validator tier, exactly like the codec and cork kill switches; the
parity suite (tests/test_torch_watchtable.py) holds the two paths to
identical notification streams.

Observability: per-shard flush batches land in the shared
``zookeeper_flush_batch_frames`` / ``_bytes`` histograms labelled
``plane="fanout"``; shard-flush duration in ``zk_fanout_tick_ms``.
Both are scraped by ``bench.py --fanout`` (`make bench-fanout`).

Beneath the shard cork sits the batched-syscall transport tier
(io/transport.py): each dirty connection's ``send_flush`` defers its
joined batch to the server's shared submission queue, so a wide
fan-out tick leaves in ONE io_uring submission (or one C writev
batch) covering every shard's connections instead of one
``transport.write`` per subscriber — the ordering and durability
contracts above are enforced by the send plane identically on every
backend.
"""

from __future__ import annotations

import os
import time

from ..io.sendplane import (
    BYTE_BUCKETS,
    FRAME_BUCKETS,
    METRIC_FLUSH_BYTES,
    METRIC_FLUSH_FRAMES,
)
from ..protocol.consts import XID_NOTIFICATION
from ..utils.aio import ambient_loop

METRIC_FANOUT_TICK = 'zk_fanout_tick_ms'

#: Shard-flush duration buckets (ms): the interesting band is whether
#: a 100k-subscriber event amortizes to sub-millisecond per shard.
TICK_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                25.0, 50.0, 100.0)

#: Default shard count (``ZKSTREAM_FANOUT_SHARDS`` overrides): enough
#: to keep one shard's dirty set small under a wide fan-out, few
#: enough that an idle tick schedules almost nothing.
DEFAULT_SHARDS = 8

#: Per-tick encode-memo cap: distinct (type, path, zxid) events per
#: tick is normally tiny (one mutation emits at most two), but a
#: pathological tick must not grow the memo without bound.
MEMO_CAP = 256


def watchtable_default() -> bool:
    """Process-wide default for new servers (env kill switch)."""
    return os.environ.get('ZKSTREAM_NO_WATCHTABLE') != '1'


def shard_count_default() -> int:
    try:
        n = int(os.environ.get('ZKSTREAM_FANOUT_SHARDS', ''))
    except ValueError:
        return DEFAULT_SHARDS
    return n if n > 0 else DEFAULT_SHARDS


class _Shard:
    """One shard's per-tick state: the dirty connection list and
    whether its flush callback is already scheduled this tick."""

    __slots__ = ('dirty', 'scheduled')

    def __init__(self) -> None:
        self.dirty: list = []
        self.scheduled = False


class WatchTable:
    """One member's reverse watch index + sharded notification cork.

    Owned by :class:`~.server.ZKServer`; subscribes ONCE to the
    member's store (watch locality: a watch armed through a lagging
    follower fires when THAT member applies the transaction, exactly
    as the per-connection emitter path did).
    """

    def __init__(self, server, shards: int | None = None,
                 collector=None):
        self.server = server
        self.nshards = shards if shards else shard_count_default()
        self._shards = [_Shard() for _ in range(self.nshards)]
        self._rr = 0
        #: The reverse index: path -> set of ServerConnection, one map
        #: per watch kind.  Invariant: ``conn`` is in
        #: ``data_index[p]`` iff ``p`` is in ``conn.data_watches``
        #: (same for child), so close-time cleanup is O(paths the
        #: connection watched).
        self.data_index: dict[str, set] = {}
        self.child_index: dict[str, set] = {}
        #: Persistent-watch indexes (ADD_WATCH, opcode 106): exact
        #: node subscribers and subtree-root subscribers.  Unlike the
        #: one-shot indexes above these SURVIVE fires — a store event
        #: consults them without popping, and a recursive entry
        #: matches every descendant by ancestor-prefix walk
        #: (O(path depth) dict hits per event, only when any
        #: persistent watch exists at all).
        self.persistent_index: dict[str, set] = {}
        self.recursive_index: dict[str, set] = {}
        #: Maintained armed-watch count across this member's
        #: connections — what ``mntr``'s ``zk_watch_count`` scrapes,
        #: O(1) instead of summing every connection's dicts.
        self.count = 0
        #: Persistent registration counts (mntr
        #: ``zk_persistent_watches`` / ``zk_recursive_watches``).
        self.persistent_count = 0
        self.recursive_count = 0
        #: Per-tick encode memo: (type, path, zxid) -> wire bytes.
        #: Cleared at the next tick boundary, so interleaved event
        #: kinds within one tick (a DELETED fanning to both data and
        #: child subscribers) share one encode without thrashing.
        self._memo: dict[tuple, bytes] = {}
        self._memo_scheduled = False
        self._frames_hist = None
        self._bytes_hist = None
        self._tick_hist = None
        if collector is not None:
            self._frames_hist = collector.histogram(
                METRIC_FLUSH_FRAMES,
                'Frames per coalesced transport write, by plane',
                buckets=FRAME_BUCKETS)
            self._bytes_hist = collector.histogram(
                METRIC_FLUSH_BYTES,
                'Bytes per coalesced transport write, by plane',
                buckets=BYTE_BUCKETS)
            self._tick_hist = collector.histogram(
                METRIC_FANOUT_TICK,
                'Per-shard fan-out flush duration (ms)',
                buckets=TICK_BUCKETS)
        self._store = server.store
        self._bind_store(self._store)

    def _bind_store(self, store) -> None:
        store.on('created', self._on_created)
        store.on('deleted', self._on_deleted)
        store.on('dataChanged', self._on_data_changed)
        store.on('childrenChanged', self._on_children_changed)

    def rebind_store(self, store) -> None:
        """Follow the server onto a new backing store (leadership
        failover repoints a member's db/store — server/election.py).
        The caller has already closed every connection, so the index
        is empty; only the event subscription moves."""
        old = self._store
        old.remove_listener('created', self._on_created)
        old.remove_listener('deleted', self._on_deleted)
        old.remove_listener('dataChanged', self._on_data_changed)
        old.remove_listener('childrenChanged',
                            self._on_children_changed)
        self._store = store
        self._bind_store(store)

    # -- connection membership --

    def add_conn(self, conn) -> None:
        """Assign a freshly-handshaken connection to a shard.  A
        connection accepted through the sharded ingress plane keeps
        its ACCEPT shard as its fan-out shard (io/ingress.py: the
        affinity key — arms, fan-out buffer and send-plane cork all
        live with the shard that drains the connection); validator-
        path connections round-robin as before (deterministic and
        balanced)."""
        shard = getattr(conn, '_ingress_shard', None)
        if shard is not None:
            conn._fanout_shard = shard % self.nshards
            return
        conn._fanout_shard = self._rr % self.nshards
        self._rr += 1

    def remove_conn(self, conn) -> None:
        """Connection closed: drop its index entries (O(paths it
        watched)) and its buffered notifications — the bytes have
        nowhere to go.  The caller has already flushed anything that
        should beat the FIN."""
        for path in conn.data_watches:
            subs = self.data_index.get(path)
            if subs is not None:
                subs.discard(conn)
                if not subs:
                    del self.data_index[path]
                self.count -= 1
        for path in conn.child_watches:
            subs = self.child_index.get(path)
            if subs is not None:
                subs.discard(conn)
                if not subs:
                    del self.child_index[path]
                self.count -= 1
        for path, recursive in conn.persistent_watches.items():
            idx = (self.recursive_index if recursive
                   else self.persistent_index)
            subs = idx.get(path)
            if subs is not None:
                subs.discard(conn)
                if not subs:
                    del idx[path]
                if recursive:
                    self.recursive_count -= 1
                else:
                    self.persistent_count -= 1
        conn.data_watches.clear()
        conn.child_watches.clear()
        conn.persistent_watches.clear()
        conn._fanout_buf.clear()

    # -- arming / disarming (the connection's watch helpers call in) --

    def arm(self, kind: str, path: str, conn) -> None:
        """Register one one-shot watch; the caller guarantees it is
        not already armed (the connection dict is the dedup)."""
        idx = self.data_index if kind == 'data' else self.child_index
        subs = idx.get(path)
        if subs is None:
            idx[path] = subs = set()
        subs.add(conn)
        self.count += 1

    def disarm(self, kind: str, path: str, conn) -> None:
        """Unregister a watch the connection consumed out of band
        (SET_WATCHES catch-up resolving a stale arm)."""
        idx = self.data_index if kind == 'data' else self.child_index
        subs = idx.get(path)
        if subs is not None and conn in subs:
            subs.discard(conn)
            if not subs:
                del idx[path]
            self.count -= 1

    def arm_persistent(self, path: str, conn,
                       recursive: bool) -> None:
        """Register one persistent (ADD_WATCH) subscription; the
        caller guarantees it is not already armed under this mode
        (``conn.persistent_watches`` is the dedup)."""
        idx = self.recursive_index if recursive \
            else self.persistent_index
        subs = idx.get(path)
        if subs is None:
            idx[path] = subs = set()
        subs.add(conn)
        if recursive:
            self.recursive_count += 1
        else:
            self.persistent_count += 1

    def disarm_persistent(self, path: str, conn,
                          recursive: bool) -> None:
        idx = self.recursive_index if recursive \
            else self.persistent_index
        subs = idx.get(path)
        if subs is not None and conn in subs:
            subs.discard(conn)
            if not subs:
                del idx[path]
            if recursive:
                self.recursive_count -= 1
            else:
                self.persistent_count -= 1

    # -- store event handlers (the O(watchers-on-path) hot path) --

    def _on_created(self, path: str, zxid: int) -> None:
        subs = self.data_index.pop(path, None)
        if subs:
            self._fan('CREATED', path, zxid, subs, 'data')
        if self.persistent_count or self.recursive_count:
            self._fan_persistent('CREATED', path, zxid)

    def _on_deleted(self, path: str, zxid: int) -> None:
        # a connection holding both watch kinds on the path receives
        # two DELETED frames, data-kind first — emitter-path parity
        subs = self.data_index.pop(path, None)
        if subs:
            self._fan('DELETED', path, zxid, subs, 'data')
        subs = self.child_index.pop(path, None)
        if subs:
            self._fan('DELETED', path, zxid, subs, 'child')
        if self.persistent_count or self.recursive_count:
            self._fan_persistent('DELETED', path, zxid)

    def _on_data_changed(self, path: str, zxid: int) -> None:
        subs = self.data_index.pop(path, None)
        if subs:
            self._fan('DATA_CHANGED', path, zxid, subs, 'data')
        if self.persistent_count or self.recursive_count:
            self._fan_persistent('DATA_CHANGED', path, zxid)

    def _on_children_changed(self, path: str, zxid: int) -> None:
        subs = self.child_index.pop(path, None)
        if subs:
            self._fan('CHILDREN_CHANGED', path, zxid, subs, 'child')
        if self.persistent_count:
            # exact-node persistent subscribers only: a recursive
            # subscriber sees the child's own CREATED/DELETED instead
            # (upstream PERSISTENT_RECURSIVE semantics)
            self._fan_persistent('CHILDREN_CHANGED', path, zxid,
                                 exact_only=True)

    def _persistent_subs(self, path: str,
                         exact_only: bool = False) -> set | None:
        """The persistent subscriber set for one store event: exact
        subscribers on ``path`` plus — unless ``exact_only`` — every
        recursive subscriber on ``path`` or an ancestor.  A
        connection holding both registrations gets ONE frame."""
        subs = None
        exact = self.persistent_index.get(path)
        if exact:
            subs = set(exact)
        if not exact_only and self.recursive_count:
            p = path
            ridx = self.recursive_index
            while True:
                r = ridx.get(p)
                if r:
                    subs = (subs | r) if subs else set(r)
                if len(p) <= 1:
                    break
                i = p.rfind('/')
                p = p[:i] if i > 0 else '/'
        return subs

    def _fan_persistent(self, ntype: str, path: str, zxid: int,
                        exact_only: bool = False) -> None:
        """Fan one store event to persistent subscribers.  Unlike
        :meth:`_fan` nothing is consumed — the registrations survive
        the fire — and the overload plane's soft-watermark gate is
        the EVICTING variant: a persistent subscriber never gets a
        silent notification gap (a dropped invalidation would wedge
        a watch-backed client cache stale forever), it gets a typed
        eviction and re-syncs on reconnect."""
        subs = self._persistent_subs(path, exact_only)
        if not subs:
            return
        data = self.encode(ntype, path, zxid)
        srv = self.server
        trace = getattr(srv, 'trace', None)
        if trace is not None:
            trace.note('FANOUT', path, zxid=zxid, kind='server',
                       batch=len(subs),
                       nbytes=len(data) * len(subs),
                       detail='PERSISTENT:' + ntype)
        if srv.faults is not None:
            # injection boundary: per frame, BEFORE the shard cork
            for conn in subs:
                if not conn.closed:
                    self._enqueue_persistent(conn, data)
            return
        srv.packets_sent += len(subs)
        shards = self._shards
        sched: list = []
        ov = getattr(srv, 'overload', None)
        for conn in subs:
            if conn.closed:
                srv.packets_sent -= 1
                continue
            if ov is not None \
                    and not ov.allow_persistent_notification(conn):
                # the gate EVICTED the stalled subscriber (typed
                # close) rather than dropping the frame
                srv.packets_sent -= 1
                continue
            buf = conn._fanout_buf
            if not buf:
                shard = shards[conn._fanout_shard]
                shard.dirty.append(conn)
                if not shard.scheduled:
                    shard.scheduled = True
                    sched.append(shard)
            buf.append(data)
        if sched:
            self._schedule_shards(sched)

    def _enqueue_persistent(self, conn, data: bytes) -> None:
        """The fault-injection-path twin of :meth:`_enqueue` with the
        persistent overload contract (evict, never silently drop)."""
        ov = getattr(self.server, 'overload', None)
        if ov is not None \
                and not ov.allow_persistent_notification(conn):
            return
        self.server.packets_sent += 1
        fi = self.server.faults
        if fi is not None and fi.server_tx(conn, data,
                                           pre=conn._preflush_fanout):
            return
        buf = conn._fanout_buf
        if not buf:
            shard = self._shards[conn._fanout_shard]
            shard.dirty.append(conn)
            if not shard.scheduled:
                shard.scheduled = True
                self._schedule_shards([shard])
        buf.append(data)

    def _fan(self, ntype: str, path: str, zxid: int, subs: set,
             kind: str) -> None:
        data = self.encode(ntype, path, zxid)
        self.count -= len(subs)
        srv = self.server
        trace = getattr(srv, 'trace', None)   # stub-server tolerant
        if trace is not None:
            # the fan-out leg of the zxid span chain: ONE span per
            # store event, stamped with the watch count and the wire
            # bytes it flushes (len(subs) subscribers x one shared
            # encode)
            trace.note('FANOUT', path, zxid=zxid, kind='server',
                       batch=len(subs),
                       nbytes=len(data) * len(subs),
                       detail=ntype)
        if srv.faults is not None:
            # injection boundary: per frame, BEFORE the shard cork
            for conn in subs:
                (conn.data_watches if kind == 'data'
                 else conn.child_watches).pop(path, None)
                if not conn.closed:
                    self._enqueue(conn, data)
            return
        # fault-free hot loop (the 100k-subscriber path): one-shot
        # consume + buffer, with the shard scheduling and the
        # packets_sent accounting hoisted out (closed subscribers
        # compensate — they consume the arm but send nothing)
        srv.packets_sent += len(subs)
        shards = self._shards
        sched: list = []
        ov = getattr(srv, 'overload', None)
        if kind == 'data':
            for conn in subs:
                conn.data_watches.pop(path, None)
                if conn.closed:
                    srv.packets_sent -= 1
                    continue
                if ov is not None \
                        and not ov.allow_notification(conn):
                    # soft tx watermark (io/overload.py): a stalled
                    # subscriber loses the frame — the legally lossy
                    # channel — instead of bloating the member
                    srv.packets_sent -= 1
                    continue
                buf = conn._fanout_buf
                if not buf:
                    shard = shards[conn._fanout_shard]
                    shard.dirty.append(conn)
                    if not shard.scheduled:
                        shard.scheduled = True
                        sched.append(shard)
                buf.append(data)
        else:
            for conn in subs:
                conn.child_watches.pop(path, None)
                if conn.closed:
                    srv.packets_sent -= 1
                    continue
                if ov is not None \
                        and not ov.allow_notification(conn):
                    srv.packets_sent -= 1
                    continue
                buf = conn._fanout_buf
                if not buf:
                    shard = shards[conn._fanout_shard]
                    shard.dirty.append(conn)
                    if not shard.scheduled:
                        shard.scheduled = True
                        sched.append(shard)
                buf.append(data)
        if sched:
            self._schedule_shards(sched)

    def _schedule_shards(self, shards: list) -> None:
        """Schedule shard flushes for the tick boundary.  With a
        batched transport tier the flush runs inside the tier's one
        tick callback, BEFORE its submission — so a wide fan-out's
        bytes ride the same batched syscall chain as the tick's
        replies instead of trailing it by a loop hop (or fragmenting
        into per-shard submissions)."""
        tier = getattr(self.server, 'transport_tier', None)
        if tier is not None:
            for shard in shards:
                tier.schedule_call(
                    lambda s=shard: self._flush_shard(s))
            return
        loop = ambient_loop()
        for shard in shards:
            loop.call_soon(self._flush_shard, shard)

    # -- notification encode (per-tick memo) --

    def encode(self, ntype: str, path: str, zxid: int) -> bytes:
        """Encode one notification through the server-owned codec,
        memoized per tick — shared bytes for every subscriber, and for
        the direct ``notify`` path (SET_WATCHES catch-up) too."""
        key = (ntype, path, zxid)
        data = self._memo.get(key)
        if data is None:
            data = self.server._notif_codec.encode(
                {'xid': XID_NOTIFICATION, 'zxid': zxid, 'err': 'OK',
                 'opcode': 'NOTIFICATION', 'type': ntype,
                 'state': 'SYNC_CONNECTED', 'path': path})
            if len(self._memo) >= MEMO_CAP:
                self._memo.clear()
            self._memo[key] = data
            if not self._memo_scheduled:
                self._memo_scheduled = True
                ambient_loop().call_soon(self._clear_memo)
        return data

    def _clear_memo(self) -> None:
        self._memo_scheduled = False
        self._memo.clear()

    # -- the shard cork --

    def _enqueue(self, conn, data: bytes) -> None:
        """Buffer one (already encoded, shared) notification for one
        subscriber; the shard flushes at the tick boundary.  Fault
        injection happens HERE — before the cork, per frame, with a
        pre-flush of everything the connection already has corked —
        the same boundary rule the send plane uses."""
        ov = getattr(self.server, 'overload', None)
        if ov is not None and not ov.allow_notification(conn):
            return
        self.server.packets_sent += 1
        fi = self.server.faults
        if fi is not None and fi.server_tx(conn, data,
                                           pre=conn._preflush_fanout):
            return   # the injector took over delivery (split/delay/RST)
        buf = conn._fanout_buf
        if not buf:
            shard = self._shards[conn._fanout_shard]
            shard.dirty.append(conn)
            if not shard.scheduled:
                shard.scheduled = True
                self._schedule_shards([shard])
        buf.append(data)

    def _flush_shard(self, shard: _Shard) -> None:
        """One shard's tick flush: every dirty connection's buffered
        notifications leave as one joined ``SendPlane.send``, and the
        plane is flushed on the spot — this callback IS the tick
        boundary for its connections, so letting the plane schedule
        its own per-connection flush would only add one loop-callback
        round trip per subscriber (the dominant cost at 100k
        watchers).  Replies the plane already corked this tick leave
        in the same buffer, order preserved, durability barrier
        honored (``flush_now`` gates on it)."""
        shard.scheduled = False
        dirty, shard.dirty = shard.dirty, []
        ledger = getattr(self.server, 'ledger', None)
        if ledger is not None:
            # fanout_flush tick phase: the shard loop's own time (the
            # nested send-plane writes account under cork_flush)
            ledger.enter('fanout_flush')
        t0 = time.perf_counter()
        frames = 0
        nbytes = 0
        ov = getattr(self.server, 'overload', None)
        try:
            for conn in dirty:
                buf = conn._fanout_buf
                if not buf:
                    continue
                data = buf[0] if len(buf) == 1 else b''.join(buf)
                frames += len(buf)
                # the list object is reused across ticks (cleared in
                # place): a 100k-subscriber flush must not allocate a
                # fresh buffer per connection per event
                buf.clear()
                if conn.closed:
                    continue
                nbytes += len(data)
                conn._tx.send_flush(data)
                if ov is not None:
                    # the flush is the fan-out's per-conn-per-tick
                    # boundary: a subscriber whose backlog outgrew
                    # the hard watermark is evicted right here
                    ov.check_tx(conn)
        finally:
            if ledger is not None:
                ledger.exit()
        if frames and self._frames_hist is not None:
            labels = {'plane': 'fanout'}
            self._frames_hist.observe(frames, labels)
            self._bytes_hist.observe(nbytes, labels)
            self._tick_hist.observe(
                (time.perf_counter() - t0) * 1000.0, labels)
