"""The client cache plane: a watch-backed read cache in the
Curator-cache shape, built on the persistent-recursive watch family
(ADD_WATCH, opcode 106).

One ``CachePlane`` subscribes each configured subtree root ONCE with a
PERSISTENT_RECURSIVE watch and then fills read-through: every server
read the client performs under a subscribed root deposits its reply
(data / stat / children), and every later read of the same path is
served locally — single-digit microseconds, zero server round trips —
until the notification stream invalidates it.  In a read-mostly fleet
the server's read QPS collapses to the invalidation rate.

Coherence contract (README "Client cache plane")
------------------------------------------------

A cached read must satisfy the same session-view rules as a server
read — ``check_session_reads`` (analysis/linearize.py) and invariant 9
apply to it verbatim.  Three mechanisms make that hold:

1. **Ordering.**  The server never lets a reply overtake an earlier
   notification on one connection (server/watchtable.py's ordering
   contract), so by the time the session has seen a reply stamped
   ``zxid Z``, every invalidation at or below ``Z`` for this
   connection has already been applied to the cache (notifications
   are processed synchronously, in arrival order, before any awaiting
   read coroutine resumes).  The cache's coherence position is
   therefore ``pos = max(last notification zxid, session.last_zxid)``.

2. **The serve gate.**  A cached read is served only while
   ``pos >= Client.last_seen_zxid()``.  The client floor can outrun
   the watch stream only through the read plane's distributed replies
   (other connections); when it does, cached reads fall through to
   real server reads — which the zxid read gate already covers —
   until the watch stream catches up.  A served entry also notes its
   fill zxid into the client floor, exactly like a server read.

3. **The fill gate.**  A reply deposits into the cache only if its
   zxid is at or above the last notification position: a distributed
   read off a lagging member must not resurrect a value the
   notification stream already invalidated.

Gaps are never silent.  A disconnect marks every subtree stale (reads
fall through); reconnect replays the registrations via SET_WATCHES2
and the ``'resumed'`` edge drops the subtree's entries — anything may
have changed while dark, so the cache refetches rather than trusts.
A session that dies outright (``'lost'``) drops everything and
re-subscribes on the replacement session.  The server holds the same
line: an overloaded member EVICTS a persistent-watch subscriber
rather than dropping its notification (io/overload.py
``allow_persistent_notification``), so a surviving connection implies
an unbroken invalidation stream.

Knobs: ``Client(cache=...)`` beats ``ZKSTREAM_CACHE`` (a subtree
root, ``:``-separated for several, or ``1`` for ``/``);
``ZKSTREAM_NO_CACHE=1`` is the kill switch.

Observability: ``zookeeper_cache_hits`` / ``_misses`` (by op),
``zookeeper_cache_invalidations`` (by event), and
``zookeeper_cache_staleness_ms`` — the age of each served entry.
"""

from __future__ import annotations

import asyncio
import os
import time

from ..utils.aio import ambient_loop

METRIC_CACHE_HITS = 'zookeeper_cache_hits'
METRIC_CACHE_MISSES = 'zookeeper_cache_misses'
METRIC_CACHE_INVALIDATIONS = 'zookeeper_cache_invalidations'
METRIC_CACHE_STALENESS = 'zookeeper_cache_staleness_ms'

#: Entry-age buckets (ms): the interesting band is whether read-mostly
#: entries live long enough to amortize their one fill round trip.
STALENESS_BUCKETS = (0.1, 1.0, 10.0, 100.0, 1000.0, 10000.0,
                     60000.0, 600000.0)

#: Opcodes the plane serves and fills.  GET_ACL stays uncached (ACL
#: changes carry no notification type to invalidate on).
_CACHED_OPS = frozenset(('GET_DATA', 'EXISTS', 'GET_CHILDREN2'))


def cache_roots_default() -> list[str] | None:
    """Process-wide default subtree roots (env resolution): None when
    the plane is off."""
    if os.environ.get('ZKSTREAM_NO_CACHE') == '1':
        return None
    raw = os.environ.get('ZKSTREAM_CACHE', '')
    if not raw:
        return None
    if raw == '1':
        return ['/']
    roots = [r for r in raw.split(':') if r.startswith('/')]
    return roots or None


def _parent(path: str) -> str:
    i = path.rfind('/')
    return path[:i] if i > 0 else '/'


class _Root:
    """One subscribed subtree root's replication state."""

    __slots__ = ('path', 'armed', 'stale', 'arming')

    def __init__(self, path: str) -> None:
        self.path = path
        #: True while a server-side PERSISTENT_RECURSIVE registration
        #: is live for this root on the current session.
        self.armed = False
        #: True while the invalidation stream has a known gap
        #: (disconnected); serving stops until the resync edge.
        self.stale = False
        #: An arm round trip is in flight (dedup for the connect
        #: retrigger).
        self.arming = False


class CachePlane:
    """The client-owned watch-backed read cache.  Constructed by
    :class:`~.client.Client` when a cache root is configured; consult
    via :meth:`lookup`, deposit via :meth:`fill` — both called from
    ``Client._read_request`` so every read path shares one contract.
    """

    def __init__(self, client, roots: list[str],
                 collector=None) -> None:
        self.client = client
        self.roots: dict[str, _Root] = {
            r: _Root(r) for r in roots}
        #: Per-kind entry maps: path -> (payload..., zxid, fill time).
        self._data: dict[str, tuple] = {}
        self._stats: dict[str, tuple] = {}
        self._children: dict[str, tuple] = {}
        #: The newest zxid any invalidation stamped — the notification
        #: half of the coherence position (the reply half is the live
        #: session's ``last_zxid``).
        self._pos = 0
        #: Plain counters for bench/campaign summaries (the metric
        #: series below carry the labelled breakdown).
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self._hits_c = None
        self._miss_c = None
        self._inval_c = None
        self._staleness = None
        if collector is not None:
            self._hits_c = collector.counter(
                METRIC_CACHE_HITS,
                'Reads served from the client cache, by opcode')
            self._miss_c = collector.counter(
                METRIC_CACHE_MISSES,
                'Cache-eligible reads that fell through to the '
                'server, by opcode')
            self._inval_c = collector.counter(
                METRIC_CACHE_INVALIDATIONS,
                'Cache entries dropped by watch notifications, '
                'by event')
            self._staleness = collector.histogram(
                METRIC_CACHE_STALENESS,
                'Age of served cache entries, milliseconds',
                buckets=STALENESS_BUCKETS)
        self._started = False
        self._closed = False
        self._tasks: set = set()

    # -- lifecycle --

    def start(self) -> None:
        """Hook the client's connectivity edges and arm on the first
        connect.  Separate from __init__ for the same reason
        Client.start is: the caller picks the running loop."""
        if self._started:
            return
        self._started = True
        self.client.on('connect', self._on_connect)
        self.client.on('disconnect', self._on_disconnect)

    def close(self) -> None:
        self._closed = True
        for t in list(self._tasks):
            t.cancel()

    # -- connectivity edges --

    def _on_connect(self) -> None:
        if self._closed:
            return
        for root in self.roots.values():
            if not root.armed and not root.arming:
                root.arming = True
                t = ambient_loop().create_task(self._arm(root))
                self._tasks.add(t)
                t.add_done_callback(self._tasks.discard)

    def _on_disconnect(self) -> None:
        # the invalidation stream has a gap from here until the
        # replay's 'resumed' edge: stop serving, keep the entries
        # (the resync drops them — cheaper than dropping twice when
        # the reconnect never comes before close)
        for root in self.roots.values():
            root.stale = True

    async def _arm(self, root: _Root) -> None:
        """One arm round trip: register + ADD_WATCH the root.  On
        failure the registration (if it landed) still rides the next
        reconnect's SET_WATCHES2 replay, and the next 'connect' edge
        retries the round trip."""
        try:
            w = await self.client.add_watch(root.path, recursive=True)
        except asyncio.CancelledError:
            raise
        except Exception:
            sess = self.client.session
            w = (None if sess is None
                 else sess.persistent_watchers.get(root.path))
            if w is None:
                root.arming = False
                return
            # registered but the round trip failed: the replay will
            # arm it — hook the emitter now and wait for 'resumed'
            self._hook(w, root)
            root.arming = False
            return
        finally:
            root.arming = False
        self._hook(w, root)
        self._resync(root)

    def _hook(self, w, root: _Root) -> None:
        """Attach this plane to one session-owned watcher emitter.
        A fresh emitter exists per session, so re-hooking after
        session replacement cannot double-subscribe."""
        w.on('created', lambda p, z: self._invalidate('created', p, z))
        w.on('deleted', lambda p, z: self._invalidate('deleted', p, z))
        w.on('dataChanged',
             lambda p, z: self._invalidate('dataChanged', p, z))
        w.on('resumed', lambda: self._resync(root))
        w.on('lost', lambda: self._lost(root))

    # -- the invalidation stream --

    def _invalidate(self, evt: str, path: str, zxid: int) -> None:
        if zxid > self._pos:
            self._pos = zxid
        # invariant-9: the notification IS an observation of member
        # state at ``zxid`` — raise the client floor so no later
        # server read (distributed or primary) can show older state
        self.client._note_read_floor(zxid)
        n = 0
        if self._data.pop(path, None) is not None:
            n += 1
        if self._stats.pop(path, None) is not None:
            n += 1
        if self._children.pop(path, None) is not None:
            n += 1
        if evt != 'dataChanged':
            # membership changed: the parent's child list AND its
            # stat (pzxid/cversion/numChildren) are both stale
            parent = _parent(path)
            if self._children.pop(parent, None) is not None:
                n += 1
            if self._stats.pop(parent, None) is not None:
                n += 1
        if n:
            self.invalidations += n
            if self._inval_c is not None:
                self._inval_c.increment({'event': evt}, n)

    def _resync(self, root: _Root) -> None:
        """The registration is live again after a gap (reconnect
        replay, or a fresh arm): anything cached under the root may
        have changed while the stream was dark — drop it all and
        refill read-through.  Never silent staleness."""
        self._drop_subtree(root.path)
        sess = self.client.session
        if sess is not None and sess.last_zxid > self._pos:
            # entries filled from here on are newer than anything the
            # dark window could have invalidated
            self._pos = sess.last_zxid
        root.armed = True
        root.stale = False

    def _lost(self, root: _Root) -> None:
        """The owning session died terminally: the server-side
        registration is gone.  Drop state; the client 'connect' edge
        on the replacement session re-subscribes."""
        root.armed = False
        root.stale = True
        self._drop_subtree(root.path)

    def _drop_subtree(self, rootpath: str) -> None:
        for m in (self._data, self._stats, self._children):
            if rootpath == '/':
                m.clear()
                continue
            prefix = rootpath + '/'
            for p in [p for p in m
                      if p == rootpath or p.startswith(prefix)]:
                del m[p]

    # -- the read path (Client._read_request calls in) --

    def _covering_root(self, path: str) -> _Root | None:
        for root in self.roots.values():
            if root.path == '/' or path == root.path \
                    or path.startswith(root.path + '/'):
                return root
        return None

    def _coherent(self) -> bool:
        sess = self.client.session
        if sess is None:
            return False
        pos = self._pos
        if sess.last_zxid > pos:
            pos = sess.last_zxid
        return pos >= self.client.last_seen_zxid()

    def lookup(self, opcode: str, path: str) -> dict | None:
        """Serve one read locally, or None to fall through.  The
        returned dict is shaped exactly like the server reply the
        caller would otherwise get (plus ``'cached': True``)."""
        if opcode not in _CACHED_OPS:
            return None
        root = self._covering_root(path)
        if root is None:
            return None
        if not root.armed or root.stale or not self._coherent():
            self._miss(opcode)
            return None
        if opcode == 'GET_DATA':
            e = self._data.get(path)
            if e is None:
                self._miss(opcode)
                return None
            data, stat, zxid, t0 = e
            out = {'opcode': opcode, 'data': data, 'stat': stat,
                   'zxid': zxid, 'cached': True}
        elif opcode == 'EXISTS':
            e = self._stats.get(path)
            if e is None:
                # a data entry carries the same stat
                d = self._data.get(path)
                if d is None:
                    self._miss(opcode)
                    return None
                e = (d[1], d[2], d[3])
            stat, zxid, t0 = e
            out = {'opcode': opcode, 'stat': stat, 'zxid': zxid,
                   'cached': True}
        else:                              # GET_CHILDREN2
            e = self._children.get(path)
            if e is None:
                self._miss(opcode)
                return None
            children, stat, zxid, t0 = e
            out = {'opcode': opcode, 'children': list(children),
                   'stat': stat, 'zxid': zxid, 'cached': True}
        # a cached read is an observation like any other: it anchors
        # the session floor at its fill zxid (<= coherence position,
        # so serving stays enabled)
        self.client._note_read_floor(zxid)
        self.hits += 1
        if self._hits_c is not None:
            self._hits_c.increment({'op': opcode})
        if self._staleness is not None:
            self._staleness.observe(
                (time.monotonic() - t0) * 1000.0)
        return out

    def _miss(self, opcode: str) -> None:
        self.misses += 1
        if self._miss_c is not None:
            self._miss_c.increment({'op': opcode})

    def fill(self, opcode: str, path: str, pkt: dict) -> None:
        """Deposit one server reply.  Gated on the notification
        position: a reply off a member behind an invalidation this
        plane already applied must not resurrect the dead value."""
        if opcode not in _CACHED_OPS:
            return
        root = self._covering_root(path)
        if root is None or not root.armed or root.stale:
            return
        zxid = pkt.get('zxid', 0)
        if zxid < self._pos:
            return
        now = time.monotonic()
        if opcode == 'GET_DATA':
            self._data[path] = (pkt['data'], pkt['stat'], zxid, now)
        elif opcode == 'EXISTS':
            self._stats[path] = (pkt['stat'], zxid, now)
        else:                              # GET_CHILDREN2
            self._children[path] = (list(pkt['children']),
                                    pkt['stat'], zxid, now)

    # -- warm-up --

    async def prime(self, root: str | None = None,
                    max_nodes: int = 100000) -> int:
        """Walk a subscribed subtree once through the normal read
        path, depositing every node's children and data — after this
        a read-mostly workload starts at its steady-state hit ratio
        instead of paying one fill miss per path.  Returns the number
        of nodes visited; bounded by ``max_nodes``."""
        from ..protocol.errors import ZKError
        targets = ([root] if root is not None
                   else list(self.roots))
        seen = 0
        for r in targets:
            stack = [r]
            while stack and seen < max_nodes:
                p = stack.pop()
                try:
                    children, _stat = await self.client.list(p)
                    await self.client.get(p)
                except ZKError:
                    continue          # raced a delete: fine
                seen += 1
                base = p if p != '/' else ''
                stack.extend(base + '/' + c for c in children)
        return seen

    def stats(self) -> dict:
        """Plane summary for bench/campaign reporting."""
        return {'hits': self.hits, 'misses': self.misses,
                'invalidations': self.invalidations,
                'entries': (len(self._data) + len(self._stats)
                            + len(self._children)),
                'armed': sum(1 for r in self.roots.values()
                             if r.armed and not r.stale)}
