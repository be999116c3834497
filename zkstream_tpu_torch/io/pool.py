"""Backend-set management: the rebuild's replacement for cueball.

The reference delegates multi-server handling to the cueball library: a
static resolver over the ``servers[]`` list, a ConnectionSet holding one
live connection (target 1, max 3), a retry/backoff recovery policy, and
periodic "decoherence" rebalancing toward more-preferred backends
(reference: lib/client.js:88-118).  There is no Python cueball, so this
module implements the same observable behavior directly:

- dial backends in preference order (optionally shuffled, seeded);
- per-attempt connect timeout + retry/delay policy matching the
  reference's recovery numbers (connect: 3000 ms x 3, 500 ms delay;
  default: 5000 ms x 3, 1000 ms delay);
- emit ``failed`` once when the initial retry policy exhausts on every
  backend, then keep dialing in monitor mode (cueball's failed state);
- when connected to a less-preferred backend, periodically try to move
  to a more-preferred one (decoherence; the live-session migration
  itself is the session's ``reattaching`` state, which reverts on
  failure);
- events: ``added(key, conn)``, ``removed(key, conn)``,
  ``stateChanged(state)`` with states starting/running/failed/stopped.
"""

from __future__ import annotations

import asyncio
import os
import random
import zlib

from ..utils.events import Bound, EventEmitter
from ..utils.fsm import note_transition
from ..utils.logging import Logger
from .backoff import BackoffPolicy
from .connection import Backend, ZKConnection
from ..utils.aio import ambient_loop

#: Back-compat alias: the reference's recovery objects carried fixed
#: {timeout, retries, delay}; the same constructor calls now get capped
#: exponential backoff + full jitter on the delay (io/backoff.py).
RecoveryPolicy = BackoffPolicy

DEFAULT_CONNECT_POLICY = BackoffPolicy(timeout=3000, retries=3,
                                       delay=500, cap=5000)
DEFAULT_POLICY = BackoffPolicy(timeout=5000, retries=3,
                               delay=1000, cap=30000)

#: How often to try moving back to a more-preferred backend, ms
#: (reference: decoherenceInterval 600 s, lib/client.js:110-111).
DEFAULT_DECOHERENCE_INTERVAL = 600 * 1000


def read_distribution_default() -> bool:
    """Process-wide default for new clients: ``ZKSTREAM_READ_
    DISTRIBUTION=1`` turns the client-side read plane on (off by
    default — single-connection clients keep the legacy shape)."""
    return os.environ.get('ZKSTREAM_READ_DISTRIBUTION') == '1'


def read_subset_default() -> int | None:
    """Process-wide read-plane subset cap: ``ZKSTREAM_READ_SUBSET=K``
    makes each client dial at most K read sessions from the live
    member list instead of one per backend (None/unset/0 = dial them
    all, the legacy shape).  Large fleets want this: per-client
    session count stays O(K) while membership grows."""
    v = os.environ.get('ZKSTREAM_READ_SUBSET')
    if not v:
        return None
    k = int(v)
    return k if k > 0 else None


class Resolver(EventEmitter):
    """Elastic backend source (README "Dynamic membership"): the
    live member list behind a client, replacing the static
    ``servers[]`` snapshot taken at construction.

    ``update(backends)`` adopts a new fleet — fed by whatever learns
    of a membership change first: the chaos campaigns push the
    ensemble's post-reconfig config directly, an operator can push a
    list scraped from ``mntr``'s ``zk_config_members`` row — and
    emits ``changed(backends)`` so subscribers (the ReadPlane)
    rebalance their dialed subset.  The primary session is NOT torn
    down on update: the pool keeps its current connection until it
    dies, then redials against the updated list (``backends`` is read
    per dial cycle), so a removed member drains rather than drops."""

    def __init__(self, backends: list[Backend]):
        super().__init__()
        self._backends = list(backends)

    @property
    def backends(self) -> list[Backend]:
        return list(self._backends)

    def update(self, backends) -> bool:
        """Adopt ``backends`` (Backend objects or (address, port)
        pairs) as the live list.  Returns True — and notifies
        subscribers — only when the membership actually changed."""
        new = []
        for b in backends:
            if isinstance(b, Backend):
                new.append(b)
            else:
                a, p = b
                new.append(Backend(a, int(p)))
        if [b.key for b in new] == [b.key for b in self._backends]:
            return False
        self._backends = new
        self.emit('changed', list(new))
        return True


class ReadPlane:
    """Client-side read scale-out (README "Read plane"): one
    lightweight read client per backend, so ``get``/``exists``/
    ``getACL``/``list`` fan out across followers and observers while
    writes, watches, MULTI and ``sync`` stay on the primary session.

    The ZooKeeper session contract survives the fan-out because every
    distributed read is zxid-gated TWICE:

    - client-side, the reply header carries the serving member's
      applied zxid; a reply below the client's floor (the newest zxid
      any of its connections has shown it — writes, reads, watch
      fires and the ``sync`` barrier all advance it) is DISCARDED and
      the read re-issued on the primary connection, whose member view
      is session-consistent by construction.  Stale state is never
      surfaced (``bounced`` counts these);
    - server-side, each read session carries its own
      ``lastZxidSeen``-seeded floor and the member's ReadGate blocks
      or bounces behind it (server/server.py).

    Spec verdicts (NO_NODE...) from a read session CANNOT be
    zxid-validated — an error reply carries no observable state — so
    they bounce to the primary too; only the primary's verdict is
    ever surfaced.  Every read therefore costs at most two RTTs and
    usually one, on a member that is not the write path.

    With ``subset=K`` the plane dials at most K read sessions, chosen
    from the live list by rendezvous hashing on the client seed —
    deterministic per client, spread across clients, and minimally
    churned when the membership changes.  A :class:`Resolver` makes
    the list live: on ``changed`` the plane retires subs whose
    backend left its selection and dials the newcomers (README
    "Dynamic membership")."""

    def __init__(self, client, backends: list[Backend],
                 subset: int | None = None,
                 resolver: Resolver | None = None):
        self._client = client
        self._resolver = (resolver if resolver is not None
                          else Resolver(backends))
        self._backends = self._resolver.backends
        self.subset = subset
        self.subs: list = []          # one lightweight Client each
        self._rr = 0
        self.started = False
        #: Monotone dial counter: each sub's seed derives from its
        #: dial ORDINAL, not its position in a mutable list, so the
        #: rerun-key determinism of chaos campaigns survives
        #: membership churn.
        self._dialed = 0
        #: Rendezvous-hash salt for subset selection (no seed: pick
        #: one per plane so unseeded clients still spread).
        self._salt = (client._seed if client._seed is not None
                      else random.randrange(1 << 30))
        #: reads served by the plane / discarded-stale re-issues /
        #: sub-connection failures that fell back to the primary
        self.distributed = 0
        self.bounced = 0
        self.fallbacks = 0
        #: config-change rebalances applied since start
        self.rebalances = 0
        self._resolver.on('changed', self._on_config_change)

    def summary(self) -> dict:
        """Read-path accounting for bench/campaign reports: where
        this client's reads actually went.  Reads the cache plane
        absorbed (README "Client cache plane") never reach this
        plane at all, so they are reported alongside — the cached
        arm of ``bench.py --read`` keys on exactly this split."""
        out = {'distributed': self.distributed,
               'bounced': self.bounced,
               'fallbacks': self.fallbacks,
               'rebalances': self.rebalances}
        cache = getattr(self._client, 'cache', None)
        if cache is not None:
            out['cached'] = cache.hits
            out['cache_misses'] = cache.misses
        return out

    def _select(self) -> list[Backend]:
        """The ≤``subset`` backends this plane should be dialing.
        Rendezvous hashing (highest crc32(salt|key) wins) keeps the
        choice deterministic per (seed, member list) and moves at
        most the displaced sessions when membership changes — a
        joining member steals ~K/N of the fleet's read sessions
        instead of triggering a full reshuffle."""
        backs = self._backends
        k = self.subset
        if k is None or k >= len(backs):
            return list(backs)
        scored = sorted(
            backs,
            key=lambda b: zlib.crc32(
                (b'%d|' % self._salt) + b.key.encode()))
        return scored[:k]

    def _dial(self, b: Backend):
        from ..client import Client   # deferred: client.py imports us
        c = self._client
        # inherit the parent's seed (derived per dial ordinal) and
        # retry policies: chaos rerun-key determinism reaches the
        # read sessions' backoff jitter too
        self._dialed += 1
        seed = (None if c._seed is None
                else c._seed * 1000003 + self._dialed)
        sub = Client(address=b.address, port=b.port,
                     session_timeout=c.session_timeout,
                     shuffle_backends=False, max_spares=0,
                     op_timeout=c.op_timeout, faults=c.faults,
                     log=c.log, seed=seed,
                     connect_policy=c.pool._connect_policy,
                     default_policy=c._retry_policy,
                     read_distribution=False)
        sub.start()
        self.subs.append(sub)
        return sub

    def start(self) -> None:
        """Dial one read client per selected backend (lazy
        sub-sessions: each is a full handshake — the read capacity IS
        those sessions landing on followers/observers)."""
        if self.started:
            return
        self.started = True
        for b in self._select():
            self._dial(b)

    def _on_config_change(self, backends: list[Backend]) -> None:
        """Resolver callback: re-run subset selection against the new
        member list, retire subs whose backend left it, dial the
        newcomers.  Retirement is a clean async close (the session's
        CLOSE_SESSION drains in the background) so in-flight reads on
        a leaving member finish or bounce — never hang."""
        self._backends = list(backends)
        if not self.started:
            return
        want = {b.key: b for b in self._select()}
        have = {}
        changed = False
        for sub in list(self.subs):
            key = sub.pool.backends[0].key
            if key in want and key not in have:
                have[key] = sub
            else:
                self.subs.remove(sub)
                ambient_loop().create_task(self._retire(sub))
                changed = True
        for key, b in want.items():
            if key not in have:
                self._dial(b)
                changed = True
        if changed:
            self.rebalances += 1

    @staticmethod
    async def _retire(sub) -> None:
        try:
            await asyncio.wait_for(sub.close(), 5)
        except (asyncio.TimeoutError, TimeoutError):
            sub.pool.stop()

    def pick(self, avoid_key: str | None = None):
        """The next connected read client, round-robin, preferring
        backends other than ``avoid_key`` (the primary's — reading
        there would not offload it); None when none is usable."""
        if not self.subs:
            return None
        n = len(self.subs)
        fallback = None
        for i in range(n):
            sub = self.subs[(self._rr + i) % n]
            if not sub.is_connected():
                continue
            key = sub.pool.backends[0].key
            if avoid_key is not None and key == avoid_key:
                fallback = fallback or (i, sub)
                continue
            self._rr = (self._rr + i + 1) % n
            return sub
        if fallback is not None:
            i, sub = fallback
            self._rr = (self._rr + i + 1) % n
            return sub
        return None

    async def close(self) -> None:
        self._resolver.remove_listener('changed',
                                       self._on_config_change)
        subs, self.subs = self.subs, []
        for sub in subs:
            try:
                await asyncio.wait_for(sub.close(), 5)
            except (asyncio.TimeoutError, TimeoutError):
                sub.pool.stop()


class ConnectionPool(EventEmitter):
    def __init__(self, client, backends: list[Backend],
                 connect_policy: BackoffPolicy = DEFAULT_CONNECT_POLICY,
                 default_policy: BackoffPolicy = DEFAULT_POLICY,
                 decoherence_interval: int = DEFAULT_DECOHERENCE_INTERVAL,
                 shuffle: bool = True, seed: int | None = None,
                 max_spares: int = 2):
        super().__init__()
        assert backends, 'at least one backend required'
        self._client = client
        self.log = getattr(client, 'log', Logger()).child(
            component='ConnectionPool')
        self._backends = list(backends)
        if shuffle:
            random.Random(seed).shuffle(self._backends)
        self._connect_policy = connect_policy
        self._default_policy = default_policy
        self._decoherence_interval = decoherence_interval
        #: Jitter stream for retry delays; derived from (not equal to)
        #: the shuffle seed so seeding one does not couple the other.
        self._jitter_seed = None if seed is None else seed ^ 0x5eed
        #: Monitor-mode redial backoff: persists across dial cycles so
        #: a long outage walks the delay up to the cap (storm
        #: decorrelation) and resets only on a successful connect.
        self._monitor_backoff = default_policy.backoff(self._jitter_seed)

        #: Circuit-breaker flag: True from the moment the initial
        #: retry policy exhausts on every backend ('failed' edge) until
        #: the next successful connect.  Surfaced as the 'degraded' /
        #: 'recovered' events here, re-emitted by the client, and read
        #: by the client's zookeeper_degraded gauge.
        self.degraded = False

        self.state = 'stopped'
        self.conn: ZKConnection | None = None
        self._conn_index: int | None = None
        #: Resolved when the pool's *current* connection dies; the dial
        #: loop parks on it while a connection is live.
        self._hold: asyncio.Future | None = None
        self._task: asyncio.Task | None = None
        self._decoherence_handle: asyncio.TimerHandle | None = None
        self._decoherence_task: asyncio.Task | None = None
        #: True while _try_rebalance is mid-flight: the old connection's
        #: death is then expected (the session migration destroys it)
        #: and must not wake the dial loop.
        self._rebalancing = False
        self._stopping = False
        self._failed_emitted = False

        #: Warm spares: TCP-connected, pre-handshake standbys promoted
        #: on failover instead of paying a fresh dial (cueball keeps up
        #: to 3 connections, target 1 — reference: lib/client.js:108-109).
        self.max_spares = max_spares
        self.spares: list[ZKConnection] = []
        self._spare_task: asyncio.Task | None = None
        self._spare_wake: asyncio.Event | None = None

    @property
    def backends(self) -> list[Backend]:
        return list(self._backends)

    def current_backend(self) -> Backend | None:
        return self.conn.backend if self.conn is not None else None

    def set_backends(self, backends: list[Backend]) -> None:
        """Adopt a new live backend list (README "Dynamic
        membership").  The current connection is left alone — a
        removed member drains in place and its eventual death redials
        against the updated list (the dial loop reads ``_backends``
        each cycle) — but parked spares on departed backends are
        destroyed so a failover cannot promote onto one."""
        self._backends = list(backends)
        keys = {b.key for b in self._backends}
        if self.conn is not None:
            self._conn_index = (
                self._backend_index(self.conn.backend)
                if self.conn.backend.key in keys else None)
        drop = [s for s in self.spares if s.backend.key not in keys]
        if drop:
            self.spares = [s for s in self.spares if s not in drop]
            for s in drop:
                s.destroy()
            self._wake_spares()

    # -- lifecycle --

    def start(self) -> None:
        assert self._task is None, 'pool already started'
        self._stopping = False
        self._set_state('starting')
        loop = ambient_loop()
        self._task = loop.create_task(self._dial_loop())
        if self.max_spares > 0:
            self._spare_wake = asyncio.Event()
            self._spare_task = loop.create_task(self._spare_loop())

    def stop(self) -> None:
        self._stopping = True
        if self._task is not None:
            self._task.cancel()
            self._task = None
        if self._spare_task is not None:
            self._spare_task.cancel()
            self._spare_task = None
        spares, self.spares = self.spares, []
        for s in spares:
            s.destroy()
        self._cancel_decoherence()
        if self._decoherence_task is not None:
            self._decoherence_task.cancel()
            self._decoherence_task = None
        self._drop_conn(destroy=True)
        self._set_state('stopped')

    def get_state(self) -> str:
        """The pool's state name — the not-quite-FSM's analogue of
        FSM.get_state(), so the fsm metric bindings (utils/fsm.py)
        census it alongside the real machines."""
        return self.state

    def _set_state(self, st: str) -> None:
        if self.state != st:
            note_transition(self, self.state, st)
            self.state = st
            self.emit('stateChanged', st)

    # -- current-connection bookkeeping --

    def _install_conn(self, idx: int, conn: ZKConnection) -> None:
        self.conn = conn
        self._conn_index = idx
        self.emit('added', conn.backend.key, conn)
        self._wake_spares()
        on_dead = Bound(ConnectionPool._on_conn_dead, self, conn)
        conn.on('error', on_dead)
        conn.on('close', on_dead)
        if not (conn.is_in_state('connected') or
                conn.is_in_state('closing')):
            on_dead()

    def _on_conn_dead(self, conn: ZKConnection, *args) -> None:
        # Only react if this is still the pool's current connection
        # (after a rebalance swap the old conn dies later, already
        # dropped from our bookkeeping).
        if self.conn is conn:
            self._drop_conn(destroy=True)
            # During a rebalance the old connection's death is the
            # session migration destroying it; the rebalance task owns
            # the hold future's fate then.
            if self._rebalancing:
                return
            if self._hold is not None and not self._hold.done():
                self._hold.set_result(None)

    def _drop_conn(self, destroy: bool) -> None:
        if self.conn is None:
            return
        conn, self.conn = self.conn, None
        self._conn_index = None
        self.emit('removed', conn.backend.key, conn)
        if destroy:
            conn.destroy()

    # -- dialing --

    async def _await_conn(self, conn: ZKConnection, want_state: str,
                          timeout_ms: int) -> ZKConnection | None:
        """Wait until ``conn`` reaches ``want_state`` or dies (timeout
        included); returns the connection on success, else destroys it
        and returns None.  Shared by dialing, spare parking, and spare
        promotion so the wait/cleanup/cancel handling cannot diverge."""
        loop = ambient_loop()
        fut: asyncio.Future = loop.create_future()

        def settle(*args):
            if not fut.done():
                fut.set_result(None)

        def on_state(st):
            if st == want_state:
                settle()
        conn.on('stateChanged', on_state)
        conn.on('error', settle)
        conn.on('close', settle)
        try:
            await asyncio.wait_for(asyncio.shield(fut),
                                   timeout_ms / 1000.0)
        except asyncio.TimeoutError:
            pass
        except asyncio.CancelledError:
            conn.destroy()
            raise
        finally:
            conn.remove_listener('stateChanged', on_state)
            conn.remove_listener('error', settle)
            conn.remove_listener('close', settle)
        if conn.is_in_state(want_state):
            return conn
        conn.destroy()
        return None

    async def _dial_one(self, backend: Backend,
                        timeout_ms: int) -> ZKConnection | None:
        """Dial one backend; resolve to the connection if it reaches
        'connected' within the timeout, else None."""
        conn = ZKConnection(self._client, backend)
        conn.connect()
        return await self._await_conn(conn, 'connected', timeout_ms)

    def _note_connected(self) -> None:
        """A connect landed: clear the failure latches and reset the
        monitor backoff so the next outage starts from the base delay."""
        self._failed_emitted = False
        self._monitor_backoff.reset()
        if self.degraded:
            self.degraded = False
            self.log.info('left degraded mode: backend reachable again')
            self.emit('recovered')

    async def _dial_loop(self) -> None:
        """Keep one live connection.  The initial phase uses the connect
        policy; once it exhausts on all backends, emit 'failed', enter
        degraded mode, and keep dialing under the default policy
        (cueball monitor mode).  All retry delays are capped-exponential
        with full jitter (io/backoff.py) so a fleet of clients losing
        the same backend does not redial in synchronized waves.
        Failover promotes a warm spare when one is parked — no fresh
        TCP dial."""
        policy = self._connect_policy
        while not self._stopping:
            promoted = await self._promote_spare()
            if promoted is not None:
                idx, conn = promoted
                self._note_connected()
                await self._hold_connection(idx, conn)
                policy = self._connect_policy
                continue
            connected = False
            attempt_backoff = policy.backoff(self._jitter_seed)
            for attempt in range(policy.retries):
                for idx, backend in enumerate(self._backends):
                    if self._stopping:
                        return
                    conn = await self._dial_one(backend, policy.timeout)
                    if conn is None:
                        continue
                    self._note_connected()
                    connected = True
                    await self._hold_connection(idx, conn)
                    break
                if connected:
                    break
                if attempt + 1 < policy.retries:
                    await asyncio.sleep(
                        attempt_backoff.next_delay() / 1000.0)
            if connected:
                # The connection (or its successor) died; dial again
                # under the fresh-connect policy.
                policy = self._connect_policy
                continue
            if not self._failed_emitted:
                self._failed_emitted = True
                self.degraded = True
                self._set_state('failed')
                self.emit('degraded')
                self.log.warning('failed to connect to any ZK backend '
                                 '(exhausted retry policy); entering '
                                 'monitor mode (degraded)')
            policy = self._default_policy
            await asyncio.sleep(
                self._monitor_backoff.next_delay() / 1000.0)

    async def _hold_connection(self, idx: int, conn: ZKConnection) -> None:
        """Park while a connection (or a rebalance successor) is live."""
        loop = ambient_loop()
        self._hold = loop.create_future()
        self._install_conn(idx, conn)
        self._set_state('running')
        if idx > 0:
            self._arm_decoherence()
        try:
            await self._hold
        finally:
            self._hold = None
            self._cancel_decoherence()

    # -- warm spares (cueball target 1 / max 3) --

    def _wake_spares(self) -> None:
        if self._spare_wake is not None:
            self._spare_wake.set()

    def _backend_index(self, backend: Backend) -> int:
        for i, b in enumerate(self._backends):
            if b.key == backend.key:
                return i
        return len(self._backends) - 1

    async def _spare_loop(self) -> None:
        """Keep up to ``max_spares`` parked standbys while a live
        connection exists.  Dial failures retry on the default policy's
        delay; an unfillable deficit (no candidate backends, e.g. a
        single-address client already holding its one spare) parks on
        the wake event instead of polling."""
        while not self._stopping:
            await self._spare_wake.wait()
            self._spare_wake.clear()
            while (not self._stopping and self.conn is not None
                   and len(self.spares) < self.max_spares):
                outcome = await self._add_one_spare()
                if outcome is True:
                    continue
                if outcome is None:
                    break  # no candidates: wait for a wake, not a timer
                try:
                    await asyncio.wait_for(
                        self._spare_wake.wait(),
                        self._default_policy.delay / 1000.0)
                except asyncio.TimeoutError:
                    pass
                self._spare_wake.clear()

    async def _add_one_spare(self) -> bool | None:
        """True = spare added; False = candidates exist but none
        reachable (caller retries on a delay); None = no candidate
        backends at all (caller waits for a wake)."""
        cur = self.conn.backend.key if self.conn is not None else None
        have = {s.backend.key for s in self.spares}
        cands = [b for b in self._backends
                 if b.key != cur and b.key not in have]
        if not cands and len(self._backends) == 1 and not self.spares:
            # single-backend config: a same-backend spare still skips
            # the TCP dial on failover
            cands = [self._backends[0]]
        if not cands:
            return None
        for backend in cands:
            conn = await self._dial_spare(backend)
            if self._stopping or self.conn is None:
                if conn is not None:
                    conn.destroy()
                return False
            if conn is not None:
                self._install_spare(conn)
                return True
        return False

    async def _dial_spare(self, backend: Backend) -> ZKConnection | None:
        """TCP-connect a spare; resolve once it parks (or dies)."""
        conn = ZKConnection(self._client, backend, spare=True)
        conn.connect()
        return await self._await_conn(conn, 'parked',
                                      self._connect_policy.timeout)

    def _install_spare(self, conn: ZKConnection) -> None:
        self.spares.append(conn)
        self.log.debug('warm spare parked for %s', conn.backend.key)
        on_dead = Bound(ConnectionPool._on_spare_dead, self, conn)
        conn.on('error', on_dead)
        conn.on('close', on_dead)

    def _on_spare_dead(self, conn: ZKConnection, *args) -> None:
        if conn in self.spares:
            self.spares.remove(conn)
            self._wake_spares()

    async def _promote_spare(self) -> tuple[int, ZKConnection] | None:
        """Promote the most-preferred parked spare into a live
        connection (handshake only — the TCP dial already happened)."""
        while self.spares and not self._stopping:
            conn = min(self.spares,
                       key=lambda s: self._backend_index(s.backend))
            self.spares.remove(conn)
            if not conn.is_in_state('parked'):
                conn.destroy()
                continue
            self.log.info('promoting warm spare to %s', conn.backend.key)
            conn.promote()
            if await self._await_conn(conn, 'connected',
                                      self._connect_policy.timeout):
                self._wake_spares()
                return self._backend_index(conn.backend), conn
        return None

    # -- decoherence: move toward preferred backends --

    def rebalance_now(self) -> None:
        """Trigger one decoherence pass immediately instead of waiting
        out the interval: if the pool currently serves a less-preferred
        backend, dial the more-preferred ones and migrate the live
        session on success (the session's 'reattaching' state reverts
        on failure).  A no-op while already rebalancing, stopped, or
        on the most-preferred backend.  The ensemble chaos campaign
        uses this to force session migration mid-operation."""
        if self._stopping:
            return
        if self._decoherence_task is None or \
                self._decoherence_task.done():
            self._decoherence_task = ambient_loop().create_task(
                self._try_rebalance())

    def _arm_decoherence(self) -> None:
        self._cancel_decoherence()
        loop = ambient_loop()

        def fire():
            if self._decoherence_task is None or \
               self._decoherence_task.done():
                self._decoherence_task = loop.create_task(
                    self._try_rebalance())
        self._decoherence_handle = loop.call_later(
            self._decoherence_interval / 1000.0, fire)

    def _cancel_decoherence(self) -> None:
        if self._decoherence_handle is not None:
            self._decoherence_handle.cancel()
            self._decoherence_handle = None

    async def _try_rebalance(self) -> None:
        """Dial more-preferred backends; a successful handshake makes
        the session migrate (its 'reattaching' state handles revert on
        failure).  On success, swap the pool's current connection; the
        old one is destroyed by the session once the new one connects —
        an expected death that must not wake the dial loop (it would
        dial a redundant connection and force another migration)."""
        cur = self._conn_index
        if cur is None or cur == 0 or self.conn is None:
            return
        self._rebalancing = True
        try:
            for idx in range(cur):
                if self._stopping:
                    return
                backend = self._backends[idx]
                self.log.debug('decoherence: trying preferred backend '
                               '%s', backend.key)
                conn = await self._dial_one(backend,
                                            self._connect_policy.timeout)
                if self._stopping:
                    if conn is not None:
                        conn.destroy()
                    return
                if conn is not None:
                    old = self.conn
                    # Drop the old conn from bookkeeping without
                    # destroying it: the session owns its teardown
                    # after migration (it may already be dead and
                    # dropped by its death watch).
                    self.conn = None
                    self._conn_index = None
                    if old is not None:
                        self.emit('removed', old.backend.key, old)
                    self._install_conn(idx, conn)
                    if idx > 0:
                        self._arm_decoherence()
                    return
        finally:
            self._rebalancing = False
            # If every attempt failed AND the old connection died while
            # we were trying (its death watch deferred to us), wake the
            # dial loop now.
            if self.conn is None and self._hold is not None and \
               not self._hold.done():
                self._hold.set_result(None)
        if self._conn_index is not None and self._conn_index > 0:
            self._arm_decoherence()
