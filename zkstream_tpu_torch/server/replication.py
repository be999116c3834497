"""Cross-process ensemble members: commit-log replication over TCP.

The in-process ``ZKEnsemble`` shares one ``ZKDatabase`` object between
its members, so killing a member is necessarily a cooperative close —
half-written frames, dead-socket detection and OS-level connection
resets are never exercised.  The reference's multi-node tier runs three
genuinely separate server processes and kills them with signals
(reference: test/multi-node.test.js:23-39,309-338; test/zkserver.js
hunts child PIDs for a clean kill).  This module gives the rebuild the
same tier: a **leader process** exporting its ``ZKDatabase`` over a
replication service, and **follower processes** running a full
``ZKServer`` whose leader-side operations forward over TCP while reads
and watches are served from a local :class:`~.store.ReplicaStore`
replaying the mirrored commit log — so ``SIGKILL`` on any follower
severs real client sockets at the OS level, and the session state the
clients depend on survives in the leader process, exactly the
single-leader replication model store.py already implements in-process.

Two channels per follower, paired by a token:

- ``control`` — a *blocking* socket the follower's request handlers
  call RPCs on (create/delete/set_data, session lifecycle, sync
  barrier).  Every response piggybacks the commit-log entries the
  follower has not mirrored yet, so a write-then-read through one
  member observes its own write without waiting on the async stream.
- ``events`` — an asyncio stream the leader pushes to: new commit-log
  entries as they land, and session-expiry broadcasts.

Wire format: 4-byte big-endian length + pickle.  Pickle is safe here
for the same reason the reference can shell out to a local JVM: both
ends are the same trusted test harness on one machine; this service
must never listen on a non-loopback interface.

Follower restart is supported the way real ZK does it: a follower
joining after history began (or rejoining after a SIGKILL) is
bootstrapped from a leader snapshot — the tree image plus its log
position — and replays only the tail from there.  Killing the leader
no longer kills the quorum: followers detect the push-channel EOF and
elect a replacement over their recovered (epoch, zxid) pairs
(server/election.py); every push and forwarded-write ack here is
stamped with the leadership epoch, stale-epoch pushes are rejected by
the mirror, and a deposed leader's forwarded writes bounce with a
typed EPOCH_FENCED error instead of being silently applied.
"""

from __future__ import annotations

import asyncio
import logging
import os
import pickle
import socket
import struct
import threading
import time

from ..protocol.consts import CreateFlag
from ..utils.events import EventEmitter
from .persist import entry_zxid
from .store import (
    ReplicaStore,
    ZKDatabase,
    ZKOpError,
    ZKServerSession,
    durable_sessions,
)

log = logging.getLogger('zkstream_tpu_torch.server.replication')

_LEN = struct.Struct('>I')


class ZKLeaderLostError(ZKOpError):
    """The leader process died (or the control channel was severed)
    mid-RPC: the forwarded write's outcome is unknown.  Typed as
    ``CONNECTION_LOSS`` — the outcome-unknown code the client-side
    ambiguity accounting (io/invariants.py AMBIGUOUS_CODES) already
    classifies — so a follower's request handler converts it into an
    honest wire error instead of tearing the client connection down
    with a raw ``ConnectionError``."""

    def __init__(self, detail: str = ''):
        super().__init__('CONNECTION_LOSS')
        self.detail = detail


class ZKEpochFencedError(ZKOpError):
    """A write carried (or arrived at) a stale leadership epoch
    (server/election.py): definitively rejected, never applied."""

    def __init__(self):
        super().__init__('EPOCH_FENCED')


def _dump(msg) -> bytes:
    payload = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
    return _LEN.pack(len(payload)) + payload


async def _read_msg(reader: asyncio.StreamReader):
    hdr = await reader.readexactly(4)
    (n,) = _LEN.unpack(hdr)
    return pickle.loads(await reader.readexactly(n))


def _recv_msg(sock: socket.socket):
    buf = b''
    while len(buf) < 4:
        chunk = sock.recv(4 - len(buf))
        if not chunk:
            raise ConnectionError('replication control channel closed')
        buf += chunk
    (n,) = _LEN.unpack(buf)
    out = b''
    while len(out) < n:
        chunk = sock.recv(n - len(out))
        if not chunk:
            raise ConnectionError('replication control channel closed')
        out += chunk
    return pickle.loads(out)


# ---------------------------------------------------------------------
# Quorum-commit: the leader's ack means a majority holds the write.
# ---------------------------------------------------------------------

METRIC_QUORUM_ACK = 'zk_quorum_ack_ms'
QUORUM_ACK_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                      25.0, 50.0, 100.0, 250.0)

#: How long a gated flush waits for quorum before DEGRADING — the
#: release-on-attempt philosophy of the WAL's fsync gate: a quorum the
#: ensemble cannot currently assemble (partition, parked followers)
#: must delay acks, never wedge every reply forever.  Degraded
#: releases are counted (``degraded_releases``, mntr
#: ``zk_quorum_degraded``) and the quorum floor does NOT advance, so
#: the invariant engine's no-demotion rule stays honest.
DEFAULT_QUORUM_WAIT_MS = 250.0


def quorum_enabled() -> bool:
    """Global kill switch (mirrors ``ZKSTREAM_NO_WAL`` /
    ``ZKSTREAM_NO_ELECTION``): the fsync-only ack barrier stays
    available as the A/B validator arm (``bench.py --quorum``)."""
    return os.environ.get('ZKSTREAM_NO_QUORUM') != '1'


def quorum_wait_ms() -> float:
    try:
        v = float(os.environ.get('ZKSTREAM_QUORUM_WAIT_MS', ''))
    except ValueError:
        return DEFAULT_QUORUM_WAIT_MS
    return v if v > 0 else DEFAULT_QUORUM_WAIT_MS


def quorum_of(total: int) -> int:
    return total // 2 + 1


class QuorumGate:
    """The quorum half of the leader's ack barrier.

    Before this gate, a write acked THROUGH THE LEADER died with the
    leader: only the leader's tree (and WAL) held it, and
    ``run_process_schedule`` routed writes through followers purely to
    keep the no-acked-write-lost invariant honest.  The gate closes
    that gap: every follower ack piggybacks its mirror's newest
    ``applied_zxid`` (and accepted epoch) on the existing replication
    channels, and the leader's send plane holds a corked tick's acks —
    alongside the WAL's group fsync, one wait for both
    (:class:`CommitBarrier`) — until a majority of the ``total``
    membership (the leader's own vote included) holds every txn the
    tick acked.

    Fencing: an ack stamped with an epoch below the database's current
    one is a deposed era's — dropped and counted (``stale_acks``), so
    a partitioned ex-follower's late acks can never count toward a new
    epoch's quorum.

    Liveness: a quorum the ensemble cannot assemble degrades after
    ``wait_ms`` (:data:`DEFAULT_QUORUM_WAIT_MS`) — the corked acks
    leave quorum-unconfirmed, ``degraded_releases`` counts it, and the
    quorum floor stays put.  A single-member ensemble (``total < 2``)
    needs no gate at all: the leader IS the majority."""

    def __init__(self, db, total: int, *, enabled: bool | None = None,
                 collector=None, wait_ms: float | None = None):
        self.db = db
        self.total = total
        self.enabled = ((quorum_enabled() if enabled is None
                         else enabled) and total >= 2)
        self.wait_ms = wait_ms if wait_ms is not None \
            else quorum_wait_ms()
        #: voter key -> newest acked zxid (follower token / member id;
        #: the leader's own vote is ``db.zxid``, never stored here)
        self.acked: dict = {}
        #: Dynamic membership (server/store.py reconfig records).
        #: ``voters`` None = legacy count-based majority over
        #: ``total`` (bit-identical to pre-reconfig behavior).  When
        #: set, the majority is computed over the NAMED voter keys —
        #: and while ``old_voters`` stands (a joint window), over
        #: BOTH sets, taking the lower floor: no txn is quorum-held
        #: until a majority of C_old AND a majority of C_new hold it.
        #: ``leader_key`` names the member whose vote is ``db.zxid``.
        self.voters: set | None = None
        self.old_voters: set | None = None
        self.leader_key = None
        self.stale_acks = 0
        self.degraded_releases = 0
        #: newest zxid a majority is known to hold (cached; advanced
        #: by :meth:`note_ack`)
        self.quorum_zxid_floor = 0
        #: newest zxid already RELEASED unconfirmed by a degrade: the
        #: gate must not re-block later (read-only) ticks on a write
        #: that already left — each NEW write gets its own bounded
        #: wait, never a standing stall
        self.degraded_zxid = 0
        #: Optional utils/trace.TraceRing: the floor advancing leaves
        #: a ``QUORUM_ACK`` span between WAL_APPEND and the client ack
        #: in the zxid-keyed chain.
        self.trace = None
        self._waiters: list = []      # send-plane releases
        self._futs: list = []         # (target_zxid, Future) rpc waits
        self._timer = None
        self._commit_t: dict[int, float] = {}
        self._hist = None
        if collector is not None:
            self.bind_metrics(collector)

    def bind_metrics(self, collector) -> None:
        self._hist = collector.histogram(
            METRIC_QUORUM_ACK,
            'Commit to majority-ack latency, ms',
            buckets=QUORUM_ACK_BUCKETS)

    # -- feed --

    def note_pushed(self, zxid: int) -> None:
        """Stamp a commit's push time (latency measurement base for
        the zk_quorum_ack_ms histogram; bounded)."""
        if self.enabled and zxid not in self._commit_t \
                and len(self._commit_t) < 4096:
            self._commit_t[zxid] = time.monotonic()

    def note_ack(self, voter, zxid: int,
                 epoch: int | None = None) -> None:
        """One follower's piggybacked applied-zxid ack.  Epoch-fenced:
        a stale era's ack never counts toward the current quorum.
        Config-fenced: once a named voter set stands, an ack from a
        member outside it (a removed voter — the reconfig fence) is
        dropped and counted exactly like a stale epoch's."""
        if not self.enabled:
            return
        if epoch is not None and epoch < getattr(self.db, 'epoch', 0):
            self.stale_acks += 1
            return
        if self.voters is not None and voter != self.leader_key \
                and voter not in self.voters \
                and (self.old_voters is None
                     or voter not in self.old_voters):
            self.stale_acks += 1
            return
        if zxid <= self.acked.get(voter, 0):
            return
        self.acked[voter] = zxid
        self._advance()

    def forget(self, voter) -> None:
        """A follower detached: its standing vote leaves the pool
        (it can rejoin by acking again)."""
        self.acked.pop(voter, None)

    def set_config(self, voters, old_voters=None,
                   leader_key=None) -> None:
        """Install the named voter set(s) from a reconfig record
        (server/store.py): ``voters`` is C_new's ack keys,
        ``old_voters`` C_old's while a joint window stands.  A removed
        member's standing vote is forgotten immediately — it can
        neither hold up nor satisfy the new majority — and its later
        acks are fenced (``note_ack``)."""
        self.voters = set(voters) if voters is not None else None
        self.old_voters = (set(old_voters)
                           if old_voters is not None else None)
        if leader_key is not None:
            self.leader_key = leader_key
        if self.voters is not None:
            live = self.voters | (self.old_voters or set())
            for v in [v for v in self.acked if v not in live]:
                del self.acked[v]
        self._advance()

    def _majority_floor(self, keys, extra=None) -> int:
        """Majority floor over ONE named voter set: each member votes
        its acked zxid (0 when it never acked), the leader its own
        ``db.zxid``; ``extra = (key, zxid)`` counts one member's vote
        virtually (the forwarded-write grant)."""
        vals = []
        for k in keys:
            if k == self.leader_key:
                vals.append(self.db.zxid)
            elif extra is not None and k == extra[0]:
                vals.append(max(extra[1], self.acked.get(k, 0)))
            else:
                vals.append(self.acked.get(k, 0))
        if not vals:
            return 0
        vals.sort(reverse=True)
        return vals[quorum_of(len(vals)) - 1]

    def quorum_zxid(self) -> int:
        """The newest zxid a majority of the membership holds (the
        leader's own ``db.zxid`` is one vote).  With a named voter
        set installed the majority is per-set; during a joint window
        it is the LOWER of the two sets' floors — majorities of both
        C_old and C_new, the joint-consensus commit rule."""
        if not self.enabled:
            return self.db.zxid
        if self.voters is not None:
            floor = self._majority_floor(self.voters)
            if self.old_voters is not None:
                floor = min(floor,
                            self._majority_floor(self.old_voters))
            return floor
        pool = sorted([self.db.zxid] + list(self.acked.values()),
                      reverse=True)
        need = quorum_of(self.total)
        return pool[need - 1] if len(pool) >= need else 0

    def _floor_with_grant(self, grant, target: int) -> int:
        """The quorum floor with ``grant``'s vote counted virtually
        at ``target``: the forwarded-write RPC path — the calling
        follower's loop is parked inside the blocking RPC, but the
        response's own piggyback delivers the txn into its mirror
        before the client can see the ack, so its vote is guaranteed
        by construction, not awaited (awaiting it would deadlock a
        two-member ensemble into the degrade timeout per write).
        Under a named config the grant only counts when the granter
        is (still) a member of the set being tallied — a removed
        voter's virtual vote is fenced like its real ones."""
        if self.voters is not None:
            extra = (grant, target) if grant is not None else None
            floor = self._majority_floor(self.voters, extra)
            if self.old_voters is not None:
                floor = min(floor, self._majority_floor(
                    self.old_voters, extra))
            return floor
        pool = [self.db.zxid]
        if grant is not None:
            pool.append(target)
        pool += [z for v, z in self.acked.items() if v != grant]
        pool.sort(reverse=True)
        need = quorum_of(self.total)
        return pool[need - 1] if len(pool) >= need else 0

    def _advance(self) -> None:
        floor = self.quorum_zxid()
        if floor <= self.quorum_zxid_floor:
            return
        self.quorum_zxid_floor = floor
        now = time.monotonic()
        covered = [z for z in self._commit_t if z <= floor]
        for z in covered:
            dur_ms = (now - self._commit_t.pop(z)) * 1000.0
            if self._hist is not None:
                self._hist.observe(dur_ms)
        if self.trace is not None:
            self.trace.note('QUORUM_ACK', zxid=floor, kind='server',
                            batch=max(1, len(covered)))
        if floor >= self.db.zxid:
            # every committed txn is majority-held: corked acks leave
            self._release(degraded=False)
        for target, fut, grant in self._futs[:]:
            if not fut.done() and \
                    self._floor_with_grant(grant, target) >= target:
                fut.set_result(True)
        self._futs = [e for e in self._futs if not e[1].done()]

    # -- the ack gate (composed with the WAL by CommitBarrier) --

    def gate_flush(self, release, mark: int | None = None) -> bool:
        """True when every committed txn is majority-held — the
        corked acks may leave.  Otherwise the flush stays corked,
        ``release`` re-flushes when the quorum floor reaches the
        current zxid, and the degrade timer bounds the wait.  ``mark``
        is the WAL gate's (its holds' accounting), unused here."""
        if not self.enabled:
            return True
        if self.quorum_zxid() >= self.db.zxid \
                or self.db.zxid <= self.degraded_zxid:
            return True
        self._waiters.append(release)
        self._arm_timer()
        return False

    def sync_for_flush(self) -> None:
        """The synchronous barrier half is the WAL's alone: quorum
        acks arrive on the events channel THIS loop serves, so a hard
        flush (fault-injected delivery, connection close) cannot
        block on them — those frames leave fsynced-but-unconfirmed,
        exactly like a degraded release."""

    def _arm_timer(self) -> None:
        if self._timer is not None:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            # no loop to deliver acks on either: degrade immediately —
            # and mark the floor BEFORE releasing, or the released
            # flush re-gates into this branch forever (the release IS
            # flush_now, which re-runs gate_flush synchronously)
            self.degraded_releases += 1
            self.degraded_zxid = self.db.zxid
            self._release(degraded=True)
            return
        self._timer = loop.call_later(self.wait_ms / 1000.0,
                                      self._degrade)

    def _degrade(self) -> None:
        self._timer = None
        if self._waiters and self.quorum_zxid() < self.db.zxid:
            self.degraded_releases += 1
            self.degraded_zxid = self.db.zxid
            log.warning('quorum wait degraded after %.0f ms (floor '
                        'zxid %d, leader zxid %d): acks leave '
                        'quorum-unconfirmed', self.wait_ms,
                        self.quorum_zxid_floor, self.db.zxid)
        self._release(degraded=True)

    def _release(self, degraded: bool) -> None:
        if self._timer is not None and not degraded:
            self._timer.cancel()
            self._timer = None
        waiters, self._waiters = self._waiters, []
        for release in waiters:
            try:
                release()
            except Exception:  # pragma: no cover - plane teardown
                log.exception('quorum gate release failed')

    async def wait(self, target_zxid: int,
                   timeout_s: float | None = None,
                   grant=None) -> bool:
        """Await the quorum floor reaching ``target_zxid`` (the
        forwarded-write RPC path): True on quorum, False on the
        degrade timeout.  ``grant`` is the calling follower's voter
        key, counted virtually at the target (see
        :meth:`_floor_with_grant`)."""
        if not self.enabled \
                or self._floor_with_grant(grant, target_zxid) \
                >= target_zxid:
            return True
        fut = asyncio.get_running_loop().create_future()
        self._futs.append((target_zxid, fut, grant))
        try:
            await asyncio.wait_for(
                fut, (timeout_s if timeout_s is not None
                      else self.wait_ms / 1000.0))
            return True
        except (asyncio.TimeoutError, TimeoutError):
            self.degraded_releases += 1
            return False
        finally:
            self._futs = [e for e in self._futs if e[1] is not fut]

    def close(self) -> None:
        # disable BEFORE releasing: a release re-enters gate_flush,
        # and a closed gate must gate nothing (re-registering here
        # would arm a fresh degrade timer on a gate being torn down)
        self.enabled = False
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        self._release(degraded=True)


class CommitBarrier:
    """The leader ack barrier: WAL group fsync AND quorum ack, taken
    together — a corked tick registers one release with each and
    flushes when both clear (io/sendplane.py ``barrier`` contract).
    Either half may be absent (WAL-less bench arms, quorum-disabled
    validator)."""

    __slots__ = ('wal', 'quorum')

    def __init__(self, wal, quorum):
        self.wal = wal
        self.quorum = quorum

    def gate_flush(self, release, mark: int | None = None) -> bool:
        # call BOTH gates unconditionally: the fsync and the quorum
        # round-trip overlap instead of serializing
        wal_clear = (self.wal is None
                     or self.wal.gate_flush(release, mark))
        q_clear = (self.quorum is None
                   or self.quorum.gate_flush(release))
        return wal_clear and q_clear

    def sync_for_flush(self) -> None:
        if self.wal is not None:
            self.wal.sync_for_flush()
        if self.quorum is not None:
            self.quorum.sync_for_flush()


class _FollowerHandle:
    """The leader-side stand-in for one remote follower in the
    database's replica registry.  ``applied`` is what the follower has
    ACKED as mirrored (never merely shipped): the truncation floor must
    stay at or below every index a control-channel piggyback may still
    be asked to serve from — a follower whose event loop is momentarily
    blocked must not have the log truncated out from under its next
    RPC.  ``shipped`` tracks the push cursor separately."""

    def __init__(self, token: str):
        self.token = token
        self.applied = 0
        self.shipped = 0
        #: True for a non-voting observer mirror (README "Read
        #: plane"): its acks still gate the truncation floor (the
        #: piggyback must always be able to serve from its mirror's
        #: end) but never count toward the quorum-commit majority.
        self.observer = False
        self.writer: asyncio.StreamWriter | None = None


class ReplicationService:
    """Leader-process side.  Owns no sockets of the ZK protocol — it
    serves follower processes, not clients; run a normal ``ZKServer``
    on the same ``db`` for the leader *member*."""

    def __init__(self, db: ZKDatabase, host: str = '127.0.0.1',
                 port: int = 0, total: int = 1, collector=None,
                 quorum: bool | None = None):
        self.db = db
        self.host = host
        self.port = port
        #: Quorum-commit (the leader's ack barrier): ``total`` is the
        #: ENSEMBLE membership (this leader included), so a
        #: standalone service (total=1) carries a disabled gate — the
        #: leader is its own majority.
        self.quorum = QuorumGate(db, total, enabled=quorum,
                                 collector=collector)
        self._server: asyncio.base_events.Server | None = None
        self._handles: dict[str, _FollowerHandle] = {}
        #: every open follower transport, severed on stop(): since
        #: Python 3.12.1 wait_closed() also waits for client handlers,
        #: which would otherwise loop forever on live channels (the
        #: same hazard ZKServer.stop() sorts around)
        self._writers: set[asyncio.StreamWriter] = set()
        self._subscribed = False
        #: Optional seeded FaultInjector (io/faults.py): drops
        #: leader->follower pushes to simulate an asymmetric partition
        #: (the follower's control channel keeps flowing, so forwarded
        #: writes still land while the event stream starves — the
        #: piggyback/ack machinery is what must absorb the gap).
        self.faults = None
        #: Deterministic partition windows, by follower token: while a
        #: token is in this set, EVERY push to it drops (the
        #: campaign-scheduled form of the asymmetric partition; the
        #: injector's ``drop_push`` is the probabilistic form).  Heal
        #: by discarding the token — recovery rides the control
        #: channel's piggyback, same as the probabilistic path.
        self.partitioned: set[str] = set()
        #: Fencing latch (server/election.py): set once this service
        #: learns a higher leadership epoch exists — an RPC stamped
        #: with a newer epoch, or the election layer deposing it
        #: directly.  A deposed leader's forwarded writes bounce with
        #: a typed EPOCH_FENCED error instead of being applied to (and
        #: acked from) a history the quorum has moved past.
        self.deposed = False

    @property
    def epoch(self) -> int:
        return getattr(self.db, 'epoch', 0)

    def depose(self, epoch: int | None = None) -> None:
        """Fence this service: a newer leader exists.  Forwarded
        writes from here on bounce with EPOCH_FENCED."""
        self.deposed = True
        log.warning('replication service deposed (epoch %d%s)',
                    self.epoch,
                    '' if epoch is None else ' -> %d' % (epoch,))

    async def start(self) -> 'ReplicationService':
        self._server = await asyncio.start_server(
            self._on_follower, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        if not self._subscribed:
            self.db.on('committed', self._push_commits)
            self.db.on('sessionExpired', self._push_expiry)
            self._subscribed = True
        log.info('replication service on %s:%d', self.host, self.port)
        return self

    async def stop(self) -> None:
        self.quorum.close()
        if self._server is not None:
            self._server.close()
            for w in list(self._writers):
                try:
                    w.close()
                except (ConnectionError, RuntimeError):
                    pass
            await self._server.wait_closed()
            self._server = None

    # -- pushes (events channel) --

    def _entries_from(self, have: int) -> tuple[int, list]:
        db = self.db
        assert have >= db.log_base, (have, db.log_base)
        return have, db.log[have - db.log_base:]

    def _push(self, handle: _FollowerHandle, msg,
              data: bytes | None = None) -> None:
        if handle.writer is None:
            return
        # Only steady-state pushes partition: the attach/snapshot
        # barrier is the join handshake — a partitioned joiner in real
        # ZK fails its sync and retries from scratch, which here would
        # just re-run connect(); dropping the handshake models nothing
        # the refusal faults don't already, and would turn every
        # campaign restart into a 10 s attach timeout.
        droppable = msg[0] in ('commit', 'session_expired')
        if droppable and handle.token in self.partitioned:
            return                   # scheduled partition window
        if droppable and self.faults is not None and \
                self.faults.drop_push(handle.token):
            # Asymmetric partition: this push is lost.  For 'commit'
            # pushes the shipped cursor still advances in
            # _push_commits, exactly like bytes lost in the network —
            # recovery rides the control channel's piggyback (acks
            # gate the truncation floor, so no entry is lost).
            return
        try:
            handle.writer.write(data if data is not None
                                else _dump(msg))
        except (ConnectionError, RuntimeError):
            pass

    def _push_commits(self) -> None:
        trace = getattr(self.db, 'trace', None)
        self.quorum.note_pushed(self.db.zxid)
        #: per-cursor encode memo: steady-state mirrors share one
        #: shipped position, so a commit's push bytes are pickled
        #: ONCE however many followers/observers subscribe — the read
        #: plane makes wide mirror fleets normal, and a per-handle
        #: pickle would bill every write O(mirrors) serializations
        memo: dict[int, bytes] = {}
        for h in self._handles.values():
            base, entries = self._entries_from(h.shipped)
            if entries:
                data = memo.get(base)
                if data is None:
                    data = memo[base] = _dump(
                        ('commit', base, entries, self.epoch))
                self._push(h, ('commit', base, entries, self.epoch),
                           data=data)
                h.shipped = base + len(entries)
                if trace is not None:
                    # one push span per follower, keyed by the newest
                    # zxid shipped — the leader-side replication leg
                    # of the merged timeline
                    trace.note('REPL_PUSH',
                               zxid=entry_zxid(entries[-1]),
                               kind='server', batch=len(entries),
                               detail=h.token[:8])

    def _push_expiry(self, session_id: int) -> None:
        for h in self._handles.values():
            self._push(h, ('session_expired', session_id, self.epoch))

    # -- per-follower connections --

    async def _on_follower(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        self._writers.add(writer)
        try:
            await self._serve_follower(reader, writer)
        finally:
            self._writers.discard(writer)

    async def _serve_follower(self, reader: asyncio.StreamReader,
                              writer: asyncio.StreamWriter) -> None:
        try:
            hello = await _read_msg(reader)
        except (asyncio.IncompleteReadError, ConnectionError):
            writer.close()
            return
        kind, token = hello[0], hello[1]
        # a follower that recovered its tree from its own WAL
        # (server/persist.py) announces the zxid it holds; None for
        # fresh joiners and pre-durability hellos
        have_zxid = hello[2] if len(hello) > 2 else None
        # a non-voting observer stamps its hello (both channels):
        # its acks and forwarded writes must never help assemble a
        # quorum-commit majority
        is_observer = len(hello) > 3 and hello[3] == 'observer'
        if kind == 'events':
            h = self._handles.get(token)
            if h is None:
                h = _FollowerHandle(token)
                h.observer = is_observer
                h.writer = writer
                try:
                    self.db.attach_replica(h)
                except ValueError:
                    # a late joiner (a follower restarted — or first
                    # started — after history began).  A follower that
                    # recovered from disk rejoins with its recovered
                    # zxid as the catch-up base when the retained log
                    # still covers it — shipped only the tail, no
                    # image; otherwise (and for fresh joiners) it is
                    # bootstrapped from a snapshot, real ZK's follower
                    # resync.  The log before replication began was
                    # never retained; the tree image carries its
                    # effects.
                    pos = None
                    if have_zxid is not None:
                        pos = self.db.attach_replica_resync(
                            h, have_zxid)
                        if pos is not None:
                            h.applied = h.shipped = pos
                            self._push(h, ('resync', pos, self.epoch))
                            log.info(
                                'follower %s rejoined by WAL resync '
                                'at log index %d (recovered zxid %d, '
                                'leader zxid %d)', token, pos,
                                have_zxid, self.db.zxid)
                    if pos is None:
                        pos = self.db.attach_replica_at_tail(h)
                        h.applied = h.shipped = pos
                        # the image carries the SESSION TABLE too:
                        # session records before the bootstrap
                        # position were never retained, and a
                        # promoted ex-follower must not expire every
                        # client (store.py session_snapshot)
                        self._push(h, ('snapshot', self.db.snapshot(),
                                       pos, self.epoch,
                                       self.db.session_snapshot(),
                                       self.db.config_snapshot()))
                        log.info('follower %s joined late: snapshot '
                                 'at log index %d (zxid %d)', token,
                                 pos, self.db.zxid)
                self._handles[token] = h
            else:
                h.writer = writer
            # the follower's connect() blocks until this lands: a
            # commit racing the hello would otherwise slip between
            # "connected" and "attached" and never be logged.  The
            # membership config rides along: the zero-history attach
            # path ships no snapshot, and a follower must still
            # learn the ensemble shape it joined
            self._push(h, ('attached', self.epoch,
                           self.db.config_snapshot()))
            # ship anything committed before this follower connected
            self._push_commits()
            try:
                # the follower acks mirrored indices on this channel;
                # acks are what advance the truncation floor, and the
                # piggybacked (applied_zxid, epoch) pair is what
                # advances the quorum-commit floor
                while True:
                    msg = await _read_msg(reader)
                    if msg[0] == 'ack':
                        h.applied = max(h.applied, msg[1])
                        if len(msg) > 2 and not h.observer:
                            # observer acks advance the truncation
                            # floor (h.applied above) but never the
                            # quorum-commit majority
                            self.quorum.note_ack(
                                h.token, msg[2],
                                msg[3] if len(msg) > 3 else None)
            except (asyncio.IncompleteReadError, ConnectionError):
                pass                         # EOF = follower died
            finally:
                self._detach(h)
        elif kind == 'control':
            await self._serve_control(reader, writer, token,
                                      is_observer=is_observer)
        else:  # pragma: no cover - only this module speaks the protocol
            writer.close()

    def _detach(self, h: _FollowerHandle) -> None:
        self._handles.pop(h.token, None)
        self.quorum.forget(h.token)
        if h in self.db._replicas:
            self.db._replicas.remove(h)
        if h.writer is not None:
            h.writer.close()
            h.writer = None
        log.info('follower %s detached', h.token)

    async def _serve_control(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter,
                             token: str | None = None,
                             is_observer: bool = False) -> None:
        db = self.db
        try:
            while True:
                msg = await _read_msg(reader)
                op = msg[0]
                if op == 'touch':
                    sess = db.sessions.get(msg[1])
                    if sess is not None and not sess.expired \
                            and not sess.closed:
                        db.touch_session(sess)
                    continue
                assert op == 'rpc', op
                _, seq, method, args, have = msg[:5]
                rpc_epoch = msg[5] if len(msg) > 5 else None
                if rpc_epoch is not None and rpc_epoch > self.epoch:
                    # the caller has seen a newer leader than this
                    # service: it IS deposed, whatever it believed
                    self.depose(rpc_epoch)
                if (self.deposed or (rpc_epoch is not None
                                     and rpc_epoch < self.epoch)) \
                        and method in ('create', 'delete', 'set_data',
                                       'multi'):
                    # epoch fence: a deposed leader must not apply —
                    # or ack — a forwarded write, and a stale-epoch
                    # follower's write must bounce until it rejoins
                    # the current epoch.  Typed, never silent.
                    status, payload = 'err', 'EPOCH_FENCED'
                else:
                    pre_zxid = db.zxid
                    status, payload = self._dispatch(method, args)
                    if db.wal is not None:
                        # logged-before-ack across processes too: a
                        # forwarded write's RPC response is its ack
                        db.wal.sync_for_flush()
                    if status == 'ok' and db.zxid > pre_zxid \
                            and method in (
                            'create', 'delete', 'set_data', 'multi'):
                        # the zxid guard skips writes that committed
                        # nothing (a rejected multi reports per-op
                        # errors under status 'ok'; a check-only
                        # batch consumes no zxid) — they must not
                        # stall on unrelated in-flight writes' quorum
                        # quorum-before-ack: the response leaves only
                        # once a majority holds the txn.  The CALLING
                        # follower's vote is granted virtually — this
                        # very response's piggyback delivers the txn
                        # into its mirror before the client can see
                        # the ack (its loop is parked in the blocking
                        # RPC, so awaiting its real ack would
                        # deadlock).  An OBSERVER caller gets no
                        # virtual grant: its mirror is outside the
                        # voter set, so the majority must assemble
                        # from real voter acks alone.  Bounded:
                        # degrades like the send-plane gate.
                        await self.quorum.wait(
                            db.zxid,
                            grant=None if is_observer else token)
                base, entries = self._entries_from(have)
                writer.write(_dump(
                    ('res', seq, status, payload, base, entries,
                     self.epoch)))
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            writer.close()

    def _dispatch(self, method: str, args: tuple):
        db = self.db
        try:
            if method == 'create':
                path, data, acl, flags, sid = args
                return 'ok', db.create(path, data, acl,
                                       CreateFlag(flags),
                                       db.sessions.get(sid))
            if method == 'delete':
                db.delete(*args)
                return 'ok', None
            if method == 'set_data':
                return 'ok', db.set_data(*args)
            if method == 'multi':
                ops, sid = args
                return 'ok', db.multi(ops, db.sessions.get(sid))
            if method == 'create_session':
                sess = db.create_session(args[0])
                return 'ok', (sess.id, sess.passwd, sess.timeout)
            if method == 'resume_session':
                sess = db.resume_session(*args)
                if sess is None:
                    return 'ok', None
                return 'ok', (sess.id, sess.passwd, sess.timeout)
            if method == 'close_session':
                db.close_session(args[0])
                return 'ok', None
            if method == 'sync_barrier':
                return 'ok', None    # the piggybacked entries ARE the
                                     # barrier: up through db.log_end()
            return 'exc', 'unknown rpc %r' % (method,)
        except ZKOpError as e:
            return 'err', e.code
        except Exception as e:  # pragma: no cover - leader-side bug
            log.exception('rpc %s failed', method)
            return 'exc', repr(e)


class RemoteLeader(EventEmitter):
    """Follower-process side: the ``db``-shaped object a ``ZKServer``
    forwards leader operations through, plus the commit-log mirror its
    :class:`RemoteReplicaStore` replays.

    Emits ``committed`` (mirror grew) and ``sessionExpired(sid)`` —
    the two ``ZKDatabase`` events the server stack subscribes to."""

    def __init__(self, host: str, port: int,
                 have_zxid: int | None = None, epoch: int = 0,
                 observer: bool = False):
        super().__init__()
        self.host = host
        self.port = port
        #: Non-voting observer mirror (README "Read plane"): both
        #: hellos are stamped so the leader excludes this mirror's
        #: acks and forwarded writes from quorum-commit majorities.
        self.observer = observer
        #: newest mirror index actually ACKED to the leader: observer
        #: acks batch (see OBS_ACK_BATCH in :meth:`_ingest`)
        self._acked_sent = 0
        import uuid
        self._token = uuid.uuid4().hex
        #: the zxid this follower recovered from its own WAL
        #: (server/persist.py), announced in the events hello so the
        #: leader can ship only the tail instead of a snapshot
        self.have_zxid = have_zxid
        #: the newest leadership epoch this follower has accepted
        #: (recovered from its mirror WAL, then adopted upward from
        #: the stamp on every push / RPC response).  Pushes stamped
        #: with a LOWER epoch are rejected — the fencing half of
        #: server/election.py — and counted in ``stale_pushes``.
        self.epoch = epoch
        self.stale_pushes = 0
        #: invoked exactly once when the events channel dies without
        #: ``close()`` — the follower's leader-loss signal (push-
        #: channel EOF), what re-enters the election loop
        self.on_leader_lost = None
        self._lost_noted = False
        self._closing = False
        #: the commit-log mirror (never truncated: one local replica)
        self.log: list = []
        self.log_base = 0
        self.sessions: dict[int, ZKServerSession] = {}
        #: replicated membership config (store.py config_snapshot
        #: form): seeded by the bootstrap image, then maintained by
        #: the reconfig records the mirror replays — a promoted
        #: ex-follower inherits the config, including an in-progress
        #: joint window it must finish (server/election.py run_member)
        self.config: dict | None = None
        #: optional mirror write-ahead log: every entry that lands in
        #: the mirror is appended (durability for the follower's own
        #: restart; the member worker wires this, server/member_worker.py)
        self.wal = None
        #: set when the leader bootstrapped this (late-joining)
        #: follower from a snapshot: (image, absolute log index) that
        #: RemoteReplicaStore installs before replaying the tail
        self._snapshot: tuple[dict, int] | None = None
        #: set when the leader accepted ``have_zxid`` as the catch-up
        #: base ('resync'): the recovered tree stands, only the tail
        #: is shipped
        self.resynced = False
        self._sock: socket.socket | None = None
        self._lock = threading.Lock()
        #: serializes mirror growth: in the follower process both
        #: channels run on one event loop, but test harnesses (and any
        #: future off-loop caller) may drive the blocking control
        #: channel from another thread, and a racy double-append would
        #: shift every later batch's slice indices
        self._mirror_lock = threading.Lock()
        self._loop: asyncio.AbstractEventLoop | None = None
        self._seq = 0
        self._events_task: asyncio.Task | None = None
        #: kept referenced: a dropped StreamWriter closes its transport
        #: and the leader would see EOF and detach this follower
        self._events_writer: asyncio.StreamWriter | None = None

    @property
    def token(self) -> str:
        """This follower's channel-pairing token — the key the
        leader-side partition controls (``ReplicationService.
        partitioned``, ``FaultInjector.drop_push``) select it by."""
        return self._token

    # -- ReplicaStore's leader surface --

    def log_end(self) -> int:
        return self.log_base + len(self.log)

    def attach_replica(self, replica) -> None:
        # Any time is fine here, unlike ZKDatabase.attach_replica: a
        # replica either replays the never-truncated mirror from 0 or
        # installs the leader's snapshot and starts at log_base
        # (RemoteReplicaStore.__init__ picks per self._snapshot).
        pass

    async def connect(self) -> 'RemoteLeader':
        self._loop = asyncio.get_running_loop()
        # the control-channel dial can hang on a partitioned peer —
        # it must park an executor thread, not the loop every other
        # session of this member is served from (the loop-blocking
        # checker surfaced this one)
        # bounded dial: a leader partitioned right after election
        # must fail this connect within the attach window, not after
        # the kernel's multi-minute SYN retry — the election loop
        # needs the OSError promptly to try again
        self._sock = await self._loop.run_in_executor(
            None, socket.create_connection,
            (self.host, self.port), 10)
        self._sock.settimeout(None)     # RPCs keep blocking semantics
        role = 'observer' if self.observer else None
        self._sock.sendall(_dump(('control', self._token, None,
                                  role)))
        reader, writer = await asyncio.open_connection(
            self.host, self.port)
        writer.write(_dump(('events', self._token, self.have_zxid,
                            role)))
        await writer.drain()
        self._events_writer = writer
        self._attached = asyncio.get_running_loop().create_future()
        self._events_task = asyncio.get_running_loop().create_task(
            self._consume_events(reader))
        # barrier: until the leader confirms the attach (snapshot
        # included for a late joiner), a commit could race this
        # follower into a silent gap before its handle exists
        try:
            await asyncio.wait_for(self._attached, timeout=10)
        except BaseException:
            self.close()
            raise
        return self

    def close(self) -> None:
        self._closing = True
        if self._events_task is not None:
            self._events_task.cancel()
            self._events_task = None
        if self._events_writer is not None:
            self._events_writer.close()
            self._events_writer = None
        if self._sock is not None:
            self._sock.close()
            self._sock = None

    def _adopt_epoch(self, epoch: int | None) -> bool:
        """Adopt a push's epoch stamp.  Returns False when the push is
        STALE (stamped below the epoch this follower has already
        accepted) and must be rejected — the fencing rule that keeps a
        deposed leader's late pushes out of the mirror."""
        if epoch is None:
            return True
        if epoch < self.epoch:
            self.stale_pushes += 1
            log.warning('rejecting push from stale epoch %d '
                        '(accepted epoch is %d)', epoch, self.epoch)
            return False
        if epoch > self.epoch:
            with self._mirror_lock:
                if epoch > self.epoch:
                    self.epoch = epoch
                    if self.wal is not None:
                        # persist the fence — and fsync it, same rule
                        # as bump_epoch: a restarted follower must
                        # come back knowing the epoch it had
                        # accepted, or a stale leader could re-seed
                        # it.  Epoch changes are rare; the blocking
                        # sync never rides the per-push hot path.
                        self.wal.append(('epoch', epoch,
                                         self.wal.last_zxid))
                        self.wal.sync_for_flush()
        return True

    def _note_leader_lost(self) -> None:
        if self._lost_noted or self._closing:
            return
        self._lost_noted = True
        cb = self.on_leader_lost
        if cb is not None:
            try:
                cb()
            except Exception:  # pragma: no cover - observer bug
                log.exception('on_leader_lost callback failed')

    async def _consume_events(self, reader: asyncio.StreamReader):
        try:
            while True:
                msg = await _read_msg(reader)
                if msg[0] == 'commit':
                    if not self._adopt_epoch(
                            msg[3] if len(msg) > 3 else None):
                        continue       # fenced: a stale leader's push
                    self._ingest(msg[1], msg[2])
                    self.emit('committed')
                elif msg[0] == 'session_expired':
                    self._adopt_epoch(msg[2] if len(msg) > 2 else None)
                    sess = self.sessions.get(msg[1])
                    if sess is not None:
                        sess.expired = True
                    self.emit('sessionExpired', msg[1])
                elif msg[0] == 'snapshot':
                    # always precedes 'attached' on this ordered
                    # socket; the mirror starts at the image's index
                    self._adopt_epoch(msg[3] if len(msg) > 3 else None)
                    with self._mirror_lock:
                        assert not self.log, 'snapshot after entries'
                        self._snapshot = (msg[1], msg[2])
                        self.log_base = msg[2]
                    self.seed_sessions(msg[4] if len(msg) > 4 else {})
                    if len(msg) > 5 and msg[5] is not None:
                        self.config = dict(msg[5])
                elif msg[0] == 'resync':
                    # the leader accepted have_zxid as the catch-up
                    # base: no image — the recovered tree stands and
                    # the mirror starts at the leader's matching index
                    self._adopt_epoch(msg[2] if len(msg) > 2 else None)
                    with self._mirror_lock:
                        assert not self.log, 'resync after entries'
                        self.resynced = True
                        self.log_base = msg[1]
                elif msg[0] == 'attached':
                    self._adopt_epoch(msg[1] if len(msg) > 1 else None)
                    if len(msg) > 2 and msg[2] is not None \
                            and self.config is None:
                        # don't regress a config a later reconfig
                        # record already advanced past this
                        # handshake's stamp
                        self.config = dict(msg[2])
                    if not self._attached.done():
                        self._attached.set_result(True)
        except asyncio.CancelledError:
            pass
        except (asyncio.IncompleteReadError, ConnectionError):
            # push-channel EOF: the leader died (or severed us) — the
            # follower's election trigger (server/election.py)
            self._note_leader_lost()

    def _ingest(self, base: int, entries: list) -> None:
        """Merge a batch of log entries starting at absolute index
        ``base`` into the mirror (entries can arrive on both channels;
        overlap is dropped under the mirror lock, gaps are impossible
        on ordered sockets from one leader loop).  Growth is acked to
        the leader — acks, not shipments, advance its truncation
        floor, so the control channel's piggyback can always serve
        from this mirror's end."""
        with self._mirror_lock:
            end = self.log_end()
            if base > end:
                # a gap: an earlier push was dropped — a scheduled
                # partition window or a stale-epoch rejection
                # (_adopt_epoch).  A gapped batch cannot be merged;
                # recovery rides the control channel's piggyback,
                # which always serves from this mirror's end.
                return
            tail = entries[end - base:]
            if tail:
                self.log.extend(tail)
                if self.wal is not None:
                    # mirror durability: the follower's own WAL logs
                    # what it has mirrored, so a SIGKILLed follower
                    # restarts from disk and rejoins with have_zxid
                    # (in the worker both channels share one loop, so
                    # appends are loop-serialized like the leader's)
                    for e in tail:
                        self.wal.append(e)
            acked = self.log_end()
            acked_zxid = entry_zxid(self.log[-1]) if self.log else 0
        if tail and self.observer \
                and acked - self._acked_sent < self.OBS_ACK_BATCH:
            # observer acks gate ONLY the leader's log-truncation
            # floor (never a quorum), so they batch: one ack per
            # OBS_ACK_BATCH ingested entries instead of one per
            # commit — at read-plane fleet widths, per-commit acks
            # from every observer made the leader process O(mirrors)
            # messages per write.  The retained-log cost is bounded
            # (< OBS_ACK_BATCH entries per observer).
            return
        if tail and self._events_writer is not None:
            self._acked_sent = acked
            # the ack rides the events transport, which belongs to the
            # loop: schedule the write there when called off-loop.
            # The piggybacked (applied_zxid, epoch) pair is the
            # quorum-commit vote: the leader's ack barrier releases
            # once a majority of mirrors has ingested the txn, and an
            # ack stamped with a stale epoch is fenced out.
            data = _dump(('ack', acked, acked_zxid, self.epoch))

            def send():
                try:
                    self._events_writer.write(data)
                except (AttributeError, ConnectionError, RuntimeError):
                    pass                  # closed mid-shutdown
            try:
                on_loop = asyncio.get_running_loop() is self._loop
            except RuntimeError:
                on_loop = False           # no loop on this thread
            if on_loop:
                send()
            elif self._loop is not None:
                try:
                    self._loop.call_soon_threadsafe(send)
                except RuntimeError:
                    pass                  # loop closed


    # -- control-channel RPC --

    def _rpc(self, method: str, *args):
        try:
            with self._lock:
                if self._sock is None:
                    raise ZKLeaderLostError('not connected')
                self._seq += 1
                seq = self._seq
                self._sock.sendall(_dump(
                    ('rpc', seq, method, args, self.log_end(),
                     self.epoch)))
                res = _recv_msg(self._sock)
        except (ConnectionError, OSError) as e:
            # the leader process died (or the OS severed the control
            # channel) with this RPC in flight: its outcome is
            # unknown.  Surface the typed, outcome-unknown error the
            # client-side ambiguity accounting classifies — never a
            # raw EOF that tears the serving connection down.
            self._note_leader_lost()
            raise ZKLeaderLostError(str(e)) from e
        tag, rseq, status, payload, base, entries = res[:6]
        assert tag == 'res' and rseq == seq, res
        self._adopt_epoch(res[6] if len(res) > 6 else None)
        self._ingest(base, entries)
        if entries:
            self.emit('committed')
        if status == 'err':
            raise ZKOpError(payload)
        if status == 'exc':
            raise RuntimeError('leader rpc failed: %s' % (payload,))
        return payload

    # -- the ZKDatabase surface ServerConnection uses --

    def create(self, path, data, acl, flags, session=None):
        sid = session.id if session is not None else 0
        return self._rpc('create', path, data, acl, int(flags), sid)

    def delete(self, path, version):
        return self._rpc('delete', path, version)

    def set_data(self, path, data, version):
        return self._rpc('set_data', path, data, version)

    def multi(self, ops, session=None):
        """Forward one all-or-nothing MULTI batch; the leader applies
        it as ONE transaction (store.py ``ZKDatabase.multi``) and the
        RPC piggyback delivers the whole ('multi', subs) entry into
        this mirror before the ack, like any forwarded write."""
        sid = session.id if session is not None else 0
        return self._rpc('multi', list(ops), sid)

    def sync_barrier(self) -> None:
        """Round-trip to the leader; on return the mirror holds every
        transaction the leader had committed when the RPC arrived."""
        self._rpc('sync_barrier')

    def seed_sessions(self, table: dict) -> None:
        """Seed the mirror's session table from a durable form
        (``{sid: (passwd, timeout)}``): the leader's bootstrap image,
        or this member's own recovered table on rejoin.  Existing
        handles win — they may already carry lifecycle state."""
        for sid, (passwd, timeout) in table.items():
            if sid not in self.sessions:
                self.sessions[sid] = ZKServerSession(
                    id=sid, passwd=passwd, timeout=timeout)

    def session_snapshot(self) -> dict:
        """The mirror's session table in durable form — what a
        promoted ex-follower seats into its new leader database."""
        return durable_sessions(self.sessions)

    def _session(self, sid: int, passwd: bytes,
                 timeout: int) -> ZKServerSession:
        sess = self.sessions.get(sid)
        if sess is None:
            sess = self.sessions[sid] = ZKServerSession(
                id=sid, passwd=passwd, timeout=timeout)
        return sess

    def create_session(self, timeout: int) -> ZKServerSession:
        sid, passwd, timeout = self._rpc('create_session', timeout)
        return self._session(sid, passwd, timeout)

    def resume_session(self, session_id: int,
                       passwd: bytes) -> ZKServerSession | None:
        res = self._rpc('resume_session', session_id, passwd)
        if res is None:
            return None
        return self._session(*res)

    #: Floor on the touch-forward interval, seconds: even a tiny
    #: session timeout must not turn every served request into a
    #: leader RPC.
    TOUCH_MIN_S = 0.1

    #: Observer ack batching (:meth:`_ingest`): one truncation-floor
    #: ack per this many ingested entries.  Voting followers always
    #: ack per batch — their piggybacked zxid IS the quorum vote.
    OBS_ACK_BATCH = 64

    def touch_session(self, sess: ZKServerSession) -> None:
        # Fire-and-forget (expiry timers live in the leader process)
        # and RATE-LIMITED to a quarter of the session timeout — real
        # ZK's learner forwards session activity at ping cadence, not
        # per request.  Without the limit, every read served by a
        # follower/observer costs the leader one control-channel
        # message plus an expiry-timer reset: at read-plane scale the
        # leader becomes the READ path's bottleneck even though it
        # serves none of the reads.
        now = time.monotonic()
        if now - sess.last_touch_fwd < max(
                self.TOUCH_MIN_S, sess.timeout / 4000.0):
            return
        sess.last_touch_fwd = now
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.sendall(_dump(('touch', sess.id)))
                except (ConnectionError, OSError):
                    self._note_leader_lost()

    def close_session(self, session_id: int) -> None:
        self._rpc('close_session', session_id)
        sess = self.sessions.get(session_id)
        if sess is not None:
            sess.closed = True


class RemoteReplicaStore(ReplicaStore):
    """A follower's replica over a :class:`RemoteLeader` mirror.  Two
    semantic differences from the in-process replica:

    - a late joiner installs the leader's snapshot and replays only
      the tail (the mirror's ``log_base`` is the image's index);
    - the SYNC op's barrier must first *fetch* — everything the
      leader has committed is the sync point, not everything the
      mirror happens to hold.  Plain ``catch_up`` (the
      read-your-own-write step after a forwarded write) stays local:
      the write RPC's piggyback already delivered the mirror through
      the write, and a second blocking round-trip per write would
      stall the member's whole event loop."""

    #: Optional hook fired with each reconfig record's config dict as
    #: it applies — run_member repoints this follower's election
    #: total from it, so a later ballot counts quorums against the
    #: membership the leader last committed, not the spawn shape.
    on_config_applied = None

    def _apply_session(self, entry: tuple) -> None:
        """Session control records replicate the leader's session
        table into THIS follower's mirror handle — what keeps every
        session alive across an OS-process leader failover: the
        promoted member seats ``leader.sessions`` into its new
        database instead of expiring every client."""
        sessions = self.leader.sessions
        if entry[0] == 'session':
            _, sid, passwd, timeout, _zxid = entry
            if sid not in sessions:
                sessions[sid] = ZKServerSession(
                    id=sid, passwd=passwd, timeout=timeout)
        else:
            sess = sessions.get(entry[1])
            if sess is not None:
                if entry[3] == 'expire':
                    sess.expired = True
                else:
                    sess.closed = True

    def _apply_reconfig(self, entry: tuple) -> None:
        """Reconfig control records replicate the leader's membership
        config into THIS follower's mirror handle — a promoted member
        inherits it, joint window included (the run_member lead path
        finishes an in-progress reconfig it recovers this way)."""
        _, ver, phase, old_v, new_v, obs, _zxid = entry
        cfg = {
            'version': ver, 'phase': phase, 'voters': tuple(new_v),
            'old_voters': (tuple(old_v) if phase == 'joint'
                           else None),
            'observers': tuple(obs)}
        self.leader.config = cfg
        hook = self.on_config_applied
        if hook is not None:
            hook(cfg)

    def __init__(self, leader: RemoteLeader, lag: float | None = 0.0,
                 recovered: dict | None = None):
        super().__init__(leader, lag=lag)
        if leader._snapshot is not None:
            snap, pos = leader._snapshot
            leader._snapshot = None     # release the image: installed
            self.install(snap)          # state must not be pinned (or
            self.applied = pos          # re-installed) afterwards
        elif recovered is not None and leader.resynced:
            # restart-from-disk: the tree recovered from this
            # follower's own WAL is the catch-up base — the leader
            # shipped no image, only the tail past recovered['zxid']
            self.install(recovered)
            self.applied = leader.log_base
        if self.lag is not None and self.lag <= 0:
            # entries can land in the mirror between the snapshot (or
            # plain attach) and this construction; _on_commit only
            # fires on FUTURE pushes, so apply the backlog now or a
            # lag=0 replica could serve stale reads until the next
            # unrelated write
            self.catch_up()

    def sync_flush(self) -> None:
        self.leader.sync_barrier()
        self.catch_up()
