"""The in-process ZooKeeper server's data model.

The reference tests against a real ZooKeeper JVM spawned as a child
process (reference: test/zkserver.js) — unavailable here, so this module
implements the server-side semantics the client exercises: the znode
tree with full Stat bookkeeping, zxid allocation, session lifecycle with
expiry timers and ephemeral cleanup, sequential-node numbering, and
change events that per-connection watch tables subscribe to.

Replication model (the quorum analogue): one ``ZKDatabase`` is the
**leader** — it validates and sequences every write, allocates zxids,
and appends each committed transaction to an in-order commit log.  Each
ensemble follower serves reads from its own ``ReplicaStore``, a separate
znode tree fed by that log with injectable lag — so a follower can be
*behind* the leader and serve a genuinely stale read, which is what
gives the client's ``sync`` op observable meaning (reference semantics:
test/multi-node.test.js:107-165 — a follower may lag until sync).
Sessions stay leader-global (in real ZK they are quorum state tracked
by the leader), so a session survives its serving member dying as long
as the client resumes it anywhere within the timeout, and ephemeral
cleanup is itself a sequence of logged deletes that replicate like any
other write.

Both leader and replicas mutate their trees through the shared
``NodeTree._apply_*`` primitives, so a replayed transaction produces a
byte-identical Stat on every member.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import secrets
import threading
import time

from ..protocol.consts import CreateFlag
from ..protocol.records import ACL, OPEN_ACL_UNSAFE, Stat
# entry_zxid rides the traced commit/apply hot paths; persist.py
# imports this module only lazily, so the top-level import is safe
from .persist import entry_zxid
from ..utils.events import EventEmitter
from ..utils.aio import ambient_loop

log = logging.getLogger('zkstream_tpu_torch.server.store')


class ZKOpError(Exception):
    """A server-side operation failure, named by protocol error code."""

    def __init__(self, code: str):
        super().__init__(code)
        self.code = code


@dataclasses.dataclass
class Znode:
    data: bytes = b''
    acl: tuple = OPEN_ACL_UNSAFE
    czxid: int = 0
    mzxid: int = 0
    pzxid: int = 0
    ctime: int = 0
    mtime: int = 0
    version: int = 0
    cversion: int = 0
    aversion: int = 0
    ephemeral_owner: int = 0
    children: set = dataclasses.field(default_factory=set)
    #: Monotonic sequential-suffix counter (real ZK derives this from
    #: cversion; an explicit counter keeps numbering stable across
    #: deletes).  Leader-only: sequential names are resolved before a
    #: create is logged, so replicas never consult it.
    seq: int = 0

    def stat(self) -> Stat:
        return Stat(czxid=self.czxid, mzxid=self.mzxid, ctime=self.ctime,
                    mtime=self.mtime, version=self.version,
                    cversion=self.cversion, aversion=self.aversion,
                    ephemeralOwner=self.ephemeral_owner,
                    dataLength=len(self.data),
                    numChildren=len(self.children), pzxid=self.pzxid)


@dataclasses.dataclass
class ZKServerSession:
    id: int
    passwd: bytes
    timeout: int
    ephemerals: set = dataclasses.field(default_factory=set)
    expired: bool = False
    closed: bool = False
    #: The server connection currently serving this session, if any.
    owner: object = None
    expiry_handle: asyncio.TimerHandle | None = None
    #: The newest member zxid this session has provably observed — the
    #: max of every reply header it was sent plus the ``lastZxidSeen``
    #: it presented at each handshake.  The zxid read gate
    #: (server/server.py ReadGate) refuses to serve this session's
    #: reads from a member behind this floor: the session view must
    #: never go backwards (analysis/linearize.py check_session_reads).
    #: In-process ensembles share the session OBJECT across members,
    #: so the floor survives migration by construction; cross-process
    #: members learn it from the handshake.
    last_zxid: int = 0
    #: When this member last FORWARDED a touch for this session to
    #: its leader (monotonic seconds; cross-process members only).
    #: Touch forwarding is rate-limited to a fraction of the session
    #: timeout — real ZK's learner ping cadence — because a
    #: per-request touch RPC would make the leader the read plane's
    #: bottleneck (server/replication.py RemoteLeader.touch_session).
    last_touch_fwd: float = 0.0


def parent_path(path: str) -> str:
    idx = path.rfind('/')
    return path[:idx] if idx > 0 else '/'


def validate_path(path: str) -> None:
    if not path.startswith('/'):
        raise ZKOpError('BAD_ARGUMENTS')
    if path != '/' and path.endswith('/'):
        raise ZKOpError('BAD_ARGUMENTS')
    if '//' in path:
        raise ZKOpError('BAD_ARGUMENTS')


def durable_sessions(sessions: dict) -> dict:
    """A session table's durable form — the ONE definition of what a
    format-3 snapshot stamps, a mirror seeds and a promotion seats
    (server/persist.py, server/replication.py):
    ``{sid: (passwd, timeout)}``, live sessions only."""
    return {sid: (s.passwd, s.timeout) for sid, s in sessions.items()
            if not s.expired and not s.closed}


def _copy_znode(node: 'Znode | None') -> 'Znode | None':
    """A rollback-grade copy: every scalar field plus a fresh children
    set (data bytes and the ACL tuple are immutable and may alias)."""
    if node is None:
        return None
    return dataclasses.replace(node, children=set(node.children))


class NodeTree(EventEmitter):
    """A znode tree plus the deterministic transaction-apply primitives
    shared by the leader and every replica — one code path mutates all
    members' trees, so replayed state cannot drift.

    Change events (for per-connection watch tables):
    ``created(path, zxid)``, ``deleted(path, zxid)``,
    ``dataChanged(path, zxid)``, ``childrenChanged(path, zxid)``.
    ``zxid`` is the last transaction applied to THIS tree (== the
    leader's on a caught-up member, behind it on a lagging one).
    """

    #: Optional utils/trace.TraceRing — the owning member's span ring
    #: (server/server.py wires it): the leader database records a
    #: ``COMMIT`` span per txn, a replica an ``APPLY`` span per
    #: replayed entry, so a write's cross-member path is traceable by
    #: zxid.  Class-level None keeps the no-tracing hot path a single
    #: attribute test.
    trace = None

    #: When set (``ZKDatabase.multi``), change events buffer here
    #: instead of dispatching: a speculative multi apply must not fire
    #: watches it may roll back.  Class-level None keeps the normal
    #: emit path a single attribute test.
    _event_buf = None

    def __init__(self) -> None:
        super().__init__()
        self.nodes: dict[str, Znode] = {'/': Znode()}
        self.zxid = 0

    def emit(self, event: str, *args) -> None:
        buf = self._event_buf
        if buf is not None:
            buf.append((event, args))
            return
        super().emit(event, *args)

    # -- snapshot (late-joining replica bootstrap) --

    def snapshot(self) -> dict:
        """An image of the tree and its position — what a late-joining
        replica installs before replaying the log tail (real ZK's
        follower resync; server/replication.py).  The image ALIASES the
        live tree: the one caller pickles it onto the wire in the same
        synchronous tick, so a defensive deep copy would only duplicate
        an arbitrarily large tree for nothing.  An in-process consumer
        that intends to retain it must copy it itself."""
        return {'zxid': self.zxid, 'nodes': self.nodes}

    def install(self, snap: dict) -> None:
        """Replace this tree with a snapshot image.  The image is
        adopted, not copied — it arrives freshly unpickled from the
        replication socket (or a WAL snapshot file, server/persist.py)
        and is private to this replica."""
        self.nodes = snap['nodes']
        self.zxid = snap['zxid']

    # -- transaction apply (leader commit path + replica replay) --

    def apply_entry(self, entry: tuple) -> None:
        """Apply one self-contained commit-log entry to this tree —
        the single replay dispatch shared by replica catch-up
        (:class:`ReplicaStore`) and WAL recovery (server/persist.py),
        so a replayed transaction produces a byte-identical Stat on
        every member *and* after a restart from disk."""
        op = entry[0]
        if op == 'create':
            _, path, data, acl, eph_owner, zxid, now = entry
            self._apply_create(path, data, acl, eph_owner, zxid, now)
        elif op == 'delete':
            self._apply_delete(entry[1], entry[2])
        elif op == 'set_data':
            _, path, data, zxid, now = entry
            self._apply_set_data(path, data, zxid, now)
        elif op == 'multi':
            # ONE all-or-nothing transaction: the subs apply in order,
            # guarded by zxid so a replay over a fuzzy image (WAL
            # recovery) skips the prefix the image already holds —
            # a torn multi RECORD never reaches here at all (the CRC
            # frame covers the whole batch, server/persist.py)
            for sub in entry[1]:
                if entry_zxid(sub) > self.zxid:
                    self.apply_entry(sub)
        elif op in ('session', 'session_close'):
            # session control records ride the commit log (a follower
            # mirror must carry the table for failover) but never
            # touch the tree
            self._apply_session(entry)
        elif op == 'reconfig':
            # membership control record: rides the commit log so every
            # mirror carries the config for failover, consumes a zxid
            # (the joint window is bounded by sequenced records), but
            # never touches the tree
            self.zxid = max(self.zxid, entry[6])
            self._apply_reconfig(entry)
        else:  # pragma: no cover - log entries are produced above
            raise AssertionError('unknown log entry %r' % (op,))

    def _apply_session(self, entry: tuple) -> None:
        """Session-record hook.  A plain tree (WAL recovery target)
        and an in-process replica (the shared leader database already
        owns the table) ignore them; the cross-process mirror's
        replica overrides this to maintain its leader-handle table
        (server/replication.py RemoteReplicaStore)."""

    def _apply_reconfig(self, entry: tuple) -> None:
        """Reconfig-record hook, same shape as :meth:`_apply_session`:
        ignored by a plain tree and an in-process replica (the shared
        leader database owns the config); the cross-process mirror's
        replica overrides it so a promoted follower inherits the
        membership config — including an in-progress joint window —
        from its replicated log (server/replication.py)."""

    def _apply_create(self, path: str, data: bytes, acl: tuple,
                      ephemeral_owner: int, zxid: int, now: int) -> None:
        node = Znode(data=data, acl=acl, czxid=zxid, mzxid=zxid,
                     pzxid=zxid, ctime=now, mtime=now,
                     ephemeral_owner=ephemeral_owner)
        self.nodes[path] = node
        ppath = parent_path(path)
        parent = self.nodes[ppath]
        parent.children.add(path.rsplit('/', 1)[1])
        parent.cversion += 1
        parent.pzxid = zxid
        self.zxid = zxid
        self.emit('created', path, zxid)
        self.emit('childrenChanged', ppath, zxid)

    def _apply_delete(self, path: str, zxid: int) -> Znode:
        node = self.nodes.pop(path)
        ppath = parent_path(path)
        parent = self.nodes.get(ppath)
        if parent is not None:
            parent.children.discard(path.rsplit('/', 1)[1])
            parent.cversion += 1
            parent.pzxid = zxid
        self.zxid = zxid
        self.emit('deleted', path, zxid)
        self.emit('childrenChanged', ppath, zxid)
        return node

    def _apply_set_data(self, path: str, data: bytes, zxid: int,
                        now: int) -> Znode:
        node = self.nodes[path]
        node.data = data
        node.version += 1
        node.mzxid = zxid
        node.mtime = now
        self.zxid = zxid
        self.emit('dataChanged', path, zxid)
        return node

    # -- reads (serve from this member's view) --

    def get_data(self, path: str) -> tuple[bytes, Stat]:
        node = self.nodes.get(path)
        if node is None:
            raise ZKOpError('NO_NODE')
        return node.data, node.stat()

    def exists(self, path: str) -> Stat:
        node = self.nodes.get(path)
        if node is None:
            raise ZKOpError('NO_NODE')
        return node.stat()

    def get_children(self, path: str) -> tuple[list[str], Stat]:
        node = self.nodes.get(path)
        if node is None:
            raise ZKOpError('NO_NODE')
        return sorted(node.children), node.stat()

    def get_acl(self, path: str) -> tuple[list[ACL], Stat]:
        node = self.nodes.get(path)
        if node is None:
            raise ZKOpError('NO_NODE')
        return list(node.acl), node.stat()


class ZKDatabase(NodeTree):
    """The leader: validates and sequences writes, allocates zxids,
    owns the session table, and appends every committed transaction to
    ``log`` (emitting ``committed`` for replicas to consume).

    Extra events beyond :class:`NodeTree`'s:
    ``sessionExpired(session_id)``, ``committed()``.
    """

    def __init__(self) -> None:
        super().__init__()
        self.sessions: dict[int, ZKServerSession] = {}
        #: Leadership epoch (server/election.py): a fencing token, not
        #: a zxid component.  0 until the first election; bumped by the
        #: winning member (``bump_epoch``), persisted as a WAL control
        #: record so a restart recovers it, stamped on every
        #: replication push and forwarded-write ack so stale-epoch
        #: traffic is rejectable instead of silently merged.
        self.epoch = 0
        #: The commit log: every mutation, in zxid order, as a
        #: self-contained entry a :class:`ReplicaStore` can replay.
        #: Only kept once a replica attaches — a standalone server
        #: must not retain every payload for the process lifetime —
        #: and truncated as all replicas apply (``log[0]`` is absolute
        #: index ``log_base``), so a long-running ensemble does not
        #: grow memory without bound either.
        self.log: list[tuple] = []
        self.log_base = 0
        #: The zxid the retained log is contiguous *after*: every txn
        #: with zxid > log_start_zxid is in ``log``.  Maintained so a
        #: follower recovering from its own WAL (server/persist.py)
        #: can rejoin with its recovered zxid as the catch-up base —
        #: shipped only the tail — instead of a full snapshot fetch.
        self.log_start_zxid = 0
        #: Optional write-ahead log (server/persist.py): when set,
        #: ``_commit`` appends every txn BEFORE its ack can leave.
        self.wal = None
        #: While a MULTI is applying, committed sub-entries collect
        #: here instead of reaching the WAL/log — on success the whole
        #: batch commits as ONE ('multi', subs) record sharing one
        #: group-fsync slot; on failure it rolls back untraced.
        self._multi_buf: list | None = None
        #: MULTI counters (mntr rows zk_multi_*).
        self.multi_batches = 0
        self.multi_subops = 0
        self._replicas: list['ReplicaStore'] = []
        #: Dynamic membership (reconfig control records).  ``None``
        #: voter_ids = never configured: the boot-time shape stands
        #: and quorum math stays count-based (the legacy path, bit-
        #: identical to pre-reconfig behavior).  During a joint window
        #: ``old_voter_ids`` holds C_old — quorum-commit and elections
        #: need majorities of BOTH sets until the final record commits.
        self.config_version = 0
        self.voter_ids: tuple | None = None
        self.old_voter_ids: tuple | None = None
        self.observer_ids: tuple = ()
        #: completed membership changes (mntr zk_reconfig_total)
        self.reconfig_total = 0
        #: epoch of the last completed VOTER change — the at-most-one-
        #: membership-change-per-epoch guard (invariant 7 extension)
        self.reconfig_epoch = -1
        #: hook called with (phase, entry) after each reconfig record
        #: commits — the owner (ZKEnsemble / run_member) repoints the
        #: QuorumGate voter sets, election tallies and client resolver
        self.on_config_change = None
        # Like real ZK's (timestamp << 24) seed, masked into int64 range.
        self._next_session = ((int(time.time() * 1000) << 24)
                              & 0x7fffffffffff0000)

    # -- zxid / time --

    def next_zxid(self) -> int:
        self.zxid += 1
        return self.zxid

    @staticmethod
    def now_ms() -> int:
        return int(time.time() * 1000)

    def catch_up(self) -> None:
        """The leader is always caught up (uniform member interface)."""

    def sync_flush(self) -> None:
        """The SYNC op's barrier — trivial on the leader."""

    def bump_epoch(self, epoch: int) -> None:
        """Adopt a new leadership epoch (the winning member of an
        election calls this before serving a single write).  The bump
        is a WAL *control* record — logged and fsynced like a txn so a
        restarted member recovers the epoch it was fenced at — but it
        never enters the replication ``log``: replicas learn epochs
        from the stamp on every push, and control records must not
        shift the log's index arithmetic."""
        if epoch <= self.epoch:
            raise ValueError('epoch must increase: %d -> %d'
                             % (self.epoch, epoch))
        self.epoch = epoch
        if self.wal is not None:
            self.wal.append(('epoch', epoch, self.zxid))
            # the fence must be durable before it can be trusted: a
            # deposed-then-restarted leader that lost the bump would
            # come back believing its stale epoch
            self.wal.sync_for_flush()

    # -- dynamic membership (reconfig control records) --

    def install_config(self, cfg: dict) -> None:
        """Adopt a membership config wholesale — the boot-time shape
        (ZKEnsemble), a WAL-recovered one (server/persist.py), or a
        promoted mirror's replicated one (server/replication.py)."""
        self.config_version = cfg.get('version', 0)
        voters = cfg.get('voters')
        self.voter_ids = tuple(voters) if voters is not None else None
        old = cfg.get('old_voters')
        self.old_voter_ids = tuple(old) if old else None
        self.observer_ids = tuple(cfg.get('observers') or ())

    def config_snapshot(self) -> dict | None:
        """The membership config in its durable form — what a format-3
        snapshot stamps and recovery adopts (server/persist.py); None
        until the ensemble is configured (legacy images stay
        byte-compatible)."""
        if self.voter_ids is None:
            return None
        return {'version': self.config_version,
                'phase': ('joint' if self.old_voter_ids is not None
                          else 'final'),
                'voters': self.voter_ids,
                'old_voters': self.old_voter_ids,
                'observers': self.observer_ids}

    def joint_config(self) -> tuple | None:
        """(C_old, C_new) while a joint window stands, else None."""
        if self.old_voter_ids is None:
            return None
        return (self.old_voter_ids, self.voter_ids)

    def propose_reconfig(self, new_voters, observers=None) -> tuple:
        """Begin a membership change: commit the phase-'joint' WAL
        CONTROL record installing C_old+C_new.  From this record's
        commit until :meth:`commit_reconfig`'s final record, quorum
        commit and elections must hold majorities of BOTH voter sets
        (server/replication.py QuorumGate, server/election.py).  An
        observer-only change (voter set unchanged) has no quorum
        implications and commits a single 'final' record directly.
        Returns the committed entry."""
        if self.voter_ids is None:
            raise ValueError('ensemble has no installed config')
        if self.old_voter_ids is not None:
            raise ValueError(
                'reconfig already in progress (config version %d is '
                'joint)' % (self.config_version,))
        new_voters = tuple(new_voters)
        observers = (tuple(observers) if observers is not None
                     else self.observer_ids)
        voters_change = set(new_voters) != set(self.voter_ids)
        if voters_change and self.reconfig_epoch == self.epoch:
            # at most one voter-set change per epoch (invariant 7
            # extension): a second change must wait for an epoch bump
            raise ValueError(
                'voter set already changed in epoch %d'
                % (self.epoch,))
        if voters_change and not new_voters:
            raise ValueError('cannot reconfig to an empty voter set')
        old = self.voter_ids
        phase = 'joint' if voters_change else 'final'
        if self.trace is not None:
            self.trace.note('RECONFIG', zxid=self.zxid, kind='server',
                            detail='propose v%d %s'
                            % (self.config_version + 1, phase))
        self.config_version += 1
        if voters_change:
            self.old_voter_ids = old
        self.voter_ids = new_voters
        self.observer_ids = observers
        zxid = self.next_zxid()
        entry = ('reconfig', self.config_version, phase,
                 tuple(old) if voters_change else (), new_voters,
                 observers, zxid)
        # the config governs from APPEND, not commit (joint
        # consensus): the hook re-derives the quorum/ballot sets
        # BEFORE the record commits, so the joint record itself must
        # clear majorities of both configs — and a just-promoted
        # voter's ack of this very record is counted, not fenced
        hook = self.on_config_change
        if hook is not None:
            hook(phase, entry)
        self._commit(entry)
        if self.trace is not None:
            self.trace.note('RECONFIG', zxid=zxid, kind='server',
                            detail='%s v%d voters=%s'
                            % (phase, self.config_version,
                               ','.join(map(str, new_voters))))
        if not voters_change:
            self.reconfig_total += 1
        return entry

    def commit_reconfig(self) -> tuple:
        """Close the joint window: commit the phase-'final' record —
        C_new alone governs from here, and removed members can neither
        ack a quorum nor win a ballot.  A leader promoted over a WAL
        holding an in-progress joint record calls this to finish the
        interrupted reconfig (server/election.py run_member)."""
        if self.old_voter_ids is None:
            raise ValueError('no reconfig in progress')
        self.old_voter_ids = None
        self.config_version += 1
        zxid = self.next_zxid()
        entry = ('reconfig', self.config_version, 'final', (),
                 self.voter_ids, self.observer_ids, zxid)
        # same append-time rule as propose_reconfig: C_new alone
        # governs the final record's own commit
        hook = self.on_config_change
        if hook is not None:
            hook('final', entry)
        self._commit(entry)
        self.reconfig_total += 1
        self.reconfig_epoch = self.epoch
        if self.trace is not None:
            self.trace.note('RECONFIG', zxid=zxid, kind='server',
                            detail='commit v%d voters=%s'
                            % (self.config_version,
                               ','.join(map(str, self.voter_ids))))
        return entry

    def attach_replica_at_tail(self, replica) -> int:
        """Attach a replica that is bootstrapped from a snapshot (the
        cross-process late join, server/replication.py): it needs no
        history before the current log tail — the tree image carries
        the effects of everything already committed, including
        transactions from before replication began that were never
        logged — so unlike :meth:`attach_replica` it may join at any
        time.  Returns the absolute log index the snapshot is current
        through (the joiner's starting ``applied``)."""
        if not self._replicas and not self.log:
            # the log starts recording at this attach: it is
            # contiguous only after the current position
            self.log_start_zxid = self.zxid
        self._replicas.append(replica)
        return self.log_end()

    def attach_replica_resync(self, replica, have_zxid: int
                              ) -> int | None:
        """Attach a follower that recovered its tree from disk at
        ``have_zxid`` (server/persist.py): when the retained log still
        covers that position, the follower needs only the tail — its
        recovered zxid is the catch-up base, no snapshot fetch.
        Returns the absolute log index to ship from, or None when the
        log no longer (or never) covers ``have_zxid`` and the caller
        must fall back to the snapshot bootstrap."""
        pos = self.index_after_zxid(have_zxid)
        if pos is None:
            return None
        # session control records carry the zxid current at their
        # edge: ones logged at exactly ``have_zxid`` AFTER the
        # rejoiner's last mirrored txn are invisible to the zxid
        # bisect — walk the position back over them (re-shipping a
        # session record the rejoiner did hold is idempotent)
        while pos > self.log_base:
            e = self.log[pos - 1 - self.log_base]
            if e[0] in ('session', 'session_close') \
                    and entry_zxid(e) == have_zxid:
                pos -= 1
            else:
                break
        self._replicas.append(replica)
        return pos

    def index_after_zxid(self, have_zxid: int) -> int | None:
        """Absolute log index of the first retained entry with zxid >
        ``have_zxid``; None when the retained log does not cover that
        position (truncated past it, never recorded, or the caller is
        ahead of this leader)."""
        if have_zxid < self.log_start_zxid or have_zxid > self.zxid:
            return None
        lo, hi = 0, len(self.log)
        while lo < hi:
            mid = (lo + hi) // 2
            if entry_zxid(self.log[mid]) <= have_zxid:
                lo = mid + 1
            else:
                hi = mid
        return self.log_base + lo

    #: Truncate the applied-everywhere log prefix in chunks (a del of
    #: a list prefix is O(surviving entries) — amortize it).
    LOG_TRUNC_CHUNK = 256

    def attach_replica(self, replica: 'ReplicaStore') -> None:
        """Called by :class:`ReplicaStore` — from here on, committed
        transactions are retained in ``log`` for replay.  Must happen
        before the first transaction: a replica cannot replay history
        that was never kept."""
        if self.zxid != 0:
            raise ValueError(
                'replica attached after %d transactions; the commit '
                'log only starts recording at attach' % (self.zxid,))
        self._replicas.append(replica)

    def log_end(self) -> int:
        """Absolute index one past the newest log entry."""
        return self.log_base + len(self.log)

    def recover_from_disk(self) -> None:
        """Rebuild this database's state from its WAL directory — the
        in-process analogue of a leader process dying and restarting
        (``ZKServer.restart(from_disk=True)``).  Sessions recovered
        LIVE from the WAL (durable session records + the snapshot's
        table) are re-seated with fresh expiry clocks — a client
        resuming inside the timeout keeps its session and its
        ephemerals; only dead sessions' ephemerals are reaped, by
        logged deletes.  Standalone/leader only: attached replicas
        hold live trees this reload would silently diverge from."""
        from .persist import (
            reap_orphan_ephemerals,
            recover_state,
            restore_sessions,
        )

        wal = self.wal
        assert wal is not None, 'recover_from_disk needs a WAL'
        assert not self._replicas, \
            'recover_from_disk is standalone/leader-rebuild only'
        wal.close()
        rec = recover_state(wal.dir)
        for sess in self.sessions.values():
            if sess.expiry_handle is not None:
                sess.expiry_handle.cancel()
                sess.expiry_handle = None
        self.sessions.clear()
        self.nodes = rec.nodes
        self.zxid = rec.zxid
        self.epoch = max(self.epoch, rec.epoch)
        if rec.config is not None:
            self.install_config(rec.config)
        self.log.clear()
        self.log_base = 0
        self.log_start_zxid = rec.zxid
        # the SAME WriteAheadLog object reopens: collector-bound
        # gauges/histograms and the fault injector stay live on it
        wal.reopen()
        restore_sessions(self, rec.sessions)
        reap_orphan_ephemerals(self)

    def _commit(self, entry: tuple) -> None:
        if self._multi_buf is not None:
            # speculative MULTI apply: held until the whole batch
            # commits (or rolls back) — nothing reaches the WAL, the
            # replication log or a trace ring from inside the batch
            self._multi_buf.append(entry)
            return
        if self.trace is not None \
                and entry[0] not in ('session', 'session_close',
                                     'reconfig'):
            # session control records are edges, not transactions:
            # they consume no zxid, so a COMMIT span would break the
            # zxid-keyed chain (and stamp zxid 0 on a fresh database);
            # reconfig records get their own RECONFIG span chain
            # (propose -> joint -> commit) instead
            if entry[0] == 'multi':
                self.trace.note('COMMIT', None,
                                zxid=entry_zxid(entry), kind='server',
                                detail='multi', batch=len(entry[1]))
            else:
                self.trace.note('COMMIT', entry[1],
                                zxid=entry_zxid(entry), kind='server',
                                detail=entry[0])
        # durability first: the WAL append precedes the 'committed'
        # emit (and therefore every replica push and — because the
        # handler corks the ack after this returns — every ack byte)
        if self.wal is not None:
            self.wal.append(entry)
        if self._replicas:
            self.log.append(entry)
            self.emit('committed')
            self._truncate_applied()
        else:
            # nothing attached: the entry is not retained, so the log
            # is only contiguous after this point (a stale prefix from
            # a detached replica era would otherwise read as coverage)
            if self.log:
                self.log_base += len(self.log)
                self.log.clear()
            self.log_start_zxid = self.zxid

    def _truncate_applied(self) -> None:
        """Drop the log prefix every attached replica has applied —
        those entries can never be replayed again (``applied`` only
        advances), so retaining them would grow a long-running
        ensemble's memory without bound."""
        floor = min(r.applied for r in self._replicas)
        if floor - self.log_base >= self.LOG_TRUNC_CHUNK:
            self.log_start_zxid = entry_zxid(
                self.log[floor - self.log_base - 1])
            del self.log[:floor - self.log_base]
            self.log_base = floor

    # -- session lifecycle --

    def create_session(self, timeout: int) -> ZKServerSession:
        self._next_session += 1
        sess = ZKServerSession(id=self._next_session,
                               passwd=secrets.token_bytes(16),
                               timeout=timeout)
        self.sessions[sess.id] = sess
        self.touch_session(sess)
        # durable sessions: the edge is a WAL control record AND a
        # replicated log entry (a follower's mirror must carry the
        # table so a promoted leader keeps every session).  It rides
        # the zxid current at the edge — consuming none — and
        # recovery replays it by log index (server/persist.py).
        self._commit(('session', sess.id, sess.passwd, sess.timeout,
                      self.zxid))
        log.debug('created session %016x timeout %d', sess.id, timeout)
        return sess

    def session_snapshot(self) -> dict:
        """The live session table in its durable form — what a fuzzy
        snapshot stamps (server/persist.py format 3)."""
        return durable_sessions(self.sessions)

    def resume_session(self, session_id: int,
                       passwd: bytes) -> ZKServerSession | None:
        sess = self.sessions.get(session_id)
        if sess is None or sess.expired or sess.closed:
            return None
        if sess.passwd != passwd:
            return None
        self.touch_session(sess)
        return sess

    def touch_session(self, sess: ZKServerSession) -> None:
        """Reset the session's expiry clock; called on every packet the
        ensemble sees from it."""
        if sess.expiry_handle is not None:
            sess.expiry_handle.cancel()
        loop = ambient_loop()
        sess.expiry_handle = loop.call_later(
            sess.timeout / 1000.0, lambda: self.expire_session(sess.id))

    def expire_session(self, session_id: int) -> None:
        sess = self.sessions.get(session_id)
        if sess is None or sess.expired or sess.closed:
            return
        sess.expired = True
        if sess.expiry_handle is not None:
            sess.expiry_handle.cancel()
            sess.expiry_handle = None
        log.info('session %016x expired', session_id)
        # the edge is logged BEFORE the ephemeral deletes it causes:
        # a crash between them recovers a dead session whose orphans
        # the recovery reap replays
        self._commit(('session_close', session_id, self.zxid,
                      'expire'))
        self._reap_ephemerals(sess)
        self.emit('sessionExpired', session_id)

    def close_session(self, session_id: int) -> None:
        sess = self.sessions.get(session_id)
        if sess is None or sess.closed:
            return
        sess.closed = True
        if sess.expiry_handle is not None:
            sess.expiry_handle.cancel()
            sess.expiry_handle = None
        log.debug('session %016x closed', session_id)
        self._commit(('session_close', session_id, self.zxid,
                      'close'))
        self._reap_ephemerals(sess)

    def _reap_ephemerals(self, sess: ZKServerSession) -> None:
        # Deepest-first so children go before parents.
        for path in sorted(sess.ephemerals, key=len, reverse=True):
            if path in self.nodes:
                try:
                    self.delete(path, -1)
                except ZKOpError:
                    log.warning('could not reap ephemeral %s', path)
        sess.ephemerals.clear()

    # -- znode writes (validate, sequence, apply, commit) --

    def create(self, path: str, data: bytes, acl, flags: CreateFlag,
               session: ZKServerSession | None = None) -> str:
        validate_path(path)
        if path == '/':
            raise ZKOpError('NODE_EXISTS')
        parent = self.nodes.get(parent_path(path))
        if parent is None:
            raise ZKOpError('NO_NODE')
        if parent.ephemeral_owner != 0:
            raise ZKOpError('NO_CHILDREN_FOR_EPHEMERALS')

        if flags & CreateFlag.SEQUENTIAL:
            path = '%s%010d' % (path, parent.seq)
            parent.seq += 1
        if path in self.nodes:
            raise ZKOpError('NODE_EXISTS')

        eph_owner = 0
        if flags & CreateFlag.EPHEMERAL:
            if session is None:
                raise ZKOpError('BAD_ARGUMENTS')
            eph_owner = session.id
            session.ephemerals.add(path)
        acl_t = tuple(acl) if acl else OPEN_ACL_UNSAFE
        zxid = self.next_zxid()
        now = self.now_ms()
        self._apply_create(path, data, acl_t, eph_owner, zxid, now)
        self._commit(('create', path, data, acl_t, eph_owner, zxid, now))
        return path

    def delete(self, path: str, version: int) -> None:
        validate_path(path)
        node = self.nodes.get(path)
        if node is None:
            raise ZKOpError('NO_NODE')
        if node.children:
            raise ZKOpError('NOT_EMPTY')
        if version >= 0 and version != node.version:
            raise ZKOpError('BAD_VERSION')

        zxid = self.next_zxid()
        node = self._apply_delete(path, zxid)
        if node.ephemeral_owner:
            sess = self.sessions.get(node.ephemeral_owner)
            if sess is not None:
                sess.ephemerals.discard(path)
        self._commit(('delete', path, zxid))

    def set_data(self, path: str, data: bytes, version: int) -> Stat:
        validate_path(path)
        node = self.nodes.get(path)
        if node is None:
            raise ZKOpError('NO_NODE')
        if version >= 0 and version != node.version:
            raise ZKOpError('BAD_VERSION')
        zxid = self.next_zxid()
        node = self._apply_set_data(path, data, zxid, self.now_ms())
        self._commit(('set_data', path, node.data, zxid, node.mtime))
        return node.stat()

    def check(self, path: str, version: int) -> None:
        """The CHECK sub-op (MULTI-only, like real ZK): version guard
        with no mutation and no log entry."""
        validate_path(path)
        node = self.nodes.get(path)
        if node is None:
            raise ZKOpError('NO_NODE')
        if version >= 0 and version != node.version:
            raise ZKOpError('BAD_VERSION')

    # -- MULTI: one all-or-nothing transaction ------------------------

    def multi(self, ops: list, session: ZKServerSession | None = None
              ) -> list:
        """Apply ``ops`` (sub-op dicts: create / delete / set_data /
        check) as ONE transaction: all of them commit as a single
        ('multi', subs) log entry — one WAL record, one group-fsync
        slot, one replication push element — or none of them touch
        the tree at all.

        The apply is speculative-with-undo rather than
        validate-then-apply: each sub-op runs through the exact
        single-op path (so validation can never diverge from it) with
        change events buffered and commits intercepted; the first
        failure rolls the applied prefix back — pre-copied nodes and
        parents restored in reverse order, zxid rewound, buffered
        events dropped — and every position reports an error result
        (the failing op its real code, the rest
        RUNTIME_INCONSISTENCY, real ZK's multi error shape).  On
        success the buffered events fire in apply order."""
        if not ops:
            return []
        start_zxid = self.zxid
        buf: list[tuple] = []
        events: list = []
        undo: list = []
        results: list = []
        failure: tuple[int, str] | None = None
        self._multi_buf = buf
        self._event_buf = events
        try:
            for op in ops:
                name = op.get('op')
                path = op.get('path', '')
                saved = (_copy_znode(self.nodes.get(path)),
                         _copy_znode(self.nodes.get(
                             parent_path(path) if path else '/')))
                n_before = len(buf)
                try:
                    if name == 'create':
                        made = self.create(
                            path, op.get('data', b''), op.get('acl'),
                            CreateFlag(op.get('flags', 0)), session)
                        results.append({'op': 'create', 'path': made})
                    elif name == 'delete':
                        self.delete(path, op.get('version', -1))
                        results.append({'op': 'delete'})
                    elif name == 'set_data':
                        stat = self.set_data(path, op['data'],
                                             op.get('version', -1))
                        results.append({'op': 'set_data',
                                        'stat': stat})
                    elif name == 'check':
                        self.check(path, op.get('version', -1))
                        results.append({'op': 'check'})
                    else:
                        raise ZKOpError('BAD_ARGUMENTS')
                except ZKOpError as e:
                    failure = (len(results), e.code)
                    break
                if len(buf) > n_before:
                    undo.append((buf[-1], saved))
        finally:
            self._multi_buf = None
            self._event_buf = None
        if failure is not None:
            self._rollback_multi(undo, start_zxid)
            idx, code = failure
            return [{'op': 'error',
                     'err': code if i == idx
                     else 'RUNTIME_INCONSISTENCY'}
                    for i in range(len(ops))]
        if buf:
            self.multi_batches += 1
            self.multi_subops += len(buf)
            self._commit(('multi', tuple(buf)))
            for ev, args in events:
                self.emit(ev, *args)
        return results

    def _rollback_multi(self, undo: list, start_zxid: int) -> None:
        """Reverse an applied MULTI prefix: each step restores the
        node/parent copies captured just before its sub-op, newest
        first, then the zxid rewinds — byte-identical to never having
        applied (no event fired, nothing logged)."""
        for entry, (node_copy, parent_copy) in reversed(undo):
            op = entry[0]
            path = entry[1]
            ppath = parent_path(path)
            if op == 'create':
                self.nodes.pop(path, None)
                if parent_copy is not None:
                    self.nodes[ppath] = parent_copy
                if entry[4]:
                    sess = self.sessions.get(entry[4])
                    if sess is not None:
                        sess.ephemerals.discard(path)
            elif op == 'delete':
                if node_copy is not None:
                    self.nodes[path] = node_copy
                    if node_copy.ephemeral_owner:
                        sess = self.sessions.get(
                            node_copy.ephemeral_owner)
                        if sess is not None:
                            sess.ephemerals.add(path)
                if parent_copy is not None:
                    self.nodes[ppath] = parent_copy
            else:
                assert op == 'set_data', op
                if node_copy is not None:
                    self.nodes[path] = node_copy
        self.zxid = start_zxid


class ReplicaStore(NodeTree):
    """One follower's local view of the tree, fed by the leader's
    commit log.

    ``lag`` controls replication delay:

    - ``0`` (default): apply synchronously at commit — a perfect
      network; every existing single-tick visibility expectation holds;
    - ``> 0``: apply each transaction ``lag`` seconds after commit —
      a follower that genuinely trails the leader;
    - ``None``: apply only on :meth:`catch_up` (the ``sync`` op or a
      write through this member) — a deterministically stale follower
      for tests.

    Watch locality falls out naturally: a server connection's watch
    tables subscribe to its member's store, so a watch on a lagging
    follower fires when THAT member applies the transaction, exactly
    like a real follower committing behind the leader.
    """

    def __init__(self, leader: ZKDatabase, lag: float | None = 0.0):
        super().__init__()
        self.leader = leader
        self.lag = lag
        #: ABSOLUTE index (leader.log_base frame) of the next entry to
        #: apply; only ever advances, which is what lets the leader
        #: truncate the applied-everywhere prefix
        self.applied = 0
        #: Serializes :meth:`_apply_until`: normally every apply runs
        #: on the member's event loop, but the cross-process replica's
        #: blocking control-channel RPCs are legitimately driven from
        #: another thread (run_in_executor — the sync barrier in the
        #: chaos campaign, test harnesses), and its piggyback triggers
        #: catch_up on THAT thread while an events-channel push can
        #: trigger it on the loop; an unguarded read-modify-write of
        #: ``applied`` would skip or double-apply an entry.
        self._apply_lock = threading.Lock()
        try:
            leader.attach_replica(self)
        except ValueError:
            # the leader already has history — e.g. it was recovered
            # from its WAL (server/persist.py) before this follower
            # existed: bootstrap from an image at the current
            # position, exactly like a cross-process late joiner.
            # The image is deep-copied (pickle roundtrip, same as the
            # wire would do): an in-process replica must not alias
            # the leader's live tree or lag would be unobservable.
            import pickle
            pos = leader.attach_replica_at_tail(self)
            self.install({'zxid': leader.zxid,
                          'nodes': pickle.loads(
                              pickle.dumps(leader.nodes))})
            self.applied = pos
        leader.on('committed', self._on_commit)

    @property
    def epoch(self) -> int:
        """The leadership epoch this replica's feed runs at — the
        leader's (or mirror's) accepted epoch; what a mirror WAL
        snapshot stamps (server/persist.py format 2)."""
        return getattr(self.leader, 'epoch', 0)

    def session_snapshot(self) -> dict:
        """The session table a mirror WAL snapshot stamps (format 3):
        the leader handle's — the shared database in process, the
        replicated mirror table cross-process — in durable form."""
        sessions = getattr(self.leader, 'sessions', None)
        return durable_sessions(sessions) if sessions else {}

    def _on_commit(self) -> None:
        if self.lag is None:
            return
        if self.lag <= 0:
            self._apply_until(self.leader.log_end())
        else:
            ambient_loop().call_later(
                self.lag, self._apply_until, self.leader.log_end())

    def _apply_until(self, target: int) -> None:
        """Apply log entries up to absolute index ``target``
        (idempotent: a timer firing after a ``catch_up`` already passed
        it is a no-op, so application order is always log order; the
        lock keeps that true when an off-loop control-channel thread
        races an on-loop events push — see ``_apply_lock``)."""
        ldr = self.leader
        with self._apply_lock:
            while self.applied < min(target, ldr.log_end()):
                self._apply_one(ldr.log[self.applied - ldr.log_base])
                self.applied += 1

    #: Optional quorum-commit ack hook (server/replication.py
    #: QuorumGate): called with this replica's zxid after every
    #: applied entry — the in-process ensemble's piggybacked
    #: applied-zxid vote.  Class-level None keeps the no-quorum hot
    #: path a single attribute test.
    on_applied = None

    def _apply_one(self, entry: tuple) -> None:
        self.apply_entry(entry)
        if self.trace is not None:
            self.trace.note('APPLY',
                            entry[1] if isinstance(entry[1], str)
                            else None,
                            zxid=entry_zxid(entry), kind='server',
                            detail=entry[0])
        cb = self.on_applied
        if cb is not None:
            cb(self.zxid)

    def catch_up(self) -> None:
        """Apply everything committed so far — what a write through
        this member does so its author can read their own write."""
        self._apply_until(self.leader.log_end())

    def detach(self) -> None:
        """Unhook from the leader's commit feed — the observer-leave
        half of a membership change (README "Dynamic membership"):
        no further entries are pushed to this replica, and its
        ``applied`` floor stops pinning the leader's log truncation.
        Idempotent."""
        ldr = self.leader
        ldr.remove_listener('committed', self._on_commit)
        try:
            ldr._replicas.remove(self)
        except ValueError:
            pass

    def sync_flush(self) -> None:
        """The ``sync`` op's barrier: for an in-process replica the
        leader's log IS the committed history, so this is
        ``catch_up``; the cross-process replica overrides it to fetch
        first (server/replication.py)."""
        self.catch_up()
