"""Quorum leader election over recovered (epoch, zxid) pairs.

Until this module the ensemble's leader was statically assigned:
``ZKEnsemble`` hard-wired member 0, and the OS-process tier spawned a
process whose *role* was leader — killing it killed the quorum.  The
durability plane (server/persist.py) gave every member a disk worth
trusting; this module builds the coordination layer on top of it, the
ZAB shape: when the leader is lost, members vote with the newest
``(epoch, zxid)`` pair they hold — recovered from their own WAL when
the whole ensemble died — and the highest pair wins (member id breaks
exact ties, deterministically, so a split vote cannot live-lock).
The winner bumps the **epoch**, a first-class fencing token:

- persisted as a WAL *control* record before the new leader serves a
  single write (recovered by server/persist.py on restart);
- stamped on every replication push and forwarded-write ack
  (server/replication.py): followers reject pushes from a lower
  epoch, and a deposed leader's forwarded writes bounce with a typed
  ``EPOCH_FENCED`` error instead of being silently applied;
- strictly increasing across elections — invariant 7
  (io/invariants.py) checks at-most-one-leader-per-epoch and epoch
  monotonicity over the campaign history.

Two tiers, one vote rule:

- **In-process** (:class:`ElectionCoordinator`): the members of a
  ``ZKEnsemble`` share one database, so an election is role + fencing
  bookkeeping — but the *detection* is honest: a monitor probes the
  leader's listener on a jittered backoff (io/backoff.py) and elects
  among live, unpartitioned members only when a quorum of the
  membership is available; a partitioned minority can never win.
- **OS-process** (:class:`ElectionPeer` + :func:`run_member`): every
  member is a symmetric peer process with an election port.  A
  looking peer polls its peers for votes (jittered backoff between
  rounds); with a quorum reachable the highest (epoch, zxid, id)
  wins, promotes its replica mirror (or its recovered WAL) into the
  leader database, starts a ``ReplicationService``, and the rest
  re-follow it through the existing tail-resync / snapshot-bootstrap
  machinery.  Leader loss is the push-channel EOF
  (``RemoteLeader.on_leader_lost``).  No operator anywhere.

``ZKSTREAM_NO_ELECTION=1`` (or ``ZKEnsemble(election=False)``) keeps
the static-leader behavior as an env-gated validator, the same knob
pattern as the watch-table emitter path.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import os
import socket
import time

from ..io.backoff import BackoffPolicy
from ..utils.aio import ambient_loop
from ..utils.events import EventEmitter
from .replication import _dump, _read_msg, quorum_of

log = logging.getLogger('zkstream_tpu_torch.server.election')

METRIC_ELECTION = 'zk_election_ms'
ELECTION_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                    500.0, 1000.0, 2500.0, 5000.0)

#: In-process leader-liveness probe cadence (ms).  Detection latency
#: is bounded by one probe interval; campaigns shrink it.
DEFAULT_HEARTBEAT_MS = 400

#: OS-process vote-round pacing: full-jittered delays between poll
#: rounds, walking up while no quorum is reachable (the storm-
#: decorrelation shape of io/backoff.py — N followers losing one
#: leader must not stampede each other's election ports).
PEER_POLICY = BackoffPolicy(timeout=1000, retries=3, delay=60,
                            cap=1000)

#: How many denied claim rounds before a candidate escalates to the
#: next epoch.  Grants are STICKY (a target epoch, once granted,
#: belongs to that candidate forever — a time-based re-grant could
#: hand the same epoch to a second live candidate whose rival is
#: merely promoting slowly), so liveness comes from escalation
#: instead: a candidate denied its target — the granted claimant died
#: mid-claim, or a slow rival holds it — claims target+1, which is a
#: fresh arbitration.  Two winners can then stand only at DIFFERENT
#: epochs, which the fencing token resolves (the lower one deposes
#: itself via the supersession watch).
CLAIM_ESCALATE_AFTER = 3

#: A standing leader's supersession-watch poll period: how often it
#: asks its peers whether a newer-epoch leader stands (the deposed-
#: while-partitioned case — it fences itself and steps down).  Also
#: the bound on how long a deposed leader can keep acking direct
#: client writes; analogous to real ZK's syncLimit window.
LEAD_WATCH_S = 0.4


def election_enabled() -> bool:
    """Global kill switch (mirrors ``ZKSTREAM_NO_WATCHTABLE``): the
    static-leader path stays available as an env-gated validator."""
    return os.environ.get('ZKSTREAM_NO_ELECTION') != '1'


@dataclasses.dataclass(frozen=True, order=True)
class Vote:
    """One member's claim in an election.  Field order IS the vote
    rule: highest epoch wins; equal epochs fall to the highest zxid
    (the member holding the most history — no acked write can be
    seeded away); an exact (epoch, zxid) tie breaks to the highest
    member id, so every voter computes the same winner from the same
    ballot and a split vote resolves in one round."""

    epoch: int
    zxid: int
    member: int


def tally(votes) -> Vote | None:
    """The election rule, shared verbatim by both tiers."""
    votes = list(votes)
    if not votes:
        return None
    return max(votes)


def _promise_path(d: str) -> str:
    return os.path.join(d, 'promise')


def read_promise(d: str) -> int:
    """The highest claim target ever granted from this directory."""
    try:
        with open(_promise_path(d)) as f:
            return int(f.read().strip() or 0)
    except (FileNotFoundError, ValueError):
        return 0


def write_promise(d: str, target: int) -> None:
    """Durably record a claim grant (write + fsync + atomic rename):
    a promise, like an accepted epoch, must survive the promiser —
    a restarted peer that forgot its grant could hand the same epoch
    to a second live candidate."""
    tmp = _promise_path(d) + '.tmp'
    with open(tmp, 'w') as f:
        f.write('%d\n' % (target,))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, _promise_path(d))


def allocate_ports(n: int, host: str = '127.0.0.1') -> list[int]:
    """Pre-allocate n distinct ephemeral ports (bind/close): peer
    processes must know each other's election ports before any of
    them exists."""
    socks, ports = [], []
    try:
        for _ in range(n):
            s = socket.socket()
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind((host, 0))
            socks.append(s)
            ports.append(s.getsockname()[1])
    finally:
        for s in socks:
            s.close()
    return ports


# ---------------------------------------------------------------------
# In-process tier: the ZKEnsemble coordinator.
# ---------------------------------------------------------------------


class ElectionCoordinator(EventEmitter):
    """Leader election for an in-process ``ZKEnsemble``.

    The members share one ``ZKDatabase``, so promotion is role +
    fencing bookkeeping — what the election *changes* is observable
    everywhere else: the epoch bumps (WAL-logged), ``zk_member_role``
    flips, a deposed-but-alive ex-leader's writes bounce with
    ``EPOCH_FENCED`` until it heals, and the campaign history gains
    the election records invariant 7 replays.

    Events: ``elected(member, epoch, duration_ms)``,
    ``electing(reason)``.
    """

    def __init__(self, servers, db, heartbeat_ms: int | None = None,
                 seed: int | None = None, collector=None,
                 voters: int | None = None):
        super().__init__()
        self.servers = servers
        self.db = db
        #: The VOTING membership: members ``0..voters-1``.  Members
        #: past it are observers (README "Read plane") — they never
        #: enter a ballot, never win, and never count toward the
        #: election quorum denominator.
        self.voters = voters if voters is not None else len(servers)
        #: Dynamic membership (README "Dynamic membership"): the
        #: CURRENT voter set by member index — reconfig records
        #: (server/store.py) repoint it via :meth:`set_config`.  While
        #: ``old_voter_set`` stands (a joint window), an election
        #: needs a reachable majority of BOTH sets, and the ballot is
        #: open to their union; once the final record commits, a
        #: removed member can neither stand nor be counted reachable.
        self.voter_set: set[int] = set(range(self.voters))
        self.old_voter_set: set[int] | None = None
        self.heartbeat_ms = (heartbeat_ms if heartbeat_ms is not None
                             else DEFAULT_HEARTBEAT_MS)
        self.leader_idx = 0
        self.elections = 0
        #: members fenced at a stale epoch (an alive-but-deposed
        #: ex-leader): writes through them raise EPOCH_FENCED
        self.deposed: set[int] = set()
        #: members cut off from the quorum: they neither vote nor win
        self.partitioned: set[int] = set()
        self._probe_policy = BackoffPolicy(
            timeout=self.heartbeat_ms, retries=3,
            delay=self.heartbeat_ms, cap=self.heartbeat_ms * 8)
        self._seed = seed
        self._task: asyncio.Task | None = None
        self._electing = False
        self._stopping = False
        self._hist = None
        if collector is not None:
            self.bind_metrics(collector)
        for i, s in enumerate(self.servers):
            if i < self.voters:
                s.role = ('leader' if i == self.leader_idx
                          else 'follower')
            s.elections_ref = self
            s.fence = (lambda idx=i: idx in self.deposed)

    def bind_metrics(self, collector) -> None:
        self._hist = collector.histogram(
            METRIC_ELECTION,
            'Leader-loss detection to new-leader promotion, ms',
            buckets=ELECTION_BUCKETS)

    # -- liveness --

    def _alive(self, idx: int) -> bool:
        return self.servers[idx].listening

    def leader_alive(self) -> bool:
        return self._alive(self.leader_idx) \
            and self.leader_idx not in self.partitioned

    def start(self) -> None:
        if self._task is None:
            self._stopping = False
            self._task = ambient_loop().create_task(self._monitor())

    def stop(self) -> None:
        self._stopping = True
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _monitor(self) -> None:
        """Probe the leader on a jittered cadence; on loss, elect.
        The backoff only *grows* while no election can complete (no
        quorum of live members) — a genuinely-down ensemble is probed
        ever more gently — and resets the moment a leader stands."""
        backoff = self._probe_policy.backoff(self._seed)
        try:
            while not self._stopping:
                if self.leader_alive():
                    backoff.reset()
                    delay = backoff.next_delay()
                else:
                    won = await self.elect('heartbeat-timeout')
                    if won is not None:
                        backoff.reset()
                    delay = backoff.next_delay()
                await asyncio.sleep(
                    (self.heartbeat_ms * 0.25 + delay * 0.75) / 1000.0)
        except asyncio.CancelledError:
            pass

    # -- the election itself --

    def set_config(self, voter_set, old_voter_set=None) -> None:
        """Adopt a reconfig record's voter set(s): ``voter_set`` is
        C_new, ``old_voter_set`` C_old while the joint window stands
        (both-majorities rule).  A member removed by the final record
        leaves the ballot immediately."""
        self.voter_set = set(voter_set)
        self.old_voter_set = (set(old_voter_set)
                              if old_voter_set is not None else None)

    def _candidates(self) -> list[int]:
        # the live ballot: current voters, plus C_old's during a
        # joint window; an observer (or a removed member) holds the
        # same history but must never stand (or be counted reachable)
        live = self.voter_set | (self.old_voter_set or set())
        return [i for i in sorted(live)
                if i < len(self.servers) and self._alive(i)
                and i not in self.partitioned]

    def _quorum_reached(self, cands) -> bool:
        """A reachable majority of EVERY active voter set: C_new
        alone in stable state, C_old AND C_new during a joint
        window — the election half of joint consensus."""
        cs = set(cands)
        for cfg in ((self.voter_set,) if self.old_voter_set is None
                    else (self.voter_set, self.old_voter_set)):
            if not cfg or len(cs & cfg) < quorum_of(len(cfg)):
                return False
        return True

    async def elect(self, reason: str) -> int | None:
        """Run one election among live, unpartitioned members.
        Returns the winning member index, or None when no quorum of
        the total membership is reachable (a partitioned minority —
        or a mostly-dead ensemble — must NOT seed a new epoch)."""
        if self._electing or self._stopping:
            return None
        self._electing = True
        t0 = time.perf_counter()
        try:
            cands = self._candidates()
            if not self._quorum_reached(cands):
                return None
            self.emit('electing', reason)
            for i in cands:
                self.servers[i].role = 'electing'
            # one cooperative yield: role flips are observable (mntr
            # scrapes a member mid-election as 'electing'), and a
            # kill racing the vote lands before the tally
            await asyncio.sleep(0)
            cands = self._candidates()
            if not self._quorum_reached(cands):
                for i in self._candidates():
                    self.servers[i].role = 'follower'
                return None
            votes = [Vote(epoch=self.db.epoch,
                          zxid=self.servers[i].store.zxid, member=i)
                     for i in cands]
            win = tally(votes)
            new_epoch = self.db.epoch + 1
            self.db.bump_epoch(new_epoch)
            old = self.leader_idx
            if old != win.member and self._alive(old):
                # an ex-leader that survived its own deposition (a
                # healed partition brings it back): fence it until it
                # rejoins the current epoch
                self.deposed.add(old)
            self.deposed.discard(win.member)
            srv = self.servers[win.member]
            srv.store.catch_up()
            for i in cands:
                self.servers[i].role = \
                    'leader' if i == win.member else 'follower'
            self.leader_idx = win.member
            self.elections += 1
            dur_ms = (time.perf_counter() - t0) * 1000.0
            if self._hist is not None:
                self._hist.observe(dur_ms)
            if srv.trace is not None:
                srv.trace.note('ELECTION', kind='server',
                               batch=len(votes), detail=reason,
                               duration_ms=round(dur_ms, 3))
                srv.trace.note('EPOCH_BUMP', zxid=self.db.zxid,
                               kind='server',
                               detail='epoch=%d' % (new_epoch,))
            log.info('member %d elected leader at epoch %d (%s, '
                     '%d votes, %.1f ms)', win.member, new_epoch,
                     reason, len(votes), dur_ms)
            self.emit('elected', win.member, new_epoch, dur_ms)
            return win.member
        finally:
            self._electing = False

    # -- membership edges the ensemble reports --

    def note_restart(self, idx: int) -> None:
        """A killed member is back: it rejoins at the current epoch as
        a follower (never as the leader it may once have been)."""
        self.deposed.discard(idx)
        if idx != self.leader_idx:
            self.servers[idx].role = 'follower'

    def partition(self, idx: int) -> None:
        self.partitioned.add(idx)

    def heal(self, idx: int | None = None) -> None:
        """Heal a partition: the member observes the current epoch
        and rejoins as a follower — its fence lifts."""
        idxs = list(self.partitioned) if idx is None else [idx]
        for i in idxs:
            self.partitioned.discard(i)
            self.deposed.discard(i)
            if i != self.leader_idx and self._alive(i):
                self.servers[i].role = 'follower'


# ---------------------------------------------------------------------
# OS-process tier: symmetric peer processes.
# ---------------------------------------------------------------------


class ElectionPeer:
    """One member process's election endpoint + vote loop.

    The peer answers ``vote?`` probes with its live state (looking /
    following / leading, epoch, zxid, and — when leading — its
    replication port), and :meth:`resolve` runs the looking-side loop:
    poll every peer, follow a standing leader at ``>=`` our epoch,
    else — with a quorum reachable — compute the winner all reachable
    peers will also compute.  A minority partition never reaches
    quorum and so never seeds an epoch."""

    def __init__(self, member_id: int, peers, total: int,
                 host: str = '127.0.0.1', port: int = 0,
                 policy: BackoffPolicy = PEER_POLICY,
                 seed: int | None = None,
                 promise_dir: str | None = None,
                 observer: bool = False):
        self.member_id = member_id
        self.peers = list(peers)          # [(id, host, election_port)]
        #: ``total`` is the VOTING membership.  An observer peer
        #: (README "Read plane") is outside it: its vote replies are
        #: stamped ``observer`` (excluded from every ballot and every
        #: reachable-quorum count), it denies every claim (a grant
        #: from outside the voter set must never help a candidate
        #: assemble a "quorum"), and :meth:`resolve` never stands —
        #: it only ever follows a leader the voters elected.
        self.observer = observer
        self.total = total
        self.host = host
        self.port = port
        self.policy = policy
        self.seed = seed
        #: durable promise floor: the highest target ever granted
        #: from this directory — consulted (and advanced, fsynced)
        #: by grant() so a SIGKILLed-and-restarted granter cannot
        #: hand an already-promised epoch to a second candidate.
        #: None = in-memory only (unit tests).
        self.promise_dir = promise_dir
        self.promised_floor = (read_promise(promise_dir)
                               if promise_dir else 0)
        self.state = 'looking'
        self.repl_port: int | None = None
        #: live-state providers, set by the owner (run_member): voting
        #: must read the CURRENT epoch/zxid, not a stale copy
        self.epoch_fn = lambda: 0
        self.zxid_fn = lambda: 0
        #: claim grants: target epoch -> candidate vote.  Each target
        #: epoch is promised to at most ONE candidate, EVER — the
        #: arbitration that keeps two candidates with overlapping
        #: (but different) reachable quorums from both seeding the
        #: SAME epoch: the overlap peer grants one of them and denies
        #: the other, so only one can reach a quorum of grants.
        #: Liveness on a wedged target (claimant died mid-claim) is
        #: the candidate's job: escalate to target+1
        #: (CLAIM_ESCALATE_AFTER).  Stale targets are pruned once an
        #: epoch at or above them stands.
        self._grants: dict[int, Vote] = {}
        self._server: asyncio.base_events.Server | None = None

    async def start(self) -> 'ElectionPeer':
        self._server = await asyncio.start_server(
            self._serve, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            self._server = None

    def note_leading(self, repl_port: int) -> None:
        self.state = 'leading'
        self.repl_port = repl_port

    def note_following(self) -> None:
        self.state = 'following'
        self.repl_port = None

    def note_looking(self) -> None:
        self.state = 'looking'
        self.repl_port = None

    def grant(self, target: int, vote: Vote) -> bool:
        """One peer's claim arbitration: grant ``target`` to at most
        one candidate, ever (sticky — never re-granted to a rival,
        however long the claimant takes to promote), and never to a
        target at or below the epoch already standing here.  The same
        candidate re-claiming is idempotent."""
        if self.observer:
            return False              # observers never arbitrate
        epoch = self.epoch_fn()
        for t in [t for t in self._grants if t <= epoch]:
            del self._grants[t]       # settled eras: prune
        if target <= epoch:
            return False              # that era already stands
        cur = self._grants.get(target)
        if cur is None and target <= self.promised_floor:
            # promised before a restart wiped the in-memory table:
            # the original claimant may still be live — deny, and let
            # whoever is asking escalate to a fresh target.  Over-
            # denial costs a skipped epoch number, never safety.
            return False
        if cur is None or cur == vote:
            self._grants[target] = vote
            if target > self.promised_floor:
                self.promised_floor = target
                if self.promise_dir is not None:
                    write_promise(self.promise_dir, target)
            return True
        return False

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        try:
            msg = await asyncio.wait_for(_read_msg(reader), 5.0)
            if msg[0] == 'vote?':
                # an observer's reply is stamped as such: voters drop
                # it from ballots and reachable-quorum counts
                state = 'observer' if self.observer else self.state
                writer.write(_dump(
                    ('vote', self.member_id, state,
                     self.epoch_fn(), self.zxid_fn(),
                     self.repl_port)))
                await writer.drain()
            elif msg[0] == 'claim?':
                _, target, vote_t = msg
                ok = self.grant(target, Vote(*vote_t))
                writer.write(_dump(('claim', self.member_id, ok)))
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError,
                asyncio.TimeoutError, TimeoutError):
            pass
        finally:
            try:
                writer.close()
            except (ConnectionError, RuntimeError):
                pass

    async def _ask(self, host: str, port: int, request: tuple,
                   reply_tag: str):
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(host, port), 1.0)
        except (OSError, asyncio.TimeoutError, TimeoutError):
            return None
        try:
            writer.write(_dump(request))
            await writer.drain()
            msg = await asyncio.wait_for(_read_msg(reader), 1.0)
            if msg[0] == reply_tag:
                return msg
        except (OSError, asyncio.IncompleteReadError,
                asyncio.TimeoutError, TimeoutError):
            return None
        finally:
            try:
                writer.close()
            except (ConnectionError, RuntimeError):
                pass
        return None

    async def _poll(self) -> list:
        req = ('vote?', self.member_id)
        out = await asyncio.gather(
            *(self._ask(h, p, req, 'vote')
              for _id, h, p in self.peers))
        return [m for m in out if m is not None]

    async def _claim_quorum(self, target: int, vote: Vote) -> bool:
        """The claim round: collect single-grant promises for
        ``target`` from every reachable peer (self included, same
        rule).  True only with a quorum of grants — at most one
        candidate per epoch can get there."""
        if not self.grant(target, vote):
            return False
        req = ('claim?', target,
               (vote.epoch, vote.zxid, vote.member))
        out = await asyncio.gather(
            *(self._ask(h, p, req, 'claim')
              for _id, h, p in self.peers))
        granted = 1 + sum(1 for m in out
                          if m is not None and m[2])
        return granted >= quorum_of(self.total)

    async def resolve(self):
        """Loop until this peer either leads or has a leader to
        follow.  Returns ``('lead', target_epoch)`` — the epoch this
        peer holds a quorum of claim grants for — or
        ``('follow', (leader_id, host, repl_port, leader_epoch))``."""
        self.note_looking()
        backoff = self.policy.backoff(self.seed)
        denied = 0
        escalate = 0
        while True:
            replies = await self._poll()
            my_epoch, my_zxid = self.epoch_fn(), self.zxid_fn()
            leaders = [r for r in replies
                       if r[2] == 'leading' and r[5] is not None]
            if leaders:
                best = max(leaders, key=lambda r: r[3])
                if best[3] >= my_epoch:
                    host = next(h for i, h, _p in self.peers
                                if i == best[1])
                    return ('follow', (best[1], host, best[5],
                                       best[3]))
            if self.observer:
                # never stand: keep polling until a voter-elected
                # leader answers (jittered, like a denied candidate)
                await asyncio.sleep(backoff.next_delay() / 1000.0)
                continue
            # observers are outside the ballot AND the reachable
            # count: total is the voting membership
            voter_replies = [r for r in replies
                             if r[2] != 'observer']
            if len(voter_replies) + 1 >= quorum_of(self.total):
                votes = [Vote(r[3], r[4], r[1])
                         for r in voter_replies]
                my_vote = Vote(my_epoch, my_zxid, self.member_id)
                votes.append(my_vote)
                win = tally(votes)
                if win.member == self.member_id:
                    # the claim round: winning the tally of MY
                    # reachable ballot is not enough — another
                    # candidate's reachable ballot may differ.  Only
                    # a quorum of per-epoch single grants arbitrates
                    # (the overlap peer grants one of us), so two
                    # winners can never seed the same epoch.  A
                    # persistently denied target (its claimant died
                    # mid-claim, or a slow rival holds it) is
                    # escalated — fresh arbitration at target+1; a
                    # doubly-led era can then only be a LOWER epoch,
                    # which the supersession watch fences away.
                    target = max(v.epoch for v in votes) + 1 \
                        + escalate
                    if await self._claim_quorum(target, my_vote):
                        return ('lead', target)
                    denied += 1
                    if denied >= CLAIM_ESCALATE_AFTER:
                        denied = 0
                        escalate += 1
                # else: wait for the real winner's 'leading' state
                # on a later poll
            await asyncio.sleep(backoff.next_delay() / 1000.0)


async def run_member(member_id: int, wal_dir: str, client_port: int,
                     election_port: int, peers,
                     sync: str = 'tick',
                     ready_cb=None, observer: bool = False,
                     voters: int | None = None,
                     voter_ids=None, observer_ids=None) -> None:
    """One symmetric ensemble-member process: recover local state,
    run elections forever, serve clients on ``client_port`` whatever
    the current role.  ``peers`` is ``[(id, host, election_port)]``
    for every OTHER member.  Runs until the process is killed —
    being SIGKILLed mid-role is the point of the tier.

    ``observer=True`` makes this member a non-voting read-serving
    replica (README "Read plane"): it receives the replication
    stream, serves reads/watches/sessions and forwards writes like
    any follower, but never stands in an election, never grants a
    claim, and its replication acks never count toward the
    quorum-commit majority.  ``voters`` is the VOTING membership size
    (observer peers excluded); default = every peer plus self, the
    observer-free legacy shape."""
    from .persist import (
        WriteAheadLog,
        attach_wal,
        entry_zxid,
        reap_orphan_ephemerals,
        recover_state,
        reset_dir,
        restore_sequential_counters,
        restore_sessions,
    )
    from .replication import (
        RemoteLeader,
        RemoteReplicaStore,
        ReplicationService,
    )
    from .server import ZKServer
    from .store import ZKDatabase

    os.makedirs(wal_dir, exist_ok=True)
    rec = recover_state(wal_dir)
    # live-state handles the peer's vote replies read through
    state = {
        'epoch': rec.epoch,
        'zxid_fn': (lambda: rec.zxid),
    }
    voting_total = voters if voters is not None else len(peers) + 1
    if rec.config is not None and rec.config.get('voters'):
        # a reconfig record on disk supersedes the spawn-time shape:
        # this member votes (and counts quorums) at the membership it
        # last durably learned
        voting_total = len(rec.config['voters'])
    peer = ElectionPeer(member_id, peers, total=voting_total,
                        port=election_port, seed=member_id,
                        promise_dir=wal_dir, observer=observer)
    peer.epoch_fn = lambda: state['epoch']
    peer.zxid_fn = lambda: state['zxid_fn']()
    await peer.start()

    server: ZKServer | None = None
    wal: WriteAheadLog | None = None
    store = None                      # RemoteReplicaStore while following
    remote = None
    led_db = None                     # ZKDatabase of a deposed ex-leader
    loop = asyncio.get_running_loop()
    redial = PEER_POLICY.backoff(member_id)

    def announce(srv: ZKServer) -> None:
        nonlocal server
        first = server is None
        server = srv
        if first:
            if ready_cb is not None:
                ready_cb(srv)
            else:
                print('READY %d %d' % (srv.port, peer.port),
                      flush=True)

    while True:
        decision = await peer.resolve()
        if decision[0] == 'lead':
            target_epoch = decision[1]
            if store is not None:
                # live promotion: the mirror this follower served
                # reads from becomes the leader database — catch up
                # first, keep the (already-open) mirror WAL as the
                # leader's log so the on-disk history continues.
                # The store's OWN leader handle, not the `remote`
                # var: a failed re-dial may have nulled the latter
                # while the store still mirrors the previous leader.
                src = store.leader
                store.catch_up()
                db = ZKDatabase()
                db.nodes = store.nodes
                db.zxid = store.zxid
                db.epoch = src.epoch
                db.log_start_zxid = db.zxid
                src.close()
                attach_wal(db, wal)
                # durable sessions survive the failover: the mirror's
                # replicated session table seats into the new leader
                # database (fresh expiry clocks; a client that
                # resumes inside the timeout keeps its ephemerals)
                restore_sessions(db, src.session_snapshot())
                # so does the membership config the mirror replicated
                # (including an in-progress joint window)
                if src.config is not None:
                    db.install_config(src.config)
            elif led_db is not None:
                # a deposed ex-leader re-winning (the successor era
                # ended before this member ever re-followed): its own
                # database stands, WAL still attached
                db = led_db
            else:
                # cold promotion: the whole ensemble died; this
                # member's WAL seeds the new quorum (the acceptance
                # path — any member's disk can)
                from .persist import open_wal_database
                db = open_wal_database(wal_dir, sync=sync)
                wal = db.wal
            restore_sequential_counters(db)
            new_epoch = max(target_epoch, db.epoch + 1)
            db.bump_epoch(new_epoch)
            reap_orphan_ephemerals(db)
            if db.voter_ids is None and voter_ids is not None:
                # never-reconfigured ensemble: install the spawn
                # shape as config version 0 so the rcfg admin
                # channel (server/server.py) has a base to change
                db.install_config({
                    'version': 0, 'phase': 'final',
                    'voters': tuple(voter_ids), 'old_voters': None,
                    'observers': tuple(observer_ids or ())})
            if db.old_voter_ids is not None:
                # an in-progress reconfig survived (recovered from
                # WAL control records, or inherited from the mirror):
                # the new leader finishes it — the final record
                # commits under the fresh epoch, closing the joint
                # window instead of wedging quorum math on a fleet
                # that may never reassemble C_old
                db.commit_reconfig()
                log.info('member %d completed recovered reconfig '
                         '(config version %d)', member_id,
                         db.config_version)
            if db.voter_ids is not None:
                voting_total = len(db.voter_ids)
                peer.total = voting_total
            # quorum-commit: the VOTING membership is the voter set
            # (observer mirrors ack for the truncation floor but
            # never toward the majority), so a write acked through
            # THIS leader is majority-held before the ack leaves
            svc = await ReplicationService(
                db, total=voting_total).start()
            state['epoch'] = new_epoch
            state['zxid_fn'] = lambda db=db: db.zxid
            store = None
            remote = None
            led_db = None
            peer.note_leading(svc.port)
            if server is None:
                srv = ZKServer(db, port=client_port,
                               member='m%d' % (member_id,),
                               blackbox_dir=wal_dir)
                srv.quorum = svc.quorum
                announce(await srv.start())
            else:
                server.quorum = svc.quorum
                server.repoint(db, role='leader')
            svc.quorum.trace = getattr(db, 'trace', None)
            # OS-tier fencing of DIRECT client writes: once this
            # service learns it is deposed, every write through this
            # member bounces with EPOCH_FENCED (same check the
            # forwarded path applies)
            server.fence = (lambda s=svc: s.deposed)

            def _member_reconfig(phase, entry, q=svc.quorum,
                                 p=peer) -> None:
                # a reconfig committed while leading repoints the
                # quorum denominator and this peer's election total.
                # The OS tier's gate is count-based (follower tokens
                # are anonymous uuids): during a joint window it
                # holds the STRICTER of the two configs' majorities
                # by count; the in-process tier carries the full
                # named-set joint rule (server/replication.py).
                if db.voter_ids is None:
                    return
                n = len(db.voter_ids)
                if phase == 'joint' and db.old_voter_ids is not None:
                    n = max(n, len(db.old_voter_ids))
                q.total = n
                p.total = len(db.voter_ids)
            db.on_config_change = _member_reconfig
            server.elections += 1
            log.info('member %d leading at epoch %d (zxid %d)',
                     member_id, new_epoch, db.zxid)
            # lead until killed — or until the supersession watch
            # sees a standing leader at a higher epoch (this member
            # was partitioned away and deposed): fence, step down,
            # rejoin.  The poll period bounds how long a deposed
            # leader can keep acking direct writes.
            while True:
                await asyncio.sleep(LEAD_WATCH_S)
                sup = [r for r in await peer._poll()
                       if r[2] == 'leading' and r[3] > new_epoch]
                if sup:
                    svc.depose(max(r[3] for r in sup))
                    break
            await svc.stop()
            led_db = db
            peer.note_looking()
            await asyncio.sleep(redial.next_delay() / 1000.0)
            continue
        else:
            _lid, host, repl_port, lepoch = decision[1]
            if store is not None:
                have_zxid = store.zxid
                recovered = {'zxid': store.zxid, 'nodes': store.nodes}
                cur_epoch = remote.epoch if remote is not None \
                    else state['epoch']
                prev_sessions = store.leader.session_snapshot()
            elif led_db is not None:
                # a deposed ex-leader rejoining the current era: its
                # led state is the catch-up base (the successor holds
                # at least as much acked history — the vote rule —
                # and anything extra here was never acked under the
                # new epoch, so a snapshot bootstrap may discard it:
                # ZAB truncation semantics)
                have_zxid = led_db.zxid
                recovered = {'zxid': led_db.zxid,
                             'nodes': led_db.nodes}
                cur_epoch = led_db.epoch
                prev_sessions = led_db.session_snapshot()
            else:
                have_zxid = rec.zxid if (
                    rec.last_index or rec.snapshot_index >= 0) else None
                recovered = ({'zxid': rec.zxid, 'nodes': rec.nodes}
                             if have_zxid is not None else None)
                cur_epoch = rec.epoch
                prev_sessions = rec.sessions
            if remote is not None:
                remote.close()
            remote = RemoteLeader(host, repl_port,
                                  have_zxid=have_zxid,
                                  epoch=cur_epoch,
                                  observer=observer)
            # the durable session table this member already holds (a
            # mirror it served, a led era, or its recovered WAL)
            # seeds the new mirror handle — resync ships only the
            # tail, and a later promotion must keep these sessions
            remote.seed_sessions(prev_sessions)
            # the leader-lost latch is one-shot: arm it BEFORE the
            # connect so an EOF landing while the server below is
            # still starting cannot fire into a missing callback and
            # wedge this member 'following' a dead leader
            lost = asyncio.Event()
            remote.on_leader_lost = \
                lambda: loop.call_soon_threadsafe(lost.set)
            try:
                await remote.connect()
            except (OSError, ConnectionError, asyncio.TimeoutError,
                    TimeoutError):
                # the would-be leader died between poll and dial:
                # back off and re-enter the election loop
                remote.close()
                remote = None
                await asyncio.sleep(redial.next_delay() / 1000.0)
                continue
            redial.reset()
            store = RemoteReplicaStore(remote, lag=0.0,
                                       recovered=recovered)
            # a reconfig record arriving over replication repoints
            # this follower's election total live (count-based at
            # this tier; a joint window holds the stricter of the
            # two configs' majorities by count)
            store.on_config_applied = (
                lambda cfg, p=peer: setattr(
                    p, 'total',
                    max(len(cfg['voters']),
                        len(cfg.get('old_voters') or ()))))
            if not remote.resynced:
                # snapshot bootstrap: the on-disk history is stale
                # relative to the installed image — reset and
                # re-anchor (same dance as the static follower worker)
                if wal is not None:
                    wal.close()
                    wal = None
                reset_dir(wal_dir)
            if wal is None:
                wal = WriteAheadLog(wal_dir, sync=sync)
            wal.bind(store)
            wal.snapshot_gate = (
                lambda s=store, r=remote: s.applied == r.log_end())
            with remote._mirror_lock:
                for e in remote.log:
                    if entry_zxid(e) > wal.last_zxid:
                        wal.append(e)
                remote.wal = wal
                if remote.epoch > cur_epoch:
                    wal.append(('epoch', remote.epoch, wal.last_zxid))
                    wal.sync_for_flush()   # the fence must be durable
            if not remote.resynced:
                wal.snapshot_now()
            state['epoch'] = remote.epoch or lepoch
            state['zxid_fn'] = lambda s=store: s.zxid
            led_db = None                 # rejoined the current era
            peer.note_following()
            member_role = 'observer' if observer else 'follower'
            if server is None:
                srv = await ZKServer(
                    remote, store=store, port=client_port,
                    member='m%d' % (member_id,),
                    blackbox_dir=wal_dir).start()
                srv.role = member_role
                announce(srv)
            else:
                # a follower's acks gate on its mirror WAL alone: the
                # quorum half belongs to the leader's RPC response
                server.quorum = None
                server.repoint(remote, store=store, role=member_role)
            # a follower at the current epoch is not fenced: stale-
            # epoch protection for its forwarded writes lives in the
            # RPC stamp (the service bounces them)
            server.fence = None
            server.elections += 1
            log.info('member %d following %s:%d at epoch %d',
                     member_id, host, repl_port, remote.epoch)
            await lost.wait()
            # push-channel EOF: jittered backoff, then re-elect —
            # every surviving follower does the same, decorrelated
            await asyncio.sleep(redial.next_delay() / 1000.0)

# ---------------------------------------------------------------------
# Process-tier campaign driver: the seeded OS-process election
# schedule.  Shared by ``zkstream_tpu_torch chaos --tier process`` and
# tests/test_torch_process_ensemble.py so the checks cannot drift.
# ---------------------------------------------------------------------

MEMBER_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             'member_worker.py')

#: bounded waits for the process tier (spawn + recovery + election)
PROC_READY_S = 45.0
PROC_LEADER_S = 45.0


class ProcMember:
    """One spawned member process and its fixed ports.
    ``observer=True`` spawns a non-voting read-serving member
    (``member_worker.py --observer``)."""

    def __init__(self, member_id: int, wal_dir: str,
                 client_port: int, election_port: int,
                 observer: bool = False):
        self.member_id = member_id
        self.wal_dir = wal_dir
        self.client_port = client_port
        self.election_port = election_port
        self.observer = observer
        self.proc = None
        #: the member's stderr, an anonymous temporary file: shown when
        #: the member never prints READY
        self.err = None

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def spawn(self, peers) -> 'ProcMember':
        import subprocess
        import sys
        args = [sys.executable, MEMBER_WORKER, str(self.member_id),
                self.wal_dir, str(self.client_port),
                str(self.election_port)]
        if self.observer:
            args.append('--observer')
        args += ['%d:127.0.0.1:%d%s'
                 % (m.member_id, m.election_port,
                    ':observer' if m.observer else '')
                 for m in peers if m.member_id != self.member_id]
        import tempfile
        if self.err is not None:
            self.err.close()
        self.err = tempfile.TemporaryFile()
        self.proc = subprocess.Popen(
            args, stdout=subprocess.PIPE, stderr=self.err, text=True)
        return self

    async def wait_ready(self, timeout: float = PROC_READY_S) -> None:
        loop = asyncio.get_running_loop()
        line = await asyncio.wait_for(
            loop.run_in_executor(None, self.proc.stdout.readline),
            timeout)
        assert line.startswith('READY '), (self.member_id, line,
                                           self.stderr_tail())

    def stderr_tail(self, limit: int = 4000) -> str:
        """The last ``limit`` bytes the member wrote to stderr (waits a
        few seconds for a dying member to finish writing)."""
        import subprocess
        if self.err is None:
            return ''
        if self.proc is not None:
            try:
                self.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                pass
        self.err.seek(0, os.SEEK_END)
        self.err.seek(max(0, self.err.tell() - limit))
        return self.err.read().decode('utf-8', 'replace')

    def kill(self) -> None:
        """SIGKILL: the OS severs every socket, RAM is gone."""
        import signal
        if self.alive():
            os.kill(self.proc.pid, signal.SIGKILL)
        if self.proc is not None:
            self.proc.wait()
            self.proc.stdout.close()
            self.proc = None
        if self.err is not None:
            self.err.close()
            self.err = None


async def _scrape_mntr(port: int, timeout: float = 2.0) -> dict:
    """Raw-TCP mntr scrape of one member -> {key: value}."""
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection('127.0.0.1', port), timeout)
    try:
        writer.write(b'mntr')
        await writer.drain()
        data = await asyncio.wait_for(reader.read(), timeout)
    finally:
        writer.close()
    out = {}
    for line in data.decode('utf-8', 'replace').splitlines():
        if '\t' in line:
            k, v = line.split('\t', 1)
            out[k] = v
    return out


async def _rcfg(port: int, line: str, timeout: float = 8.0) -> str:
    """One raw-TCP ``rcfg`` admin line against one member -> reply."""
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection('127.0.0.1', port), timeout)
    try:
        writer.write(('rcfg %s\n' % (line,)).encode())
        await writer.drain()
        data = await asyncio.wait_for(reader.read(), timeout)
    finally:
        writer.close()
    return data.decode('utf-8', 'replace')


async def find_leader(members, min_epoch: int = 0,
                      timeout: float = PROC_LEADER_S):
    """Poll the live members' mntr rows until one reports
    ``zk_member_role == 'leader'`` at ``zk_epoch >= min_epoch``.
    Returns ``(member_id, epoch)``; raises TimeoutError when no such
    leader stands inside the window."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for m in members:
            if not m.alive():
                continue
            try:
                rows = await _scrape_mntr(m.client_port)
            except (OSError, asyncio.TimeoutError, TimeoutError):
                continue
            if rows.get('zk_member_role') == 'leader':
                epoch = int(rows.get('zk_epoch', 0))
                if epoch >= min_epoch:
                    return m.member_id, epoch
        await asyncio.sleep(0.15)
    raise TimeoutError('no leader at epoch >= %d within %.0fs'
                       % (min_epoch, timeout))


async def run_process_schedule(seed: int, ops: int = 6,
                               members: int = 3, elections: int = 2,
                               generations: int = 2,
                               workdir: str | None = None,
                               clients: int | None = None,
                               observers: int = 0,
                               reconfig: bool = False,
                               cached: bool = False):
    """One seeded OS-process election schedule: spawn ``members``
    symmetric peer processes over per-member WAL dirs, drive a seeded
    workload THROUGH THE LEADER (quorum-commit makes its ack
    survivable), SIGKILL the elected leader ``elections`` times —
    each kill immediately after a freshly acked marker write, which
    must read back from the successor — (each survivor set must elect
    a successor at a strictly higher epoch, operator-free), then
    SIGKILL the WHOLE ensemble ``generations`` times — each
    generation must elect from recovered WALs alone and still hold
    every acked write.  Invariant
    7 (at-most-one-leader-per-epoch, epoch monotonicity) is checked
    over the recorded history; violations carry the seed, rerunnable
    via ``zkstream_tpu_torch chaos --tier process --seed N``.

    ``clients`` > 1 runs every workload phase as N CONCURRENT
    clients contending on a small shared key set, each op recorded
    as a two-sided interval (``History.invoke``/``settle``), and the
    schedule ends with the per-key WGL linearizability pass
    (analysis/linearize.py, invariant 9) pinned to the final key
    states read back through the elected leader — the OS-process
    half of the concurrent tier (``chaos --tier process --clients
    N``)."""
    import random
    import tempfile

    from ..analysis.linearize import check_linearizable
    from ..client import Client
    from ..io.faults import ScheduleResult, record_settle_error
    from ..io.invariants import (AMBIGUOUS_CODES, History,
                                 check_election, check_reconfig)
    from ..protocol.errors import ZKError, ZKProtocolError

    rng = random.Random('proc/%d' % (seed,))
    #: observer churn draws come from their OWN stream: attaching
    #: observers must not perturb the schedule existing seeds pin
    orng = random.Random('proc-obs/%d' % (seed,))
    #: reconfig victim draws likewise (``--reconfig`` joins the rerun
    #: key; existing pinned seeds see zero draws from this stream)
    prng = random.Random('proc-reconfig/%d' % (seed,))
    if reconfig and observers == 0:
        # the replace-voter swap needs a non-voting member to promote:
        # --reconfig implies at least one observer (part of the flag's
        # rerun-key semantics, like --observers itself)
        observers = 1
    res = ScheduleResult(seed=seed, tier='process',
                         clients=clients if clients else 1)
    h = History()
    root = workdir or tempfile.mkdtemp(prefix='zkproc-elect-')
    own_root = workdir is None
    total = members + observers
    ports = allocate_ports(2 * total)
    fleet = [ProcMember(i, os.path.join(root, 'm%d' % i),
                        ports[2 * i], ports[2 * i + 1],
                        observer=i >= members)
             for i in range(total)]
    expected: dict[str, bytes] = {}
    deleted: set[str] = set()

    def record_election(member_id: int, epoch: int) -> None:
        h.election(member_id, epoch)
        res.elections += 1

    async def fresh_client(leader_id: int) -> Client:
        """A client preferring the LEADER member: quorum-commit makes
        the leader's own ack survivable — it leaves only once a
        majority of mirrors has ingested the txn — so the schedule
        writes through the leader and asserts exactly that (the
        follower-routing workaround this schedule used to need is
        gone).  With observers attached the client runs with the
        read plane on (the ensemble tier's rule: `--observers` puts
        the distributed, zxid-gated read path under test here too)."""
        backends = [('127.0.0.1', m.client_port) for m in fleet
                    if m.alive() and m.member_id == leader_id]
        backends += [('127.0.0.1', m.client_port) for m in fleet
                     if m.alive() and m.member_id != leader_id]
        c = Client(servers=backends, shuffle_backends=False,
                   session_timeout=12000, op_timeout=3000,
                   seed=seed, read_distribution=observers > 0,
                   # --cached: the watch-backed cache plane rides
                   # the OS-process tier too (cache=False pins the
                   # knob off regardless of ZKSTREAM_CACHE)
                   cache='/' if cached else False,
                   connect_policy=BackoffPolicy(timeout=2000,
                                                retries=4, delay=100,
                                                cap=1000))
        c.start()
        await c.wait_connected(timeout=20)
        return c

    async def retrying(coro_fn, attempts=30, delay=0.25):
        last = None
        for _ in range(attempts):
            try:
                return await coro_fn()
            except ZKError as e:
                # a definite server verdict (NODE_EXISTS, NO_NODE,
                # BAD_VERSION, EPOCH_FENCED...) will not change on
                # retry — only the outcome-unknown family is worth
                # waiting out (io/invariants.py AMBIGUOUS_CODES)
                if e.code not in AMBIGUOUS_CODES:
                    raise
                last = e
                await asyncio.sleep(delay)
            except (ZKProtocolError, OSError) as e:
                last = e               # connection churn: retryable
                await asyncio.sleep(delay)
        raise last

    async def workload(phase: int, leader_id: int) -> None:
        c = await fresh_client(leader_id)
        try:
            for i in range(ops):
                res.ops += 1
                kind = rng.choice(('create', 'create', 'set', 'get'))
                path = '/p%d-%d' % (phase, i)
                try:
                    if kind == 'create':
                        data = b'd%d-%d' % (phase, i)
                        await retrying(
                            lambda p=path, d=data: c.create(p, d))
                        expected[path] = data
                        h.acked_create(path, data, 0)
                        res.acked += 1
                    elif kind == 'set' and expected:
                        p = rng.choice(sorted(expected))
                        data = b'v%d-%d' % (phase, i)
                        await retrying(
                            lambda p=p, d=data: c.set(p, d,
                                                      version=-1))
                        expected[p] = data
                        res.acked += 1
                    else:
                        if expected:
                            p = rng.choice(sorted(expected))
                            await retrying(lambda p=p: c.get(p))
                except (ZKError, ZKProtocolError) as e:
                    res.typed_errors += 1
                    log.info('workload op failed (typed): %s', e)
        finally:
            await c.close()

    #: the concurrent phases' shared, contended key set
    lin_keys = ('/lk0', '/lk1', '/lk2')

    async def concurrent_workload(phase: int, leader_id: int) -> None:
        """The ``clients`` > 1 workload phase: N concurrent clients
        over :data:`lin_keys`, every op an interval record.  No
        retry loop — a churn-felled attempt settles as its own
        outcome-unknown interval, exactly what the checker models."""

        async def one(ci: int) -> None:
            c = await fresh_client(leader_id)
            crng = random.Random('proc-client/%d/%d/%d'
                                 % (seed, phase, ci))
            spans = [None]
            c.on_op = lambda span: spans.__setitem__(0, span)
            # each phase's client is a FRESH session: the history's
            # client id is phase-qualified so the session-monotone
            # read check (check_session_reads) floors each session
            # separately instead of chaining floors across sessions
            # that share no lastZxidSeen carry
            hci = phase * clients + ci
            try:
                for i in range(ops):
                    res.ops += 1
                    kind = crng.choice(('create', 'set', 'set',
                                        'get', 'get'))
                    key = crng.choice(lin_keys)
                    tag = b'p%d-c%d-%d' % (phase, ci, i)
                    call = h.invoke(kind, key, client=hci,
                                    data=tag if kind != 'get'
                                    else None)
                    try:
                        if kind == 'create':
                            await asyncio.wait_for(
                                c.create(key, tag), 8)
                            span = spans[0]
                            h.settle(call, 'ok',
                                     zxid=span.zxid
                                     if span is not None else None)
                            res.acked += 1
                        elif kind == 'set':
                            stat = await asyncio.wait_for(
                                c.set(key, tag, version=-1), 8)
                            h.settle(call, 'ok', zxid=stat.mzxid,
                                     version=stat.version)
                            res.acked += 1
                        else:
                            got, stat = await asyncio.wait_for(
                                c.get(key), 8)
                            h.settle(call, 'ok', zxid=stat.mzxid,
                                     data=bytes(got),
                                     version=stat.version)
                    except (ZKError, ZKProtocolError) as e:
                        record_settle_error(res, h, call, e)
                    except (asyncio.TimeoutError, TimeoutError):
                        h.settle(call, 'unknown',
                                 error='HARD_BOUND')
            finally:
                await c.close()

        await asyncio.gather(*(one(ci) for ci in range(clients)))

    work = concurrent_workload if clients and clients > 1 \
        else workload

    async def verify(leader_id: int, context: str) -> None:
        c = await fresh_client(leader_id)
        try:
            await retrying(lambda: c.sync('/'))
            for path, data in sorted(expected.items()):
                if path in deleted:
                    continue
                try:
                    got, _stat = await retrying(
                        lambda p=path: c.get(p))
                except (ZKError, ZKProtocolError) as e:
                    res.violations.append(
                        '%s: acked create %s lost (%s)'
                        % (context, path, e))
                    continue
                if bytes(got) != data:
                    res.violations.append(
                        '%s: acked write %s holds %r, expected %r'
                        % (context, path, bytes(got), data))
        finally:
            await c.close()

    #: the schedule's view of the LOGICAL membership (member ids):
    #: starts at the spawn shape, moves with every applied reconfig.
    #: Spawn roles stay fixed — this tier is count-based (see
    #: run_member) — but quorum denominators and election totals
    #: follow these sets through the replicated CONTROL records.
    cfg_voters = sorted(range(members))
    cfg_observers = sorted(range(members, total))

    def _pick_swap(leader_id: int):
        """One replace-voter shape: a non-leader voter demotes to
        observer, an observer promotes into the voter set (sizes
        preserved, so every later quorum stays satisfiable)."""
        cands = [v for v in cfg_voters if v != leader_id]
        v = cands[prng.randrange(len(cands))]
        o = cfg_observers[prng.randrange(len(cfg_observers))]
        new_voters = sorted([x for x in cfg_voters if x != v] + [o])
        new_obs = sorted([x for x in cfg_observers if x != o] + [v])
        return v, o, new_voters, new_obs

    async def reconfig_round(leader_id: int, epoch: int) -> None:
        """One fenced replace-voter reconfiguration through the rcfg
        admin channel: ``apply`` lands the joint record, awaits its
        quorum, commits, awaits the final record — the process tier's
        analogue of the ensemble tier's forced reconfig step."""
        nonlocal cfg_voters, cfg_observers
        v, o, new_voters, new_obs = _pick_swap(leader_id)
        line = 'apply %s %s' % (','.join(map(str, new_voters)),
                                ','.join(map(str, new_obs)) or '-')
        try:
            reply = await asyncio.wait_for(
                _rcfg(fleet[leader_id].client_port, line), 20)
        except (OSError, asyncio.TimeoutError, TimeoutError) as e:
            res.violations.append(
                'rcfg apply (replace %d->%d) did not complete: %s'
                % (v, o, e))
            return
        if reply.startswith('applied'):
            version = int(reply.split('version=')[1].split()[0])
            cfg_voters, cfg_observers = new_voters, new_obs
            h.reconfig(version, 'final', epoch, voters=new_voters,
                       observers=new_obs)
            h.member_event('reconfig-replace-voter(%d->%d)'
                           % (v, o), o)
        elif reply.startswith('error'):
            # a legal fence refusal (one voter change per epoch) is
            # a recorded non-event, not a violation
            h.member_event('reconfig-refused(%s)'
                           % (reply.strip(),), v)
        else:
            res.violations.append(
                'rcfg apply (replace %d->%d) unexpected reply %r'
                % (v, o, reply))

    try:
        for m in fleet:
            m.spawn(fleet)
        for m in fleet:
            await m.wait_ready()
        leader_id, epoch = await find_leader(fleet, min_epoch=1)
        record_election(leader_id, epoch)

        # -- elected-leader kill loop: >= `elections` forced ---------
        for round_no in range(elections):
            await work(round_no, leader_id)
            if observers and orng.random() < 0.5:
                # observer churn (own RNG stream): SIGKILL one and
                # respawn it — it must recover its mirror WAL and
                # re-follow without ever standing in the election
                ob = fleet[members + orng.randrange(observers)]
                if ob.alive():
                    h.member_event('kill-observer', ob.member_id)
                    ob.kill()
                    ob.spawn(fleet)
                    await ob.wait_ready()
                    h.member_event('restart', ob.member_id)
            victim = next(m for m in fleet
                          if m.member_id == leader_id)
            # leader-killed-after-ack: one marker write THROUGH THE
            # LEADER, then SIGKILL it the instant the ack returns —
            # quorum-commit means the ack implies a majority of
            # mirrors holds the txn, so it must survive the election
            # and read back from the successor (verify below)
            c = await fresh_client(leader_id)
            try:
                path = '/killmark%d' % (round_no,)
                data = b'k%d' % (round_no,)
                await retrying(lambda: c.create(path, data))
                expected[path] = data
                h.acked_create(path, data, 0)
                res.acked += 1
            finally:
                await c.close()
            h.member_event('kill-leader-after-ack', leader_id)
            victim.kill()
            # the survivors elect with no operator; the dead member
            # respawns over its own WAL and must rejoin as follower
            leader_id, epoch = await find_leader(
                fleet, min_epoch=epoch + 1)
            record_election(leader_id, epoch)
            victim.spawn(fleet)
            await victim.wait_ready()
            h.member_event('restart', victim.member_id)
            await verify(leader_id, 'after election %d' % (round_no,))
            if reconfig and (round_no < elections - 1
                             or not generations):
                # one voter replace per freshly elected era (the
                # at-most-one-voter-change-per-epoch fence clears on
                # every leader kill above).  The LAST era's voter-
                # change budget is reserved for the mid-joint
                # SIGKILL below — same epoch, same fence.
                await reconfig_round(leader_id, epoch)
        await work(elections, leader_id)

        # -- full-ensemble SIGKILL -> election from recovered WALs --
        for gen in range(generations):
            pending = None
            if reconfig and gen == 0:
                # land the JOINT record only, then SIGKILL the whole
                # ensemble mid-window: recovery must finish the
                # reconfig from WAL CONTROL records alone (the new
                # leader's commit_reconfig on promotion) — or, if the
                # record never reached a durable majority, roll back
                # to the pre-propose config.  Either way the joint
                # window must not survive recovery.
                v, o, nv, no = _pick_swap(leader_id)
                line = 'propose %s %s' % (','.join(map(str, nv)),
                                          ','.join(map(str, no))
                                          or '-')
                try:
                    reply = await asyncio.wait_for(
                        _rcfg(fleet[leader_id].client_port, line), 20)
                except (OSError, asyncio.TimeoutError,
                        TimeoutError) as e:
                    res.violations.append(
                        'rcfg propose mid-joint failed: %s' % (e,))
                    reply = ''
                if reply.startswith('proposed'):
                    h.member_event('sigkill-mid-joint(%d->%d)'
                                   % (v, o), 'ensemble')
                    pending = (nv, no)
                elif reply.startswith('error'):
                    h.member_event('reconfig-refused(%s)'
                                   % (reply.strip(),), v)
            h.member_event('sigkill-all(gen %d)' % (gen,), 'ensemble')
            for m in fleet:
                m.kill()
            for m in fleet:
                m.spawn(fleet)
            for m in fleet:
                await m.wait_ready()
            prev = epoch
            leader_id, epoch = await find_leader(
                fleet, min_epoch=prev + 1)
            if epoch <= prev:
                res.violations.append(
                    'generation %d: epoch did not increase across '
                    'full-ensemble recovery (%d -> %d)'
                    % (gen, prev, epoch))
            record_election(leader_id, epoch)
            if reconfig:
                # the joint window must be resolved (gen 0), and the
                # resolved config must keep surviving every further
                # generation of full-ensemble SIGKILL
                try:
                    status = await asyncio.wait_for(
                        _rcfg(fleet[leader_id].client_port,
                              'status'), 20)
                except (OSError, asyncio.TimeoutError,
                        TimeoutError) as e:
                    status = ''
                    res.violations.append(
                        'generation %d: rcfg status unreadable '
                        'after recovery: %s' % (gen, e))
                if status and 'phase=final' not in status:
                    res.violations.append(
                        'generation %d: joint config survived '
                        'full-ensemble recovery (%r)'
                        % (gen, status.strip()))
                elif status and pending is not None:
                    version = int(
                        status.split('version=')[1].split()[0])
                    voters_csv = status.split('voters=')[1].split()[0]
                    got = sorted(int(x) for x in voters_csv.split(',')
                                 if x and x != '-')
                    if got == pending[0]:
                        cfg_voters, cfg_observers = pending
                        h.reconfig(version, 'final', epoch,
                                   voters=cfg_voters,
                                   observers=cfg_observers)
                        h.member_event(
                            'reconfig-recovered(v%d)' % (version,),
                            'ensemble')
                    elif got == cfg_voters:
                        h.member_event('reconfig-rolled-back',
                                       'ensemble')
                    else:
                        res.violations.append(
                            'generation %d: recovered voter set %s '
                            'matches neither the proposed %s nor '
                            'the prior %s config'
                            % (gen, got, pending[0], cfg_voters))
            await verify(leader_id,
                         'generation %d (recovered WALs)' % (gen,))
            # one more acked write per generation: the recovered
            # quorum must be writable, and the next generation must
            # carry this write too
            c = await fresh_client(leader_id)
            try:
                path, data = '/gen%d' % (gen,), b'g%d' % (gen,)
                await retrying(lambda: c.create(path, data))
                expected[path] = data
                h.acked_create(path, data, 0)
                res.acked += 1
            finally:
                await c.close()

        if clients and clients > 1:
            # invariant 9 over the concurrent phases: every shared
            # key's interval history must linearize, pinned to the
            # final state read back through the elected leader (the
            # writes survived generations of SIGKILL by now).  Only
            # a definite verdict pins a key: NO_NODE = absent, data
            # = present; a key whose read-back exhausted its retries
            # (connection churn) is left OUT of the mapping, which
            # check_linearizable treats as unconstrained — never as
            # absent, which would fabricate a lost-update finding.
            c = await fresh_client(leader_id)
            finals: dict = {}
            try:
                try:
                    await retrying(lambda: c.sync('/'))
                except (ZKError, ZKProtocolError, OSError):
                    pass               # a barrier, not an op
                for key in lin_keys:
                    try:
                        got, _stat = await retrying(
                            lambda k=key: c.get(k))
                        finals[key] = bytes(got)
                    except ZKError as e:
                        if e.code == 'NO_NODE':
                            finals[key] = None
                    except (ZKProtocolError, OSError):
                        pass               # unpinned, not absent
            finally:
                await c.close()
            res.violations.extend(check_linearizable(h, finals))
            # the session-monotone read gate's acceptance on THIS
            # tier too (analysis/linearize.py): a session must never
            # observe state older than it has already seen
            from ..analysis.linearize import check_session_reads
            res.violations.extend(check_session_reads(h))
        res.violations.extend(check_election(h))
        res.violations.extend(check_reconfig(h))
        if reconfig and not h.of_kind('reconfig'):
            res.violations.append(
                'reconfig schedule completed no membership change '
                '(every rcfg apply refused or rolled back)')
        if observers:
            # observers must never have stood: every recorded
            # election winner is a voter, and every live observer
            # still reports the observer role
            for r in h.of_kind('election'):
                if isinstance(r['member'], int) \
                        and r['member'] >= members:
                    res.violations.append(
                        'observer %s won an election at epoch %d '
                        '(observers must never stand)'
                        % (r['member'], r['epoch']))
            for ob in fleet[members:]:
                if not ob.alive():
                    continue
                try:
                    rows = await _scrape_mntr(ob.client_port)
                except (OSError, asyncio.TimeoutError, TimeoutError):
                    continue
                if rows.get('zk_member_role') != 'observer':
                    res.violations.append(
                        'member %d spawned as observer reports role '
                        '%r' % (ob.member_id,
                                rows.get('zk_member_role')))
            # read scale-out correctness: the acked tree must read
            # back through an OBSERVER too (sync barrier first — the
            # forwarded RPC piggyback is the catch-up)
            await verify(fleet[members].member_id,
                         'read-back through observer %d'
                         % (fleet[members].member_id,))
        return res
    except (TimeoutError, asyncio.TimeoutError) as e:
        res.violations.append('process schedule stalled: %s' % (e,))
        return res
    finally:
        for m in fleet:
            try:
                m.kill()
            except Exception:
                pass
        res.history = list(h.records)
        res.member_events = h.member_timeline()
        # black-box harvest (utils/blackbox.py): every member of this
        # tier — the SIGKILL'd ones especially — left a flight-
        # recorder ring in its wal_dir; lift the dead fleet's last
        # spans into member_rings before the root is torn down, so
        # the OS-process tier's --trace-out timeline has member rings
        # at all (its servers live in child processes, so the
        # in-process ring dump path never sees them)
        from ..utils.blackbox import harvest_spans
        for m in fleet:
            try:
                for key, spans in harvest_spans(m.wal_dir).items():
                    res.member_rings.setdefault(key, spans)
            except Exception:
                pass                  # salvage is best-effort
        if own_root:
            import shutil
            shutil.rmtree(root, ignore_errors=True)


async def run_process_campaign(base_seed: int, schedules: int,
                               ops: int = 6, progress=None,
                               elections: int | None = None,
                               clients: int | None = None,
                               observers: int | None = None,
                               reconfig: bool = False,
                               cached: bool = False):
    """Consecutive seeded process-tier schedules from ``base_seed``.
    ``elections`` overrides the per-schedule forced leader-kill count,
    ``clients`` > 1 makes every workload phase concurrent with
    the linearizability pass at the end, ``observers`` attaches N
    non-voting read-serving members with their own churn stream, and
    ``reconfig`` drives a fenced voter replace through the rcfg admin
    channel per elected era plus one full-ensemble SIGKILL mid-joint
    (all part of the rerun key, like the ensemble tier's flags)."""
    out = []
    for i in range(schedules):
        r = await run_process_schedule(
            base_seed + i, ops=ops,
            elections=elections if elections is not None else 2,
            clients=clients,
            observers=observers if observers is not None else 0,
            reconfig=reconfig, cached=cached)
        out.append(r)
        if progress is not None:
            progress(r)
    return out
