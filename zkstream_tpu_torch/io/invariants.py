"""History-checked invariants for ensemble-tier chaos campaigns.

The transport-tier campaign (io/faults.py ``run_schedule``) checks a
handful of end-state facts inline.  The ensemble tier — member kills,
restarts, partitions, session migration — needs more: whether an
outcome is a bug depends on *when* it happened relative to failovers
and session lifecycle, so the campaign records every operation,
watch fire, member event and session edge into an append-only
:class:`History`, and :func:`check_history` replays it after the
schedule against the leader's final database.

Invariants (each one a ``check_*`` function, composed by
:func:`check_history`; every violation string stands alone so a
failing seed's report reads without the source):

1. **No acked-write loss across failover** — an acked create (with no
   later acked delete) exists with its exact data; an acked delete
   stays deleted; the newest acked set to the shared counter node is
   <= the final value (a later *unacked* set may have applied:
   at-least-once ambiguity).  An op that died with an outcome-unknown
   error (CONNECTION_LOSS / DEADLINE_EXCEEDED / PING_TIMEOUT after
   the request was sent) is recorded as *ambiguous* and weakens only
   the expectations it could have changed.
2. **Zxid monotonicity per session** — the reply zxids stamped on
   successful *write* completions (CREATE / SET_DATA / DELETE / SYNC)
   never decrease per session, in completion order.  Writes are
   sequenced by the single leader and the serving member catches its
   store up through the write before replying, so a decrease means a
   reply was misrouted or a session resumed against state older than
   it had already observed.
3. **Ephemeral lifetime** — an ephemeral node exists exactly while
   its owning session does: while the session is live it must be
   present (unless acked- or ambiguously deleted); once the leader
   confirms the session expired or closed it must be gone.
4. **Sequential numbering** — acked SEQUENTIAL creates under a parent
   get strictly increasing numbers in ack order, and the total of the
   gaps is covered by the ambiguous sequential creates on that parent
   (an outcome-unknown create may have consumed a number; nothing
   else may).
5. **Watch at-most-once per arm** — no watch event is delivered twice
   for the same change: per (path, kind) no duplicated zxid, and at
   most one 'deleted' per single-deletion path (re-arms over the same
   absence stay silent).
6. **Durable recovery** (:func:`check_durable_recovery`, the
   durability plane's invariant) — after a full-ensemble SIGKILL, the
   database recovered from the write-ahead log (server/persist.py:
   newest valid snapshot + replayed tail, torn final record
   tolerated) holds every unambiguously-acked write, with the same
   ambiguity rules as invariant 1.  Both chaos tiers run it against a
   crash image cut at an injector-chosen fsync window.
7. **Election safety** (:func:`check_election`, the coordination
   plane — server/election.py) — over the recorded election history:
   at most ONE leader is ever elected per epoch, and elected epochs
   strictly increase in history order.  A second winner at an epoch
   means the fencing token was forged or reused; a non-increasing
   epoch means a deposed leader's era could be mistaken for current.
   Invariants 1 and 6 run unchanged across elections — failover must
   not lose an acked write.
8. **Quorum-commit era** — three strengthenings: invariant
   1/6 take a ``quorum_zxid`` floor under which acks are NEVER
   demoted (a majority of mirrors ingested the txn before its ack
   left — server/replication.py QuorumGate);
   :func:`check_session_continuity` asserts a session that stayed
   inside its timeout across a full restart keeps its identity and
   its ephemerals (durable sessions, server/persist.py); and
   :func:`check_multi_atomic` asserts no MULTI batch is ever
   partially visible — in the live tree or across a torn-record
   recovery (one CRC frame per batch).
9. **Per-key linearizability** (analysis/linearize.py, the
   concurrent tier — io/faults.py ``run_concurrent_schedule``) —
   over the TWO-SIDED half of the history (:meth:`History.invoke` /
   :meth:`History.settle` interval records), every key's operations
   admit a Wing&Gong/Lowe-style linearization against the sequential
   znode spec, MULTI batches atomic across their keys, ambiguity
   rules exactly invariant 1's (an outcome-unknown op may linearize
   as applied or be dropped).  Histories with no interval records —
   every pre-concurrent-tier history — pass vacuously; the one-sided
   recorders below stay as the degenerate interval (invocation and
   response at the same history point), so invariants 1-8 run
   unchanged on old and new histories alike.

The history is plain data (a list of dicts) so it can ride a JSON
trace dump next to the span ring; :func:`format_history` renders the
member-event timeline for failure reports (``columns=True`` renders
the per-client interleaving of the interval records instead).
"""

from __future__ import annotations

#: Opcodes whose successful replies must carry monotone zxids per
#: session (leader-sequenced; the member catches up before replying).
WRITE_OPS = frozenset(('CREATE', 'SET_DATA', 'DELETE', 'SYNC'))

#: Error codes that leave a sent write's outcome unknown.
AMBIGUOUS_CODES = frozenset(('CONNECTION_LOSS', 'DEADLINE_EXCEEDED',
                             'PING_TIMEOUT'))


class History:
    """Append-only campaign history.  Every record is a dict with a
    ``kind`` and a monotonically increasing ``t`` (history order —
    completion order for ops, delivery order for watch fires)."""

    def __init__(self) -> None:
        self.records: list[dict] = []
        self._next_call = 0

    def _add(self, kind: str, **fields) -> dict:
        rec = {'kind': kind, 't': len(self.records)}
        rec.update(fields)
        self.records.append(rec)
        return rec

    # -- recorders --

    def invoke(self, op: str, path: str | None, client: int = 0,
               session_id: int = 0, data: bytes | None = None,
               version: int | None = None,
               subs: list | None = None) -> int:
        """Open one two-sided interval: the op is about to be SENT.
        Returns the call id :meth:`settle` closes the interval with.
        ``op`` is one of create/set/delete/get/exists/multi; ``subs``
        (multi only) is ``[(op, path, data, version)]``.  The interval
        pair is what invariant 9 (analysis/linearize.py) searches —
        an invoke with no settle is treated as outcome-unknown."""
        call = self._next_call
        self._next_call += 1
        self._add('invoke', call=call, op=op, path=path,
                  client=client, session_id=session_id, data=data,
                  version=version,
                  subs=list(subs) if subs is not None else None)
        return call

    def settle(self, call: int, status: str,
               zxid: int | None = None, data: bytes | None = None,
               version: int | None = None,
               error: str | None = None) -> dict:
        """Close the interval opened by :meth:`invoke`.  ``status``:
        ``'ok'`` (applied; ``zxid``/``data``/``version`` carry what
        the reply showed — reads record their observed payload here),
        ``'error'`` (a definite spec verdict: NO_NODE / NODE_EXISTS /
        BAD_VERSION — the op linearizes as a no-effect op yielding
        exactly that error), ``'fail'`` (definitely never applied —
        raised before send, or a typed fencing bounce; excluded from
        the search), or ``'unknown'`` (outcome-unknown: may linearize
        as applied or be dropped, invariant 1's ambiguity rule)."""
        return self._add('settle', call=call, status=status,
                         zxid=zxid, data=data, version=version,
                         error=error)

    def op(self, op: str, path: str | None, status: str,
           zxid: int | None = None, session_id: int = 0,
           error: str | None = None) -> dict:
        """One completed client op (every completion path)."""
        return self._add('op', op=op, path=path, status=status,
                         zxid=zxid, session_id=session_id, error=error)

    def acked_create(self, path: str, data: bytes, session_id: int,
                     ephemeral: bool = False,
                     sequential_parent: str | None = None,
                     zxid: int | None = None) -> dict:
        return self._add('ack', op='create', path=path, data=data,
                         session_id=session_id, ephemeral=ephemeral,
                         seq_parent=sequential_parent, zxid=zxid)

    def acked_delete(self, path: str, session_id: int,
                     zxid: int | None = None) -> dict:
        return self._add('ack', op='delete', path=path,
                         session_id=session_id, zxid=zxid)

    def acked_set(self, path: str, index: int,
                  session_id: int, zxid: int | None = None) -> dict:
        return self._add('ack', op='set', path=path, index=index,
                         session_id=session_id, zxid=zxid)

    def multi_batch(self, subs: list, session_id: int = 0,
                    zxid: int | None = None) -> dict:
        """One ATTEMPTED MULTI batch: ``subs`` is ``[(op, path,
        data)]`` (data None where the op carries none), recorded
        whatever the outcome — acked, rejected or outcome-unknown —
        because atomicity binds them all: invariant 8
        (:func:`check_multi_atomic`) demands the batch be visible
        whole or not at all."""
        return self._add('multi', subs=list(subs),
                         session_id=session_id, zxid=zxid)

    def ambiguous(self, op: str, path: str | None,
                  session_id: int = 0,
                  sequential_parent: str | None = None) -> dict:
        """A write whose request was sent but whose outcome is
        unknown (typed CONNECTION_LOSS / deadline / ping timeout)."""
        return self._add('ambig', op=op, path=path,
                         session_id=session_id,
                         seq_parent=sequential_parent)

    def watch_fire(self, path: str, event: str,
                   zxid: int | None) -> dict:
        return self._add('watch', path=path, event=event, zxid=zxid)

    def member_event(self, event: str, member: int | str) -> dict:
        """Ensemble-tier event: kill / restart / partition / heal /
        lag / migrate."""
        return self._add('member', event=event, member=member)

    def election(self, member: int | str, epoch: int) -> dict:
        """A completed leader election (server/election.py): ``member``
        won ``epoch``.  Invariant 7 replays these."""
        return self._add('election', member=member, epoch=epoch)

    def reconfig(self, version: int, phase: str, epoch: int,
                 voters, old_voters=None, observers=()) -> dict:
        """A committed membership-change record (store.py
        ``propose_reconfig``/``commit_reconfig``): config ``version``
        installed under leadership ``epoch``, ``phase`` 'joint'
        (C_old+C_new both govern) or 'final'.  The invariant-7
        extension (:func:`check_reconfig`) replays these."""
        return self._add('reconfig', version=version, phase=phase,
                         epoch=epoch, voters=tuple(voters),
                         old_voters=tuple(old_voters or ()),
                         observers=tuple(observers or ()))

    def session_event(self, event: str, session_id: int) -> dict:
        return self._add('session', event=event,
                         session_id=session_id)

    # -- selectors --

    def of_kind(self, kind: str) -> list[dict]:
        return [r for r in self.records if r['kind'] == kind]

    def member_timeline(self) -> list[dict]:
        return self.of_kind('member')


# ---------------------------------------------------------------------
# Invariant checkers.  Each returns a list of violation strings.
# ---------------------------------------------------------------------


def check_acked_durability(history: History, db,
                           floor_zxid: int | None = None,
                           quorum_zxid: int | None = None) -> list[str]:
    """Invariant 1: no acked write lost.  ``db`` is the leader
    ZKDatabase (reads bypass the wire; faults are stopped).

    ``floor_zxid`` (recovery checks, :func:`check_durable_recovery`):
    acks sequenced past the newest *known-durable* zxid — possible
    only when an fsync failed under them — are demoted to their
    outcome-unknown form instead of enforced; ``None`` enforces every
    ack.

    ``quorum_zxid`` (quorum-commit, server/replication.py
    QuorumGate): the strengthened form — an ack at or under the
    quorum floor is NEVER demoted, whatever the fsync floor says: a
    majority of mirrors ingested the txn before the ack left, so it
    must survive a leader death regardless of the leader's own disk.
    Only meaningful where quorum ack implies a surviving copy (the
    OS-process tier's mirror WALs; the in-process ensemble's replicas
    share the one crash image and keep floor semantics)."""
    from ..server.store import ZKOpError

    out: list[str] = []
    # final acked action per created path, in history order; the
    # ambiguity excuses are ORDERED — an acked op that postdates an
    # ambiguous one proves that ambiguity resolved, so it spends the
    # excuse
    created: dict[str, dict] = {}
    deleted: dict[str, dict] = {}
    ambig_delete: set[str] = set()
    ambig_create: set[str] = set()
    last_set: dict[str, int] = {}
    for r in history.records:
        if r['kind'] == 'ack':
            if floor_zxid is not None and (
                    r.get('zxid') is None or r['zxid'] > floor_zxid) \
                    and not (quorum_zxid is not None
                             and r.get('zxid') is not None
                             and r['zxid'] <= quorum_zxid):
                # past the durable floor: this ack's txn may not have
                # reached disk before the crash — demote, do not
                # enforce (it may legitimately be present OR absent)
                if r['op'] == 'create' and r.get('path'):
                    ambig_create.add(r['path'])
                elif r['op'] == 'delete':
                    ambig_delete.add(r['path'])
                continue
            if r['op'] == 'create':
                created[r['path']] = r
                deleted.pop(r['path'], None)
                ambig_delete.discard(r['path'])
            elif r['op'] == 'delete':
                deleted[r['path']] = r
                created.pop(r['path'], None)
                ambig_delete.discard(r['path'])
                ambig_create.discard(r['path'])
                # sets acked before this delete were deleted with the
                # node; they say nothing about a later re-create
                last_set.pop(r['path'], None)
            elif r['op'] == 'set':
                last_set[r['path']] = max(
                    last_set.get(r['path'], -1), r['index'])
        elif r['kind'] == 'ambig':
            if r['op'] == 'delete':
                ambig_delete.add(r['path'])
            elif r['op'] == 'create' and r.get('path'):
                ambig_create.add(r['path'])
    for path, rec in created.items():
        if path in deleted:
            continue
        try:
            got, _stat = db.get_data(path)
        except ZKOpError:
            if path in ambig_delete:
                continue            # an unacked delete may have landed
            if rec.get('ephemeral'):
                continue            # judged by check_ephemerals
            out.append('acked create %s lost (NO_NODE after campaign)'
                       % (path,))
            continue
        if path in last_set:
            continue                # value judged by the set check
        if rec['data'] is not None and bytes(got) != rec['data']:
            out.append('acked create %s holds %r, expected %r'
                       % (path, bytes(got), rec['data']))
    for path in deleted:
        try:
            db.get_data(path)
        except ZKOpError:
            continue
        if path in ambig_create:
            continue            # an unacked re-create may have landed
        out.append('acked delete %s did not stick' % (path,))
    for path, idx in last_set.items():
        if path in deleted:
            continue
        try:
            got, _stat = db.get_data(path)
            have = int(bytes(got).rsplit(b'v', 1)[1])
        except (ZKOpError, ValueError, IndexError):
            out.append('acked set v%d on %s lost: node unreadable'
                       % (idx, path))
            continue
        if have < idx:
            out.append('acked set v%d on %s lost: final value %r'
                       % (idx, path, bytes(got)))
    return out


def check_durable_recovery(history: History, db,
                           floor_zxid: int | None = None,
                           quorum_zxid: int | None = None) -> list[str]:
    """Invariant 6 (the durability plane, server/persist.py): after a
    full-ensemble SIGKILL, a database recovered from the newest valid
    snapshot plus the replayed WAL tail still holds every
    unambiguously-acked write.  ``db`` is the *recovered* tree (not
    the live leader's); the ambiguity rules are exactly invariant 1's
    — an outcome-unknown write may or may not have reached the log —
    plus the ``floor_zxid`` demotion for acks an fsync error left
    non-durable (``None`` = every ack was fsynced before it left,
    the sync='always'/'tick' barrier contract) and the
    ``quorum_zxid`` strengthening (acks at or under the quorum floor
    are never demoted — invariant 1's docstring says when that is
    sound).  Ephemeral absence is excused as in invariant 1 when the
    owning session died with the crash; a session recovered live
    keeps its ephemerals (:func:`check_session_continuity` asserts
    that side)."""
    out = ['durability: %s' % v
           for v in check_acked_durability(history, db,
                                           floor_zxid=floor_zxid,
                                           quorum_zxid=quorum_zxid)]
    top = 0
    for r in history.of_kind('ack'):
        z = r.get('zxid')
        if z and (floor_zxid is None or z <= floor_zxid
                  or (quorum_zxid is not None and z <= quorum_zxid)):
            top = max(top, z)
    if db.zxid < top:
        out.append('durability: recovered zxid %d is behind the '
                   'newest durable acked zxid %d (log tail lost)'
                   % (db.zxid, top))
    # a multi past the durable floor may legitimately be absent whole
    # — but never partial: the one-CRC-frame record guarantees torn
    # replay is all-or-nothing, and this asserts it
    out.extend('durability: %s' % v
               for v in check_multi_atomic(history, db))
    return out


def check_zxid_monotonic(history: History) -> list[str]:
    """Invariant 2: write-reply zxids never decrease per session."""
    out: list[str] = []
    last: dict[int, tuple[int, str]] = {}
    for r in history.of_kind('op'):
        if r['status'] != 'ok' or r['op'] not in WRITE_OPS:
            continue
        zxid = r.get('zxid')
        sid = r.get('session_id') or 0
        if zxid is None or not sid:
            continue
        prev = last.get(sid)
        if prev is not None and zxid < prev[0]:
            out.append(
                'zxid regression on session %016x: %s %s replied '
                'zxid %d after %s had replied %d'
                % (sid, r['op'], r.get('path'), zxid, prev[1],
                   prev[0]))
        if prev is None or zxid >= prev[0]:
            last[sid] = (zxid, '%s %s' % (r['op'], r.get('path')))
    return out


def check_ephemerals(history: History, db) -> list[str]:
    """Invariant 3: ephemerals live exactly as long as their owning
    session."""
    out: list[str] = []
    acked_del: set[str] = set()
    ambig_del: set[str] = set()
    ephemerals: list[dict] = []
    for r in history.records:
        if r['kind'] == 'ack' and r['op'] == 'create' \
                and r.get('ephemeral'):
            ephemerals.append(r)
        elif r['kind'] == 'ack' and r['op'] == 'delete':
            acked_del.add(r['path'])
        elif r['kind'] == 'ambig' and r['op'] == 'delete':
            ambig_del.add(r['path'])
    for rec in ephemerals:
        path, sid = rec['path'], rec['session_id']
        sess = db.sessions.get(sid)
        alive = (sess is not None and not sess.expired
                 and not sess.closed)
        exists = path in db.nodes
        if not alive and exists:
            out.append(
                'ephemeral %s outlived its session %016x (confirmed '
                '%s)' % (path, sid,
                         'expired' if sess is None or sess.expired
                         else 'closed'))
        elif alive and not exists and path not in acked_del \
                and path not in ambig_del:
            out.append(
                'ephemeral %s vanished while its session %016x is '
                'still live' % (path, sid))
        elif exists and db.nodes[path].ephemeral_owner != sid:
            out.append(
                'ephemeral %s owned by %016x, expected %016x'
                % (path, db.nodes[path].ephemeral_owner, sid))
    return out


def _seq_number(path: str) -> int:
    return int(path[-10:])


def check_sequential(history: History) -> list[str]:
    """Invariant 4: per parent, acked sequential numbers strictly
    increase, and every gap is covered by an ambiguous create
    *recorded before the ack that reveals the gap* — ops complete in
    issue order, so an ambiguous create recorded later could only
    have consumed a higher number and must not excuse an earlier
    loss."""
    out: list[str] = []
    prev: dict[str, int] = {}        # parent -> last acked number
    avail: dict[str, int] = {}       # parent -> unspent ambig creates
    for r in history.records:
        parent = r.get('seq_parent')
        if parent is None:
            continue
        if r['kind'] == 'ambig' and r['op'] == 'create':
            avail[parent] = avail.get(parent, 0) + 1
        elif r['kind'] == 'ack' and r['op'] == 'create':
            num = _seq_number(r['path'])
            last = prev.get(parent)
            if last is not None and num <= last:
                out.append(
                    'sequential numbering under %s not increasing: '
                    '%d acked after %d' % (parent, num, last))
                continue
            gap = num - (last + 1 if last is not None else 0)
            have = avail.get(parent, 0)
            if gap > have:
                out.append(
                    'sequential gap under %s: number(s) %s missing '
                    'before acked %d with only %d prior ambiguous '
                    'create(s) to have consumed them'
                    % (parent,
                       list(range((last + 1 if last is not None
                                   else 0), num)), num, have))
            else:
                avail[parent] = have - gap
            prev[parent] = num
    return out


def check_watch_once(history: History) -> list[str]:
    """Invariant 5: each watch delivers a given change at most once."""
    out: list[str] = []
    seen: dict[tuple[str, str], set[int]] = {}
    deleted_fires: dict[str, int] = {}
    for r in history.of_kind('watch'):
        path, event, zxid = r['path'], r['event'], r.get('zxid')
        if zxid is None:
            if event == 'deleted':
                deleted_fires[path] = deleted_fires.get(path, 0) + 1
            continue
        zset = seen.setdefault((path, event), set())
        if zxid in zset:
            out.append('duplicated %s watch fire for %s at zxid %d'
                       % (event, path, zxid))
        zset.add(zxid)
    for path, n in deleted_fires.items():
        if n > 1:
            out.append('%d deleted fires for %s (deleted at most '
                       'once)' % (n, path))
    return out


def check_session_continuity(live_sessions: dict, db) -> list[str]:
    """Invariant 8a (durable sessions, server/persist.py): a session
    that stayed inside its timeout across a full restart keeps its
    identity AND its ephemerals.  ``live_sessions`` is the
    pre-restart truth, ``{sid: set(ephemeral paths)}`` captured while
    the sessions were live; ``db`` the recovered database."""
    out: list[str] = []
    for sid, paths in live_sessions.items():
        sess = db.sessions.get(sid)
        if sess is None or sess.expired or sess.closed:
            out.append(
                'session %016x did not survive restart inside its '
                'timeout (%s)' % (sid,
                                  'missing' if sess is None else
                                  'expired' if sess.expired
                                  else 'closed'))
            continue
        for path in sorted(paths):
            node = db.nodes.get(path)
            if node is None:
                out.append(
                    'ephemeral %s of surviving session %016x lost '
                    'across restart' % (path, sid))
            elif node.ephemeral_owner != sid:
                out.append(
                    'ephemeral %s re-owned across restart: %016x, '
                    'expected %016x' % (path, node.ephemeral_owner,
                                        sid))
            elif path not in sess.ephemerals:
                out.append(
                    'ephemeral %s missing from recovered session '
                    '%016x ephemeral set' % (path, sid))
    return out


def check_multi_atomic(history: History, db) -> list[str]:
    """Invariant 8b (MULTI, server/store.py ``ZKDatabase.multi``): no
    partial batch is ever visible — for each acked multi, either every
    sub-effect is present in the final tree or none is (a torn multi
    record replays atomically or not at all).  Sub-effects are judged
    by (op, path, data); the caller keeps batch paths unmutated
    outside their batch, as the seeded scenarios do."""
    out: list[str] = []
    for r in history.of_kind('multi'):
        vis: list[bool] = []
        for op, path, data in r['subs']:
            node = db.nodes.get(path)
            if op == 'create':
                vis.append(node is not None and (
                    data is None or bytes(node.data) == data))
            elif op == 'delete':
                vis.append(node is None)
            elif op == 'set_data':
                vis.append(node is not None
                           and bytes(node.data) == data)
        if any(vis) and not all(vis):
            missing = [r['subs'][i][1] for i, v in enumerate(vis)
                       if not v]
            out.append(
                'multi batch (t=%d, %d ops) partially visible: '
                'effect(s) missing at %s — a multi must apply whole '
                'or not at all' % (r['t'], len(vis), missing))
    return out


def check_election(history: History) -> list[str]:
    """Invariant 7: at most one elected leader per epoch, and elected
    epochs strictly increase in history order."""
    out: list[str] = []
    winners: dict[int, object] = {}
    prev: int | None = None
    for r in history.of_kind('election'):
        epoch, member = r['epoch'], r['member']
        if epoch in winners:
            # re-observing a standing leader (a scrape after a
            # restart) is fine; a DIFFERENT winner at the same epoch
            # means the fencing token was reused
            if winners[epoch] != member:
                out.append(
                    'two leaders elected at epoch %d: member %s and '
                    'member %s' % (epoch, winners[epoch], member))
        else:
            winners[epoch] = member
            if prev is not None and epoch <= prev:
                out.append(
                    'elected epoch not increasing: %d won after %d '
                    '(a deposed era could be mistaken for current)'
                    % (epoch, prev))
        prev = epoch if prev is None else max(prev, epoch)
    return out


def check_reconfig(history: History) -> list[str]:
    """Invariant 7 extension (README "Dynamic membership"): config
    versions strictly increase in history order, at most ONE
    voter-set change (joint record) lands per leadership epoch, and
    no joint window opens while another still stands.  The per-epoch
    fence is what makes a reconfig record safe to recover mid-joint:
    a deposed leader's half-finished change can never interleave
    with its successor's in the same epoch."""
    out: list[str] = []
    prev_version: int | None = None
    joint_by_epoch: dict[int, int] = {}
    open_joint: int | None = None
    for r in history.of_kind('reconfig'):
        v = r['version']
        if prev_version is not None and v <= prev_version:
            out.append(
                'config version not increasing: v%d recorded after '
                'v%d' % (v, prev_version))
        prev_version = v
        if r['phase'] == 'joint':
            if open_joint is not None:
                out.append(
                    'joint config v%d proposed while v%d still open '
                    '(two overlapping membership changes)'
                    % (v, open_joint))
            open_joint = v
            e = r['epoch']
            if e in joint_by_epoch:
                out.append(
                    'two voter-set changes in epoch %d: v%d and v%d '
                    '(at-most-one-change-per-epoch fence breached)'
                    % (e, joint_by_epoch[e], v))
            else:
                joint_by_epoch[e] = v
        else:
            open_joint = None
    return out


def check_history(history: History, db) -> list[str]:
    """Run every invariant against the history and the leader's
    final database; returns the combined violation list."""
    from ..analysis.linearize import (
        check_linearizable,
        check_session_reads,
    )

    out: list[str] = []
    out.extend(check_acked_durability(history, db))
    out.extend(check_zxid_monotonic(history))
    out.extend(check_ephemerals(history, db))
    out.extend(check_sequential(history))
    out.extend(check_watch_once(history))
    out.extend(check_election(history))
    out.extend(check_reconfig(history))
    out.extend(check_multi_atomic(history, db))
    # invariant 9: per-key WGL linearizability over the interval
    # records (vacuous on histories that carry none)
    out.extend(check_linearizable(history, db))
    # the session-monotone read rung (the read plane's acceptance):
    # a session never observes state older than it has
    # already seen — held by the zxid read gate (server/server.py
    # ReadGate + the client plane's header-zxid validation); the
    # env-gated ungated validator (ZKSTREAM_NO_READ_GATE=1) is what
    # this checker exists to catch
    out.extend(check_session_reads(history))
    return out


def format_history(history: 'History | list[dict]',
                   kinds=('member', 'session', 'election',
                          'reconfig'),
                   limit: int | None = None,
                   columns: bool = False) -> str:
    """Render the member-event (and session-edge) timeline for a
    failure report, oldest first.  Accepts a :class:`History` or a
    plain record list (``ScheduleResult.history``).

    ``columns=True`` renders the per-client interleaving instead:
    one column per client id, invoke (``op>``) and settle (``<st``)
    rows of the interval records in history order, member events in
    a trailing column — the view a linearizability counterexample is
    read against."""
    records = history.records if isinstance(history, History) \
        else history
    if columns:
        return _format_columns(records, limit=limit)
    rows = [r for r in records if r['kind'] in kinds]
    if limit is not None and len(rows) > limit:
        rows = rows[-limit:]
    lines = []
    for r in rows:
        if r['kind'] == 'member':
            lines.append('  t=%-4d member %-8s %s'
                         % (r['t'], r['member'], r['event']))
        elif r['kind'] == 'election':
            lines.append('  t=%-4d member %-8s ELECTED leader '
                         '(epoch %d)'
                         % (r['t'], r['member'], r['epoch']))
        elif r['kind'] == 'reconfig':
            old = (' old=%s' % (','.join(map(str, r['old_voters'])),)
                   if r['old_voters'] else '')
            lines.append('  t=%-4d config v%-7d RECONFIG %s '
                         'voters=%s%s (epoch %d)'
                         % (r['t'], r['version'], r['phase'],
                            ','.join(map(str, r['voters'])), old,
                            r['epoch']))
        else:
            lines.append('  t=%-4d session %016x %s'
                         % (r['t'], r['session_id'], r['event']))
    return '\n'.join(lines)


#: Column width of the per-client interleaving view.
_COL_W = 22


def _format_columns(records: list[dict],
                    limit: int | None = None) -> str:
    """The per-client column view behind ``format_history(...,
    columns=True)``: each interval record renders in its client's
    column (``set /k0 v=-1 >`` opening, ``< ok z=14`` closing,
    correlated by the ``#call`` prefix), member events in a trailing
    column, so concurrent overlap — the thing a linearizability
    counterexample hinges on — is visible by eye."""
    invokes = {r['call']: r for r in records
               if r['kind'] == 'invoke'}
    clients = sorted({r['client'] for r in invokes.values()})
    col = {c: i for i, c in enumerate(clients)}
    rows = [r for r in records
            if r['kind'] in ('invoke', 'settle', 'member')]
    if limit is not None and len(rows) > limit:
        rows = rows[-limit:]
    head = '  %-7s %s| member' \
        % ('t', ''.join(('client %-2s' % (c,)).ljust(_COL_W)
                        for c in clients))
    lines = [head]
    for r in rows:
        cells = [' ' * _COL_W] * len(clients)
        tail = ''
        if r['kind'] == 'member':
            tail = '%s %s' % (r['event'], r['member'])
        else:
            inv = invokes.get(r.get('call'))
            if r['kind'] == 'invoke':
                text = '#%d %s %s >' % (r['call'], r['op'],
                                        r.get('path') or '*')
                c = r['client']
            else:
                c = inv['client'] if inv is not None else None
                text = '< #%d %s' % (r['call'], r['status'])
                if r.get('zxid') is not None:
                    text += ' z=%d' % (r['zxid'],)
                if r.get('error'):
                    text += ' %s' % (r['error'],)
            if c in col:
                cells[col[c]] = text[:_COL_W - 1].ljust(_COL_W)
            else:
                # a settle whose invoke record is missing (e.g.
                # trimmed by ``limit``): never guess a column
                tail = text
        lines.append('  t=%-5d %s| %s'
                     % (r['t'], ''.join(cells), tail))
    return '\n'.join(lines)
