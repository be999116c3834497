"""Per-key WGL linearizability over two-sided chaos histories.

The invariant engine's first eight checks (io/invariants.py) judge
one-sided facts — an acked write exists, zxids never regress per
session.  What they cannot see is the bugs only CONCURRENT writers
expose: a lost update under quorum degrade, a stale read across
failover, an ack sequenced against the CommitBarrier in an order no
sequential execution explains.  This module is invariant 9: a
Wing&Gong-style linearizability search (the worklist form Lowe's
testing framework popularized — "WGL") over the *interval* records
the concurrent tier writes (``History.invoke``/``settle`` pairs),
checked per key against the sequential znode spec.

The consistency contract checked is ZooKeeper's real one, which this
ensemble implements today (README "Ensemble failover matrix"):

- **writes are linearizable.**  Every write routes through the one
  leader; per key — keys a MULTI touches merge into one component,
  the batch applying whole-or-not-at-all, each sub-op at its own
  zxid — the WGL search must find an order consistent with both
  real time (op A precedes op B iff A settled before B invoked) and
  the reply zxids (leader-sequenced: a later-invoked write acked at
  a lower zxid is a circular ack order no sequential execution
  explains), reaching the leader's final tree.
- **reads are prefix-consistent, not linearizable.**  A read may be
  served by a lagging follower, so it may legitimately observe a
  *stale* snapshot of its key — but never a forged one: the
  observed (data, version, mzxid) must be a snapshot some
  zxid-ordered write prefix actually produced, produced by a write
  that had been invoked by the time the read returned (no reading
  the future), and MULTI batches never tear (no snapshot exposes a
  strict sub-batch: sub-zxids are interior points no member state
  ever shows).  :func:`check_session_reads` layers the last rung —
  a session never observes state older than it has already seen —
  held by the zxid read gate (server/server.py
  ReadGate + the client read plane's header-zxid validation) and
  wired into ``check_history`` on both chaos tiers; the env-gated
  ungated path (``ZKSTREAM_NO_READ_GATE=1``) is the validator this
  rung exists to catch.
- **ambiguity** follows invariant 1 exactly: a call whose outcome is
  unknown (CONNECTION_LOSS / deadline / never settled) may linearize
  as applied at any point after its invocation, or be dropped
  entirely.  A call that definitely never applied (``status='fail'``)
  is excluded.

On failure the violation string carries a **minimal counterexample
window**: the linearized frontier at the deepest point the search
reached, the spec state there, and every pending op with the reason
it cannot linearize next — readable next to ``format_history(...,
columns=True)``'s per-client interleaving.

Entry points: :func:`check_linearizable` (wired into
``check_history`` as invariant 9; vacuous on histories with no
interval records), :func:`check_recovered_prefix` (the durability
composition: the crash-recovered tree must equal the zxid-ordered
replay prefix) and :func:`check_session_reads` (the read-plane
gate, wired into ``check_history`` and the process tier's
concurrent pass).  Rerun any failing seed with
``python -m zkstream_tpu_torch chaos --tier ensemble --clients N --seed
S``.
"""

from __future__ import annotations

import dataclasses
import math

#: Definite spec verdicts a settle may carry as ``status='error'``:
#: the op linearizes as a no-effect op yielding exactly this error.
SPEC_ERRORS = frozenset(('NO_NODE', 'NODE_EXISTS', 'BAD_VERSION'))

#: Mutating op names (the zxid-ordered ones).
_WRITES = frozenset(('create', 'set', 'set_data', 'delete', 'multi'))

#: Default node budget for one component's search.  The per-key
#: partition + zxid pruning keep real campaign histories orders of
#: magnitude under this (tools/bench_linearize.py guards the cost);
#: hitting it is reported as its own violation, never silent.
MAX_NODES = 250_000


def _b(x):
    """bytes-normalize: JSON-carried corpus histories hold str."""
    if isinstance(x, str):
        return x.encode('utf-8')
    return bytes(x) if x is not None else None


@dataclasses.dataclass
class IntervalOp:
    """One settled call, as the search consumes it."""

    call: int
    client: object
    op: str                     # create|set|delete|get|exists|multi
    path: str | None
    data: bytes | None          # argument payload (writes)
    version: int | None         # argument version (None/-1 = any)
    subs: list | None           # multi: [(op, path, data, version)]
    status: str                 # 'ok' | 'error' | 'unknown'
    error: str | None
    zxid: int | None            # reply zxid / observed stat.mzxid
    obs_data: bytes | None      # reads: observed payload
    obs_version: int | None     # observed stat.version
    invoke_t: int
    settle_t: float             # math.inf while outcome-unknown

    def keys(self) -> list[str]:
        if self.op == 'multi':
            return [s[1] for s in (self.subs or [])]
        return [self.path] if self.path else []

    def label(self) -> str:
        what = self.op if self.op != 'multi' else \
            'multi[%s]' % ','.join('%s %s' % (s[0], s[1])
                                   for s in (self.subs or []))
        bits = ['#%d' % self.call, 'c%s' % (self.client,), what]
        if self.path:
            bits.append(self.path)
        if self.version is not None and self.version >= 0:
            bits.append('v=%d' % self.version)
        bits.append(self.status if self.status != 'error'
                    else str(self.error))
        if self.zxid is not None:
            bits.append('z=%d' % self.zxid)
        return ' '.join(bits)


def intervals(history) -> list['IntervalOp']:
    """Pair the invoke/settle records of a history (a ``History`` or
    a plain record list, JSON-roundtripped corpora included) into
    :class:`IntervalOp` rows.  An invoke with no settle is
    outcome-unknown; ``status='fail'`` settles (definitely never
    applied) are dropped here."""
    records = getattr(history, 'records', history)
    out: dict[int, IntervalOp] = {}
    for r in records:
        if r['kind'] == 'invoke':
            subs = r.get('subs')
            out[r['call']] = IntervalOp(
                call=r['call'], client=r.get('client', 0),
                op=r['op'], path=r.get('path'),
                data=_b(r.get('data')), version=r.get('version'),
                subs=[(s[0], s[1], _b(s[2]),
                       s[3] if len(s) > 3 else None)
                      for s in subs] if subs is not None else None,
                status='unknown', error=None, zxid=None,
                obs_data=None, obs_version=None,
                invoke_t=r['t'], settle_t=math.inf)
        elif r['kind'] == 'settle':
            o = out.get(r['call'])
            if o is None:
                continue            # settle without invoke: ignore
            o.status = r['status']
            o.error = r.get('error')
            o.zxid = r.get('zxid')
            o.obs_data = _b(r.get('data'))
            o.obs_version = r.get('version')
            o.settle_t = r['t']
    return [o for o in out.values() if o.status != 'fail']


# ---------------------------------------------------------------------
# The sequential znode spec.  Per-key state is None (absent) or
# ``(data, version, mzxid)``; mzxid is None when the last effective
# write's zxid is unknown (an applied ambiguous op).
# ---------------------------------------------------------------------


def _apply_write(st, op: str, data, version, zxid):
    """One sub-op against one key's state: ``(outcome, new_state)``
    — outcome 'ok' or the spec error code (state unchanged then)."""
    versioned = version is not None and version >= 0
    if op == 'create':
        if st is not None:
            return 'NODE_EXISTS', st
        return 'ok', (data, 0, zxid)
    if op in ('set', 'set_data'):
        if st is None:
            return 'NO_NODE', st
        if versioned and version != st[1]:
            return 'BAD_VERSION', st
        return 'ok', (data, st[1] + 1, zxid)
    assert op == 'delete', op
    if st is None:
        return 'NO_NODE', st
    if versioned and version != st[1]:
        return 'BAD_VERSION', st
    return 'ok', None


def _try_linearize(o: IntervalOp, state: dict):
    """Attempt to linearize the WRITE ``o`` at ``state`` (a
    key->state dict for the component).  Returns ``(None,
    new_state)`` on success or ``(reason, None)`` when the op cannot
    linearize here.  Unknown-outcome ops succeed only when they
    APPLY with effect (the no-effect/error branch is identical to
    dropping them).  Reads never enter the search — they are
    prefix-consistent, validated against the snapshot logs by
    :func:`_check_reads`."""
    if o.op == 'multi':
        new = dict(state)
        outcome = 'ok'
        subs = o.subs or []
        # each sub-op runs through the exact single-op apply path
        # (server/store.py ``ZKDatabase.multi``), so each consumes
        # its OWN zxid; the batch reply carries the last one — sub i
        # of m committed at reply_zxid - (m - 1 - i)
        m = len(subs)
        for i, (sub, path, data, version) in enumerate(subs):
            z = o.zxid - (m - 1 - i) if o.zxid is not None else None
            outcome, st = _apply_write(new.get(path), sub, data,
                                       version, z)
            if outcome != 'ok':
                break
            new[path] = st
        if o.status == 'error':
            if outcome != 'ok':
                return None, state       # rejected whole: no effect
            return 'spec applies the whole batch, op was ' \
                'rejected', None
        if outcome != 'ok':
            if o.status == 'unknown':
                return 'no effect', None
            return 'spec rejects the batch (%s)' % (outcome,), None
        return None, new
    # single-key write
    outcome, st = _apply_write(state.get(o.path), o.op, o.data,
                               o.version, o.zxid)
    if o.status == 'error':
        if outcome == o.error:
            return None, state           # definite verdict, no effect
        return ('spec says %s, op observed %s'
                % (outcome, o.error)), None
    if outcome != 'ok':
        if o.status == 'unknown':
            return 'no effect', None
        return 'spec says %s, op was acked ok' % (outcome,), None
    new = dict(state)
    new[o.path] = st
    if o.status == 'ok' and o.obs_version is not None \
            and st is not None and st[1] != o.obs_version:
        return ('spec version would be %d, reply stat said %d'
                % (st[1], o.obs_version)), None
    return None, new


# ---------------------------------------------------------------------
# Component partition + the WGL search.
# ---------------------------------------------------------------------


def _components(ops: list[IntervalOp]) -> list[list[IntervalOp]]:
    """Partition ops by key, keys unioned across MULTI batches."""
    parent: dict[str, str] = {}

    def find(k: str) -> str:
        while parent.setdefault(k, k) != k:
            parent[k] = parent[parent[k]]
            k = parent[k]
        return k

    for o in ops:
        keys = o.keys()
        for k in keys[1:]:
            parent[find(k)] = find(keys[0])
    groups: dict[str, list[IntervalOp]] = {}
    for o in ops:
        keys = o.keys()
        if not keys:
            continue
        groups.setdefault(find(keys[0]), []).append(o)
    return [sorted(g, key=lambda o: o.invoke_t)
            for _, g in sorted(groups.items())]


def _state_key(state: dict, keys: tuple) -> tuple:
    return tuple(state.get(k) for k in keys)


#: A key the caller could not read back definitively: its final
#: state places no constraint on the linearization (plain-mapping
#: ``db`` only — a real database's absence IS definitive).
_UNPINNED = object()


def _final_state(db, key: str):
    """The final data for ``key`` from a ZKDatabase-like (``.nodes``
    of objects with ``.data``), or a plain ``{path: bytes|None}``
    mapping; None = absent, a key MISSING from a plain mapping =
    :data:`_UNPINNED` (unconstrained)."""
    if db is None:
        return None
    nodes = getattr(db, 'nodes', None)
    if nodes is not None:
        node = nodes.get(key)
        return None if node is None else bytes(node.data)
    if key not in db:
        return _UNPINNED
    return _b(db.get(key))


def _no_effect(o: IntervalOp) -> bool:
    """Search ops that never change the spec state: definite
    spec-error verdicts (the op linearizes as a no-op yielding the
    error — a write's verdict comes from the leader, so it carries
    full real-time force, unlike a follower-served read)."""
    return o.status == 'error'


def _search(ops: list[IntervalOp], finals: dict | None,
            max_nodes: int):
    """WGL over one component.  Returns ``None`` when a linearization
    exists, else a dict describing the deepest stuck point (or the
    exhausted budget).

    Two prunings keep this flat on real histories (``make
    bench-linearize`` guards the cost):

    - **zxid order**: completed-ok writes are leader-sequenced, so
      only the one with the minimal remaining zxid may linearize
      next — write placement never branches;
    - **greedy no-effect commits**: a candidate no-effect op that
      matches the current state can be committed immediately without
      losing completeness.  Proof sketch: a candidate has no
      remaining op real-time-preceding it (its invoke predates every
      remaining response), so any valid linearization can be
      rewritten with this op moved to the front — it changes no
      state, every other op still sees the same spec.  A
      non-matching no-effect op simply waits for the state to reach
      what it observed; it never branches either.

    Branching therefore comes only from outcome-unknown ops (apply
    now, or keep not applying) — exactly the irreducible ambiguity.
    """
    keys = tuple(sorted({k for o in ops for k in o.keys()}))
    completed = [o for o in ops if o.status in ('ok', 'error')]
    by_id = {o.call: o for o in ops}
    state0: dict = {}
    # DFS frames: (done frozenset, path tuple, state dict)
    stack = [(frozenset(), (), state0)]
    seen: set = set()
    nodes = 0
    best: dict = {'done': (), 'state': state0, 'reject': [],
                  'depth': -1}
    while stack:
        done, path, state = stack.pop()
        # greedily commit matching no-effect candidates (complete,
        # see above); loop because each commit can raise the bound
        progressed = True
        while progressed:
            progressed = False
            remaining = [o for o in completed if o.call not in done]
            if not remaining:
                break
            bound = min(o.settle_t for o in remaining)
            for o in remaining:
                if not _no_effect(o) or o.invoke_t >= bound:
                    continue
                why, _st = _try_linearize(o, state)
                if why is None:
                    done = done | {o.call}
                    path = path + (o.call,)
                    progressed = True
                    break
        mark = (done, _state_key(state, keys))
        if mark in seen:
            continue
        seen.add(mark)
        nodes += 1
        if nodes > max_nodes:
            return {'budget': nodes, 'keys': keys, 'ops': len(ops)}
        remaining = [o for o in completed if o.call not in done]
        if not remaining:
            if finals is None or all(
                    finals.get(k) is _UNPINNED
                    or ((state.get(k) is None)
                        == (finals.get(k) is None)
                        and (state.get(k) is None
                             or state[k][0] == finals[k]))
                    for k in keys):
                return None
            reject = [('final tree', 'component state %s does not '
                       'reach the final tree %s'
                       % (_fmt_state(state, keys),
                          _fmt_finals(finals, keys)))]
        else:
            reject = []
        bound = min(o.settle_t for o in remaining) \
            if remaining else math.inf
        min_zxid = min((o.zxid for o in remaining
                        if o.op in _WRITES and o.status == 'ok'
                        and o.zxid is not None), default=None)
        cands = []
        for o in by_id.values():
            if o.call in done or o.invoke_t >= bound:
                continue
            if o.status == 'error':
                # greedy already commits these when they match; a
                # stuck verdict is window material, not a branch
                why, _st = _try_linearize(o, state)
                if why is not None:
                    reject.append((o.label(), why))
                continue
            cands.append(o)
        # unknown ops pushed first so the completed write (pushed
        # last) pops first: the happy path linearizes greedily
        cands.sort(key=lambda o: (o.status != 'unknown',
                                  -o.invoke_t))
        for o in cands:
            if o.status == 'ok' and o.op in _WRITES \
                    and o.zxid is not None and min_zxid is not None \
                    and o.zxid > min_zxid:
                reject.append((o.label(),
                               'zxid %d cannot precede pending '
                               'zxid %d' % (o.zxid, min_zxid)))
                continue
            why, new = _try_linearize(o, state)
            if why is not None:
                if o.status != 'unknown':
                    reject.append((o.label(), why))
                continue
            stack.append((done | {o.call}, path + (o.call,), new))
        if len(path) > best['depth'] and (remaining or reject):
            best = {'done': path, 'state': state,
                    'reject': reject, 'depth': len(path)}
    best.update(keys=keys, ops=len(ops), by_id=by_id)
    return best


def _fmt_state(state: dict, keys: tuple) -> str:
    bits = []
    for k in keys:
        st = state.get(k)
        if st is None:
            bits.append('%s=absent' % (k,))
        else:
            bits.append('%s=%r v%d%s'
                        % (k, st[0], st[1],
                           '' if st[2] is None else ' z=%d'
                           % (st[2],)))
    return '{%s}' % ', '.join(bits)


def _fmt_finals(finals: dict | None, keys: tuple) -> str:
    if finals is None:
        return '(unconstrained)'
    return '{%s}' % ', '.join(
        '%s=%s' % (k, '?' if finals.get(k) is _UNPINNED
                   else 'absent' if finals.get(k) is None
                   else repr(finals[k])) for k in keys)


def _format_window(stuck: dict) -> str:
    """Render the minimal counterexample window: the frontier at the
    deepest point the search reached, the spec state there, and each
    pending op with why it cannot linearize next."""
    if 'budget' in stuck:
        return ('search budget exceeded (%d nodes over %d ops on '
                '%s) — not a proven violation; rerun with a larger '
                'max_nodes or shrink the schedule'
                % (stuck['budget'], stuck['ops'],
                   ','.join(stuck['keys'])))
    by_id = stuck['by_id']
    frontier = [by_id[c].label() for c in stuck['done'][-4:]]
    lines = ['no linearization over %d op(s) on %s'
             % (stuck['ops'], ','.join(stuck['keys']))]
    lines.append('  linearized %d; frontier: %s'
                 % (len(stuck['done']),
                    ' | '.join(frontier) if frontier else '(start)'))
    lines.append('  spec state: %s'
                 % _fmt_state(stuck['state'], stuck['keys']))
    for label, why in stuck.get('reject', [])[:6]:
        lines.append('  pending: %s — %s' % (label, why))
    return '\n'.join(lines)


# ---------------------------------------------------------------------
# Prefix-consistent reads: per-key snapshot logs from the
# zxid-ordered write prefix, and the validations layered on them.
# ---------------------------------------------------------------------


@dataclasses.dataclass
class _Snap:
    """One snapshot a zxid-ordered write prefix produced for a key:
    the key held ``(data, version)`` for member states T in
    ``[zxid, end)`` — ``end`` is the next write to the key (interior
    zxids of a MULTI batch are no member state at all, so a sub-op's
    snapshot starts at its own zxid but the OBSERVABLE floor jumps
    to the batch end; :func:`check_session_reads` uses ``batch_end``
    for exactly that).  ``absent`` covers the initial state and
    post-delete windows."""

    zxid: int
    absent: bool
    data: bytes | None
    version: int | None          # None once unknown writes blur it
    end: float                   # next write's zxid, or +inf
    batch_end: int | None        # MULTI: the batch's last sub zxid
    invoke_t: int                # producing write's invocation


def _write_events(ops: list[IntervalOp]):
    """Flatten completed-ok writes into per-key (zxid, op, data,
    producing-op) events, MULTI subs at their own zxids."""
    events: list[tuple] = []
    for o in ops:
        if o.status != 'ok' or o.op not in _WRITES \
                or o.zxid is None:
            continue
        if o.op == 'multi':
            subs = o.subs or []
            m = len(subs)
            for i, (sub, path, data, _version) in enumerate(subs):
                events.append((o.zxid - (m - 1 - i), sub, path,
                               data, o.zxid, o))
        else:
            events.append((o.zxid, o.op, o.path, o.data, None, o))
    events.sort(key=lambda e: e[0])
    return events


def _snapshot_logs(ops: list[IntervalOp]):
    """``(logs, fuzzy)``: per-key :class:`_Snap` lists from the
    completed-ok writes, and the set of keys an outcome-unknown (or
    zxid-less) write may also have touched — their version chains
    and snapshot completeness can no longer be trusted exactly."""
    logs: dict[str, list[_Snap]] = {}
    fuzzy: set[str] = set()
    for o in ops:
        if o.op in _WRITES and (o.status == 'unknown'
                                or (o.status == 'ok'
                                    and o.zxid is None)):
            fuzzy.update(o.keys())
    for z, op, path, data, batch_end, src in _write_events(ops):
        log = logs.setdefault(path, [
            _Snap(0, True, None, None, math.inf, None, -1)])
        prev = log[-1]
        prev.end = z
        if op == 'delete':
            snap = _Snap(z, True, None, None, math.inf, batch_end,
                         src.invoke_t)
        elif op == 'create':
            snap = _Snap(z, False, data, 0, math.inf, batch_end,
                         src.invoke_t)
        else:                        # set / set_data
            ver = None if (prev.absent or prev.version is None
                           or path in fuzzy) \
                else prev.version + 1
            snap = _Snap(z, False, data, ver, math.inf, batch_end,
                         src.invoke_t)
        log.append(snap)
    return logs, fuzzy


def _match_read(r: IntervalOp, logs: dict, fuzzy: set,
                unknown_writes: list):
    """Validate one ok/NO_NODE read against the snapshot logs.
    Returns ``(None, snap)`` on success (``snap`` may be None when
    the read was excused by an ambiguous write) or a reason
    string."""
    k = r.path
    log = logs.get(k, [_Snap(0, True, None, None, math.inf, None,
                             -1)])
    blurred = k in fuzzy

    def excused() -> bool:
        # an outcome-unknown write may have produced what was seen
        for o in unknown_writes:
            if k not in o.keys():
                continue
            if r.status == 'error':
                if o.op == 'delete' or o.op == 'multi':
                    return True
            elif r.obs_data is None or o.op == 'multi' \
                    or o.data == r.obs_data:
                return True
        return False

    if r.status == 'error':          # observed NO_NODE
        if any(s.absent for s in log) or excused():
            return None, None
        return ('no write prefix ever leaves %s absent, op '
                'observed NO_NODE' % (k,)), None
    if r.zxid is not None:
        snap = next((s for s in log if s.zxid == r.zxid
                     and not s.absent), None)
        if snap is None:
            if excused():
                return None, None
            return ('observed mzxid %d matches no write on %s'
                    % (r.zxid, k)), None
        if r.op == 'get' and r.obs_data is not None \
                and snap.data != r.obs_data:
            if excused():
                return None, None
            return ('snapshot at mzxid %d holds %r, op observed %r'
                    % (r.zxid, snap.data, r.obs_data)), None
        if r.obs_version is not None and snap.version is not None \
                and not blurred and snap.version != r.obs_version:
            return ('snapshot at mzxid %d is version %d, op '
                    'observed %d' % (r.zxid, snap.version,
                                     r.obs_version)), None
        if snap.invoke_t >= r.settle_t:
            return ('observed the write at zxid %d before it was '
                    'invoked (reply settled at t=%d, write invoked '
                    't=%d)' % (r.zxid, r.settle_t,
                               snap.invoke_t)), None
        return None, snap
    # no mzxid recorded: any matching snapshot (or excuse) will do
    for s in log:
        if s.absent:
            continue
        if r.op == 'get' and r.obs_data is not None \
                and s.data != r.obs_data:
            continue
        if r.obs_version is not None and s.version is not None \
                and not blurred and s.version != r.obs_version:
            continue
        if s.invoke_t < r.settle_t:
            return None, s
    if excused():
        return None, None
    return ('no write prefix produced the observed state '
            '(data %r, version %r)' % (r.obs_data,
                                       r.obs_version)), None


def _check_reads(ops: list[IntervalOp]) -> list[str]:
    """Prefix-consistency of every completed read: the observed
    (data, version, mzxid) must be a snapshot some zxid-ordered
    write prefix produced — stale is legal (a lagging follower may
    have served it), forged or future is not."""
    logs, fuzzy = _snapshot_logs(ops)
    unknown_writes = [o for o in ops if o.op in _WRITES
                      and o.status == 'unknown']
    out = []
    for r in ops:
        if r.op not in ('get', 'exists') \
                or r.status not in ('ok', 'error'):
            continue
        why, _snap = _match_read(r, logs, fuzzy, unknown_writes)
        if why is not None:
            out.append('linearizability: read %s has no '
                       'prefix-consistent explanation — %s'
                       % (r.label(), why))
    return out


def check_session_reads(history) -> list[str]:
    """The read-plane gate, wired into ``check_history``: a
    session never observes state older than what it has already
    seen.  The pool migrates sessions onto lagging followers and
    observers, and the zxid read gate (server/server.py ReadGate:
    every session carries a last-seen-zxid floor, a read on a member
    behind it blocks briefly or bounces; the client read plane adds
    a header-zxid validation on distributed reads) is what holds
    this rung; ``ZKSTREAM_NO_READ_GATE=1`` is the env-gated ungated
    validator this checker exists to catch.

    Per client, in completion order, a floor tracks the newest
    member state the session provably saw (write reply zxids, read
    mzxids — a MULTI sub observation jumps the floor to the batch
    END, its interior zxids being states no member ever shows).  A
    read whose snapshot window dies before the floor is a session
    view regression; keys blurred by outcome-unknown writes are
    skipped."""
    ops = intervals(history)
    if not ops:
        return []
    logs, fuzzy = _snapshot_logs(ops)
    unknown_writes = [o for o in ops if o.op in _WRITES
                      and o.status == 'unknown']
    floors: dict = {}
    out = []
    for r in sorted(ops, key=lambda o: o.settle_t):
        if r.status != 'ok':
            continue
        floor = floors.get(r.client, 0)
        if r.op in _WRITES:
            if r.zxid is not None:
                floors[r.client] = max(floor, r.zxid)
            continue
        if r.path in fuzzy:
            continue
        why, snap = _match_read(r, logs, fuzzy, unknown_writes)
        if why is not None or snap is None:
            continue                 # _check_reads' finding, not ours
        if snap.end <= floor:
            out.append(
                'session-reads: client %s observed %s at mzxid %d '
                '(stale window [%d, %s)) after its session had '
                'already seen zxid %d — the session view went '
                'backwards' % (r.client, r.path, snap.zxid,
                               snap.zxid,
                               '%d' % snap.end
                               if snap.end != math.inf else 'inf',
                               floor))
            continue
        seen = snap.batch_end if snap.batch_end is not None \
            else snap.zxid
        floors[r.client] = max(floor, seen)
    return out


def check_linearizable(history, db=None,
                       floor_zxid: int | None = None,
                       quorum_zxid: int | None = None,
                       max_nodes: int = MAX_NODES) -> list[str]:
    """Invariant 9: the write history admits a WGL linearization
    against the sequential znode spec per key (MULTI-linked keys
    searched as one component, batches atomic), and every read is
    prefix-consistent against the zxid-ordered write snapshots
    (stale is legal — follower reads — forged, torn or future is
    not; :func:`check_session_reads` adds the session-monotone rung
    separately).  ``db`` (the leader's final tree, or a plain
    ``{path: data}`` mapping) additionally pins the linearization's
    end state — an acked write silently dropped on a shared key
    surfaces here even when every read happened to miss it.
    ``floor_zxid``/``quorum_zxid`` demote acks exactly as invariant
    1 does (recovery checks: an ok write past the durable floor
    becomes outcome-unknown, never demoted at or under the quorum
    floor).  Histories with no interval records return []."""
    ops = intervals(history)
    if not ops:
        return []
    if floor_zxid is not None:
        for o in ops:
            if o.status == 'ok' and o.op in _WRITES \
                    and (o.zxid is None or o.zxid > floor_zxid) \
                    and not (quorum_zxid is not None
                             and o.zxid is not None
                             and o.zxid <= quorum_zxid):
                o.status = 'unknown'
    writes = [o for o in ops if o.op in _WRITES]
    out = []
    for comp in _components(writes):
        keys = sorted({k for o in comp for k in o.keys()})
        finals = None
        if db is not None:
            finals = {k: _final_state(db, k) for k in keys}
        stuck = _search(comp, finals, max_nodes)
        if stuck is not None:
            out.append('linearizability: %s' % _format_window(stuck))
    out.extend(_check_reads(ops))
    return out


def check_recovered_prefix(history, rdb) -> list[str]:
    """Durability composition for the concurrent tier: the crash-
    recovered tree must equal the spec replay of the completed-ok
    writes with zxid <= the recovered zxid, in zxid order (the WAL is
    a prefix — a contiguous tail dies with the page cache, never a
    middle record; no fsync floor is needed here, because a write
    with zxid under the recovered zxid is in the replayed prefix by
    construction).  Components containing an outcome-unknown write,
    or an ok write with no zxid, are skipped (the unknown write may
    or may not be in the log; strict equality would false-positive).
    Replay outcomes are themselves checked: an acked write the replay
    rejects is a circular ack order no recovery can explain."""
    ops = intervals(history)
    if not ops:
        return []
    out = []
    for comp in _components(ops):
        writes = [o for o in comp if o.op in _WRITES]
        if any(o.status == 'unknown' or
               (o.status == 'ok' and o.zxid is None)
               for o in writes):
            continue
        keys = sorted({k for o in comp for k in o.keys()})
        state: dict = {}
        replayed = [o for o in writes
                    if o.status == 'ok' and o.zxid <= rdb.zxid]
        replayed.sort(key=lambda o: o.zxid)
        bad = False
        for o in replayed:
            why, new = _try_linearize(o, state)
            if why is not None:
                out.append(
                    'linearizability: recovered replay rejects '
                    'acked %s — %s (ack order has no sequential '
                    'explanation)' % (o.label(), why))
                bad = True
                break
            state = new
        if bad:
            continue
        for k in keys:
            st = state.get(k)
            fin = _final_state(rdb, k)
            if (st is None) != (fin is None) or \
                    (st is not None and st[0] != fin):
                out.append(
                    'linearizability: recovered tree diverges from '
                    'the zxid-ordered replay at %s: replay says %s, '
                    'recovery holds %s'
                    % (k, 'absent' if st is None else repr(st[0]),
                       'absent' if fin is None else repr(fin)))
    return out
