"""The watcher engine: per-path user-facing emitters backed by per-watch
re-arm state machines.

ZooKeeper watches are one-shot on the server: a notification consumes
the watch, so the client must re-issue the read (with ``watch=True``) to
re-arm it, de-duplicating the re-read against the last seen zxid.  This
module ports that loop faithfully (reference: lib/zk-session.js:482-1005,
including the state diagram at :616-674).

Watch-kind compatibility matrix (reference: lib/zk-session.js:496-526):
the protocol pretends existence and data watches are distinct, but older
ZK servers keep them in one list, so which user events fire for which
server notification varies by server version.  ``ZKWatcher.notify`` maps
conservatively — every event FSM that *might* have had its server-side
watch consumed gets notified so it re-arms, and the zxid dedup suppresses
the duplicate user-facing emits this can cause.

  Older ZK versions:           created  deleted  dataCh  childrenCh
    GET_DATA                      X        X       X
    EXISTS                        X        X       X
    GET_CHILDREN2                          X               X
  Newer ZK versions (>=3.5?):
    GET_DATA                               X       X
    EXISTS                        X        X
    GET_CHILDREN2                          X               X
"""

from __future__ import annotations

import random
import time

from ..utils.events import EventEmitter
from ..utils.fsm import FSM
from ..utils.logging import Logger
from .backoff import BackoffPolicy

METRIC_ZK_WATCH_REARM_LATENCY = 'zookeeper_watch_rearm_latency_ms'

#: Re-arm pacing after consecutive arm failures: base 5 ms doubling to
#: a 500 ms cap — well below any session timeout, so a watch is never
#: dark long, but enough to keep churn from spinning the FSM hot.
ARM_RETRY_POLICY = BackoffPolicy(delay=5, cap=500, factor=2.0)

#: Idle window after which an armed watch probes the server to check it
#: has not missed a wakeup (reference: lib/zk-session.js:27-36).
DOUBLECHECK_TIMEOUT = 4 * 3600 * 1000
DOUBLECHECK_RAND = 8 * 3600 * 1000


class LostWakeupError(RuntimeError):
    """The doublecheck probe found the zxid moved without a notification:
    the watch machinery missed an event.  Deliberately fatal — this is a
    crash-on-bug self-check (reference: lib/zk-session.js:916-919)."""


class ZKWatcher(EventEmitter):
    """The per-path emitter returned by ``session.watcher(path)``.  User
    events: 'created', 'deleted', 'dataChanged', 'childrenChanged'.
    Spins up at most three ZKWatchEvent FSMs (created+deleted collapse
    into one existence watch) (reference: lib/zk-session.js:527-614)."""

    def __init__(self, session, path: str):
        super().__init__()
        self.path = path
        self.session = session
        self.watch_events: dict[str, 'ZKWatchEvent'] = {}

    def events(self) -> list['ZKWatchEvent']:
        out = []
        for evt in ('createdOrDeleted', 'dataChanged', 'childrenChanged'):
            if evt in self.watch_events:
                out.append(self.watch_events[evt])
        return out

    def once(self, event, cb):
        raise NotImplementedError(
            'ZKWatcher does not support once() (use on)')

    def notify(self, evt: str) -> None:
        """Fan a server notification out to the event FSMs per the
        compatibility matrix; crash if nothing matched, because that
        means our model of ZK watch semantics is wrong and we cannot
        guarantee a working watcher (reference: lib/zk-session.js:556-593).
        """
        if evt == 'created':
            to_notify = ['createdOrDeleted', 'dataChanged']
        elif evt == 'deleted':
            to_notify = ['createdOrDeleted', 'dataChanged',
                         'childrenChanged']
        elif evt == 'dataChanged':
            to_notify = ['dataChanged', 'createdOrDeleted']
        elif evt == 'childrenChanged':
            to_notify = ['childrenChanged']
        else:
            raise ValueError('Unknown notification type: %s' % (evt,))
        notified = False
        for kind in to_notify:
            event = self.watch_events.get(kind)
            if event is not None and not event.is_in_state('disarmed'):
                event.notify()
                notified = True
        if not notified:
            # Crash-on-bug: escalate through the session's fatal path
            # (teardown + 'failed'/'expire' + loop exception handler by
            # default) so the failure is loud even with no handler
            # installed (reference throws: lib/zk-session.js:584-592).
            self.session.fatal_error(LostWakeupError(
                'Got notification for %s but have no matching events '
                'on %s' % (evt, self.path)))

    def on(self, evt: str, cb) -> 'ZKWatcher':
        first = self.listener_count(evt) < 1
        super().on(evt, cb)
        if evt != 'error' and first:
            self._arm_event(evt)
        return self

    def _arm_event(self, evt: str) -> None:
        if evt in ('deleted', 'created'):
            evt = 'createdOrDeleted'
        if evt not in self.watch_events:
            self.watch_events[evt] = ZKWatchEvent(
                self.session, self.path, self, evt)
        if self.watch_events[evt].is_in_state('disarmed'):
            self.watch_events[evt].arm()


class ZKPersistentWatcher(EventEmitter):
    """One persistent (ADD_WATCH, opcode 106) registration: the
    client-side half of the watch family the one-shot engine above
    never had.  No re-arm FSM — the server-side subscription survives
    fires, so this object is just the session-lifetime emitter plus
    the replay bookkeeping.

    User events, each emitted with ``(path, zxid)``:

    - ``'created'`` / ``'deleted'`` / ``'dataChanged'`` — for the
      registered node and, in recursive mode, every descendant;
    - ``'childrenChanged'`` — exact (non-recursive) mode only: a
      recursive subscriber sees the child's own CREATED/DELETED
      instead (upstream PERSISTENT_RECURSIVE semantics);
    - ``'resumed'`` — the session re-established and the server-side
      subscription was re-armed via SET_WATCHES2 replay.  Anything
      may have changed in the gap: a subscriber maintaining derived
      state (io/cache.py) must resync, not trust it;
    - ``'lost'`` — the owning session died for good (expired/closed);
      the registration is gone and must be re-created on a new
      session.

    Exact-mode registrations dedup on a monotone zxid: the replay
    catch-up nudge can restate an event the old connection already
    delivered.  Recursive mode interleaves many paths and stays
    dedup-free — duplicate delivery after a reconnect is part of its
    contract (subscribers resync on 'resumed' anyway)."""

    def __init__(self, session, path: str, recursive: bool):
        super().__init__()
        self.session = session
        self.path = path
        self.recursive = recursive
        self.last_zxid = 0

    def _notify(self, evt: str, path: str, zxid: int) -> None:
        if not self.recursive:
            if zxid <= self.last_zxid:
                return
            self.last_zxid = zxid
        self.emit(evt, path, zxid)

    def _resumed(self) -> None:
        self.emit('resumed')

    def _lost(self) -> None:
        self.emit('lost')


class ZKWatchEvent(FSM):
    """One watch's arm / re-arm loop (state diagram: reference
    lib/zk-session.js:616-674).  Lives as long as the session."""

    def __init__(self, session, path: str, emitter: ZKWatcher, evt: str):
        self.path = path
        self.session = session
        self.emitter = emitter
        self.evt = evt
        self.log = getattr(session, 'log', Logger()).child(
            component='ZKWatchEvent', path=path, event=evt)
        self.prev_zxid: int | None = None
        #: Paces re-arm retries: under injected churn the arming read
        #: can fail over and over while the session flaps between
        #: attached and detached; without a growing delay the
        #: wait_session -> wait_connected -> arming cycle becomes a
        #: hot loop that floods the dying connection with re-arm
        #: reads.  Shared jittered-backoff machinery (io/backoff.py);
        #: ``_arm_retry`` is the "last attempt failed" latch.
        self._arm_backoff = ARM_RETRY_POLICY.backoff()
        self._arm_retry = False
        #: (Re-)arm latency instrumentation: the arming read's
        #: round-trip, labelled by watch kind — the window a watch is
        #: dark after a notification consumed it server-side.
        collector = getattr(session, 'collector', None)
        self._rearm_latency = None
        if collector is not None:
            self._rearm_latency = collector.histogram(
                METRIC_ZK_WATCH_REARM_LATENCY,
                'Watch (re-)arm read round-trip latency, '
                'milliseconds, by watch event kind')
            self.bind_fsm_metrics(collector, 'ZKWatchEvent')
        #: True after 'deleted' was emitted for the node's current
        #: absence: re-arming an existence watch on a still-missing
        #: node (connection churn forces re-arms) must not re-emit
        #: 'deleted' for the same deletion.
        self._deleted_seen = False
        super().__init__('disarmed')

    def _arm_ok(self) -> None:
        self._arm_retry = False
        self._arm_backoff.reset()

    def _observe_rearm(self, t0: float) -> None:
        if self._rearm_latency is not None:
            self._rearm_latency.observe(
                (time.monotonic() - t0) * 1000.0, {'event': self.evt})

    def get_event(self) -> str:
        return self.evt

    def arm(self) -> None:
        self.emit('armAsserted')

    def notify(self) -> None:
        """A matching notification arrived.  Only meaningful when armed
        or resuming; in other states we are already mid-(re)arm
        (reference: lib/zk-session.js:703-711)."""
        # A server notification means the node genuinely changed, so
        # the deleted-emit latch no longer describes the current
        # absence: a create-then-delete pulse must re-report 'deleted'
        # from the re-arm read (only *churn-forced* re-arms — which
        # never come through here — stay suppressed).
        self._deleted_seen = False
        if self.is_in_state('armed') or self.is_in_state('resuming'):
            self.emit('notifyAsserted')

    def disconnected(self) -> None:
        """The session detached; if armed, we are on its auto-resume
        list (reference: lib/zk-session.js:722-730)."""
        if self.is_in_state('armed'):
            self.emit('disconnectAsserted')

    def resume(self) -> None:
        """Auto-resume (server-side SET_WATCHES re-arm) completed.  If a
        catch-up notification already moved us along, ignore it
        (reference: lib/zk-session.js:732-740)."""
        if self.is_in_state('resuming'):
            self.emit('resumeAsserted')

    # -- states --

    def state_disarmed(self, S) -> None:
        S.on(self, 'armAsserted', lambda: S.goto_state('wait_session'))

    def state_wait_session(self, S) -> None:
        if self.session.is_in_state('attached'):
            S.goto_state('wait_connected')
            return

        def on_state(state):
            if state == 'attached':
                S.goto_state('wait_connected')
        S.on(self.session, 'stateChanged', on_state)
        self.log.debug('deferring watcher arm until after reconnect')

    def state_wait_connected(self, S) -> None:
        conn = self.session.get_connection()
        if conn is None or not conn.is_in_state('connected'):
            # Do not bounce back synchronously: give the connection a
            # chance to finish its own transition this turn
            # (reference: lib/zk-session.js:781-790).
            S.immediate(lambda: S.goto_state('wait_session'))
            return
        if self._arm_retry:
            # Previous arming attempt(s) failed: pace the retry so
            # connection churn cannot spin this FSM hot.  The timer is
            # scope-bound — a disconnect mid-wait disposes it and the
            # normal wait_session path takes over.
            S.timeout(self._arm_backoff.next_delay(),
                      lambda: S.goto_state('arming'))
            return
        S.goto_state('arming')

    def state_arming(self, S) -> None:
        """Issue the read-with-watch; a valid reply (or certain errors)
        means the watch is armed (reference: lib/zk-session.js:803-888)."""
        conn = self.session.get_connection()
        if conn is None or not conn.is_in_state('connected'):
            # The connection died while a paced retry timer was
            # pending (state_wait_connected's check is stale by the
            # time the timer fires): back to waiting, don't throw.
            self._arm_retry = True
            S.immediate(lambda: S.goto_state('wait_session'))
            return
        arm_t0 = time.monotonic()
        req = conn.request(self.to_packet())

        def on_reply(pkt):
            if self.evt == 'createdOrDeleted':
                # EXISTS returned OK: the node exists.
                args = ('created', pkt['stat'])
                zxid = pkt['stat'].czxid
            elif self.evt == 'dataChanged':
                args = ('dataChanged', pkt['data'], pkt['stat'])
                zxid = pkt['stat'].mzxid
            elif self.evt == 'childrenChanged':
                args = ('childrenChanged', pkt['children'], pkt['stat'])
                zxid = pkt['stat'].pzxid
            else:
                raise ValueError('Unknown watcher event %s' % (self.evt,))
            # Emit only if the relevant zxid moved FORWARD since the
            # last emit: equality suppresses duplicate notifications
            # from the server watch-kind overlap (reference:
            # lib/zk-session.js:849-856), and an OLDER zxid is a
            # stale read — a churn-forced re-arm can land on a
            # lagging follower that has not applied a change this
            # watcher already delivered, and re-emitting the old
            # state would be a duplicate fire for a change the
            # watcher saw (the at-most-once invariant,
            # io/invariants.py check_watch_once).
            self._arm_ok()
            self._observe_rearm(arm_t0)
            self._deleted_seen = False
            if self.prev_zxid is not None and zxid <= self.prev_zxid:
                S.goto_state('armed')
                return
            EventEmitter.emit(self.emitter, *args)
            self.prev_zxid = zxid
            S.goto_state('armed')
        S.on(req, 'reply', on_reply)

        def on_error(err, *a):
            code = getattr(err, 'code', None)
            if code == 'PING_TIMEOUT':
                self._arm_retry = True
                S.goto_state('wait_session')
                return
            if self.evt == 'createdOrDeleted' and code == 'NO_NODE':
                # Existence watches arm fine on a missing node
                # (reference: lib/zk-session.js:865-874).  Emit
                # 'deleted' once per disappearance: churn-forced
                # re-arms over the same absence stay silent.
                self._arm_ok()
                self._observe_rearm(arm_t0)
                if not self._deleted_seen:
                    self._deleted_seen = True
                    EventEmitter.emit(self.emitter, 'deleted')
                S.goto_state('armed')
                return
            if code == 'NO_NODE':
                # Other watch kinds cannot attach to a missing node;
                # park until it is created.
                self._arm_ok()
                self._observe_rearm(arm_t0)
                S.goto_state('wait_node')
                return
            self._arm_retry = True
            self.log.debug('watcher attach failure (%s); will retry',
                           err)
            S.goto_state('wait_session')
        S.on(req, 'error', on_error)

    def state_wait_node(self, S) -> None:
        S.on(self.emitter, 'created',
             lambda *a: S.goto_state('wait_session'))

    def state_armed(self, S) -> None:
        S.on(self, 'notifyAsserted', lambda: S.goto_state('wait_session'))
        S.on(self, 'disconnectAsserted', lambda: S.goto_state('resuming'))
        dbl = round(DOUBLECHECK_TIMEOUT + random.random() * DOUBLECHECK_RAND)
        S.timeout(dbl, lambda: S.goto_state('armed.doublecheck'))

    def state_armed_doublecheck(self, S) -> None:
        """Probe EXISTS (no watch) and compare zxids; a moved zxid with
        no notification means we missed a wakeup — crash on the bug
        (reference: lib/zk-session.js:923-970).  Inherits armed's
        notify/disconnect transitions via the substate scope stack."""
        if not self.session.is_in_state('attached'):
            S.goto_state('armed')
            return
        conn = self.session.get_connection()
        if conn is None or not conn.is_in_state('connected'):
            S.goto_state('armed')
            return
        req = conn.request({'path': self.path, 'opcode': 'EXISTS',
                            'watch': False})

        def on_reply(pkt):
            if self.evt == 'createdOrDeleted':
                zxid = pkt['stat'].czxid
            elif self.evt == 'dataChanged':
                zxid = pkt['stat'].mzxid
            elif self.evt == 'childrenChanged':
                zxid = pkt['stat'].pzxid
            else:
                raise ValueError('Unknown watcher event %s' % (self.evt,))
            if self.prev_zxid is None or zxid > self.prev_zxid:
                # Crash-on-bug (see ZKWatcher.notify): fatal by
                # default, never a swallowed callback exception
                # (reference throws: lib/zk-session.js:916-919).
                # Only a zxid AHEAD of the last emit is a missed
                # wakeup; an older one is a stale read from a
                # lagging member (the next probe re-checks).
                self.session.fatal_error(LostWakeupError(
                    'ZKWatchEvent double-check failed: a ZK event '
                    'wakeup was missed, this is a bug'))
                return
            S.goto_state('armed')
        S.on(req, 'reply', on_reply)
        S.on(req, 'error', lambda err, *a: S.goto_state('armed'))

    def state_resuming(self, S) -> None:
        S.on(self, 'resumeAsserted', lambda: S.goto_state('armed'))
        S.on(self, 'notifyAsserted', lambda: S.goto_state('wait_session'))

    def to_packet(self) -> dict:
        opcode = {'createdOrDeleted': 'EXISTS',
                  'dataChanged': 'GET_DATA',
                  'childrenChanged': 'GET_CHILDREN2'}.get(self.evt)
        if opcode is None:
            raise ValueError('Unknown watcher event %s' % (self.evt,))
        return {'path': self.path, 'opcode': opcode, 'watch': True}
