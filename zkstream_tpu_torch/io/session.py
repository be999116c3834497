"""The durable session layer.

A ``ZKSession`` outlives any one TCP connection: it holds the protocol
state that makes a session resumable — sessionId, password, and the last
zxid seen — and attaches to whichever ``ZKConnection`` is currently live,
re-sending those credentials in the ConnectRequest so the server resumes
rather than recreates the session (reference: lib/zk-session.js:38-480).
That triple *is* the checkpoint/resume mechanism of this system; nothing
touches disk.

States: ``detached / attaching / attached / reattaching / closing /
expired / closed``.  ``reattaching`` implements live-session migration to
a more-preferred backend with revert-on-failure
(reference: lib/zk-session.js:265-339).
"""

from __future__ import annotations

import asyncio
import time

from ..protocol import consts
from ..protocol.errors import ZKProtocolError
from ..utils.events import EventEmitter
from ..utils.fsm import FSM
from ..utils.logging import Logger
from ..utils.metrics import Collector
from .backoff import BackoffPolicy
from .watcher import ZKPersistentWatcher, ZKWatcher

METRIC_ZK_NOTIFICATION_COUNTER = 'zookeeper_notifications'

#: NOTIFICATION wire type -> user-facing watcher event name.
_NOTIFICATION_EVENTS = {
    'CREATED': 'created',
    'DELETED': 'deleted',
    'DATA_CHANGED': 'dataChanged',
    'CHILDREN_CHANGED': 'childrenChanged',
}


class ZKSession(FSM):
    def __init__(self, timeout: int, collector: Collector | None = None,
                 log: Logger | None = None,
                 retry_policy: BackoffPolicy | None = None,
                 seed: int | None = None,
                 trace=None):
        # Child logger; sessionId accretes once the server assigns one
        # (reference: lib/zk-session.js:42-44,179-181).
        self.log = Logger(log).child(component='ZKSession')
        self.conn = None
        self.old_conn = None
        #: Wall-clock ms of the last packet; liveness = a packet within
        #: the session timeout (reference: lib/zk-session.js:77-87).
        self.last_pkt: float | None = None
        self.expiry_timer = EventEmitter()
        self._expiry_handle: asyncio.TimerHandle | None = None
        self._expiry_deadline = 0.0
        self._expiry_at = 0.0      # when the pending handle will fire
        self.watchers: dict[str, ZKWatcher] = {}
        #: Persistent (ADD_WATCH) registrations: path ->
        #: ZKPersistentWatcher.  Unlike the one-shot map above these
        #: carry no re-arm FSMs — the server-side subscription
        #: survives fires — but they ride the same reconnect replay,
        #: upgraded to SET_WATCHES2 (io/connection.py set_watches).
        self.persistent_watchers: dict[str, ZKPersistentWatcher] = {}
        #: The newest zxid any NOTIFICATION stamped (reply zxids live
        #: in ``last_zxid``).  The watch-backed cache's coherence
        #: position (io/cache.py) is the max of the two: the server
        #: never lets a reply overtake an earlier notification on one
        #: connection (server/watchtable.py ordering contract), so
        #: everything at or below that max has already been fanned to
        #: this session's watchers.
        self.notif_zxid = 0
        self.timeout = timeout
        self.last_attach = 0.0
        self.collector = collector if collector is not None else Collector()
        self.collector.counter(METRIC_ZK_NOTIFICATION_COUNTER,
            'Notifications received from ZooKeeper')
        #: Optional TraceRing (utils/trace.py) shared with the owning
        #: client: notification deliveries are recorded into it so a
        #: span dump interleaves requests and watch events.
        self.trace = trace

        #: The session triple that makes resumption possible
        #: (reference: lib/zk-session.js:57-59).
        self.last_zxid = 0
        self.session_id = 0
        self.passwd = b'\x00' * 16

        #: Zxid floor observed OUTSIDE this session's own connection —
        #: the client's read plane (io/pool.py ReadPlane) bumps it
        #: with every distributed read it accepts, and the previous
        #: session's floor carries into it on replacement.  Presented
        #: at every handshake (max with ``last_zxid``) so the
        #: server-side zxid read gate covers what the CLIENT has seen,
        #: not just this connection; kept separate from ``last_zxid``
        #: because that one is also the SET_WATCHES relZxid — raising
        #: it for state observed via OTHER sessions could suppress
        #: catch-up notifications this connection still owes.
        self.gate_floor = 0

        #: Optional override for crash-on-bug escalation (see
        #: :meth:`fatal_error`); None = loud default (loop exception
        #: handler after teardown).
        self.fatal_handler = None

        #: SET_WATCHES re-arm retry backoff: the same jittered policy
        #: object the pool redials under (shared via the client), so
        #: reattach-time churn retries decorrelate the same way.
        self._rearm_backoff = (retry_policy if retry_policy is not None
                               else BackoffPolicy(delay=50,
                                                  cap=2000)).backoff(seed)
        self._rearm_handle: asyncio.TimerHandle | None = None

        self.bind_fsm_metrics(self.collector, 'ZKSession')
        super().__init__('detached')

    def _trace_edge(self, what: str, session_id: int) -> None:
        """Record a session lifecycle edge into the shared span ring
        (when one is attached), so a campaign's trace dump interleaves
        session create/resume/expiry with ops and member events."""
        if self.trace is not None:
            self.trace.note(what, kind='session',
                            session_id='%016x' % (session_id,))

    # -- public accessors --

    def is_attaching(self) -> bool:
        return (self.is_in_state('attaching') or
                self.is_in_state('reattaching'))

    def is_alive(self) -> bool:
        if self.last_pkt is None:
            return False
        delta = time.monotonic() * 1000.0 - self.last_pkt
        return delta < self.timeout

    def attach_and_send_cr(self, conn) -> None:
        """Called by a connection mid-handshake to bind this session to
        it (reference: lib/zk-session.js:89-97)."""
        if not self.is_in_state('detached') and \
           not self.is_in_state('attached'):
            raise RuntimeError('ZKSession.attach_and_send_cr may only be '
                'called in state "attached" or "detached" (is in %s)'
                % (self.get_state(),))
        self.emit('assertAttach', conn)

    def reset_expiry_timer(self) -> None:
        """Push the expiry deadline out by one session timeout.

        Called on every received packet, so it must be cheap: the
        deadline is just a number, and ONE lazy timer chases it — when
        the timer fires early (deadline moved while it slept) it
        reschedules for the remainder instead of expiring.  Avoids a
        cancel + heap insertion per packet (this showed up in the e2e
        runtime profile)."""
        now = time.monotonic()
        self.last_pkt = now * 1000.0
        self._expiry_deadline = now + self.timeout / 1000.0
        if self._expiry_handle is None:
            self._schedule_expiry(self.timeout / 1000.0)
        elif self._expiry_deadline < self._expiry_at:
            # The deadline moved EARLIER (server renegotiated the
            # session timeout down on reattach) — the lazy timer must
            # not fire late, so this rare case does reschedule.
            self._expiry_handle.cancel()
            self._schedule_expiry(self.timeout / 1000.0)

    def _schedule_expiry(self, delay: float) -> None:
        loop = asyncio.get_running_loop()

        def fire():
            self._expiry_handle = None
            remaining = self._expiry_deadline - time.monotonic()
            if remaining > 0:          # deadline moved while sleeping
                self._schedule_expiry(remaining)
            else:
                self.expiry_timer.emit('timeout')
        self._expiry_at = time.monotonic() + delay
        self._expiry_handle = loop.call_later(delay, fire)

    def _cancel_expiry_timer(self) -> None:
        if self._expiry_handle is not None:
            self._expiry_handle.cancel()
            self._expiry_handle = None

    def get_timeout(self) -> int:
        return self.timeout

    def get_connection(self):
        if not self.is_in_state('attached'):
            return None
        return self.conn

    def get_session_id(self) -> str:
        return '%016x' % (self.session_id,)

    def close(self) -> None:
        self.emit('closeAsserted')

    def fatal_error(self, exc: BaseException) -> None:
        """Crash-on-bug escalation for self-check failures (missed
        wakeups, unmatchable notifications).  The reference throws to
        kill the process (lib/zk-session.js:916-919); here the loud
        default is: log critical, tear the session down through the
        terminal ``expired`` path (connection destroyed, ``expire``/
        ``failed`` surfaced to the client), and hand the exception to
        the event loop's exception handler so an unconfigured process
        prints a traceback.  Installing a ``fatalError`` listener makes
        the policy configurable — teardown still happens, but the loop
        handler is not invoked."""
        self.log.fatal('fatal self-check failure: %s', exc)
        self.emit('fatalError', exc)
        if not (self.is_in_state('expired') or
                self.is_in_state('closed')):
            self._transition('expired')
        if self.fatal_handler is not None:
            self.fatal_handler(exc)
        else:
            asyncio.get_running_loop().call_exception_handler({
                'message': 'zkstream fatal self-check failure '
                           '(crash-on-bug)',
                'exception': exc,
            })

    # -- states --

    def state_detached(self, S) -> None:
        if self.conn is not None:
            self.conn.destroy()
        self.conn = None

        def on_attach(conn):
            self.conn = conn
            S.goto_state('attaching')
        S.on(self, 'assertAttach', on_attach)
        S.on(self, 'closeAsserted', lambda: S.goto_state('closed'))
        S.on(self.expiry_timer, 'timeout', lambda: S.goto_state('expired'))
        self.watchers_disconnected()

    def state_attaching(self, S) -> None:
        def on_conn_dead(*args):
            # The connect attempt died.  A live session keeps trying; a
            # session that had an id and ran out the clock is expired
            # (reference: lib/zk-session.js:150-159).
            if self.is_alive():
                S.goto_state('detached')
            elif self.session_id != 0:
                S.goto_state('expired')
            else:
                S.goto_state('detached')
        S.on(self.conn, 'error', on_conn_dead)
        S.on(self.conn, 'close', on_conn_dead)

        def on_packet(pkt):
            if pkt['sessionId'] == 0:
                # The server zeroed the id: our session is gone
                # (reference: lib/zk-session.js:170-173).
                S.goto_state('expired')
                return
            verb = 'resumed' if self.session_id != 0 else 'created'
            self.log = self.log.child(
                sessionId='%016x' % (pkt['sessionId'],))
            self.log.info('%s zookeeper session with timeout %d ms',
                          verb, pkt['timeOut'])
            self._trace_edge('SESSION_' + verb.upper(),
                             pkt['sessionId'])
            self.timeout = pkt['timeOut']
            self.session_id = pkt['sessionId']
            self.passwd = pkt['passwd']
            self.reset_expiry_timer()
            S.goto_state('attached')
        S.on(self.conn, 'packet', on_packet)

        S.on(self.expiry_timer, 'timeout', lambda: S.goto_state('expired'))
        S.on(self, 'closeAsserted', lambda: S.goto_state('closing'))

        self.conn.send({
            'protocolVersion': consts.PROTOCOL_VERSION,
            'lastZxidSeen': max(self.last_zxid, self.gate_floor),
            'timeOut': self.timeout,
            'sessionId': self.session_id,
            'passwd': self.passwd,
        })

    def state_attached(self, S) -> None:
        self.last_attach = time.monotonic()

        def on_conn_dead(*args):
            if self.is_alive():
                S.goto_state('detached')
            else:
                S.goto_state('expired')
        S.on(self.conn, 'close', on_conn_dead)
        S.on(self.conn, 'error', on_conn_dead)

        def on_packet(pkt):
            self.reset_expiry_timer()
            if pkt['opcode'] != 'NOTIFICATION':
                # Track the max zxid seen: it anchors both session
                # resumption and watch catch-up
                # (reference: lib/zk-session.js:229-235).
                if pkt['zxid'] > self.last_zxid:
                    self.last_zxid = pkt['zxid']
                return
            self.process_notification(pkt)
        S.on(self.conn, 'packet', on_packet)

        S.on(self.expiry_timer, 'timeout', lambda: S.goto_state('expired'))
        S.on(self, 'closeAsserted', lambda: S.goto_state('closing'))

        def on_conn_state(st):
            if st == 'connected':
                if self.old_conn is not None:
                    self.old_conn.destroy()
                    self.old_conn = None
                self.resume_watches()
        S.on(self.conn, 'stateChanged', on_conn_state)

        def on_attach(conn):
            self.old_conn = self.conn
            self.conn = conn
            S.goto_state('reattaching')
        S.on(self, 'assertAttach', on_attach)

    def state_reattaching(self, S) -> None:
        """Move a live session to a more-preferred backend, reverting to
        the old connection on failure (reference:
        lib/zk-session.js:265-339)."""
        assert self.old_conn is not None, 'reattaching requires old_conn'

        def on_packet(pkt):
            if pkt['sessionId'] == 0:
                revert()
                return
            self.log.info('moved zookeeper session to more preferred '
                          'backend (%s) with timeout %d ms',
                          self.conn.backend.key, pkt['timeOut'])
            self._trace_edge('SESSION_MIGRATED', pkt['sessionId'])
            self.timeout = pkt['timeOut']
            self.session_id = pkt['sessionId']
            self.passwd = pkt['passwd']
            self.reset_expiry_timer()
            self.watchers_disconnected()
            S.goto_state('attached')
        S.on(self.conn, 'packet', on_packet)

        def revert(*args):
            if self.is_alive() and self.old_conn.is_in_state('connected'):
                self.log.warning('reverted move of session to new '
                                 'backend (%s)', self.conn.backend.key)
                self.conn = self.old_conn
                self.old_conn = None
                S.goto_state('attached')
            elif self.is_alive():
                self.old_conn.destroy()
                self.old_conn = None
                S.goto_state('detached')
            else:
                self.old_conn.close()
                self.old_conn = None
                S.goto_state('expired')
        S.on(self.conn, 'error', revert)
        S.on(self.conn, 'close', revert)
        S.on(self.expiry_timer, 'timeout', revert)

        def on_close_asserted():
            self.old_conn.close()
            self.old_conn = None
            S.goto_state('closing')
        S.on(self, 'closeAsserted', on_close_asserted)

        self.log.debug('attempting to move zookeeper session from %s '
                       'to %s', self.old_conn.backend.key,
                       self.conn.backend.key)

        self.conn.send({
            'protocolVersion': consts.PROTOCOL_VERSION,
            'lastZxidSeen': max(self.last_zxid, self.gate_floor),
            'timeOut': self.timeout,
            'sessionId': self.session_id,
            'passwd': self.passwd,
        })

    def state_closing(self, S) -> None:
        S.on(self.conn, 'error', lambda *a: S.goto_state('closed'))
        S.on(self.conn, 'close', lambda: S.goto_state('closed'))
        S.on(self.expiry_timer, 'timeout', lambda: S.goto_state('closed'))
        self.conn.close()

    def state_expired(self, S) -> None:
        if self.conn is not None:
            self.conn.destroy()
        self.conn = None
        self._cancel_expiry_timer()
        self._cancel_rearm_retry()
        self._trace_edge('SESSION_EXPIRED', self.session_id)
        self._drop_persistent()
        self.log.warning('ZK session expired')

    def state_closed(self, S) -> None:
        if self.conn is not None:
            self.conn.destroy()
        self.conn = None
        self._cancel_expiry_timer()
        self._cancel_rearm_retry()
        self._drop_persistent()
        self.log.info('ZK session closed')

    # -- watcher plumbing --

    def _drop_persistent(self) -> None:
        """Terminal teardown (expired/closed): the server-side
        registrations die with the session — surface the loss so
        subscribers re-create them on the replacement session."""
        pers = self.persistent_watchers
        if not pers:
            return
        self.persistent_watchers = {}
        for pw in pers.values():
            pw._lost()

    def watchers_disconnected(self) -> None:
        """Tell every armed watch event it is on the auto-resume list
        (reference: lib/zk-session.js:377-387)."""
        for w in list(self.watchers.values()):
            for event in w.events():
                event.disconnected()

    def process_notification(self, pkt: dict) -> None:
        """Dispatch a NOTIFICATION to the right path's watcher
        (reference: lib/zk-session.js:389-419)."""
        if pkt['state'] != 'SYNC_CONNECTED':
            self.log.warning('received notification with bad state %s',
                             pkt['state'])
            return
        evt = _NOTIFICATION_EVENTS[pkt['type']]
        self.log.trace('notification %s for %s', evt, pkt['path'])
        self.collector.get_collector(
            METRIC_ZK_NOTIFICATION_COUNTER).increment({'event': evt})
        if self.trace is not None:
            self.trace.note('NOTIFICATION', pkt['path'],
                            zxid=self.last_zxid, kind='notification',
                            session_id=self.get_session_id())
        watcher = self.watchers.get(pkt['path'])
        if watcher is not None:
            watcher.notify(evt)
        if self.persistent_watchers:
            zxid = pkt.get('zxid', 0)
            if zxid > self.notif_zxid:
                self.notif_zxid = zxid
            self._dispatch_persistent(evt, pkt['path'], zxid)

    def _dispatch_persistent(self, evt: str, path: str,
                             zxid: int) -> None:
        """Fan one notification to the persistent registrations it
        matches: the exact node, plus — for everything except
        childrenChanged — every recursive registration on an ancestor
        (mirrors the server's ancestor-prefix walk,
        server/watchtable.py _persistent_subs)."""
        pers = self.persistent_watchers
        w = pers.get(path)
        if w is not None:
            if evt != 'childrenChanged':
                w._notify(evt, path, zxid)
            elif not w.recursive:
                # recursive subscribers never get childrenChanged:
                # they see the child's own created/deleted instead
                w._notify(evt, path, zxid)
        if evt == 'childrenChanged':
            return
        p = path
        while len(p) > 1:
            i = p.rfind('/')
            p = p[:i] if i > 0 else '/'
            w = pers.get(p)
            if w is not None and w.recursive:
                w._notify(evt, path, zxid)

    def resume_watches(self) -> None:
        """After reconnect, batch every watch event in 'resuming' into
        one SET_WATCHES anchored at the last zxid seen, then release them
        (reference: lib/zk-session.js:421-471)."""
        events = {'dataChanged': [], 'createdOrDestroyed': [],
                  'childrenChanged': []}
        all_evts = []
        count = 0
        for path, w in self.watchers.items():
            cod = False
            for event in w.events():
                if not event.is_in_state('resuming'):
                    continue
                evt = event.get_event()
                if evt == 'createdOrDeleted':
                    if cod:
                        continue
                    events['createdOrDestroyed'].append(path)
                    count += 1
                    cod = True
                elif evt == 'dataChanged':
                    events['dataChanged'].append(path)
                    count += 1
                elif evt == 'childrenChanged':
                    events['childrenChanged'].append(path)
                    count += 1
                else:
                    raise AssertionError('unknown event: %s' % (evt,))
                all_evts.append(event)
        opcode = 'SET_WATCHES'
        pers_list: list[ZKPersistentWatcher] = []
        if self.persistent_watchers:
            # persistent registrations always replay — arming is
            # unconditional (nothing to consume server-side), and a
            # registration made while disconnected arms here for the
            # first time
            opcode = 'SET_WATCHES2'
            events['persistent'] = []
            events['persistentRecursive'] = []
            for path, pw in self.persistent_watchers.items():
                events['persistentRecursive' if pw.recursive
                       else 'persistent'].append(path)
                pers_list.append(pw)
                count += 1
        if count < 1:
            return
        zxid = self.last_zxid
        self.log.info('re-arming %d node watchers at zxid %x', count, zxid)

        def done(err):
            if err is not None:
                # Injected/real churn killed the SET_WATCHES round trip.
                # The events stay in 'resuming' (they re-batch on the
                # next reconnect), and — when the failure was transient
                # and this connection is still serving — a jittered
                # retry re-arms them without waiting for another
                # disconnect.  Without this, watches could stay dark
                # until the next unrelated reconnect: a dropped-event
                # window.
                self.log.warning('SET_WATCHES failed during watch '
                                 'resumption: %s', err)
                self._schedule_rearm_retry()
                return
            self._rearm_backoff.reset()
            for event in all_evts:
                event.resume()
            for pw in pers_list:
                # the gap is closed server-side; derived state
                # (io/cache.py) resyncs on this edge
                pw._resumed()
        try:
            self.conn.set_watches(events, zxid, done, opcode)
        except ZKProtocolError as e:
            # The connection died between 'connected' and this call
            # (reattach churn): not a bug, the events stay 'resuming'
            # and the retry path below re-arms them.
            self.log.warning('connection lost before SET_WATCHES '
                             'could be sent: %s', e)
            self._schedule_rearm_retry()

    def _schedule_rearm_retry(self) -> None:
        """Retry :meth:`resume_watches` after a jittered backoff delay,
        if the session is still attached over a usable connection by
        then.  One timer at a time; re-arm churn cannot stack timers."""
        if self._rearm_handle is not None:
            return
        delay_s = self._rearm_backoff.next_delay() / 1000.0
        loop = asyncio.get_running_loop()

        def fire():
            self._rearm_handle = None
            if not self.is_in_state('attached'):
                return
            conn = self.conn
            if conn is None or not conn.is_in_state('connected'):
                return
            self.resume_watches()
        self._rearm_handle = loop.call_later(delay_s, fire)

    def _cancel_rearm_retry(self) -> None:
        if self._rearm_handle is not None:
            self._rearm_handle.cancel()
            self._rearm_handle = None

    def watcher(self, path: str) -> ZKWatcher:
        """One cached ZKWatcher per path
        (reference: lib/zk-session.js:473-480)."""
        w = self.watchers.get(path)
        if w is None:
            w = ZKWatcher(self, path)
            self.watchers[path] = w
        return w

    def persistent_watcher(self, path: str,
                           recursive: bool) -> ZKPersistentWatcher:
        """One persistent registration per path.  Registering here
        alone does NOT arm the server side — the caller sends
        ADD_WATCH (Client.add_watch) — but once registered the path
        rides every reconnect's SET_WATCHES2 replay, so a
        registration that raced a disconnect still arms.  Asking for
        the same path under a different mode re-homes it (last mode
        wins, matching the server's re-arm semantics)."""
        w = self.persistent_watchers.get(path)
        if w is None:
            w = ZKPersistentWatcher(self, path, recursive)
            self.persistent_watchers[path] = w
        elif w.recursive is not recursive:
            w.recursive = recursive
        return w

    def drop_persistent_watcher(self, path: str) -> None:
        self.persistent_watchers.pop(path, None)
