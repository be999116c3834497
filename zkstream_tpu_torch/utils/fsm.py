"""A Moore-machine FSM base with auto-disposing state scopes.

The reference builds every stateful component (client, connection,
session, watch events) on the mooremachine library's pattern: each state
is a ``state_<name>`` method receiving a scope handle ``S``; listeners
and timers registered through ``S`` are torn down automatically on the
next transition.  That discipline is what makes the protocol's many
races tractable, so this module provides the same contract for asyncio:

- ``goto_state(name)`` disposes the current scope (listeners removed,
  timers cancelled) and runs ``state_<name>(S)``;
- ``S.on(emitter, event, cb)`` / ``S.timeout(ms, cb)`` /
  ``S.interval(ms, cb)`` / ``S.immediate(cb)`` are scope-bound;
- dotted substates (``armed.doublecheck``) keep the parent state's scope
  alive, inheriting its transitions, exactly like mooremachine substates
  (reference: lib/zk-session.js:671-673);
- ``is_in_state('armed')`` is true while in ``armed.doublecheck``;
- every transition emits ``stateChanged`` with the new state name.
"""

from __future__ import annotations

import asyncio
import weakref
from typing import Callable

from .events import EventEmitter
from .aio import ambient_loop

METRIC_FSM_TRANSITIONS = 'zkstream_fsm_transitions'
METRIC_FSM_STATE = 'zkstream_fsm_state'


def _fsm_state_counts(registry) -> dict:
    """Current-state census over a weak registry of instrumented
    machines: {labels: count of live machines in that state}."""
    counts: dict[tuple[str, str], int] = {}
    for machine in list(registry):
        label = getattr(machine, '_fsm_metrics_label', None)
        state = machine.get_state()
        if label is None or not state:
            continue
        counts[(label, state)] = counts.get((label, state), 0) + 1
    return {(('fsm', label), ('state', state)): float(n)
            for (label, state), n in counts.items()}


def bind_transition_metrics(machine, collector,
                            label: str | None = None) -> None:
    """Instrument any object with a ``get_state()`` and state
    transitions (FSM subclasses get the counting for free via
    ``FSM._transition``; the pool calls :func:`note_transition`
    manually) so ``collector`` exposes:

    - ``zkstream_fsm_transitions{fsm,from,to}`` — a counter bumped on
      every transition;
    - ``zkstream_fsm_state{fsm,state}`` — a pull gauge counting live
      machines per (label, state) at scrape time.

    The registry holds weak references, so instrumented machines are
    censused only while alive; binding is idempotent per collector
    (the counter is fetched, the gauge registered once)."""
    if label is None:
        label = type(machine).__name__
    machine._fsm_metrics_ctr = collector.counter(
        METRIC_FSM_TRANSITIONS, 'FSM state transitions')
    machine._fsm_metrics_label = label
    registry = getattr(collector, '_fsm_registry', None)
    if registry is None:
        registry = collector._fsm_registry = weakref.WeakSet()
        collector.multi_gauge(
            METRIC_FSM_STATE,
            lambda reg=registry: _fsm_state_counts(reg),
            'Live state machines per (fsm, state)')
    registry.add(machine)


def note_transition(machine, old: str | None, new: str) -> None:
    """Count one state transition on the machine's bound collector
    (no-op until :func:`bind_transition_metrics` ran)."""
    ctr = getattr(machine, '_fsm_metrics_ctr', None)
    if ctr is not None:
        ctr.increment({'fsm': machine._fsm_metrics_label,
                       'from': old or '', 'to': new})


class StateScope:
    """Handle passed to ``state_*`` methods; everything registered through
    it is disposed when the machine leaves the state."""

    def __init__(self, fsm: 'FSM', state: str):
        self._fsm = fsm
        self._state = state
        self._disposers: list[Callable[[], None]] = []
        self._valid = True

    def on(self, emitter: EventEmitter, event: str, cb: Callable) -> None:
        def guarded(*args):
            if self._valid:
                cb(*args)
        emitter.on(event, guarded)
        self._disposers.append(
            lambda: emitter.remove_listener(event, guarded))

    def timeout(self, ms: float,
                cb: Callable[[], None]) -> asyncio.TimerHandle:
        loop = ambient_loop()
        handle = loop.call_later(ms / 1000.0,
                                 lambda: self._valid and cb())
        self._disposers.append(handle.cancel)
        return handle

    def interval(self, ms: float, cb: Callable[[], None]) -> None:
        loop = ambient_loop()
        state = {}

        def fire():
            if not self._valid:
                return
            cb()
            if self._valid:
                state['h'] = loop.call_later(ms / 1000.0, fire)

        state['h'] = loop.call_later(ms / 1000.0, fire)
        self._disposers.append(lambda: state['h'].cancel())

    def immediate(self, cb: Callable[[], None]) -> None:
        loop = ambient_loop()
        handle = loop.call_soon(lambda: self._valid and cb())
        self._disposers.append(handle.cancel)

    def defer(self, cb: Callable[[], None]) -> None:
        """Run ``cb`` when the machine leaves this state (scope-exit
        cleanup, e.g. deregistering from an external registry)."""
        self._disposers.append(cb)

    def goto_state(self, name: str) -> None:
        if self._valid:
            self._fsm._transition(name)

    def _dispose(self) -> None:
        self._valid = False
        for d in self._disposers:
            d()
        self._disposers.clear()


class FSM(EventEmitter):
    """Base class: subclasses define ``state_<name>(self, S)`` methods and
    call ``super().__init__(initial_state)``."""

    def __init__(self, initial: str):
        super().__init__()
        self._state: str | None = None
        #: Scope stack: one entry per dotted level of the current state
        #: (['armed'] or ['armed', 'armed.doublecheck']).
        self._scopes: list[tuple[str, StateScope]] = []
        self._in_transition = False
        self._queued: str | None = None
        self._transition(initial)

    def get_state(self) -> str:
        return self._state or ''

    def is_in_state(self, name: str) -> bool:
        if self._state is None:
            return False
        return self._state == name or self._state.startswith(name + '.')

    def bind_fsm_metrics(self, collector, label: str | None = None) \
            -> None:
        """Expose this machine's transitions/current state on
        ``collector`` (see :func:`bind_transition_metrics`).  Called
        before ``super().__init__`` the initial transition is counted
        too; after, counting starts from the next transition."""
        bind_transition_metrics(self, collector, label)

    def _transition(self, name: str) -> None:
        # A transition triggered from inside a state_* entry function is
        # deferred until the entry function returns (mooremachine allows
        # synchronous re-entry; a queue keeps the bookkeeping sane).
        if self._in_transition:
            self._queued = name
            return

        # Dispose scopes that are not parents of the new state.  Entering
        # 'armed.doublecheck' from 'armed' keeps the 'armed' scope alive;
        # entering 'wait_session' from 'armed.doublecheck' disposes both.
        keep = 0
        parts = name.split('.')
        prefixes = ['.'.join(parts[:i + 1]) for i in range(len(parts) - 1)]
        for st, _scope in self._scopes:
            if keep < len(prefixes) and st == prefixes[keep]:
                keep += 1
            else:
                break
        for _st, scope in reversed(self._scopes[keep:]):
            scope._dispose()
        del self._scopes[keep:]

        handler = getattr(self, 'state_' + name.replace('.', '_'), None)
        if handler is None:
            raise AttributeError('%s has no state %r' %
                                 (type(self).__name__, name))
        scope = StateScope(self, name)
        self._scopes.append((name, scope))
        note_transition(self, self._state, name)
        self._state = name
        self._in_transition = True
        try:
            handler(scope)
        finally:
            self._in_transition = False
        self.emit('stateChanged', name)
        if self._queued is not None:
            nxt, self._queued = self._queued, None
            self._transition(nxt)
