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
  ``S.interval(ms, cb)`` / ``S.immediate(cb)`` are scope-bound, and
  ``S.goto_on(emitter, event, state)`` / ``S.goto_after(ms, state)`` /
  ``S.goto_soon(state)`` go to a state without a callback of their
  own; a machine's listeners are its methods, so that a registration
  is one object holding a function and its receiver, not a closure;
- a listener method that moves the machine takes ``S = self._scope``
  at entry and goes through ``S.goto_state``, as a closure over the
  state's ``S`` did: if its side effects moved the machine first, the
  disposed scope makes the transition a no-op.  ``self._scope`` is the
  innermost scope, a substate's while the machine is in one, so a
  listener registered by a parent state (``armed``) that runs in its
  substate (``armed.doublecheck``) takes the substate's scope;
- dotted substates (``armed.doublecheck``) keep the parent state's scope
  alive, inheriting its transitions, exactly like mooremachine substates
  (reference: lib/zk-session.js:671-673);
- ``is_in_state('armed')`` is true while in ``armed.doublecheck``;
- every transition emits ``stateChanged`` with the new state name.
"""

from __future__ import annotations

import asyncio
import weakref
from types import MethodType
from typing import Callable

from .events import EventEmitter
from .aio import ambient_loop

METRIC_FSM_TRANSITIONS = 'zkstream_fsm_transitions'
METRIC_FSM_STATE = 'zkstream_fsm_state'
METRIC_FSM_REGISTRATIONS = 'zkstream_fsm_scope_registrations'


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


def _fsm_registrations(registry) -> dict:
    """Live ``StateScope`` registrations over a weak registry of
    instrumented machines, by form: ``method`` (a function and its
    receiver, or a target state) and ``callable`` (anything else)."""
    total = callables = 0
    for machine in list(registry):
        scope = getattr(machine, '_scope', None)
        while scope is not None:
            total += len(scope._disposers)
            callables += scope._callables
            scope = scope._parent
    return {(('form', 'method'),): float(total - callables),
            (('form', 'callable'),): float(callables)}


def bind_transition_metrics(machine, collector,
                            label: str | None = None) -> None:
    """Instrument any object with a ``get_state()`` and state
    transitions (FSM subclasses get the counting for free via
    ``FSM._transition``; the pool calls :func:`note_transition`
    manually) so ``collector`` exposes:

    - ``zkstream_fsm_transitions{fsm,from,to}`` — a counter bumped on
      every transition;
    - ``zkstream_fsm_state{fsm,state}`` — a pull gauge counting live
      machines per (label, state) at scrape time;
    - ``zkstream_fsm_scope_registrations{form}`` — a pull gauge
      summing the live ``StateScope`` registrations of those machines
      (the process's, where one collector serves every client) by the
      form of their callback: ``method`` or ``callable``.

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
        collector.multi_gauge(
            METRIC_FSM_REGISTRATIONS,
            lambda reg=registry: _fsm_registrations(reg),
            'Live state-scope registrations (listeners, timers, '
            'deferred callbacks) of the instrumented machines, by '
            'form (method | callable)')
    registry.add(machine)


def note_transition(machine, old: str | None, new: str) -> None:
    """Count one state transition on the machine's bound collector
    (no-op until :func:`bind_transition_metrics` ran)."""
    ctr = getattr(machine, '_fsm_metrics_ctr', None)
    if ctr is not None:
        ctr.increment({'fsm': machine._fsm_metrics_label,
                       'from': old or '', 'to': new})


def _split(cb: Callable) -> tuple:
    """``(fn, obj)`` of a callback as :class:`_Scoped` holds it: a bound
    method's function and receiver, else the callable and None."""
    if type(cb) is MethodType:
        return cb.__func__, cb.__self__
    return cb, None


class _Scoped:
    """A callback bound to a scope: runs only while the scope is
    current.  ``S.on`` registers one as the emitter's listener and as
    its own disposer (``emitter`` and ``event`` say where the disposal
    takes it off, by identity); ``S.timeout`` and ``S.immediate``
    schedule one.  A registration is thus one object the collector
    tracks, in one of three forms:

    - a method: ``fn`` the function, ``obj`` its receiver (the bound
      method object itself is dropped), called as ``fn(obj, *args)``;
    - a target state: ``fn`` None, ``obj`` the state's name;
    - any other callable: ``fn`` it, ``obj`` None (a bound method's
      receiver is never None)."""

    __slots__ = ('scope', 'fn', 'obj', 'emitter', 'event')

    def __init__(self, scope: 'StateScope', fn: Callable | None, obj,
                 emitter: EventEmitter | None = None,
                 event: str | None = None):
        self.scope = scope
        self.fn = fn
        self.obj = obj
        self.emitter = emitter
        self.event = event

    def __call__(self, *args) -> None:
        scope = self.scope
        if scope._valid:
            fn = self.fn
            if fn is None:
                scope._fsm._transition(self.obj)
            elif self.obj is None:
                fn(*args)
            else:
                fn(self.obj, *args)


class _Interval:
    """One ``S.interval`` registration: the armed timer and its re-arm
    (``fn`` and ``obj`` as in :class:`_Scoped`)."""

    __slots__ = ('scope', 'fn', 'obj', 'delay', 'loop', 'handle')

    def __init__(self, scope: 'StateScope', fn: Callable, obj,
                 delay: float, loop):
        self.scope = scope
        self.fn = fn
        self.obj = obj
        self.delay = delay
        self.loop = loop
        self.handle = loop.call_later(delay, self)

    def __call__(self) -> None:
        if not self.scope._valid:
            return
        if self.obj is None:
            self.fn()
        else:
            self.fn(self.obj)
        if self.scope._valid:
            self.handle = self.loop.call_later(self.delay, self)

    def cancel(self) -> None:
        self.handle.cancel()


class StateScope:
    """Handle passed to ``state_*`` methods; everything registered through
    it is disposed when the machine leaves the state.

    The disposers, in registration order: an ``S.on`` listener (a
    :class:`_Scoped`, taken off its emitter), a timer handle or an
    :class:`_Interval` (cancelled), an ``S.defer`` callback (called);
    an ``S.immediate`` callback needs none (its guard goes stale).
    A bound method given to any of them is kept as its function and
    receiver; ``_callables`` counts the registrations of any other
    callable (closures and lambdas), for the registrations gauge."""

    __slots__ = ('_fsm', '_state', '_parent', '_disposers', '_valid',
                 '_callables')

    def __init__(self, fsm: 'FSM', state: str,
                 parent: 'StateScope | None' = None):
        self._fsm = fsm
        self._state = state
        self._parent = parent
        self._disposers: list = []
        self._valid = True
        self._callables = 0

    def _split(self, cb: Callable) -> tuple:
        """``(fn, obj)`` of a registration's callback, counted."""
        fn, obj = _split(cb)
        if obj is None:
            self._callables += 1
        return fn, obj

    def on(self, emitter: EventEmitter, event: str, cb: Callable) -> None:
        guard = _Scoped(self, *self._split(cb), emitter, event)
        emitter.on(event, guard)
        self._disposers.append(guard)

    def goto_on(self, emitter: EventEmitter, event: str,
                state: str) -> None:
        """Go to ``state`` when ``emitter`` emits ``event`` (its
        arguments ignored)."""
        guard = _Scoped(self, None, state, emitter, event)
        emitter.on(event, guard)
        self._disposers.append(guard)

    def timeout(self, ms: float,
                cb: Callable[[], None]) -> asyncio.TimerHandle:
        handle = ambient_loop().call_later(
            ms / 1000.0, _Scoped(self, *self._split(cb)))
        self._disposers.append(handle)
        return handle

    def goto_after(self, ms: float, state: str) -> None:
        """Go to ``state`` after ``ms`` milliseconds in this one."""
        self._disposers.append(ambient_loop().call_later(
            ms / 1000.0, _Scoped(self, None, state)))

    def interval(self, ms: float, cb: Callable[[], None]) -> None:
        self._disposers.append(
            _Interval(self, *self._split(cb), ms / 1000.0,
                      ambient_loop()))

    def immediate(self, cb: Callable[[], None]) -> None:
        """Run ``cb`` on the loop's next turn, if still in this state.
        The guard, gone stale, is all the disposal it needs: the scope
        keeps no handle of it, so it is not a registration either."""
        ambient_loop().call_soon(_Scoped(self, *_split(cb)))

    def goto_soon(self, state: str) -> None:
        """Go to ``state`` on the loop's next turn, if still in this
        one (as :meth:`immediate`)."""
        ambient_loop().call_soon(_Scoped(self, None, state))

    def defer(self, cb: Callable[[], None]) -> None:
        """Run ``cb`` when the machine leaves this state (scope-exit
        cleanup, e.g. deregistering from an external registry)."""
        if type(cb) is not MethodType:
            self._callables += 1
        self._disposers.append(cb)

    def goto_state(self, name: str) -> None:
        if self._valid:
            self._fsm._transition(name)

    def _dispose(self) -> None:
        self._valid = False
        for d in self._disposers:
            if type(d) is _Scoped:
                d.emitter.remove_listener(d.event, d)
            elif callable(d):
                d()                 # S.defer
            else:
                d.cancel()          # a timer handle, an _Interval
        self._disposers.clear()
        self._callables = 0


class FSM(EventEmitter):
    """Base class: subclasses define ``state_<name>(self, S)`` methods and
    call ``super().__init__(initial_state)``."""

    def __init__(self, initial: str):
        super().__init__()
        self._state: str | None = None
        #: The current state's scope; a dotted state's links to its
        #: parent state's ('armed.doublecheck' -> 'armed'), which stays
        #: alive with it.
        self._scope: StateScope | None = None
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
        parent = self._scope
        while parent is not None and \
                not name.startswith(parent._state + '.'):
            parent._dispose()
            parent = parent._parent

        handler = getattr(self, 'state_' + name.replace('.', '_'), None)
        if handler is None:
            raise AttributeError('%s has no state %r' %
                                 (type(self).__name__, name))
        scope = self._scope = StateScope(self, name, parent)
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
