"""A small synchronous event emitter.

The connection/session/watcher layers are event-driven state machines;
this provides Node-style ``on``/``once``/``emit`` dispatch semantics for
them: listeners run synchronously in registration order, and a listener
removed mid-dispatch (e.g. by a state transition disposing its scope) is
not called for that emit.

An event with one listener maps to that callable, bare; a second ``on``
turns the entry into a list, and removal down to one listener turns it
back.  Most events of a client's machines have one listener, and a
one-element list would be one more object for the collector to walk.
"""

from __future__ import annotations

import logging
from typing import Any, Callable


class Bound:
    """A listener holding a function, its receiver and one argument:
    ``Bound(fn, obj, arg)(*args)`` calls ``fn(obj, arg, *args)``.  One
    slotted object, where a closure over the same takes a function,
    its cells and their tuple."""

    __slots__ = ('fn', 'obj', 'arg')

    def __init__(self, fn: Callable, obj, arg):
        self.fn = fn
        self.obj = obj
        self.arg = arg

    def __call__(self, *args: Any) -> None:
        self.fn(self.obj, self.arg, *args)


def _matches(fn: Callable, cb: Callable) -> bool:
    return fn is cb or getattr(fn, '__wrapped__', None) is cb


class EventEmitter:
    def __init__(self) -> None:
        #: event -> its listener, or a list of two or more in
        #: registration order
        self._listeners: dict[str, Callable | list[Callable]] = {}
        #: bumped on every registry mutation; lets emit() skip the
        #: per-callback liveness checks when nothing changed mid-dispatch
        self._ver = 0

    def on(self, event: str, cb: Callable) -> 'EventEmitter':
        cur = self._listeners.get(event)
        if cur is None:
            self._listeners[event] = cb
        elif type(cur) is list:
            cur.append(cb)
        else:
            self._listeners[event] = [cur, cb]
        self._ver += 1
        return self

    def once(self, event: str, cb: Callable) -> 'EventEmitter':
        def wrapper(*args: Any) -> None:
            self.remove_listener(event, wrapper)
            cb(*args)
        wrapper.__wrapped__ = cb  # type: ignore[attr-defined]
        return self.on(event, wrapper)

    def remove_listener(self, event: str, cb: Callable) -> None:
        cur = self._listeners.get(event)
        if cur is None:
            return
        if type(cur) is not list:
            if _matches(cur, cb):
                del self._listeners[event]
                self._ver += 1
            return
        for i, fn in enumerate(cur):
            if _matches(fn, cb):
                del cur[i]
                self._ver += 1
                break
        if len(cur) == 1:
            self._listeners[event] = cur[0]

    def remove_all_listeners(self, event: str | None = None) -> None:
        if event is None:
            self._listeners.clear()
        else:
            self._listeners.pop(event, None)
        self._ver += 1

    def listeners(self, event: str) -> list[Callable]:
        cur = self._listeners.get(event)
        if cur is None:
            return []
        return list(cur) if type(cur) is list else [cur]

    def listener_count(self, event: str) -> int:
        cur = self._listeners.get(event)
        if cur is None:
            return 0
        return len(cur) if type(cur) is list else 1

    def emit(self, event: str, *args: Any) -> bool:
        """Dispatch synchronously.  A listener deregistered by an earlier
        listener in the same emit is skipped.  Returns True if anyone was
        listening."""
        snapshot = self._listeners.get(event)
        if snapshot is None:
            return False
        if type(snapshot) is not list:
            # Hot path ('packet' and friends have one listener): no
            # snapshot copy, no membership scans.  Nothing can
            # deregister the listener before it runs — there is no
            # earlier listener in this emit to do so.
            snapshot(*args)
            return True
        # Multi-listener: liveness checks (O(n) each) are only needed
        # for callbacks dispatched AFTER the registry mutated — a
        # server db emitter carries 1 listener per subscribed
        # connection, and O(n^2) per event would melt at fleet scale.
        ver0 = self._ver
        for cb in list(snapshot):
            if self._ver != ver0:
                live = self._listeners.get(event)
                if live is None:
                    break
                if type(live) is list:
                    if cb not in live:
                        continue
                elif cb is not live:
                    continue
            cb(*args)
        return True


log = logging.getLogger('zkstream_tpu_torch')
