"""A small synchronous event emitter.

The connection/session/watcher layers are event-driven state machines;
this provides Node-style ``on``/``once``/``emit`` dispatch semantics for
them: listeners run synchronously in registration order, and a listener
removed mid-dispatch (e.g. by a state transition disposing its scope) is
not called for that emit.
"""

from __future__ import annotations

import logging
from typing import Any, Callable


class EventEmitter:
    def __init__(self) -> None:
        self._listeners: dict[str, list[Callable]] = {}
        #: bumped on every registry mutation; lets emit() skip the
        #: per-callback liveness checks when nothing changed mid-dispatch
        self._ver = 0

    def on(self, event: str, cb: Callable) -> 'EventEmitter':
        self._listeners.setdefault(event, []).append(cb)
        self._ver += 1
        return self

    def once(self, event: str, cb: Callable) -> 'EventEmitter':
        def wrapper(*args: Any) -> None:
            self.remove_listener(event, wrapper)
            cb(*args)
        wrapper.__wrapped__ = cb  # type: ignore[attr-defined]
        self._listeners.setdefault(event, []).append(wrapper)
        self._ver += 1
        return self

    def remove_listener(self, event: str, cb: Callable) -> None:
        lst = self._listeners.get(event)
        if not lst:
            return
        for i, fn in enumerate(lst):
            if fn is cb or getattr(fn, '__wrapped__', None) is cb:
                del lst[i]
                self._ver += 1
                break
        if not lst:
            self._listeners.pop(event, None)

    def remove_all_listeners(self, event: str | None = None) -> None:
        if event is None:
            self._listeners.clear()
        else:
            self._listeners.pop(event, None)
        self._ver += 1

    def listeners(self, event: str) -> list[Callable]:
        return list(self._listeners.get(event, ()))

    def listener_count(self, event: str) -> int:
        return len(self._listeners.get(event, ()))

    def emit(self, event: str, *args: Any) -> bool:
        """Dispatch synchronously.  A listener deregistered by an earlier
        listener in the same emit is skipped.  Returns True if anyone was
        listening."""
        snapshot = self._listeners.get(event)
        if not snapshot:
            return False
        if len(snapshot) == 1:
            # Hot path ('packet' and friends have one listener): no
            # snapshot copy, no membership scans.  Nothing can
            # deregister the listener before it runs — there is no
            # earlier listener in this emit to do so.
            snapshot[0](*args)
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
                if cb not in live:
                    continue
            cb(*args)
        return True


log = logging.getLogger('zkstream_tpu_torch')
