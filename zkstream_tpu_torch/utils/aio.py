"""Event-loop plumbing shared by the runtime components."""

from __future__ import annotations

import asyncio
import socket


def ambient_loop() -> asyncio.AbstractEventLoop:
    """The running loop, or — outside a running loop — the thread's set
    loop.

    ``Client.start()`` — and the client/pool FSM transitions it drives
    synchronously — may legitimately run before the loop starts
    spinning, queuing work the loop will process once entered;
    ``asyncio.get_running_loop`` alone would forbid that pattern, while
    bare ``get_event_loop`` is deprecated when no loop is set.  This
    helper keeps both cases working and never creates an implicit loop
    inside callbacks.  (Connections themselves are constructed only
    inside pool tasks, so ``io/connection.py`` uses the stricter
    ``get_running_loop`` throughout.)
    """
    try:
        return asyncio.get_running_loop()
    except RuntimeError:
        return asyncio.get_event_loop()


def set_nodelay(endpoint) -> None:
    """Set ``TCP_NODELAY`` on an asyncio transport or StreamWriter.

    ZooKeeper traffic is small request/reply frames; with Nagle on, the
    kernel delays a short frame behind an unacked one, adding an RTT-ish
    stall per op under write-heavy load.  Any write batching should be
    the send plane's explicit per-tick cork (io/sendplane.py), not the
    kernel's implicit one.  Best-effort: non-TCP endpoints (unix
    sockets, test doubles without a real socket) are left alone."""
    try:
        sock = endpoint.get_extra_info('socket')
        if sock is not None:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except (OSError, ValueError, AttributeError):
        pass
