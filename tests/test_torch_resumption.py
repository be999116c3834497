"""Session-resumption tests of the port's ``Client``: the port of
tests/test_resumption.py — socket-kill recovery, the #39 watcher re-arm
race, ping-timeout recovery, and the #46 clean-close in-flight
cancellation (reference: test/basic.test.js:983-1448) — each on the
port's server and on the JAX package's."""

import asyncio

import pytest

from zkstream_tpu_torch import Client, ZKProtocolError

from helpers import wait_until
from test_torch_basic import server, server_cls  # noqa: F401


def tracked_client(server, **kw):
    kw.setdefault('session_timeout', 5000)
    c = Client(address='127.0.0.1', port=server.port, **kw)
    events = []
    for ev in ('session', 'connect', 'disconnect', 'expire'):
        c.on(ev, lambda *a, ev=ev: events.append(ev))
    c.start()
    return c, events


async def test_session_resumption_with_watcher(server):
    """Kill the socket under a live session: event order must be exactly
    session, connect, disconnect, connect, and watchers must survive
    (reference: basic.test.js:983-1070)."""
    c1, ev1 = tracked_client(server)
    c2, _ = tracked_client(server)
    await c1.wait_connected(timeout=5)
    await c2.wait_connected(timeout=5)

    created = []
    c2.watcher('/foo').on('created', lambda *a: created.append(True))
    data_seen = []
    c1.watcher('/foo').on('dataChanged',
                          lambda data, stat: data_seen.append(bytes(data)))
    await c1.create('/foo', b'hi there')
    await wait_until(lambda: created and data_seen)

    stat = await c2.stat('/foo')
    # Kill c1's socket out from under it.
    c1.current_connection().transport.abort()

    await c2.set('/foo', b'hello again', version=stat.version)
    await wait_until(lambda: b'hello again' in data_seen, timeout=10)

    assert ev1 == ['session', 'connect', 'disconnect', 'connect']
    await c1.close()
    await c2.close()


async def test_resumption_new_watcher_race(server):
    """Watchers created before, during, and just after the socket dies
    must all arm and fire (#39; reference: basic.test.js:1073-1182)."""
    c1, ev1 = tracked_client(server)
    c2, _ = tracked_client(server)
    await c1.wait_connected(timeout=5)
    await c2.wait_connected(timeout=5)

    counts = {'race1': 0, 'race2': 0, 'race3': 0}

    def incr(k):
        counts[k] += 1

    c1.watcher('/race1').on('created', lambda *a: incr('race1'))

    # Kill the socket, then immediately register more watchers while
    # the session is detached/reconnecting.
    c1.current_connection().transport.abort()
    c1.watcher('/race2').on('created', lambda *a: incr('race2'))

    async def later():
        c1.watcher('/race3').on('created', lambda *a: incr('race3'))
    asyncio.get_event_loop().call_soon(
        lambda: asyncio.get_event_loop().create_task(later()))

    # Wait for reconnect, then create the nodes from the other client.
    await wait_until(lambda: c1.is_connected(), timeout=10)
    for p in ('/race1', '/race2', '/race3'):
        await c2.create(p, b'hi there')

    await wait_until(
        lambda: counts['race1'] == 1 and counts['race2'] == 1 and
        counts['race3'] == 1, timeout=10)

    # No leaked stateChanged handlers on the session after resumption
    # (reference: basic.test.js:1171-1173).
    assert c1.session.listener_count('stateChanged') == 1

    assert ev1 == ['session', 'connect', 'disconnect', 'connect']
    await c1.close()
    await c2.close()


async def test_resumption_on_ping_timeout(server):
    """A server that stops answering pings triggers the ping-timeout
    error path; the session must resume the same way
    (reference: basic.test.js:1184-1271)."""
    # Timeout chosen so the ping cycle (interval max(t/4, 2s) + reply
    # timeout max(t/8, 2s) = ~5s) errors well inside the 12s liveness
    # window: the session must detach, not expire.
    c1, ev1 = tracked_client(server, session_timeout=12000)
    await c1.wait_connected(timeout=5)
    sid_before = c1.session.session_id

    seen = []
    await c1.create('/pt', b'v0')
    c1.watcher('/pt').on('dataChanged',
                         lambda data, stat: seen.append(bytes(data)))
    await wait_until(lambda: seen == [b'v0'])

    server.drop_pings = True
    # Ping interval = max(timeout/4, 2s) = 2s; ping timeout = 2s.  The
    # connection should error out and the session resume afterwards.
    await wait_until(lambda: 'disconnect' in ev1, timeout=10)
    server.drop_pings = False
    await wait_until(lambda: ev1.count('connect') >= 2, timeout=10)

    assert c1.session.session_id == sid_before  # resumed, not replaced
    assert ev1 == ['session', 'connect', 'disconnect', 'connect']
    await c1.close()


async def test_clean_close_cancels_inflight_request(server):
    """A request still in flight when close() is called fails with
    CONNECTION_LOSS instead of hanging (#46; reference:
    basic.test.js:1344-1389), and the close still completes."""
    c1, ev1 = tracked_client(server)
    await c1.wait_connected(timeout=5)

    server.drop_replies = True
    conn = c1.current_connection()
    req = conn.request({'opcode': 'CREATE', 'path': '/foo5',
                        'data': b'hello again', 'acl': None or
                        list(__import__('zkstream_tpu_torch').OPEN_ACL_UNSAFE),
                        'flags': 0})
    fut = req.as_future()

    # Schedule teardown: drain-close never finishes (replies dropped),
    # so sever the socket shortly after, like the reference's timeout.
    async def teardown():
        await asyncio.sleep(0.2)
        if conn.transport is not None:
            conn.transport.abort()
    teardown_task = asyncio.get_event_loop().create_task(teardown())
    close_task = asyncio.get_event_loop().create_task(c1.close())

    with pytest.raises(ZKProtocolError) as ei:
        await asyncio.wait_for(fut, 10)
    assert ei.value.code == 'CONNECTION_LOSS'
    server.drop_replies = False
    await asyncio.wait_for(close_task, 10)
    await teardown_task
    assert ev1[:2] == ['session', 'connect']


async def test_resumption_preserves_session_id(server):
    c1, _ = tracked_client(server)
    await c1.wait_connected(timeout=5)
    sid = c1.session.session_id
    assert sid != 0
    for _ in range(3):
        dying = c1.current_connection()
        dying.transport.abort()
        # The abort lands on the next loop tick; wait for the old
        # connection to actually die before polling for the new one.
        await wait_until(lambda: not dying.is_in_state('connected'),
                         timeout=10)
        await wait_until(lambda: c1.is_connected(), timeout=10)
        await c1.ping()
        assert c1.session.session_id == sid
    await c1.close()


async def test_expiry_creates_fresh_session(server, server_cls):
    """If the server is gone past the session timeout, the session
    expires and a fresh one is built on reconnect (reference:
    basic.test.js:89-120 + lib/client.js:264-273)."""
    c1, ev1 = tracked_client(server, session_timeout=1500)
    await c1.wait_connected(timeout=5)
    sid = c1.session.session_id
    port = server.port
    await server.stop()
    await wait_until(lambda: 'expire' in ev1, timeout=10)
    srv2 = await server_cls(host='127.0.0.1', port=port).start()
    try:
        await wait_until(lambda: c1.is_connected(), timeout=15)
        assert c1.session.session_id != sid
        assert ev1.count('session') == 2
    finally:
        await c1.close()
        await srv2.stop()
