"""Doublecheck ("missed wakeup" self-probe) tests of the port.

After a long idle window an armed watch probes EXISTS (no watch) and
compares zxids: a moved zxid with no notification means the watch
machinery lost an event, and the process deliberately crashes
(reference: lib/zk-session.js:901-970, window constants :35-36).  These
tests shrink the window to milliseconds and drive both the clean pass
and the crash path.  The port of tests/test_doublecheck.py: each case
runs on the port's server and on the JAX package's, and, where its
outcome is an observed behaviour, the JAX package's ``Client`` runs the
same scenario against the same server and must observe the same.
"""

import asyncio

import pytest

import zkstream_tpu
from helpers import wait_until
from test_torch_basic import server, server_cls  # noqa: F401
from zkstream_tpu.io import watcher as ref_watcher_mod
from zkstream_tpu_torch import Client
from zkstream_tpu_torch.io import watcher as watcher_mod
from zkstream_tpu_torch.io.watcher import LostWakeupError

#: the client packages a scenario runs with: (Client, its watcher module)
PACKAGES = {'port': (Client, watcher_mod),
            'reference': (zkstream_tpu.Client, ref_watcher_mod)}


def _window(monkeypatch, ms: int) -> None:
    """Shrink both packages' 4-12 h idle window to ``ms``,
    deterministically."""
    for _cls, mod in PACKAGES.values():
        monkeypatch.setattr(mod, 'DOUBLECHECK_TIMEOUT', ms)
        monkeypatch.setattr(mod, 'DOUBLECHECK_RAND', 0)


@pytest.fixture
def fast_doublecheck(monkeypatch):
    """Shrink the 4-12 h idle window to ~80 ms, deterministically."""
    _window(monkeypatch, 80)


async def both(scenario, server, **kw):
    """``scenario(Client, server)`` run with the port's ``Client`` and
    then the reference's: the port's summary, asserted equal to the
    reference's."""
    out = {}
    for name, (cls, _mod) in PACKAGES.items():
        c = cls(address='127.0.0.1', port=server.port,
                session_timeout=5000, **kw.get(name, {}))
        c.start()
        try:
            await c.wait_connected(timeout=5)
            out[name] = await scenario(c, name)
        finally:
            await c.close()
    assert out['port'] == out['reference']
    return out['port']


async def _watched(c, path: str) -> list:
    """Create ``path`` and arm a dataChanged watcher; its data list."""
    await c.create(path, b'v0')
    seen = []
    c.watcher(path).on('dataChanged',
                       lambda data, stat: seen.append(bytes(data)))
    await wait_until(lambda: seen == [b'v0'])
    return seen


async def test_doublecheck_probe_clean(fast_doublecheck, server):
    """Idle watch probes, finds the zxid unmoved, and returns to armed;
    the watch keeps working afterwards."""
    async def scenario(client, name):
        path = '/dc-' + name
        seen = await _watched(client, path)
        we = client.watcher(path).watch_events['dataChanged']
        states = []
        we.on('stateChanged', lambda st: states.append(st))
        await wait_until(lambda: 'armed.doublecheck' in states)
        # The probe reply found prev_zxid unchanged: back to armed.
        await wait_until(lambda: states[-1] == 'armed' and
                         we.is_in_state('armed'))
        await client.set(path, b'v1')
        await wait_until(lambda: seen == [b'v0', b'v1'])
        return seen

    assert await both(scenario, server) == [b'v0', b'v1']


async def test_doublecheck_detects_missed_wakeup(fast_doublecheck, server):
    """If the zxid moved behind the watch's back, the probe escalates
    fatally BY DEFAULT — no custom handler installed: the client emits
    'failed' with the LostWakeupError, the session tears down through
    'expire', and the loop's exception handler is invoked (crash-on-bug,
    reference: lib/zk-session.js:916-919)."""
    async def scenario(client, name):
        path = '/dc2-' + name
        await _watched(client, path)
        failures, expires = [], []
        client.on('failed', lambda *a: failures.append(a))
        client.on('expire', lambda *a: expires.append(True))
        sess = client.session
        we = client.watcher(path).watch_events['dataChanged']
        # Simulate a lost wakeup: the node's mzxid no longer matches what
        # the armed watch believes it last emitted for.
        we.prev_zxid -= 1
        # Process-visible failure, with NO handler installed anywhere.
        await wait_until(lambda: failures and expires, timeout=10)
        return (type(failures[0][0]).__name__, sess.is_in_state('expired'),
                isinstance(failures[0][0], (LostWakeupError,
                                            ref_watcher_mod.LostWakeupError)))

    assert await both(scenario, server) == ('LostWakeupError', True, True)


async def test_missed_wakeup_custom_fatal_handler(fast_doublecheck, server):
    """on_fatal= overrides the loud default; teardown still happens."""
    caught = {'port': [], 'reference': []}

    async def scenario(c, name):
        path = '/dc4-' + name
        await _watched(c, path)
        sess = c.session
        c.watcher(path).watch_events['dataChanged'].prev_zxid -= 1
        await wait_until(lambda: bool(caught[name]), timeout=10)
        return (type(caught[name][0]).__name__, sess.is_in_state('expired'))

    got = await both(scenario, server, **{
        name: {'on_fatal': caught[name].append} for name in caught})
    assert got == ('LostWakeupError', True)
    assert isinstance(caught['port'][0], LostWakeupError)


async def test_doublecheck_defers_when_disconnected(monkeypatch, server):
    """An armed watch whose session detached must not probe: it goes to
    resuming, and the doublecheck timer only re-arms on reconnect.

    Uses a 500 ms window (not the 80 ms fast fixture): the window must
    be comfortably wider than the abort -> connection_lost gap, or the
    timer could legitimately fire before the FSM hears about the dead
    transport and the no-probe assertion would race."""
    _window(monkeypatch, 500)

    async def scenario(c, name):
        path = '/dc3-' + name
        seen = await _watched(c, path)
        we = c.watcher(path).watch_events['dataChanged']
        states = []
        we.on('stateChanged', lambda st: states.append(st))

        # Kill the transport: session detaches, watch goes to resuming
        # (or re-arms from scratch), never straight into a probe.
        c.current_connection().transport.abort()
        await wait_until(
            lambda: any(st in ('resuming', 'wait_session')
                        for st in states), timeout=5)
        # No probe may have fired in the detached window.
        probed_detached = 'armed.doublecheck' in states
        # Reconnection re-arms it; doublecheck still fires cleanly after.
        await wait_until(lambda: we.is_in_state('armed'), timeout=10)
        del states[:]
        await wait_until(lambda: 'armed.doublecheck' in states and
                         we.is_in_state('armed'), timeout=5)
        await c.set(path, b'v1')
        await wait_until(lambda: seen == [b'v0', b'v1'])
        return probed_detached, seen

    assert await both(scenario, server) == (False, [b'v0', b'v1'])


async def test_notify_unmatched_escalates_fatally(server):
    """A notification that matches no armed event FSM means our model of
    ZK watch semantics is wrong: crash-on-bug escalation — client emits
    'failed' and the session tears down, with no handler installed
    (reference throws: lib/zk-session.js:584-592)."""
    async def scenario(client, name):
        path = '/nm-' + name
        await client.create(path, b'')
        w = client.watcher(path)
        w.on('childrenChanged', lambda *a: None)
        await asyncio.sleep(0.1)
        failures = []
        client.on('failed', lambda *a: failures.append(a))
        sess = client.session
        # 'created' fans out to createdOrDeleted/dataChanged only —
        # neither is armed here.
        w.notify('created')
        await wait_until(lambda: bool(failures), timeout=5)
        return type(failures[0][0]).__name__, sess.is_in_state('expired')

    assert await both(scenario, server) == ('LostWakeupError', True)


async def test_doublecheck_probe_through_ingest(fast_doublecheck, server):
    """The probe's EXISTS reply routes back through the fleet ingest's
    batched delivery (bypass disabled so the device path carries it) —
    the lost-wakeup self-check composes with the tick decode (here on
    the CPU, the plain version)."""
    from zkstream_tpu_torch.io.ingest import FleetIngest

    ingest = FleetIngest(device='cpu', body_mode='host', max_frames=8,
                         bypass_bytes=0, warm='block')
    c = Client(address='127.0.0.1', port=server.port,
               session_timeout=5000, ingest=ingest)
    c.start()
    try:
        await c.wait_connected(timeout=5)
        seen = await _watched(c, '/dci')
        we = c.watcher('/dci').watch_events['dataChanged']
        states = []
        we.on('stateChanged', lambda st: states.append(st))
        await wait_until(lambda: 'armed.doublecheck' in states)
        await wait_until(lambda: states[-1] == 'armed'
                         and we.is_in_state('armed'))
        await c.set('/dci', b'v1')
        await wait_until(lambda: seen == [b'v0', b'v1'])
        assert ingest.ticks > 0
    finally:
        await c.close()
