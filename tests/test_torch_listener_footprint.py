"""The objects the collector walks for the listeners the port registers
for itself: a scope registration is one slotted guard holding a function
and its receiver, or a target state, with no closure (utils/fsm.py); an
event with one listener holds it bare, with no list (utils/events.py);
a request settles its future through a slot, with no listener
(io/connection.py ``ZKRequest``).

Run as a script, the file prints the connected-session footprint of
a fresh process (``python3 tests/test_torch_listener_footprint.py``,
from the repository root)."""

import asyncio
import collections
import gc
import json
import os
import subprocess
import sys
import types

import pytest

from zkstream_tpu_torch import Client
from zkstream_tpu_torch.io.connection import ZKRequest
from zkstream_tpu_torch.protocol import consts
from zkstream_tpu_torch.protocol.errors import ZKError, ZKProtocolError
from zkstream_tpu_torch.server import ZKServer
from zkstream_tpu_torch.utils.events import EventEmitter
from zkstream_tpu_torch.utils.fsm import FSM, METRIC_FSM_REGISTRATIONS
from zkstream_tpu_torch.utils.metrics import Collector

#: Tracked objects a connected session holds over the no-client
#: baseline, at most: client and server side, 32 clients after 300 gets
#: each (the same census as test_torch_gc_footprint's).
SESSION_OBJECTS_MAX = 250

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CLOSURE_TYPES = (types.FunctionType, types.CellType, tuple)
SLACK = 100


def _census() -> tuple:
    """(tracked objects, their count by type), after a full pass."""
    gc.collect()
    objs = gc.get_objects()
    return len(objs), collections.Counter(type(o) for o in objs)


class _Registering(FSM):
    """A machine whose ``busy`` state makes ``n`` registrations of one
    form; its listener method counts calls."""

    def __init__(self, emitter, n, form):
        self.emitter, self.n, self.form = emitter, n, form
        self.calls = 0
        super().__init__('busy')

    def state_busy(self, S):
        for _ in range(self.n):
            if self.form == 'method':
                S.on(self.emitter, 'ev', self.hit)
            else:
                S.goto_on(self.emitter, 'ev', 'done')

    def hit(self, *args):
        self.calls += 1

    def state_done(self, S):
        pass


@pytest.mark.parametrize('form', ['method', 'goto'])
def test_scope_registration_holds_no_closure(form):
    emitter = EventEmitter()
    n0, types0 = _census()
    m = _Registering(emitter, 1000, form)
    n1, types1 = _census()
    # the slack: what the rest of the process (a worker's threads and
    # earlier tests) makes meanwhile, far less than one a registration
    assert n1 - n0 <= 1000 + SLACK, n1 - n0
    for t in CLOSURE_TYPES:
        assert types1[t] - types0[t] < SLACK, (t, types1[t] - types0[t])
    assert emitter.listener_count('ev') == 1000
    regs = m._scope._disposers
    assert len(regs) == 1000 and m._scope._callables == 0
    emitter.emit('ev', 1)
    if form == 'method':
        assert m.calls == 1000 and m.get_state() == 'busy'
        guards = emitter.listeners('ev')
        m._scope.goto_state('done')
        guards[0](2)                  # a stale guard does nothing
        assert m.calls == 1000
    assert m.get_state() == 'done'
    assert emitter.listener_count('ev') == 0


def _lists_in(emitter) -> int:
    return sum(1 for v in emitter._listeners.values() if type(v) is list)


@pytest.mark.parametrize('n', [1, 2, 3])
def test_emitter_storage_and_dispatch(n):
    """One listener per event is held bare; two or more in a list, in
    registration order.  Dispatch, ``once``, removal by identity or by
    ``__wrapped__``, ``listeners()`` and ``listener_count`` behave the
    same at every count."""
    e = EventEmitter()
    calls = []

    def make(i):
        def cb(*args):
            calls.append((i,) + args)
        return cb
    cbs = [make(i) for i in range(n)]
    for cb in cbs:
        e.on('a', cb)
    e.on('b', make('b'))
    assert _lists_in(e) == (0 if n == 1 else 1)
    assert e.listener_count('a') == n and e.listener_count('b') == 1
    assert e.listener_count('none') == 0 and e.listeners('none') == []

    # listeners() is a copy, in registration order
    got = e.listeners('a')
    assert got == cbs
    got.clear()
    assert e.listener_count('a') == n

    assert e.emit('a', 7) is True and e.emit('none') is False
    assert calls == [(i, 7) for i in range(n)]

    # a listener removed mid-dispatch by an earlier one is not called;
    # one added mid-dispatch waits for the next emit
    calls.clear()
    late = make('late')

    def remover(*args):
        calls.append(('remover',) + args)
        for cb in cbs:
            e.remove_listener('a', cb)
        e.on('a', late)
    e.remove_all_listeners('a')
    e.on('a', remover)
    for cb in cbs:
        e.on('a', cb)
    e.emit('a', 1)
    assert calls == [('remover', 1)]
    assert e.listeners('a') == [remover, late]
    calls.clear()
    e.emit('a', 2)
    assert calls == [('remover', 2), ('late', 2)]

    # once: fires one time, removable by the callback it wraps
    e.remove_all_listeners('a')
    calls.clear()
    onces = [make('once%d' % i) for i in range(n)]
    for cb in onces:
        e.once('a', cb)
    assert e.listener_count('a') == n
    e.emit('a', 3)
    e.emit('a', 4)
    assert calls == [('once%d' % i, 3) for i in range(n)]
    assert e.listener_count('a') == 0 and 'a' not in e._listeners
    for cb in onces:
        e.once('a', cb)
    e.remove_listener('a', onces[0])          # by __wrapped__
    assert e.listener_count('a') == n - 1
    assert _lists_in(e) == (1 if n == 3 else 0)

    # removal down to one listener leaves it bare; to none, no entry
    e.remove_all_listeners()
    for cb in cbs:
        e.on('a', cb)
    for k, cb in enumerate(cbs[:-1]):
        e.remove_listener('a', cb)
        assert e.listener_count('a') == n - k - 1
    assert e._listeners['a'] is cbs[-1]
    e.remove_listener('a', make('stranger'))  # not listening: no-op
    assert e.listener_count('a') == 1
    e.remove_listener('a', cbs[-1])
    assert e._listeners == {} and e.emit('a') is False


async def _fleet(srv, n, gets, create=True):
    """``n`` port clients of ``srv`` on one collector, connected, each
    after ``gets`` gets (of ``/g``, which the first creates unless
    ``create`` is false)."""
    collector = Collector()
    clients = [Client(address='127.0.0.1', port=srv.port,
                      session_timeout=30000, collector=collector)
               for _ in range(n)]
    for c in clients:
        c.start()
    await asyncio.gather(*[c.wait_connected(timeout=10) for c in clients])
    if create:
        await clients[0].create('/g', b'x' * 64)

    async def run(c):
        for _ in range(gets):
            await c.get('/g')
    await asyncio.gather(*[run(c) for c in clients])
    return clients, collector


async def _close(srv, clients):
    await asyncio.gather(*[c.close() for c in clients])
    await srv.stop()


async def test_gets_make_no_closure_per_op():
    """2,000 gets with the collector off: while they are all in flight,
    and after they settle, no function or cell object was made for
    each (a request's future settles through its slot)."""
    srv = await ZKServer().start()
    clients, _col = await _fleet(srv, 1, 10)
    c = clients[0]
    try:
        gc.collect()
        gc.disable()
        try:
            _n, before = _census()
            tasks = [asyncio.ensure_future(c.get('/g'))
                     for _ in range(2000)]
            await asyncio.sleep(0)     # every get is sent and waiting
            assert len(c.current_connection().reqs) == 2000
            inflight = collections.Counter(type(o)
                                           for o in gc.get_objects())
            await asyncio.gather(*tasks)
            settled = collections.Counter(type(o)
                                          for o in gc.get_objects())
        finally:
            gc.enable()
        for t in (types.FunctionType, types.CellType):
            assert inflight[t] - before[t] < 50, (t, inflight[t])
            assert settled[t] - before[t] < 50, (t, settled[t])
    finally:
        await _close(srv, clients)


async def _session_footprint(n=32, gets=300) -> float:
    """Tracked objects per connected port ``Client`` (and its server
    side) after ``gets`` gets each, over the same process with the
    server and no client; one client's round trip first, so that what
    its first use builds for good (imports, caches) is in both
    readings."""
    srv = await ZKServer().start()
    clients = []
    try:
        warm, _col = await _fleet(srv, 1, 5)
        await asyncio.gather(*[c.close() for c in warm])
        warm = None
        await asyncio.sleep(0)
        n0, _t = _census()
        clients, _col = await _fleet(srv, n, gets, create=False)
        n1, _t = _census()
        return (n1 - n0) / len(clients)
    finally:
        await _close(srv, clients)


def test_connected_session_footprint_without_closures():
    """The footprint of 32 clients after 300 gets each, read in a fresh
    process, so that what earlier tests left in a worker cannot move
    it.  With every scope registration a closure and every single
    listener a one-element list, this read 372 (CPU)."""
    env = dict(os.environ)
    env['PYTHONPATH'] = _ROOT + os.pathsep + env.get('PYTHONPATH', '')
    res = subprocess.run([sys.executable, os.path.abspath(__file__)],
                         cwd=_ROOT, env=env, capture_output=True,
                         text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-4000:]
    per = json.loads(res.stdout.strip().splitlines()[-1])['per_session']
    assert per <= SESSION_OBJECTS_MAX, per


async def test_connected_client_registers_methods():
    """A connected client's scope registrations are methods or target
    states: the registrations gauge reads them under ``form=method``,
    at least 90 % of them (and no closure at all here)."""
    srv = await ZKServer().start()
    clients = []
    try:
        clients, collector = await _fleet(srv, 2, 5)
        forms = collector.get_collector(METRIC_FSM_REGISTRATIONS)._fn()
        method = forms[(('form', 'method'),)]
        callable_ = forms[(('form', 'callable'),)]
        assert method >= 0.9 * (method + callable_), forms
        assert method >= 10 * len(clients) and callable_ == 0, forms
        assert METRIC_FSM_REGISTRATIONS + '{form="method"} %s' % (
            method,) in collector.expose()
    finally:
        await _close(srv, clients)


@pytest.mark.parametrize('outcome', ['reply', 'error'])
async def test_request_future_settles_before_listeners(outcome):
    """``as_future`` keeps one future a request, in its slot: the first
    outcome settles it ahead of the outcome's own listeners, which
    still run; a second outcome changes neither."""
    calls = []
    req = ZKRequest({'opcode': 'GET_DATA'})
    fut = req.as_future()
    assert req.as_future() is fut
    assert req.listener_count('reply') == req.listener_count('error') == 0
    req.on('reply', lambda pkt: calls.append(('reply', fut.done())))
    req.on('error', lambda err, *a: calls.append(('error', fut.done())))
    err = ZKError('NO_NODE')
    if outcome == 'reply':
        req.emit('reply', {'xid': 1})
        assert fut.result() == {'xid': 1}
        req.emit('error', err)
    else:
        req.emit('error', err, {'xid': 1})
        assert fut.exception() is err
        req.emit('reply', {'xid': 1})
    assert calls[0] == (outcome, True) and len(calls) == 2
    assert (fut.result() if outcome == 'reply' else fut.exception()) \
        == ({'xid': 1} if outcome == 'reply' else err)
    assert req.as_future() is fut


@pytest.mark.parametrize('outcome', ['reply', 'error', 'timeout'])
async def test_ping_settles_its_callback_and_waiters(outcome):
    """A ping's reply or error calls its callback and then those of
    the pings piggybacked on it, in order, and takes the ping off the
    pending table; unanswered, it emits ``pingTimeout``, and the
    connection's teardown fails the three with the ping timeout."""
    srv = await ZKServer().start()
    clients = []
    try:
        clients, _col = await _fleet(srv, 1, 1)
        conn = clients[0].current_connection()
        calls = []
        done = asyncio.Event()

        def cb(name):
            def call(err, ms):
                calls.append((name, err, ms if name != 'main'
                              else ms is not None))
                if name == 'waiter1':
                    done.set()
            return call
        timeouts = []
        conn.on('pingTimeout', lambda: timeouts.append(1))
        if outcome == 'timeout':
            conn.transport.pause_reading()   # the reply never lands
        conn.ping(cb('main'))
        req = conn.reqs[consts.XID_PING]
        conn.ping(cb('waiter0'))
        conn.ping(cb('waiter1'))
        assert conn.reqs[consts.XID_PING] is req
        if outcome == 'error':
            err = ZKProtocolError('CONNECTION_LOSS', 'lost')
            req.emit('error', err)
        await asyncio.wait_for(done.wait(), 10)
        if outcome == 'timeout':
            err = calls[0][1]
            assert timeouts == [1] and err.code == 'PING_TIMEOUT'
        want = [('main', None if outcome == 'reply' else err,
                 outcome == 'reply'),
                ('waiter0', None if outcome == 'reply' else err, None),
                ('waiter1', None if outcome == 'reply' else err, None)]
        assert calls == want
        assert consts.XID_PING not in conn.reqs
    finally:
        await _close(srv, clients)


if __name__ == '__main__':
    print(json.dumps({'per_session': asyncio.run(_session_footprint())}))
