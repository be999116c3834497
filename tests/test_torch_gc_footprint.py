"""The objects the collector walks for the port's long-lived bookkeeping:
one object per ``StateScope`` registration (utils/fsm.py), settled
spans held as untracked rows (utils/trace.py ``TraceRing``), and what a
connected session holds in all."""

import asyncio
import gc
import itertools
import types

from zkstream_tpu_torch import Client
from zkstream_tpu_torch.server import ZKServer
from zkstream_tpu_torch.utils import trace as T
from zkstream_tpu_torch.utils.events import EventEmitter
from zkstream_tpu_torch.utils.fsm import FSM
from zkstream_tpu_torch.utils.metrics import Collector

#: Tracked objects a connected session holds over the no-client
#: baseline, at most (test (c)).
SESSION_OBJECTS_MAX = 620


def _tracked() -> int:
    gc.collect()
    return len(gc.get_objects())


class _Listening(FSM):
    """A machine whose ``busy`` state registers ``n`` listeners."""

    def __init__(self, emitter, n, cb):
        self.emitter, self.n, self.cb = emitter, n, cb
        self.scope = None
        super().__init__('busy')

    def state_busy(self, S):
        self.scope = S
        for _ in range(self.n):
            S.on(self.emitter, 'ev', self.cb)

    def state_done(self, S):
        pass


def test_scope_registration_is_one_object():
    emitter = EventEmitter()
    calls = []
    cb = calls.append
    before = _tracked()
    m = _Listening(emitter, 1000, cb)
    added = _tracked() - before
    assert added <= 2 * 1000, added
    assert emitter.listener_count('ev') == 1000
    emitter.emit('ev', 1)
    assert calls == [1] * 1000
    guards = emitter.listeners('ev')
    m.scope.goto_state('done')
    assert m.get_state() == 'done'
    assert emitter.listener_count('ev') == 0
    guards[0](2)                      # a stale guard does nothing
    emitter.emit('ev', 3)
    assert calls == [1] * 1000


class _ObjectRing(T.TraceRing):
    """The ring with the rows turned off: a settled span stays the
    ``Span`` it was."""

    def _store(self, span):
        pass

    def _put(self, n, entry):
        super()._put(n, T.Span._of(entry) if type(entry) is tuple
                     else entry)


def _clock(monkeypatch) -> None:
    """The trace module's clocks, restarted: one tick a read."""
    tick = itertools.count(1)
    monkeypatch.setattr(T, 'time', types.SimpleNamespace(
        time=lambda: 1.7e9 + next(tick), perf_counter=lambda: next(tick)
        * 1e-4))


def _feed(ring, monkeypatch):
    """1,000 ops on ``ring`` on a restarted clock, every settle path
    among them; returns the spans left open."""
    _clock(monkeypatch)
    held = []
    for i in range(1000):
        if i % 5 == 0:
            ring.note('NOTIFICATION', '/n', zxid=i, kind='notification',
                      session_id='0x1', batch=2, detail='watch')
        span = ring.start('GET_DATA', '/n%d' % (i % 7))
        span.xid = i
        span.backend = '127.0.0.1:2181'
        span.t_sent = span._t0 + 1e-4
        if i % 97 == 0:
            held.append(span)         # left open
            continue
        if i % 11 == 0:
            span.finish(status='error', error='NO_NODE')
        elif i % 13 == 0:
            span.finish(status='deadline', error='DEADLINE_EXCEEDED')
            span.t_sent = span._t0 + 2e-3   # the frame went out late
            span.restamp()
        else:
            span.finish(zxid=i, t_rx=span.t_sent + 5e-4)
        span.finish(status='error')   # a second settle changes nothing
        span.t_resumed = span._t0 + 9e-3
        span.restamp()
    return held


def _fields(span) -> dict:
    return {f: getattr(span, f) for f in T.Span.__slots__ if f != '_ring'}


def test_ring_holds_settled_spans_as_untracked_rows(monkeypatch):
    before = _tracked()
    n0 = sum(1 for o in gc.get_objects() if type(o) is T.Span)
    ring = T.TraceRing(256)
    held = _feed(ring, monkeypatch)
    gc.collect(0)
    spans = sum(1 for o in gc.get_objects() if type(o) is T.Span)
    assert spans - n0 == len(held) == 11
    # the ring, its slot list, the open spans and the fixed clock: no
    # row is tracked
    assert _tracked() - before <= len(held) + 20
    newest = ring.spans()[-1].span_id
    assert sorted(s.span_id for s in ring.open_spans()) == sorted(
        s.span_id for s in held if s.span_id > newest - 256)
    assert ring.held() == (256 - len(ring.open_spans()),
                           len(ring.open_spans()))

    ref = _ObjectRing(256)
    ref_held = _feed(ref, monkeypatch)
    assert (len(ring), ring.dropped) == (len(ref), ref.dropped) == (
        256, 1200 - 256)
    assert [_fields(s) for s in ring.spans()] == [
        _fields(s) for s in ref.spans()]
    assert ring.dump() == ref.dump()
    assert ring.dump_json() == ref.dump_json()
    assert [s.span_id for s in ring.open_spans()] == [
        s.span_id for s in ref.open_spans()]
    for spans in (held, ref_held):
        _clock(monkeypatch)
        for span in spans:
            span.finish(zxid=1)
    assert ring.open_spans() == [] and ring.held() == (256, 0)
    assert ring.dump() == ref.dump()
    ring.clear()
    assert len(ring) == 0 and ring.spans() == [] and ring.held() == (0, 0)


async def test_connected_session_footprint():
    """Tracked objects per connected port ``Client`` (and its server
    side) after 300 gets each, over the same process with the server
    and no client.  Before settled spans were rows and a scope
    registration one object, this read 827 a session (CPU, 32 clients;
    583 after 10 gets each); the bound is 75 % of that."""
    srv = await ZKServer().start()
    clients = []
    try:
        await asyncio.sleep(0)
        base = _tracked()
        collector = Collector()
        clients = [Client(address='127.0.0.1', port=srv.port,
                          session_timeout=30000, collector=collector)
                   for _ in range(32)]
        for c in clients:
            c.start()
        await asyncio.gather(*[c.wait_connected(timeout=10)
                               for c in clients])
        await clients[0].create('/g', b'x' * 64)

        async def gets(c):
            for _ in range(300):
                await c.get('/g')
        await asyncio.gather(*[gets(c) for c in clients])
        per = (_tracked() - base) / len(clients)
        assert per <= SESSION_OBJECTS_MAX, per
        rows = collector.get_collector(T.METRIC_RING_SPANS)._fn()
        assert sum(rows.values()) == 256 * len(clients)
        assert rows[(('form', 'open'),)] <= len(clients)
        regs = sum(collector.get_collector(
            'zkstream_fsm_scope_registrations')._fn().values())
        assert 10 * len(clients) <= regs <= 40 * len(clients), regs
    finally:
        await asyncio.gather(*[c.close() for c in clients])
        await srv.stop()


def test_chaos_leak_check_sees_open_spans_among_rows():
    """The campaigns' teardown check (io/faults.py) still finds an open
    span in a ring whose settled spans are rows."""
    from zkstream_tpu_torch.io.faults import _note_open_spans

    ring = T.TraceRing(8)
    for i in range(20):
        ring.start('CREATE', '/c%d' % i).finish(zxid=i)
    lost = ring.start('GET_DATA', '/lost')
    ring.note('NOTIFICATION', '/c1', zxid=2)
    res = types.SimpleNamespace(violations=[])
    _note_open_spans(res, ring)
    assert res.violations == [
        '1 trace span(s) left open after teardown: #%d GET_DATA'
        % (lost.span_id,)]
    lost.finish(status='abandoned', error='CONNECTION_LOSS')
    res.violations.clear()
    _note_open_spans(res, ring)
    assert res.violations == []
