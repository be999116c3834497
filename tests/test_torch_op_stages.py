"""Op stages of the port (utils/trace.py ``Span.stage_ms``): each client
op's latency split into ``send``, ``remote``, ``ingest`` and ``resume``
on its own span, observed into ``zookeeper_op_stage_ms``; and the
port's profiler ranges, off by default (``set_profiler_ranges``)."""

import asyncio
import gc
import math

import pytest

from zkstream_tpu_torch import Client, ZKDeadlineError
from zkstream_tpu_torch.client import METRIC_ZK_OP_LATENCY, \
    METRIC_ZK_OP_STAGE
from zkstream_tpu_torch.io.ingest import FleetIngest
from zkstream_tpu_torch.protocol.errors import ZKError, ZKProtocolError
from zkstream_tpu_torch.server import ZKServer
from zkstream_tpu_torch.utils import trace as T
from zkstream_tpu_torch.utils.metrics import Collector, Histogram

#: The five ranges the port opens while the switch is on.
RANGES = ('zk.read', 'zk.flush', 'zk.route', 'zk.call', 'zk.reply')


async def _fleet(port: int, n: int, ingest=None, collector=None):
    clients = [Client(address='127.0.0.1', port=port, session_timeout=10000,
                      ingest=ingest, collector=collector)
               for _ in range(n)]
    for c in clients:
        c.start()
    await asyncio.gather(*[c.wait_connected(timeout=10) for c in clients])
    return clients


async def _rounds(clients, rounds: int) -> None:
    """``rounds`` closed-loop rounds: every client sets then gets its
    own node, all clients at once."""
    async def one(i, c):
        for r in range(rounds):
            await c.set('/s%d' % (i,), b'v%d' % (r,))
            await c.get('/s%d' % (i,))
    await asyncio.gather(*[one(i, c) for i, c in enumerate(clients)])


def _sums(col: Collector) -> tuple:
    lat = col.get_collector(METRIC_ZK_OP_LATENCY)
    st = col.get_collector(METRIC_ZK_OP_STAGE)
    total = sum(lat.sum(dict(k)) for k in lat.label_keys())
    return total, {s: st.sum({'stage': s}) for s in T.OP_STAGES}, \
        {s: st.count({'stage': s}) for s in T.OP_STAGES}


def _check_spans(clients, ingest_max_ms=None) -> int:
    """Every settled op span: four stages >= 0 that add up to its
    latency.  Returns how many were checked."""
    n = 0
    for c in clients:
        for span in c.trace.spans():
            if span.kind != 'op' or span.t_resumed is None:
                continue
            stages = span.stage_ms()
            assert all(s is not None and s >= 0 for s in stages), stages
            latency = (span.t_resumed - span._t0) * 1000.0
            assert math.isclose(sum(stages), latency, rel_tol=1e-9,
                                abs_tol=1e-6)
            if ingest_max_ms is not None:
                assert stages[2] <= ingest_max_ms, stages
            d = span.to_dict()
            for s, v in zip(T.OP_STAGES, stages):
                assert d[s + '_ms'] == round(v, 3)
            n += 1
    return n


@pytest.mark.parametrize('fleet', ['ingest16', 'plain'])
async def test_stages_add_up_to_latency(fleet):
    srv = await ZKServer().start()
    ingest = (FleetIngest(device='cpu', bypass_bytes=0, warm='block')
              if fleet == 'ingest16' else None)
    col = Collector()
    clients = await _fleet(srv.port, 16 if ingest else 2, ingest, col)
    try:
        for i in range(len(clients)):
            await clients[i].create('/s%d' % (i,), b'')
        await _rounds(clients, 6)
        if ingest is not None:
            assert ingest.ticks > 0            # the batched path ran
        # the plain drain reads and routes in one callback
        n = _check_spans(clients, None if ingest else 5.0)
        assert n >= len(clients) * 12
        total, sums, counts = _sums(col)
        assert all(counts[s] == counts['send'] for s in T.OP_STAGES)
        assert abs(sum(sums.values()) - total) <= 0.01 * total
        if ingest is None:
            # ~0: nothing batches the per-socket drain
            assert sums['ingest'] <= 0.05 * total
    finally:
        await asyncio.gather(*[c.close() for c in clients])
        await srv.stop()
        if ingest is not None:
            ingest.close()


async def test_error_and_deadline_ops_skip_unreached_stages():
    srv = await ZKServer().start()
    col = Collector()
    c, = await _fleet(srv.port, 1, collector=col)
    try:
        # an error reply is routed and resumed: every stage
        with pytest.raises(ZKError):
            await c.get('/missing')
        err = c.trace.spans()[-1]
        assert err.status == 'error'
        assert all(s is not None for s in err.stage_ms())
        _total, _sums_, before = _sums(col)
        # a deadline: sent, never routed
        srv.drop_replies = True
        with pytest.raises(ZKDeadlineError):
            await c.get('/missing', deadline=50)
        dl = c.trace.spans()[-1]
        assert dl.status == 'deadline' and dl.t_sent is not None
        assert dl.t_routed is None
        assert dl.stage_ms()[1:] == (None, None, None)
        # an op torn down in flight: sent, abandoned, never routed
        op = asyncio.ensure_future(c.get('/missing', deadline=None))
        await asyncio.sleep(0.05)
        c.current_connection().destroy()
        with pytest.raises((ZKError, ZKProtocolError)):
            await op
        lost = c.trace.spans()[-1]
        assert lost.status in ('error', 'abandoned')
        assert lost.t_routed is None and lost.stage_ms()[0] is not None
        _total, _sums_, after = _sums(col)
        assert after['send'] - before['send'] == 2
        assert all(after[s] == before[s]
                   for s in ('remote', 'ingest', 'resume'))
        lat = col.get_collector(METRIC_ZK_OP_LATENCY)
        assert lat.count({'op': 'GET_DATA'}) == 3
        srv.drop_replies = False
    finally:
        await c.close()
        await srv.stop()


@pytest.mark.parametrize('value', [0.0, 0.01, 0.0100001, 7.5, 10000.0,
                                   10000.5, 3e9])
def test_resolved_series_land_where_the_labelled_observe_does(value):
    """``Histogram.series`` and ``Histogram.rows`` (the op path's
    resolved rows) bucket and sum a value as ``observe(value, labels)``
    does: on a bound, between two, past the last."""
    from zkstream_tpu_torch.client import STAGE_BUCKETS

    ref = Histogram('ref', '', buckets=STAGE_BUCKETS)
    got = Histogram('got', '', buckets=STAGE_BUCKETS)
    ref.observe(value, {'stage': 'send'})
    ref.observe(value, {'stage': 'resume'})
    got.series({'stage': 'send'}).observe(value)
    got.rows('stage', T.OP_STAGES).observe_each((None, None, None, value))
    for st in ('send', 'resume'):
        assert got._row({'stage': st}) == ref._row({'stage': st})
    assert got.count({'stage': 'remote'}) == 0


async def test_ops_add_no_tracked_objects_once_the_ring_is_full():
    """The stamps add no object the collector tracks: over 2,000 ops
    (rings full) the collector's gen-0 count, which counts tracked
    objects made and not yet freed, and the live tracked objects grow
    by less than a quarter of an object an op; no slot of a settled op
    span holds a tracked object (a tuple stored on a span lives as long
    as the ring keeps it); the corked-span list and the stage series
    are the ones the client started with."""
    srv = await ZKServer().start()
    c, = await _fleet(srv.port, 1)
    try:
        await c.create('/g', b'x')
        for _ in range(600):          # the client and server rings fill
            await c.get('/g')
        conn = c.current_connection()
        corked = conn._corked_spans
        stages = c.collector.get_collector(METRIC_ZK_OP_STAGE)
        n_ops = 2000
        gc.collect()
        gc.disable()
        try:
            live0 = len(gc.get_objects())
            born0 = gc.get_count()[0]
            for _ in range(n_ops):
                await c.get('/g')
            born = gc.get_count()[0] - born0
            gc.collect()
            live = len(gc.get_objects()) - live0
        finally:
            gc.enable()
        assert born < n_ops // 4, born
        assert live < n_ops // 4, live
        spans = [s for s in c.trace.spans() if s.kind == 'op']
        assert len(spans) == c.trace.capacity
        held = [(f, type(getattr(s, f)).__name__) for s in spans
                for f in T.Span.__slots__ if gc.is_tracked(getattr(s, f))]
        assert not held, held[:4]
        assert conn._corked_spans is corked and conn._tx._spans is corked
        assert sorted(stages.label_keys()) == sorted(
            (('stage', st),) for st in T.OP_STAGES)
    finally:
        await c.close()
        await srv.stop()


async def test_ranges_off_make_no_profiler_call(monkeypatch):
    import torch

    def refuse(*a, **kw):
        raise AssertionError('a profiler call with the ranges off')
    assert T.profiler_ranges is False
    ops = torch.ops.profiler
    monkeypatch.setattr(ops, '_record_function_enter_new', refuse)
    monkeypatch.setattr(ops, '_record_function_exit', refuse)
    monkeypatch.setattr(torch._C._profiler, '_RecordFunctionFast', refuse)
    srv = await ZKServer().start()
    ingest = FleetIngest(device='cpu', bypass_bytes=0, warm='block')
    clients = (await _fleet(srv.port, 4, ingest)
               + await _fleet(srv.port, 1))
    try:
        for i in range(len(clients)):
            await clients[i].create('/s%d' % (i,), b'')
        await _rounds(clients, 3)
        await clients[-1].ping()
    finally:
        await asyncio.gather(*[c.close() for c in clients])
        await srv.stop()
        ingest.close()


async def test_ranges_on_appear_in_a_cpu_profile():
    import torch

    srv = await ZKServer().start()
    c, = await _fleet(srv.port, 1)
    try:
        await c.create('/p', b'')
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            T.set_profiler_ranges(True)
            try:
                for _ in range(3):
                    await c.set('/p', b'x')
                    await c.get('/p')
            finally:
                T.set_profiler_ranges(False)
        names = {e.name for e in prof.events()}
        assert set(RANGES) <= names, names & set(RANGES)
        assert T._op_open is None
        # nested as opened: on the per-socket drain a reply routes
        # inside the socket read that brought it
        reads = [e.time_range for e in prof.events() if e.name == 'zk.read']
        routes = [e.time_range for e in prof.events()
                  if e.name == 'zk.route']
        assert routes and all(any(r.start <= x.start and x.end <= r.end
                                  for r in reads) for x in routes)
    finally:
        await c.close()
        await srv.stop()
