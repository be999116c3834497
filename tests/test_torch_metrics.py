"""The port's metrics (the port of tests/test_metrics.py): labelled
counters, Prometheus exposition, the client's event counter (the
rebuild's artedi equivalent, reference: lib/client.js:29,58-61,222-235),
histograms and the tick ledger.  Server-facing cases run on the port's
server and on the JAX package's."""

import pytest

from zkstream_tpu_torch import Client, Collector
from test_torch_basic import server, server_cls  # noqa: F401


def test_counter_labels_and_exposition():
    c = Collector()
    ctr = c.counter('zookeeper_events', 'Total number of zookeeper events')
    assert c.counter('zookeeper_events') is ctr  # idempotent
    ctr.increment({'evtype': 'session'})
    ctr.increment({'evtype': 'connect'})
    ctr.increment({'evtype': 'connect'})
    assert ctr.value({'evtype': 'connect'}) == 2
    assert ctr.value({'evtype': 'session'}) == 1
    assert ctr.value({'evtype': 'nope'}) == 0
    text = c.expose()
    assert '# HELP zookeeper_events Total number of zookeeper events' \
        in text
    assert '# TYPE zookeeper_events counter' in text
    assert 'zookeeper_events{evtype="connect"} 2.0' in text


async def test_client_counts_events_and_notifications(server):
    """An injected collector sees zookeeper_events increments for the
    session/connect lifecycle and zookeeper_notifications per watch
    fire (reference counter names, lib/client.js:29,
    lib/zk-session.js:25)."""
    coll = Collector()
    c = Client(address='127.0.0.1', port=server.port,
               session_timeout=5000, collector=coll)
    c.start()
    await c.wait_connected(timeout=5)
    ev = coll.get_collector('zookeeper_events')
    assert ev.value({'evtype': 'session'}) == 1
    assert ev.value({'evtype': 'connect'}) == 1

    await c.create('/m', b'a')
    seen = []
    c.watcher('/m').on('dataChanged', lambda d, s: seen.append(bytes(d)))
    from helpers import wait_until
    await wait_until(lambda: seen == [b'a'])
    await c.set('/m', b'b')
    await wait_until(lambda: seen == [b'a', b'b'])
    notif = coll.get_collector('zookeeper_notifications')
    assert notif.value({'event': 'dataChanged'}) >= 1
    await c.close()


async def test_ingest_gauges(server):
    """FleetIngest binds pull-model gauges (device/scalar/warming
    ticks, frames, body fallbacks) onto the collector; exposition
    reads live values at scrape time."""
    from zkstream_tpu_torch import Client, Collector
    from zkstream_tpu_torch.io.ingest import FleetIngest

    col = Collector()
    ingest = FleetIngest(device='cpu', body_mode='host', max_frames=8,
                         bypass_bytes=0, warm='block')
    ingest.bind_metrics(col)
    assert 'zkstream_ingest_ticks 0' in col.expose()
    c = Client(address='127.0.0.1', port=server.port,
               session_timeout=5000, ingest=ingest)
    c.start()
    try:
        await c.wait_connected(timeout=5)
        await ingest.prewarm(1)
        await c.create('/g', b'v')
        data, _stat = await c.get('/g')
        assert data == b'v'
        text = col.expose()
        assert 'zkstream_ingest_ticks %d' % ingest.ticks in text
        assert ingest.ticks > 0
        assert 'zkstream_ingest_frames_routed %d' \
            % ingest.frames_routed in text
        assert '# TYPE zkstream_ingest_ticks gauge' in text
    finally:
        await c.close()


def test_gauge_callback_failure_does_not_sink_exposition():
    from zkstream_tpu_torch import Collector

    col = Collector()
    col.gauge('ok_gauge', lambda: 7)
    col.gauge('bad_gauge', lambda: 1 / 0)
    text = col.expose()
    assert 'ok_gauge 7' in text
    assert 'bad_gauge nan' in text


def test_label_values_escaped_per_exposition_spec():
    """A quote/backslash/newline in a label value must not produce
    unparseable scrape text (a path label can carry any of them)."""
    c = Collector()
    ctr = c.counter('paths_total')
    ctr.increment({'path': '/a"b\\c\nd'})
    text = ctr.expose()
    assert 'paths_total{path="/a\\"b\\\\c\\nd"} 1.0' in text
    # and the same escaping on histogram series
    h = c.histogram('lat_ms', buckets=(1.0,))
    h.observe(0.5, {'path': 'x"y'})
    assert 'lat_ms_bucket{path="x\\"y",le="1"} 1' in h.expose()


def test_get_collector_unknown_name_is_a_clear_error():
    c = Collector()
    c.counter('known_counter')
    with pytest.raises(ValueError) as ei:
        c.get_collector('nope_metric')
    assert 'nope_metric' in str(ei.value)
    assert 'known_counter' in str(ei.value)


def test_histogram_bucket_inf_sum_count_semantics():
    """_bucket series are cumulative with a +Inf catch-all; _sum and
    _count aggregate every observation including over-the-top ones."""
    from zkstream_tpu_torch.utils.metrics import Histogram

    h = Histogram('lat_ms', 'latency', buckets=(1.0, 10.0, 100.0))
    for v in (0.5, 5.0, 5.0, 50.0, 5000.0):
        h.observe(v, {'op': 'GET'})
    assert h.count({'op': 'GET'}) == 5
    assert h.sum({'op': 'GET'}) == 0.5 + 5.0 + 5.0 + 50.0 + 5000.0
    assert h.bucket_value(1.0, {'op': 'GET'}) == 1
    assert h.bucket_value(10.0, {'op': 'GET'}) == 3
    assert h.bucket_value(100.0, {'op': 'GET'}) == 4
    assert h.bucket_value(float('inf'), {'op': 'GET'}) == 5
    text = h.expose()
    assert '# TYPE lat_ms histogram' in text
    assert 'lat_ms_bucket{op="GET",le="1"} 1' in text
    assert 'lat_ms_bucket{op="GET",le="10"} 3' in text
    assert 'lat_ms_bucket{op="GET",le="100"} 4' in text
    assert 'lat_ms_bucket{op="GET",le="+Inf"} 5' in text
    assert 'lat_ms_count{op="GET"} 5' in text
    assert 'lat_ms_sum{op="GET"} 5060.5' in text
    # unlabelled series are independent
    h.observe(2.0)
    assert h.count() == 1 and h.count({'op': 'GET'}) == 5


def test_collector_histogram_idempotent_and_collision_checked():
    c = Collector()
    h = c.histogram('lat_ms')
    assert c.histogram('lat_ms') is h
    assert c.get_collector('lat_ms') is h
    with pytest.raises(ValueError):
        c.counter('lat_ms')
    with pytest.raises(ValueError):
        c.gauge('lat_ms', lambda: 0)
    # re-registering with different bounds would silently mis-bucket
    # the second registrant's observations — it must raise instead
    with pytest.raises(ValueError) as ei:
        c.histogram('lat_ms', buckets=(1.0, 2.0))
    assert 'lat_ms' in str(ei.value)


async def test_client_per_op_latency_histograms(server):
    """Every client op records into zookeeper_op_latency_ms, labelled
    by opcode, with coherent _bucket/_sum/_count series."""
    coll = Collector()
    c = Client(address='127.0.0.1', port=server.port,
               session_timeout=5000, collector=coll)
    c.start()
    try:
        await c.wait_connected(timeout=5)
        await c.create('/h', b'v')
        await c.get('/h')
        await c.get('/h')
        await c.set('/h', b'w')
        await c.list('/')
        await c.ping()
        h = coll.get_collector('zookeeper_op_latency_ms')
        assert h.count({'op': 'CREATE'}) == 1
        assert h.count({'op': 'GET_DATA'}) == 2
        assert h.count({'op': 'SET_DATA'}) == 1
        assert h.count({'op': 'GET_CHILDREN2'}) == 1
        assert h.count({'op': 'PING'}) == 1
        assert h.sum({'op': 'GET_DATA'}) > 0
        text = coll.expose()
        assert 'zookeeper_op_latency_ms_bucket{op="CREATE",le="+Inf"} 1' \
            in text
        assert 'zookeeper_op_latency_ms_count{op="GET_DATA"} 2' in text
        # connect+handshake latency landed too
        ch = coll.get_collector('zookeeper_connect_latency_ms')
        assert ch.count({'backend': '127.0.0.1:%d' % server.port}) >= 1
    finally:
        await c.close()


async def test_fsm_transition_metrics_and_state_gauge(server):
    """Every FSM (client/connection/session/pool) feeds the shared
    transition counter and the live current-state gauge."""
    coll = Collector()
    c = Client(address='127.0.0.1', port=server.port,
               session_timeout=5000, collector=coll)
    c.start()
    try:
        await c.wait_connected(timeout=5)
        ctr = coll.get_collector('zkstream_fsm_transitions')
        assert ctr.value({'fsm': 'ZKConnection',
                          'from': 'handshaking',
                          'to': 'connected'}) >= 1
        assert ctr.value({'fsm': 'ZKSession', 'from': 'attaching',
                          'to': 'attached'}) == 1
        # the pool flips to 'running' on the dial task's next wakeup,
        # which may trail the client's 'connect' emission by a tick
        from helpers import wait_until
        await wait_until(lambda: ctr.value(
            {'fsm': 'ConnectionPool', 'from': 'starting',
             'to': 'running'}) == 1)
        text = coll.expose()
        assert 'zkstream_fsm_state{fsm="ZKSession",state="attached"} ' \
            '1.0' in text
        assert 'zkstream_fsm_state{fsm="ZKClient",state="normal"} 1.0' \
            in text
    finally:
        await c.close()
    # after close, the census reflects the terminal states
    text = coll.expose()
    assert 'zkstream_fsm_state{fsm="ZKClient",state="closed"} 1.0' \
        in text


def test_gauge_name_collision_raises():
    """Silently replacing a gauge would drop the first registrant's
    series; two ingests sharing a collector use distinct prefixes."""
    from zkstream_tpu_torch import Collector
    from zkstream_tpu_torch.io.ingest import FleetIngest

    col = Collector()
    a, b = FleetIngest(device='cpu'), FleetIngest(device='cpu')
    a.bind_metrics(col)
    with pytest.raises(ValueError):
        b.bind_metrics(col)
    b.bind_metrics(col, prefix='b_')
    text = col.expose()
    assert 'zkstream_ingest_ticks 0' in text
    assert 'b_zkstream_ingest_ticks 0' in text
    # gauges are reachable through the same lookup as counters
    assert col.get_collector('b_zkstream_ingest_ticks') is not None


def test_histogram_percentile_interpolation():
    """Histogram percentiles interpolate inside the bucket that holds
    the rank (the histogram_quantile rule), clamp at the largest
    finite bound for +Inf samples, and NaN on empty series — the
    estimator bench.py publishes per-op p50/p99 through."""
    import math

    from zkstream_tpu_torch.utils.metrics import Histogram

    h = Histogram('t_ms', buckets=(1.0, 10.0, 100.0))
    assert math.isnan(h.percentile(50))
    for _ in range(50):
        h.observe(0.5)               # <= 1.0 bucket
    for _ in range(50):
        h.observe(50.0)              # <= 100.0 bucket
    # rank 50 sits exactly at the top of the first bucket
    assert h.percentile(50) == pytest.approx(1.0)
    # rank 75 is halfway through the (10, 100] bucket
    assert h.percentile(75) == pytest.approx(55.0)
    h2 = Histogram('t2_ms', buckets=(1.0, 10.0))
    h2.observe(1000.0)               # +Inf-only sample
    assert h2.percentile(99) == pytest.approx(10.0)  # clamped
    # labelled series are independent
    h3 = Histogram('t3_ms', buckets=(1.0, 10.0))
    h3.observe(0.2, {'op': 'GET'})
    h3.observe(8.0, {'op': 'SET'})
    assert h3.percentile(50, {'op': 'GET'}) <= 1.0
    assert h3.percentile(50, {'op': 'SET'}) > 1.0
    assert {dict(k)['op'] for k in h3.label_keys()} == {'GET', 'SET'}


# -- the tick ledger (utils/metrics.TickLedger) ------------------------

def test_tick_ledger_nested_phases_subtract():
    """A nested section's time is counted once (in the inner phase),
    and phase sums can never exceed the tick's wall span."""
    import time

    from zkstream_tpu_torch.utils.metrics import TickLedger

    led = TickLedger()
    led.enter('decode_apply')
    time.sleep(0.002)
    led.enter('fsync_gate')          # e.g. sync='always' inside append
    time.sleep(0.002)
    led.exit()
    time.sleep(0.001)
    led.exit()
    led.close_tick()                 # no loop: manual close
    assert led.ticks == 1
    tick = led.last_tick
    phases = tick['phases']
    assert set(phases) == {'decode_apply', 'fsync_gate'}
    assert phases['fsync_gate'] >= 1.5
    # the parent's accumulation excludes the nested child
    assert phases['decode_apply'] >= 2.5
    total = sum(phases.values())
    assert total <= tick['total_ms'] + 1e-6
    # and in this gap-free synchronous drive, sums to it (slop for
    # the enter/exit bookkeeping itself)
    assert tick['total_ms'] - total < 1.0


def test_tick_ledger_phase_p99_and_scrape():
    from zkstream_tpu_torch.utils.metrics import (
        Collector,
        TickLedger,
        scrape_tick_cells,
    )

    col = Collector()
    led = TickLedger(col)
    for _ in range(4):
        led.enter('cork_flush')
        led.exit()
        led.close_tick()
    assert led.ticks == 4
    assert led.phase_p99('cork_flush') is not None
    assert led.phase_p99('fanout_flush') is None
    cells = scrape_tick_cells(col)
    assert cells['ticks'] == 4
    assert 'cork_flush' in cells['phases']
    ph = cells['phases']['cork_flush']
    assert ph['count'] == 4
    assert 0.0 <= ph['share'] <= 1.0


async def test_tick_ledger_coalesces_spilled_callbacks():
    """call_soon callbacks scheduled during a tick's processing run in
    the NEXT loop iteration (the cork/fan-out flushes of one logical
    tick): the close callback re-arms while activity continues, so
    the whole burst lands in ONE ledger tick."""
    import asyncio

    from zkstream_tpu_torch.utils.metrics import TickLedger

    led = TickLedger()
    loop = asyncio.get_running_loop()

    def flush():                     # the spill-over callback
        led.enter('cork_flush')
        led.exit()

    led.enter('decode_apply')
    loop.call_soon(flush)            # scheduled mid-tick
    led.exit()
    for _ in range(4):               # let the burst + close drain
        await asyncio.sleep(0)
    assert led.ticks == 1
    assert set(led.last_tick['phases']) == {'decode_apply',
                                            'cork_flush'}


async def test_tick_ledger_sums_to_busy_tick_on_live_server(server):
    """Acceptance: the phase histograms sum (within slop) to the
    observed busy-tick duration on a real server under a pipelined
    write burst."""
    from zkstream_tpu_torch import Client
    from zkstream_tpu_torch.utils.metrics import METRIC_TICK_PHASE

    c = Client(address='127.0.0.1', port=server.port,
               session_timeout=5000)
    c.start()
    try:
        await c.wait_connected(timeout=5)
        await c.create('/t', b'x')
        for i in range(20):
            await c.set('/t', b'v%d' % i)
    finally:
        await c.close()
    led = server.ledger
    assert led is not None and led.ticks > 0
    phase_total = sum(
        led.phase_hist.sum(dict(k))
        for k in led.phase_hist.label_keys())
    tick_total = led.tick_hist.sum()
    assert led.phase_hist.name == METRIC_TICK_PHASE
    # phases are exclusive slices of each tick's [first, last] window
    assert phase_total <= tick_total + 1e-6
    # and cover most of it (the gap is un-instrumented loop work;
    # generous slop for a loaded CI core)
    assert phase_total >= 0.25 * tick_total, \
        (phase_total, tick_total)


async def test_scrape_after_chaos_schedule_smoke():
    """One seeded chaos schedule with an injected collector: the
    post-campaign scrape must expose cleanly — no NaN gauges, and
    every registered histogram readable with >= 0 samples."""
    from zkstream_tpu_torch.io.faults import run_schedule

    coll = Collector()
    res = await run_schedule(17, ops=4, collector=coll)
    assert res.ok, res.violations
    text = coll.expose()
    assert ' nan' not in text
    hists = coll.histograms()
    assert any(h.name == 'zookeeper_op_latency_ms' for h in hists)
    for h in hists:
        for key in list(h._series) or [()]:
            assert h.count(dict(key)) >= 0
    # ops ran, so per-op latency actually observed samples
    assert coll.get_collector('zookeeper_op_latency_ms').count(
        {'op': 'CREATE'}) >= 1
