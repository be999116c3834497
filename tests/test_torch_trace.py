"""Causal-tracing tests of the port (utils/trace.py; the port of
tests/test_trace.py): span lifecycle, xid/zxid correlation through the
connection, the bounded ring, and the zxid-merged timeline of one
member.  Server-facing cases run on the port's server and on the JAX
package's, and so do the cross-member merges on both packages'
``ZKEnsemble``; the chaos dumps are the port's fault plane's."""

import asyncio
import json

import pytest

from helpers import wait_until
from zkstream_tpu_torch import Client, ZKDeadlineError
from zkstream_tpu_torch.utils.trace import (
    TRACE_SCHEMA,
    TraceRing,
    format_spans,
    format_timeline,
    merge_timelines,
)
from test_torch_basic import ensemble_cls, server, server_cls  # noqa: F401


def test_ring_is_bounded_and_ordered():
    ring = TraceRing(capacity=4)
    for i in range(10):
        ring.start('OP%d' % i).finish(zxid=i)
    assert len(ring) == 4
    dump = ring.dump()
    assert [s['op'] for s in dump] == ['OP6', 'OP7', 'OP8', 'OP9']
    assert all(s['status'] == 'ok' for s in dump)
    # dumps are JSON-ready
    json.loads(ring.dump_json())
    ring.clear()
    assert len(ring) == 0


def test_span_double_finish_keeps_first_outcome():
    ring = TraceRing()
    span = ring.start('GET_DATA', '/x')
    span.finish(zxid=7, status='ok')
    span.finish(status='error', error='CONNECTION_LOSS')
    d = span.to_dict()
    assert d['status'] == 'ok' and d['zxid'] == 7
    assert 'error' not in d


def test_format_spans_is_readable_and_bounded():
    ring = TraceRing()
    for i in range(6):
        ring.start('CREATE', '/n%d' % i).finish(zxid=i)
    text = format_spans(ring.dump(), limit=3)
    assert text.count('\n') == 2          # 3 lines
    assert 'CREATE' in text and '/n5' in text


async def test_client_spans_are_xid_and_zxid_correlated(server):
    c = Client(address='127.0.0.1', port=server.port,
               session_timeout=5000)
    c.start()
    try:
        await c.wait_connected(timeout=5)
        await c.create('/t', b'a')
        await c.set('/t', b'b')
        await c.get('/t')
        spans = {s['op']: s for s in c.trace.dump()}
        create, st, get = (spans['CREATE'], spans['SET_DATA'],
                           spans['GET_DATA'])
        # xids are the connection's, strictly increasing per request
        assert 0 < create['xid'] < st['xid'] < get['xid']
        # replies stamped each span with the server's zxid
        assert create['zxid'] == 1 and st['zxid'] == 2
        assert get['zxid'] == 2              # reads carry head zxid
        for s in (create, st, get):
            assert s['status'] == 'ok'
            assert s['duration_ms'] >= 0
            assert s['backend'] == '127.0.0.1:%d' % server.port
            assert s['session_id'] == c.session.get_session_id()
    finally:
        await c.close()


async def test_error_and_deadline_spans(server):
    c = Client(address='127.0.0.1', port=server.port,
               session_timeout=5000)
    c.start()
    try:
        await c.wait_connected(timeout=5)
        with pytest.raises(Exception):
            await c.get('/missing')
        err_span = [s for s in c.trace.dump()
                    if s['op'] == 'GET_DATA'][-1]
        assert err_span['status'] == 'error'
        assert err_span['error'] == 'NO_NODE'

        await c.create('/d', b'x')
        server.drop_replies = True
        with pytest.raises(ZKDeadlineError):
            await c.get('/d', deadline=150)
        dl_span = [s for s in c.trace.dump()
                   if s['op'] == 'GET_DATA'][-1]
        assert dl_span['status'] == 'deadline'
        assert dl_span['error'] == 'DEADLINE_EXCEEDED'
    finally:
        server.drop_replies = False
        await c.close()


async def test_notifications_recorded_in_ring(server):
    c = Client(address='127.0.0.1', port=server.port,
               session_timeout=5000)
    c.start()
    try:
        await c.wait_connected(timeout=5)
        await c.create('/n', b'a')
        seen = []
        c.watcher('/n').on('dataChanged',
                           lambda d, s: seen.append(bytes(d)))
        await wait_until(lambda: seen == [b'a'])
        await c.set('/n', b'b')
        await wait_until(lambda: seen == [b'a', b'b'])
        notifs = [s for s in c.trace.dump()
                  if s['kind'] == 'notification']
        assert notifs and notifs[-1]['path'] == '/n'
        # stamped with the session's last-tracked zxid at delivery
        # (the notification may outrun the write reply's zxid)
        assert notifs[-1]['zxid'] >= 1
    finally:
        await c.close()


async def test_injected_ring_and_capacity(server):
    ring = TraceRing(capacity=3)
    c = Client(address='127.0.0.1', port=server.port,
               session_timeout=5000, trace=ring)
    c.start()
    try:
        await c.wait_connected(timeout=5)
        assert c.trace is ring
        for i in range(5):
            await c.create('/r%d' % i, b'x')
        assert len(ring) == 3
        assert [s['path'] for s in ring.dump()] == ['/r2', '/r3', '/r4']
    finally:
        await c.close()


# -- schema, stable ordering, ring accounting --------------------------

def test_span_to_dict_is_stable_ordered():
    """Key order is fixed regardless of the order fields were set —
    trace-out JSON must be byte-stable per span (trace_schema 3)."""
    ring = TraceRing(member='7')
    a = ring.start('SET_DATA', '/x')
    a.backend = 'b:1'
    a.xid = 3
    a.finish(zxid=9)
    b = ring.start('SET_DATA', '/x')
    b.xid = 3
    b.backend = 'b:1'
    b.finish(zxid=9)
    assert list(a.to_dict()) == list(b.to_dict())
    assert list(a.to_dict())[:5] == ['span', 'kind', 'op', 'status',
                                     't_wall']
    # member stamped from the ring; new fields serialize when set
    assert a.to_dict()['member'] == '7'
    s = ring.note('GROUP_FSYNC', zxid=4, kind='server', batch=3,
                  nbytes=120, detail='tick', duration_ms=1.25)
    d = s.to_dict()
    assert (d['batch'], d['nbytes'], d['detail']) == (3, 120, 'tick')
    # explicit duration survives the instant close (pre-measured
    # stages: GROUP_FSYNC, WAL_RECOVER)
    assert d['duration_ms'] == 1.25
    assert TRACE_SCHEMA == 3


def test_ring_counts_dropped_overwrites():
    ring = TraceRing(capacity=4)
    for i in range(4):
        ring.start('OP%d' % i).finish()
    assert ring.dropped == 0
    for i in range(3):
        ring.start('X%d' % i).finish()
    assert ring.dropped == 3
    assert len(ring) == 4


def test_open_spans_and_abandoned_settle():
    ring = TraceRing()
    s1 = ring.start('GET_DATA', '/a')
    ring.start('SET_DATA', '/b').finish(zxid=1)
    assert ring.open_spans() == [s1]
    s1.finish(status='abandoned', error='CONNECTION_LOSS')
    assert ring.open_spans() == []
    assert s1.to_dict()['status'] == 'abandoned'


async def test_destroyed_connection_abandons_spans(server):
    """An op evicted from the pending table by connection teardown
    (destroy: no error routing) settles its span as 'abandoned' —
    never left open (the chaos campaigns assert the ring is fully
    settled after every schedule)."""
    c = Client(address='127.0.0.1', port=server.port,
               session_timeout=5000, op_timeout=None)
    c.start()
    try:
        await c.wait_connected(timeout=5)
        server.drop_replies = True
        conn = c.current_connection()
        task = asyncio.get_running_loop().create_task(c.get('/nope'))
        await asyncio.sleep(0.05)      # request lands in the table
        conn.destroy()
        with pytest.raises(Exception):
            await task
        span = [s for s in c.trace.dump()
                if s['op'] == 'GET_DATA'][-1]
        assert span['status'] == 'abandoned'
        assert not c.trace.open_spans()
    finally:
        server.drop_replies = False
        await c.close()


# -- the cross-member merge --------------------------------------------


# -- the single-member merge --------------------------------------------

async def test_single_member_timeline_span_by_span(server_cls, tmp_path):
    """One watched write through one WAL-backed member: client submit
    -> commit -> WAL append -> the group-fsync span (batch-stamped) ->
    fan-out delivery, merged by zxid from the client's ring and the
    member's."""
    srv = await server_cls(wal_dir=str(tmp_path), durability='tick').start()
    client = Client(address='127.0.0.1', port=srv.port,
                    session_timeout=8000)
    client.start()
    try:
        await client.wait_connected(timeout=10)
        await client.create('/w', b'v0')
        fires = []
        client.watcher('/w').on('dataChanged', lambda *a: fires.append(a))
        await wait_until(lambda: fires)        # armed; arm-emit in
        stat = await client.set('/w', b'v1')
        await wait_until(lambda: len(fires) >= 2)
        await client.sync('/w')
        rings = {'client': client.trace.dump(),
                 'member': srv.trace.dump()}
    finally:
        await client.close()
        await srv.stop()
    merged = merge_timelines(rings)
    chain = [(e['source'], e['op']) for e in merged
             if e['zxid'] == stat.mzxid
             and e['op'] in ('SET_DATA', 'COMMIT', 'WAL_APPEND',
                             'GROUP_FSYNC', 'FANOUT')]
    # member-stamped spans carry their member id as the source
    assert chain == [('client', 'SET_DATA'), ('member:0', 'COMMIT'),
                     ('member:0', 'WAL_APPEND'),
                     ('member:0', 'GROUP_FSYNC'),
                     ('member:0', 'FANOUT')], chain
    fan = [e for e in merged if e['zxid'] == stat.mzxid
           and e['op'] == 'FANOUT'][0]
    assert fan['batch'] == 1 and fan['nbytes'] > 0
    assert 'GROUP_FSYNC' in format_timeline(merged)


async def test_chaos_schedule_result_carries_trace():
    """Every chaos schedule result ships its span dump — the substrate
    for the on-failure print in tests/test_chaos.py and the chaos CLI
    (which adds --trace-out for offline triage) — plus, since the
    server grew its trace plane, the member ring(s), with every span
    settled."""
    from zkstream_tpu_torch.io.faults import run_schedule

    res = await run_schedule(5, ops=3)
    assert res.trace, 'span ring dump missing from schedule result'
    assert any(s['op'] == 'CREATE' for s in res.trace)
    json.dumps(res.trace)          # JSON-ready for --trace-out
    assert format_spans(res.trace)  # and renderable for failures
    assert res.member_rings, 'member ring missing from result'
    member_ops = {s['op'] for spans in res.member_rings.values()
                  for s in spans}
    assert 'COMMIT' in member_ops
    assert all(s['status'] != 'open'
               for spans in res.member_rings.values() for s in spans)
    # merged timeline is buildable from exactly what the result holds
    merged = merge_timelines(dict({'client': res.trace},
                                  **res.member_rings))
    assert merged and format_timeline(merged)


async def _ensemble_write_rings(ensemble_cls, lag_member=None):
    """Drive one watched write through an in-process 3-member
    ensemble (WAL on) and return (set_zxid, rings, ensemble spans)."""
    import shutil
    import tempfile

    wal_dir = tempfile.mkdtemp(prefix='zktrace-wal-')
    ens = await ensemble_cls(3, wal_dir=wal_dir).start()
    client = Client(servers=[{'address': h, 'port': p}
                             for h, p in ens.addresses()],
                    shuffle_backends=False, session_timeout=8000)
    client.start()
    try:
        await client.wait_connected(timeout=10)
        await client.create('/w', b'v0')
        fires = []
        fired = asyncio.get_running_loop().create_future()

        def on_change(*a):
            fires.append(a)
            if len(fires) >= 2 and not fired.done():
                fired.set_result(None)
        client.watcher('/w').on('dataChanged', on_change)
        await asyncio.sleep(0.15)          # armed; arm-emit delivered
        if lag_member is not None:
            ens.set_lag(lag_member, None)  # park the follower
        stat = await client.set('/w', b'v1')
        set_zxid = stat.mzxid
        await asyncio.wait_for(fired, 10)
        extra_zxid = None
        if lag_member is not None:
            # a later write lands while the laggard is parked, THEN
            # the laggard catches up — its apply span for set_zxid is
            # recorded after extra_zxid's spans
            stat2 = await client.set('/w', b'v2')
            extra_zxid = stat2.mzxid
            ens.set_lag(lag_member, 0.0)
            ens.servers[lag_member].store.catch_up()
        await client.sync('/w')
        await asyncio.sleep(0.05)
        rings = {'client': client.trace.dump()}
        for s in ens.servers:
            rings['member:%s' % (s.member,)] = s.trace.dump()
        return set_zxid, extra_zxid, rings
    finally:
        await client.close()
        await ens.stop()
        shutil.rmtree(wal_dir, ignore_errors=True)


async def test_merged_timeline_span_by_span(ensemble_cls):
    """The acceptance chain, asserted span by span for one watched
    write: client submit -> leader commit -> WAL append -> the shared
    group-fsync span (batch-stamped) -> both follower applies ->
    fan-out delivery."""
    set_zxid, _extra, rings = await _ensemble_write_rings(ensemble_cls)
    merged = merge_timelines(rings)
    chain = [(e['source'], e['op']) for e in merged
             if e['zxid'] == set_zxid
             and e['op'] in ('SET_DATA', 'COMMIT', 'WAL_APPEND',
                             'GROUP_FSYNC', 'APPLY', 'FANOUT')]
    assert chain[0] == ('client', 'SET_DATA'), chain
    assert chain[1] == ('member:0', 'COMMIT'), chain
    assert chain[2] == ('member:0', 'WAL_APPEND'), chain
    assert chain[3] == ('member:0', 'GROUP_FSYNC'), chain
    assert chain[4:6] == [('member:1', 'APPLY'),
                          ('member:2', 'APPLY')], chain
    assert chain[6] == ('member:0', 'FANOUT'), chain
    fsync = [e for e in merged if e['zxid'] == set_zxid
             and e['op'] == 'GROUP_FSYNC'][0]
    assert fsync['batch'] >= 1             # barrier batch size
    fan = [e for e in merged if e['zxid'] == set_zxid
           and e['op'] == 'FANOUT'][0]
    assert fan['batch'] == 1 and fan['nbytes'] > 0
    # renders, and the zxid column groups
    text = format_timeline(merged)
    assert 'GROUP_FSYNC' in text and 'FANOUT' in text


async def test_lagging_follower_apply_merges_in_zxid_order(
        ensemble_cls):
    """A follower apply recorded long after later transactions still
    merges back into its own write's zxid group — the timeline is
    causal, not wall-clock."""
    set_zxid, extra_zxid, rings = await _ensemble_write_rings(
        ensemble_cls, lag_member=2)
    laggard = [s for s in rings['member:2']
               if s['op'] == 'APPLY' and s['zxid'] == set_zxid]
    assert laggard, 'laggard never applied the watched write'
    leader_commit = [s for s in rings['member:0']
                     if s['op'] == 'COMMIT'
                     and s['zxid'] == extra_zxid]
    assert leader_commit
    # wall-clock: the late apply happened AFTER the later commit...
    assert laggard[0]['t_wall'] > leader_commit[0]['t_wall']
    merged = merge_timelines(rings)
    idx_apply = merged.index([e for e in merged
                              if e['op'] == 'APPLY'
                              and e['source'] == 'member:2'
                              and e['zxid'] == set_zxid][0])
    first_extra = min(i for i, e in enumerate(merged)
                      if e['zxid'] == extra_zxid)
    # ...but the merge puts it back before anything of the later zxid
    assert idx_apply < first_extra


def test_chaos_trace_out_round_trips_with_member_rings(tmp_path):
    """Satellite regression: `chaos --trace-out` JSON is
    schema-stamped, carries the member rings and merged timeline, and
    round-trips through json.loads."""
    from zkstream_tpu_torch.cli import main

    out = tmp_path / 'trace.json'
    rc = main(['chaos', '--seed', '5', '--schedules', '2', '--quiet',
               '--trace-out', str(out)])
    assert rc == 0
    dumps = json.loads(out.read_text())
    assert len(dumps) == 2
    for d in dumps:
        assert d['trace_schema'] == TRACE_SCHEMA
        assert d['member_rings'], d.get('seed')
        assert any(s['op'] == 'COMMIT'
                   for spans in d['member_rings'].values()
                   for s in spans)
        assert isinstance(d['timeline'], list)
        # every timeline entry is zxid-keyed and source-stamped
        assert all('zxid' in e and 'source' in e
                   for e in d['timeline'])
