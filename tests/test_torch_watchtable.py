"""The port's sharded watch fan-out (server/watchtable.py; the port of
tests/test_watchtable.py).

Covers the table's bookkeeping contract in isolation (reverse index,
maintained watch count, round-robin shard assignment, per-tick encode
memo, close-time cleanup), the table-vs-emitter PARITY suite — the
same scripted workload produces byte-identical notification streams,
in order, on both paths, including one-shot consumption and the
SET_WATCHES catch-up decision table, on the port's server and on the
JAX package's, and the port's streams equal to the reference's — plus
the fan-out observability (per-shard flush-batch histograms,
``zk_fanout_tick_ms``).  The lagging-follower locality case runs on
both packages' ``ZKEnsemble``, the chaos slices on the port's fault
plane, and the slow 100k-watcher campaign on the port's bench
(``zkstream_tpu_torch.bench.fanout_cell``).
"""

from __future__ import annotations

import asyncio
import functools

import pytest

from zkstream_tpu_torch.io import faults
from zkstream_tpu_torch.io.sendplane import METRIC_FLUSH_FRAMES
from zkstream_tpu_torch.server import ZKServer
from zkstream_tpu_torch.server.watchtable import METRIC_FANOUT_TICK, WatchTable
from zkstream_tpu_torch.utils.metrics import Collector

from test_torch_server_edges import RawClient
from test_torch_basic import ensemble_cls, server_cls  # noqa: F401


# -- table bookkeeping in isolation ------------------------------------

class _StubTx:
    def __init__(self, sent):
        self.send = sent.append
        self.send_flush = sent.append


class _StubConn:
    """The slice of ServerConnection the table touches."""

    def __init__(self):
        self.data_watches = {}
        self.child_watches = {}
        self.persistent_watches = {}
        self.closed = False
        self._fanout_buf = []
        self._fanout_shard = 0
        self.sent = []
        self._tx = _StubTx(self.sent)


class _StubServer:
    def __init__(self, store):
        self.store = store
        self.faults = None
        self.packets_sent = 0
        from zkstream_tpu_torch.protocol.framing import PacketCodec
        self._notif_codec = PacketCodec(server=True)
        self._notif_codec.handshaking = False


async def test_table_index_count_and_cleanup():
    from zkstream_tpu_torch.server.store import ZKDatabase
    db = ZKDatabase()
    srv = _StubServer(db)
    table = WatchTable(srv, shards=4)
    conns = [_StubConn() for _ in range(6)]
    for c in conns:
        table.add_conn(c)
    # round-robin shard assignment spreads evenly
    assert sorted(c._fanout_shard for c in conns) == [0, 0, 1, 1, 2, 3]

    for i, c in enumerate(conns):
        c.data_watches['/p'] = True
        table.arm('data', '/p', c)
        if i % 2 == 0:
            c.child_watches['/p'] = True
            table.arm('child', '/p', c)
    assert table.count == 9
    assert len(table.data_index['/p']) == 6

    # explicit disarm (the SET_WATCHES catch-up path)
    conns[1].data_watches.pop('/p')
    table.disarm('data', '/p', conns[1])
    assert table.count == 8

    # persistent registrations live in their own indexes and counters
    conns[2].persistent_watches['/p'] = False
    table.arm_persistent('/p', conns[2], recursive=False)
    conns[3].persistent_watches['/sub'] = True
    table.arm_persistent('/sub', conns[3], recursive=True)
    assert table.persistent_count == 1
    assert table.recursive_count == 1

    # close-time cleanup is O(paths watched): index entries and the
    # maintained count both drop — persistent indexes included
    for c in conns[2:]:
        table.remove_conn(c)
    assert table.count == 2
    assert table.data_index['/p'] == {conns[0]}
    assert table.persistent_count == 0 and not table.persistent_index
    assert table.recursive_count == 0 and not table.recursive_index

    # one-shot consumption through a real store event
    db.create('/p', b'', [], 0)          # childrenChanged on '/'
    db.set_data('/p', b'x', -1)          # dataChanged on '/p'
    await asyncio.sleep(0)               # shard flush tick
    assert table.count == 1              # data watch consumed...
    assert '/p' not in table.data_index  # ...and de-indexed
    assert conns[0].data_watches == {}
    assert len(conns[0].sent) == 1       # exactly one notification
    assert table.child_index['/p'] == {conns[0]}


async def test_per_tick_encode_memo_shares_interleaved_kinds():
    """A DELETED fanning to both data and child subscribers within one
    tick encodes ONCE (the depth-1 cache this replaces thrashed when
    event kinds interleaved); the memo clears at the tick boundary."""
    from zkstream_tpu_torch.server.store import ZKDatabase
    db = ZKDatabase()
    table = WatchTable(_StubServer(db), shards=2)
    a = table.encode('DELETED', '/n', 7)
    b = table.encode('DELETED', '/n', 7)
    assert a is b                        # same object: memo hit
    c = table.encode('CHILDREN_CHANGED', '/n', 7)
    d = table.encode('DELETED', '/n', 7)
    assert c is not a and d is a         # interleaving cannot evict
    await asyncio.sleep(0)
    assert table.encode('DELETED', '/n', 7) is not a   # tick cleared


# -- parity: table vs emitter, identical notification streams ----------

WORKLOAD_NOTIF_BUDGET = 16    # frames the scripted workload produces


async def _scripted_workload(watchtable: bool, server_cls) -> dict:
    """Drive one deterministic watch workload over raw sockets and
    return each connection's ordered notification stream plus the
    server's maintained watch count at the end."""
    srv = await server_cls(watchtable=watchtable).start()
    a, b = RawClient(), RawClient()
    try:
        await a.connect(srv)
        await b.connect(srv)

        def notifs(pkts):
            return [(p['type'], p['path']) for p in pkts
                    if p['opcode'] == 'NOTIFICATION']

        streams = {'a': [], 'b': []}
        # 1. existence watch on a missing node fires CREATED
        a.send({'opcode': 'EXISTS', 'path': '/n', 'watch': True})
        (r,) = await a.recv(1)
        assert r['err'] == 'NO_NODE'
        # 2. b child-watches the root
        b.send({'opcode': 'GET_CHILDREN', 'path': '/', 'watch': True})
        await b.recv(1)
        b.send({'opcode': 'CREATE', 'path': '/n', 'data': b'',
                'acl': [], 'flags': 0})
        # b's own create fires a's CREATED and b's CHILDREN_CHANGED
        streams['a'] += notifs(await a.recv(1))
        streams['b'] += notifs(await b.recv(2))
        # 3. one-shot: a second mutation without re-arm fires nothing
        a.send({'opcode': 'GET_DATA', 'path': '/n', 'watch': True})
        await a.recv(1)
        a.send({'opcode': 'SET_DATA', 'path': '/n', 'data': b'x',
                'version': -1})
        streams['a'] += notifs(await a.recv(2))   # reply + DATA_CHANGED
        a.send({'opcode': 'SET_DATA', 'path': '/n', 'data': b'y',
                'version': -1})
        streams['a'] += notifs(await a.recv(1))   # reply only
        # 4. both kinds on one path: DELETE fires data+child DELETED
        #    to the same connection, data-kind first
        a.send({'opcode': 'GET_DATA', 'path': '/n', 'watch': True})
        a.send({'opcode': 'GET_CHILDREN', 'path': '/n', 'watch': True})
        await a.recv(2)
        b.send({'opcode': 'GET_CHILDREN', 'path': '/', 'watch': True})
        await b.recv(1)
        a.send({'opcode': 'DELETE', 'path': '/n', 'version': -1})
        streams['a'] += notifs(await a.recv(3))   # reply + 2 DELETED
        streams['b'] += notifs(await b.recv(1))   # CHILDREN_CHANGED /
        # 5. SET_WATCHES catch-up decision table
        b.send({'opcode': 'CREATE', 'path': '/w', 'data': b'',
                'acl': [], 'flags': 0})
        (r,) = await b.recv(1)
        rel = r['zxid']
        b.send({'opcode': 'SET_DATA', 'path': '/w', 'data': b'z',
                'version': -1})
        await b.recv(1)
        #    a pre-existing arm on '/w' must be CONSUMED by the
        #    catch-up fire (arm-then-pop semantics), not left live
        a.send({'opcode': 'GET_DATA', 'path': '/w', 'watch': True})
        await a.recv(1)
        a.send({'opcode': 'SET_WATCHES', 'relZxid': rel, 'events': {
            'dataChanged': ['/w', '/gone'],
            'createdOrDestroyed': ['/w'],
            'childrenChanged': ['/w'],
        }})
        streams['a'] += notifs(await a.recv(3))   # DELETED + DATA_CHANGED
        #    the createdOrDestroyed branch silently re-armed '/w'
        #    (czxid == rel): the next change fires exactly ONCE —
        #    no duplicate from the pre-SET_WATCHES arm
        b.send({'opcode': 'SET_DATA', 'path': '/w', 'data': b'zz',
                'version': -1})
        streams['a'] += notifs(await a.recv(1))
        await b.recv(1)
        #    '/w' childrenChanged re-armed silently: next child fires
        b.send({'opcode': 'CREATE', 'path': '/w/kid', 'data': b'',
                'acl': [], 'flags': 0})
        streams['a'] += notifs(await a.recv(1))
        await b.recv(1)
        count = srv.watch_count()
        return {'streams': streams, 'watch_count': count}
    finally:
        a.close()
        b.close()
        await srv.stop()


async def test_table_and_emitter_produce_identical_streams(server_cls):
    table = await _scripted_workload(True, server_cls)
    emitter = await _scripted_workload(False, server_cls)
    assert table['streams'] == emitter['streams']
    # the maintained counter agrees with the emitter's O(conns) sum
    assert table['watch_count'] == emitter['watch_count']
    # the workload actually exercised the interesting shapes
    flat = table['streams']['a'] + table['streams']['b']
    assert len(flat) <= WORKLOAD_NOTIF_BUDGET
    assert ('DELETED', '/n') in flat
    assert ('DATA_CHANGED', '/w') in flat


@pytest.mark.parametrize('watchtable', [True, False])
async def test_port_server_streams_equal_reference(watchtable):
    """The scripted workload's notification streams and watch count on
    the port's server equal the JAX package's, on both dispatch
    paths."""
    from zkstream_tpu.server import ZKServer as RefServer

    assert await _scripted_workload(watchtable, ZKServer) \
        == await _scripted_workload(watchtable, RefServer)


async def test_notification_never_overtaken_by_later_reply(server_cls):
    """A pipelined [SET_DATA, GET_DATA] batch from the watching
    connection must deliver the DATA_CHANGED notification before the
    GET_DATA reply carrying the new state — ZooKeeper's watch-before-
    read-result guarantee, preserved by the reply path draining the
    fan-out buffer."""
    srv = await server_cls(watchtable=True).start()
    c = RawClient()
    try:
        await c.connect(srv)
        c.send({'opcode': 'CREATE', 'path': '/o', 'data': b'a',
                'acl': [], 'flags': 0})
        c.send({'opcode': 'GET_DATA', 'path': '/o', 'watch': True})
        await c.recv(2)
        # one pipelined batch: the mutation, then a read of the new
        # state — all handled in a single server tick
        c.send({'opcode': 'SET_DATA', 'path': '/o', 'data': b'b',
                'version': -1})
        c.send({'opcode': 'GET_DATA', 'path': '/o', 'watch': False})
        pkts = await c.recv(3)
        order = [(p.get('opcode'), p.get('type')) for p in pkts]
        notif_at = order.index(('NOTIFICATION', 'DATA_CHANGED'))
        read_at = [i for i, p in enumerate(pkts)
                   if p.get('opcode') == 'GET_DATA'][0]
        assert notif_at < read_at, order
        assert pkts[read_at]['data'] == b'b'
    finally:
        c.close()
        await srv.stop()


# -- observability ------------------------------------------------------

async def test_fanout_histograms_and_maintained_count(server_cls):
    col = Collector()
    srv = await server_cls(collector=col, watchtable=True).start()
    clients = [RawClient() for _ in range(8)]
    try:
        for c in clients:
            await c.connect(srv)
        clients[0].send({'opcode': 'CREATE', 'path': '/h', 'data': b'',
                        'acl': [], 'flags': 0})
        await clients[0].recv(1)
        for c in clients:
            c.send({'opcode': 'GET_DATA', 'path': '/h', 'watch': True})
            await c.recv(1)
        assert srv.watch_count() == 8    # maintained, not summed
        clients[0].send({'opcode': 'SET_DATA', 'path': '/h',
                        'data': b'x', 'version': -1})
        for c in clients:
            pkts = await c.recv(2 if c is clients[0] else 1)
            assert any(p['opcode'] == 'NOTIFICATION' for p in pkts)
        assert srv.watch_count() == 0    # all one-shots consumed
        fr = col.get_collector(METRIC_FLUSH_FRAMES)
        assert fr.count({'plane': 'fanout'}) > 0
        # 7 of 8 frames rode the shard cork; the mutator's own
        # notification drained with its reply (the ordering rule), so
        # it lands in the server plane's histogram instead
        assert fr.sum({'plane': 'fanout'}) == 7.0
        tick = col.get_collector(METRIC_FANOUT_TICK)
        assert tick.count({'plane': 'fanout'}) > 0
        # mntr reports the shard knob
        stats = dict(srv.monitor_stats())
        assert stats['zk_fanout_shards'] == srv.watch_table.nshards
        assert stats['zk_watch_count'] == 0
    finally:
        for c in clients:
            c.close()
        await srv.stop()


# -- the ensemble and the fault plane on both dispatch paths ------------


#: The CPU tests run every plan's ``FleetIngest`` on the CPU.
run_ensemble_schedule = functools.partial(faults.run_ensemble_schedule,
                                          device='cpu')


async def test_watch_locality_on_lagging_follower_parity(ensemble_cls):
    """A watch armed through a deterministically lagging follower
    fires when THAT member applies the transaction — on both dispatch
    paths, with the same stream."""
    out = {}
    for mode in (True, False):
        ens = await ensemble_cls(2, lag=None, watchtable=mode).start()
        leader, follower = ens.servers
        lc, fc = RawClient(), RawClient()
        try:
            await lc.connect(leader)
            await fc.connect(follower)
            lc.send({'opcode': 'CREATE', 'path': '/lag', 'data': b'',
                     'acl': [], 'flags': 0})
            await lc.recv(1)
            # follower (lag=None) has not applied yet; a write
            # through it catches it up first
            fc.send({'opcode': 'SYNC', 'path': '/'})
            await fc.recv(1)
            fc.send({'opcode': 'GET_DATA', 'path': '/lag',
                     'watch': True})
            await fc.recv(1)
            lc.send({'opcode': 'SET_DATA', 'path': '/lag',
                     'data': b'x', 'version': -1})
            await lc.recv(1)
            # the held-back follower has NOT fired yet
            await asyncio.sleep(0.05)
            fc.send({'opcode': 'SYNC', 'path': '/'})
            pkts = await fc.recv(2)      # catch-up fires the watch
            out[mode] = [(p.get('opcode'), p.get('type'),
                          p.get('path')) for p in pkts
                         if p.get('opcode') == 'NOTIFICATION']
            assert out[mode], 'lagging-follower watch never fired'
        finally:
            lc.close()
            fc.close()
            await ens.stop()
    assert out[True] == out[False]


async def test_chaos_slice_watchtable_disabled(monkeypatch):
    """Transport tier with the table force-disabled: invariant 5
    (watch at-most-once per arm) and friends hold on the emitter
    fallback (the tier-1 campaign runs the same seeds table-on)."""
    monkeypatch.setenv('ZKSTREAM_NO_WATCHTABLE', '1')
    for seed in range(2400, 2406):
        res = await faults.run_schedule(seed)
        assert res.ok, (seed, res.violations)


@pytest.mark.timeout(120)
async def test_ensemble_chaos_slice_watchtable_disabled(monkeypatch):
    """Ensemble tier, emitter fallback: member kills/restarts, lag and
    migration with the full invariant engine — watch at-most-once per
    arm included — on the non-table path."""
    monkeypatch.setenv('ZKSTREAM_NO_WATCHTABLE', '1')
    for seed in range(2500, 2503):
        res = await run_ensemble_schedule(seed)
        assert res.ok, (seed, res.violations)



# -- the 100k campaign (slow: scale proof, kept out of tier-1) ----------

@pytest.mark.slow
@pytest.mark.timeout(600)
async def test_100k_watcher_fanout_campaign():
    """100k sessions on one box, every one watching the hot path: the
    fan-out completes, delivers exactly once per subscriber, and the
    maintained count stays exact — the serving-plane scale target,
    through the port's bench fan-out cell."""
    from zkstream_tpu_torch import bench

    col = Collector()
    r = await bench.fanout_cell(100000, 100000, table=True,
                                events=3, collector=col)
    assert r['events'] == 3
    fr = col.get_collector(METRIC_FLUSH_FRAMES)
    # every subscriber of every event got exactly one frame
    assert fr.sum({'plane': 'fanout'}) == 300000.0
