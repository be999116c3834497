"""The port of tests/test_multi.py, on the port's MULTI plane; every case
on an in-process server or ensemble runs twice, on the port's and on
the JAX package's, with the port's clients.

MULTI (opcode 14) — the all-or-nothing transaction pillar.

Three layers: the store's atomic apply (speculative-with-undo —
rollback leaves the tree, the session ephemeral sets, the sequential
counters and the zxid byte-identical to never having applied, and no
watch fires), the wire round trip through the real server (every codec
tier — the C extension now carries MULTI layouts in both directions,
A/B-held byte-identical below — Client.multi / transaction), and
the replication story (ONE log entry per batch, forwarded MULTI
through a cross-process follower's mirror).
"""

from __future__ import annotations

import asyncio
import copy

import pytest

from helpers import wait_until
from zkstream_tpu_torch import Client, CreateFlag
from zkstream_tpu_torch.protocol.errors import ZKMultiError
from zkstream_tpu_torch.server.store import ZKDatabase, ZKOpError
from test_torch_basic import ensemble_cls, server, server_cls  # noqa: F401


# -- store-level atomicity ---------------------------------------------


def _db_with(*paths):
    db = ZKDatabase()
    for p in paths:
        db.create(p, b'seed', None, CreateFlag(0), None)
    return db


def test_multi_applies_all_as_one_log_entry():
    db = ZKDatabase()

    class Sink:
        applied = 0
    db.attach_replica(Sink())          # retain the log
    db.create('/a', b'seed', None, CreateFlag(0), None)
    db2_entries = []
    db.on('committed', lambda: db2_entries.append(db.log[-1]))

    res = db.multi([
        {'op': 'create', 'path': '/b', 'data': b'x'},
        {'op': 'set_data', 'path': '/b', 'data': b'y'},
        {'op': 'check', 'path': '/a', 'version': 0},
        {'op': 'delete', 'path': '/a'},
    ])
    assert [r['op'] for r in res] == ['create', 'set_data', 'check',
                                     'delete']
    assert res[0]['path'] == '/b'
    assert res[1]['stat'].version == 1
    assert db.nodes['/b'].data == b'y' and '/a' not in db.nodes
    # ONE committed log entry for the whole batch; check logged nothing
    (entry,) = db2_entries
    assert entry[0] == 'multi' and len(entry[1]) == 3
    assert db.multi_batches == 1 and db.multi_subops == 3


async def test_multi_failure_rolls_back_everything():
    # async: create_session arms an expiry timer on the running loop
    db = _db_with('/a')
    eph_sess = db.create_session(30000)
    db.create('/eph', b'', None, CreateFlag.EPHEMERAL, eph_sess)
    db.create('/seq', b'', None, CreateFlag(0), None)
    db.create('/seq/n-', b'', None, CreateFlag.SEQUENTIAL, None)
    before_nodes = copy.deepcopy(db.nodes)
    before_zxid = db.zxid
    before_eph = set(eph_sess.ephemerals)
    fires = []
    for ev in ('created', 'deleted', 'dataChanged',
               'childrenChanged'):
        db.on(ev, lambda *a, ev=ev: fires.append((ev, a)))

    res = db.multi([
        {'op': 'create', 'path': '/new', 'data': b'n'},
        {'op': 'create', 'path': '/seq/n-', 'data': b's',
         'flags': CreateFlag.SEQUENTIAL},
        {'op': 'create', 'path': '/eph2', 'data': b'',
         'flags': CreateFlag.EPHEMERAL},
        {'op': 'set_data', 'path': '/a', 'data': b'mut'},
        {'op': 'delete', 'path': '/eph'},
        {'op': 'check', 'path': '/a', 'version': 99},   # fails
        {'op': 'create', 'path': '/never', 'data': b''},
    ], session=eph_sess)
    # all-error result shape: real code at the failing slot,
    # RUNTIME_INCONSISTENCY everywhere else
    assert [r['op'] for r in res] == ['error'] * 7
    assert res[5]['err'] == 'BAD_VERSION'
    assert {res[i]['err'] for i in (0, 1, 2, 3, 4, 6)} == \
        {'RUNTIME_INCONSISTENCY'}
    # the tree, the zxid, the ephemeral set and the sequential
    # counter are byte-identical to never having applied
    assert db.nodes == before_nodes
    assert db.zxid == before_zxid
    assert eph_sess.ephemerals == before_eph
    assert db.nodes['/seq'].seq == 1
    assert fires == [], 'a rolled-back multi must fire no watch'
    assert db.multi_batches == 0
    # and the tree still works
    db.multi([{'op': 'create', 'path': '/new', 'data': b'n'}])
    assert db.nodes['/new'].data == b'n'


def test_multi_interdependent_ops_and_replay():
    """Create-then-delete-in-batch, and the replica replay applies
    the whole entry through the shared apply_entry dispatch."""
    from zkstream_tpu_torch.server.store import ReplicaStore

    db = ZKDatabase()
    rep = ReplicaStore(db, lag=None)
    db.multi([
        {'op': 'create', 'path': '/t', 'data': b'1'},
        {'op': 'create', 'path': '/t/kid', 'data': b'2'},
        {'op': 'delete', 'path': '/t/kid'},
        {'op': 'set_data', 'path': '/t', 'data': b'3'},
    ])
    assert db.nodes['/t'].data == b'3' and '/t/kid' not in db.nodes
    rep.catch_up()
    assert rep.nodes['/t'].data == b'3' and '/t/kid' not in rep.nodes
    assert rep.zxid == db.zxid


def test_multi_empty_and_bad_subop():
    db = ZKDatabase()
    assert db.multi([]) == []
    res = db.multi([{'op': 'noop', 'path': '/x'}])
    assert res == [{'op': 'error', 'err': 'BAD_ARGUMENTS'}]


# -- wire round trip ----------------------------------------------------


@pytest.fixture
def ensemble(event_loop, ensemble_cls):
    ens = event_loop.run_until_complete(ensemble_cls(3).start())
    yield ens
    event_loop.run_until_complete(ens.stop())


def _client(addr_port, **kw):
    c = Client(address=addr_port[0], port=addr_port[1], **kw)
    c.start()
    return c


async def test_client_multi_end_to_end(ensemble):
    c = _client(ensemble.addresses()[0])
    try:
        await c.wait_connected(timeout=5)
        results = await c.multi([
            {'op': 'create', 'path': '/m', 'data': b'a'},
            {'op': 'create', 'path': '/m/kid', 'data': b'b'},
            {'op': 'set_data', 'path': '/m', 'data': b'c'},
            {'op': 'check', 'path': '/m', 'version': 1},
        ])
        assert results[0] == '/m' and results[1] == '/m/kid'
        assert results[2].version == 1
        assert results[3] is None
        data, _ = await c.get('/m')
        assert data == b'c'
        # a watch armed on / fires exactly once per created child
        fired = []
        w = c.watcher('/')
        w.on('childrenChanged', lambda kids, stat: fired.append(kids))
        await asyncio.sleep(0.1)
        t = c.transaction().create('/m2', b'x').set('/m2', b'y') \
            .delete('/m/kid')
        out = await t.commit()
        assert out[0] == '/m2' and out[1].version == 1
        await wait_until(lambda: len(fired) >= 2, 5)
    finally:
        await c.close()


async def test_client_multi_rejection_is_atomic(ensemble):
    c = _client(ensemble.addresses()[0])
    try:
        await c.wait_connected(timeout=5)
        await c.create('/exists', b'')
        with pytest.raises(ZKMultiError) as ei:
            await c.transaction() \
                .create('/fresh', b'1') \
                .create('/exists', b'2') \
                .commit()
        assert ei.value.code == 'NODE_EXISTS'
        assert ei.value.index == 1
        assert [r['op'] for r in ei.value.results] == ['error'] * 2
        # nothing applied — the batch vanished whole
        with pytest.raises(Exception):
            await c.get('/fresh')
    finally:
        await c.close()


async def test_multi_forwarded_through_follower(ensemble):
    """MULTI through a follower member lands on the shared leader as
    one txn and is readable everywhere after sync."""
    addrs = ensemble.addresses()
    c = Client(servers=addrs[1:] + addrs[:1], shuffle_backends=False)
    c.start()
    try:
        await c.wait_connected(timeout=5)
        out = await c.multi([
            {'op': 'create', 'path': '/fw', 'data': b'1'},
            {'op': 'set_data', 'path': '/fw', 'data': b'2'},
        ])
        assert out[0] == '/fw'
        await c.sync('/fw')
        data, _ = await c.get('/fw')
        assert data == b'2'
    finally:
        await c.close()


async def test_multi_rpc_through_remote_leader(event_loop):
    """Cross-process forwarding shape: a RemoteLeader's multi RPC
    applies on the leader as ONE entry and the response piggyback
    delivers the whole batch into the mirror before the ack."""
    from zkstream_tpu_torch.server.replication import (
        RemoteLeader,
        RemoteReplicaStore,
        ReplicationService,
    )

    db = ZKDatabase()
    svc = await ReplicationService(db, total=2).start()
    remote = await RemoteLeader('127.0.0.1', svc.port).connect()
    store = RemoteReplicaStore(remote, lag=0.0)
    try:
        res = await event_loop.run_in_executor(
            None, lambda: remote.multi([
                {'op': 'create', 'path': '/r', 'data': b'x'},
                {'op': 'set_data', 'path': '/r', 'data': b'y'},
            ]))
        assert res[0]['path'] == '/r'
        # the RPC piggyback already delivered the batch: read-your-
        # own-write holds without waiting for the async push
        store.catch_up()
        assert store.nodes['/r'].data == b'y'
        assert db.log_end() == remote.log_end()
        # rejection is typed and atomic across the wire too
        with pytest.raises(ZKOpError):
            await event_loop.run_in_executor(
                None, lambda: remote.delete('/r', 99))
    finally:
        remote.close()
        await svc.stop()


async def test_multi_survives_wal_restart(tmp_path, server_cls):
    """ONE WAL record per batch: a server restart from disk replays
    the multi atomically (server/persist.py tag 7)."""
    srv = await server_cls(wal_dir=str(tmp_path / 'w'),
                         durability='always').start()
    c = _client(('127.0.0.1', srv.port))
    try:
        await c.wait_connected(timeout=5)
        await c.multi([
            {'op': 'create', 'path': '/d', 'data': b'1'},
            {'op': 'create', 'path': '/d/k', 'data': b'2'},
        ])
        wal = srv.db.wal
        n_appends = wal.appends
        await srv.stop()
        await srv.restart(from_disk=True)
        assert srv.db.nodes['/d'].data == b'1'
        assert srv.db.nodes['/d/k'].data == b'2'
        # the batch cost one WAL append (plus the session record the
        # connect logged)
        assert n_appends == 2
    finally:
        await c.close()
        await srv.stop()


# -- C-extension decode layouts --------------------------------------
#
# MULTI used to be the one opcode the C tier PUNTED per frame back to
# the Python spec decoder.  Both directions now carry a C layout
# (native/zkwire_ext.c LAYOUT_MULTI / RQ_MULTI); these A/B cells hold
# the two tiers byte-identical — same packet dicts from the same wire
# bytes, xid bookkeeping included — so the layouts can never drift
# from records._read_multi / _read_multi_resp.

def _codec_pair(server: bool):
    from zkstream_tpu_torch.protocol.framing import PacketCodec

    py = PacketCodec(server=server, use_native=False)
    cx = PacketCodec(server=server, use_native=True)
    py.handshaking = cx.handshaking = False
    return py, cx


def test_ext_decodes_multi_request_ab():
    from zkstream_tpu_torch.protocol.framing import PacketCodec
    from zkstream_tpu_torch.protocol.records import OPEN_ACL_UNSAFE
    from zkstream_tpu_torch.utils import native

    if native.ensure_ext() is None:
        pytest.skip('no C toolchain for the extension')
    enc = PacketCodec(server=False, use_native=False)
    enc.handshaking = False
    wire = enc.encode({'opcode': 'MULTI', 'xid': 11, 'ops': [
        {'op': 'create', 'path': '/a', 'data': b'x',
         'acl': list(OPEN_ACL_UNSAFE), 'flags': 0},
        {'op': 'set_data', 'path': '/b', 'data': b'y' * 100,
         'version': 3},
        {'op': 'delete', 'path': '/c', 'version': -1},
        {'op': 'check', 'path': '/d', 'version': 5},
    ]})
    py, cx = _codec_pair(server=True)
    a, b = py.decode(wire), cx.decode(wire)
    assert a == b
    assert b[0]['opcode'] == 'MULTI'
    assert [s['op'] for s in b[0]['ops']] == [
        'create', 'set_data', 'delete', 'check']
    # the sub-op dicts carry the exact single-op reader shapes
    assert b[0]['ops'][0]['flags'] == CreateFlag(0)
    assert isinstance(b[0]['ops'][0]['flags'], CreateFlag)


def test_ext_decodes_multi_response_ab():
    from zkstream_tpu_torch.protocol.framing import PacketCodec
    from zkstream_tpu_torch.protocol.records import Stat
    from zkstream_tpu_torch.utils import native

    if native.ensure_ext() is None:
        pytest.skip('no C toolchain for the extension')
    senc = PacketCodec(server=True, use_native=False)
    senc.handshaking = False
    stat = Stat(1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11)
    ok_wire = senc.encode({
        'opcode': 'MULTI', 'xid': 7, 'zxid': 99, 'err': 'OK',
        'results': [{'op': 'create', 'path': '/a'},
                    {'op': 'set_data', 'stat': stat},
                    {'op': 'delete'}, {'op': 'check'}]})
    err_wire = senc.encode({
        'opcode': 'MULTI', 'xid': 8, 'zxid': 100, 'err': 'OK',
        'results': [{'op': 'error', 'err': 'NO_NODE'},
                    {'op': 'error',
                     'err': 'RUNTIME_INCONSISTENCY'}]})
    py, cx = _codec_pair(server=False)
    for codec in (py, cx):
        codec.xid_map[7] = 'MULTI'
        codec.xid_map[8] = 'MULTI'
    a, b = py.decode(ok_wire + err_wire), cx.decode(ok_wire + err_wire)
    assert a == b
    assert b[0]['results'][1]['stat'] == stat
    assert b[1]['results'][0] == {'op': 'error', 'err': 'NO_NODE'}
    # one reply per xid, popped by BOTH tiers
    assert not py.xid_map and not cx.xid_map


def test_ext_multi_bad_frames_match_spec_errors():
    """Corrupt MULTI frames fail identically on both tiers (same
    BAD_DECODE classification, no partial packet surfaced)."""
    from zkstream_tpu_torch.protocol.errors import ZKProtocolError
    from zkstream_tpu_torch.protocol.framing import PacketCodec
    from zkstream_tpu_torch.utils import native

    if native.ensure_ext() is None:
        pytest.skip('no C toolchain for the extension')
    enc = PacketCodec(server=False, use_native=False)
    enc.handshaking = False
    wire = bytearray(enc.encode({'opcode': 'MULTI', 'xid': 3, 'ops': [
        {'op': 'check', 'path': '/d', 'version': 5}]}))
    # corrupt the terminator's type (-1 -> -2): the spec reader
    # raises 'multi terminator carries type', and so must the C tier
    term = wire.rindex(b'\xff\xff\xff\xff\x01')
    wire[term:term + 4] = b'\xff\xff\xff\xfe'
    for use_native in (False, True):
        codec = PacketCodec(server=True, use_native=use_native)
        codec.handshaking = False
        with pytest.raises(ZKProtocolError) as ei:
            codec.decode(bytes(wire))
        assert ei.value.code == 'BAD_DECODE'
