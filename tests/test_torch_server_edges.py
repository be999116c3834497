"""Server edge paths the integration suites skirt (the port of
tests/test_server_edges.py): the bare GET_CHILDREN op, unknown-session
handshakes, requests against an expired session, unimplemented
opcodes, and the SET_WATCHES catch-up decision table — driven over raw
protocol sockets speaking the port's codec (the reference's
fake-client trick in reverse) so each branch is hit deterministically,
on the port's server and on the JAX package's (the unit-level case
drives the port's ``ServerConnection`` directly).
Reference behaviors: lib/zk-buffer.js:337-347 (GET_CHILDREN without
Stat), lib/zk-session.js:170-173 (sid==0 on unknown session),
lib/zk-session.js:421-471 + the server-side catch-up rules of
SET_WATCHES at relZxid.  The ensemble case runs on both packages'
``ZKEnsemble``."""

from __future__ import annotations

import asyncio

import pytest

from zkstream_tpu_torch.protocol.framing import PacketCodec
from zkstream_tpu_torch.server import ZKServer
from zkstream_tpu_torch.server.server import ServerConnection
from test_torch_basic import ensemble_cls, server, server_cls  # noqa: F401


class RawClient:
    """A hand-driven protocol speaker: full control over handshake
    fields, xids, and SET_WATCHES contents."""

    def __init__(self):
        self.codec = PacketCodec()
        self.reader = None
        self.writer = None
        self._xid = 0

    async def connect(self, server, session_id=0, passwd=b'',
                      timeout=8000):
        self.reader, self.writer = await asyncio.open_connection(
            '127.0.0.1', server.port)
        self.writer.write(self.codec.encode({
            'protocolVersion': 0, 'lastZxidSeen': 0,
            'timeOut': timeout, 'sessionId': session_id,
            'passwd': passwd}))
        (resp,) = await self.recv(1)
        # the connection layer's job, done by hand here
        self.codec.handshaking = False
        return resp

    async def recv(self, n, timeout=5):
        pkts = []
        async def pump():
            while len(pkts) < n:
                data = await self.reader.read(65536)
                assert data, 'server closed mid-read'
                pkts.extend(self.codec.decode(data))
        await asyncio.wait_for(pump(), timeout)
        return pkts

    def send(self, pkt):
        if 'xid' not in pkt:
            self._xid += 1
            pkt['xid'] = self._xid
        self.writer.write(self.codec.encode(pkt))
        return pkt['xid']

    def close(self):
        if self.writer is not None:
            self.writer.close()


@pytest.fixture
def raw(event_loop, server):
    clients: list[RawClient] = []

    def make():
        c = RawClient()
        clients.append(c)
        return c

    yield make
    for c in clients:
        c.close()


async def test_bare_get_children_no_stat(server, raw):
    c = raw()
    resp = await c.connect(server)
    assert resp['sessionId'] != 0
    c.send({'opcode': 'CREATE', 'path': '/p', 'data': b'', 'acl': [],
            'flags': 0})
    c.send({'opcode': 'CREATE', 'path': '/p/a', 'data': b'', 'acl': [],
            'flags': 0})
    xid = c.send({'opcode': 'GET_CHILDREN', 'path': '/p',
                  'watch': True})
    pkts = await c.recv(3)
    reply = [p for p in pkts if p['xid'] == xid][0]
    assert reply['opcode'] == 'GET_CHILDREN'
    assert reply['children'] == ['a']
    assert 'stat' not in reply                 # the no-Stat variant
    # the watch armed: a child change notifies
    c.send({'opcode': 'CREATE', 'path': '/p/b', 'data': b'', 'acl': [],
            'flags': 0})
    pkts = await c.recv(2)
    notif = [p for p in pkts if p['opcode'] == 'NOTIFICATION'][0]
    assert notif['type'] == 'CHILDREN_CHANGED' and notif['path'] == '/p'


async def test_unknown_session_resume_gets_zero_sid(server, raw):
    c = raw()
    resp = await c.connect(server, session_id=0x7777,
                           passwd=b'\x01' * 16)
    assert resp['sessionId'] == 0
    assert resp['passwd'] == b'\x00' * 16


async def test_request_on_expired_session_and_unimplemented_op():
    """Unit-level: a request arriving for a session that expired (the
    close event racing the read loop), and an opcode with no handler —
    both must reply with the right error code, not crash."""
    server = ZKServer()
    sent = []

    class W:
        def write(self, data):
            sent.append(data)

        def close(self):
            pass

    conn = ServerConnection(server, reader=None, writer=W())
    conn.codec.handshaking = False
    sess = server.db.create_session(8000)
    sess.expired = True
    conn.session = sess
    dec = PacketCodec()
    dec.handshaking = False

    dec.xid_map[7] = 'PING'      # as the send side would have recorded
    conn._handle_request({'xid': 7, 'opcode': 'PING'})
    # replies are tick-corked (sendplane); flush_hard is the
    # synchronous drain on every transport backend (flush_now defers
    # to the batched tier's tick callback when one is attached)
    conn._tx.flush_hard()
    (reply,) = dec.decode(sent.pop())
    assert reply['err'] == 'SESSION_EXPIRED'

    sess.expired = False
    # an opcode with no _op_ handler: UNIMPLEMENTED, not a crash
    dec.xid_map[8] = 'CHECK_WATCHES'
    conn._handle_request({'xid': 8, 'opcode': 'CHECK_WATCHES'})
    conn._tx.flush_hard()
    (reply,) = dec.decode(sent.pop())
    assert reply['err'] == 'UNIMPLEMENTED'

    conn._handle_request({'xid': -2, 'opcode': 'PING'})
    conn._tx.flush_hard()
    (reply,) = dec.decode(sent.pop())
    assert reply['err'] == 'OK'


async def test_set_watches_catchup_decision_table(server, raw):
    """Every branch of the SET_WATCHES catch-up rules: missing nodes
    fire DELETED, nodes changed past relZxid fire their change, and
    unchanged nodes silently re-arm (firing only on the NEXT change)."""
    c = raw()
    await c.connect(server)
    c.send({'opcode': 'CREATE', 'path': '/old', 'data': b'', 'acl': [],
            'flags': 0})
    (r1,) = await c.recv(1)
    rel = r1['zxid']                     # everything after is "new"
    c.send({'opcode': 'CREATE', 'path': '/newer', 'data': b'',
            'acl': [], 'flags': 0})
    c.send({'opcode': 'SET_DATA', 'path': '/newer', 'data': b'x',
            'version': -1})
    c.send({'opcode': 'CREATE', 'path': '/newer/kid', 'data': b'',
            'acl': [], 'flags': 0})
    await c.recv(3)

    xid = c.send({'opcode': 'SET_WATCHES', 'relZxid': rel, 'events': {
        'dataChanged': ['/gone', '/newer', '/old'],
        'createdOrDestroyed': ['/also-gone', '/newer', '/old'],
        'childrenChanged': ['/gone-too', '/newer', '/old'],
    }})
    pkts = await c.recv(7)               # 6 catch-up notifs + reply
    reply = [p for p in pkts if p['xid'] == xid][0]
    assert reply['opcode'] == 'SET_WATCHES' and reply['err'] == 'OK'
    notifs = {(p['type'], p['path'])
              for p in pkts if p['opcode'] == 'NOTIFICATION'}
    assert notifs == {
        ('DELETED', '/gone'),            # missing => DELETED
        ('DELETED', '/also-gone'),
        ('DELETED', '/gone-too'),
        ('DATA_CHANGED', '/newer'),      # mzxid > rel
        ('CREATED', '/newer'),           # czxid > rel
        ('CHILDREN_CHANGED', '/newer'),  # pzxid > rel
    }
    # '/old' re-armed silently in all three tables: its next change
    # fires exactly one data notification
    c.send({'opcode': 'SET_DATA', 'path': '/old', 'data': b'y',
            'version': -1})
    pkts = await c.recv(2)
    fired = [p for p in pkts if p['opcode'] == 'NOTIFICATION']
    assert {(p['type'], p['path']) for p in fired} == {
        ('DATA_CHANGED', '/old')}


async def test_ensemble_set_lag_rejects_leader(event_loop, ensemble_cls):
    ens = await ensemble_cls(2).start()
    try:
        with pytest.raises(ValueError, match='leader'):
            ens.set_lag(0, None)
        ens.set_lag(1, None)             # follower: fine
    finally:
        await ens.stop()
