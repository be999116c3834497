"""Deterministic session-FSM unit tests of the port's ``ZKSession`` with
stub connections (the port of tests/test_session_unit.py).

The integration suites cover the happy migration and revert paths over
real sockets; these drive the reattaching state's remaining exits
directly — old connection also dead (detach), and session clock run out
(expire) — per the reference's revert logic
(lib/zk-session.js:298-317)."""

import time

from zkstream_tpu_torch.io.session import ZKSession
from zkstream_tpu_torch.utils.events import EventEmitter


class StubBackend:
    def __init__(self, key):
        self.key = key
        self.address, port = key.split(':')
        self.port = int(port)


class StubConn(EventEmitter):
    """Just enough connection surface for ZKSession."""

    def __init__(self, key='127.0.0.1:1'):
        super().__init__()
        self.backend = StubBackend(key)
        self.state = 'connected'
        self.sent = []
        self.destroyed = False
        self.closed = False

    def is_in_state(self, name):
        return self.state == name

    def send(self, pkt):
        self.sent.append(pkt)

    def destroy(self):
        self.destroyed = True
        self.state = 'closed'

    def close(self):
        self.closed = True
        self.state = 'closing'


def attach(session, conn, session_id=0x42):
    session.attach_and_send_cr(conn)
    assert session.is_in_state('attaching')
    assert conn.sent, 'no ConnectRequest sent'
    conn.emit('packet', {'sessionId': session_id, 'timeOut': 5000,
                         'passwd': b'\x01' * 16})
    assert session.is_in_state('attached')


async def test_reattach_reverts_to_live_old_conn():
    s = ZKSession(5000)
    old, new = StubConn('127.0.0.1:1'), StubConn('127.0.0.1:2')
    attach(s, old)
    s.attach_and_send_cr(new)
    assert s.is_in_state('reattaching')
    # The move sends the EXISTING credentials on the new connection.
    assert new.sent[-1]['sessionId'] == 0x42
    assert new.sent[-1]['passwd'] == b'\x01' * 16
    new.emit('error', RuntimeError('boom'))
    assert s.is_in_state('attached')
    assert s.get_connection() is old
    s.close()


async def test_reattach_detaches_when_old_conn_also_dead():
    s = ZKSession(5000)
    old, new = StubConn('127.0.0.1:1'), StubConn('127.0.0.1:2')
    attach(s, old)
    s.attach_and_send_cr(new)
    old.state = 'closed'  # the old connection died mid-move
    new.emit('error', RuntimeError('boom'))
    # Still alive (recent packet), but nowhere to revert: detached,
    # and the dead old conn is torn down.
    assert s.is_in_state('detached')
    assert old.destroyed
    s.close()


async def test_reattach_expires_when_clock_ran_out():
    s = ZKSession(5000)
    old, new = StubConn('127.0.0.1:1'), StubConn('127.0.0.1:2')
    attach(s, old)
    s.attach_and_send_cr(new)
    # Backdate the last packet beyond the timeout: no longer alive.
    s.last_pkt = time.monotonic() * 1000.0 - 60000
    new.emit('error', RuntimeError('boom'))
    assert s.is_in_state('expired')
    assert old.closed


async def test_reattach_zero_session_id_reply_reverts():
    """The new backend answering with sessionId 0 means it would give
    us a FRESH session: refuse the move, keep the live one
    (reference: lib/zk-session.js:270-276)."""
    s = ZKSession(5000)
    old, new = StubConn('127.0.0.1:1'), StubConn('127.0.0.1:2')
    attach(s, old)
    s.attach_and_send_cr(new)
    new.emit('packet', {'sessionId': 0, 'timeOut': 5000,
                        'passwd': b'\x00' * 16})
    assert s.is_in_state('attached')
    assert s.get_connection() is old
    assert s.session_id == 0x42
    s.close()


async def test_expiry_timer_tracks_renegotiated_down_timeout():
    """The lazy expiry timer must fire on the NEW (shorter) deadline
    when the server renegotiates the session timeout down mid-life —
    the pending long timer is rescheduled, not left to fire late."""
    import asyncio

    s = ZKSession(30000)               # client asks for 30 s
    conn = StubConn()
    s.attach_and_send_cr(conn)
    # server grants only 600 ms
    conn.emit('packet', {'sessionId': 0x42, 'timeOut': 600,
                         'passwd': b'\x01' * 16})
    assert s.is_in_state('attached')
    assert s.get_timeout() == 600
    # the pending timer must now be due within ~600 ms, not 30 s
    assert s._expiry_at - time.monotonic() < 1.0
    expired = asyncio.get_event_loop().create_future()
    s.expiry_timer.on('timeout',
                      lambda: expired.done() or expired.set_result(1))
    await asyncio.wait_for(expired, 3)   # would hang if timer sat at 30 s
