"""Structured-logging tests of the port: child-context accretion through
the client/connection/session stack (the rebuild's equivalent of the
reference's bunyan child loggers, lib/client.js:34-45,
lib/connection-fsm.js:93-96,209-211, lib/zk-session.js:179-181).  The
port of tests/test_logging.py: each record the port's ``Logger`` makes
is held to the one the JAX package's ``Logger`` makes from the same
call (message, level, context, call site), and the client-stack case
runs on the port's server and on the JAX package's."""

import logging

from helpers import wait_until
from test_torch_basic import server, server_cls  # noqa: F401
from zkstream_tpu import Logger as RefLogger
from zkstream_tpu_torch import Client, Logger


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__(level=1)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def capture(name: str, call) -> list:
    """``call(Logger, stdlib_logger)`` made once with the port's
    ``Logger`` and once with the reference's, each on its own capturing
    stdlib logger: the port's records, asserted equal to the
    reference's in message, level, context and call site."""
    out = []
    for cls, tag in ((Logger, 'port'), (RefLogger, 'ref')):
        lg = logging.getLogger('zkstream_tpu_torch.test.%s.%s'
                               % (name, tag))
        lg.setLevel(1)
        cap = _Capture()
        lg.addHandler(cap)
        try:
            call(cls, lg)
        finally:
            lg.removeHandler(cap)
        out.append(cap.records)
    port, ref = out

    def key(r):
        return (r.getMessage(), r.levelno, getattr(r, 'zk_context', None),
                r.filename, r.funcName)
    assert [key(r) for r in port] == [key(r) for r in ref]
    return port


def test_child_merges_context():
    for cls in (Logger, RefLogger):
        base = cls()
        a = base.child(component='A', x=1)
        b = a.child(x=2, y=3)
        assert a.context == {'component': 'A', 'x': 1}
        assert b.context == {'component': 'A', 'x': 2, 'y': 3}
        # children never mutate the parent
        assert base.context == {}


def test_records_carry_context_suffix_and_extra():
    (rec,) = capture('capture', lambda cls, lg: cls(lg).child(
        component='X', n=7).info('hello %d', 42))
    assert rec.getMessage() == 'hello 42 [component=X n=7]'
    assert rec.zk_context == {'component': 'X', 'n': 7}


def test_records_attribute_to_the_call_site():
    """%(filename)s / %(funcName)s must point at the caller, not at the
    Logger facade internals."""
    def call(cls, lg):
        cls(lg).child(c=1).info('where am i')

    (rec,) = capture('site', call)
    assert rec.filename == 'test_torch_logging.py'
    assert rec.funcName == 'call'


def test_format_mismatch_is_contained():
    """A bad format/args pair must not raise at the call site (it would
    kill an FSM state handler); it degrades to repr-appended args."""
    (rec,) = capture('mismatch',
                     lambda cls, lg: cls(lg).info('oops %d', 'not-an-int'))
    assert "oops %d ('not-an-int',)" == rec.getMessage()


def test_percent_in_context_value_is_safe():
    """A context value containing '%' (e.g. IPv6 zone id) must not be
    treated as a format directive when the call carries args."""
    (rec,) = capture('pct', lambda cls, lg: cls(lg).child(
        zkAddress='fe80::1%eth0').debug('ping ok in %d ms', 3))
    assert rec.getMessage() == 'ping ok in 3 ms [zkAddress=fe80::1%eth0]'


def test_wrapping_a_logger_facade_merges():
    lg = logging.getLogger('zkstream_tpu_torch.test.wrap')
    inner = Logger(lg).child(a=1)
    outer = Logger(inner, {'b': 2})
    assert outer.base is lg
    assert outer.context == {'a': 1, 'b': 2}


def test_exception_appends_active_traceback():
    def call(cls, lg):
        try:
            raise ValueError('boom')
        except ValueError:
            cls(lg).exception('tick failed %d', 7)

    (rec,) = capture('exc1', call)
    msg = rec.getMessage()
    assert msg.startswith('tick failed 7')
    assert 'ValueError: boom' in msg


def test_exception_outside_except_block_logs_plain_error():
    """logging.exception() with no active exception must not append
    the confusing 'NoneType: None' tail format_exc() produces outside
    an except block."""
    (rec,) = capture('exc2', lambda cls, lg: cls(lg).exception(
        'no active exception here'))
    msg = rec.getMessage()
    assert rec.levelno == logging.ERROR
    assert msg == 'no active exception here'
    assert 'NoneType' not in msg


async def test_client_stack_accretes_context(server):
    """Connection records carry zkAddress/zkPort; once the session is
    up, session and connection records carry sessionId."""
    lg = logging.getLogger('zkstream_tpu_torch.test.e2e')
    lg.setLevel(1)
    lg.propagate = False
    cap = _Capture()
    lg.addHandler(cap)
    c = Client(address='127.0.0.1', port=server.port,
               session_timeout=5000, log=Logger(lg))
    c.start()
    try:
        await c.wait_connected(timeout=5)
        await c.ping()
        await wait_until(lambda: any(
            getattr(r, 'zk_context', {}).get('component') == 'ZKSession'
            and 'sessionId' in r.zk_context for r in cap.records))
    finally:
        await c.close()
        lg.removeHandler(cap)

    ctxs = [getattr(r, 'zk_context', {}) for r in cap.records]
    conn_ctxs = [x for x in ctxs
                 if x.get('component') == 'ZKConnectionFSM']
    assert conn_ctxs, 'no connection records captured'
    assert all(x['zkAddress'] == '127.0.0.1' and
               x['zkPort'] == server.port for x in conn_ctxs)
    # Post-handshake connection records accrete the session id.
    sid = c.session.get_session_id()
    assert any(x.get('sessionId') == sid for x in conn_ctxs)
    sess_ctxs = [x for x in ctxs if x.get('component') == 'ZKSession']
    assert any(x.get('sessionId') == sid for x in sess_ctxs)
