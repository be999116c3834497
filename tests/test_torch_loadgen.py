"""The port's C load generator (zkstream_tpu_torch/csrc/loadgen.c; the
port of tests/test_loadgen.py).

The reference's pillars, on the port's binary (built by the port's
``utils.native.build_loadgen`` into ``build/``) and its ``utils.loadgen``
glue:

1. **Parity** — the C arm and the port's Python client agree against a
   live server (the port's ``ZKServer`` and the reference's): op counts
   reconcile exactly with the server's zxid advance, the acked-write
   max zxid sits inside the bracket, and the loadgen's fan-out SET
   fires a watch the Python client armed.
2. **zxid floor check** — a fake server replaying a stale zxid: exit 4.
3. **Malformed/torn replies** — exit 3.
4. **Scale smoke** — 1k sessions against one in-process server.
5. **Cached arm** — ADD_WATCH and local hits.

Plus the one place the port departs from ``tools/loadgen.c``: a thread
that has finished a phase keeps its ``phase_done`` stamp until the main
thread moves the phase on.  With the reference's copy, a 1,000-session
run at two or more threads usually hung in the connect phase; here five
runs at ``--threads 4`` must each get through it.

``_run_loadgen`` kills the process when its time runs out, so a hung
load generator never outlives its test.  Every test skips cleanly when
the host has no C compiler.
"""

import asyncio
import json
import socket
import struct
import threading

import pytest

from zkstream_tpu_torch import Client
from zkstream_tpu_torch.utils import loadgen, native

from test_torch_basic import server_cls  # noqa: F401

BIN = native.build_loadgen()

pytestmark = pytest.mark.skipif(
    BIN is None, reason='no C compiler: zkloadgen unavailable')


async def _run_loadgen(cmd, timeout=120):
    """Run one loadgen invocation to completion while the caller's
    event loop (and therefore any in-process server) keeps serving.
    Returns (rc, summary dict).  On timeout the process is killed and
    reaped before the TimeoutError propagates."""
    proc = await asyncio.create_subprocess_exec(
        *cmd, stdout=asyncio.subprocess.PIPE,
        stderr=asyncio.subprocess.DEVNULL)
    try:
        out, _ = await asyncio.wait_for(proc.communicate(), timeout)
    except BaseException:
        if proc.returncode is None:
            proc.kill()
            await proc.wait()
        raise
    summary = json.loads(out.decode().strip().splitlines()[-1])
    return proc.returncode, summary


def test_binary_is_the_ports_own():
    """The port builds its own copy, from its own source, into build/."""
    assert BIN == native.loadgen_path()
    assert native.loadgen_source_path().endswith(
        'zkstream_tpu_torch/csrc/loadgen.c')
    assert '/build/' in BIN
    assert loadgen.argv([('127.0.0.1', 1)], 3)[0] == BIN


# -- pillar 1: loadgen-vs-Python parity ---------------------------------


async def test_parity_op_counts_zxids_and_watch_fires(event_loop,
                                                      server_cls):
    """Bracket a count-mode loadgen run between two Python-client
    writes: every successful loadgen write must account for exactly
    one zxid step, its acked-write max zxid must fall inside the
    bracket, and its fan-out SET must fire a watch the PYTHON client
    armed (the two arms observe each other's effects)."""
    srv = await server_cls().start()
    c = Client(servers=[('127.0.0.1', srv.port)],
               shuffle_backends=False, session_timeout=30000)
    c.start()
    try:
        await c.wait_connected(timeout=10)
        await c.create('/parity', b'seed')
        fired = asyncio.Event()
        w = c.watcher('/parity')
        w.on('dataChanged', lambda *a: fired.set())
        await asyncio.sleep(0.05)     # let the watch arm land
        before = (await c.set('/parity', b'a')).mzxid

        sessions, count = 10, 30
        cmd = loadgen.argv(
            [('127.0.0.1', srv.port)], sessions, count=count,
            mix='get=50,set=50', path='/parity', ensure_path=False,
            arm_watch=True, fanout_sets=2, pipeline=4,
            close_sessions=True)
        rc, s = await _run_loadgen(cmd)
        assert rc == 0, s
        after = (await c.set('/parity', b'b')).mzxid

        # op-count parity: the steady window issued exactly
        # sessions x count mix ops (the fan-out rounds' SETs ride the
        # SET_DATA class too), all of them acked
        ops = s['ops']
        mix_ops = (ops['GET_DATA']['count']
                   + ops['SET_DATA']['count'])
        assert mix_ops == sessions * count + s['fanout']['rounds']
        assert s['errors'] == {'connect': 0, 'io': 0, 'proto': 0}
        assert s['zxid']['floor_violations'] == 0

        # zxid parity: every write the server acked to the loadgen
        # (steady SETs + the 2 fan-out SETs) is one zxid step in the
        # Python client's bracket, and nothing else wrote
        writes = (ops['SET_DATA']['count']
                  - ops['SET_DATA']['errors'])
        assert after - before == writes + 1
        assert before < s['zxid']['acked_write_max_zxid'] < after
        assert s['zxid']['max_zxid'] <= after

        # cross-arm watch delivery: the loadgen's fan-out SET fired
        # the watch the Python client armed...
        await asyncio.wait_for(fired.wait(), 5)
        # ...and the loadgen's own armed watchers all fired too
        assert s['fanout']['rounds'] == 2
        assert s['fanout']['delivered'] == s['fanout']['expected']
        assert s['notifications'] >= s['fanout']['delivered']
    finally:
        try:
            await asyncio.wait_for(c.close(), 5)
        except Exception:
            c.pool.stop()
        await srv.stop()


# -- fake servers for the failure pillars -------------------------------

_CONNECT_RESP = struct.pack('>iiq', 0, 30000, 0x1234) + \
    struct.pack('>i', 16) + b'\0' * 16


def _frame(body: bytes) -> bytes:
    return struct.pack('>i', len(body)) + body


def _recv_frame(conn: socket.socket) -> bytes | None:
    hdr = b''
    while len(hdr) < 4:
        chunk = conn.recv(4 - len(hdr))
        if not chunk:
            return None
        hdr += chunk
    need = struct.unpack('>i', hdr)[0]
    body = b''
    while len(body) < need:
        chunk = conn.recv(need - len(body))
        if not chunk:
            return None
        body += chunk
    return body


def _fake_server(per_request):
    """One-connection fake ZK server: answers the handshake, then
    calls ``per_request(conn, n, xid)`` for each request frame.
    Returns (port, thread)."""
    lsock = socket.socket()
    lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lsock.bind(('127.0.0.1', 0))
    lsock.listen(8)
    port = lsock.getsockname()[1]

    def serve():
        try:
            conn, _ = lsock.accept()
            with conn:
                if _recv_frame(conn) is None:   # ConnectRequest
                    return
                conn.sendall(_frame(_CONNECT_RESP))
                n = 0
                while True:
                    body = _recv_frame(conn)
                    if body is None:
                        return
                    xid = struct.unpack('>i', body[:4])[0]
                    if not per_request(conn, n, xid):
                        return
                    n += 1
        except OSError:
            pass
        finally:
            lsock.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    return port, t


# -- pillar 2: stale-reply zxid-floor detection -------------------------


async def test_zxid_floor_violation_exits_4(event_loop):
    """A reply whose header zxid is OLDER than what the connection
    already observed trips the per-connection floor check: counted in
    the summary, distinct exit code 4."""
    def stale(conn, n, xid):
        # the first reply raises the floor to 100; later replies
        # replay zxid 50 — stale reads the loadgen must catch
        zxid = 100 if n == 0 else 50
        conn.sendall(_frame(struct.pack('>iqi', xid, zxid, 0)))
        return True

    port, _t = _fake_server(stale)
    cmd = loadgen.argv([('127.0.0.1', port)], 1, count=2,
                       mix='get=100', ensure_path=False, pipeline=1)
    rc, s = await _run_loadgen(cmd)
    assert rc == 4, s
    assert s['zxid']['floor_violations'] >= 1
    assert s['client_capped'] is False


async def test_monotone_zxids_exit_0(event_loop):
    """The control arm: monotone zxids are clean — exit 0, no
    violations."""
    def monotone(conn, n, xid):
        conn.sendall(_frame(struct.pack('>iqi', xid, 100 + n, 0)))
        return True

    port, _t = _fake_server(monotone)
    cmd = loadgen.argv([('127.0.0.1', port)], 1, count=2,
                       mix='get=100', ensure_path=False, pipeline=1)
    rc, s = await _run_loadgen(cmd)
    assert rc == 0, s
    assert s['zxid']['floor_violations'] == 0


# -- pillar 3: malformed / torn replies ---------------------------------


async def test_torn_reply_exits_3(event_loop):
    """A reply torn mid-frame is a protocol error: counted, distinct
    exit code 3 — never conflated with the floor-violation exit."""
    def torn(conn, n, xid):
        conn.sendall(struct.pack('>i', 16)
                     + struct.pack('>iI', xid, 0))
        return False    # close mid-frame

    port, _t = _fake_server(torn)
    cmd = loadgen.argv([('127.0.0.1', port)], 1, count=2,
                       mix='get=100', ensure_path=False, pipeline=1)
    rc, s = await _run_loadgen(cmd)
    assert rc == 3, s
    assert s['errors']['proto'] == 1
    assert s['zxid']['floor_violations'] == 0


async def test_unmatched_xid_exits_3(event_loop):
    """A reply whose xid matches no outstanding request is malformed,
    same distinct exit code."""
    def misrouted(conn, n, xid):
        conn.sendall(_frame(struct.pack('>iqi', xid + 7, 1, 0)))
        return True

    port, _t = _fake_server(misrouted)
    cmd = loadgen.argv([('127.0.0.1', port)], 1, count=2,
                       mix='get=100', ensure_path=False, pipeline=1)
    rc, s = await _run_loadgen(cmd)
    assert rc == 3, s
    assert s['errors']['proto'] >= 1


async def test_nothing_connected_exits_5(event_loop):
    """No server at all: nothing connects, distinct exit code 5, and
    the summary line is still printed."""
    lsock = socket.socket()
    lsock.bind(('127.0.0.1', 0))
    port = lsock.getsockname()[1]
    lsock.close()                    # a port nobody listens on
    cmd = loadgen.argv([('127.0.0.1', port)], 2, count=1,
                       mix='get=100', ensure_path=False)
    rc, s = await _run_loadgen(cmd)
    assert rc == 5, s
    assert s['connected'] == 0


# -- pillar 4: 1k-session smoke -----------------------------------------


async def test_thousand_session_smoke(event_loop, server_cls):
    """1000 raw-socket sessions against one in-process server: every
    session connects, the count-mode window drains exactly, zero
    floor violations / protocol errors, and the summary carries the
    fd-cap accounting the million-session campaign relies on."""
    srv = await server_cls().start()
    try:
        sessions, count = 1000, 5
        cmd = loadgen.argv([('127.0.0.1', srv.port)], sessions,
                           count=count, mix='get=100',
                           path='/smoke', pipeline=2,
                           close_sessions=True)
        rc, s = await _run_loadgen(cmd, timeout=180)
        assert rc == 0, s
        assert s['connected'] == sessions
        assert s['ops']['GET_DATA']['count'] == sessions * count
        assert s['errors'] == {'connect': 0, 'io': 0, 'proto': 0}
        assert s['zxid']['floor_violations'] == 0
        assert s['handshake']['failures'] == 0
        caps = s['caps']
        assert caps['nofile_soft'] >= sessions
        assert caps['sessions_clamped'] is False
    finally:
        await srv.stop()


# -- the repair: every thread keeps its phase stamp ---------------------


@pytest.mark.timeout(300)
async def test_thousand_sessions_four_threads_pass_connect_five_runs(
        event_loop):
    """Five 1,000-session runs at ``--threads 4`` against the port's
    server each complete: every session connects, the connect phase
    ends (the main thread saw all four threads' stamps), and the
    count-mode window drains exactly.  The reference's copy of the
    program hung in the connect phase on most such runs."""
    from zkstream_tpu_torch.server import ZKServer

    srv = await ZKServer().start()
    try:
        sessions, count = 1000, 2
        for run in range(5):
            cmd = loadgen.argv([('127.0.0.1', srv.port)], sessions,
                               count=count, mix='get=100',
                               path='/threads', pipeline=2, threads=4,
                               close_sessions=True)
            assert cmd[cmd.index('--threads') + 1] == '4'
            rc, s = await _run_loadgen(cmd, timeout=50)
            assert rc == 0, (run, s)
            assert s['connected'] == sessions, (run, s)
            assert s['ops']['GET_DATA']['count'] == sessions * count
            assert s['errors'] == {'connect': 0, 'io': 0, 'proto': 0}
    finally:
        await srv.stop()


# -- pillar 5: cached arm (ADD_WATCH + local hit simulation) ------------


async def test_cached_arm_add_watch_and_local_hits(event_loop,
                                                   server_cls):
    """--cached arms one persistent-recursive ADD_WATCH per session,
    serves steady reads from the local entry (no wire traffic), and
    every writer-churn notification invalidates exactly one refill
    read."""
    srv = await server_cls().start()
    try:
        sessions = 8
        cmd = loadgen.argv([('127.0.0.1', srv.port)], sessions,
                           duration=2, pipeline=4, path='/cbench',
                           cached=True, cached_write_ms=100)
        rc, s = await _run_loadgen(cmd, timeout=120)
        assert rc == 0, s
        assert s['connected'] == sessions
        assert s['ops']['ADD_WATCH']['count'] == sessions
        assert s['ops']['ADD_WATCH']['errors'] == 0
        cache = s['cache']
        assert cache['hits'] > 0
        assert cache['invalidations'] > 0
        # one wire refill per invalidation, like the client cache
        assert cache['wire_reads_win'] <= cache['invalidations'] + sessions
        assert cache['hit_ratio'] > 0.5
        # local hits never cross the wire: single-digit microseconds
        assert cache['hit_p50_us'] < 10.0
        assert s['notifications'] >= cache['invalidations']
        assert s['zxid']['floor_violations'] == 0
        assert s['errors'] == {'connect': 0, 'io': 0, 'proto': 0}
    finally:
        await srv.stop()
