"""The port's overload plane (io/overload.py; the port of
tests/test_overload.py): admission control, rx/tx backpressure,
slow-consumer defense, and the global write throttle.  Server-facing
cases run on the port's server and on the JAX package's.

Covers the README "Overload plane" contract:

- knob resolution (ctor beats env beats defaults; inverted watermarks
  repaired) and the ``ZKSTREAM_NO_OVERLOAD=1`` kill switch (plane off,
  frame cap pinned to the legacy MAX_PACKET — byte-stream parity);
- admission: the connection cap, held to the reference server's
  behaviour on the same dials (what the third dial observes, and the
  shed count);
- the inbound frame cap: an absurd declared length is refused BEFORE
  buffering with a typed eviction and a definite socket close, on the
  server; the client threads its own cap into its codec;
- tx watermarks: soft drops watch notifications (the legally lossy
  channel), hard evicts the slow consumer with the buffered bytes
  DISCARDED — a fan-out with one stalled subscriber completes to the
  healthy subscriber with every connection's tx backlog bounded by
  the hard watermark;
- the global write throttle: writes bounce with the typed, retryable
  ``THROTTLED`` code (the client's capped-exp backoff retries to
  success once pressure clears; reads keep flowing).

The overload fault vocabulary and its chaos slices run on the port's
fault plane (its ensemble schedules' ingests on the CPU).
"""

from __future__ import annotations

import asyncio
import functools
import os
import struct

import pytest

from helpers import wait_until
from zkstream_tpu_torch import Client
from zkstream_tpu_torch.io import faults
from zkstream_tpu_torch.io.backoff import BackoffPolicy
from zkstream_tpu_torch.io.faults import FaultConfig, FaultInjector, FaultPlan
from zkstream_tpu_torch.io.overload import (
    MAX_CONNS_ENV,
    NO_OVERLOAD_ENV,
    TX_SOFT_ENV,
    OverloadConfig,
    OverloadPlane,
    overload_enabled,
)
from zkstream_tpu_torch.protocol.consts import MAX_PACKET
from zkstream_tpu_torch.protocol.errors import (
    ZKError,
    ZKFrameTooLargeError,
    ZKThrottledError,
)
from zkstream_tpu_torch.protocol.framing import FrameDecoder
from zkstream_tpu_torch.server import ZKServer
from test_torch_basic import server_cls  # noqa: F401

FAST = dict(
    connect_policy=BackoffPolicy(timeout=300, retries=2, delay=30,
                                 cap=200),
    default_policy=BackoffPolicy(timeout=500, retries=3, delay=20,
                                 cap=120))


async def _read_closed(reader) -> bool:
    """True if the peer definitively closed the stream (EOF or RST) —
    the shed/evict contract is 'a definite close, never a hang'."""
    try:
        return await asyncio.wait_for(reader.read(64), 5) == b''
    except (ConnectionResetError, ConnectionAbortedError):
        return True


# -- knob resolution and the kill switch -------------------------------

def test_config_ctor_beats_env_beats_default(monkeypatch):
    monkeypatch.setenv(MAX_CONNS_ENV, '77')
    monkeypatch.setenv(TX_SOFT_ENV, '1000')
    cfg = OverloadConfig.resolve()
    assert cfg.max_conns == 77
    assert cfg.tx_soft == 1000
    cfg = OverloadConfig.resolve(max_conns=5)
    assert cfg.max_conns == 5          # ctor beats env
    monkeypatch.delenv(MAX_CONNS_ENV)
    assert OverloadConfig.resolve().max_conns == \
        OverloadConfig().max_conns     # default


def test_config_repairs_inverted_watermarks():
    cfg = OverloadConfig.resolve(tx_soft=1 << 20, tx_hard=1 << 10)
    assert cfg.tx_hard >= cfg.tx_soft


def test_kill_switch_env(monkeypatch):
    monkeypatch.delenv(NO_OVERLOAD_ENV, raising=False)
    assert overload_enabled()
    monkeypatch.setenv(NO_OVERLOAD_ENV, '1')
    assert not overload_enabled()


async def test_no_overload_parity_server_shape(server_cls):
    """With the plane off the server carries no OverloadPlane, the
    frame cap pins to the legacy MAX_PACKET, and mntr grows no
    overload rows — the byte-stream-parity shape the kill switch
    promises."""
    srv = await server_cls(overload=False).start()
    try:
        assert srv.overload is None
        assert srv.max_frame == MAX_PACKET
        rows = dict(srv.monitor_stats())
        assert not any(k.startswith('zk_overload_') for k in rows)
    finally:
        await srv.stop()
    on = await server_cls().start()
    try:
        rows_on = dict(on.monitor_stats())
        assert 'zk_overload_sheds' in rows_on
        assert 'zk_overload_tx_buffered_bytes' in rows_on
    finally:
        await on.stop()


def test_client_kill_switch_pins_frame_cap(monkeypatch):
    monkeypatch.setenv(NO_OVERLOAD_ENV, '1')
    c = Client(address='127.0.0.1', port=1)
    assert c.max_frame == MAX_PACKET
    monkeypatch.delenv(NO_OVERLOAD_ENV)
    c2 = Client(address='127.0.0.1', port=1, max_frame=4096)
    assert c2.max_frame == 4096


# -- admission control -------------------------------------------------

async def _cap_dials(server_cls) -> tuple:
    """Two held dials then a third against a server capped at two
    connections: what the third observes (a definite close after its
    connect, or a reset of the connect itself) and the shed count."""
    from zkstream_tpu.io.overload import OverloadConfig as RefConfig

    cfg = (OverloadConfig if server_cls is ZKServer else RefConfig)(
        max_conns=2)
    srv = await server_cls(overload_config=cfg).start()
    held = []
    try:
        for _ in range(2):
            held.append(await asyncio.open_connection('127.0.0.1',
                                                      srv.port))
        await wait_until(lambda: len(srv.conns) >= 2)
        try:
            r3, w3 = await asyncio.open_connection('127.0.0.1', srv.port)
        except ConnectionError:
            third = 'connect reset'
        else:
            third = ('closed' if await _read_closed(r3) else 'served')
            w3.close()
        await asyncio.sleep(0.1)
        return third, srv.overload.sheds > 0, \
            dict(srv.monitor_stats())['zk_overload_sheds'] > 0
    finally:
        for _r, w in held:
            w.close()
        await srv.stop()


async def test_connection_cap_same_dials_as_reference():
    """Raw dials beyond the cap get what the JAX package's server gives
    them on the same dials: the third dial is never served, and the
    shed is counted in the plane and in mntr alike."""
    from zkstream_tpu.server import ZKServer as RefServer

    port = await _cap_dials(ZKServer)
    ref = await _cap_dials(RefServer)
    assert port[0] != 'served'
    assert port == ref


# -- the inbound frame cap ---------------------------------------------

def test_frame_decoder_rejects_oversized_declaration():
    dec = FrameDecoder(use_native=False, max_frame=64)
    with pytest.raises(ZKFrameTooLargeError) as ei:
        dec.feed(struct.pack('>i', 1 << 20) + b'\x00' * 8)
    assert ei.value.length == 1 << 20
    assert ei.value.cap == 64
    # within the cap: frames flow
    dec2 = FrameDecoder(use_native=False, max_frame=64)
    assert dec2.feed(struct.pack('>i', 3) + b'abc') == [b'abc']


async def test_server_evicts_oversized_frame(server_cls):
    """An absurd declared length is refused before buffering: typed
    eviction, definite close, and the server keeps serving."""
    srv = await server_cls(max_frame=1 << 16).start()
    try:
        r, w = await asyncio.open_connection('127.0.0.1', srv.port)
        w.write(struct.pack('>i', 1 << 26) + b'\x00' * 16)
        assert await _read_closed(r)
        w.close()
        await wait_until(lambda: srv.overload.evictions >= 1)
        # ...and a real client still handshakes and writes after it
        c = Client(address='127.0.0.1', port=srv.port, **FAST)
        c.start()
        await c.wait_connected(timeout=5)
        await c.create('/alive', b'x')
        await c.close()
    finally:
        await srv.stop()


async def test_client_threads_frame_cap_into_codec(server_cls):
    srv = await server_cls().start()
    c = Client(address='127.0.0.1', port=srv.port, max_frame=12345,
               **FAST)
    try:
        c.start()
        await c.wait_connected(timeout=5)
        conn = c.current_connection()
        assert conn.codec._max_frame == 12345
    finally:
        await c.close()
        await srv.stop()


# -- rx backpressure (inflight throttle) -------------------------------

class _StubTx:
    def __init__(self):
        self.n = 0

    def buffered_bytes(self):
        return self.n


class _StubConn:
    def __init__(self):
        self.closed = False
        self.session = None
        self.session_id = None
        self._tx = _StubTx()
        self._ingress = None
        self._rx_paused = False
        self._notif_dropping = False
        self.aborted = False

    def abort(self):
        self.aborted = True
        self.closed = True


class _StubServer:
    trace = None
    blackbox = None

    def __init__(self):
        self.conns = set()


async def test_inflight_throttle_pauses_and_resumes():
    srv = _StubServer()
    plane = OverloadPlane(srv, cfg=OverloadConfig(max_inflight=4))
    conn = _StubConn()
    plane.after_drain(conn, 3)
    assert not conn._rx_paused         # under the cap: untouched
    plane.after_drain(conn, 4)
    assert conn._rx_paused
    assert plane.rx_pauses == 1
    await asyncio.sleep(0.05)          # > RX_PAUSE_S
    assert not conn._rx_paused         # resumed by the timer


# -- tx watermarks (slow-consumer defense) -----------------------------

def test_soft_watermark_drops_notifications():
    srv = _StubServer()
    plane = OverloadPlane(srv, cfg=OverloadConfig(tx_soft=100,
                                                  tx_hard=1000))
    conn = _StubConn()
    conn._tx.n = 50
    assert plane.allow_notification(conn)
    conn._tx.n = 150
    assert not plane.allow_notification(conn)
    assert plane.notifications_dropped == 1
    conn._tx.n = 10                    # backlog drained: flows again
    assert plane.allow_notification(conn)


def test_hard_watermark_evicts_and_discards():
    srv = _StubServer()
    plane = OverloadPlane(srv, cfg=OverloadConfig(tx_soft=100,
                                                  tx_hard=1000))
    conn = _StubConn()
    conn._tx.n = 999
    assert not plane.check_tx(conn)
    assert not conn.aborted
    conn._tx.n = 1000
    assert plane.check_tx(conn)
    assert conn.aborted                # abort discards, never flushes
    assert conn.evicted == 'tx_hard'
    assert plane.evictions == 1
    # an already-evicted (closed) conn is not double-counted
    assert not plane.check_tx(conn)
    assert plane.evictions == 1


def test_soft_watermark_persistent_subscriber_evicted_not_gapped():
    """Regression: the soft-watermark notification drop is only legal
    for ONE-SHOT watches (the client re-arms and re-reads on
    reconnect, closing the gap itself).  A PERSISTENT-watch
    subscriber is a watch-backed cache relying on a gap-free
    invalidation stream — a silent drop would leave it serving stale
    data forever.  Over the soft watermark it must be EVICTED (typed
    close, buffer discarded), never gapped."""
    srv = _StubServer()
    plane = OverloadPlane(srv, cfg=OverloadConfig(tx_soft=100,
                                                  tx_hard=1000))
    conn = _StubConn()
    conn._tx.n = 50
    assert plane.allow_persistent_notification(conn)   # under: flows
    assert plane.persistent_evictions == 0
    conn._tx.n = 150                   # over soft, under hard
    assert not plane.allow_persistent_notification(conn)
    assert conn.aborted                # evicted on the spot, not gapped
    assert conn.evicted == 'persistent_gap'
    assert plane.persistent_evictions == 1
    assert plane.evictions == 1
    assert plane.notifications_dropped == 0   # NOT the lossy channel
    # a closed conn is a no-op, not a double count
    assert plane.allow_persistent_notification(conn)
    assert plane.persistent_evictions == 1


@pytest.mark.timeout(60)
async def test_stalled_persistent_subscriber_evicted_then_resyncs(
        server_cls):
    """The stalled-subscriber e2e shape with a PERSISTENT-watch
    (cached) client: its tx backlog crosses the soft watermark, and
    the next fan-out that would have been silently dropped for a
    one-shot watch instead EVICTS it ('persistent_gap').  The client
    observes the connection loss, marks its cached subtree stale,
    re-dials, replays via SET_WATCHES2 and re-syncs — so a cached
    read after recovery observes the write it missed while stalled.
    Never a silent gap."""
    import socket as socketmod
    # the hard watermark is parked far away so the SOFT-watermark
    # persistent gate is the defense under test, not check_tx
    srv = await server_cls(
        overload_config=OverloadConfig(tx_soft=8 * 1024,
                                       tx_hard=64 * 1024 * 1024)).start()
    writer = Client(address='127.0.0.1', port=srv.port, **FAST)
    cached = Client(address='127.0.0.1', port=srv.port,
                    cache='/fan', session_timeout=10000, **FAST)
    pending = []
    try:
        for c in (writer, cached):
            c.start()
            await c.wait_connected(timeout=5)
        await wait_until(lambda: cached.cache.stats()['armed'] == 1)
        await writer.create('/fan', b'f')
        await writer.create('/fan/k', b'old')
        await writer.create('/big', b'p' * (32 * 1024))
        await cached.get('/fan/k')     # warm the cache
        d, _ = await cached.get('/fan/k')
        assert d == b'old'
        assert cached.cache.stats()['hits'] >= 1
        # Stall: shrink the receive window so the kernel can't mask
        # the backlog, stop reading, then pipeline ~3 MB of fat reads
        # so the tx account crosses the soft watermark.
        dying = cached.current_connection()
        tr = dying.transport
        sock = tr.get_extra_info('socket')
        if sock is not None:
            sock.setsockopt(socketmod.SOL_SOCKET,
                            socketmod.SO_RCVBUF, 4096)
        tr.pause_reading()
        pending = [asyncio.ensure_future(cached.get('/big'))
                   for _ in range(100)]
        await asyncio.sleep(0)         # let the requests hit the wire
        # the writes' invalidations cannot be delivered while the
        # replies are wedged in the tx account — the stalled
        # persistent subscriber must be evicted, not gapped
        for _ in range(20):
            await writer.set('/fan/k', b'new', version=-1)
            if srv.overload.persistent_evictions:
                break
        await wait_until(
            lambda: srv.overload.persistent_evictions >= 1,
            timeout=20)
        assert srv.overload.notifications_dropped == 0
        # recovery: the stalled client's reading is paused, so it
        # only notices the abort when a ping write fails — wait for
        # the connection loss, the re-dial, the SET_WATCHES2 replay
        # and the cache resync; the read then observes the write it
        # missed while stalled
        await wait_until(lambda: not dying.is_in_state('connected'),
                         timeout=20)
        await cached.wait_connected(timeout=15, fail_fast=False)
        await wait_until(lambda: cached.cache.stats()['armed'] == 1,
                         timeout=15)
        d, _ = await cached.get('/fan/k')
        assert d == b'new', d
    finally:
        for t in pending:
            t.cancel()
        await asyncio.gather(*pending, return_exceptions=True)
        for c in (writer, cached):
            await c.close()
        await srv.stop()


@pytest.mark.timeout(60)
async def test_stalled_subscriber_tx_bounded_and_evicted(server_cls):
    """The acceptance shape, scaled to test time: one subscriber
    stalls (stops reading) while pipelining reads of a fat node, so
    the server's replies pile into its tx account; a writer keeps the
    fan-out going for a healthy subscriber.  The defense must fire
    (the stalled consumer is evicted at the hard watermark, its
    buffer DISCARDED), every live connection's tx backlog must stay
    bounded by the hard watermark, and the healthy subscriber must
    keep observing changes throughout."""
    import socket as socketmod
    srv = await server_cls(
        overload_config=OverloadConfig(tx_soft=8 * 1024,
                                       tx_hard=64 * 1024)).start()
    writer = Client(address='127.0.0.1', port=srv.port, **FAST)
    healthy = Client(address='127.0.0.1', port=srv.port, **FAST)
    stalled = Client(address='127.0.0.1', port=srv.port, **FAST)
    pending = []
    try:
        for c in (writer, healthy, stalled):
            c.start()
            await c.wait_connected(timeout=5)
        await writer.create('/fan', b'f')
        await writer.create('/big', b'p' * (32 * 1024))
        fires = []
        healthy.watcher('/fan').on(
            'dataChanged',
            lambda data, stat: fires.append(stat.version))
        await wait_until(lambda: len(fires) >= 1)  # watch armed
        # Stall: shrink the client's receive window so the kernel
        # can't mask the backlog, stop reading, then pipeline 100
        # 32 KiB reads — ~3 MB of replies aimed at a socket that
        # will never drain.
        tr = stalled.current_connection().transport
        sock = tr.get_extra_info('socket')
        if sock is not None:
            sock.setsockopt(socketmod.SOL_SOCKET,
                            socketmod.SO_RCVBUF, 4096)
        tr.pause_reading()
        pending = [asyncio.ensure_future(stalled.get('/big'))
                   for _ in range(100)]
        await asyncio.sleep(0)         # let the requests hit the wire
        for _ in range(20):
            await writer.set('/fan', b'f', version=-1)
        # the stalled consumer was evicted at the hard watermark
        await wait_until(lambda: srv.overload.evictions >= 1,
                         timeout=20)
        # the healthy subscriber kept observing the fan-out
        await wait_until(lambda: len(fires) >= 3, timeout=20)
        assert fires[-1] > fires[0]
        # every LIVE connection's tx backlog is bounded by the hard
        # watermark — the evicted one's buffer was discarded, not
        # left bloating the member
        hard = srv.overload.cfg.tx_hard
        worst = max((c._tx.buffered_bytes()
                     for c in srv.conns if not c.closed), default=0)
        assert worst <= hard, \
            'tx backlog %d exceeds the hard watermark %d' \
            % (worst, hard)
    finally:
        for t in pending:
            t.cancel()
        await asyncio.gather(*pending, return_exceptions=True)
        for c in (writer, healthy, stalled):
            await c.close()
        await srv.stop()


# -- the global write throttle -----------------------------------------

async def test_throttled_write_bounces_typed_and_retries(server_cls):
    """Over the memory watermark new writes bounce with the typed,
    retryable THROTTLED code while reads keep flowing; once pressure
    clears mid-flight the client's internal capped-exp retry lands
    the write with no caller-visible error."""
    srv = await server_cls().start()
    c = Client(address='127.0.0.1', port=srv.port, **FAST)
    # the plane class of the server under test (the port's or the
    # reference's); __slots__ blocks patching the instance
    Plane = type(srv.overload)
    orig = Plane.write_throttled
    try:
        c.start()
        await c.wait_connected(timeout=5)
        await c.create('/t', b'v')
        # pressure on: every write bounces, reads keep flowing
        Plane.write_throttled = lambda self: True
        with pytest.raises(ZKThrottledError) as ei:
            await c.create('/bounced', b'x')
        assert ei.value.code == 'THROTTLED'
        assert isinstance(ei.value, ZKError)   # typed subclass
        assert srv.overload.throttled_writes > 0
        assert (await c.get('/t'))[0] == b'v'  # reads keep flowing
        # pressure clears while a write is backing off: the retry
        # succeeds without surfacing an error to the caller.  The
        # throttle bounces the set's first attempt only, so the retry
        # finds the pressure gone however the loop is paced (clearing
        # it from a poll raced the client's jittered retry budget)
        calls = []

        def first_attempt_only(_plane):
            calls.append(None)
            return len(calls) == 1

        Plane.write_throttled = first_attempt_only
        task = asyncio.ensure_future(
            c.set('/t', b'recovered', version=-1))
        before = srv.overload.throttled_writes
        await wait_until(
            lambda: srv.overload.throttled_writes > before)
        Plane.write_throttled = orig
        await asyncio.wait_for(task, 10)
        assert (await c.get('/t'))[0] == b'recovered'
    finally:
        Plane.write_throttled = orig
        await c.close()
        await srv.stop()


# -- the fault plane's overload draws and slices ------------------------


#: The CPU tests run every plan's ``FleetIngest`` on the CPU.
run_ensemble_schedule = functools.partial(faults.run_ensemble_schedule,
                                          device='cpu')


def test_overload_faults_deterministic():
    for seed in (0, 3, 99):
        a, b = (FaultConfig.randomized(seed) for _ in range(2))
        assert (a.p_conn_flood, a.p_stall_reader,
                a.p_oversize_frame) == \
            (b.p_conn_flood, b.p_stall_reader, b.p_oversize_frame)
        pa, pb = (FaultPlan.randomized(seed) for _ in range(2))
        assert pa.overloads == pb.overloads
        assert pa.forced_overload_steps() == \
            pb.forced_overload_steps()
        ia = FaultInjector(seed, FaultConfig(p_stall_reader=0.5))
        ib = FaultInjector(seed, FaultConfig(p_stall_reader=0.5))
        assert [ia.overload_action() for _ in range(8)] == \
            [ib.overload_action() for _ in range(8)]


def test_overload_draws_do_not_perturb_existing_streams():
    """The overload knobs ride fresh RNG streams: consuming the
    overload stream leaves every pre-existing category's draw
    sequence untouched (existing seeds stay pinned)."""
    inj = FaultInjector.randomized(4)
    inj.overload_action()
    fresh = FaultInjector.randomized(4)
    for cat in ('rx', 'tx', 'connect', 'server_tx'):
        assert [inj.rand(cat) for _ in range(8)] == \
            [fresh.rand(cat) for _ in range(8)]


@pytest.mark.timeout(120)
async def test_transport_tier_overload_slice():
    """A handful of transport-tier schedules across seeds whose fresh
    overload stream fires the mid-schedule burst: all invariants stay
    clean."""
    for seed in range(8):
        r = await faults.run_schedule(seed, ops=6)
        assert r.ok, 'seed %d: %r' % (r.seed, r.violations)


@pytest.mark.timeout(240)
async def test_ensemble_tier_forced_overload_slice():
    """Forced overload bursts (conn flood / stalled reader /
    oversized frame) in every ensemble schedule: the full invariant
    engine stays clean and the bursts land in the member timeline."""
    saw_burst = False
    for seed in (1, 5, 9):
        r = await run_ensemble_schedule(seed, ops=10, overloads=2)
        assert r.ok, 'seed %d: %r' % (r.seed, r.violations)
        if any(str(e.get('event', '')).startswith('overload-')
               for e in r.member_events):
            saw_burst = True
    assert saw_burst


@pytest.mark.slow
@pytest.mark.timeout(3000)
async def test_overload_campaign_slow():
    """The acceptance campaign: 120 seeded schedules with forced
    overload bursts, clean on every invariant.  Scale knobs mirror
    tests/test_torch_chaos.py."""
    base = int(os.environ.get('ZKSTREAM_CHAOS_SEED', '0'))
    n = int(os.environ.get('ZKSTREAM_OVERLOAD_SCHEDULES', '120'))
    bad = []
    for i in range(n):
        r = await run_ensemble_schedule(base + i, ops=10,
                                        overloads=2)
        if not r.ok:
            bad.append(r)
    assert not bad, 'failing seeds: %s' % (
        ', '.join('%d: %r' % (r.seed, r.violations) for r in bad))

