"""The port's batched-syscall transport tier (io/transport.py; the port
of tests/test_transport.py), and its C half against the JAX package's.

Covers the capability probe and its fallback order (env force falls
DOWN, never up — a forced ``uring`` on a pre-5.1 kernel runs mmsg,
and this suite stays green there via skip markers), the byte-stream
parity invariant the whole tier hangs on — every backend produces the
identical per-connection stream over the full opcode corpus, through
plane flushes, hard flushes and partial kernel writes — the
O(1)-submissions-per-tick contract with its syscall accounting
(``zookeeper_flush_syscalls_total`` / ``zookeeper_submit_depth``),
the flush_hard synchronous-delivery contract fault injection depends
on, backpressure fallback through the asyncio transport, the e2e
request/reply + notification parity across backends over real
sockets (on the port's server and on the JAX package's), and the
``zk_transport_backend`` mntr row.  The port's extension's transport
calls (``submit_writev``, ``drain_recv``, the io_uring ring,
``crc32c``) are held to the reference's on the same sockets.

Whether this host runs a batched backend is decided in a fixture,
never at import: the C extension that holds the ring may still be
building while the file is collected, and every worker must collect
the same tests."""

from __future__ import annotations

import asyncio
import functools
import socket

import pytest

from zkstream_tpu_torch.io import faults
from zkstream_tpu_torch.io.sendplane import SendPlane
from zkstream_tpu_torch.io.transport import (
    BACKENDS,
    METRIC_FLUSH_SYSCALLS,
    METRIC_SUBMIT_DEPTH,
    TransportTier,
    backend_default,
    make_tier,
    probe,
    resolve_backend,
)
from zkstream_tpu_torch.protocol.framing import PacketCodec
from zkstream_tpu_torch.server import ZKServer
from zkstream_tpu_torch.utils.metrics import Collector

from zkstream_tpu_torch.utils.native import ensure_ext

from test_fastencode import REPLIES, REQUESTS
from test_torch_basic import server_cls  # noqa: F401
from test_torch_server_edges import RawClient

#: The batched backends; each case runs on every one this host has.
BATCHED = ('uring', 'mmsg')


def _probe():
    """The capability probe with the port's extension built."""
    ensure_ext()
    return probe(refresh=True)


@pytest.fixture(params=BATCHED)
def backend(request):
    """A batched backend this host runs (the case skips where the
    probe refuses it, as the reference's suite does)."""
    p = _probe()
    if not p.available(request.param):
        pytest.skip('%s unavailable: %s' % (request.param, (
            p.uring_reason if request.param == 'uring' else p.mmsg_reason)))
    return request.param


@pytest.fixture
def ring_exts():
    """The port's extension and the JAX package's, where io_uring is
    available."""
    from zkstream_tpu.utils.native import ensure_ext as ref_ensure_ext

    p = _probe()
    if not p.uring:
        pytest.skip('io_uring unavailable: %s' % (p.uring_reason,))
    return ensure_ext(), ref_ensure_ext()


# -- a real transport over a socketpair --------------------------------

async def _pipe():
    """A live asyncio transport writing into a readable peer socket —
    the smallest thing the tier can resolve a raw fd from."""
    left, right = socket.socketpair()
    left.setblocking(False)
    right.setblocking(False)
    loop = asyncio.get_running_loop()
    transport, _ = await loop.create_connection(asyncio.Protocol,
                                                sock=left)
    return transport, right


async def _read_exact(sock, n, timeout=5.0) -> bytes:
    data = b''
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while len(data) < n:
        try:
            chunk = sock.recv(1 << 16)
            if not chunk:
                break
            data += chunk
        except BlockingIOError:
            pass
        assert loop.time() < deadline, \
            'timed out: %d/%d bytes' % (len(data), n)
        await asyncio.sleep(0)
    return data


# -- probe + resolution -------------------------------------------------

def test_probe_shape_and_default():
    p = probe()
    assert p.chosen in BACKENDS
    assert p.available(p.chosen)
    assert backend_default() == p.chosen
    # the chosen tier is the best available one
    for b in BACKENDS:
        if b == p.chosen:
            break
        assert not p.available(b)


def test_env_force_falls_down_never_up(monkeypatch):
    monkeypatch.setenv('ZKSTREAM_TRANSPORT', 'asyncio')
    assert backend_default() == 'asyncio'
    monkeypatch.setenv('ZKSTREAM_TRANSPORT', 'mmsg')
    assert backend_default() == ('mmsg' if probe().mmsg else 'asyncio')
    monkeypatch.setenv('ZKSTREAM_TRANSPORT', 'uring')
    d = backend_default()
    if not probe().uring:
        assert d != 'uring'        # degraded down the order
    monkeypatch.setenv('ZKSTREAM_TRANSPORT', 'bogus')
    assert backend_default() == probe().chosen   # ignored


def test_resolve_backend_rejects_unknown():
    with pytest.raises(ValueError):
        resolve_backend('sendfile')
    assert resolve_backend('asyncio') == 'asyncio'
    assert resolve_backend(None) == backend_default()


def test_make_tier_none_for_asyncio():
    assert make_tier('asyncio') is None


# -- byte-stream parity (the satellite): every backend, full corpus ----

async def _stream_through(backend: str | None,
                          frames: list[bytes]) -> bytes:
    """Push the corpus through one plane configuration — corked sends,
    a mid-stream flush_now, a hard flush, then a tail rides the tick
    flush — and return what the peer read."""
    transport, peer = await _pipe()
    try:
        tier = TransportTier(backend) if backend else None
        plane = SendPlane(transport.write, enabled=True, tier=tier,
                          transport_fn=lambda: transport)
        half = len(frames) // 2
        for f in frames[:half]:
            plane.send(f)
        plane.flush_now()            # deferred tier submission
        for f in frames[half:]:
            plane.send(f)
        plane.flush_hard()           # synchronous mid-tick drain
        for f in frames[:3]:
            plane.send(f)            # tail: tick-boundary flush
        for _ in range(4):
            await asyncio.sleep(0)
        expect = len(b''.join(frames)) + len(b''.join(frames[:3]))
        return await _read_exact(peer, expect)
    finally:
        transport.close()
        peer.close()


async def test_byte_stream_parity_all_opcodes(backend):
    """The invariant the tier hangs on: batched and asyncio backends
    produce IDENTICAL per-connection byte streams — for every opcode,
    both directions, across deferred, hard and tick flushes (the
    test_sendplane coalescing harness, run per backend)."""
    for server, corpus in ((True, REPLIES), (False, REQUESTS)):
        enc = PacketCodec(server=server, use_native=False)
        enc.handshaking = False
        frames = [enc.encode(dict(p)) for p in corpus]
        expect = b''.join(frames) + b''.join(frames[:3])
        baseline = await _stream_through(None, frames)
        assert baseline == expect
        got = await _stream_through(backend, frames)
        assert got == expect, \
            'backend %s diverged from the asyncio stream' % backend


async def test_one_submission_covers_every_dirty_connection(backend):
    """The tentpole's number: a tick that dirties N connections costs
    ONE batched submission (tier.submissions), with the syscall
    counter O(1) on uring and O(N) on mmsg — never O(frames)."""
    col = Collector()
    tier = TransportTier(backend, collector=col, plane='server')
    pipes = [await _pipe() for _ in range(8)]
    try:
        planes = [SendPlane(t.write, enabled=True, tier=tier,
                            transport_fn=lambda t=t: t)
                  for t, _ in pipes]
        for i, p in enumerate(planes):
            p.send(b'a%d' % i)
            p.send(b'b%d' % i)       # two frames, one plane flush
        for _ in range(3):
            await asyncio.sleep(0)
        assert tier.submissions == 1
        expected_syscalls = 1 if backend == 'uring' else 8
        assert tier.syscalls == expected_syscalls
        ctr = col.get_collector(METRIC_FLUSH_SYSCALLS)
        assert ctr.value({'plane': 'server',
                          'backend': backend}) == expected_syscalls
        dep = col.get_collector(METRIC_SUBMIT_DEPTH)
        assert dep.count({'plane': 'server', 'backend': backend}) == 1
        assert dep.sum({'plane': 'server', 'backend': backend}) == 8
        for i, (_, peer) in enumerate(pipes):
            assert await _read_exact(peer, 4) == b'a%db%d' % (i, i)
    finally:
        for t, peer in pipes:
            t.close()
            peer.close()


async def test_flush_hard_is_synchronous_on_batched_backends(backend):
    """The fault injector's boundary rule: after flush_hard returns,
    the bytes are already in the kernel — a direct transport write
    issued immediately after can never overtake them."""
    transport, peer = await _pipe()
    try:
        tier = TransportTier(backend)
        plane = SendPlane(transport.write, enabled=True, tier=tier,
                          transport_fn=lambda: transport)
        plane.send(b'corked-')
        plane.flush_hard()
        transport.write(b'injected')     # the gate's delivery path
        assert await _read_exact(peer, 15) == b'corked-injected'
    finally:
        transport.close()
        peer.close()


async def test_flush_hard_drains_tier_held_bytes(backend):
    """A cap-hit flush parks bytes in the tier entry with the PLANE
    buffer empty; a later flush_hard must still put them on the wire
    before returning — the fault gate writes directly right after,
    and nothing may overtake (the review-found ordering hole)."""
    transport, peer = await _pipe()
    try:
        tier = TransportTier(backend)
        plane = SendPlane(transport.write, enabled=True, max_bytes=4,
                          tier=tier, transport_fn=lambda: transport)
        plane.send(b'early')        # over the cap: parked in the tier
        assert plane.pending == 0
        plane.flush_hard()          # plane empty, tier entry is NOT
        transport.write(b'late')
        assert await _read_exact(peer, 9) == b'earlylate'
    finally:
        transport.close()
        peer.close()


async def test_stranded_tick_callback_recovers_on_next_loop(backend):
    """A tier whose tick callback was stranded on a dead loop (a
    client reused across asyncio.run calls) must reschedule on the
    next loop instead of wedging."""
    tier = TransportTier(backend)

    class _DeadLoop:
        def is_closed(self):
            return True
    tier._scheduled_on = _DeadLoop()    # the stranded state
    transport, peer = await _pipe()
    try:
        plane = SendPlane(transport.write, enabled=True, tier=tier,
                          transport_fn=lambda: transport)
        plane.send(b'revived')
        for _ in range(3):
            await asyncio.sleep(0)
        assert await _read_exact(peer, 7) == b'revived'
    finally:
        transport.close()
        peer.close()


async def test_partial_write_falls_back_in_order(backend):
    """A raw write that fills the kernel buffer hands the REMAINDER to
    the asyncio transport, and later ticks queue behind it — the
    stream survives backpressure byte-identical."""
    left, right = socket.socketpair()
    left.setblocking(False)
    right.setblocking(False)
    left.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 8192)
    loop = asyncio.get_running_loop()
    transport, _ = await loop.create_connection(asyncio.Protocol,
                                                sock=left)
    try:
        tier = TransportTier(backend)
        plane = SendPlane(transport.write, enabled=True, tier=tier,
                          transport_fn=lambda: transport)
        import os as _os
        payload = _os.urandom(400000)    # >> SO_SNDBUF and the cap
        plane.send(payload)              # cap hit: immediate flush
        await asyncio.sleep(0)
        plane.send(b'TAIL')              # must queue BEHIND the spill
        reader = asyncio.ensure_future(
            _read_exact(right, len(payload) + 4, timeout=10))
        got = await reader
        assert got == payload + b'TAIL'
    finally:
        transport.close()
        right.close()


async def test_iov_guard_coalesces_pathological_chunk_counts(backend):
    """A tick holding more chunks than an iovec can carry coalesces in
    place instead of overflowing the submission (IOV_MAX guard)."""
    from zkstream_tpu_torch.io.transport import IOV_GUARD
    transport, peer = await _pipe()
    try:
        tier = TransportTier(backend)
        plane = SendPlane(transport.write, enabled=True, tier=tier,
                          transport_fn=lambda: transport)
        n = IOV_GUARD + 64
        for i in range(n):
            plane.send(b'%04d' % i)
        plane.flush_now()
        entry = plane._entry
        assert len(entry.chunks) <= IOV_GUARD + 1
        for _ in range(3):
            await asyncio.sleep(0)
        expect = b''.join(b'%04d' % i for i in range(n))
        assert await _read_exact(peer, len(expect)) == expect
    finally:
        transport.close()
        peer.close()


async def test_uring_ring_roundtrip(ring_exts):
    """Where io_uring exists: one enter syscall delivers a whole batch
    across distinct sockets (the native ring in csrc/zkwire_ext.c)."""
    ext, _ref = ring_exts
    pairs = [socket.socketpair() for _ in range(4)]
    try:
        ring = ext.uring_create(64)
        fds = [a.fileno() for a, _b in pairs]
        chunks = [[b'frame-', b'%d' % i] for i in range(len(pairs))]
        results, enters = ext.uring_submit(ring, fds, chunks)
        assert enters == 1
        assert results == [7] * 4
        for i, (a, b) in enumerate(pairs):
            assert b.recv(16) == b'frame-%d' % i
        ext.uring_close(ring)
    finally:
        for a, b in pairs:
            a.close()
            b.close()


# -- e2e over real sockets: parity + accounting + mntr -----------------

async def _scripted_ops(backend: str, server_cls) -> list[tuple]:
    """One deterministic request/watch workload against a forced-
    backend server; returns the decoded reply/notification stream."""
    srv = await server_cls(transport=backend).start()
    want = ('asyncio' if srv.transport_tier is None
            else srv.transport_tier.backend)
    assert want == backend
    c = RawClient()
    out: list[tuple] = []
    try:
        await c.connect(srv)
        c.send({'opcode': 'CREATE', 'path': '/t', 'data': b'v0',
                'acl': [], 'flags': 0})
        c.send({'opcode': 'GET_DATA', 'path': '/t', 'watch': True})
        # pipelined burst: multi-frame coalescing through the tier
        for i in range(8):
            c.send({'opcode': 'GET_DATA', 'path': '/t',
                    'watch': False})
        c.send({'opcode': 'SET_DATA', 'path': '/t', 'data': b'v1',
                'version': -1})
        c.send({'opcode': 'GET_DATA', 'path': '/t', 'watch': False})
        # replies: create + watch-get + 8 gets + set + get, plus the
        # DATA_CHANGED notification (which must precede the post-set
        # read result — the ordering contract)
        pkts = await c.recv(13)
        for p in pkts:
            out.append((p['opcode'], p['err'],
                        p.get('path'), bytes(p.get('data') or b'')))
        notif_at = [i for i, p in enumerate(pkts)
                    if p['opcode'] == 'NOTIFICATION']
        read_v1 = [i for i, p in enumerate(pkts)
                   if p['opcode'] == 'GET_DATA'
                   and bytes(p.get('data') or b'') == b'v1']
        assert notif_at and read_v1 and notif_at[0] < read_v1[0], \
            'notification overtaken by the read of the new state'
    finally:
        c.close()
        await srv.stop()
    return out


async def test_e2e_stream_parity_across_backends(backend, server_cls):
    assert await _scripted_ops(backend, server_cls) \
        == await _scripted_ops('asyncio', server_cls)


async def test_e2e_batched_backend_counts_syscalls(backend):
    col = Collector()
    srv = await ZKServer(transport=backend, collector=col).start()
    c = RawClient()
    try:
        await c.connect(srv)
        for i in range(6):
            c.send({'opcode': 'EXISTS', 'path': '/none%d' % i,
                    'watch': False})
        await c.recv(6)
    finally:
        c.close()
        await srv.stop()
    ctr = col.get_collector(METRIC_FLUSH_SYSCALLS)
    assert ctr.value({'plane': 'server', 'backend': backend}) > 0


def test_mntr_reports_transport_backend(backend):
    srv = ZKServer(transport='asyncio')
    rows = dict(srv.monitor_stats())
    assert rows['zk_transport_backend'] == 'asyncio'
    srv2 = ZKServer(transport=backend)
    rows2 = dict(srv2.monitor_stats())
    assert rows2['zk_transport_backend'] == backend


# -- the C transport half against the reference's ----------------------

def _pairs(n):
    pairs = [socket.socketpair() for _ in range(n)]
    for a, b in pairs:
        a.setblocking(False)
        b.setblocking(False)
    return pairs


def _close(pairs):
    for a, b in pairs:
        a.close()
        b.close()


def _recv_all(sock) -> bytes:
    out = b''
    while True:
        try:
            chunk = sock.recv(1 << 16)
        except BlockingIOError:
            return out
        if not chunk:
            return out
        out += chunk


def _chunklists():
    """One entry per socket: no chunks, one, several, a large one."""
    return [[], [b'one'], [b'a', b'bb', b'', b'ccc'],
            [bytes(range(256)) * 64, b'tail']]


def _ref_ext():
    from zkstream_tpu.utils.native import ensure_ext as ref_ensure_ext
    ext = ref_ensure_ext()
    assert ext is not None, 'the reference extension did not build'
    return ext


def test_submit_writev_matches_reference():
    """The same chunk lists through both extensions' batched writes,
    one socket each, give the same per-entry results and bytes."""
    port_ext, ref_ext = ensure_ext(), _ref_ext()
    out = []
    for ext in (port_ext, ref_ext):
        pairs = _pairs(4)
        try:
            res = ext.submit_writev([a.fileno() for a, _b in pairs],
                                    _chunklists())
            out.append((res, [_recv_all(b) for _a, b in pairs]))
        finally:
            _close(pairs)
    assert out[0] == out[1]
    assert out[0][1] == [b''.join(c) for c in _chunklists()]


def test_drain_recv_matches_reference():
    """One receive per socket in one call: data, nothing pending
    (-EAGAIN), EOF (b'') and a closed descriptor's error, the same
    from both extensions."""
    port_ext, ref_ext = ensure_ext(), _ref_ext()
    out = []
    for ext in (port_ext, ref_ext):
        pairs = _pairs(4)
        try:
            pairs[0][1].send(b'hello')
            pairs[2][1].close()                 # EOF on pairs[2][0]
            big = bytes(range(256)) * 40
            pairs[3][1].send(big)
            fds = [a.fileno() for a, _b in pairs]
            first = ext.drain_recv(fds, 4096)   # bufsize caps a read
            second = ext.drain_recv(fds, 65536)
            out.append((first, second))
        finally:
            for a, b in pairs:
                a.close()
                if b.fileno() >= 0:
                    b.close()
    assert out[0] == out[1]
    first, second = out[0]
    assert first[0] == b'hello' and first[2] == b''
    assert first[1] < 0 and len(first[3]) == 4096


async def test_uring_calls_match_reference(ring_exts):
    """One chained submission of sends, then of receives, through each
    extension's ring: the same results, bytes and enter counts."""
    out = []
    for ext in ring_exts:
        pairs = _pairs(4)
        ring = ext.uring_create(64)
        try:
            fds = [a.fileno() for a, _b in pairs]
            sent = ext.uring_submit(ring, fds, _chunklists())
            got = [_recv_all(b) for _a, b in pairs]
            for i, (_a, b) in enumerate(pairs):
                b.send(b'reply-%d' % i)
            recvd = ext.uring_recv(ring, fds, 4096)
            out.append((sent, got, recvd))
        finally:
            ext.uring_close(ring)
            _close(pairs)
    assert out[0] == out[1]
    assert out[0][2][0] == [b'reply-%d' % i for i in range(4)]


def test_crc32c_matches_reference_and_software():
    """The WAL checksum: the port's C call equals the reference's C
    call and the pure-Python table walk, chained over seeds too."""
    import random

    from zkstream_tpu.server.persist import software_crc32c as ref_soft
    from zkstream_tpu_torch.server.persist import software_crc32c

    port_ext, ref_ext = ensure_ext(), _ref_ext()
    rng = random.Random(6)
    assert port_ext.crc32c(b'123456789') == 0xE3069283
    for n in (0, 1, 7, 100, 4097):
        data = bytes(rng.randrange(256) for _ in range(n))
        seed = rng.randrange(1 << 32)
        want = ref_ext.crc32c(data, seed)
        assert port_ext.crc32c(data, seed) == want
        assert software_crc32c(data, seed) == ref_soft(data, seed) == want


# -- the chaos slices: the fault plane over each tier -------------------

#: The CPU tests run every plan's ``FleetIngest`` on the CPU.
run_ensemble_schedule = functools.partial(faults.run_ensemble_schedule,
                                          device='cpu')


async def test_chaos_slice_transport_batched(monkeypatch, backend):
    """Transport-tier chaos with each batched backend force-enabled:
    byte faults, resets and delays against planes that defer to the
    submission queue — invariants and the no-open-spans check hold
    (`zkstream_tpu_torch chaos --transport <be>` reruns any seed)."""
    monkeypatch.setenv('ZKSTREAM_TRANSPORT', backend)
    for seed in range(3100, 3106):
        res = await faults.run_schedule(seed)
        assert res.ok, (seed, res.violations)


async def test_chaos_slice_transport_asyncio_validator(monkeypatch):
    """The same seeds on the forced asyncio validator: a failure that
    appears in only one slice bisects to the tier."""
    monkeypatch.setenv('ZKSTREAM_TRANSPORT', 'asyncio')
    for seed in range(3100, 3106):
        res = await faults.run_schedule(seed)
        assert res.ok, (seed, res.violations)


@pytest.mark.timeout(120)
async def test_ensemble_chaos_slice_transport_batched(monkeypatch,
                                                      backend):
    """Ensemble tier with each batched backend force-enabled: member
    kills/restarts, partitions, migration, the crash-recovery image —
    invariants 1-7 and the no-open-spans check unchanged."""
    monkeypatch.setenv('ZKSTREAM_TRANSPORT', backend)
    for seed in range(3200, 3203):
        res = await run_ensemble_schedule(seed)
        assert res.ok, (seed, res.violations)

