"""The port's shared-nothing ingress (io/ingress.py; the port of
tests/test_ingress.py).

Covers the capability probe and its fallback order (env force falls
DOWN, never up — the transport-tier rule, asserted for the rx
direction too), the frame-stream parity invariant the plane hangs on
— every rx backend (the batched C drain, its pure-Python fallback,
and the single-loop validator) produces the identical per-connection
reply stream over the full request-opcode corpus, partial frames at
EVERY byte offset included — the accept-shard affinity contract (a
connection's fan-out shard IS its accept shard), the rx-direction
syscall accounting (``zookeeper_recv_syscalls_total`` /
``zookeeper_recv_drain_depth``: drain submissions are O(dirty
shards), not O(connections)), the ``ZKSTREAM_RX_BUF`` knob, the
``zk_ingress_*`` mntr rows with the per-shard census, admin words
over the sharded path and the dispatcher handoff (no-SO_REUSEPORT
fallback) — each server-facing case on the port's server and on the
JAX package's, and the port's reply streams equal to the reference's.
The chaos slices run the port's fault plane, its ensemble schedules
with their ingests on the CPU.

Whether this host runs a batched rx backend is decided in a fixture,
never at import: the C extensions may still be building while the
file is collected, and every worker must collect the same tests.
"""

from __future__ import annotations

import asyncio
import functools

import pytest

from zkstream_tpu_torch.io import faults
from zkstream_tpu_torch.io.ingress import (
    BACKENDS,
    METRIC_RECV_DRAIN_DEPTH,
    METRIC_RECV_SYSCALLS,
    backend_default,
    probe,
    resolve_backend,
    resolve_shards,
    rx_buf_default,
    shards_default,
)
from zkstream_tpu_torch.server import ZKServer
from zkstream_tpu_torch.utils.metrics import Collector

from zkstream_tpu_torch.utils.native import ensure_ext

from test_fastencode import REQUESTS
from test_torch_basic import server_cls  # noqa: F401
from test_torch_server_edges import RawClient


def _probes():
    """Both packages' ingress probes, with their extensions built."""
    from zkstream_tpu.io import ingress as ref_ingress
    from zkstream_tpu.utils.native import ensure_ext as ref_ensure_ext

    ensure_ext()
    ref_ensure_ext()
    return probe(refresh=True), ref_ingress.probe(refresh=True)


@pytest.fixture
def batched(server_cls):
    """The batched rx backend ``server_cls``'s package chose on this
    host; the case skips where there is none."""
    p = _probes()[0 if server_cls is ZKServer else 1]
    have = [b for b in ('uring', 'mmsg') if p.available(b)]
    if not have:
        pytest.skip('no batched ingress backend here (uring: %s; mmsg: '
                    '%s)' % (p.uring_reason, p.mmsg_reason))
    return have[0]


# -- probe + resolution -------------------------------------------------

def test_probe_shape_and_default():
    p = probe()
    assert p.chosen in BACKENDS
    assert p.available(p.chosen)
    assert backend_default() == p.chosen
    for b in BACKENDS:
        if b == p.chosen:
            break
        assert not p.available(b)


def test_env_force_falls_down_never_up(monkeypatch):
    monkeypatch.setenv('ZKSTREAM_INGRESS', 'asyncio')
    assert backend_default() == 'asyncio'
    monkeypatch.setenv('ZKSTREAM_INGRESS', 'mmsg')
    assert backend_default() == ('mmsg' if probe().mmsg else 'asyncio')
    monkeypatch.setenv('ZKSTREAM_INGRESS', 'uring')
    if not probe().uring:
        assert backend_default() != 'uring'   # degraded down, not up
    monkeypatch.setenv('ZKSTREAM_INGRESS', 'bogus')
    assert backend_default() == probe().chosen   # ignored


def test_resolve_backend_rejects_unknown():
    with pytest.raises(ValueError):
        resolve_backend('recvfrom')
    assert resolve_backend('asyncio') == 'asyncio'
    assert resolve_backend(None) == backend_default()


def test_shards_knob(monkeypatch):
    monkeypatch.setenv('ZKSTREAM_INGRESS_SHARDS', '3')
    assert shards_default() == 3
    assert resolve_shards(None) == 3
    assert resolve_shards(5) == 5
    monkeypatch.setenv('ZKSTREAM_INGRESS_SHARDS', 'junk')
    assert shards_default() >= 1          # CPU-count default
    with pytest.raises(ValueError):
        resolve_shards(0)


def test_rx_buf_knob(monkeypatch, server_cls):
    monkeypatch.setenv('ZKSTREAM_RX_BUF', '8192')
    assert rx_buf_default() == 8192
    srv = server_cls()
    assert srv.rx_buf == 8192
    monkeypatch.setenv('ZKSTREAM_RX_BUF', '-1')
    assert rx_buf_default() == 65536
    monkeypatch.delenv('ZKSTREAM_RX_BUF')
    assert rx_buf_default() == 65536


def test_validator_resolutions_build_no_plane(monkeypatch, server_cls):
    assert server_cls(ingress_shards=1).ingress is None
    assert server_cls(ingress_backend='asyncio').ingress is None
    monkeypatch.setenv('ZKSTREAM_INGRESS', 'asyncio')
    assert server_cls().ingress is None
    monkeypatch.delenv('ZKSTREAM_INGRESS')
    monkeypatch.setenv('ZKSTREAM_INGRESS_SHARDS', '1')
    assert server_cls().ingress is None


# -- frame-stream parity across rx backends ----------------------------

async def _scripted_ops(shards: int, server_cls, no_native: bool = False,
                        monkeypatch=None) -> list[tuple]:
    """One deterministic workload — the full request-opcode corpus
    pipelined in one burst, plus a watch arm/fire — against a server
    on the given rx configuration; returns the decoded reply stream."""
    if no_native and monkeypatch is not None:
        # ZKSTREAM_NO_NATIVE short-circuits get_ext(), forcing the
        # batch tier's pure-Python os.read fallback — the third rx
        # stream the parity claim covers.  The codec tiers fall back
        # identically on both arms, so the bytes stay comparable.
        monkeypatch.setenv('ZKSTREAM_NO_NATIVE', '1')
    srv = await server_cls(ingress_shards=shards).start()
    assert (srv.ingress is None) == (shards == 1)
    out: list[tuple] = []
    c = RawClient()
    watcher = RawClient()
    try:
        await watcher.connect(srv)
        watcher.send({'opcode': 'GET_DATA', 'path': '/n',
                      'watch': False})
        (miss,) = await watcher.recv(1)
        assert miss['err'] == 'NO_NODE'
        await c.connect(srv)
        # pipeline the whole corpus in ONE write: the drain decodes
        # a multi-frame batch exactly like the validator's read loop
        frames = b''.join(c.codec.encode(dict(p)) for p in REQUESTS)
        c.writer.write(frames)
        pkts = await c.recv(len(REQUESTS))
        for p in pkts:
            out.append((p['opcode'], p['err'], p.get('path'),
                        bytes(p.get('data') or b'')))
        # the corpus created + deleted /n; re-create it (on a fresh
        # client — the corpus ended with CLOSE_SESSION) and fire the
        # watcher's arm so the fan-out path rides the ingress tick
        watcher.send({'opcode': 'EXISTS', 'path': '/n',
                      'watch': True})
        await watcher.recv(1)
        c2 = RawClient()
        try:
            await c2.connect(srv)
            c2.send({'opcode': 'CREATE', 'path': '/n', 'data': b'w',
                     'acl': [], 'flags': 0})
            (created,) = await c2.recv(1)
            out.append((created['opcode'], created['err']))
            (notif,) = await watcher.recv(1)
            out.append((notif['opcode'], notif['type'],
                        notif['path']))
        finally:
            c2.close()
    finally:
        c.close()
        watcher.close()
        await srv.stop()
    return out


async def test_frame_stream_parity_all_opcodes(monkeypatch, server_cls,
                                               batched):
    """The invariant the plane hangs on: every rx backend produces
    the IDENTICAL reply stream over the full request corpus — the
    batched C drain, its pure-Python fallback, and the single-loop
    validator."""
    baseline = await _scripted_ops(1, server_cls)
    sharded = await _scripted_ops(4, server_cls)
    assert sharded == baseline
    fallback = await _scripted_ops(4, server_cls, no_native=True,
                                   monkeypatch=monkeypatch)
    assert fallback == baseline


async def test_reply_streams_equal_reference():
    """The port's server answers the full request corpus, sharded and
    on the validator, with the stream the JAX package's server gives."""
    from zkstream_tpu.server import ZKServer as RefServer

    if not all(p.available('uring') or p.available('mmsg')
               for p in _probes()):
        pytest.skip('no batched ingress backend here')

    for shards in (1, 4):
        assert await _scripted_ops(shards, ZKServer) \
            == await _scripted_ops(shards, RefServer)


async def test_partial_frames_at_every_byte_offset(server_cls, batched):
    """A request stream split at EVERY byte offset decodes
    identically: the drain hands the codec partial frames at
    arbitrary cuts and the accumulation must finish them on the next
    drain — the validator's contract, byte for byte."""
    srv = await server_cls(ingress_shards=2).start()
    c = RawClient()
    try:
        await c.connect(srv)
        c.send({'opcode': 'CREATE', 'path': '/p', 'data': b'v0',
                'acl': [], 'flags': 0})
        await c.recv(1)
        pkt_dict = {'xid': 99, 'opcode': 'GET_DATA', 'path': '/p',
                    'watch': False}
        nbytes = len(c.codec.encode(dict(pkt_dict)))
        c.codec.xid_map.pop(99, None)
        for cut in range(1, nbytes):
            # encode through the CLIENT's codec so its xid map knows
            # the reply; the frame bytes are identical every round
            frame = c.codec.encode(dict(pkt_dict))
            c.writer.write(frame[:cut])
            await c.writer.drain()
            await asyncio.sleep(0)      # a drain sees the partial
            c.writer.write(frame[cut:])
            (pkt,) = await c.recv(1)
            assert pkt['opcode'] == 'GET_DATA'
            assert pkt['err'] == 'OK'
            assert bytes(pkt['data']) == b'v0'
    finally:
        c.close()
        await srv.stop()


# -- shard affinity + census -------------------------------------------

async def test_accept_shard_is_fanout_shard(server_cls, batched):
    """The affinity contract: a connection's watch fan-out shard IS
    its accept shard, so its arms, fan-out buffer and cork all live
    with the shard that drains it — and the watch table sized itself
    from the ingress plane."""
    srv = await server_cls(ingress_shards=4).start()
    clients = [RawClient() for _ in range(8)]
    try:
        for c in clients:
            await c.connect(srv)
        assert srv.watch_table.nshards == 4
        census = srv.ingress.shard_census()
        assert sum(census) == len(srv.conns) == 8
        for conn in srv.conns:
            assert conn._ingress_shard is not None
            assert conn._fanout_shard == conn._ingress_shard
    finally:
        for c in clients:
            c.close()
        await srv.stop()


async def test_dispatcher_handoff_round_robins(server_cls, batched):
    """The no-SO_REUSEPORT fallback: one listener, accepted sockets
    handed round-robin across the shards — every shard still drains
    its own connections."""
    srv = server_cls(ingress_shards=4)
    srv.ingress.reuseport = False      # force the dispatcher path
    await srv.start()
    clients = [RawClient() for _ in range(8)]
    try:
        for c in clients:
            await c.connect(srv)
        census = srv.ingress.shard_census()
        assert census == [2, 2, 2, 2]      # strict round-robin
        c = clients[0]
        c.send({'opcode': 'CREATE', 'path': '/rr', 'data': b'x',
                'acl': [], 'flags': 0})
        (pkt,) = await c.recv(1)
        assert pkt['err'] == 'OK'
    finally:
        for c in clients:
            c.close()
        await srv.stop()


# -- rx syscall accounting ---------------------------------------------

async def test_drain_submissions_scale_with_shards_not_conns(server_cls,
                                                            batched):
    """The tentpole's number: a tick that dirties N connections on
    one shard costs ONE drain submission covering all of them —
    O(dirty shards), not O(connections) — with the depth histogram
    carrying the batch width."""
    col = Collector()
    # dispatcher mode: deterministic round-robin shard assignment,
    # so the drain batch widths are predictable
    srv = server_cls(ingress_shards=2, collector=col)
    srv.ingress.reuseport = False
    await srv.start()
    n = 6
    clients = [RawClient() for _ in range(n)]
    try:
        for c in clients:
            await c.connect(srv)
        drains_before = srv.ingress.drains
        # all six write in the same tick: the shard drains them in
        # one submission each (two shards -> at most 2 per tick)
        for c in clients:
            c.send({'opcode': 'EXISTS', 'path': '/none',
                    'watch': False})
        for c in clients:
            await c.recv(1)
        drained = srv.ingress.drains - drains_before
        assert drained >= 1
        dep = col.get_collector(METRIC_RECV_DRAIN_DEPTH)
        labels = {'plane': 'server',
                  'backend': srv.ingress.backend}
        assert dep.count(labels) >= 1
        # at least one drain covered multiple connections
        assert dep.sum(labels) >= dep.count(labels)
        ctr = col.get_collector(METRIC_RECV_SYSCALLS)
        assert ctr.value(labels) > 0
    finally:
        for c in clients:
            c.close()
        await srv.stop()


async def test_validator_counts_reads_as_recv_syscalls(server_cls):
    col = Collector()
    srv = await server_cls(ingress_shards=1, collector=col).start()
    c = RawClient()
    try:
        await c.connect(srv)
        c.send({'opcode': 'EXISTS', 'path': '/x', 'watch': False})
        await c.recv(1)
    finally:
        c.close()
        await srv.stop()
    ctr = col.get_collector(METRIC_RECV_SYSCALLS)
    assert ctr.value({'plane': 'server', 'backend': 'asyncio'}) > 0


# -- mntr rows + admin words -------------------------------------------

def test_mntr_reports_ingress_configuration(server_cls, batched):
    srv = server_cls(ingress_shards=1)
    rows = dict(srv.monitor_stats())
    assert rows['zk_ingress_shards'] == 1
    assert rows['zk_ingress_backend'] == 'asyncio'
    srv2 = server_cls(ingress_shards=3)
    rows2 = dict(srv2.monitor_stats())
    assert rows2['zk_ingress_shards'] == 3
    assert rows2['zk_ingress_backend'] == batched
    assert rows2['zk_ingress_shard_conns{shard="2"}'] == 0


async def test_admin_words_over_sharded_ingress(server_cls, batched):
    """Four-letter words arrive raw as the first bytes and must ride
    the drain path exactly as the validator's read loop served them."""
    srv = await server_cls(ingress_shards=4).start()
    try:
        for word, probe_text in (('ruok', 'imok'),
                                 ('mntr', 'zk_ingress_shards'),
                                 ('srvr', 'Zookeeper version'),
                                 ('stat', 'Clients:')):
            reader, writer = await asyncio.open_connection(
                '127.0.0.1', srv.port)
            writer.write(word.encode('ascii'))
            text = (await reader.read()).decode()
            assert probe_text in text, (word, text)
            writer.close()
    finally:
        await srv.stop()


async def test_stop_restart_keeps_port_and_serves(server_cls, batched):
    srv = await server_cls(ingress_shards=2).start()
    port = srv.port
    c = RawClient()
    try:
        await c.connect(srv)
        await srv.stop()
        await srv.restart()
        assert srv.port == port
        c2 = RawClient()
        await c2.connect(srv)
        c2.send({'opcode': 'EXISTS', 'path': '/gone', 'watch': False})
        (pkt,) = await c2.recv(1)
        assert pkt['err'] == 'NO_NODE'
        c2.close()
    finally:
        c.close()
        await srv.stop()


async def test_uring_recv_roundtrip():
    """Where io_uring exists (>= 5.1 kernel): one enter syscall
    drains a whole batch across distinct sockets."""
    import socket

    p = _probes()[0]
    if not p.uring:
        pytest.skip('io_uring recv unavailable: %s' % (p.uring_reason,))
    ext = ensure_ext()
    assert ext is not None
    pairs = [socket.socketpair() for _ in range(4)]
    try:
        ring = ext.uring_create(64)
        for i, (_a, b) in enumerate(pairs):
            b.send(b'frame-%d' % i)
        fds = [a.fileno() for a, _b in pairs]
        results, enters = ext.uring_recv(ring, fds, 65536)
        assert enters == 1
        assert results == [b'frame-%d' % i for i in range(4)]
        ext.uring_close(ring)
    finally:
        for a, b in pairs:
            a.close()
            b.close()


# -- the chaos slices: the fault plane over the port's receive path -----

#: The CPU tests run every plan's ``FleetIngest`` on the CPU.
run_ensemble_schedule = functools.partial(faults.run_ensemble_schedule,
                                          device='cpu')


@pytest.fixture
def port_batched():
    """The batched rx backend the port chose on this host; the case
    skips where there is none."""
    p = _probes()[0]
    if not (p.available('uring') or p.available('mmsg')):
        pytest.skip('no batched ingress backend here (uring: %s; mmsg: '
                    '%s)' % (p.uring_reason, p.mmsg_reason))


async def test_chaos_slice_ingress_sharded(monkeypatch, port_batched):
    """Transport-tier chaos with the sharded ingress force-enabled
    (`zkstream_tpu_torch chaos --ingress-shards 4` reruns any seed):
    byte faults — the server_rx split/delay/reset stream included —
    against servers whose receive path is the batched drain."""
    monkeypatch.setenv('ZKSTREAM_INGRESS_SHARDS', '4')
    for seed in range(3300, 3306):
        res = await faults.run_schedule(seed)
        assert res.ok, (seed, res.violations)


async def test_chaos_slice_ingress_validator(monkeypatch):
    """The same seeds on the forced shards=1 validator: a failure
    appearing in only one slice bisects to the ingress plane."""
    monkeypatch.setenv('ZKSTREAM_INGRESS_SHARDS', '1')
    for seed in range(3300, 3306):
        res = await faults.run_schedule(seed)
        assert res.ok, (seed, res.violations)


@pytest.mark.timeout(120)
async def test_ensemble_chaos_slice_ingress_sharded(monkeypatch,
                                                    port_batched):
    """Ensemble tier with sharded ingress force-enabled: member
    kills/restarts, partitions, elections, the crash-recovery image —
    invariants 1-7 and the no-open-spans check unchanged."""
    monkeypatch.setenv('ZKSTREAM_INGRESS_SHARDS', '4')
    for seed in range(3400, 3403):
        res = await run_ensemble_schedule(seed)
        assert res.ok, (seed, res.violations)


@pytest.mark.timeout(120)
async def test_ensemble_chaos_slice_ingress_validator(monkeypatch):
    monkeypatch.setenv('ZKSTREAM_INGRESS_SHARDS', '1')
    for seed in range(3400, 3403):
        res = await run_ensemble_schedule(seed)
        assert res.ok, (seed, res.violations)

