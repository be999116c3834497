"""The port's outbound plane: tick-corked write coalescing
(io/sendplane.py; the port of tests/test_sendplane.py).

Covers the SendPlane contract in isolation (one flush per busy tick,
size-capped early flush, ordering under flush_now, write-through when
disabled), the wire-equivalence invariant (the coalesced stream is
byte-identical to the uncoalesced concatenation for every opcode), the
end-to-end client/server path with cork on and off (on the port's
server and on the JAX package's), and the flush-batch histograms.  The
chaos slice runs the port's fault plane."""

from __future__ import annotations

import asyncio

from zkstream_tpu_torch import Client
from zkstream_tpu_torch.io.faults import run_schedule
from zkstream_tpu_torch.io.sendplane import (
    METRIC_FLUSH_BYTES,
    METRIC_FLUSH_FRAMES,
    SendPlane,
)
from zkstream_tpu_torch.protocol.framing import PacketCodec
from zkstream_tpu_torch.server import ZKServer
from zkstream_tpu_torch.utils.metrics import Collector

from test_fastencode import REPLIES, REQUESTS
from test_torch_basic import server_cls  # noqa: F401


async def test_one_flush_per_tick():
    writes: list[bytes] = []
    plane = SendPlane(writes.append, enabled=True)
    plane.send(b'aaa')
    plane.send(b'bb')
    plane.send(b'c')
    assert writes == []          # corked until the tick boundary
    assert plane.pending == 6
    await asyncio.sleep(0)
    assert writes == [b'aaabbc']  # ONE joined write
    assert plane.pending == 0
    # a later tick corks independently
    plane.send(b'dd')
    await asyncio.sleep(0)
    assert writes == [b'aaabbc', b'dd']


async def test_size_capped_early_flush():
    writes: list[bytes] = []
    plane = SendPlane(writes.append, enabled=True, max_bytes=8)
    plane.send(b'aaaa')
    assert writes == []
    plane.send(b'bbbb')          # hits the cap: flush immediately
    assert writes == [b'aaaabbbb']
    plane.send(b'c')
    await asyncio.sleep(0)       # the stale scheduled flush is a no-op
    assert writes == [b'aaaabbbb', b'c']


async def test_flush_now_orders_ahead_of_tick():
    writes: list[bytes] = []
    plane = SendPlane(writes.append, enabled=True)
    plane.send(b'a')
    plane.flush_now()
    writes.append(b'-injected-')  # e.g. a fault gate delivering
    plane.send(b'b')
    await asyncio.sleep(0)
    assert writes == [b'a', b'-injected-', b'b']


async def test_disabled_writes_through():
    writes: list[bytes] = []
    plane = SendPlane(writes.append, enabled=False)
    plane.send(b'a')
    plane.send(b'b')
    assert writes == [b'a', b'b']
    assert plane.pending == 0


async def test_reset_drops_corked_frames():
    writes: list[bytes] = []
    plane = SendPlane(writes.append, enabled=True)
    plane.send(b'doomed')
    plane.reset()
    plane.flush_now()
    await asyncio.sleep(0)
    assert writes == []


async def test_coalesced_stream_byte_identity_all_opcodes():
    """The invariant the whole design hangs on: corked or not, the
    byte stream is the concatenation of the per-frame encodes — for
    every opcode, in both directions."""
    for server, corpus in ((True, REPLIES), (False, REQUESTS)):
        enc = PacketCodec(server=server, use_native=False)
        enc.handshaking = False
        frames = [enc.encode(dict(p)) for p in corpus]

        writes: list[bytes] = []
        plane = SendPlane(writes.append, enabled=True)
        for f in frames[:len(frames) // 2]:
            plane.send(f)
        plane.flush_now()            # mid-stream explicit flush
        for f in frames[len(frames) // 2:]:
            plane.send(f)
        await asyncio.sleep(0)
        assert b''.join(writes) == b''.join(frames)
        assert len(writes) == 2      # two flushes, not N writes


async def test_flush_histograms_record_batches():
    col = Collector()
    plane = SendPlane(lambda d: None, enabled=True, collector=col,
                      plane='client')
    for _ in range(3):
        plane.send(b'x' * 10)
    plane.flush_now()
    fr = col.get_collector(METRIC_FLUSH_FRAMES)
    by = col.get_collector(METRIC_FLUSH_BYTES)
    assert fr.count({'plane': 'client'}) == 1
    assert fr.sum({'plane': 'client'}) == 3.0
    assert by.sum({'plane': 'client'}) == 30.0
    scrape = col.expose()
    assert 'zookeeper_flush_batch_frames_bucket' in scrape


async def _ops_roundtrip(cork: bool, server_cls):
    col = Collector()
    srv = await server_cls(cork=cork, collector=col).start()
    client = Client(address='127.0.0.1', port=srv.port,
                    session_timeout=8000, cork=cork, collector=col)
    client.start()
    try:
        await client.wait_connected(timeout=10)
        await client.create('/n', b'v1')
        got, stat = await client.get('/n')
        assert got == b'v1'
        st = await client.set('/n', b'v2')
        assert st.version == stat.version + 1
        # pipelined burst: many ops in flight in one tick exercises
        # multi-frame coalescing on both planes
        await asyncio.gather(*[client.get('/n') for _ in range(16)])
        await client.delete('/n', -1)
    finally:
        await client.close()
        await srv.stop()
    return col


async def test_e2e_cork_enabled_and_disabled(server_cls):
    col_on = await _ops_roundtrip(cork=True, server_cls=server_cls)
    fr = col_on.get_collector(METRIC_FLUSH_FRAMES)
    assert fr.count({'plane': 'client'}) > 0
    assert fr.count({'plane': 'server'}) > 0
    # the pipelined burst must actually coalesce somewhere: at least
    # one flush on some plane carried more than one frame
    multi = sum(fr.sum({'plane': p}) - fr.count({'plane': p})
                for p in ('client', 'server'))
    assert multi > 0, 'no flush ever carried >1 frame'
    col_off = await _ops_roundtrip(cork=False, server_cls=server_cls)
    fr = col_off.get_collector(METRIC_FLUSH_FRAMES)
    # write-through still records (per-frame) batches of exactly 1
    assert fr.count({'plane': 'client'}) > 0
    assert fr.sum({'plane': 'client'}) == fr.count({'plane': 'client'})


# -- the early-flush cap knob (ZKSTREAM_FLUSH_CAP / flush_cap=) --------

async def test_flush_cap_env_default(monkeypatch):
    from zkstream_tpu_torch.io.sendplane import (
        DEFAULT_MAX_CORK,
        flush_cap_default,
    )
    monkeypatch.delenv('ZKSTREAM_FLUSH_CAP', raising=False)
    assert flush_cap_default() == DEFAULT_MAX_CORK
    monkeypatch.setenv('ZKSTREAM_FLUSH_CAP', '1024')
    assert flush_cap_default() == 1024
    plane = SendPlane(lambda d: None, enabled=True)
    assert plane.max_bytes == 1024          # resolved at construction
    for junk in ('nope', '-5', '0'):
        monkeypatch.setenv('ZKSTREAM_FLUSH_CAP', junk)
        assert flush_cap_default() == DEFAULT_MAX_CORK


async def test_flush_cap_knobs_reach_both_planes():
    """Client(flush_cap=) and ZKServer(flush_cap=) resize the per-
    connection planes (the 256 KiB constant was the only option
    before)."""
    from zkstream_tpu_torch.io.connection import Backend, ZKConnection
    from zkstream_tpu_torch.server.server import ServerConnection

    srv = ZKServer(flush_cap=123)

    class _W:            # writer stub: the plane only needs .write
        transport = None

        def write(self, data):
            pass
    conn = ServerConnection(srv, reader=None, writer=_W())
    assert conn._tx.max_bytes == 123

    client = Client(address='127.0.0.1', port=1, flush_cap=77)
    zc = ZKConnection(client, Backend('127.0.0.1', 1))
    assert zc._tx.max_bytes == 77


async def test_flush_cap_honored_per_backend():
    """A burst over the cap leaves the plane immediately on EVERY
    backend: the legacy path writes it, a batched tier takes it into
    the tick submission — the plane never holds more than the cap."""
    from zkstream_tpu_torch.io.transport import probe

    # asyncio (no tier): early flush reaches the sink synchronously
    writes: list[bytes] = []
    plane = SendPlane(writes.append, enabled=True, max_bytes=8)
    plane.send(b'aaaa')
    plane.send(b'bbbb')
    assert writes == [b'aaaabbbb'] and plane.pending == 0

    batched = [b for b in ('uring', 'mmsg') if probe().available(b)]
    if not batched:
        return
    import socket

    from zkstream_tpu_torch.io.transport import TransportTier
    left, right = socket.socketpair()
    left.setblocking(False)
    right.setblocking(False)
    loop = asyncio.get_running_loop()
    transport, _ = await loop.create_connection(asyncio.Protocol,
                                                sock=left)
    try:
        tier = TransportTier(batched[0])
        plane = SendPlane(transport.write, enabled=True, max_bytes=8,
                          tier=tier, transport_fn=lambda: transport)
        plane.send(b'aaaa')
        assert plane.pending == 4
        plane.send(b'bbbb')              # cap hit: plane hands off now
        assert plane.pending == 0
        await asyncio.sleep(0)           # the tick submission
        data = b''
        while len(data) < 8:
            try:
                data += right.recv(64)
            except BlockingIOError:
                await asyncio.sleep(0)
        assert data == b'aaaabbbb'
    finally:
        transport.close()
        right.close()


async def test_chaos_slice_cork_disabled(monkeypatch):
    """A short seeded slice with coalescing force-disabled: schedule
    outcomes stay invariant-clean either way (the tier-1 campaigns run
    the same seeds with the default cork enabled)."""
    monkeypatch.setenv('ZKSTREAM_NO_CORK', '1')
    for seed in range(140, 146):
        res = await run_schedule(seed)
        assert res.ok, (seed, res.violations)
