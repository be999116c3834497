"""The port's FleetIngest against the reference's.

First, behind the reference ``Client`` + ``ZKServer`` over real TCP:
the port's ingest (``device='cpu'``) must give the same observations
as the scalar drain, over the full op surface and a watcher sequence
(the ``_workload`` of tests/test_ingest.py).

Second, with stand-in connections (the three things the ingest needs
of a connection: ``codec``, ``is_in_state``, ``emit``): the same
chunks fed through the JAX ``FleetIngest`` and the port's must deliver
equal packets, equal to a fresh scalar codec's decode, and the same
error on a bad length prefix — across re-ticks past ``max_frames`` and
a background warm.
"""

import asyncio
import struct

import numpy as np
import pytest

from test_ingest import _workload, make_client
from zkstream_tpu.io.ingest import FleetIngest as RefIngest
from zkstream_tpu.protocol.framing import PacketCodec as RefCodec
from zkstream_tpu.server import ZKServer
from zkstream_tpu_torch import corpus
from zkstream_tpu_torch.io.ingest import FleetIngest
from zkstream_tpu_torch.protocol.framing import PacketCodec


def _norm(x):
    """Observations with ACL/Id records as plain tuples: the two
    packages' record classes are distinct types with equal fields."""
    if hasattr(x, 'perms') and hasattr(x, 'id'):
        return ('ACL', int(x.perms), x.id.scheme, x.id.id)
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not hasattr(x, '_fields'):
        return type(x)(_norm(v) for v in x)
    return x


async def _run_mode(ingest):
    srv = await ZKServer().start()
    if ingest is not None:
        await ingest.prewarm(1)
    c = make_client(srv.port, ingest=ingest)
    try:
        await c.wait_connected(timeout=5)
        if ingest is not None:
            assert c.current_connection().ingest is ingest
        return _norm(await _workload(c))
    finally:
        await c.close()
        await srv.stop()


async def test_port_ingest_matches_scalar_drain():
    scalar = await _run_mode(None)
    ing = FleetIngest(device='cpu', max_frames=8, min_len=256,
                      bypass_bytes=0, warm='block')
    got = await _run_mode(ing)
    assert got == scalar
    assert ing.ticks > 0 and ing.frames_routed > 0


class _StandIn:
    """A connection as the ingest sees it."""

    def __init__(self, codec):
        self.codec = codec
        self.got: list = []
        self.err = None

    def is_in_state(self, state):
        return state == 'connected' and self.err is None

    def emit(self, event, pkts, err):
        assert event == 'ingestDeliver'
        self.got.extend(pkts)
        if err is not None:
            self.err = err


def _streams(seed):
    """Corpus streams plus one with a bad length prefix after two
    good frames."""
    buf, _lens, slots, maps = corpus.fleet(B=12, seed=seed, frames=16)
    streams = [r.tobytes() for r in buf]
    first_two = slots[2]['off']
    streams.append(streams[0][:first_two] + struct.pack('>i', -7) + b'xx')
    maps.append({x: op for x, op in maps[0].items()})
    return streams, maps


def _chunks(stream, rng):
    a, b = sorted(rng.randint(0, len(stream) + 1, 2).tolist())
    return [stream[:a], stream[a:b], stream[b:]]


def _codec(cls, xid_map, **kw):
    c = cls(**kw)
    c.handshaking = False
    c.xid_map.update(xid_map)
    return c


def _expected(chunks, maps):
    """What the per-socket scalar drain delivers: each chunk decoded as
    it arrives, until the first error (a bad prefix drops the frames
    completed in its own chunk, as the scalar codec does)."""
    out = []
    for ch, m in zip(chunks, maps):
        codec = _codec(PacketCodec, m)
        pkts, code = [], None
        for piece in ch:
            try:
                pkts += codec.decode(piece)
            except Exception as e:
                pkts += getattr(e, 'packets', [])
                code = e.code
                break
        out.append((_norm(pkts), code))
    return out


async def _drive(ingest, conns, chunks, timeout=30.0):
    """Feed every connection its chunks, one round per loop cycle, and
    run the loop until every slot has drained."""
    for k in range(3):
        for conn, ch in zip(conns, chunks):
            if ch[k]:
                ingest.feed(conn, ch[k])
        await asyncio.sleep(0)
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while ingest._scheduled or any(buf for _c, buf in
                                   ingest._slots.values()):
        assert loop.time() < deadline, 'ingest did not drain'
        await asyncio.sleep(0.001)


def _cut(streams, seed):
    rng = np.random.RandomState(seed)
    return [_chunks(s, rng) for s in streams]


async def _serve(ingest, codec_cls, chunks, maps, **codec_kw):
    conns = [_StandIn(_codec(codec_cls, m, **codec_kw)) for m in maps]
    for c in conns:
        ingest.register(c)
    await _drive(ingest, conns, chunks)
    return [(_norm(c.got), getattr(c.err, 'code', None)) for c in conns]


@pytest.mark.parametrize('max_frames', [4, 64])
@pytest.mark.parametrize('seed', [0, 1])
async def test_port_and_jax_ingest_deliver_equal_packets(seed, max_frames):
    streams, maps = _streams(seed)
    chunks = _cut(streams, seed)
    want = _expected(chunks, maps)
    assert want[-1][1] == 'BAD_LENGTH'

    port = FleetIngest(device='cpu', max_frames=max_frames,
                       bypass_bytes=0, warm='block')
    got = await _serve(port, PacketCodec, chunks, maps)
    ref = RefIngest(body_mode='host', max_frames=max_frames,
                    bypass_bytes=0, warm='block', placement='host')
    ref_got = await _serve(ref, RefCodec, chunks, maps,
                           use_native=False)
    assert got == want
    assert ref_got == want
    assert port.ticks > 0 and port.ticks_scalar == 0
    if max_frames == 4:          # 16 frames a stream: re-ticks needed
        assert port.ticks >= 4


async def test_port_ingest_background_warm():
    """Under warm='background' ticks whose bucket is still warming
    drain through the scalar codec; the result is the same."""
    streams, maps = _streams(3)
    chunks = _cut(streams, 3)
    ing = FleetIngest(device='cpu', max_frames=8, bypass_bytes=0)
    assert ing.warm == 'background'
    try:
        got = await _serve(ing, PacketCodec, chunks, maps)
        assert got == _expected(chunks, maps)
        assert ing.ticks_warming > 0
        await ing.prewarm(len(streams), 4096)
        before = ing.ticks
        more, more_maps = _streams(4)
        chunks = _cut(more, 4)
        got = await _serve(ing, PacketCodec, chunks, more_maps)
        assert got == _expected(chunks, more_maps)
        assert ing.ticks > before
    finally:
        ing.close()


def test_body_mode_device_not_ported():
    with pytest.raises(NotImplementedError, match='later slice'):
        FleetIngest(device='cpu', body_mode='device')
