"""The port's FleetIngest against the reference's.

First, behind the reference ``Client`` + ``ZKServer`` over real TCP:
the port's ingest (``device='cpu'``) must give the same observations
as the scalar drain, over the full op surface and a watcher sequence
(the ``_workload`` of tests/test_ingest.py), in both body modes.

Second, with stand-in connections (the three things the ingest needs
of a connection: ``codec``, ``is_in_state``, ``emit``): the same
chunks fed through the JAX ``FleetIngest`` and the port's must deliver
equal packets, equal to a fresh scalar codec's decode, and the same
error on a bad length prefix — across re-ticks past ``max_frames`` and
a background warm; in device-body mode also the same
``body_fallbacks``.

Third, the device-body tick itself: the port's packed ``(ints,
bytes)`` equal the JAX tick program's on the same zero-padded batch,
also when the port's staging bucket still holds a longer tick's bytes.
"""

import asyncio
import random
import struct

import numpy as np
import pytest
import torch

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



# -- body_mode='device' --

async def test_port_device_ingest_matches_scalar_drain():
    scalar = await _run_mode(None)
    ing = FleetIngest(device='cpu', body_mode='device', max_frames=8,
                      min_len=1024, bypass_bytes=0, max_data=128,
                      max_path=64, warm='block')
    got = await _run_mode(ing)
    assert got == scalar
    assert ing.ticks > 0 and ing.frames_routed > 0


async def test_port_device_ingest_fallbacks():
    """Oversized data fields and list-shaped bodies take the scalar
    fallback inside the device body mode, transparently."""
    ing = FleetIngest(device='cpu', body_mode='device', max_frames=8,
                      bypass_bytes=0, max_data=8, max_path=8,
                      min_len=1024, warm='block')
    srv = await ZKServer().start()
    await ing.prewarm(1)
    c = make_client(srv.port, ingest=ing)
    try:
        await c.wait_connected(timeout=5)
        await c.create('/big', b'x' * 500)       # data >> max_data
        data, _stat = await c.get('/big')
        assert data == b'x' * 500
        path = await c.create('/deep-name-longer-than-eight', b'')
        assert path == '/deep-name-longer-than-eight'
        children, _stat = await c.list('/')
        assert sorted(children) == ['big', 'deep-name-longer-than-eight']
        acl = await c.get_acl('/big')
        assert acl and acl[0].id.scheme == 'world'
        assert ing.ticks > 0 and ing.body_fallbacks > 0
    finally:
        await c.close()
        await srv.stop()


async def test_port_device_ingest_list_bodies():
    """Within the static bounds, children and ACL list replies assemble
    from the tensor planes (no scalar fallback); beyond the bounds they
    fall back per frame, with the same result."""
    ing = FleetIngest(device='cpu', body_mode='device', max_frames=8,
                      bypass_bytes=0, warm='block', min_len=1024,
                      max_children=8, max_name=16)
    srv = await ZKServer().start()
    await ing.prewarm(1)
    c = make_client(srv.port, ingest=ing)
    try:
        await c.wait_connected(timeout=5)
        for i in range(5):
            await c.create('/n%d' % i, b'')
        before = ing.body_fallbacks
        children, stat = await c.list('/')
        assert sorted(children) == ['n%d' % i for i in range(5)]
        assert stat.numChildren == 5
        acl = await c.get_acl('/n0')
        assert acl and acl[0].id.scheme == 'world' \
            and acl[0].id.id == 'anyone'
        assert ing.body_fallbacks == before      # device-served
        for i in range(5, 10):
            await c.create('/n%d' % i, b'')
        children, _stat = await c.list('/')
        assert len(children) == 10
        assert ing.body_fallbacks > before
    finally:
        await c.close()
        await srv.stop()


async def test_port_device_oversized_getdata_falls_back_per_frame():
    """A data field wider than the plane falls back to the scalar
    reader for that frame only (counted once, as the JAX ingest counts
    it); the frame beside it comes from the device planes."""
    from zkstream_tpu_torch.protocol.framing import frame
    from zkstream_tpu_torch.protocol.jute import JuteWriter
    from zkstream_tpu_torch.protocol.records import Stat, write_response

    def reply(xid, data):
        w = JuteWriter()
        write_response(w, {'xid': xid, 'zxid': 7, 'err': 'OK',
                           'opcode': 'GET_DATA', 'data': data,
                           'stat': Stat(czxid=1, mzxid=2, pzxid=3)})
        return frame(w.to_bytes())

    ing = FleetIngest(device='cpu', body_mode='device', max_data=8,
                      max_path=16, max_frames=2, bypass_bytes=0,
                      warm='block')
    conn = _StandIn(_codec(PacketCodec, {5: 'GET_DATA', 6: 'GET_DATA'}))
    ing.register(conn)
    ing.feed(conn, reply(5, b'x' * 32) + reply(6, b'ok'))
    await asyncio.sleep(0)
    await asyncio.sleep(0)
    assert conn.err is None
    assert [p['data'] for p in conn.got] == [b'x' * 32, b'ok']
    assert ing.body_fallbacks == 1


def test_device_mode_needs_word_aligned_max_data():
    with pytest.raises(ValueError, match='multiple of 4'):
        FleetIngest(device='cpu', body_mode='device', max_data=30)
    with pytest.raises(ValueError, match='body_mode'):
        FleetIngest(device='cpu', body_mode='tensor')


#: One device-body configuration for the stand-in and packing tests, so
#: every test shares one JAX compile: 16 frames a tick, one (16, 4096)
#: shape bucket, widths that some of the lists and payloads exceed.
_DEV = dict(max_frames=16, min_len=4096, max_data=64, max_path=32,
            max_children=6, max_name=12, max_acls=2, max_scheme=8,
            max_id=32)
_DEV_KEY = (16, 4096)


@pytest.fixture(scope='module')
def ref_device():
    """A JAX device-body ingest with the bucket compiled once; tests
    take fresh instances sharing its compiled executables."""
    ref = RefIngest(body_mode='device', bypass_bytes=0, warm='block',
                    placement='host', **_DEV)
    ref._compile_or_latch((True,) + _DEV_KEY)

    def fresh():
        ing = RefIngest(body_mode='device', bypass_bytes=0, warm='block',
                        placement='host', **_DEV)
        ing._exec = ref._exec
        return ing
    fresh.exec = ref._exec[(True,) + _DEV_KEY]
    return fresh


def _device_fleet(seed, n_streams=13, frames=12):
    """Reply streams mixing every body layout the device mode parses
    (the random packets of tests/test_replies.py), some beyond
    ``_DEV``'s widths, plus the bad-prefix stream."""
    from test_replies import _frame, _rand_list_packet, _rand_packet

    rng = random.Random(seed)
    streams, maps = [], []
    for _b in range(n_streams - 1):
        raw, xm = b'', {}
        for f in range(frames):
            make = _rand_list_packet if rng.random() < 0.3 else _rand_packet
            pkt, op = make(rng, f + 1)
            if op is not None:
                xm[pkt['xid']] = op
            raw += _frame(pkt)
        assert len(raw) <= _DEV['min_len']
        streams.append(raw)
        maps.append(xm)
    first = 4 + struct.unpack('>i', streams[0][:4])[0]
    streams.append(streams[0][:first] + struct.pack('>i', -7) + b'xx')
    maps.append(dict(maps[0]))
    return streams, maps


@pytest.mark.parametrize('seed', [0, 1])
async def test_device_ingest_matches_jax_and_scalar(ref_device, seed):
    streams, maps = _device_fleet(seed)
    chunks = _cut(streams, seed)
    want = _expected(chunks, maps)
    port = FleetIngest(device='cpu', body_mode='device', bypass_bytes=0,
                       warm='block', **_DEV)
    got = await _serve(port, PacketCodec, chunks, maps)
    ref = ref_device()
    ref_got = await _serve(ref, RefCodec, chunks, maps, use_native=False)
    assert got == want
    assert ref_got == want
    assert want[-1][1] == 'BAD_LENGTH'
    assert port.ticks > 0 and port.ticks_scalar == 0
    assert port.body_fallbacks == ref.body_fallbacks > 0
    assert list(port._exec) == [_DEV_KEY]


def _batch(rows, Bp=16, L=4096):
    """Zero-padded ``[Bp, L]`` batch of byte strings, as the JAX tick
    stages it."""
    buf = np.zeros((Bp, L), np.uint8)
    lens = np.zeros((Bp,), np.int32)
    for i, r in enumerate(rows):
        buf[i, :len(r)] = np.frombuffer(r, np.uint8)
        lens[i] = len(r)
    return buf, lens


def _tick_rows(name):
    if name == 'mixed':
        return _device_fleet(3)[0]
    if name == 'corpus':
        buf, _lens, _s, _m = corpus.fleet(B=12, seed=2, frames=16)
        return [r.tobytes() for r in buf]
    if name == 'getdata':
        buf, lens = corpus.getdata_fleet(4, 16, 1024, 64)
        return [r[:n].tobytes() for r, n in zip(buf, lens)]
    buf, lens = corpus.adversarial(2, B=16, L=1024)
    return [r[:max(n, 0)].tobytes() for r, n in zip(buf, lens)]


def _assert_packed_equal(want, got):
    w_ints, w_bytes = (np.asarray(x) for x in want)
    g_ints, g_bytes = got
    assert w_ints.shape == g_ints.shape and w_bytes.shape == g_bytes.shape
    assert w_ints.dtype == g_ints.dtype and w_bytes.dtype == g_bytes.dtype
    np.testing.assert_array_equal(w_ints, g_ints)
    np.testing.assert_array_equal(w_bytes, g_bytes)


@pytest.mark.parametrize('name', ['mixed', 'corpus', 'getdata',
                                  'adversarial'])
def test_device_tick_packs_like_jax(ref_device, name):
    """The port's device-body tick (K2's plain version, the torch body
    parse, the pack) gives the JAX tick program's packed arrays."""
    buf, lens = _batch(_tick_rows(name))
    ing = FleetIngest(device='cpu', body_mode='device', **_DEV)
    got = ing._step(torch.from_numpy(buf), torch.from_numpy(lens))
    _assert_packed_equal(ref_device.exec(buf, lens),
                         tuple(x.numpy() for x in got))


def test_short_tick_after_long_tick_in_one_bucket(ref_device):
    """The port reuses a bucket's staging rows without zeroing them: a
    short tick after a long one reads stale bytes past its rows'
    lengths wherever the body parse reads speculatively.  Its packed
    result must still equal the JAX tick's on a zero-filled batch."""
    ing = FleetIngest(device='cpu', body_mode='device', **_DEV)
    bk = ing._warm_bucket(_DEV_KEY)
    long_rows = [b'\xab' * 8 + r for r in _tick_rows('corpus')]
    long_rows += _tick_rows('mixed')[:4]
    ing._run_step(bk, [(None, bytearray(r)) for r in long_rows])
    short = _tick_rows('getdata')[:9]
    # cut each row inside its last frame's body: the parse then reads
    # past the row's length into the long tick's bytes
    short = [r[:max(len(r) - 30, 0)] for r in short]
    got = ing._run_step(bk, [(None, bytearray(r)) for r in short])
    tail = [bk.buf_np[i, len(r):].any() for i, r in enumerate(short)]
    assert all(tail) and bk.buf_np[len(short):].any()
    buf, lens = _batch(short)
    _assert_packed_equal(ref_device.exec(buf, lens), got)
