"""FleetIngest failure-path coverage of the port: the port of
tests/test_ingest_failures.py.  The code that only runs when things go
wrong — the warm-failure latch, loop-closed-mid-warm, torn-down-mid-tick
connections, unmatched xids, unsupported reply opcodes — driven through
lightweight fake connections so each path is hit deterministically,
with asserts on observable behavior (what got delivered / counted), not
line touches.

Where a case's outcome is observed behaviour, the same case also runs
on the JAX package's ``FleetIngest`` (``placement='host'``) with its own
codec, and both must deliver the same packets and errors and count the
same ticks.  The port's ingests run with ``device='cpu'`` (the plain
versions).

Left out of the reference file:
- ``test_placement_host_pins_cpu_and_accelerator_skips``,
  ``test_placement_survives_missing_cpu_backend``,
  ``test_placement_auto_probes_and_falls_back``: the JAX ingest's
  placement probe, which the port replaces with ``device=``
  (tests/test_torch_imports.py holds its default and its raise);
- ``test_ext_slice_failure_wraps_as_bad_decode``: its port copy is
  tests/test_torch_ingest.py::test_ext_slice_failure_wraps_as_bad_decode.
"""

from __future__ import annotations

import asyncio
import struct
import threading
import types

import pytest

from zkstream_tpu.io.ingest import FleetIngest as RefFleetIngest
from zkstream_tpu.protocol import framing as ref_framing
from zkstream_tpu.protocol import jute as ref_jute
from zkstream_tpu.protocol import records as ref_records
from zkstream_tpu_torch.io.ingest import FleetIngest
from zkstream_tpu_torch.protocol.errors import ZKProtocolError
from zkstream_tpu_torch.protocol.framing import PacketCodec, frame
from zkstream_tpu_torch.protocol.jute import JuteWriter
from zkstream_tpu_torch.protocol.records import Stat, write_response

#: each package's ingest, codec and record writers, and what its
#: ingests are built with
PORT = types.SimpleNamespace(
    FleetIngest=FleetIngest, PacketCodec=PacketCodec, JuteWriter=JuteWriter,
    Stat=Stat, write_response=write_response, kw={'device': 'cpu'})
REF = types.SimpleNamespace(
    FleetIngest=RefFleetIngest, PacketCodec=ref_framing.PacketCodec,
    JuteWriter=ref_jute.JuteWriter, Stat=ref_records.Stat,
    write_response=ref_records.write_response, kw={'placement': 'host'})


class FakeConn:
    """The slice of ZKConnection the ingest touches: a codec, a state
    probe, and the 'ingestDeliver' emitter."""

    def __init__(self, pkg=PORT, use_native=False):
        self.codec = pkg.PacketCodec(use_native=use_native)
        self.codec.handshaking = False
        self.delivered: list = []
        self.on_deliver = None
        self.state = 'connected'

    def is_in_state(self, s):
        return self.state == s

    def emit(self, name, *args):
        assert name == 'ingestDeliver'
        self.delivered.append(args)
        if self.on_deliver is not None:
            self.on_deliver(self)


def reply_frame(xid, opcode='PING', zxid=7, pkg=PORT, **body) -> bytes:
    w = pkg.JuteWriter()
    pkg.write_response(w, {'xid': xid, 'zxid': zxid, 'err': 'OK',
                           'opcode': opcode, **body})
    return frame(w.to_bytes())


def mk_ingest(pkg=PORT, **kw):
    kw.setdefault('bypass_bytes', 0)
    kw.setdefault('warm', 'block')
    kw.setdefault('min_len', 256)
    kw.setdefault('max_frames', 4)
    return pkg.FleetIngest(**pkg.kw, **kw)


def observed(conn) -> list:
    """A connection's deliveries: packets, and each error as its class
    name, code and message."""
    return [(pkts, None if err is None else
             (type(err).__name__, err.code, str(err)))
            for pkts, err in conn.delivered]


async def both(case):
    """``case(pkg)`` on the port and then on the reference: the port's
    observations, asserted equal to the reference's."""
    got = await case(PORT)
    assert got == await case(REF)
    return got


async def drain():
    """Run the call_soon-scheduled tick."""
    await asyncio.sleep(0)
    await asyncio.sleep(0)


def _fail_warm(ing) -> None:
    """Make every warm of ``ing`` fail (the port's bucket warm, the
    reference's XLA compile)."""
    ing._compile = lambda key: (_ for _ in ()).throw(
        RuntimeError('injected compile failure'))


async def test_compile_failure_latches_bucket_to_scalar(caplog):
    """A failed warm must latch that bucket onto the scalar drain
    (never retry, never lose traffic) — warm='block'."""
    async def case(pkg):
        ing = mk_ingest(pkg)
        _fail_warm(ing)
        conn = FakeConn(pkg)
        ing.register(conn)
        ing.feed(conn, reply_frame(-2, pkg=pkg))
        await drain()
        # delivered through the codec anyway, and the bucket is poisoned
        assert conn.delivered[0][0][0]['opcode'] == 'PING'
        assert list(ing._exec.values()) == [None]
        before = ing.ticks_scalar
        ing.feed(conn, reply_frame(-2, pkg=pkg))
        await drain()
        assert ing.ticks_scalar == before + 1   # stays scalar, no retry
        assert ing.ticks == 0
        return observed(conn), ing.ticks_scalar

    with caplog.at_level('ERROR', logger='zkstream_tpu_torch'):
        assert (await both(case))[1] == 2
    # the port logs the failure once, at error level
    errors = [r for r in caplog.records
              if r.name == 'zkstream_tpu_torch' and 'failed to warm'
              in r.getMessage()]
    assert len(errors) == 1 and 'injected' in errors[0].getMessage()


async def test_background_compile_failure_unblocks_prewarm():
    """warm='background': a failing warm still sets the warm event
    (None latched), so prewarm callers do not hang."""
    async def case(pkg):
        ing = mk_ingest(pkg, warm='background')
        _fail_warm(ing)
        await asyncio.wait_for(ing.prewarm(4), timeout=10)
        assert list(ing._exec.values()) == [None]
        # traffic flows scalar through the latched bucket
        conn = FakeConn(pkg)
        ing.register(conn)
        ing.feed(conn, reply_frame(-2, pkg=pkg))
        await drain()
        assert conn.delivered[0][0][0]['opcode'] == 'PING'
        assert ing.ticks == 0 and ing.ticks_scalar == 1
        ing.close()
        return observed(conn)

    await both(case)


def test_loop_closed_mid_compile_is_contained():
    """The background warm thread surviving its event loop: the
    call_soon_threadsafe on a closed loop raises RuntimeError, which
    must be swallowed (the process is shutting down; nothing to do).
    Sync test: it owns its own short-lived loop."""
    for pkg in (PORT, REF):
        ing = mk_ingest(pkg, warm='background')
        release = threading.Event()
        done = threading.Event()

        def slow_compile(key):
            release.wait(10)
            done.set()
            return None

        ing._compile = slow_compile

        async def kick():
            ing._start_warm(ing._bucket(8, 256))

        loop = asyncio.new_event_loop()
        try:
            loop.run_until_complete(kick())
        finally:
            loop.close()          # close BEFORE the warm finishes
        release.set()
        assert done.wait(10)
        ing._warm_queue.join()    # daemon worker finished the task cleanly
        # the result could not be delivered: the bucket is still unwarmed
        assert ing._exec == {}


async def test_warming_tick_defers_scalar_then_flips_to_device():
    """warm='background' handoff: ticks before the warm lands drain
    scalar (counted as warming), and the ready callback re-schedules so
    queued bytes flow through the device program."""
    async def case(pkg):
        ing = mk_ingest(pkg, warm='background')
        conn = FakeConn(pkg)
        ing.register(conn)
        ing.feed(conn, reply_frame(-2, pkg=pkg))
        await drain()
        assert ing.ticks_warming == 1
        assert conn.delivered[0][0][0]['opcode'] == 'PING'
        # wait for the single bucket to finish warming
        ev = next(iter(ing._warm_events.values()))
        await asyncio.wait_for(ev.wait(), timeout=30)
        ing.feed(conn, reply_frame(-2, pkg=pkg))
        await drain()
        assert ing.ticks == 1                  # device path engaged
        assert conn.delivered[1][0][0]['opcode'] == 'PING'
        ing.close()
        return observed(conn), ing.ticks_warming, ing.ticks

    await both(case)


async def test_register_migrates_codec_residue():
    """BATCH regime: a partial steady-state frame that rode the same
    TCP segment as the handshake must migrate from the scalar decoder
    into the slot (the tick scan owns the stream), and complete once
    the rest arrives."""
    async def case(pkg):
        ing = mk_ingest(pkg)                # bypass 0 -> batch regime
        conn = FakeConn(pkg)
        wire = reply_frame(-2, pkg=pkg)
        conn.codec.restore_pending(wire[:5])  # partial frame in the codec
        ing.register(conn)
        assert bytes(ing._slots[id(conn)][1]) == wire[:5]
        ing.feed(conn, wire[5:])
        await drain()
        assert conn.delivered[0][0][0]['opcode'] == 'PING'
        return observed(conn)

    await both(case)


async def test_register_direct_regime_leaves_residue_in_codec():
    """DIRECT regime (the shipped default at startup): the codec keeps
    draining the stream itself, so handshake-coincident residue must
    STAY in the codec — migrating it into a slot nothing drains would
    strand it and misframe every later byte."""
    async def case(pkg):
        ing = mk_ingest(pkg, bypass_bytes=16384)
        assert ing._direct
        conn = FakeConn(pkg)
        wire = reply_frame(-2, pkg=pkg) + reply_frame(-2, pkg=pkg)
        conn.codec.restore_pending(wire[:5])
        ing.register(conn)
        assert bytes(ing._slots[id(conn)][1]) == b''   # slot stays empty
        # the connection-side direct drain continues the partial frame
        # exactly where the codec left off
        pkts = conn.codec.decode(wire[5:])
        ing.note_direct(len(wire) - 5, len(pkts))
        assert [p['opcode'] for p in pkts] == ['PING', 'PING']
        await drain()
        assert ing.frames_routed == 2
        return pkts, ing.frames_routed

    await both(case)


async def test_feed_after_unregister_is_dropped():
    async def case(pkg):
        ing = mk_ingest(pkg)
        conn = FakeConn(pkg)
        ing.register(conn)
        ing.unregister(conn)
        ing.feed(conn, reply_frame(-2, pkg=pkg))  # raced a teardown
        await drain()
        assert conn.delivered == []
        return observed(conn)

    await both(case)


async def test_unregister_restores_pending_bytes_to_codec():
    async def case(pkg):
        ing = mk_ingest(pkg)
        conn = FakeConn(pkg)
        ing.register(conn)
        wire = reply_frame(-2, pkg=pkg)
        ing.feed(conn, wire[:5])
        ing.unregister(conn)
        # the closing state keeps draining through the codec
        pkts = conn.codec.decode(wire[5:])
        assert pkts[0]['opcode'] == 'PING'
        return pkts

    await both(case)


async def test_unmatched_reply_xid_is_bad_decode():
    """A reply xid matching no request surfaces the same BAD_DECODE
    the scalar codec raises (framing.py parity)."""
    async def case(pkg):
        ing = mk_ingest(pkg)
        conn = FakeConn(pkg)
        ing.register(conn)
        ing.feed(conn, reply_frame(31337, pkg=pkg))  # nothing in xid_map
        await drain()
        pkts, err = conn.delivered[0]
        assert pkts == []
        assert err.code == 'BAD_DECODE'
        assert 'matches no request' in str(err)
        return observed(conn)

    [(_pkts, err)] = await both(case)
    assert err[0] == ZKProtocolError.__name__


async def test_unsupported_reply_opcode_is_bad_decode():
    async def case(pkg):
        ing = mk_ingest(pkg)
        conn = FakeConn(pkg)
        conn.codec.xid_map[9] = 'SET_ACL'  # decodable header, no reader
        ing.register(conn)
        w = pkg.JuteWriter()
        w.write_struct(struct.Struct('>iqi'), 9, 7, 0)
        w.write_ustring('/x')
        ing.feed(conn, frame(w.to_bytes()))
        await drain()
        pkts, err = conn.delivered[0]
        assert pkts == []
        assert err.code == 'BAD_DECODE'
        return observed(conn)

    await both(case)


async def test_bypass_scalar_error_delivers_prior_packets():
    """The small-tick bypass drains through the codec: a frame with an
    undecodable BODY mid-chunk delivers the packets before it plus the
    error (the scalar drain's contract, test_native_ext's
    bad-body case), and a bad LENGTH prefix surfaces BAD_LENGTH."""
    async def case(pkg):
        ing = mk_ingest(pkg, bypass_bytes=1 << 20)  # force the bypass
        conn = FakeConn(pkg)
        ing.register(conn)
        # valid framing, body truncated mid-stat
        bad_body = struct.pack('>iqi', 2, 5, 0) + b'\x00' * 4
        conn.codec.xid_map[2] = 'EXISTS'
        ing.feed(conn, reply_frame(-2, pkg=pkg) + frame(bad_body))
        await drain()
        pkts, err = conn.delivered[0]
        assert [p['opcode'] for p in pkts] == ['PING']
        assert err.code == 'BAD_DECODE'

        conn2 = FakeConn(pkg)
        ing.register(conn2)
        ing.feed(conn2, struct.pack('>i', -5))  # negative length prefix
        await drain()
        pkts, err = conn2.delivered[0]
        assert pkts == []
        assert err.code == 'BAD_LENGTH'
        return observed(conn), observed(conn2)

    await both(case)


@pytest.mark.parametrize('setup', ['bypass', 'warming', 'device'])
async def test_teardown_mid_tick_skips_dead_connection(setup):
    """A delivery callback tearing down ANOTHER connection mid-tick:
    the torn-down conn is skipped on every drain loop (bypass, warming,
    device) and its bytes returned to its codec."""
    async def case(pkg):
        ing = mk_ingest(
            pkg, bypass_bytes=(1 << 20) if setup == 'bypass' else 0,
            warm='background' if setup == 'warming' else 'block')
        if setup == 'device':
            await ing.prewarm(8)
        a, b = FakeConn(pkg), FakeConn(pkg)
        ing.register(a)
        ing.register(b)

        def kill_b(_conn):
            ing.unregister(b)
        a.on_deliver = kill_b
        ing.feed(conn=a, data=reply_frame(-2, pkg=pkg))
        ing.feed(conn=b, data=reply_frame(-2, pkg=pkg))
        await drain()
        assert a.delivered and a.delivered[0][0][0]['opcode'] == 'PING'
        # b was skipped; its bytes went back to its codec intact
        assert b.delivered == [], setup
        assert id(b) not in ing._slots
        ing.close()
        return observed(a), observed(b), b.codec.decode(b'')

    await both(case)


async def test_oversized_device_body_falls_back_to_scalar_reader():
    """body_mode='device': a data field wider than the tensor plane
    must fall back to the scalar reader per frame (counted), with the
    identical packet delivered."""
    async def case(pkg):
        ing = mk_ingest(pkg, body_mode='device', max_data=8, max_path=16,
                        max_frames=2)
        conn = FakeConn(pkg)
        conn.codec.xid_map[5] = 'GET_DATA'
        conn.codec.xid_map[6] = 'GET_DATA'
        ing.register(conn)
        st = pkg.Stat(czxid=1, mzxid=2, pzxid=3)
        wire = reply_frame(5, 'GET_DATA', pkg=pkg, data=b'x' * 32,
                           stat=st)                       # > 8
        wire += reply_frame(6, 'GET_DATA', pkg=pkg, data=b'ok',
                            stat=st)                      # fits
        ing.feed(conn, wire)
        await drain()
        pkts, err = conn.delivered[0]
        assert err is None
        assert pkts[0]['data'] == b'x' * 32    # scalar fallback, correct
        assert pkts[1]['data'] == b'ok'        # device plane
        assert ing.body_fallbacks == 1
        return observed(conn), ing.body_fallbacks

    await both(case)


async def test_fragmentation_guard_enters_and_exits():
    """The upper dispatch guard (CROSSOVER.md's 1,024-conn losing
    regime): a large fleet whose ticks are sparse routes to the scalar
    drain; when ticks become batches again the device path resumes —
    with hysteresis in between."""
    async def case(pkg):
        # the guard must be requested explicitly here: bypass_bytes=0
        # auto-disables it (force-device means force-device)
        ing = mk_ingest(pkg, frag_guard=True)  # bypass 0, warm='block'
        ing.FRAG_MIN_FLEET = 8        # scale the guard to a test fleet
        await ing.prewarm(8)
        conns = [FakeConn(pkg) for _ in range(8)]
        for c in conns:
            ing.register(c)
        marks = []

        # synchronized bursts: every conn delivers every tick -> device
        for _ in range(4):
            for c in conns:
                ing.feed(c, reply_frame(-2, pkg=pkg))
            await drain()
        assert ing.ticks >= 4 and ing.ticks_frag == 0
        marks.append((ing.ticks, ing.ticks_frag))

        # fragmented: one frame per tick over an 8-conn fleet -> the EMA
        # decays below FRAG_ENTER * 8 = 2 and the guard engages
        for i in range(16):
            ing.feed(conns[i % 8], reply_frame(-2, pkg=pkg))
            await drain()
        assert ing.ticks_frag > 0
        assert ing._frag_scalar
        frag_at = ing.ticks_frag
        # every frame still delivered, through whichever path
        assert ing.frames_routed == 4 * 8 + 16
        marks.append((ing.ticks, ing.ticks_frag))

        # batches return: EMA recovers past FRAG_EXIT * 8 and device
        # ticks resume (a couple of guarded ticks while the EMA climbs is
        # the hysteresis working)
        device_before = ing.ticks
        for _ in range(8):
            for c in conns:
                ing.feed(c, reply_frame(-2, pkg=pkg))
            await drain()
        assert not ing._frag_scalar
        assert ing.ticks_frag <= frag_at + 3
        assert ing.ticks > device_before     # device path resumed
        marks.append((ing.ticks, ing.ticks_frag))
        return marks, [observed(c) for c in conns]

    await both(case)


async def test_direct_and_batch_regimes_deliver_identically():
    """Property: the SAME randomized feed pattern through a forced
    pass-through ingest and a forced batch ingest delivers identical
    packet sequences per connection — the regime machine is an
    execution-layout choice, never a semantics change — and the
    reference's batch ingest delivers the same."""
    import random

    rng = random.Random(2024)

    def traffic():
        out = []
        for i in range(40):
            kind = rng.random()
            if kind < 0.6:
                out.append(('frame', reply_frame(-2)))
            elif kind < 0.8:
                w = reply_frame(-1, 'NOTIFICATION', zxid=100 + i,
                                type='DATA_CHANGED',
                                state='SYNC_CONNECTED', path='/p%d' % i)
                out.append(('frame', w))
            else:
                out.append(('split', reply_frame(-2)))
        return out

    plan = traffic()

    async def run(ing, pkg=PORT):
        conns = [FakeConn(pkg) for _ in range(3)]
        for c in conns:
            ing.register(c)
        for j, (kind, wire) in enumerate(plan):
            c = conns[j % 3]
            if kind == 'split':      # byte-at-a-time partial feeds
                for off in range(0, len(wire), 5):
                    ing.feed(c, wire[off:off + 5])
                    await asyncio.sleep(0)
            else:
                ing.feed(c, wire)
            if j % 4 == 0:
                await drain()
        for _ in range(6):
            await drain()
        for c in conns:          # no regime may surface an error
            assert all(e is None for _pkts, e in c.delivered)
        return [[(p['opcode'], p.get('path'), p['zxid'])
                 for pkts, _e in c.delivered for p in pkts]
                for c in conns]

    direct = await run(mk_ingest(bypass_bytes=1 << 30))  # always direct
    batch = await run(mk_ingest(bypass_bytes=0))         # always batch
    assert direct == batch
    assert sum(len(x) for x in direct) == len(plan)
    assert batch == await run(mk_ingest(REF, bypass_bytes=0), REF)


async def test_force_device_auto_disables_frag_guard():
    """bypass_bytes=0 promises every tick on the device pipeline
    (tests, benchmarks); under frag_guard auto (the default) that
    promise extends to the fragmentation guard."""
    for pkg in (PORT, REF):
        assert mk_ingest(pkg).frag_guard is False          # bypass 0
        assert mk_ingest(pkg, frag_guard=True).frag_guard is True
        assert pkg.FleetIngest(**pkg.kw).frag_guard is True  # default
        assert pkg.FleetIngest(frag_guard=False,
                               **pkg.kw).frag_guard is False


async def test_background_warm_thread_is_daemon():
    """The warm worker must be a daemon thread: a warm wedged on an
    unreachable device must not hang interpreter exit — which a
    ThreadPoolExecutor's non-daemon worker, joined by
    concurrent.futures atexit, would."""
    ing = mk_ingest(warm='background')
    ev = ing._start_warm(ing._bucket(2, ing.min_len))
    warm = [t for t in threading.enumerate()
            if t.name == 'ingest-warm']
    assert warm and all(t.daemon for t in warm)
    await asyncio.wait_for(ev.wait(), 60)
    ing.close()


async def test_close_releases_warm_worker_and_is_idempotent():
    """close() drains queued warms FIFO, then the daemon worker exits;
    a second close is a no-op; an ingest that never warmed has nothing
    to release."""
    mk_ingest().close()                  # never warmed: no-op

    # other suites' ingests may have parked warm workers of their own;
    # only the thread THIS ingest starts must exit on close
    before = {t for t in threading.enumerate()
              if t.name == 'ingest-warm'}
    ing = mk_ingest(warm='background')
    ev = ing._start_warm(ing._bucket(2, ing.min_len))
    await asyncio.wait_for(ev.wait(), 60)    # queued warm lands
    (mine,) = [t for t in threading.enumerate()
               if t.name == 'ingest-warm' and t not in before]
    ing.close()
    ing.close()                          # idempotent
    for _ in range(100):
        if not mine.is_alive():
            break
        await asyncio.sleep(0.05)
    else:
        raise AssertionError('warm worker survived close()')


# -- the port's own cases: the latch on the mesh ingest, and what
# still raises --


@pytest.mark.parametrize('body_mode', ['host', 'device'])
async def test_mesh_warm_failure_latches_bucket_to_scalar(body_mode):
    """``MeshFleetIngest`` inherits the latch: a failed warm drains that
    bucket through the scalar codec, with the packets the scalar codec
    decodes, in both body modes."""
    from zkstream_tpu_torch.parallel import MeshFleetIngest, make_mesh

    ing = MeshFleetIngest(mesh=make_mesh(dp=4, devices=['cpu'] * 4),
                          device='cpu', body_mode=body_mode,
                          warm='block', max_frames=4)
    _fail_warm(ing)
    conns = [FakeConn() for _ in range(3)]
    for c in conns:
        ing.register(c)
    for _ in range(2):
        for c in conns:
            ing.feed(c, reply_frame(-2))
        await drain()
    assert list(ing._exec.values()) == [None]
    assert ing.ticks == 0 and ing.ticks_scalar == 2
    assert ing.global_stats is None
    want = FakeConn().codec.decode(reply_frame(-2))
    assert all(observed(c) == [(want, None)] * 2 for c in conns)


async def test_step_failure_after_warm_raises():
    """Only a warm failure latches: a bucket that warmed and then fails
    when its tick runs (a replayed graph on a card, the eager chain on
    the CPU) raises out of the tick, as the reference's executable call
    does, and the bucket stays warm."""
    ing = mk_ingest()
    await ing.prewarm(1)

    def broken(device_bodies):
        def step(buf, lens):
            raise RuntimeError('injected step failure')
        return step

    ing._step_fn = broken
    conn = FakeConn()
    ing.register(conn)
    ing.feed(conn, reply_frame(-2))
    with pytest.raises(RuntimeError, match='injected step failure'):
        ing._tick_impl()
    assert None not in ing._exec.values()
    assert ing.ticks == 1 and ing.ticks_scalar == 0
    assert conn.delivered == []
