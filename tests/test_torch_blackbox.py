"""The port's black-box plane (utils/blackbox.py): crash-durable flight
recorder, slow-op digest, and the fleet collector.  The port of
tests/test_blackbox.py: every box the port writes is also scanned by the
JAX package's reader, which must see the same frames and status (the
on-disk format is shared), and the server-facing cases run on the
port's ``ZKServer``/``ZKEnsemble`` and CLI.  The SIGKILL case spawns
member processes and is marked ``slow``, as the port's other
process-tier cases are.

Corruption discipline mirrors tests/test_wal.py exactly: a torn FINAL
frame (truncation at every byte offset) is the normal crash signature
and yields every complete frame before it; a bit flip anywhere fails
the CRC32C and nothing at or past it is trusted.  The end-to-end legs
run the OS-process election tier: a SIGKILL'd leader's box must
recover and give the dead member a voice in the merged timeline."""

import json
import os
import struct

import pytest
from helpers import wait_until

from zkstream_tpu.utils import blackbox as ref_bb
from zkstream_tpu_torch import Client, cli
from zkstream_tpu_torch.utils.blackbox import (
    MAGIC_BLACKBOX,
    TOP_SCHEMA,
    BlackBoxRecorder,
    box_path,
    harvest_spans,
    list_boxes,
    read_box,
    scan_box,
)
from zkstream_tpu_torch.utils.trace import TraceRing, merge_timelines

# ---------------------------------------------------------------------
# corpus helpers (the WAL tests' framing walk, retargeted at a box)
# ---------------------------------------------------------------------


def _build_box(directory, member='0', frames=4, final=True,
               cap_bytes=4 * 1024 * 1024):
    """An offline box with ``frames`` periodic frames (+1 final when
    asked) — no loop, so every write is inline and the file is
    byte-complete when this returns."""
    rec = BlackBoxRecorder(directory, member=member,
                           interval_ms=60000.0, cap_bytes=cap_bytes)
    for _ in range(frames):
        rec.capture()
    rec.stop(final=final)
    return box_path(directory, member)


def scan_both(path):
    """``scan_box(path)``, asserted to give the JAX package's scan's
    status, valid bytes and frames."""
    scan, ref = scan_box(path), ref_bb.scan_box(path)
    assert (scan.status, scan.valid_bytes, scan.frames) == \
        (ref.status, ref.valid_bytes, ref.frames)
    return scan


def read_both(directory, member):
    """``read_box(directory, member)``, asserted to give what the JAX
    package's ``read_box`` gives (each file's scan compared by its
    status, valid bytes and frames)."""
    box = read_box(directory, member)
    ref = ref_bb.read_box(directory, member)

    def plain(b):
        return dict(b, files=[(f.status, f.valid_bytes, f.frames)
                              for f in b['files']])
    assert plain(box) == plain(ref)
    return box


def _frame_starts(blob):
    """Offsets where each CRC-framed record begins (test_wal.py's
    segment walk: ``>I`` length, ``>I`` crc, body)."""
    starts = []
    off = len(MAGIC_BLACKBOX)
    while off < len(blob):
        starts.append(off)
        (ln,) = struct.unpack_from('>I', blob, off)
        off += 8 + ln
    assert off == len(blob), 'corpus must be byte-exact'
    return starts


def test_torn_final_frame_tolerated_at_every_byte_offset(tmp_path):
    """Truncate the box at EVERY byte offset inside the last frame:
    the scan must yield exactly the complete frames, report 'torn'
    (except at the exact frame boundary), and never raise."""
    path = _build_box(str(tmp_path), frames=4, final=True)
    blob = open(path, 'rb').read()
    starts = _frame_starts(blob)
    assert len(starts) == 5          # 4 periodic + 1 final
    last = starts[-1]
    cut_path = str(tmp_path / 'cut.log')
    for cut in range(last, len(blob)):
        with open(cut_path, 'wb') as f:
            f.write(blob[:cut])
        scan = scan_both(cut_path)
        assert len(scan.frames) == 4, cut
        assert scan.valid_bytes == last, cut
        if cut == last:
            assert scan.status == 'ok', cut
        else:
            assert scan.status == 'torn', (cut, scan.status)
        assert [f['seq'] for f in scan.frames] == [0, 1, 2, 3]


def test_bit_flip_rejected_at_every_offset_of_a_frame(tmp_path):
    """Flip one bit at EVERY offset of frame 3's span (header + crc +
    body): the flipped frame and everything after it must never
    decode — a mid-ring flip is corruption, not a crash tail."""
    path = _build_box(str(tmp_path), frames=4, final=True)
    blob = bytearray(open(path, 'rb').read())
    starts = _frame_starts(bytes(blob))
    lo, hi = starts[2], starts[3]
    flip_path = str(tmp_path / 'flip.log')
    for off in range(lo, hi):
        blob[off] ^= 0x40
        with open(flip_path, 'wb') as f:
            f.write(bytes(blob))
        scan = scan_both(flip_path)
        assert len(scan.frames) <= 2, off
        assert scan.status != 'ok', off
        assert [f['seq'] for f in scan.frames] == \
            [0, 1][:len(scan.frames)]
        blob[off] ^= 0x40            # restore for the next offset
    # bad magic is structural corruption, zero frames trusted
    blob[0] ^= 0x40
    with open(flip_path, 'wb') as f:
        f.write(bytes(blob))
    assert scan_both(flip_path).status == 'corrupt'


def test_rotation_bounds_disk_and_read_box_folds_old_half(tmp_path):
    """A tiny cap forces the flip-flop rotation; read_box folds the
    rotated half before the current file and a torn ROTATED half is
    graded corrupt (a live process sealed it — not a crash)."""
    d = str(tmp_path)
    rec = BlackBoxRecorder(d, member='r', interval_ms=60000.0,
                           cap_bytes=200)
    for _ in range(9):
        rec.capture()
    rec.stop(final=False)
    path = box_path(d, 'r')
    assert os.path.exists(path + '.old')
    # disk stays bounded near 2x cap + one frame, forever
    total = os.path.getsize(path) + os.path.getsize(path + '.old')
    assert total < 2 * (200 + 512) + 2 * len(MAGIC_BLACKBOX)
    box = read_both(d, 'r')
    assert box['status'] == 'ok'
    seqs = [f['seq'] for f in box['frames']]
    assert seqs == sorted(seqs) and len(seqs) >= 2
    assert list_boxes(d) == ['r']
    # tear the ROTATED half: that is structural, not a crash tail
    blob = open(path + '.old', 'rb').read()
    with open(path + '.old', 'wb') as f:
        f.write(blob[:-1])
    assert read_both(d, 'r')['status'] == 'corrupt'


def test_stop_seals_the_box_with_its_final_frame(tmp_path):
    """A clean stop() leaves the final frame last: the frames of an
    executor write still in flight land before it, and a frame appended
    after it (a span that settles after the stop, such as a WAL's last
    group fsync) is not written.  (The JAX package's recorder can write
    both after its final frame.)"""
    import asyncio
    import concurrent.futures
    import threading

    release = threading.Event()
    pool = concurrent.futures.ThreadPoolExecutor(1)
    loop = asyncio.new_event_loop()
    loop.set_default_executor(pool)
    try:
        rec = BlackBoxRecorder(str(tmp_path), member='s',
                               interval_ms=60000.0)
        rec.start(loop)
        pool.submit(release.wait, 10)    # the executor's thread is busy
        rec.capture()                    # seq 0: its write is in flight
        rec.capture()                    # seq 1: queued behind it
        rec.stop()                       # seq 2: final
        release.set()
        pool.shutdown(wait=True)         # the in-flight write runs now
        loop.run_until_complete(asyncio.sleep(0))
        rec.capture('slow_op')           # after the stop: stays out
    finally:
        loop.close()
    box = read_both(str(tmp_path), 's')
    assert box['status'] == 'ok'
    assert [(f['seq'], f['kind']) for f in box['frames']] == \
        [(0, 'periodic'), (1, 'periodic'), (2, 'final')]


# ---------------------------------------------------------------------
# slow-op digest
# ---------------------------------------------------------------------


def test_trace_ring_slow_hook_fires_only_past_threshold():
    ring = TraceRing(member='m9')
    fired = []
    ring.slow_ms = 5.0
    ring.on_slow = fired.append
    # fast start()/finish(): under threshold, silent
    ring.start('FAST').finish(zxid=1)
    assert fired == []
    # pre-measured note() over threshold fires (WAL_RECOVER style)
    ring.note('GROUP_FSYNC', zxid=2, duration_ms=9.0)
    assert [s.op for s in fired] == ['GROUP_FSYNC']
    # note() under threshold stays silent
    ring.note('COMMIT', zxid=3, duration_ms=1.0)
    assert len(fired) == 1
    # a genuinely slow open span fires on settle
    span = ring.start('SLOW')
    span._t0 -= 0.050                # 50ms of elapsed time
    span.finish(zxid=4)
    assert [s.op for s in fired] == ['GROUP_FSYNC', 'SLOW']
    # threshold off (the default): nothing ever fires
    quiet = TraceRing()
    quiet.on_slow = fired.append
    quiet.note('COMMIT', zxid=5, duration_ms=9999.0)
    assert len(fired) == 2


async def test_server_slow_op_digest_persists_causal_chain(
        tmp_path, monkeypatch):
    """With the threshold dialed to ~zero every settled span is slow:
    the counter moves, mntr reports it, and the box holds slow_op
    frames carrying the offending span plus its zxid chain."""
    monkeypatch.setenv('ZKSTREAM_SLOW_OP_MS', '0.0001')
    from zkstream_tpu_torch.server import ZKServer
    from zkstream_tpu_torch.utils.metrics import Collector

    d = str(tmp_path / 'wal')
    srv = await ZKServer(wal_dir=d, collector=Collector()).start()
    try:
        assert srv.blackbox is not None
        assert srv.trace.slow_ms == 0.0001
        c = Client(address='127.0.0.1', port=srv.port,
                   session_timeout=5000)
        c.start()
        try:
            await c.wait_connected(timeout=5)
            await c.create('/slow', b'x')
            await c.set('/slow', b'y')
        finally:
            await c.close()
        await wait_until(lambda: srv.blackbox.slow_ops > 0)
        rows = dict(srv.monitor_stats())
        assert rows['zk_slow_ops_total'] == srv.blackbox.slow_ops
        # every counted slow op observed the threshold histogram
        assert srv.blackbox._hist is not None
        assert srv.blackbox._hist.count() == srv.blackbox.slow_ops
    finally:
        await srv.stop()
    member = list_boxes(d)[0]
    box = read_both(d, member)
    assert box['status'] == 'ok'     # clean stop: no torn tail
    slow = [f for f in box['frames'] if f['kind'] == 'slow_op']
    assert slow, [f['kind'] for f in box['frames']]
    for f in slow:
        assert f['slow']['duration_ms'] >= 0.0001
        assert f['chain'], f         # the causal chain rode along
        zx = f['slow'].get('zxid')
        if zx is not None:
            assert all(s['zxid'] == zx for s in f['chain'])
    assert box['frames'][-1]['kind'] == 'final'


async def test_clean_ensemble_counts_zero_slow_ops(tmp_path):
    """The clean-schedule invariant (`make obs`): a healthy 3-member
    ensemble at the DEFAULT threshold counts zero slow ops while the
    recorders frame on cadence, and a clean stop seals every box with
    a final frame."""
    from zkstream_tpu_torch.server import ZKEnsemble

    d = str(tmp_path / 'ens')
    ens = await ZKEnsemble(3, wal_dir=d).start()
    try:
        c = Client(address='127.0.0.1', port=ens.servers[0].port,
                   session_timeout=5000)
        c.start()
        try:
            await c.wait_connected(timeout=5)
            await c.create('/k', b'0')
            for i in range(5):
                await c.set('/k', b'%d' % i)
        finally:
            await c.close()
        for srv in ens.servers:
            assert srv.blackbox is not None
            srv.blackbox.capture()
            rows = dict(srv.monitor_stats())
            assert rows['zk_slow_ops_total'] == 0
            assert rows['zk_blackbox_frames'] >= 1
            assert rows['zk_uptime_ms'] >= 0
        await wait_until(
            lambda: all(s.blackbox.bytes_written > 0
                        for s in ens.servers))
    finally:
        await ens.stop()
    members = list_boxes(d)
    assert len(members) == 3
    for m in members:
        box = read_both(d, m)
        assert box['status'] == 'ok'
        assert box['frames'][-1]['kind'] == 'final'
        assert box['frames'][-1]['mntr']['zk_slow_ops_total'] == 0
    assert harvest_spans(d)          # span tails survived to disk
    assert harvest_spans(d) == ref_bb.harvest_spans(d)


# ---------------------------------------------------------------------
# the crash story: SIGKILL on the OS-process tier, then recovery
# ---------------------------------------------------------------------


@pytest.mark.slow
@pytest.mark.timeout(240)
async def test_sigkill_leader_box_recovers_into_merged_timeline(
        tmp_path, capsys, monkeypatch):
    """The acceptance path end to end: the process-tier schedule
    SIGKILLs elected leaders; their boxes (torn tails included) are
    harvested off disk into ``ScheduleResult.member_rings``, merge
    into the zxid timeline next to the client's spans, and the CLI
    renders the same directory clean."""
    monkeypatch.setenv('ZKSTREAM_BLACKBOX_MS', '50')
    from zkstream_tpu_torch.server.election import run_process_schedule

    r = await run_process_schedule(seed=7, ops=3, elections=1,
                                   generations=1,
                                   workdir=str(tmp_path))
    assert r.ok, r.violations
    assert r.acked > 0
    # this tier has no live in-process rings: every entry here was
    # read back from a killed member's on-disk box
    assert r.member_rings, 'no black boxes harvested'
    assert all(k.startswith('member:m') for k in r.member_rings)
    merged = merge_timelines(
        dict({'client': r.trace}, **r.member_rings))
    assert any(e['source'].startswith('member:') for e in merged), \
        'dead members contributed nothing to the timeline'
    # the boxes themselves: recoverable, never structurally corrupt
    boxed = 0
    for i in range(3):
        d = os.path.join(str(tmp_path), 'm%d' % (i,))
        for m in list_boxes(d):
            box = read_both(d, m)
            assert box['status'] in ('ok', 'torn'), \
                (d, m, box['status'])
            assert box['frames'], (d, m)
            boxed += 1
    assert boxed >= 1
    # and the CLI agrees with the harvest (same scan underneath)
    for i in range(3):
        d = os.path.join(str(tmp_path), 'm%d' % (i,))
        if not list_boxes(d):
            continue
        args = cli.build_parser().parse_args(['blackbox', d])
        assert cli._blackbox(args) == 0
        args = cli.build_parser().parse_args(
            ['blackbox', d, '--json'])
        assert cli._blackbox(args) == 0
        out = capsys.readouterr().out
        doc = json.loads(out[out.index('{'):])
        assert doc['blackbox_schema'] == 1
        assert doc['members'][0]['frames']


async def test_chaos_trace_out_carries_member_rings(tmp_path,
                                                    capsys):
    """The harvest round trip the triage workflow uses: one transport
    schedule, ``--trace-out`` JSON, member rings + merged timeline in
    the dump."""
    out = str(tmp_path / 'spans.json')
    args = cli.build_parser().parse_args(
        ['chaos', '--tier', 'transport', '--schedules', '1',
         '--ops', '4', '--quiet', '--trace-out', out])
    rc = await cli._chaos(args)
    capsys.readouterr()
    assert rc == 0
    docs = json.load(open(out))
    assert len(docs) == 1
    doc = docs[0]
    assert doc['ok'] and doc['trace_schema']
    assert doc['member_rings'], 'schedule dump lost the member rings'
    assert isinstance(doc['timeline'], list)
    for key in doc['member_rings']:
        assert key.startswith('member:')


# ---------------------------------------------------------------------
# the continuous fleet collector
# ---------------------------------------------------------------------


async def test_top_appends_schema_stamped_jsonl(tmp_path, capsys):
    """`zkstream_tpu_torch top --out` across a live 3-member ensemble: one
    JSONL row per member per poll, top_schema-stamped, carrying the
    full mntr inventory (zk_uptime_ms included)."""
    from zkstream_tpu_torch.server import ZKEnsemble

    out = str(tmp_path / 'top.jsonl')
    ens = await ZKEnsemble(3).start()
    try:
        spec = ','.join('127.0.0.1:%d' % p
                        for _h, p in ens.addresses())
        args = cli.build_parser().parse_args(
            ['--server', spec, 'top', '--count', '2',
             '--interval', '0.05', '--out', out])
        rc = await cli._top(args)
        capsys.readouterr()
        assert rc == 0
    finally:
        await ens.stop()
    rows = [json.loads(line) for line in open(out)]
    assert len(rows) == 6            # 3 members x 2 polls
    members = set()
    for row in rows:
        assert row['top_schema'] == TOP_SCHEMA
        members.add(row['member'])
        assert row['mntr']['zk_uptime_ms'] >= 0
        assert row['mntr']['zk_slow_ops_total'] == 0
        assert 'zk_znode_count' in row['mntr']
    assert len(members) == 3


async def test_top_all_unreachable_is_exit_1(capsys):
    args = cli.build_parser().parse_args(
        ['--server', '127.0.0.1:1', '--timeout', '1', 'top',
         '--count', '1', '--interval', '0.01'])
    rc = await cli._top(args)
    capsys.readouterr()
    assert rc == 1
