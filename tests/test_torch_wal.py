"""The port's durability plane (server/persist.py; the port of
tests/test_wal.py): CRC32C record framing, the two-tier entry
codec, group-commit sync policies, fuzzy snapshots + rotation, and
crash recovery — including the torn-write corpus: a recorded log
truncated at EVERY byte offset of its final record must still recover
the longest valid prefix, and a bit flip anywhere must be rejected by
CRC, never half-applied.  The server cases run on the port's server
and on the JAX package's; the fsync fault cases take a fixed stub of
the WAL's fault hook.  The full-ensemble restart runs on both
packages' ``ZKEnsemble``; the follower resyncs drive the port's
replication layer."""

from __future__ import annotations

import asyncio
import os
import struct

import pytest

from zkstream_tpu_torch.protocol.consts import CreateFlag, Perm
from zkstream_tpu_torch.protocol.records import ACL, OPEN_ACL_UNSAFE, Id
from zkstream_tpu_torch.server.persist import (
    MAGIC_SEGMENT,
    WriteAheadLog,
    crc32c,
    decode_entry,
    encode_entry,
    entry_zxid,
    open_wal_database,
    recover_state,
    scan_dir,
    _spec_encode_entry,
)
from zkstream_tpu_torch.server.store import ZKDatabase
from zkstream_tpu_torch.utils.metrics import Collector
from test_torch_basic import ensemble_cls, server_cls  # noqa: F401


# -- CRC32C -------------------------------------------------------------

def test_crc32c_known_answers():
    # the RFC 3720 / iSCSI check value
    assert crc32c(b'123456789') == 0xE3069283
    assert crc32c(b'') == 0
    assert crc32c(b'\x00' * 32) == 0x8A9136AA
    # chaining splits arbitrarily
    whole = crc32c(b'hello world')
    assert crc32c(b' world', crc32c(b'hello')) == whole


def test_crc32c_tiers_agree():
    """The C-extension tier (when built) matches the Python spec tier
    over a structured + random corpus, chaining included."""
    import random

    from zkstream_tpu_torch.server.persist import software_crc32c
    from zkstream_tpu_torch.utils import native

    ext = native.ensure_ext()
    if ext is None or not hasattr(ext, 'crc32c'):
        pytest.skip('native extension unavailable')
    rng = random.Random(7)
    corpus = [b'', b'\x00', b'123456789', b'\xff' * 257,
              bytes(range(256))]
    corpus += [rng.randbytes(rng.randrange(1, 512)) for _ in range(64)]
    for blob in corpus:
        assert ext.crc32c(blob) == software_crc32c(blob)
        mid = len(blob) // 2
        assert ext.crc32c(blob[mid:], ext.crc32c(blob[:mid])) == \
            software_crc32c(blob)


# -- entry codec: fast tier == jute spec tier --------------------------

ENTRY_CORPUS = [
    ('create', '/a', b'hello', OPEN_ACL_UNSAFE, 0, 1, 1726000000123),
    ('create', '/uni-é中', b'', OPEN_ACL_UNSAFE,
     0x7fffffffffff0001, 2, 7),
    ('create', '/acl', b'x', (ACL(Perm.READ | Perm.WRITE,
                                  Id('digest', 'u:pw')),
                              ACL(Perm.ALL, Id('world', 'anyone'))),
     0, 3, 0),
    ('create', '/big', b'\xff' * 70000, OPEN_ACL_UNSAFE, 0, 4, 5),
    ('set_data', '/a', b'v' * 300, 5, 99),
    ('set_data', '/a', b'', 6, 0),
    ('delete', '/a', 7),
]


@pytest.mark.parametrize('entry', ENTRY_CORPUS,
                         ids=[e[0] + str(i) for i, e in
                              enumerate(ENTRY_CORPUS)])
def test_entry_codec_tiers_byte_identical(entry):
    fast = encode_entry(entry)
    spec = _spec_encode_entry(entry)
    assert fast == spec
    assert decode_entry(fast) == entry
    assert entry_zxid(entry) == entry_zxid(decode_entry(fast))


# -- append / recover roundtrip ----------------------------------------

def _populate(db, n=8):
    for i in range(n):
        db.create('/n%d' % i, b'v%d' % i, None, 0, None)
    db.set_data('/n0', b'updated', -1)
    db.delete('/n1', -1)


async def test_roundtrip_and_reopen_continues(tmp_path):
    d = str(tmp_path / 'wal')
    db = open_wal_database(d, sync='always')
    _populate(db)
    stat_before = db.nodes['/n0'].stat()
    db.wal.close()

    rec = recover_state(d)
    assert rec.zxid == db.zxid
    assert rec.nodes['/n0'].data == b'updated'
    assert '/n1' not in rec.nodes
    # byte-identical Stat after replay (same apply primitives)
    assert rec.nodes['/n0'].stat() == stat_before

    # reopen continues the log where it left off
    db2 = open_wal_database(d, sync='always')
    assert db2.zxid == db.zxid
    db2.create('/post', b'p', None, 0, None)
    db2.wal.close()
    rec2 = recover_state(d)
    assert rec2.nodes['/post'].data == b'p'
    assert rec2.zxid == db.zxid + 1


async def test_sequential_counter_restored_after_recovery(tmp_path):
    """A recovered leader must never hand out an already-used
    sequential number — even when the numbered node was deleted (the
    counter is leader-only state no replayed entry carries)."""
    d = str(tmp_path / 'wal')
    db = open_wal_database(d, sync='always')
    db.create('/q', b'', None, 0, None)
    p0 = db.create('/q/s-', b'', None, CreateFlag.SEQUENTIAL, None)
    p1 = db.create('/q/s-', b'', None, CreateFlag.SEQUENTIAL, None)
    assert (p0, p1) == ('/q/s-0000000000', '/q/s-0000000001')
    db.delete(p1, -1)
    db.wal.close()
    db2 = open_wal_database(d, sync='always')
    p2 = db2.create('/q/s-', b'', None, CreateFlag.SEQUENTIAL, None)
    assert p2 == '/q/s-0000000002', p2
    db2.wal.close()


async def test_recovery_honors_session_liveness(tmp_path):
    """Durable sessions: a session live at the crash is recovered
    with its ephemerals intact (restart inside the session timeout —
    the client can resume); only a DEAD session's ephemerals are
    reaped, by logged deletes, so a second crash cannot resurrect
    them."""
    d = str(tmp_path / 'wal')
    db = open_wal_database(d, sync='always')
    live = db.create_session(30000)
    dead = db.create_session(30000)
    db.create('/eph-live', b'x', None, CreateFlag.EPHEMERAL, live)
    db.create('/eph-dead', b'x', None, CreateFlag.EPHEMERAL, dead)
    db.create('/keep', b'y', None, 0, None)
    db.close_session(dead.id)            # reaps /eph-dead, logged
    db.wal.close()
    db2 = open_wal_database(d, sync='always')
    # the live session survived with its ephemeral; a resume with the
    # recovered credentials succeeds
    assert '/eph-live' in db2.nodes
    assert db2.nodes['/eph-live'].ephemeral_owner == live.id
    assert db2.resume_session(live.id, live.passwd) is not None
    assert db2.sessions[live.id].ephemerals == {'/eph-live'}
    assert '/eph-dead' not in db2.nodes
    assert db2.nodes['/keep'].data == b'y'
    # an ephemeral whose owner died WITHOUT a close record (e.g. the
    # session record itself predates a session-table wipe) is still
    # reaped: model it by expiring the live session, then crashing
    db2.expire_session(live.id)
    db2.wal.close()
    db3 = open_wal_database(d, sync='always')
    assert '/eph-live' not in db3.nodes
    assert db3.resume_session(live.id, live.passwd) is None
    db3.wal.close()
    # the reaps were logged: a further recovery agrees without reaping
    rec = recover_state(d)
    assert '/eph-live' not in rec.nodes and '/eph-dead' not in rec.nodes
    assert live.id not in rec.sessions and dead.id not in rec.sessions


# -- torn-write corpus --------------------------------------------------

def _single_segment(tmp_path, n_entries=5):
    """A closed WAL dir with everything in one segment, plus the byte
    offset where the final record starts."""
    d = str(tmp_path / 'wal')
    db = open_wal_database(d, sync='always')
    for i in range(n_entries):
        db.create('/t%d' % i, b'payload-%d' % i, None, 0, None)
    db.wal.close()
    seg = scan_dir(d).segments[0]
    assert len(seg.records) == n_entries
    with open(seg.path, 'rb') as f:
        blob = f.read()
    # walk the framing to find the last record's start offset
    off = len(MAGIC_SEGMENT)
    starts = []
    while off < len(blob):
        (ln,) = struct.unpack_from('>I', blob, off)
        starts.append(off)
        off += 8 + ln
    return d, seg.path, blob, starts[-1]


async def test_torn_final_record_every_byte_offset(tmp_path):
    """Truncate the log at EVERY byte offset inside the final record:
    recovery must load exactly the first n-1 records each time — the
    longest valid prefix — and report the tear, never raise, never
    half-apply."""
    d, seg_path, blob, last_start = _single_segment(tmp_path)
    for cut in range(last_start, len(blob)):
        with open(seg_path, 'wb') as f:
            f.write(blob[:cut])
        rec = recover_state(d)
        assert rec.zxid == 4, (cut, rec.zxid)
        assert '/t3' in rec.nodes and '/t4' not in rec.nodes, cut
        assert rec.torn == (cut != last_start), cut
    # the complete file recovers all five
    with open(seg_path, 'wb') as f:
        f.write(blob)
    rec = recover_state(d)
    assert rec.zxid == 5 and '/t4' in rec.nodes and not rec.torn


async def test_bit_flip_rejected_by_crc(tmp_path):
    """Flip one bit at every offset of a mid-log record: the CRC must
    reject it (replay stops before it; nothing after is trusted)."""
    d, seg_path, blob, last_start = _single_segment(tmp_path)
    # the third record's span: find its start
    off = len(MAGIC_SEGMENT)
    starts = []
    while off < len(blob):
        (ln,) = struct.unpack_from('>I', blob, off)
        starts.append((off, 8 + ln))
        off += 8 + ln
    start, span = starts[2]
    for rel in range(span):
        flipped = bytearray(blob)
        flipped[start + rel] ^= 0x40
        with open(seg_path, 'wb') as f:
            f.write(bytes(flipped))
        rec = recover_state(d)
        # records 0-1 always survive; record 2 never does (a flipped
        # length may also invalidate the frame walk, which is fine —
        # the point is no corrupt record is ever half-applied)
        assert rec.zxid <= 2, (rel, rec.zxid)
        assert '/t1' in rec.nodes or rec.zxid < 2
        assert '/t2' not in rec.nodes, rel


async def test_reopen_quarantines_segments_past_mid_log_corruption(
        tmp_path):
    """A corrupt NON-final segment stops recovery there — and
    reopening for writes must quarantine the later segments rather
    than truncate-and-rejoin them, or the NEXT recovery would replay
    across the gap into history the served state never contained."""
    d = str(tmp_path / 'wal')
    db = open_wal_database(d, sync='always', segment_bytes=300)
    for i in range(12):
        db.create('/q%d' % i, b'v%d' % i, None, 0, None)
    db.wal.close()
    scan = scan_dir(d)
    assert len(scan.segments) >= 3
    # wipe the snapshots so nothing supersedes the corruption, then
    # flip a byte in the FIRST segment
    for s in scan.snapshots:
        os.unlink(s.path)
    with open(scan.segments[0].path, 'r+b') as f:
        f.seek(20)
        blob = bytearray(f.read(1))
        f.seek(20)
        f.write(bytes([blob[0] ^ 0xFF]))
    rec = recover_state(d)
    served_zxid = rec.zxid            # what a recovered server serves
    db2 = open_wal_database(d, sync='always')
    assert db2.zxid == served_zxid    # reopen agrees with recovery
    db2.create('/after', b'a', None, 0, None)
    db2.wal.close()
    rec2 = recover_state(d)
    assert rec2.zxid == served_zxid + 1
    assert rec2.nodes['/after'].data == b'a'
    # the unreachable era was quarantined, not silently replayed
    assert '/q11' not in rec2.nodes
    assert any(f.endswith('.dead') for f in os.listdir(d))


async def test_recover_from_disk_keeps_collector_bindings(tmp_path):
    """restart(from_disk=True) reopens the SAME WriteAheadLog object,
    so collector-bound gauges keep reading live state."""
    d = str(tmp_path / 'wal')
    collector = Collector()
    db = open_wal_database(d, sync='always', collector=collector)
    db.create('/a', b'x', None, 0, None)
    wal_before = db.wal
    db.wal.close()
    db.recover_from_disk()
    assert db.wal is wal_before       # same object: closures stay live
    db.create('/b', b'y', None, 0, None)
    text = collector.expose()
    assert 'zkstream_wal_last_index 2' in text
    assert db.wal.durable_zxid == 2
    db.wal.close()


async def test_reopen_truncates_torn_tail_and_continues(tmp_path):
    """Opening a torn directory for writing truncates the tear in
    place, so post-restart appends can never hide behind garbage."""
    d, seg_path, blob, last_start = _single_segment(tmp_path)
    with open(seg_path, 'wb') as f:
        f.write(blob[:last_start + 5])      # mid-record tear
    db = open_wal_database(d, sync='always')
    assert db.zxid == 4
    db.create('/after-tear', b'z', None, 0, None)
    db.wal.close()
    rec = recover_state(d)
    assert rec.zxid == 5 and rec.nodes['/after-tear'].data == b'z'
    assert not rec.torn


# -- rotation, snapshots, truncation -----------------------------------

async def test_rotation_snapshots_and_truncation(tmp_path):
    d = str(tmp_path / 'wal')
    db = open_wal_database(d, sync='always', segment_bytes=256)
    for i in range(40):
        db.create('/r%d' % i, b'v%d' % i, None, 0, None)
    # executor-thread snapshot writes settle on the loop
    for _ in range(50):
        await asyncio.sleep(0.01)
        if db.wal.snapshots_taken >= 2:
            break
    scan = scan_dir(d)
    assert db.wal.snapshots_taken >= 2
    valid = [s for s in scan.snapshots if s.valid]
    assert valid, 'no durable snapshot'
    # truncation actually reclaimed early segments
    assert scan.segments[0].start_index > 0
    # every still-needed entry is reachable: full recovery equals the
    # live tree
    rec = recover_state(d)
    assert rec.zxid == db.zxid
    assert set(rec.nodes) == set(db.nodes)
    db.wal.close()


async def test_corrupt_newest_snapshot_falls_back(tmp_path):
    """A corrupt newest snapshot forces the older one + a longer
    replay — and the kept-segment range must still cover it."""
    d = str(tmp_path / 'wal')
    db = open_wal_database(d, sync='always', segment_bytes=256)
    for i in range(40):
        db.create('/f%d' % i, b'v%d' % i, None, 0, None)
    for _ in range(50):
        await asyncio.sleep(0.01)
        if db.wal.snapshots_taken >= 2:
            break
    live_zxid = db.zxid
    live_nodes = set(db.nodes)
    db.wal.close()
    snaps = [s for s in scan_dir(d).snapshots if s.valid]
    assert len(snaps) >= 2
    with open(snaps[-1].path, 'r+b') as f:
        f.seek(30)
        f.write(b'\xde\xad\xbe\xef')
    rec = recover_state(d)
    assert rec.zxid == live_zxid
    assert set(rec.nodes) == live_nodes
    assert rec.snapshot_index == snaps[-2].index


# -- sync policies + the group-commit barrier --------------------------

async def test_sync_always_is_durable_per_append(tmp_path):
    d = str(tmp_path / 'wal')
    db = open_wal_database(d, sync='always')
    db.create('/a', b'x', None, 0, None)
    assert db.wal.durable_zxid == db.zxid
    assert db.wal.fsyncs >= 1
    db.wal.close()


async def test_sync_tick_one_group_fsync_per_tick(tmp_path):
    """Appends of one event-loop iteration share one group fsync,
    which runs OFF the loop (executor thread) and marks everything
    written at submit time durable on completion."""
    d = str(tmp_path / 'wal')
    db = open_wal_database(d, sync='tick')
    for i in range(10):                  # same tick: no await between
        db.create('/b%d' % i, b'x', None, 0, None)
    assert db.wal.fsyncs == 0            # scheduled, not yet run
    for _ in range(200):                 # completion lands on the loop
        await asyncio.sleep(0.005)
        if db.wal.fsyncs:
            break
    assert db.wal.fsyncs == 1
    assert db.wal.durable_zxid == db.zxid
    db.wal.close()


async def test_gate_flush_releases_after_group_sync(tmp_path):
    """The send-plane gate: held while the group fsync is pending,
    released (on the loop) once it completes — and everything written
    at submit time is then durable."""
    d = str(tmp_path / 'wal')
    db = open_wal_database(d, sync='tick')
    db.create('/g', b'x', None, 0, None)
    released = []
    assert db.wal.gate_flush(lambda: released.append(1)) is False
    for _ in range(200):
        await asyncio.sleep(0.005)
        if released:
            break
    assert released == [1]
    assert db.wal.durable_zxid == db.zxid
    # durable now: the gate passes straight through
    assert db.wal.gate_flush(lambda: None) is True
    db.wal.close()


async def test_sync_for_flush_barrier(tmp_path):
    """The send-plane barrier: acks must not beat their fsync."""
    d = str(tmp_path / 'wal')
    db = open_wal_database(d, sync='tick')
    db.create('/c', b'x', None, 0, None)
    assert db.wal.durable_zxid < db.zxid
    db.wal.sync_for_flush()              # what flush_now runs
    assert db.wal.durable_zxid == db.zxid
    assert db.wal.fsyncs == 1
    db.wal.close()


async def test_sync_never_skips_fsync(tmp_path):
    d = str(tmp_path / 'wal')
    db = open_wal_database(d, sync='never')
    db.create('/n', b'x', None, 0, None)
    db.wal.sync_for_flush()
    assert db.wal.fsyncs == 0
    db.wal.close()
    # the bytes were still flushed to the OS: recovery sees them
    rec = recover_state(d)
    assert rec.zxid == 1


class _FsyncFaults:
    """The WAL's fault hook (``fsync_fault() -> (delay_ms, error)``,
    the 'disk' category of io/faults.py) with every decision fixed."""

    def __init__(self, delay_ms: float = 0.0, error: bool = False):
        self.decision = (delay_ms, error)

    def fsync_fault(self):
        return self.decision

    def close(self):
        pass


async def test_fsync_error_injection_counts_and_recovers(tmp_path):
    d = str(tmp_path / 'wal')
    inj = _FsyncFaults(error=True)
    db = open_wal_database(d, sync='always', faults=inj)
    db.create('/e', b'x', None, 0, None)
    assert db.wal.sync_errors >= 1
    assert db.wal.durable_zxid == 0      # nothing durable yet
    db.wal.faults = None                 # device heals
    db.create('/e2', b'y', None, 0, None)
    assert db.wal.durable_zxid == db.zxid   # barrier caught up
    db.wal.close()


async def test_roll_does_not_leak_durability_across_segments(
        tmp_path):
    """Per-segment accounting: a segment roll while a group fsync is
    in flight (or merely after one) must not let the old segment's
    offsets read as durability of the new segment's unsynced bytes —
    the ack gate has to hold until a sync covering the NEW append
    completes."""
    d = str(tmp_path / 'wal')
    # a deterministically slow device keeps the EWMA above the
    # fast-device short-circuit, so the group fsync goes off-loop
    inj = _FsyncFaults(delay_ms=3.0)
    db = open_wal_database(d, sync='tick', faults=inj)
    db.wal.segment_age_s = 1e9           # roll only when told to
    db.create('/a', b'x', None, 0, None)
    assert db.wal.gate_flush(lambda: None) in (True, False)
    db.wal.roll()                        # sync covers the old segment
    old_durable_zxid = db.wal.durable_zxid
    assert old_durable_zxid == 1
    db.create('/b', b'y', None, 0, None)
    # the new segment's append is NOT durable yet: the gate must keep
    # re-gating (a release means "re-attempt the flush", exactly what
    # the send-plane does) until a sync covering the NEW append lands
    released = []

    def attempt():
        if db.wal.gate_flush(attempt):
            released.append(1)
    attempt()
    for _ in range(400):
        if released:
            break
        await asyncio.sleep(0.005)
    assert released and db.wal.durable_zxid == 2
    db.wal.close()
    rec = recover_state(d)
    assert rec.zxid == 2 and rec.nodes['/b'].data == b'y'
    inj.close()


# -- crash windows ------------------------------------------------------

async def test_crash_image_windows(tmp_path):
    """before-fsync loses the un-fsynced tail (and only it);
    after-fsync keeps everything written."""
    d = str(tmp_path / 'wal')
    crash_b = str(tmp_path / 'crash-before')
    crash_a = str(tmp_path / 'crash-after')
    db = open_wal_database(d, sync='tick')
    db.create('/d1', b'x', None, 0, None)
    db.wal.sync_now()
    db.create('/d2', b'y', None, 0, None)   # appended, not fsynced
    floor_b = db.wal.materialize_crash(crash_b, before_fsync=True)
    floor_a = db.wal.materialize_crash(crash_a, before_fsync=False)
    assert (floor_b, floor_a) == (1, 2)
    rec_b = recover_state(crash_b)
    assert rec_b.zxid == 1 and '/d2' not in rec_b.nodes
    rec_a = recover_state(crash_a)
    assert rec_a.zxid == 2 and rec_a.nodes['/d2'].data == b'y'
    db.wal.close()


# -- metrics ------------------------------------------------------------

async def test_wal_metrics_exposition(tmp_path):
    d = str(tmp_path / 'wal')
    collector = Collector()
    db = open_wal_database(d, sync='always', collector=collector)
    db.create('/m', b'x' * 64, None, 0, None)
    text = collector.expose()
    assert 'zookeeper_fsync_latency_ms_count' in text
    assert 'zkstream_wal_append_bytes_count' in text
    assert 'zkstream_wal_segments 1' in text
    assert 'zkstream_wal_last_index 1' in text
    from zkstream_tpu_torch.server.persist import scrape_wal_cells
    cells = scrape_wal_cells(collector)
    assert cells['fsyncs'] >= 1 and cells['appends'] == 1
    db.wal.close()


# -- server integration -------------------------------------------------

async def test_server_restart_from_disk(tmp_path, server_cls):
    """Kill a standalone server, restart it from disk: acked state is
    back, sessions are gone (they died with the 'process')."""
    from zkstream_tpu_torch import Client

    d = str(tmp_path / 'wal')
    srv = await server_cls(wal_dir=d, durability='tick').start()
    c = Client(address='127.0.0.1', port=srv.port,
               session_timeout=8000)
    c.start()
    await c.wait_connected(timeout=10)
    for i in range(5):
        await c.create('/s%d' % i, b'v%d' % i)
    await c.set('/s0', b'final', version=-1)
    await c.close()
    await srv.stop()

    await srv.restart(from_disk=True)
    assert not srv.db.sessions
    c2 = Client(address='127.0.0.1', port=srv.port,
                session_timeout=8000)
    c2.start()
    await c2.wait_connected(timeout=10)
    data, stat = await c2.get('/s0')
    assert bytes(data) == b'final' and stat.version == 1
    data, _ = await c2.get('/s4')
    assert bytes(data) == b'v4'
    await c2.close()
    await srv.stop()
    srv.db.wal.close()


async def test_no_wal_env_kill_switch(tmp_path, monkeypatch, server_cls):
    monkeypatch.setenv('ZKSTREAM_NO_WAL', '1')
    srv = server_cls(wal_dir=str(tmp_path / 'wal'))
    assert srv.db.wal is None
    assert not os.path.exists(str(tmp_path / 'wal'))


async def test_wal_dir_env_default(tmp_path, monkeypatch, server_cls):
    monkeypatch.setenv('ZKSTREAM_WAL_DIR', str(tmp_path / 'envwal'))
    srv = server_cls()
    assert srv.db.wal is not None
    assert srv.db.wal.dir == str(tmp_path / 'envwal')
    srv.db.wal.close()


# -- the log format against the reference's -----------------------------

@pytest.mark.parametrize('writer', ['port', 'reference'])
async def test_log_readable_by_the_other_package(tmp_path, writer):
    """A log and snapshot written by one package recover to the same
    tree and zxid through the other's ``recover_state``: the port keeps
    the reference's on-disk format byte for byte."""
    from zkstream_tpu.server import persist as ref_persist

    d = str(tmp_path / 'wal')
    mod = ref_persist if writer == 'reference' else None
    db = (mod.open_wal_database if mod else open_wal_database)(
        d, sync='always')
    db.create('/a', b'one', None, 0, None)
    db.create('/a/b', b'two', None, 0, None)
    db.set_data('/a', b'three', -1)
    assert db.wal.snapshot_now()       # a snapshot, then a log tail
    db.create('/c', b'', None, 0, None)
    db.delete('/a/b', -1)
    db.wal.close()
    got = recover_state(d)
    want = ref_persist.recover_state(d)
    assert (got.zxid, got.last_index) == (want.zxid, want.last_index)
    assert sorted(got.nodes) == sorted(want.nodes)
    for path, node in want.nodes.items():
        assert bytes(got.nodes[path].data) == bytes(node.data), path


async def test_full_ensemble_restart_from_disk(tmp_path, ensemble_cls):
    """The headline guarantee, in-process tier: kill EVERY member (a
    full-ensemble crash — the case a live-leader resync can never
    recover), bring a fresh ensemble up over the same WAL dir, and
    every acked write is back, replicas included."""
    from zkstream_tpu_torch import Client

    d = str(tmp_path / 'wal')
    ens = await ensemble_cls(3, wal_dir=d, durability='tick').start()
    c = Client(servers=ens.addresses(), shuffle_backends=False,
               session_timeout=8000)
    c.start()
    await c.wait_connected(timeout=10)
    for i in range(10):
        await c.create('/k%d' % i, b'v%d' % i)
    await c.close()
    await ens.stop()                    # every member dies; WAL closed

    ens2 = await ensemble_cls(3, wal_dir=d, durability='tick').start()
    assert ens2.db.zxid >= 10
    c2 = Client(servers=[ens2.addresses()[1]],   # a follower serves it
                session_timeout=8000)
    c2.start()
    await c2.wait_connected(timeout=10)
    await c2.sync('/k0')
    for i in range(10):
        data, _ = await c2.get('/k%d' % i)
        assert bytes(data) == b'v%d' % i
    await c2.close()
    await ens2.stop()


async def test_follower_resync_from_recovered_zxid(tmp_path):
    """A follower that recovered its tree from disk rejoins with its
    recovered zxid and is shipped ONLY the tail — no snapshot fetch —
    and converges with the leader."""
    from zkstream_tpu_torch.server.replication import (
        RemoteLeader,
        RemoteReplicaStore,
        ReplicationService,
    )

    d = str(tmp_path / 'wal')
    db = ZKDatabase()
    svc = await ReplicationService(db).start()
    try:
        # follower joins fresh, mirrors 5 txns into its own WAL
        r1 = await RemoteLeader('127.0.0.1', svc.port).connect()
        rep1 = RemoteReplicaStore(r1, lag=0.0)
        wal = WriteAheadLog(d, sync='always')
        wal.bind(rep1)
        r1.wal = wal
        for i in range(5):
            db.create('/a%d' % i, b'x%d' % i, None, 0, None)
        await asyncio.sleep(0.05)
        assert rep1.zxid == 5
        r1.close()                       # SIGKILL stand-in
        wal.close()
        await asyncio.sleep(0.05)

        # a second replica keeps the leader's log retained while the
        # leader commits 4 more
        rk = await RemoteLeader('127.0.0.1', svc.port).connect()
        RemoteReplicaStore(rk, lag=0.0)
        for i in range(5, 9):
            db.create('/a%d' % i, b'x%d' % i, None, 0, None)

        # restart-from-disk: recovered zxid becomes the catch-up base
        rec = recover_state(d)
        assert rec.zxid == 5
        r2 = await RemoteLeader('127.0.0.1', svc.port,
                                have_zxid=rec.zxid).connect()
        rep2 = RemoteReplicaStore(r2, lag=0.0,
                                  recovered={'zxid': rec.zxid,
                                             'nodes': rec.nodes})
        assert r2.resynced, 'leader fell back to a snapshot fetch'
        assert r2._snapshot is None
        await asyncio.sleep(0.05)
        assert rep2.zxid == 9
        assert rep2.nodes['/a8'].data == b'x8'
        assert rep2.nodes['/a0'].data == b'x0'  # from the recovery
        r2.close()
        rk.close()
    finally:
        await svc.stop()


async def test_follower_resync_falls_back_when_log_truncated(
        tmp_path):
    """When the leader's retained log no longer covers the recovered
    zxid, the join falls back to the snapshot bootstrap — correctness
    over cleverness."""
    from zkstream_tpu_torch.server.replication import (
        RemoteLeader,
        RemoteReplicaStore,
        ReplicationService,
    )

    db = ZKDatabase()
    for i in range(6):
        db.create('/pre%d' % i, b'p%d' % i, None, 0, None)
    # no replica was attached: nothing retained, log starts at 6
    svc = await ReplicationService(db).start()
    try:
        r = await RemoteLeader('127.0.0.1', svc.port,
                               have_zxid=3).connect()
        rep = RemoteReplicaStore(r, lag=0.0,
                                 recovered={'zxid': 3, 'nodes': {}})
        assert not r.resynced            # zxid 3 is not covered
        await asyncio.sleep(0.05)
        assert rep.zxid == 6             # snapshot image installed
        assert rep.nodes['/pre5'].data == b'p5'
        r.close()
    finally:
        await svc.stop()


async def test_durable_recovery_invariant_floor():
    """check_durable_recovery: strict without a floor; acks past the
    floor are demoted to outcome-unknown."""
    from zkstream_tpu_torch.io.invariants import (
        History,
        check_durable_recovery,
    )
    from zkstream_tpu_torch.server.store import NodeTree

    h = History()
    h.acked_create('/a', b'x', 1, zxid=3)
    h.acked_create('/b', b'y', 1, zxid=8)

    tree = NodeTree()
    tree.zxid = 3
    tree._apply_create('/a', b'x', OPEN_ACL_UNSAFE, 0, 3, 0)
    tree.zxid = 3
    # strict: /b missing is a loss
    out = check_durable_recovery(h, tree)
    assert any('/b' in v for v in out), out
    # floor 3 (fsync failed past it): /b demoted, clean
    assert check_durable_recovery(h, tree, floor_zxid=3) == []
    # recovered-zxid floor check
    tree2 = NodeTree()
    out = check_durable_recovery(History(), tree2)
    assert out == []
    h2 = History()
    h2.acked_set('/w', 1, 1, zxid=9)
    tree3 = NodeTree()
    tree3._apply_create('/w', b'v1', OPEN_ACL_UNSAFE, 0, 2, 0)
    out = check_durable_recovery(h2, tree3)
    assert any('behind the newest durable acked zxid' in v
               for v in out), out
