"""The port of tests/test_durability_scenarios.py, on the port's
durability plane; every case on an in-process server or ensemble runs
twice, on the port's and on the JAX package's, with the port's clients.

The ack-durability-gap scenarios: quorum-commit, durable
sessions and MULTI, each asserted at its sharpest edge.

- **torn-multi recovery**: a MULTI is ONE CRC-framed WAL record, so a
  crash mid-record replays the batch atomically or not at all —
  asserted at EVERY byte offset of the record, with invariant 8
  (io/invariants.py check_multi_atomic) doing the judging.
- **full-restart-with-live-ephemerals**: a full-ensemble death and
  restart inside the session timeout keeps sessions, their ephemerals
  and (via SET_WATCHES resume) their watches — the durable-session
  records + format-3 snapshot stamp (server/persist.py).
- **quorum-commit units**: the QuorumGate's ack arithmetic (majority
  floor, epoch-fenced stale acks, degrade release, the CommitBarrier
  composition with the WAL gate, the virtual-grant RPC wait).

The third seeded chaos scenario — leader SIGKILLed immediately after
acking a quorum-committed write, write survives the election — runs
in the OS-process campaign (server/election.py run_process_schedule,
tests/test_process_ensemble.py): every kill-loop round writes a
marker THROUGH the leader and kills it the instant the ack returns.
"""

from __future__ import annotations

import asyncio
import struct

from helpers import wait_until
from zkstream_tpu_torch import Client, CreateFlag
from zkstream_tpu_torch.io.invariants import (
    History,
    check_acked_durability,
    check_multi_atomic,
    check_session_continuity,
)
from zkstream_tpu_torch.server.persist import (
    MAGIC_SEGMENT,
    open_wal_database,
    recover_state,
    scan_dir,
)
from zkstream_tpu_torch.server.replication import (
    CommitBarrier,
    QuorumGate,
)
from zkstream_tpu_torch.server.store import NodeTree, ZKDatabase
from test_torch_basic import ensemble_cls, server, server_cls  # noqa: F401


# -- scenario: torn MULTI record replays all-or-nothing ----------------


def _multi_wal(tmp_path):
    """A closed WAL whose FINAL record is a 3-sub MULTI; returns the
    dir, the segment blob and the final record's start offset."""
    d = str(tmp_path / 'wal')
    db = open_wal_database(d, sync='always')
    db.create('/base', b'seed', None, 0, None)
    res = db.multi([
        {'op': 'create', 'path': '/m1', 'data': b'aaaa'},
        {'op': 'create', 'path': '/m2', 'data': b'bbbb'},
        {'op': 'set_data', 'path': '/base', 'data': b'mutated'},
    ])
    assert [r['op'] for r in res] == ['create', 'create', 'set_data']
    db.wal.close()
    seg = scan_dir(d).segments[0]
    with open(seg.path, 'rb') as f:
        blob = f.read()
    off = len(MAGIC_SEGMENT)
    starts = []
    while off < len(blob):
        (ln,) = struct.unpack_from('>I', blob, off)
        starts.append(off)
        off += 8 + ln
    return d, seg.path, blob, starts[-1]


def test_torn_multi_every_byte_offset(tmp_path):
    """Cut the log at every byte inside the final (multi) record: the
    recovered tree must hold either the WHOLE batch or none of it —
    never a partial apply — and invariant 8 agrees."""
    d, seg_path, blob, last_start = _multi_wal(tmp_path)
    h = History()
    h.multi_batch([('create', '/m1', b'aaaa'),
                   ('create', '/m2', b'bbbb'),
                   ('set_data', '/base', b'mutated')])
    for cut in range(last_start, len(blob) + 1):
        with open(seg_path, 'wb') as f:
            f.write(blob[:cut])
        rec = recover_state(d)
        tree = NodeTree()
        tree.install({'zxid': rec.zxid, 'nodes': rec.nodes})
        whole = cut == len(blob)
        # a cut exactly at the record boundary is a CLEAN shorter log,
        # not a tear; anything inside the record is torn
        assert rec.torn == (last_start < cut < len(blob)), \
            (cut, rec.detail)
        if whole:
            assert tree.nodes['/m1'].data == b'aaaa'
            assert tree.nodes['/m2'].data == b'bbbb'
            assert tree.nodes['/base'].data == b'mutated'
        else:
            assert '/m1' not in tree.nodes, cut
            assert '/m2' not in tree.nodes, cut
            assert tree.nodes['/base'].data == b'seed', cut
        assert check_multi_atomic(h, tree) == [], cut


def test_torn_multi_reopen_truncates_and_rewrites(tmp_path):
    """After a torn multi, reopening the WAL truncates the tear and a
    re-issued batch lands whole — the recovery story end to end."""
    d, seg_path, blob, last_start = _multi_wal(tmp_path)
    with open(seg_path, 'wb') as f:
        f.write(blob[:last_start + 13])      # mid-record
    db = open_wal_database(d, sync='always')
    assert '/m1' not in db.nodes and '/m2' not in db.nodes
    db.multi([
        {'op': 'create', 'path': '/m1', 'data': b'aaaa'},
        {'op': 'create', 'path': '/m2', 'data': b'bbbb'},
        {'op': 'set_data', 'path': '/base', 'data': b'mutated'},
    ])
    db.wal.close()
    rec = recover_state(d)
    assert rec.nodes['/m1'].data == b'aaaa'
    assert rec.nodes['/m2'].data == b'bbbb'
    assert rec.nodes['/base'].data == b'mutated'
    assert not rec.torn


# -- scenario: full restart with live ephemerals -----------------------


async def test_full_restart_keeps_live_ephemerals_e2e(tmp_path, server_cls):
    """Kill the whole server and bring it back inside the session
    timeout: the CLIENT keeps its session (no expire), its ephemerals
    survive, and its re-armed watch still fires — the fast-restart
    guarantee the durable session table exists for."""
    srv = await server_cls(wal_dir=str(tmp_path / 'w'),
                         durability='always').start()
    c = Client(address='127.0.0.1', port=srv.port,
               session_timeout=30000)
    expired = []
    c.on('expire', lambda: expired.append(1))
    c.start()
    try:
        await c.wait_connected(timeout=5)
        await c.create('/eph', b'mine', flags=CreateFlag.EPHEMERAL)
        await c.create('/plain', b'keep')
        fires = []
        w = c.watcher('/plain')
        w.on('dataChanged', lambda data, stat: fires.append(data))
        await asyncio.sleep(0.1)
        sid = c.session.session_id

        # capture the pre-crash truth, then die and come back
        live = {sid: {'/eph'}}
        await srv.stop()
        await srv.restart(from_disk=True)

        assert check_session_continuity(live, srv.db) == []
        # the client reconnects and RESUMES — same session id, no
        # expire edge, ephemeral intact
        await c.wait_connected(timeout=10)
        assert c.session.session_id == sid
        assert not expired
        data, stat = await c.get('/eph')
        assert data == b'mine' and stat.ephemeralOwner == sid
        # the re-armed watch fires on the next change
        await c.set('/plain', b'v2')
        await wait_until(lambda: fires and bytes(fires[-1]) == b'v2',
                         5)
    finally:
        await c.close()
        await srv.stop()


async def test_full_ensemble_restart_keeps_sessions(tmp_path, ensemble_cls):
    """The ensemble flavor: a fresh ZKEnsemble over yesterday's
    wal_dir recovers the session table (snapshot stamp + session
    records) and keeps live ephemerals; a client presenting the
    recovered credentials resumes."""
    d = str(tmp_path / 'w')
    ens = await ensemble_cls(3, wal_dir=d, durability='always').start()
    c = Client(servers=ens.addresses(), shuffle_backends=False,
               session_timeout=30000)
    c.start()
    await c.wait_connected(timeout=5)
    await c.create('/eph', b'x', flags=CreateFlag.EPHEMERAL)
    sid = c.session.session_id
    passwd = None
    for s in ens.db.sessions.values():
        if s.id == sid:
            passwd = s.passwd
    # full death: stop WITHOUT closing the client session cleanly
    c.pool.stop()
    await ens.stop()

    ens2 = await ensemble_cls(3, wal_dir=d, durability='always').start()
    try:
        assert check_session_continuity({sid: {'/eph'}}, ens2.db) == []
        assert ens2.db.resume_session(sid, passwd) is not None
        # invariant 1 agrees: the acked ephemeral create survived
        h = History()
        h.acked_create('/eph', b'x', sid, ephemeral=True, zxid=1)
        assert check_acked_durability(h, ens2.db) == []
        # a session that does NOT resume expires on its own clock and
        # the expiry reaps the ephemeral by logged deletes
        ens2.db.sessions[sid].timeout = 1
        ens2.db.touch_session(ens2.db.sessions[sid])
        await wait_until(lambda: '/eph' not in ens2.db.nodes, 5)
    finally:
        await ens2.stop()


# -- quorum-commit units -----------------------------------------------


def _gate(total=3, **kw):
    db = ZKDatabase()
    return db, QuorumGate(db, total, **kw)


def test_quorum_floor_arithmetic():
    db, g = _gate(3)
    assert g.enabled
    db.zxid = 5
    assert g.quorum_zxid() == 0          # no follower ack yet
    g.note_ack('f1', 3)
    assert g.quorum_zxid() == 3          # leader(5) + f1(3) -> 3
    g.note_ack('f2', 5)
    assert g.quorum_zxid() == 5
    g.forget('f2')
    assert g.quorum_zxid() == 3
    # single-member mode: the leader IS the majority
    db2, g2 = _gate(1)
    db2.zxid = 9
    assert not g2.enabled
    assert g2.quorum_zxid() == 9
    assert g2.gate_flush(lambda: None) is True


def test_quorum_gate_blocks_until_majority(event_loop):
    async def run():
        db, g = _gate(3, wait_ms=5000)
        db.zxid = 2
        released = []
        assert g.gate_flush(lambda: released.append(1)) is False
        g.note_ack('f1', 1)
        assert not released                  # floor 1 < 2
        g.note_ack('f1', 2)
        await asyncio.sleep(0)
        assert released                      # majority at 2
        assert g.quorum_zxid_floor == 2
        # stale-epoch acks are fenced out of the tally
        db.epoch = 4
        db.zxid = 3
        g.note_ack('f2', 3, epoch=3)
        assert g.stale_acks == 1 and g.quorum_zxid() == 2
        g.note_ack('f2', 3, epoch=4)
        assert g.quorum_zxid() == 3
        g.close()
    event_loop.run_until_complete(run())


def test_quorum_gate_degrades_not_wedges(event_loop):
    async def run():
        db, g = _gate(3, wait_ms=30.0)
        db.zxid = 1
        released = []
        assert g.gate_flush(lambda: released.append(1)) is False
        await asyncio.sleep(0.1)
        assert released and g.degraded_releases == 1
        # the degraded zxid never re-blocks (read-only ticks flow);
        # a NEW write gets its own bounded wait
        assert g.gate_flush(lambda: None) is True
        db.zxid = 2
        assert g.gate_flush(lambda: released.append(2)) is False
        g.close()
    event_loop.run_until_complete(run())


def test_quorum_gate_no_loop_degrades_once():
    """Without a running loop there is no ack delivery and no timer:
    the gate degrades ON THE SPOT — floor marked, counted, waiter
    released exactly once — because the release IS flush_now, which
    re-enters gate_flush synchronously: an unmarked release would
    recurse through its own registration forever."""
    db, g = _gate(3, wait_ms=30.0)
    db.zxid = 1
    calls = []
    g.gate_flush(lambda: calls.append(1))
    assert calls == [1]
    assert g.degraded_releases == 1 and g.degraded_zxid == 1
    assert g.gate_flush(lambda: calls.append(2)) is True
    # and a CLOSED gate gates nothing — no re-registration, no timer
    db2, g2 = _gate(3)
    db2.zxid = 1
    g2.close()
    assert g2.gate_flush(lambda: None) is True


def test_commit_barrier_composes_wal_and_quorum(event_loop):
    async def run():
        db, g = _gate(3, wait_ms=5000)
        db.zxid = 1

        class FakeWal:
            cleared = False
            release = None

            def gate_flush(self, release):
                if self.cleared:
                    return True
                self.release = release
                return False

            def sync_for_flush(self):
                self.synced = True

        wal = FakeWal()
        barrier = CommitBarrier(wal, g)
        flushed = []
        assert barrier.gate_flush(lambda: flushed.append(1)) is False
        # one half clearing is not enough
        wal.cleared = True
        wal.release()
        assert barrier.gate_flush(lambda: flushed.append(2)) is False
        g.note_ack('f1', 1)
        await asyncio.sleep(0)
        # quorum released; the re-gate now clears both
        assert barrier.gate_flush(lambda: None) is True
        barrier.sync_for_flush()
        assert wal.synced
        g.close()
    event_loop.run_until_complete(run())


def test_quorum_rpc_wait_with_virtual_grant(event_loop):
    async def run():
        db, g = _gate(3, wait_ms=50.0)
        db.zxid = 4
        # the calling follower's vote counts virtually: leader +
        # grant = 2 of 3, no waiting, no deadlock-by-timeout
        assert await g.wait(4, grant='caller') is True
        # without a grant the wait needs a real second vote
        t0 = asyncio.get_running_loop().time()
        assert await g.wait(4) is False      # degrade timeout
        assert asyncio.get_running_loop().time() - t0 >= 0.04
        assert g.degraded_releases == 1
        fut = asyncio.ensure_future(g.wait(4, timeout_s=5))
        await asyncio.sleep(0)
        g.note_ack('f1', 4)
        assert await fut is True
        g.close()
    event_loop.run_until_complete(run())


def test_quorum_no_demotion_for_quorum_acked_writes():
    """Invariant 1's strengthened form: an ack at or under the quorum
    floor is enforced even past the fsync-failure floor."""
    tree = ZKDatabase()
    tree.create('/q', b'x', None, 0, None)       # zxid 1
    h = History()
    h.acked_create('/q', b'x', 1, zxid=1)
    h.acked_create('/lost', b'y', 1, zxid=2)
    # plain floor demotion: both acks past floor 0 are demoted
    assert check_acked_durability(h, tree, floor_zxid=0) == []
    # quorum floor 1: /q (zxid 1) is enforced — present, so clean;
    # /lost (zxid 2) stays demoted
    assert check_acked_durability(h, tree, floor_zxid=0,
                                  quorum_zxid=1) == []
    # and a quorum-acked write that IS missing becomes a violation
    # the plain floor would have excused
    h2 = History()
    h2.acked_create('/gone', b'z', 1, zxid=1)
    out = check_acked_durability(h2, tree, floor_zxid=0,
                                 quorum_zxid=1)
    assert out and 'acked create /gone lost' in out[0]
    assert check_acked_durability(h2, tree, floor_zxid=0) == []


async def test_ensemble_quorum_gate_wired_and_traced(tmp_path, ensemble_cls):
    """The in-process ensemble carries the gate by default: writes
    ack only at the majority floor, the QUORUM_ACK span lands in the
    zxid chain, and the quorum=False arm keeps the fsync-only
    barrier."""
    ens = await ensemble_cls(3, wal_dir=str(tmp_path / 'w')).start()
    c = Client(servers=ens.addresses(), shuffle_backends=False)
    c.start()
    try:
        await c.wait_connected(timeout=5)
        await c.create('/qq', b'v')
        assert ens.quorum.enabled
        await wait_until(
            lambda: ens.quorum.quorum_zxid_floor >= ens.db.zxid, 5)
        spans = [s for s in ens.servers[0].trace.dump()
                 if s['op'] == 'QUORUM_ACK']
        assert spans, 'QUORUM_ACK span missing from the leader ring'
    finally:
        await c.close()
        await ens.stop()
    ens2 = await ensemble_cls(2, quorum=False).start()
    try:
        assert not ens2.quorum.enabled
        assert ens2.servers[0].ack_barrier is None  # no WAL, no gate
    finally:
        await ens2.stop()
