"""The process-isolated ensemble tier of the port: the port of
tests/test_process_ensemble.py.  Each member is its own OS process
running the port's server stack, and the member holding the session
dies by SIGKILL — the OS severs the client's TCP connection, not a
cooperative close — while the session, its ephemeral, and its watches
survive on the rest of the ensemble.

Every case here is port-only: a replication channel carries pickled
messages whose class paths name their package, so a port member and a
reference member never share one running ensemble (state crosses
packages through the WAL, see the full-ensemble SIGKILL cases at the
end).  This file is also its own member worker (the port of
tests/process_member_worker.py), run as a script::

    python tests/test_torch_process_ensemble.py leader [WAL_DIR [SYNC]]
    python tests/test_torch_process_ensemble.py follower HOST PORT \
        [WAL_DIR [SYNC]]
    python tests/test_torch_process_ensemble.py member ID WAL_DIR \
        CLIENT_PORT ELECTION_PORT [PEER_ID:HOST:PORT ...]
    python tests/test_torch_process_ensemble.py spawn-time [N]

``leader`` serves a ``ZKDatabase`` with a ``ReplicationService`` and
prints ``READY <client_port> <repl_port>``; ``follower`` mirrors a
leader through ``RemoteLeader`` + ``RemoteReplicaStore`` and prints
``READY <client_port>``; ``member`` runs the package's
``server/member_worker.py``.  With a WAL_DIR the leader recovers its
database from it and the follower logs its mirror and rejoins from its
recovered zxid.  ``spawn-time`` spawns one single-member ensemble N
times (default 10) through ``ProcMember`` and prints the spawn-to-READY
times in milliseconds.
"""

from __future__ import annotations

import asyncio
import os
import signal
import subprocess
import sys
import tempfile

import pytest

WORKER = os.path.abspath(__file__)
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Member:
    def __init__(self, proc: subprocess.Popen, ports: list[int]):
        self.proc = proc
        self.ports = ports


def _spawn(*args: str) -> Member:
    # stderr goes to an anonymous file (a pipe nobody reads could fill
    # and stall the worker), shown when READY never comes
    with tempfile.TemporaryFile() as err:
        proc = subprocess.Popen(
            [sys.executable, WORKER, *args],
            stdout=subprocess.PIPE, stderr=err, text=True)
        line = proc.stdout.readline().strip()
        if not line.startswith('READY '):
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            err.seek(0)
            raise AssertionError((args, line, err.read()[-4000:]
                                  .decode('utf-8', 'replace')))
    return Member(proc, [int(x) for x in line.split()[1:]])


@pytest.fixture
def process_ensemble():
    """A leader process + two follower processes; yields
    (leader, [follower1, follower2]).  SIGKILLs everything left at
    teardown."""
    members: list[Member] = []
    leader = _spawn('leader')
    members.append(leader)
    try:
        for _ in range(2):
            members.append(_spawn('follower', '127.0.0.1',
                                  str(leader.ports[1])))
        yield leader, members[1:]
    finally:
        for m in members:
            if m.proc.poll() is None:
                m.proc.kill()
            m.proc.wait()
            m.proc.stdout.close()


async def on_free_ports(run, tries: int = 3):
    """``await run()``, run again from the start (fresh ports) when a
    member could not bind the port allocated for it.  ``allocate_ports``
    binds and closes, so another socket, such as an outgoing
    connection's ephemeral port, can take the port before the member
    binds it (ROADMAP queue 3); the member then exits before READY with
    errno 98 on its stderr (asyncio's bind words it in lower case, the
    ingress plane's raw bind as the OS does).  Any other failure is
    raised at once."""
    for left in range(tries - 1, -1, -1):
        try:
            return await run()
        except AssertionError as e:
            if left == 0 or 'address already in use' not in str(e).lower():
                raise


def _client(addrs, **kw):
    from zkstream_tpu_torch import Client

    kw.setdefault('session_timeout', 12000)
    c = Client(servers=addrs, shuffle_backends=False, **kw)
    c.start()
    return c


async def _retrying(coro_fn, attempts=20, delay=0.25):
    last = None
    for _ in range(attempts):
        try:
            return await coro_fn()
        except Exception as e:        # reconnect churn mid-failover
            last = e
            await asyncio.sleep(delay)
    raise last


async def test_sigkill_member_session_and_watches_survive(
        process_ensemble):
    """The reference experiment: kill -9 the member serving the
    session; the client reconnects to another member, resumes the SAME
    session (no 'expire', no fresh 'session'), its ephemeral is intact,
    and a re-armed watch still fires (multi-node.test.js:233-350)."""
    from zkstream_tpu_torch.protocol.consts import CreateFlag

    leader, (f1, f2) = process_ensemble
    others = [('127.0.0.1', f2.ports[0]), ('127.0.0.1', leader.ports[0])]
    c1 = _client([('127.0.0.1', f1.ports[0])] + others)
    c2 = _client(list(reversed(others)))
    events: list[str] = []
    for ev in ('session', 'connect', 'disconnect', 'expire', 'failed'):
        c1.on(ev, lambda *a, ev=ev: events.append(ev))
    try:
        await c1.wait_connected(timeout=10)
        await c2.wait_connected(timeout=10)
        sid = c1.session.get_session_id()
        await c1.create('/eph', b'mine', flags=CreateFlag.EPHEMERAL)
        await c1.create('/watched', b'v0')

        fired: asyncio.Future = asyncio.get_running_loop().create_future()

        def on_change(*a):
            if not fired.done():
                fired.set_result(a)

        c1.watcher('/watched').on('dataChanged', on_change)
        await asyncio.sleep(0.3)       # arm (and swallow arm-time emit)
        events.clear()

        # the OS, not a cooperative close, severs the connection
        os.kill(f1.proc.pid, signal.SIGKILL)
        f1.proc.wait()

        # the session resumes on a surviving member within the timeout
        st = await _retrying(lambda: c1.stat('/eph'))
        assert st is not None
        assert c1.session.get_session_id() == sid, \
            'session did not survive the SIGKILL'
        assert 'disconnect' in events and 'connect' in events, events
        assert 'expire' not in events and 'session' not in events, events

        # the ephemeral survives — its session never expired
        data, _ = await c2.get('/eph')
        assert data == b'mine'

        # the re-armed watch still fires, through the new member
        await c2.set('/watched', b'v1')
        got = await asyncio.wait_for(fired, 10)
        assert got, 'watch lost across the SIGKILL failover'
        data, _ = await c1.get('/watched')
        assert data == b'v1'
    finally:
        await c1.close()
        await c2.close()


async def test_process_members_replicate_and_sync(process_ensemble):
    """Plumbing check for the tier itself: a write through one OS
    process is readable through another after sync, and sequential
    numbering stays leader-global across processes."""
    from zkstream_tpu_torch.protocol.consts import CreateFlag

    leader, (f1, f2) = process_ensemble
    c1 = _client([('127.0.0.1', f1.ports[0])])
    c2 = _client([('127.0.0.1', f2.ports[0])])
    try:
        await c1.wait_connected(timeout=10)
        await c2.wait_connected(timeout=10)
        await c1.create('/x', b'hello')
        await c2.sync('/x')
        data, stat = await c2.get('/x')
        assert data == b'hello' and stat.version == 0
        p1 = await c1.create('/s-', b'', flags=CreateFlag.SEQUENTIAL)
        p2 = await c2.create('/s-', b'', flags=CreateFlag.SEQUENTIAL)
        assert p1 == '/s-0000000000' and p2 == '/s-0000000001'
        await c1.set('/x', b'world')
        await c2.sync('/x')
        data, stat = await c2.get('/x')
        assert data == b'world' and stat.version == 1

        # push past LOG_TRUNC_CHUNK commits so the leader's truncation
        # sweep runs UNDER the control-channel piggyback: acks (not
        # shipments) gate the floor, so forwarded writes must keep
        # working throughout
        for i in range(300):
            await c1.set('/x', b'w%d' % i)
        await c2.sync('/x')
        data, stat = await c2.get('/x')
        assert data == b'w299' and stat.version == 301
    finally:
        await c1.close()
        await c2.close()


async def test_killed_follower_replaced_by_fresh_process(
        process_ensemble):
    """The restart half of the reference experiment
    (multi-node.test.js restarts a killed server): after SIGKILLing a
    follower, a replacement follower process joins the live ensemble
    late — bootstrapped from the leader's snapshot — and serves the
    full tree to clients."""
    leader, (f1, f2) = process_ensemble
    c = _client([('127.0.0.1', f1.ports[0])])
    try:
        await c.wait_connected(timeout=10)
        for i in range(5):
            await c.create('/pre%d' % i, b'v%d' % i)
    finally:
        await c.close()

    os.kill(f1.proc.pid, signal.SIGKILL)
    f1.proc.wait()

    # a replacement member, joining AFTER history began
    f3 = _spawn('follower', '127.0.0.1', str(leader.ports[1]))
    try:
        c3 = _client([('127.0.0.1', f3.ports[0])])
        try:
            await c3.wait_connected(timeout=10)
            await c3.sync('/pre0')
            for i in range(5):
                data, _ = await c3.get('/pre%d' % i)
                assert data == b'v%d' % i
            # and it serves writes + watches like any member
            await c3.create('/via3', b'x')
            data, _ = await c3.get('/via3')
            assert data == b'x'
        finally:
            await c3.close()
    finally:
        f3.proc.kill()
        f3.proc.wait()
        f3.proc.stdout.close()


@pytest.mark.timeout(120)
async def test_leader_sigkill_restart_from_disk(tmp_path):
    """The durability plane's headline at the OS-process tier: the
    LEADER process — the quorum itself, whose death previously lost
    every acked write — is SIGKILLed and respawned over its WAL dir
    (server/persist.py), and every acked write is back.  Two
    generations deep, so recovery-of-a-recovered-log is covered."""
    wal_dir = str(tmp_path / 'leader-wal')
    leader = _spawn('leader', wal_dir)
    c = _client([('127.0.0.1', leader.ports[0])])
    try:
        await c.wait_connected(timeout=10)
        for i in range(10):
            await c.create('/d%d' % i, b'gen0-%d' % i)
        await c.set('/d0', b'gen0-final')
    finally:
        await c.close()

    # the OS severs everything; RAM is gone
    os.kill(leader.proc.pid, signal.SIGKILL)
    leader.proc.wait()
    leader.proc.stdout.close()

    leader2 = _spawn('leader', wal_dir)
    c2 = _client([('127.0.0.1', leader2.ports[0])])
    try:
        await c2.wait_connected(timeout=10)
        data, stat = await c2.get('/d0')
        assert bytes(data) == b'gen0-final' and stat.version == 1
        for i in range(1, 10):
            data, _ = await c2.get('/d%d' % i)
            assert bytes(data) == b'gen0-%d' % i
        await c2.create('/gen1', b'after-recovery')
    finally:
        await c2.close()

    os.kill(leader2.proc.pid, signal.SIGKILL)
    leader2.proc.wait()
    leader2.proc.stdout.close()

    leader3 = _spawn('leader', wal_dir)
    c3 = _client([('127.0.0.1', leader3.ports[0])])
    try:
        await c3.wait_connected(timeout=10)
        data, _ = await c3.get('/gen1')
        assert bytes(data) == b'after-recovery'
        data, _ = await c3.get('/d0')
        assert bytes(data) == b'gen0-final'
    finally:
        await c3.close()
        leader3.proc.kill()
        leader3.proc.wait()
        leader3.proc.stdout.close()


@pytest.mark.timeout(120)
async def test_follower_sigkill_rejoins_from_recovered_zxid(
        process_ensemble, tmp_path):
    """A follower with its own mirror WAL is SIGKILLed and respawned
    over the same dir: it recovers its tree from disk and rejoins
    with the recovered zxid as the replication catch-up base (tail
    resync) — then serves the full tree, pre- and post-outage writes
    included."""
    leader, (f1, f2) = process_ensemble
    wal_dir = str(tmp_path / 'follower-wal')
    fw = _spawn('follower', '127.0.0.1', str(leader.ports[1]),
                wal_dir)
    try:
        c = _client([('127.0.0.1', fw.ports[0])])
        try:
            await c.wait_connected(timeout=10)
            for i in range(6):
                await c.create('/pre%d' % i, b'p%d' % i)
            await c.sync('/pre0')
        finally:
            await c.close()

        os.kill(fw.proc.pid, signal.SIGKILL)
        fw.proc.wait()
        fw.proc.stdout.close()

        # the follower's WAL captured the mirrored history
        from zkstream_tpu_torch.server.persist import recover_state
        rec = recover_state(wal_dir)
        assert rec.zxid >= 6, rec.zxid

        # writes land while it is down (via another member)
        c2 = _client([('127.0.0.1', f2.ports[0])])
        try:
            await c2.wait_connected(timeout=10)
            for i in range(3):
                await c2.create('/during%d' % i, b'd%d' % i)
        finally:
            await c2.close()

        fw = _spawn('follower', '127.0.0.1', str(leader.ports[1]),
                    wal_dir)
        c3 = _client([('127.0.0.1', fw.ports[0])])
        try:
            await c3.wait_connected(timeout=10)
            await c3.sync('/pre0')
            for i in range(6):
                data, _ = await c3.get('/pre%d' % i)
                assert bytes(data) == b'p%d' % i
            for i in range(3):
                data, _ = await c3.get('/during%d' % i)
                assert bytes(data) == b'd%d' % i
        finally:
            await c3.close()
    finally:
        if fw.proc.poll() is None:
            fw.proc.kill()
        fw.proc.wait()
        if not fw.proc.stdout.closed:
            fw.proc.stdout.close()


@pytest.mark.timeout(120)
async def test_rolling_sigkill_chaos_soak(process_ensemble):
    """Tier-4 chaos on the process tier: SIGKILL the member serving
    the session, twice in a row (the client's preference order makes
    the serving member deterministic: f1, then f2, then the leader
    member), with replacement followers joining the live ensemble
    mid-churn via snapshot bootstrap — one client session and its
    ephemeral live through every generation.  The reference's
    kill/restart cycling, compressed (multi-node.test.js:309-338)."""
    from zkstream_tpu_torch.protocol.consts import CreateFlag

    leader, (f1, f2) = process_ensemble
    spawned: list = []
    c = _client([('127.0.0.1', f1.ports[0]),
                 ('127.0.0.1', f2.ports[0]),
                 ('127.0.0.1', leader.ports[0])],
                session_timeout=15000)
    try:
        await c.wait_connected(timeout=10)
        sid = c.session.get_session_id()
        await c.create('/soak-eph', b'alive',
                       flags=CreateFlag.EPHEMERAL)
        for gen, victim in enumerate((f1, f2)):
            # kill the member the session is being served through
            os.kill(victim.proc.pid, signal.SIGKILL)
            victim.proc.wait()
            # ...while a replacement joins the live ensemble
            nxt = _spawn('follower', '127.0.0.1', str(leader.ports[1]))
            spawned.append(nxt)
            st = await _retrying(lambda: c.stat('/soak-eph'),
                                 attempts=40)
            assert st is not None
            assert c.session.get_session_id() == sid, \
                'session lost at generation %d' % gen
            await c.set('/soak-eph', b'gen%d' % gen)
        # the replacements serve the whole churned tree to new clients
        c2 = _client([('127.0.0.1', spawned[-1].ports[0])])
        try:
            await c2.wait_connected(timeout=10)
            await c2.sync('/soak-eph')
            data, _ = await c2.get('/soak-eph')
            assert data == b'gen1'
        finally:
            await c2.close()
    finally:
        await c.close()
        for m in spawned:
            if m.proc.poll() is None:
                m.proc.kill()
            m.proc.wait()
            m.proc.stdout.close()


async def _scrape_trce(port: int) -> dict:
    import json

    reader, writer = await asyncio.open_connection('127.0.0.1', port)
    try:
        writer.write(b'trce')
        await writer.drain()
        return json.loads(await asyncio.wait_for(reader.read(), 5))
    finally:
        writer.close()


async def test_trce_scrape_merges_cross_process_timeline(
        process_ensemble):
    """Acceptance (OS-process tier): a watched write through a
    follower process leaves a zxid-keyed span chain spanning real
    processes — client submit, leader commit + replication push,
    follower apply, fan-out delivery — reassembled by scraping every
    member's `trce` admin word over raw TCP and merging by zxid."""
    from zkstream_tpu_torch.utils.trace import (
        format_timeline,
        merge_timelines,
    )

    leader, (f1, f2) = process_ensemble
    c = _client([('127.0.0.1', f1.ports[0])])
    try:
        await c.wait_connected(timeout=10)
        await c.create('/xproc', b'v0')

        fires: list = []
        fired = asyncio.get_running_loop().create_future()

        def on_change(*a):
            fires.append(a)
            if len(fires) >= 2 and not fired.done():
                fired.set_result(None)
        c.watcher('/xproc').on('dataChanged', on_change)
        await asyncio.sleep(0.3)      # armed; arm-time emit delivered
        stat = await c.set('/xproc', b'v1')
        zxid = stat.mzxid
        await asyncio.wait_for(fired, 10)
        await c.sync('/xproc')

        rings = {'client': c.trace.dump()}
        for port in (leader.ports[0], f1.ports[0], f2.ports[0]):
            dump = await _scrape_trce(port)
            assert dump['trace_schema'] == 2
            rings['member:%s' % (dump['member'],)] = dump['spans']
        merged = merge_timelines(rings)
        sel = [(e['source'], e['op']) for e in merged
               if e['zxid'] == zxid]
        assert ('client', 'SET_DATA') in sel, sel
        assert ('member:leader', 'COMMIT') in sel, sel
        assert any(src == 'member:leader' and op == 'REPL_PUSH'
                   for src, op in sel), sel
        appliers = {src for src, op in sel
                    if op == 'APPLY'
                    and src.startswith('member:follower-')}
        assert len(appliers) == 2, sel   # both follower processes
        assert any(op == 'FANOUT'
                   and src.startswith('member:follower-')
                   for src, op in sel), sel
        # causal order within the zxid group: submit before commit
        # before push before any apply
        ops = [op for _src, op in sel]
        assert ops.index('SET_DATA') < ops.index('COMMIT') \
            < ops.index('REPL_PUSH') < ops.index('APPLY')
        assert format_timeline(merged)
    finally:
        await c.close()


@pytest.mark.timeout(240)
async def test_election_kill_loop_and_full_sigkill_generations():
    """The election plane's OS-process acceptance, via the exact
    seeded driver `zkstream_tpu_torch chaos --tier process --seed N` runs
    (server/election.py run_process_schedule): three symmetric peer
    members; the elected leader is SIGKILLed twice and each survivor
    set elects a successor at a strictly higher epoch with no
    operator; then the WHOLE ensemble is SIGKILLed twice and each
    generation elects from recovered WALs alone — every acked write
    intact, invariant 7 (one leader per epoch, epochs monotone)
    checked over the recorded history."""
    from zkstream_tpu_torch.server.election import run_process_schedule

    r = await on_free_ports(lambda: run_process_schedule(
        seed=5, ops=3, elections=2, generations=2))
    assert r.ok, r.violations
    # initial + 2 forced + 2 full-ensemble generations
    assert r.elections >= 5, r.history
    epochs = [rec['epoch'] for rec in r.history
              if rec['kind'] == 'election']
    assert epochs == sorted(epochs) and len(set(epochs)) == len(epochs)
    assert epochs[-1] >= 5
    assert r.acked > 0


@pytest.mark.timeout(240)
async def test_process_tier_cached_clients_survive_leader_kills():
    """The cache plane's OS-process slice (`chaos --tier process
    --cached`): the seeded election schedule's clients run with the
    watch-backed client cache on (cache='/') — leader SIGKILLs force
    the cache through connection loss, SET_WATCHES2 replay and
    resync, and every acked write must still read back correctly
    through the (possibly cached) read path; invariant 7 and the
    final read-back hold as in the uncached schedule."""
    from zkstream_tpu_torch.server.election import run_process_schedule

    r = await on_free_ports(lambda: run_process_schedule(
        seed=5, ops=3, elections=1, generations=1, cached=True))
    assert r.ok, r.violations
    assert r.elections >= 2, r.history
    assert r.acked > 0


@pytest.mark.timeout(120)
async def test_member_worker_role_via_test_worker():
    """The tests/ worker's `member` role delegates to the package
    worker: one single-member 'ensemble' elects itself leader from an
    empty WAL and serves clients."""
    from zkstream_tpu_torch.server.election import allocate_ports

    with tempfile.TemporaryDirectory() as wal_dir:
        async def start():
            cport, eport = allocate_ports(2)
            return _spawn('member', '0', wal_dir, str(cport), str(eport))
        m = await on_free_ports(start)
        try:
            c = _client([('127.0.0.1', m.ports[0])])
            try:
                await c.wait_connected(timeout=15)
                await c.create('/solo', b'x')
                data, _ = await c.get('/solo')
                assert data == b'x'
            finally:
                await c.close()
        finally:
            m.proc.kill()
            m.proc.wait()
            m.proc.stdout.close()



# -- state across packages: a full-ensemble SIGKILL over the WALs ------

@pytest.mark.timeout(150)
@pytest.mark.parametrize('first', ['reference', 'port'])
async def test_full_sigkill_recovers_across_packages(first):
    """Generation 1: three member processes of one package (the JAX
    package's ``server/member_worker.py`` or the port's) over fresh WAL
    directories; a port client's writes are acked through the elected
    leader; then every member is SIGKILLed.  Generation 2: three members
    of the other package over the same directories must elect a leader
    from the recovered WALs alone, at a higher epoch, and serve every
    acknowledged write.  The two packages never share a running
    ensemble: the WAL is the only state that crosses."""
    from zkstream_tpu.server import election as ref_election
    from zkstream_tpu_torch.server import election

    gens = ((ref_election, election) if first == 'reference'
            else (election, ref_election))

    async def run():
        acked = {}
        with tempfile.TemporaryDirectory() as root:
            epoch = 0
            for gen, mod in enumerate(gens):
                ports = mod.allocate_ports(6)
                fleet = [mod.ProcMember(i, os.path.join(root, 'm%d' % i),
                                        ports[2 * i], ports[2 * i + 1])
                         for i in range(3)]
                try:
                    for m in fleet:
                        m.spawn(fleet)
                    for m in fleet:
                        await m.wait_ready()
                    leader, new_epoch = await mod.find_leader(
                        fleet, min_epoch=epoch + 1)
                    assert new_epoch > epoch
                    epoch = new_epoch
                    lead = [('127.0.0.1', fleet[leader].client_port)]
                    c = _client(lead + [('127.0.0.1', m.client_port)
                                        for m in fleet
                                        if m.member_id != leader])
                    try:
                        await c.wait_connected(timeout=20)
                        await _retrying(lambda: c.sync('/'))
                        for path, data in sorted(acked.items()):
                            got, _ = await _retrying(
                                lambda p=path: c.get(p))
                            assert bytes(got) == data, (gen, path)
                        for i in range(8):
                            path, data = '/g%d-%d' % (gen, i), b'v%d' % i
                            await _retrying(
                                lambda p=path, d=data: c.create(p, d))
                            acked[path] = data
                        await _retrying(lambda: c.set(
                            '/g0-0', b'gen%d' % (gen,)))
                        acked['/g0-0'] = b'gen%d' % (gen,)
                    finally:
                        await c.close()
                finally:
                    for m in fleet:         # the whole ensemble: SIGKILL
                        m.kill()
        return acked

    # a member that loses its port to the bind-then-close race runs the
    # whole test again, two generations in a fresh directory
    acked = await on_free_ports(run)
    assert len(acked) == 16


# -- the member worker (this file run as a script) --------------------

async def run_leader(wal_dir: str | None = None,
                     sync: str = 'tick') -> None:
    from zkstream_tpu_torch.server.replication import ReplicationService
    from zkstream_tpu_torch.server.server import ZKServer
    from zkstream_tpu_torch.server.store import ZKDatabase

    if wal_dir:
        from zkstream_tpu_torch.server.persist import open_wal_database
        db = open_wal_database(wal_dir, sync=sync)
    else:
        db = ZKDatabase()
    # member id 'leader': what the trce admin word / merged causal
    # timeline names this process's span ring by
    member = await ZKServer(db, member='leader').start()
    repl = await ReplicationService(db).start()
    print('READY %d %d' % (member.port, repl.port), flush=True)
    await asyncio.Event().wait()


async def run_follower(leader_host: str, leader_port: int,
                       wal_dir: str | None = None,
                       sync: str = 'tick') -> None:
    from zkstream_tpu_torch.server.replication import (
        RemoteLeader,
        RemoteReplicaStore,
    )
    from zkstream_tpu_torch.server.server import ZKServer

    recovered = None
    have_zxid = None
    if wal_dir:
        from zkstream_tpu_torch.server.persist import recover_state
        rec = recover_state(wal_dir)
        if rec.last_index or rec.snapshot_index >= 0:
            recovered = {'zxid': rec.zxid, 'nodes': rec.nodes}
            have_zxid = rec.zxid
    remote = await RemoteLeader(leader_host, leader_port,
                                have_zxid=have_zxid).connect()
    store = RemoteReplicaStore(remote, lag=0.0, recovered=recovered)
    if wal_dir:
        from zkstream_tpu_torch.server.persist import (
            WriteAheadLog,
            entry_zxid,
            reset_dir,
        )
        if not remote.resynced:
            # snapshot bootstrap (or fresh join): the on-disk history
            # is stale relative to the installed image
            reset_dir(wal_dir)
        wal = WriteAheadLog(wal_dir, sync=sync)
        wal.bind(store)
        wal.snapshot_gate = (
            lambda: store.applied == remote.log_end())
        with remote._mirror_lock:
            # entries mirrored while connecting predate the WAL attach
            for e in remote.log:
                if entry_zxid(e) > wal.last_zxid:
                    wal.append(e)
            remote.wal = wal
        if not remote.resynced:
            wal.snapshot_now()
    # pid-qualified member id: two followers of one ensemble must not
    # collapse into one source in the merged timeline
    member = await ZKServer(remote, store=store,
                            member='follower-%d' % os.getpid()).start()
    print('READY %d' % (member.port,), flush=True)
    await asyncio.Event().wait()


async def spawn_times(n: int) -> list[float]:
    """Spawn-to-READY of ``n`` single-member port ensembles, ms."""
    import time

    from zkstream_tpu_torch.server.election import (
        ProcMember,
        allocate_ports,
    )

    out = []
    for _ in range(n):
        with tempfile.TemporaryDirectory() as wal_dir:
            cport, eport = allocate_ports(2)
            m = ProcMember(0, wal_dir, cport, eport)
            t0 = time.perf_counter()
            m.spawn([m])
            try:
                await m.wait_ready()
                out.append((time.perf_counter() - t0) * 1e3)
            finally:
                m.kill()
    return out


def main() -> int:
    if _ROOT not in sys.path:
        sys.path.insert(0, _ROOT)
    role = sys.argv[1]
    if role == 'leader':
        asyncio.run(run_leader(*sys.argv[2:4]))
    elif role == 'member':
        from zkstream_tpu_torch.server import member_worker
        sys.argv = sys.argv[1:]       # member_worker parses from [1]
        return member_worker.main()
    elif role == 'spawn-time':
        import statistics

        ms = asyncio.run(spawn_times(int(sys.argv[2]) if len(sys.argv) > 2
                                     else 10))
        print('member spawn-to-READY ms: %s' % (
            ' '.join('%.1f' % x for x in ms),))
        print('median %.1f  min %.1f  max %.1f  (n=%d)'
              % (statistics.median(ms), min(ms), max(ms), len(ms)))
    else:
        assert role == 'follower', role
        asyncio.run(run_follower(sys.argv[2], int(sys.argv[3]),
                                 *sys.argv[4:6]))
    return 0


if __name__ == '__main__':
    sys.exit(main())
