"""The port of tests/test_chaos.py, on the port's fault plane; every case
on an in-process server or ensemble runs twice, on the port's and on
the JAX package's, with the port's clients (the campaigns and process
members are the port's alone).

Seeded fault-injection campaigns (io/faults.py) and the resilience
machinery they exercise: deadlines, degraded mode, jittered redial,
watcher re-arm under churn, session survival across member kills.

The campaign invariants (checked per schedule by
``faults.run_schedule``, seed printed on any failure):

- every client op completes or raises a typed error within its
  deadline — never a silent hang;
- no acked write is lost;
- no duplicated watch fire (same mzxid emitted twice);
- the schedule is a pure function of the seed (same seed => same
  fault plan).

Scale knobs: ``ZKSTREAM_CHAOS_SCHEDULES`` (total seeded schedules,
default 200) and ``ZKSTREAM_CHAOS_SEED`` (base seed, default 0) — the
``make chaos`` target runs a smaller, time-bounded slice."""

from __future__ import annotations

import asyncio
import os
import signal
import subprocess
import sys

import pytest

from helpers import wait_until
from zkstream_tpu_torch import Client, ZKDeadlineError, ZKProtocolError
from zkstream_tpu_torch.io.backoff import BackoffPolicy
from zkstream_tpu_torch.io.faults import (
    FaultConfig,
    FaultInjector,
    run_campaign,
)
from zkstream_tpu_torch.utils.trace import format_spans
from test_torch_basic import ensemble_cls, server, server_cls  # noqa: F401

BASE_SEED = int(os.environ.get('ZKSTREAM_CHAOS_SEED', '0'))
SCHEDULES = int(os.environ.get('ZKSTREAM_CHAOS_SCHEDULES', '200'))
BATCHES = 5
PER_BATCH = max(1, SCHEDULES // BATCHES)

FAST = dict(
    connect_policy=BackoffPolicy(timeout=300, retries=2, delay=30,
                                 cap=200),
    default_policy=BackoffPolicy(timeout=300, retries=2, delay=50,
                                 cap=400))


# -- determinism: same seed => same schedule ---------------------------

def test_same_seed_same_schedule():
    for seed in (0, 1, 7, 12345):
        a = FaultInjector.randomized(seed)
        b = FaultInjector.randomized(seed)
        assert a.config == b.config
        assert a.schedule_digest() == b.schedule_digest()
        # the per-category decision streams replay identically
        for cat in ('rx', 'tx', 'connect', 'plan'):
            assert [a.rand(cat) for _ in range(16)] == \
                [b.rand(cat) for _ in range(16)]


def test_different_seed_different_schedule():
    digests = {FaultInjector.randomized(s).schedule_digest()
               for s in range(32)}
    assert len(digests) == 32


def test_draws_consumed_even_when_fault_disabled():
    """Decision points always draw from their stream, so enabling a
    fault class never shifts the other classes' schedules."""
    on = FaultInjector(5, FaultConfig(p_rx_split=1.0, max_faults=2))
    off = FaultInjector(5, FaultConfig())
    data = b'x' * 64
    for inj in (on, off):
        inj.accept_refuse()
        inj.drop_push('t')
    # both consumed exactly one 'accept' and one 'partition' draw
    assert on._streams['accept'].random() == \
        off._streams['accept'].random()
    assert on._streams['partition'].random() == \
        off._streams['partition'].random()
    assert len(off.fired) == 0
    del data


# -- the 200-schedule randomized campaign ------------------------------
#
# The campaign runs with the outbound send plane in its default state:
# tick-corked write coalescing ENABLED on both the client and the
# in-process server (io/sendplane.py) — asserted below so a stray
# ZKSTREAM_NO_CORK in the test environment cannot silently weaken what
# these schedules exercise.  The cork-disabled slice lives in
# tests/test_sendplane.py.

def test_campaign_runs_with_coalescing_enabled():
    from zkstream_tpu_torch.io.sendplane import cork_default
    assert cork_default(), \
        'ZKSTREAM_NO_CORK must not be set for the tier-1 campaign'


def test_campaign_runs_with_watchtable_enabled():
    # same rationale for the sharded watch fan-out
    # (server/watchtable.py); the emitter-fallback slice lives in
    # tests/test_watchtable.py
    from zkstream_tpu_torch.server.watchtable import watchtable_default
    assert watchtable_default(), \
        'ZKSTREAM_NO_WATCHTABLE must not be set for the tier-1 campaign'


def test_campaign_runs_on_default_transport():
    # same rationale for the batched-syscall transport tier
    # (io/transport.py): the campaign must run the capability-probe
    # default, so the env force must be UNSET (probe().chosen folds
    # the force in, so comparing against it would pass any resolved
    # force) — forced-backend slices live in tests/test_transport.py
    import os
    assert os.environ.get('ZKSTREAM_TRANSPORT') in (None, ''), \
        'ZKSTREAM_TRANSPORT must not be set for the tier-1 campaign'


@pytest.mark.timeout(240)
@pytest.mark.parametrize('batch', range(BATCHES))
async def test_chaos_campaign(batch):
    results = await run_campaign(BASE_SEED + batch * PER_BATCH,
                                 PER_BATCH)
    bad = [r for r in results if not r.ok]
    assert not bad, 'chaos schedules failed; rerun any with ' \
        '`python -m zkstream_tpu_torch chaos --seed N --schedules 1`:\n' + \
        '\n'.join('seed %d: %s\n  span ring (oldest first):\n%s'
                  % (r.seed, '; '.join(r.violations),
                     format_spans(r.trace, limit=40))
                  for r in bad)


# -- deadlines ---------------------------------------------------------

async def test_deadline_raises_typed_error(server):
    c = Client(address='127.0.0.1', port=server.port,
               session_timeout=5000, **FAST)
    c.start()
    try:
        await c.wait_connected(timeout=5)
        await c.create('/d', b'x')
        server.drop_replies = True
        with pytest.raises(ZKDeadlineError) as ei:
            await asyncio.wait_for(c.get('/d', deadline=200), 5)
        assert ei.value.code == 'DEADLINE_EXCEEDED'
        assert isinstance(ei.value, ZKProtocolError)  # typed taxonomy
        assert ei.value.opcode == 'GET_DATA'
        assert ei.value.path == '/d'
    finally:
        server.drop_replies = False
        await c.close()


async def test_client_default_op_timeout_bounds_every_op(server):
    c = Client(address='127.0.0.1', port=server.port,
               session_timeout=5000, op_timeout=200, **FAST)
    c.start()
    try:
        await c.wait_connected(timeout=5)
        await c.create('/d2', b'x')
        server.drop_replies = True
        for op in (c.get('/d2'), c.set('/d2', b'y'),
                   c.list('/'), c.sync('/d2'), c.stat('/d2')):
            with pytest.raises(ZKDeadlineError):
                await asyncio.wait_for(op, 5)
    finally:
        server.drop_replies = False
        await c.close()


# -- degraded mode / circuit breaker -----------------------------------

async def test_degraded_mode_cycle(server_cls):
    """All backends down => one 'degraded' edge + gauge at 1; backend
    returns => 'recovered' edge, gauge at 0, client usable."""
    # grab a real free port, then kill the listener
    probe = await server_cls().start()
    port = probe.port
    await probe.stop()

    c = Client(address='127.0.0.1', port=port, session_timeout=5000,
               **FAST)
    events = []
    c.on('degraded', lambda: events.append('degraded'))
    c.on('recovered', lambda: events.append('recovered'))
    c.start()
    try:
        await wait_until(lambda: c.is_degraded(), timeout=10)
        assert events == ['degraded']
        assert c.pool.state == 'failed'
        gauge = c.collector.get_collector('zookeeper_degraded')
        assert 'zookeeper_degraded 1.0' in gauge.expose()

        # the backend comes back on the same port: monitor-mode redial
        # (jittered, capped) must recover without intervention
        srv = await server_cls(host='127.0.0.1', port=port).start()
        try:
            await wait_until(lambda: not c.is_degraded(), timeout=10)
            await c.wait_connected(timeout=10, fail_fast=False)
            assert events == ['degraded', 'recovered']
            assert 'zookeeper_degraded 0.0' in gauge.expose()
            await c.create('/back', b'alive')     # fully usable again
        finally:
            await c.close()
            await srv.stop()
    finally:
        if not c.is_in_state('closed'):
            await c.close()


async def test_degraded_event_counted_in_metrics(server_cls):
    probe = await server_cls().start()
    port = probe.port
    await probe.stop()
    c = Client(address='127.0.0.1', port=port, session_timeout=5000,
               **FAST)
    c.start()
    try:
        await wait_until(lambda: c.is_degraded(), timeout=10)
        ctr = c.collector.get_collector('zookeeper_events')
        assert ctr.value({'evtype': 'degraded'}) == 1.0
    finally:
        await c.close()


# -- ensemble: any single-member kill is survivable --------------------

@pytest.mark.timeout(120)
async def test_ensemble_single_member_kill_campaign(ensemble_cls):
    """Seeded campaign over the in-process 3-member ensemble: kill
    whichever member serves the session (injector-chosen reconnect
    latency active); the session must resume — same id — and a
    post-kill write must land, every time."""
    failures = []
    for seed in range(BASE_SEED, BASE_SEED + 8):
        inj = FaultInjector(seed, FaultConfig(
            connect_latency_ms=FaultInjector(seed).uniform(
                'plan', 0.0, 150.0)))
        ens = await ensemble_cls(3).start()
        c = Client(servers=ens.addresses(), shuffle_backends=False,
                   session_timeout=8000, op_timeout=2000, faults=inj,
                   **FAST)
        c.start()
        try:
            await c.wait_connected(timeout=10)
            sid = c.session.session_id
            await c.create('/k%d' % seed, b'pre')
            dying = c.current_connection()
            victim = next(i for i, s in enumerate(ens.servers)
                          if s.port == dying.backend.port)
            await ens.kill(victim)
            # the client notices the severed socket on its next loop
            # turn; only then is is_connected() trustworthy again
            await wait_until(
                lambda: not dying.is_in_state('connected'), timeout=10)
            # bounded: resume on a surviving member with the SAME id
            await wait_until(lambda: c.is_connected(), timeout=10)
            if c.session.session_id != sid:
                failures.append('seed %d: session id changed after '
                                'kill of member %d' % (seed, victim))
            # reconnect churn may still break an op or two (typed!);
            # retry bounded, like any real consumer of this client
            last = None
            for _ in range(20):
                try:
                    await asyncio.wait_for(
                        c.set('/k%d' % seed, b'post', version=-1), 10)
                    last = None
                    break
                except ZKProtocolError as e:
                    last = e
                    await asyncio.sleep(0.1)
            if last is not None:
                failures.append('seed %d: post-kill write never '
                                'landed: %r' % (seed, last))
                continue
            data, _ = await asyncio.wait_for(c.get('/k%d' % seed), 10)
            if bytes(data) != b'post':
                failures.append('seed %d: post-kill write lost'
                                % (seed,))
        except (asyncio.TimeoutError, TimeoutError) as e:
            failures.append('seed %d: hung/timed out: %r' % (seed, e))
        finally:
            inj.stop()
            try:
                await asyncio.wait_for(c.close(), 5)
            except (asyncio.TimeoutError, TimeoutError):
                c.pool.stop()
            await ens.stop()
            inj.close()
    assert not failures, '\n'.join(failures)


# -- replication: asymmetric partition ---------------------------------

@pytest.mark.timeout(60)
async def test_replication_survives_asymmetric_partition():
    """Leader->follower pushes dropped (follower->leader control alive):
    the follower's mirror stalls, but a sync barrier recovers every
    entry via the control-channel piggyback — no acked write lost."""
    from zkstream_tpu_torch.protocol.consts import CreateFlag
    from zkstream_tpu_torch.protocol.records import OPEN_ACL_UNSAFE
    from zkstream_tpu_torch.server.replication import (
        RemoteLeader,
        RemoteReplicaStore,
        ReplicationService,
    )
    from zkstream_tpu_torch.server.store import ZKDatabase

    db = ZKDatabase()
    svc = await ReplicationService(db).start()
    remote = await RemoteLeader('127.0.0.1', svc.port).connect()
    store = RemoteReplicaStore(remote, lag=0.0)
    try:
        # partition: every push to this follower drops
        svc.faults = FaultInjector(
            3, FaultConfig(p_push_drop=1.0, max_faults=None))
        for i in range(5):
            db.create('/p%d' % i, b'v%d' % i, list(OPEN_ACL_UNSAFE),
                      CreateFlag(0), None)
        await asyncio.sleep(0.05)      # pushes (all dropped) flushed
        assert '/p4' not in store.nodes, 'partition not effective'

        # heal direction-agnostically: the *control* channel was never
        # partitioned, so a sync barrier must recover everything
        await asyncio.get_running_loop().run_in_executor(
            None, store.sync_flush)
        for i in range(5):
            assert store.nodes['/p%d' % i].data == b'v%d' % i
    finally:
        svc.faults = None
        remote.close()
        await svc.stop()


# -- the acceptance scenario: SIGKILL + 500 ms reconnect latency -------

#: the port's member worker: tests/test_torch_process_ensemble.py run
#: as a script (leader / follower roles over the port's server stack)
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      'test_torch_process_ensemble.py')


def _spawn_member(*args: str):
    proc = subprocess.Popen(
        [sys.executable, WORKER, *args],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    line = proc.stdout.readline().strip()
    assert line.startswith('READY '), (args, line)
    return proc, [int(x) for x in line.split()[1:]]


@pytest.mark.timeout(120)
async def test_sigkill_during_inflight_write_with_reconnect_latency():
    """SIGKILL the OS process serving the session while a write is in
    flight, with 500 ms of injected reconnect latency: the session
    resumes (same id), and the write either acked-and-durable or
    raised a typed error — never a silent hang."""
    members = []
    try:
        leader, lports = _spawn_member('leader')
        members.append(leader)
        f1, f1ports = _spawn_member('follower', '127.0.0.1',
                                    str(lports[1]))
        members.append(f1)
        f2, f2ports = _spawn_member('follower', '127.0.0.1',
                                    str(lports[1]))
        members.append(f2)

        inj = FaultInjector(0, FaultConfig(connect_latency_ms=500.0))
        c1 = Client(servers=[('127.0.0.1', f1ports[0]),
                             ('127.0.0.1', f2ports[0]),
                             ('127.0.0.1', lports[0])],
                    shuffle_backends=False, session_timeout=12000,
                    op_timeout=3000, faults=inj)
        c1.start()
        c2 = Client(servers=[('127.0.0.1', lports[0])],
                    shuffle_backends=False, session_timeout=12000)
        c2.start()
        try:
            await c1.wait_connected(timeout=15)
            await c2.wait_connected(timeout=15)
            sid = c1.session.session_id
            assert c1.current_connection().backend.port == f1ports[0]
            await c1.create('/k', b'v0')

            # in-flight write, then SIGKILL the serving member
            dying = c1.current_connection()
            write = asyncio.get_running_loop().create_task(
                c1.set('/k', b'v1', version=-1))
            await asyncio.sleep(0.005)
            os.kill(f1.pid, signal.SIGKILL)
            f1.wait()

            acked = None
            try:
                # bounded: op deadline 3000 ms + scheduling slack; an
                # asyncio.TimeoutError here IS the silent-hang bug
                await asyncio.wait_for(write, 8)
                acked = True
            except ZKProtocolError:
                acked = False          # typed: loss/deadline — fine
            assert acked is not None

            # session resumption through the 500 ms-latency redial
            # (wait for the severed socket to be noticed first:
            # is_connected() reads the old conn until then)
            await wait_until(
                lambda: not dying.is_in_state('connected'), timeout=10)
            await wait_until(lambda: c1.is_connected(), timeout=20)
            assert c1.session.session_id == sid, \
                'session did not survive the SIGKILL'

            if acked:
                # acked => durable: visible through another member
                await c2.sync('/k')
                data, _ = await c2.get('/k')
                assert bytes(data) == b'v1', \
                    'acked write lost across SIGKILL failover'
            # either way the client is fully usable again (retry
            # through residual reconnect churn, typed errors only)
            for _ in range(20):
                try:
                    await asyncio.wait_for(
                        c1.set('/k', b'v2', version=-1), 10)
                    break
                except ZKProtocolError:
                    await asyncio.sleep(0.1)
            else:
                raise AssertionError('client unusable after failover')
        finally:
            await c1.close()
            await c2.close()
    finally:
        for m in members:
            if m.poll() is None:
                m.kill()
            m.wait()
            m.stdout.close()
