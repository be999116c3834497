"""The port of tests/test_spares.py, on the port's pool; every case on an
in-process server or ensemble runs twice, on the port's and on the JAX
package's, with the port's clients.

Warm-spare connection tests.

cueball keeps up to 3 connections with target 1
(reference: lib/client.js:108-109) so failover can skip dial+handshake;
the pool parks up to 2 pre-dialed spares and promotes the most-preferred
one when the live connection dies — asserted here by object identity:
the post-failover connection IS the pre-failover spare, so no TCP dial
happened for it.
"""

import pytest

from helpers import wait_until
from zkstream_tpu_torch import Client, CreateFlag
from test_torch_basic import ensemble_cls, server, server_cls  # noqa: F401


@pytest.fixture
def ensemble(event_loop, ensemble_cls):
    ens = event_loop.run_until_complete(ensemble_cls(3).start())
    yield ens
    event_loop.run_until_complete(ens.stop())


def make_client(ensemble, **kw):
    kw.setdefault('session_timeout', 5000)
    c = Client(servers=ensemble.addresses(), shuffle_backends=False, **kw)
    c.start()
    return c


async def test_spares_reach_target_and_park(ensemble):
    c = make_client(ensemble)
    try:
        await c.wait_connected(timeout=5)
        await wait_until(lambda: len(c.pool.spares) == 2, timeout=5)
        cur = c.current_connection().backend.key
        keys = {s.backend.key for s in c.pool.spares}
        assert cur not in keys and len(keys) == 2
        assert all(s.is_in_state('parked') for s in c.pool.spares)
    finally:
        await c.close()


async def test_failover_promotes_spare_without_dial(ensemble):
    """Kill the live backend: the replacement connection must be the
    pre-existing parked spare object (no fresh dial), the session must
    resume (same id), and an ephemeral must survive."""
    c = make_client(ensemble)
    try:
        await c.wait_connected(timeout=5)
        await wait_until(lambda: len(c.pool.spares) == 2, timeout=5)
        sid = c.session.session_id
        await c.create('/eph', b'', flags=CreateFlag.EPHEMERAL)

        spares_before = list(c.pool.spares)
        dials = []
        orig = c.pool._dial_one

        async def spy(backend, timeout_ms):
            dials.append(backend.key)
            return await orig(backend, timeout_ms)
        c.pool._dial_one = spy

        victim = c.current_connection().backend.key
        await ensemble.kill(ensemble.addresses().index(
            ('127.0.0.1', int(victim.rsplit(':', 1)[1]))))
        await wait_until(lambda: c.is_connected() and
                         c.current_connection().backend.key != victim,
                         timeout=5)
        assert c.current_connection() in spares_before
        assert dials == []          # promotion, not a fresh dial
        assert c.session.session_id == sid
        stat = await c.stat('/eph')
        assert stat.ephemeralOwner != 0
        # the spare pool tops back up (dials now expected/allowed)
        await wait_until(lambda: len(c.pool.spares) >= 1, timeout=5)
    finally:
        await c.close()


async def test_spare_death_topped_up(ensemble):
    c = make_client(ensemble)
    try:
        await c.wait_connected(timeout=5)
        await wait_until(lambda: len(c.pool.spares) == 2, timeout=5)
        dead = c.pool.spares[0]
        dead.transport.abort()
        await wait_until(
            lambda: dead not in c.pool.spares and
            len(c.pool.spares) == 2 and
            all(s.is_in_state('parked') for s in c.pool.spares),
            timeout=5)
    finally:
        await c.close()


async def test_single_backend_spare_promotion(server):
    """With one backend, a same-backend spare still skips the TCP dial
    when only the connection (not the server) dies."""
    c = Client(address='127.0.0.1', port=server.port,
               session_timeout=5000)
    c.start()
    try:
        await c.wait_connected(timeout=5)
        await wait_until(lambda: len(c.pool.spares) == 1, timeout=5)
        spare = c.pool.spares[0]
        sid = c.session.session_id
        # promotion is near-instant (no dial): watch the events, not
        # the connected flag, which may never be observed down
        disconnects = []
        c.on('disconnect', lambda: disconnects.append(True))
        c.current_connection().transport.abort()
        await wait_until(lambda: disconnects and c.is_connected(),
                         timeout=5)
        assert c.current_connection() is spare
        assert c.session.session_id == sid
        await c.ping()
    finally:
        await c.close()


async def test_spare_promotion_with_ingest(ensemble):
    """Spare promotion composes with the fleet ingest: the promoted
    connection registers with the ingest and traffic keeps flowing
    through the batched path (or its scalar bypass) after failover."""
    from zkstream_tpu_torch.io.ingest import FleetIngest

    ingest = FleetIngest(device='cpu', body_mode='host', max_frames=8)
    c = make_client(ensemble, ingest=ingest)
    try:
        await c.wait_connected(timeout=5)
        await wait_until(lambda: len(c.pool.spares) == 2, timeout=5)
        await c.create('/i', b'before')
        routed_before = ingest.frames_routed

        spare_objs = list(c.pool.spares)
        live_key = c.current_connection().backend.key
        idx = next(i for i, s in enumerate(ensemble.servers)
                   if ('%s:%d' % s.address) == live_key)
        await ensemble.kill(idx)
        await wait_until(
            lambda: (c.is_connected()
                     and c.current_connection() in spare_objs),
            timeout=10)

        data, _stat = await c.get('/i')
        assert data == b'before'
        # the promoted spare's replies went through the ingest
        assert ingest.frames_routed > routed_before
        assert id(c.current_connection()) in ingest._slots
    finally:
        await c.close()
