"""Single-server integration tests of the port's ``Client``: the port
of tests/test_basic.py (itself the equivalent of the reference's
test/basic.test.js).  Every case that talks to a server runs twice, on
the port's in-process ``ZKServer`` and on the JAX package's, on the same
dials: the port's client must behave the same against both.

The ``server_cls``, ``server`` and ``ensemble_cls`` fixtures here are
shared by the port's other server-facing suites (tests/test_torch_*.py
import them).
"""

import asyncio
import importlib

import pytest

from zkstream_tpu.server import ZKEnsemble as RefZKEnsemble
from zkstream_tpu.server import ZKServer as RefZKServer
from zkstream_tpu_torch import Client, CreateFlag, ZKError, ZKNotConnectedError
from zkstream_tpu_torch.server import ZKEnsemble as PortZKEnsemble
from zkstream_tpu_torch.server import ZKServer as PortZKServer

SERVERS = {'port': PortZKServer, 'reference': RefZKServer}
ENSEMBLES = {'port': PortZKEnsemble, 'reference': RefZKEnsemble}


@pytest.fixture(params=sorted(SERVERS))
def server_cls(request):
    """The server class a server-facing case runs against: the port's
    ``ZKServer`` or the JAX package's."""
    return SERVERS[request.param]


@pytest.fixture(params=sorted(ENSEMBLES))
def ensemble_cls(request):
    """The in-process ensemble class a case runs against: the port's
    ``ZKEnsemble`` or the JAX package's (the clients are the port's
    either way)."""
    return ENSEMBLES[request.param]


def pkg_attr(obj, dotted: str):
    """``dotted`` (e.g. ``'server.store.ZKOpError'``) from the package
    ``obj``'s class belongs to: what a server-side raise of the port's
    or the reference's ensemble is an instance of."""
    pkg = type(obj).__module__.split('.')[0]
    mod, _, name = dotted.rpartition('.')
    return getattr(importlib.import_module(pkg + '.' + mod), name)


@pytest.fixture
def server(event_loop, server_cls):
    """One in-process server of ``server_cls`` per test."""
    srv = event_loop.run_until_complete(server_cls().start())
    yield srv
    event_loop.run_until_complete(srv.stop())


@pytest.fixture
def client(event_loop, server):
    async def setup():
        c = Client(address='127.0.0.1', port=server.port,
                   session_timeout=5000)
        c.start()
        await c.wait_connected(timeout=5)
        return c
    c = event_loop.run_until_complete(setup())
    yield c
    event_loop.run_until_complete(c.close())


def make_client(server, **kw):
    kw.setdefault('session_timeout', 5000)
    c = Client(address='127.0.0.1', port=server.port, **kw)
    c.start()
    return c


async def test_servers_accepts_dicts(server):
    """servers[] takes {'address', 'port'} dicts like the reference's
    address/port objects (reference: lib/client.js:63-76)."""
    c = Client(servers=[{'address': '127.0.0.1', 'port': server.port}],
               session_timeout=5000)
    c.start()
    await c.wait_connected(timeout=5)
    await c.ping()
    await c.close()


async def test_connect_ping_close(server):
    c = make_client(server)
    events = []
    c.on('session', lambda: events.append('session'))
    c.on('connect', lambda: events.append('connect'))
    await c.wait_connected(timeout=5)
    latency = await c.ping()
    assert latency >= 0
    await c.close()
    assert 'session' in events
    assert 'connect' in events


async def test_create_get_roundtrip(client):
    path = await client.create('/hello', b'world')
    assert path == '/hello'
    data, stat = await client.get('/hello')
    assert data == b'world'
    assert stat.version == 0
    assert stat.dataLength == 5


async def test_get_nonexistent_fails(client):
    with pytest.raises(ZKError) as ei:
        await client.get('/nope')
    assert ei.value.code == 'NO_NODE'


async def test_double_create_fails(client):
    await client.create('/dup', b'x')
    with pytest.raises(ZKError) as ei:
        await client.create('/dup', b'y')
    assert ei.value.code == 'NODE_EXISTS'


async def test_set_and_version_bump(client):
    await client.create('/v', b'a')
    stat = await client.set('/v', b'b')
    assert stat.version == 1
    data, stat2 = await client.get('/v')
    assert data == b'b'
    assert stat2.version == 1


async def test_set_bad_version(client):
    await client.create('/bv', b'a')
    with pytest.raises(ZKError) as ei:
        await client.set('/bv', b'x', version=99)
    assert ei.value.code == 'BAD_VERSION'


async def test_delete_with_version_check(client):
    await client.create('/del', b'a')
    await client.set('/del', b'b')  # version now 1
    with pytest.raises(ZKError) as ei:
        await client.delete('/del', 0)
    assert ei.value.code == 'BAD_VERSION'
    await client.delete('/del', 1)
    with pytest.raises(ZKError) as ei:
        await client.get('/del')
    assert ei.value.code == 'NO_NODE'


async def test_stat(client):
    await client.create('/st', b'abc')
    stat = await client.stat('/st')
    assert stat.dataLength == 3
    assert stat.version == 0
    with pytest.raises(ZKError):
        await client.stat('/missing')


async def test_list_children(client):
    await client.create('/parent', b'')
    await client.create('/parent/a', b'')
    await client.create('/parent/b', b'')
    children, stat = await client.list('/parent')
    assert sorted(children) == ['a', 'b']
    assert stat.numChildren == 2


async def test_get_acl(client):
    await client.create('/acl', b'')
    acl = await client.get_acl('/acl')
    assert len(acl) == 1
    assert acl[0].id.scheme == 'world'
    assert acl[0].id.id == 'anyone'


async def test_sync(client):
    await client.sync('/')


async def test_large_payload_9kb(client):
    # Reference exercises a 9000-byte znode (test/basic.test.js:613-642).
    payload = bytes(i % 251 for i in range(9000))
    await client.create('/big', payload)
    data, stat = await client.get('/big')
    assert data == payload
    assert stat.dataLength == 9000


async def test_megabyte_payload_all_codec_paths(server):
    """A 1 MiB znode (ZooKeeper's jute.maxbuffer default) round-trips
    through every receive path: scalar codec, C extension, and fleet
    ingest — the frame spans many TCP segments, so this exercises
    large-buffer reassembly in each."""
    from zkstream_tpu_torch import Client
    from zkstream_tpu_torch.io.ingest import FleetIngest

    payload = bytes(i % 251 for i in range(1 << 20))
    configs = [
        dict(use_native_codec=False),
        dict(use_native_codec=None),       # ext when built
        dict(ingest=FleetIngest(device='cpu', body_mode='host',
                                max_frames=4, bypass_bytes=0,
                                warm='block')),
    ]
    for i, kw in enumerate(configs):
        c = Client(address='127.0.0.1', port=server.port,
                   session_timeout=10000, **kw)
        c.start()
        try:
            await c.wait_connected(timeout=10)
            path = '/mb%d' % i
            await c.create(path, payload)
            data, stat = await c.get(path)
            assert data == payload
            assert stat.dataLength == len(payload)
        finally:
            await c.close()


async def test_ephemeral_and_sequential(client, server):
    path = await client.create(
        '/eseq', b'x', flags=CreateFlag.EPHEMERAL | CreateFlag.SEQUENTIAL)
    assert path == '/eseq0000000000'
    path2 = await client.create(
        '/eseq', b'x', flags=CreateFlag.SEQUENTIAL)
    assert path2 == '/eseq0000000001'
    stat = await client.stat(path)
    assert stat.ephemeralOwner != 0


async def test_ephemeral_deleted_on_close(server):
    c1 = make_client(server)
    await c1.wait_connected(timeout=5)
    await c1.create('/eph', b'x', flags=CreateFlag.EPHEMERAL)
    c2 = make_client(server)
    await c2.wait_connected(timeout=5)
    stat = await c2.stat('/eph')
    assert stat.ephemeralOwner != 0
    await c1.close()
    await asyncio.sleep(0.1)
    with pytest.raises(ZKError) as ei:
        await c2.stat('/eph')
    assert ei.value.code == 'NO_NODE'
    await c2.close()


async def test_no_children_for_ephemerals(client):
    await client.create('/ephp', b'', flags=CreateFlag.EPHEMERAL)
    with pytest.raises(ZKError) as ei:
        await client.create('/ephp/kid', b'')
    assert ei.value.code == 'NO_CHILDREN_FOR_EPHEMERALS'


async def test_create_with_empty_parents(client):
    path = await client.create_with_empty_parents('/a/b/c/d', b'leaf')
    assert path == '/a/b/c/d'
    data, _ = await client.get('/a/b/c/d')
    assert data == b'leaf'
    # Parents are plain persistent nodes with b'null' data.
    data, _ = await client.get('/a/b')
    assert data == b'null'


async def test_create_with_empty_parents_existing_parents_ok(client):
    await client.create('/p1', b'keep')
    path = await client.create_with_empty_parents('/p1/x/y', b'v')
    assert path == '/p1/x/y'
    # Existing parent data untouched.
    data, _ = await client.get('/p1')
    assert data == b'keep'


async def test_create_with_empty_parents_leaf_exists_fails(client):
    await client.create_with_empty_parents('/q/r', b'v')
    with pytest.raises(ZKError) as ei:
        await client.create_with_empty_parents('/q/r', b'v2')
    assert ei.value.code == 'NODE_EXISTS'


async def test_create_with_empty_parents_leaf_flags_only(client):
    # Flags apply to the leaf only: parents are persistent.
    path = await client.create_with_empty_parents(
        '/e1/e2/leaf', b'v', flags=CreateFlag.EPHEMERAL)
    stat = await client.stat(path)
    assert stat.ephemeralOwner != 0
    pstat = await client.stat('/e1/e2')
    assert pstat.ephemeralOwner == 0


async def test_not_connected_error(server):
    c = Client(address='127.0.0.1', port=server.port)
    # Never started: no connection.
    with pytest.raises(ZKNotConnectedError):
        await c.get('/x')


async def test_delete_nonempty_fails(client):
    await client.create('/ne', b'')
    await client.create('/ne/kid', b'')
    with pytest.raises(ZKError) as ei:
        await client.delete('/ne', -1)
    assert ei.value.code == 'NOT_EMPTY'
