"""Persistent watches (ADD_WATCH / SET_WATCHES2) and the watch-backed
client cache plane of the port (io/cache.py; the port of
tests/test_cache.py), each on the port's server and on the JAX
package's.

The persistent-watch opcode family is NEW relative to the reference
(node-zkstream has no addWatch support); the tests pin the upstream
ZooKeeper semantics the implementation targets:

- PERSISTENT survives fires (no re-arm round trip), exact node, all
  four event types including childrenChanged;
- PERSISTENT_RECURSIVE survives fires, matches the node and every
  descendant, and delivers created/deleted/dataChanged only — a
  child's own CREATED/DELETED stands in for the parent's
  childrenChanged;
- SET_WATCHES2 replays the registrations across a session
  re-establishment, with catch-up nudges for changes that landed in
  the gap.

The cache plane rides the recursive stream: subscribe a subtree once,
serve reads locally, invalidate from notifications — with the session
read floor applying to cached reads verbatim.
"""

import asyncio

import pytest

from helpers import wait_until
from zkstream_tpu_torch import Client
from zkstream_tpu_torch.io.cache import cache_roots_default
from zkstream_tpu_torch.protocol.errors import ZKError
from test_torch_basic import server, server_cls  # noqa: F401


@pytest.fixture
def cached_pair(event_loop, server):
    """c1 caches the /app subtree; c2 is a plain writer client."""
    async def setup():
        c1 = Client(address='127.0.0.1', port=server.port,
                    session_timeout=5000, cache='/app')
        c2 = Client(address='127.0.0.1', port=server.port,
                    session_timeout=5000)
        for c in (c1, c2):
            c.start()
            await c.wait_connected(timeout=5)
        await wait_until(lambda: c1.cache.stats()['armed'] == 1)
        await c2.create('/app', b'root')
        return c1, c2
    cs = event_loop.run_until_complete(setup())
    yield cs
    for c in cs:
        event_loop.run_until_complete(c.close())


@pytest.fixture
def two_clients(event_loop, server):
    async def setup():
        cs = []
        for _ in range(2):
            c = Client(address='127.0.0.1', port=server.port,
                       session_timeout=5000)
            c.start()
            await c.wait_connected(timeout=5)
            cs.append(c)
        return cs
    cs = event_loop.run_until_complete(setup())
    yield cs
    for c in cs:
        event_loop.run_until_complete(c.close())


# -- persistent watches ------------------------------------------------

async def test_persistent_watch_survives_fires(two_clients):
    """The defining property: three data changes, three fires, zero
    re-arm round trips (a one-shot watch would deliver only the
    first)."""
    c1, c2 = two_clients
    await c1.create('/p', b'v0')
    seen = []
    w = await c1.add_watch('/p')
    w.on('dataChanged', lambda path, zxid: seen.append(zxid))
    for v in (b'v1', b'v2', b'v3'):
        await c2.set('/p', v, version=-1)
    await wait_until(lambda: len(seen) == 3)
    assert seen == sorted(seen)        # zxid order, no duplicates
    assert len(set(seen)) == 3


async def test_persistent_exact_all_event_types(two_clients):
    c1, c2 = two_clients
    events = []
    w = await c1.add_watch('/e')
    for evt in ('created', 'deleted', 'dataChanged',
                'childrenChanged'):
        w.on(evt, lambda path, zxid, e=evt: events.append((e, path)))
    await c2.create('/e', b'x')
    await c2.set('/e', b'y', version=-1)
    await c2.create('/e/kid', b'k')    # parent's childrenChanged
    await wait_until(lambda: ('childrenChanged', '/e') in events)
    await c2.delete('/e/kid', version=-1)
    await c2.delete('/e', version=-1)
    await wait_until(lambda: ('deleted', '/e') in events)
    kinds = [e for e, p in events if p == '/e']
    assert kinds[0] == 'created'
    assert 'dataChanged' in kinds and 'deleted' in kinds


async def test_persistent_recursive_subtree_no_children_changed(
        two_clients):
    """Recursive mode sees every descendant's own created / deleted /
    dataChanged — and never childrenChanged (upstream
    AddWatchMode.PERSISTENT_RECURSIVE semantics: the child's own
    lifecycle event stands in for it)."""
    c1, c2 = two_clients
    await c1.create('/r', b'')
    events = []
    w = await c1.add_watch('/r', recursive=True)
    for evt in ('created', 'deleted', 'dataChanged',
                'childrenChanged'):
        w.on(evt, lambda path, zxid, e=evt: events.append((e, path)))
    await c2.create('/r/a', b'1')
    await c2.create('/r/a/b', b'2')
    await c2.set('/r/a/b', b'3', version=-1)
    await c2.delete('/r/a/b', version=-1)
    await wait_until(lambda: ('deleted', '/r/a/b') in events)
    assert ('created', '/r/a') in events
    assert ('created', '/r/a/b') in events
    assert ('dataChanged', '/r/a/b') in events
    assert not any(e == 'childrenChanged' for e, _p in events), events


async def test_persistent_and_one_shot_coexist(two_clients):
    """A persistent watch and a classic one-shot watcher on the same
    node each get their own delivery; consuming the one-shot does not
    consume the persistent registration."""
    c1, c2 = two_clients
    await c1.create('/mix', b'v0')
    oneshot, persist = [], []
    c1.watcher('/mix').on('dataChanged',
                          lambda data, stat: oneshot.append(bytes(data)))
    await wait_until(lambda: len(oneshot) == 1)   # arming emit
    w = await c1.add_watch('/mix')
    w.on('dataChanged', lambda path, zxid: persist.append(zxid))
    await c2.set('/mix', b'v1', version=-1)
    await c2.set('/mix', b'v2', version=-1)
    await wait_until(lambda: len(persist) == 2)
    await wait_until(lambda: b'v2' in oneshot)


async def test_add_watch_bad_mode_rejected(two_clients):
    c1, _ = two_clients
    with pytest.raises(ZKError) as ei:
        await c1._primary_request(
            {'opcode': 'ADD_WATCH', 'path': '/x', 'mode': 7},
            'ADD_WATCH', '/x', None)
    assert ei.value.code == 'BAD_ARGUMENTS'


async def test_remove_persistent_watch_stops_delivery(two_clients):
    c1, c2 = two_clients
    await c1.create('/rm', b'v0')
    seen = []
    w = await c1.add_watch('/rm')
    w.on('dataChanged', lambda path, zxid: seen.append(zxid))
    await c2.set('/rm', b'v1', version=-1)
    await wait_until(lambda: len(seen) == 1)
    c1.remove_persistent_watch('/rm')
    await c2.set('/rm', b'v2', version=-1)
    await asyncio.sleep(0.2)           # window for a wrong delivery
    assert len(seen) == 1


async def test_mntr_counts_persistent_watches(server, two_clients):
    c1, _ = two_clients
    await c1.add_watch('/a')
    await c1.add_watch('/b', recursive=True)
    rows = dict(line.split('\t')
                for line in server.admin_text('mntr').splitlines()
                if '\t' in line)
    assert rows['zk_persistent_watches'] == '1'
    assert rows['zk_recursive_watches'] == '1'


# -- the cache plane ---------------------------------------------------

async def test_cached_read_served_locally(cached_pair):
    c1, c2 = cached_pair
    await c2.create('/app/k', b'v1')
    d1, s1 = await c1.get('/app/k')    # miss + fill
    d2, s2 = await c1.get('/app/k')    # hit
    assert d1 == d2 == b'v1'
    assert s1.mzxid == s2.mzxid
    st = c1.cache.stats()
    assert st['hits'] == 1 and st['misses'] >= 1


async def test_cache_invalidates_on_remote_write(cached_pair):
    """The coherence contract end to end: another session's write
    must invalidate, and the next read observes the new value."""
    c1, c2 = cached_pair
    await c2.create('/app/k', b'v1')
    await c1.get('/app/k')
    await c1.get('/app/k')             # cached
    inv0 = c1.cache.stats()['invalidations']
    await c2.set('/app/k', b'v2', version=-1)
    await wait_until(
        lambda: c1.cache.stats()['invalidations'] > inv0)
    d, _ = await c1.get('/app/k')
    assert d == b'v2'


async def test_cache_children_and_exists(cached_pair):
    c1, c2 = cached_pair
    await c2.create('/app/a', b'')
    ch1, _ = await c1.list('/app')
    ch2, _ = await c1.list('/app')     # cached
    assert ch1 == ch2 == ['a']
    st1 = await c1.stat('/app/a')      # EXISTS off the filled entry
    assert st1 is not None
    assert c1.cache.stats()['hits'] >= 1
    inv0 = c1.cache.stats()['invalidations']
    await c2.create('/app/b', b'')     # invalidates /app's children
    await wait_until(
        lambda: c1.cache.stats()['invalidations'] > inv0)
    ch3, _ = await c1.list('/app')
    assert sorted(ch3) == ['a', 'b']


async def test_cache_deleted_node_drops_entry(cached_pair):
    c1, c2 = cached_pair
    await c2.create('/app/d', b'x')
    await c1.get('/app/d')
    await c2.delete('/app/d', version=-1)
    await wait_until(
        lambda: c1.cache.stats()['invalidations'] >= 1)
    with pytest.raises(ZKError) as ei:
        await c1.get('/app/d')
    assert ei.value.code == 'NO_NODE'


async def test_uncovered_path_never_cached(cached_pair):
    c1, c2 = cached_pair
    await c2.create('/other', b'x')
    await c1.get('/other')
    await c1.get('/other')
    assert c1.cache.stats()['hits'] == 0


async def test_cache_prime_warms_subtree(cached_pair):
    c1, c2 = cached_pair
    for i in range(5):
        await c2.create('/app/n%d' % i, b'v%d' % i)
    await c1.cache.prime()
    hits0 = c1.cache.stats()['hits']
    for i in range(5):
        d, _ = await c1.get('/app/n%d' % i)
        assert d == b'v%d' % i
    assert c1.cache.stats()['hits'] == hits0 + 5


async def test_cached_read_advances_read_floor(cached_pair):
    """Invariant 9 applies to cached reads verbatim: serving a cached
    entry pins the session read floor at the entry's zxid, so a later
    distributed read can never be served from a member behind it."""
    c1, c2 = cached_pair
    await c2.create('/app/f', b'v1')
    d, stat = await c1.get('/app/f')
    floor_after_fill = c1.last_seen_zxid()
    await c1.get('/app/f')             # cached serve
    assert c1.last_seen_zxid() >= floor_after_fill >= stat.mzxid


async def test_fill_gate_rejects_stale_reply(cached_pair):
    """A reply older than the cache position (a lagging member's
    read racing an invalidation) must not be deposited — else the
    invalidated value would be resurrected and served forever."""
    c1, _ = cached_pair
    cache = c1.cache
    cache._pos = max(cache._pos, 1000)
    cache.fill('GET_DATA', '/app/stale',
               {'data': b'old', 'stat': None, 'zxid': 999})
    assert cache.lookup('GET_DATA', '/app/stale') is None


def test_cache_knob_resolution(monkeypatch):
    monkeypatch.setenv('ZKSTREAM_NO_CACHE', '1')
    monkeypatch.setenv('ZKSTREAM_CACHE', '/a:/b')
    assert cache_roots_default() is None       # kill switch wins
    monkeypatch.delenv('ZKSTREAM_NO_CACHE')
    assert cache_roots_default() == ['/a', '/b']
    monkeypatch.setenv('ZKSTREAM_CACHE', '1')
    assert cache_roots_default() == ['/']
    monkeypatch.delenv('ZKSTREAM_CACHE')
    assert cache_roots_default() is None


def test_cache_ctor_beats_env(monkeypatch, event_loop, server):
    monkeypatch.setenv('ZKSTREAM_CACHE', '/env')

    async def check():
        c = Client(address='127.0.0.1', port=server.port,
                   session_timeout=5000, cache=False)
        assert c.cache is None
        c2 = Client(address='127.0.0.1', port=server.port,
                    session_timeout=5000, cache='/ctor')
        assert list(c2.cache.roots) == ['/ctor']
        c3 = Client(address='127.0.0.1', port=server.port,
                    session_timeout=5000)
        assert list(c3.cache.roots) == ['/env']
    event_loop.run_until_complete(check())


async def test_cache_metrics_exported(cached_pair):
    c1, c2 = cached_pair
    await c2.create('/app/m', b'v')
    await c1.get('/app/m')
    await c1.get('/app/m')
    text = c1.collector.expose()
    assert 'zookeeper_cache_hits' in text
    assert 'zookeeper_cache_misses' in text
