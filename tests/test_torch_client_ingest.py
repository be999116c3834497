"""The port's client stack and single-member server against the JAX
package's, over real TCP on the CPU.

The op surface and watcher sequence of the reference's ingest parity
workload (``tests/test_ingest.py::_workload``) is the yardstick: the
reference ``Client`` against the reference ``ZKServer`` with the
per-socket scalar drain gives the observations every other case must
equal —

- the port's ``Client`` on both servers (the reference's and the
  port's), with no ingest, with the port's ``FleetIngest(device='cpu')``
  in both body modes, and with ``MeshFleetIngest`` at dp=8 on CPU
  shards;
- the reference ``Client`` on the port's server.

The two packages' record classes are distinct types, so observations
are compared as plain tuples (``_norm``).  A 32-client watch fan-out
(``bench.py``'s smallest client scale) through one port ingest closes
the file.
"""

from __future__ import annotations

import asyncio

import pytest
import torch

import zkstream_tpu as ref
import zkstream_tpu_torch as port
from helpers import wait_until
from test_ingest import _stat_obs
from test_torch_ingest import _norm
from zkstream_tpu.server import ZKServer as RefServer
from zkstream_tpu_torch.io import FleetIngest
from zkstream_tpu_torch.parallel import MeshFleetIngest, make_mesh
from zkstream_tpu_torch.server import ZKServer as PortServer

ERRORS = (ref.ZKError, port.ZKError)


async def _workload(c) -> list:
    """tests/test_ingest.py's ``_workload``, for a client of either
    package: every op kind and a full watcher sequence."""
    obs: list = []
    events: list = []
    w = c.watcher('/w')
    for evt in ('created', 'deleted', 'dataChanged'):
        w.on(evt, lambda *a, _e=evt: events.append(
            (_e, bytes(a[0]) if _e == 'dataChanged' and a else None)))
    await wait_until(lambda: events)

    obs.append(('create', await c.create('/w', b'v0')))
    data, stat = await c.get('/w')
    obs.append(('get', data, _stat_obs(stat)))
    stat = await c.set('/w', b'v1' * 40)
    obs.append(('set', _stat_obs(stat)))
    data, stat = await c.get('/w')
    obs.append(('get2', data, _stat_obs(stat)))
    obs.append(('exists', _stat_obs(await c.stat('/w'))))
    children, stat = await c.list('/')
    obs.append(('ls', sorted(children), _stat_obs(stat)))
    obs.append(('acl', tuple(await c.get_acl('/w'))))
    try:
        await c.get('/missing')
    except ERRORS as e:
        obs.append(('err', e.code))
    obs.append(('seq', await c.create(
        '/q-', b'', flags=port.CreateFlag.SEQUENTIAL
        | port.CreateFlag.EPHEMERAL)))
    await c.sync('/w')
    obs.append(('ping', (await c.ping()) >= 0))
    await wait_until(
        lambda: any(e[0] == 'dataChanged' for e in events))
    obs.append(('events', events[:3]))
    return _norm(obs)


async def _observe(client_pkg, server_cls, ingest=None) -> list:
    srv = await server_cls().start()
    if ingest is not None:
        await ingest.prewarm(1)
    c = client_pkg.Client(address='127.0.0.1', port=srv.port,
                          ingest=ingest, session_timeout=5000)
    c.start()
    try:
        await c.wait_connected(timeout=5)
        if ingest is not None:
            assert c.current_connection().ingest is ingest
        return await _workload(c)
    finally:
        await c.close()
        await srv.stop()


def _ingest(kind):
    kw = dict(max_frames=8, min_len=1024, warm='block', max_data=128,
              max_path=64)
    if kind == 'host':
        return FleetIngest(device='cpu', body_mode='host', bypass_bytes=0,
                           **kw)
    if kind == 'device':
        return FleetIngest(device='cpu', body_mode='device',
                           bypass_bytes=0, **kw)
    if kind == 'mesh8':
        return MeshFleetIngest(
            mesh=make_mesh(dp=8, devices=[torch.device('cpu')] * 8),
            device='cpu', body_mode='host', **kw)
    return None


_CASES = [('port', srv, kind)
          for srv in ('reference', 'port')
          for kind in ('none', 'host', 'device', 'mesh8')] \
    + [('reference', 'port', 'none')]


@pytest.mark.timeout(60)
@pytest.mark.parametrize('client,server,ingest', _CASES,
                         ids=['-'.join(c) for c in _CASES])
async def test_workload_matches_reference(client, server, ingest):
    want = await _observe(ref, RefServer)
    ing = _ingest(ingest)
    got = await _observe(port if client == 'port' else ref,
                         PortServer if server == 'port' else RefServer,
                         ing)
    assert got == want
    if ing is not None:
        assert ing.ticks > 0 and ing.frames_routed > 0
        assert ing.ticks_scalar == ing.ticks_warming == 0
        assert ing.body_fallbacks == 0


@pytest.mark.timeout(60)
@pytest.mark.parametrize('body_mode', ['host', 'device'])
async def test_watch_fanout_32_clients_through_one_ingest(body_mode):
    """Every client watches one node; one set fires 32 notifications
    and their re-arm reads through one shared port ingest, each watcher
    exactly once, on the port's server."""
    n = 32
    srv = await PortServer().start()
    ing = FleetIngest(device='cpu', body_mode=body_mode, bypass_bytes=0,
                      max_frames=4, warm='block')
    for bp in (8, 16, 32):
        await ing.prewarm(bp)
    clients = [port.Client(address='127.0.0.1', port=srv.port,
                           ingest=ing, session_timeout=5000)
               for _ in range(n)]
    for c in clients:
        c.start()
    try:
        await asyncio.gather(*[c.wait_connected(timeout=10)
                               for c in clients])
        await clients[0].create('/b', b'x' * 64)
        fired = [0] * n
        seen: list = [None] * n
        for i, c in enumerate(clients):
            def on_fire(data=None, *_a, _i=i):
                fired[_i] += 1
                seen[_i] = bytes(data) if data is not None else None
            c.watcher('/b').on('dataChanged', on_fire)
        await wait_until(lambda: all(fired))    # the arm-time emits
        fired[:] = [0] * n
        ticks = ing.ticks
        await clients[0].set('/b', b'z' * 64)
        await wait_until(lambda: all(fired))
        # every watch re-arms, and no re-arm read fires a second time
        await wait_until(lambda: srv.watch_count() == n)
        await asyncio.sleep(0.1)
        assert fired == [1] * n
        assert seen == [b'z' * 64] * n
        assert ing.ticks > ticks and ing.ticks_scalar == 0
        assert ing.body_fallbacks == 0
    finally:
        await asyncio.gather(*[c.close() for c in clients])
        await srv.stop()
