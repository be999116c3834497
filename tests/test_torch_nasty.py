"""Adversarial tests of the port's ``Client``: hostile, broken, and
half-dead servers — the rebuild's equivalent of the reference's
test/nasty.test.js, ported from tests/test_nasty.py.

Each hostile-server case runs twice, the port's ``Client`` and then the
JAX package's, each against a fresh instance of the same fake server
(and, where a real server appears, the port's ``ZKServer``): what the
two clients observe — 'failed', 'connect', the error a call raises —
must be the same, and the reference's expectation."""

import asyncio
import struct
import types

import pytest

import zkstream_tpu
from helpers import wait_until
from zkstream_tpu.io.pool import RecoveryPolicy as RefRecoveryPolicy
from zkstream_tpu.protocol.framing import PacketCodec as RefPacketCodec
from zkstream_tpu_torch import Client, ZKNotConnectedError
from zkstream_tpu_torch.io.pool import RecoveryPolicy
from zkstream_tpu_torch.protocol.framing import PacketCodec
from zkstream_tpu_torch.server import ZKServer

PACKAGES = {
    'port': types.SimpleNamespace(
        Client=Client, ZKNotConnectedError=ZKNotConnectedError,
        RecoveryPolicy=RecoveryPolicy),
    'reference': types.SimpleNamespace(
        Client=zkstream_tpu.Client,
        ZKNotConnectedError=zkstream_tpu.ZKNotConnectedError,
        RecoveryPolicy=RefRecoveryPolicy),
}


def failing_client(pkg, port, **kw):
    fast = dict(
        connect_policy=pkg.RecoveryPolicy(timeout=300, retries=2, delay=50),
        default_policy=pkg.RecoveryPolicy(timeout=300, retries=2,
                                          delay=100))
    c = pkg.Client(address='127.0.0.1', port=port, session_timeout=2000,
                   **{**fast, **kw})
    failed = []
    c.on('failed', failed.append)
    connected = []
    c.on('connect', lambda: connected.append(True))
    c.start()
    return c, failed, connected


async def both(scenario):
    """``scenario(pkg)`` with the port's client package and then the
    reference's: the port's observations, asserted equal to the
    reference's."""
    out = {name: await scenario(pkg) for name, pkg in PACKAGES.items()}
    assert out['port'] == out['reference']
    return out['port']


async def start_fake(handler):
    srv = await asyncio.start_server(handler, '127.0.0.1', 0)
    return srv, srv.sockets[0].getsockname()[1]


async def rejected(handler):
    """Both clients against a fresh fake server running ``handler``:
    each must end in 'failed' and never connect."""
    async def scenario(pkg):
        srv, port = await start_fake(handler)
        c, failed, connected = failing_client(pkg, port)
        try:
            await wait_until(lambda: failed, timeout=10)
            return bool(failed), connected
        finally:
            await c.close()
            srv.close()

    assert await both(scenario) == (True, [])


async def test_connect_refused_emits_failed():
    # Port 1 refuses connections (reference: basic.test.js:1399-1418).
    async def scenario(pkg):
        c, failed, connected = failing_client(pkg, 1)
        try:
            await wait_until(lambda: failed, timeout=10)
            with pytest.raises(pkg.ZKNotConnectedError) as ei:
                await c.get('/x')
            return bool(failed), connected, ei.value.code
        finally:
            await c.close()

    got = await both(scenario)
    assert got[:2] == (True, [])


async def test_immediate_close_server():
    # Accepts then instantly destroys every connection
    # (reference: basic.test.js:1420-1448).
    async def handler(reader, writer):
        writer.close()
    await rejected(handler)


async def test_hanging_server():
    # Accepts and never replies to the handshake: connect attempts must
    # time out, not hang (reference: nasty.test.js:245-285).
    async def handler(reader, writer):
        await reader.read(65536)
        await asyncio.sleep(3600)
    await rejected(handler)


@pytest.mark.parametrize('prefix', [
    struct.pack('>i', -10),               # negative length
    struct.pack('>i', 17 * 1024 * 1024),  # over the 16 MiB cap
    struct.pack('>i', 2 ** 31 - 1),       # absurd length
])
async def test_awful_server_bad_length_prefix(prefix):
    """Servers replying with insane length prefixes must produce a
    protocol error and eventually 'failed', never a crash or hang
    (reference: nasty.test.js:105-189)."""
    async def handler(reader, writer):
        await reader.read(65536)   # swallow the ConnectRequest
        writer.write(prefix + b'garbage')
        try:
            await writer.drain()
        except ConnectionError:
            pass
    await rejected(handler)


async def test_zero_length_frames_flood():
    # Zero-length frames are valid framing but undecodable bodies.
    async def handler(reader, writer):
        await reader.read(65536)
        writer.write(struct.pack('>i', 0) * 100)
        try:
            await writer.drain()
        except ConnectionError:
            pass
    await rejected(handler)


@pytest.mark.parametrize('codec_cls', [PacketCodec, RefPacketCodec],
                         ids=['port-codec', 'reference-codec'])
async def test_version_incompatible_server(codec_cls):
    """A fake ZK server built from a codec in server mode (the port's,
    and the JAX package's), replying protocolVersion 1: the handshake
    must be rejected (reference: nasty.test.js:294-361 — the same
    trick, except the reference's server-mode encoder does not actually
    exist)."""
    async def handler(reader, writer):
        codec = codec_cls(server=True)
        data = await reader.read(65536)
        [creq] = codec.decode(data)
        writer.write(codec.encode({'protocolVersion': 1,
                                   'timeOut': creq['timeOut'],
                                   'sessionId': 0x1234,
                                   'passwd': b'p' * 16}))
        await writer.drain()
    await rejected(handler)


async def test_flaky_listener_attach_race():
    """A listener that kills its first few connections mid-handshake
    then starts behaving: the client must ride through the attach-race
    guard and eventually connect (reference: nasty.test.js:28-103)."""
    real = await ZKServer().start()

    async def scenario(pkg):
        kills = {'n': 0}

        async def handler(reader, writer):
            if kills['n'] < 3:
                kills['n'] += 1
                # Read the ConnectRequest, then die mid-handshake.
                await reader.read(65536)
                writer.close()
                return
            # Proxy to the real server from here on.
            try:
                r2, w2 = await asyncio.open_connection('127.0.0.1',
                                                       real.port)
            except ConnectionError:
                writer.close()
                return

            async def pump(src, dst):
                try:
                    while True:
                        chunk = await src.read(65536)
                        if not chunk:
                            break
                        dst.write(chunk)
                        await dst.drain()
                except ConnectionError:
                    pass
                finally:
                    try:
                        dst.close()
                    except RuntimeError:
                        pass
            await asyncio.gather(pump(reader, w2), pump(r2, writer))

        srv, port = await start_fake(handler)
        c, failed, connected = failing_client(pkg, port)
        try:
            await wait_until(lambda: connected, timeout=15)
            return await c.ping() >= 0, kills['n']
        finally:
            await c.close()
            srv.close()

    try:
        assert await both(scenario) == (True, 3)
    finally:
        await real.stop()


async def _free_port() -> int:
    """A port reserved by binding and closing."""
    tmp = await asyncio.start_server(lambda r, w: None, '127.0.0.1', 0)
    port = tmp.sockets[0].getsockname()[1]
    tmp.close()
    await tmp.wait_closed()
    return port


async def test_recovery_after_failed():
    """'failed' is not terminal: monitor mode keeps dialing and the
    client recovers when a server appears (cueball monitor semantics)."""
    async def scenario(pkg):
        port = await _free_port()
        c, failed, connected = failing_client(pkg, port)
        srv = None
        try:
            await wait_until(lambda: failed, timeout=10)
            srv = await ZKServer(host='127.0.0.1', port=port).start()
            await wait_until(lambda: connected, timeout=15)
            return bool(failed), await c.ping() >= 0
        finally:
            await c.close()
            if srv is not None:
                await srv.stop()

    assert await both(scenario) == (True, True)


async def test_wait_connected_fail_fast_contract():
    """wait_connected's 'failed' contract (client.py): fail_fast=True
    surfaces policy exhaustion (immediately when the pool is already in
    monitor mode); fail_fast=False rides monitor mode and completes
    when a backend appears after exhaustion."""
    async def scenario(pkg):
        port = await _free_port()
        c, failed, connected = failing_client(pkg, port)
        srv = None
        seen = []
        try:
            # A fail_fast waiter registered BEFORE exhaustion gets the
            # edge.
            with pytest.raises(pkg.ZKNotConnectedError):
                await c.wait_connected(timeout=10)
            seen.append(bool(failed))
            # Pool is now in monitor mode: fail_fast=True raises
            # immediately...
            seen.append(c.pool.state)
            with pytest.raises(pkg.ZKNotConnectedError):
                await c.wait_connected(timeout=10)
            # ...but a patient waiter survives the (already-passed) edge
            # and completes once monitor mode lands a connection.
            waiter = asyncio.ensure_future(
                c.wait_connected(timeout=15, fail_fast=False))
            await asyncio.sleep(0.3)
            seen.append(waiter.done())
            srv = await ZKServer(host='127.0.0.1', port=port).start()
            await waiter
            seen.append(await c.ping() >= 0)
            return seen
        finally:
            await c.close()
            if srv is not None:
                await srv.stop()

    assert await both(scenario) == [True, 'failed', False, True]


def _validation_errors(pkg) -> list:
    """The error class each invalid call raises, by name."""
    async def run():
        c = pkg.Client(address='127.0.0.1', port=1)
        out = []
        for call in (lambda: c.get(123), lambda: c.get('no-slash'),
                     lambda: c.create('/x', 'not-bytes'),
                     lambda: c.delete('/x', 'not-an-int'),
                     lambda: c.watcher(None),
                     lambda: c.delete('/x', True),  # bool is no version
                     lambda: c.set('/x', b'd', version='7')):
            try:
                r = call()
                if asyncio.iscoroutine(r):
                    await r
                out.append(None)
            except Exception as e:
                out.append(type(e).__name__)
        await c.close()
        # watcher() on a closed client raises cleanly, not AttributeError
        try:
            c.watcher('/x')
            out.append(None)
        except Exception as e:
            out.append(type(e).__name__)
        return out
    return run()


async def test_argument_validation():
    got = await both(_validation_errors)
    assert got[:5] == ['TypeError', 'ValueError', 'TypeError', 'TypeError',
                       'TypeError']
    c = Client(address='127.0.0.1', port=1)
    with pytest.raises(TypeError):
        await c.get(123)
    with pytest.raises(ValueError):
        await c.get('no-slash')
    with pytest.raises(TypeError):
        await c.create('/x', 'not-bytes')
    with pytest.raises(TypeError):
        await c.delete('/x', 'not-an-int')
    with pytest.raises(TypeError):
        c.watcher(None)


async def test_argument_validation_bool_version_and_closed_watcher():
    got = await both(_validation_errors)
    assert got[5:] == ['TypeError', 'TypeError', 'ZKNotConnectedError']
    c = Client(address='127.0.0.1', port=1)
    with pytest.raises(TypeError):
        await c.delete('/x', True)   # bool is not a version
    with pytest.raises(TypeError):
        await c.set('/x', b'd', version='7')
    # watcher() on a closed client raises cleanly, not AttributeError.
    await c.close()
    with pytest.raises(ZKNotConnectedError):
        c.watcher('/x')
