"""The port of tests/test_admin_words.py, on the port's admin words; every
case on an in-process server or ensemble runs twice, on the port's and
on the JAX package's, with the port's clients.

Four-letter admin word tests (server/server.py): ruok / mntr /
stat / srvr over raw TCP, like real ZooKeeper's — no length prefix,
reply text, connection closed after the answer."""

import asyncio

from helpers import wait_until
from zkstream_tpu_torch import Client
from test_torch_basic import ensemble_cls, server, server_cls  # noqa: F401


async def _four_letter(server, word: bytes) -> bytes:
    reader, writer = await asyncio.open_connection('127.0.0.1',
                                                   server.port)
    try:
        writer.write(word)
        await writer.drain()
        return await asyncio.wait_for(reader.read(), 5)
    finally:
        writer.close()


async def test_ruok_returns_imok(server):
    assert await _four_letter(server, b'ruok') == b'imok'


async def test_mntr_reports_live_server_state(server):
    """mntr over a live server with a connected client: znode count,
    watch count, outstanding requests, and connection count are all
    present and reflect reality."""
    c = Client(address='127.0.0.1', port=server.port,
               session_timeout=5000)
    c.start()
    try:
        await c.wait_connected(timeout=5)
        await c.create('/a', b'x')
        await c.create('/a/b', b'y')
        seen = []
        c.watcher('/a').on('dataChanged',
                           lambda d, s: seen.append(bytes(d)))
        await wait_until(lambda: seen == [b'x'])

        text = (await _four_letter(server, b'mntr')).decode()
        kv = dict(line.split('\t', 1)
                  for line in text.strip().splitlines())
        # /, /a, /a/b
        assert int(kv['zk_znode_count']) == 3
        assert int(kv['zk_watch_count']) >= 1
        assert int(kv['zk_outstanding_requests']) == 0
        assert int(kv['zk_num_alive_connections']) >= 1
        assert int(kv['zk_packets_received']) > 0
        assert int(kv['zk_packets_sent']) > 0
        assert int(kv['zk_sessions']) == 1
        assert kv['zk_server_state'] == 'standalone'
        assert kv['zk_zxid'].startswith('0x')
    finally:
        await c.close()


async def test_stat_and_srvr_words(server):
    c = Client(address='127.0.0.1', port=server.port,
               session_timeout=5000)
    c.start()
    try:
        await c.wait_connected(timeout=5)
        stat = (await _four_letter(server, b'stat')).decode()
        assert 'Zookeeper version:' in stat
        assert 'Clients:' in stat
        assert 'Mode: standalone' in stat
        assert 'Node count: 1' in stat
        # client lines carry the PEER address (the client's ephemeral
        # port), not the server's own listening endpoint
        sid = c.session.session_id
        client_lines = [ln for ln in stat.splitlines()
                        if ('sid=0x%x' % sid) in ln]
        assert client_lines, stat
        assert ':%d[' % server.port not in client_lines[0]
        srvr = (await _four_letter(server, b'srvr')).decode()
        assert 'Mode: standalone' in srvr
        assert 'Clients:' not in srvr
    finally:
        await c.close()


async def test_admin_word_split_across_segments(server):
    """The four letters may straggle in over several TCP segments; the
    server must buffer until it can decide."""
    reader, writer = await asyncio.open_connection('127.0.0.1',
                                                   server.port)
    try:
        writer.write(b'ru')
        await writer.drain()
        await asyncio.sleep(0.05)
        writer.write(b'ok')
        await writer.drain()
        assert await asyncio.wait_for(reader.read(), 5) == b'imok'
    finally:
        writer.close()


async def test_admin_probe_does_not_disturb_protocol_clients(server):
    """Admin scrapes ride the same listener as protocol clients; a
    client connected before and after a scrape keeps working."""
    c = Client(address='127.0.0.1', port=server.port,
               session_timeout=5000)
    c.start()
    try:
        await c.wait_connected(timeout=5)
        await c.create('/p', b'1')
        assert await _four_letter(server, b'ruok') == b'imok'
        data, _stat = await c.get('/p')
        assert data == b'1'
        await c.set('/p', b'2')
        assert (await _four_letter(server, b'mntr')).startswith(
            b'zk_version')
    finally:
        await c.close()


async def test_mntr_tick_ledger_and_trace_rows(server):
    """The tick-ledger rows (zk_tick_count, per-phase p99) and the
    trace-ring overwrite counter ride mntr: after real traffic the
    counts are live and the decode phase has a distribution."""
    c = Client(address='127.0.0.1', port=server.port,
               session_timeout=5000)
    c.start()
    try:
        await c.wait_connected(timeout=5)
        await c.create('/t', b'x')
        for i in range(5):
            await c.set('/t', b'v%d' % i)
        text = (await _four_letter(server, b'mntr')).decode()
        kv = dict(line.split('\t', 1)
                  for line in text.strip().splitlines())
        assert int(kv['zk_tick_count']) > 0
        assert int(kv['zk_trace_ring_dropped']) == 0
        assert float(kv['zk_tick_phase_ms_p99{phase="decode_apply"}'
                        ]) >= 0.0
        assert float(kv['zk_tick_phase_ms_p99{phase="cork_flush"}'
                        ]) >= 0.0
    finally:
        await c.close()


async def test_mntr_uptime_slow_op_and_blackbox_rows(server,
                                                     tmp_path, server_cls):
    """The black-box plane's mntr rows: zk_uptime_ms and
    zk_slow_ops_total on EVERY member (0 slow ops at the default
    threshold — the clean-schedule invariant); zk_blackbox_frames /
    zk_blackbox_bytes only where a flight recorder actually writes
    (a member with a wal_dir)."""

    text = (await _four_letter(server, b'mntr')).decode()
    kv = dict(line.split('\t', 1)
              for line in text.strip().splitlines())
    assert int(kv['zk_uptime_ms']) >= 0
    assert int(kv['zk_slow_ops_total']) == 0
    # no wal_dir -> no recorder -> no frame rows (mntr never lies)
    assert 'zk_blackbox_frames' not in kv
    assert 'zk_blackbox_bytes' not in kv

    srv = await server_cls(wal_dir=str(tmp_path / 'wal')).start()
    try:
        assert srv.blackbox is not None
        srv.blackbox.capture()       # one frame now, cadence aside
        text = (await _four_letter(srv, b'mntr')).decode()
        kv = dict(line.split('\t', 1)
                  for line in text.strip().splitlines())
        assert int(kv['zk_blackbox_frames']) >= 1
        assert int(kv['zk_blackbox_bytes']) >= 0
        assert int(kv['zk_slow_ops_total']) == 0
    finally:
        await srv.stop()


async def test_trce_word_dumps_member_ring(server):
    """trce: the member's span ring as trace_schema-stamped JSON —
    what `timeline --live` merges across members."""
    import json

    from zkstream_tpu_torch.utils.trace import TRACE_SCHEMA

    c = Client(address='127.0.0.1', port=server.port,
               session_timeout=5000)
    c.start()
    try:
        await c.wait_connected(timeout=5)
        await c.create('/t', b'x')
        await c.set('/t', b'y')
        dump = json.loads(await _four_letter(server, b'trce'))
        assert dump['trace_schema'] == TRACE_SCHEMA
        assert dump['member'] == server.member
        assert dump['dropped'] == 0
        ops = [s['op'] for s in dump['spans']]
        assert 'COMMIT' in ops and 'SRV_DECODE' in ops
        commits = [s for s in dump['spans'] if s['op'] == 'COMMIT']
        assert all(s['zxid'] for s in commits)
    finally:
        await c.close()


async def test_trce_word_with_trace_disabled(server_cls):
    """A server with the trace plane off still answers trce (empty
    ring) — scrapes must not error on an untraced member."""
    import json


    srv = await server_cls(trace=False).start()
    try:
        assert srv.trace is None and srv.ledger is None
        dump = json.loads(await _four_letter(srv, b'trce'))
        assert dump['spans'] == [] and dump['dropped'] == 0
        # and mntr omits the ledger rows rather than lying
        text = (await _four_letter(srv, b'mntr')).decode()
        assert 'zk_tick_count' not in text
    finally:
        await srv.stop()


async def test_mntr_follower_mode_in_ensemble(ensemble_cls):

    ens = await ensemble_cls(2).start()
    try:
        leader = (await _four_letter(ens.servers[0], b'mntr')).decode()
        follower = (await _four_letter(ens.servers[1],
                                       b'mntr')).decode()
        assert 'zk_server_state\tstandalone' in leader
        assert 'zk_server_state\tfollower' in follower
    finally:
        await ens.stop()


async def test_cli_mntr_subcommand(server, capsys):
    from zkstream_tpu_torch import cli

    args = cli.build_parser().parse_args(
        ['--server', '127.0.0.1:%d' % server.port, 'mntr'])
    rc = await cli._admin(args)
    out, _err = capsys.readouterr()
    assert rc == 0
    assert 'zk_znode_count\t1' in out

    args = cli.build_parser().parse_args(
        ['--server', '127.0.0.1:%d' % server.port, 'mntr', 'ruok'])
    rc = await cli._admin(args)
    out, _err = capsys.readouterr()
    assert rc == 0 and out.strip() == 'imok'


async def test_cli_mntr_scrapes_every_member(capsys, ensemble_cls):
    """A multi-host --server list probes each member, not just the
    first — that is what makes it an ensemble health check."""
    from zkstream_tpu_torch import cli

    ens = await ensemble_cls(3).start()
    try:
        spec = ','.join('127.0.0.1:%d' % p
                        for _h, p in ens.addresses())
        args = cli.build_parser().parse_args(
            ['--server', spec, 'mntr', 'ruok'])
        rc = await cli._admin(args)
        out, _err = capsys.readouterr()
        assert rc == 0
        assert out.count('imok') == 3
        for _h, p in ens.addresses():
            assert '--- 127.0.0.1:%d ---' % p in out
    finally:
        await ens.stop()


async def test_cli_mntr_unreachable_is_exit_1(capsys):
    from zkstream_tpu_torch import cli

    args = cli.build_parser().parse_args(
        ['--server', '127.0.0.1:1', '--timeout', '2', 'mntr'])
    rc = await cli._admin(args)
    _out, err = capsys.readouterr()
    assert rc == 1 and 'could not connect' in err


async def test_cli_metrics_subcommand(server, capsys):
    from zkstream_tpu_torch import cli

    args = cli.build_parser().parse_args(
        ['--server', '127.0.0.1:%d' % server.port, 'metrics'])
    rc = await cli._run(args)
    out, _err = capsys.readouterr()
    assert rc == 0
    assert '# TYPE zookeeper_op_latency_ms histogram' in out
    assert 'zookeeper_op_latency_ms_count{op="PING"} 1' in out
    assert '# TYPE zkstream_fsm_transitions counter' in out
