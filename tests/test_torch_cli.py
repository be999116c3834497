"""The port of tests/test_cli.py, on the port's CLI (``--device cpu``
where an ingest is built); every case on an in-process server or
ensemble runs twice, on the port's and on the JAX package's, with the
port's clients.

CLI tests: ``python -m zkstream_tpu_torch`` commands driven in-process
against the in-process server (the rebuild's zkCli analogue)."""

import asyncio
import os

import pytest

from helpers import wait_until
from zkstream_tpu_torch import Client, cli
from test_torch_basic import ensemble_cls, server, server_cls  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


async def run_cli(server, *argv, capsys=None):
    args = cli.build_parser().parse_args(
        ['--server', '127.0.0.1:%d' % server.port,
         '--session-timeout', '5000', '--device', 'cpu'] + list(argv))
    rc = await cli._run(args)
    if capsys is None:
        return rc, '', ''
    out, err = capsys.readouterr()
    return rc, out, err


async def test_cli_crud_cycle(server, capsys):
    rc, out, _ = await run_cli(server, 'ping', capsys=capsys)
    assert rc == 0 and out.startswith('ping ok:')

    rc, out, _ = await run_cli(server, 'create', '/c', 'hello',
                               capsys=capsys)
    assert rc == 0 and out.strip() == '/c'

    rc, out, _ = await run_cli(server, 'get', '/c', capsys=capsys)
    assert rc == 0 and out == 'hello\n'

    rc, out, _ = await run_cli(server, 'set', '/c', 'world',
                               capsys=capsys)
    assert rc == 0 and out.strip() == 'version = 1'

    rc, out, _ = await run_cli(server, 'stat', '/c', capsys=capsys)
    assert rc == 0
    assert 'version = 1' in out and 'dataLength = 5' in out

    rc, out, _ = await run_cli(server, 'getacl', '/c', capsys=capsys)
    assert rc == 0 and 'world:anyone' in out

    rc, out, _ = await run_cli(server, 'create', '-p', '/d/e/f', 'x',
                               capsys=capsys)
    assert rc == 0 and out.strip() == '/d/e/f'

    rc, out, _ = await run_cli(server, 'ls', '/', capsys=capsys)
    assert rc == 0 and out.split() == ['c', 'd']

    rc, out, _ = await run_cli(server, 'sync', '/', capsys=capsys)
    assert rc == 0

    rc, _, _ = await run_cli(server, 'delete', '/c', capsys=capsys)
    assert rc == 0
    rc, _, err = await run_cli(server, 'get', '/c', capsys=capsys)
    assert rc == 1 and 'NO_NODE' in err


async def test_cli_sequential_create(server, capsys):
    rc, out, _ = await run_cli(server, 'create', '-q', '/s-',
                               capsys=capsys)
    assert rc == 0 and out.strip() == '/s-0000000000'


async def test_cli_error_exit_status(server, capsys):
    rc, _, err = await run_cli(server, 'delete', '/nope',
                               capsys=capsys)
    assert rc == 1
    assert 'NO_NODE' in err


async def test_cli_watch_count(server, capsys):
    c = Client(address='127.0.0.1', port=server.port,
               session_timeout=5000)
    c.start()
    await c.wait_connected(timeout=5)
    await c.create('/w', b'v0')

    async def poke():
        await asyncio.sleep(0.3)
        await c.set('/w', b'v1')

    task = asyncio.get_event_loop().create_task(poke())
    # Arming emits the initial state first — created (existence watch),
    # dataChanged v0, childrenChanged [] in registration order — then
    # the set delivers dataChanged v1.
    rc, out, _ = await run_cli(server, 'watch', '/w', '--count', '4',
                               capsys=capsys)
    await task
    assert rc == 0
    lines = out.strip().splitlines()
    assert lines[:3] == ['created /w', "dataChanged /w b'v0'",
                         'childrenChanged /w []']
    assert lines[3] == "dataChanged /w b'v1'"
    await c.close()


async def test_cli_connect_failure_timeout(capsys):
    args = cli.build_parser().parse_args(
        ['--server', '127.0.0.1:1', '--timeout', '0.5', 'ping'])
    rc = await cli._run(args)
    _, err = capsys.readouterr()
    assert rc == 1 and 'could not connect' in err


async def test_cli_connect_failure_policy_exhausted(capsys):
    """With a long --timeout the pool exhausts its retry policy first
    and wait_connected raises ZKNotConnectedError (a ZKProtocolError,
    not a ZKError) — still a clean exit 1, not a traceback."""
    args = cli.build_parser().parse_args(
        ['--server', '127.0.0.1:1', '--timeout', '15', 'ping'])
    rc = await cli._run(args)
    _, err = capsys.readouterr()
    assert rc == 1 and 'could not connect' in err


async def test_cli_bad_path_is_usage_error(server, capsys):
    """A path without a leading slash is a clean exit-2 usage error,
    not a traceback."""
    rc, _, err = await run_cli(server, 'get', 'foo', capsys=capsys)
    assert rc == 2
    assert 'usage error' in err and 'foo' in err


def test_cli_import_main_is_inert():
    """Importing zkstream_tpu_torch.__main__ must not run the CLI or exit."""
    import importlib

    mod = importlib.import_module('zkstream_tpu_torch.__main__')
    assert hasattr(mod, 'main')


def test_cli_server_spec_parsing(capsys):
    parse = cli._parse_servers
    assert parse('h') == [{'address': 'h', 'port': 2181}]
    assert parse('h:1234') == [{'address': 'h', 'port': 1234}]
    assert parse('a:1,b:2') == [{'address': 'a', 'port': 1},
                                {'address': 'b', 'port': 2}]
    # bare IPv6 literal is a host, not a host:port split
    assert parse('::1') == [{'address': '::1', 'port': 2181}]
    assert parse('[::1]:99') == [{'address': '::1', 'port': 99}]
    assert parse('[fe80::2]') == [{'address': 'fe80::2', 'port': 2181}]
    # malformed specs are argparse usage errors (exit 2), not tracebacks
    # multi-colon specs that are not IPv6 literals are typos
    # (host:port:junk, missing comma), not hostnames
    for bad in ('h:', 'h:abc', ':9', 'h:0', 'h:99999', '[::1', '',
                'host:2181:junk', 'a:1:b:2'):
        with pytest.raises(SystemExit) as ei:
            cli.build_parser().parse_args(['-s', bad, 'ping'])
        assert ei.value.code == 2
        capsys.readouterr()


async def test_cli_codec_flag(server, capsys):
    """--codec native / python both serve a full get round trip; auto
    is the default (parser-level)."""
    for codec in ('native', 'python', 'ingest'):
        rc, out, _ = await run_cli(server, '--codec', codec,
                                   'create', '/k-%s' % codec, 'v',
                                   capsys=capsys)
        assert rc == 0
        rc, out, _ = await run_cli(server, '--codec', codec,
                                   'get', '/k-%s' % codec,
                                   capsys=capsys)
        assert rc == 0 and out == 'v\n'
    assert cli.build_parser().parse_args(['ping']).codec == 'auto'


async def test_cli_stat_flags_on_get_and_ls(server, capsys):
    rc, _, _ = await run_cli(server, 'create', '/sf', 'data')
    assert rc == 0
    capsys.readouterr()
    rc, out, _ = await run_cli(server, 'get', '--stat', '/sf',
                               capsys=capsys)
    assert rc == 0 and 'data' in out and 'dataLength = 4' in out
    rc, out, _ = await run_cli(server, 'ls', '--stat', '/',
                               capsys=capsys)
    assert rc == 0 and 'sf' in out and 'numChildren' in out


async def test_cli_create_ephemeral_holds_until_stdin_eof(
        server, capsys, monkeypatch):
    """create -e prints the path, announces the hold, and exits when
    stdin reaches EOF — the ephemeral is alive while held and reaped
    with the session on exit."""
    import io
    import sys as _sys

    import threading

    release = threading.Event()

    class HeldEOF(io.StringIO):
        def read(self, *a):
            release.wait(10)         # the test decides when EOF lands
            return ''

    monkeypatch.setattr(_sys, 'stdin', HeldEOF())
    task = asyncio.ensure_future(
        run_cli(server, 'create', '-e', '/held', 'x'))
    try:
        # while held: the ephemeral exists, owned by the CLI session
        # (observed server-side — no second client whose own
        # connection churn could fake an answer)
        await wait_until(lambda: '/held' in server.db.nodes)
        assert server.db.nodes['/held'].ephemeral_owner != 0
        release.set()                # EOF: the CLI closes its session
        rc, _, _ = await asyncio.wait_for(task, 10)
        assert rc == 0
        out, err = capsys.readouterr()
        assert out.strip() == '/held'
        assert 'holding ephemeral until EOF' in err
        # session closed: the node is reaped
        await wait_until(lambda: '/held' not in server.db.nodes)
    finally:
        release.set()


async def test_cli_watch_session_expiry_is_an_error_exit(
        server, capsys):
    task = asyncio.ensure_future(run_cli(server, 'watch', '/w'))
    await wait_until(lambda: bool(server.db.sessions))
    await asyncio.sleep(0.3)          # watcher armed
    for sid in list(server.db.sessions):
        server.db.expire_session(sid)
    rc, _, _ = await asyncio.wait_for(task, 10)
    out, err = capsys.readouterr()
    assert rc == 1 and 'session expired' in err


def _wal_fixture_dir(tmp_path, segment_bytes=300):
    """A closed WAL dir with a few segments and a snapshot."""
    from zkstream_tpu_torch.server.persist import open_wal_database

    d = str(tmp_path / 'wal')

    async def build():
        db = open_wal_database(d, sync='always',
                               segment_bytes=segment_bytes)
        for i in range(10):
            db.create('/w%d' % i, b'v%d' % i, None, 0, None)
        db.set_data('/w0', b'updated', -1)
        db.delete('/w9', -1)
        db.wal.close()
    asyncio.new_event_loop().run_until_complete(build())
    return d


def test_cli_wal_dump_and_verify(tmp_path, capsys):
    d = _wal_fixture_dir(tmp_path)
    rc = cli.main(['wal', d])
    out, err = capsys.readouterr()
    assert rc == 0, err
    assert 'segments:' in out and 'wal.' in out
    assert 'snapshots:' in out
    assert 'recovery:' in out and 'zxid 12' in out
    assert 'status: clean' in out
    # --records lists decoded ops with index/zxid/path
    rc = cli.main(['wal', d, '--records'])
    out, _ = capsys.readouterr()
    assert rc == 0
    assert 'create' in out and '/w3' in out
    assert 'delete' in out and 'set_data' in out


def test_cli_wal_reports_corruption(tmp_path, capsys):
    d = _wal_fixture_dir(tmp_path)
    segs = sorted(f for f in os.listdir(d) if f.startswith('wal.'))
    # flip a byte in the FIRST segment: mid-log corruption, exit 1
    p = os.path.join(d, segs[0])
    blob = bytearray(open(p, 'rb').read())
    blob[20] ^= 0xFF
    open(p, 'wb').write(bytes(blob))
    rc = cli.main(['wal', d])
    out, err = capsys.readouterr()
    assert rc == 1
    assert 'crc@' in out or 'corrupt@' in out
    assert 'STRUCTURAL CORRUPTION' in err


def test_cli_wal_torn_final_record_is_clean(tmp_path, capsys):
    """A torn FINAL record is the normal crash signature: reported,
    tolerated, exit 0 — exactly recovery's contract."""
    d = _wal_fixture_dir(tmp_path, segment_bytes=1 << 20)
    segs = sorted(f for f in os.listdir(d) if f.startswith('wal.'))
    p = os.path.join(d, segs[-1])
    size = os.path.getsize(p)
    with open(p, 'r+b') as f:
        f.truncate(size - 3)
    rc = cli.main(['wal', d])
    out, err = capsys.readouterr()
    assert rc == 0, err
    assert 'torn@' in out
    assert 'torn final record tolerated' in out


def test_cli_wal_empty_dir_errors(tmp_path, capsys):
    rc = cli.main(['wal', str(tmp_path)])
    _, err = capsys.readouterr()
    assert rc == 1 and 'no WAL state' in err


@pytest.mark.timeout(150)
async def test_cli_main_entry_via_subprocess(server):
    """python -m zkstream_tpu_torch: the real __main__/main()/argv path,
    against the fixture server over TCP.  The subprocess runs on an
    executor thread so this test's loop keeps serving the fixture."""
    import subprocess
    import sys as _sys

    out = await asyncio.get_running_loop().run_in_executor(
        None, lambda: subprocess.run(
            [_sys.executable, '-m', 'zkstream_tpu_torch',
             '--server', '127.0.0.1:%d' % server.port,
             '--session-timeout', '5000', 'ping'],
            capture_output=True, text=True, timeout=120, cwd=REPO))
    assert out.returncode == 0, (out.stdout, out.stderr)
    assert out.stdout.startswith('ping ok:')


# -- timeline: the causal-tracing demo + live trce scrape --------------

async def test_cli_timeline_demo_text_and_json(capsys):
    """`zkstream_tpu_torch timeline`: the self-contained in-process demo
    renders the merged causal chain for one watched write — client
    submit, leader commit + WAL append + group fsync, follower
    applies, fan-out delivery — and --json emits the schema-stamped
    rings + timeline."""
    import json

    args = cli.build_parser().parse_args(['timeline'])
    rc = await cli._timeline(args)
    out, _err = capsys.readouterr()
    assert rc == 0
    for op in ('SET_DATA', 'COMMIT', 'WAL_APPEND', 'GROUP_FSYNC',
               'APPLY', 'FANOUT'):
        assert op in out, out
    assert 'member:1' in out and 'member:2' in out

    args = cli.build_parser().parse_args(['timeline', '--json'])
    rc = await cli._timeline(args)
    out, _err = capsys.readouterr()
    assert rc == 0
    dump = json.loads(out)
    assert dump['trace_schema'] == 2
    assert set(dump['rings']) >= {'client', 'member:0', 'member:1'}
    assert any(e['op'] == 'GROUP_FSYNC' for e in dump['timeline'])


async def test_cli_timeline_live_scrapes_members(capsys, ensemble_cls):
    """`timeline --live` scrapes the trce rings of a running ensemble
    (no demo, no protocol session) and merges whatever they hold."""

    ens = await ensemble_cls(2).start()
    c = Client(servers=[{'address': h, 'port': p}
                        for h, p in ens.addresses()],
               shuffle_backends=False, session_timeout=5000)
    c.start()
    try:
        await c.wait_connected(timeout=5)
        await c.create('/live', b'x')
        await c.set('/live', b'y')
        spec = ','.join('127.0.0.1:%d' % p
                        for _h, p in ens.addresses())
        args = cli.build_parser().parse_args(
            ['--server', spec, 'timeline', '--live'])
        rc = await cli._timeline(args)
        out, _err = capsys.readouterr()
        assert rc == 0
        assert 'COMMIT' in out and '/live' in out
        assert 'member:1' in out and 'APPLY' in out
    finally:
        await c.close()
        await ens.stop()
