"""The port's command line prints what the JAX package's prints.

Each subcommand runs through both CLIs, ``zkstream_tpu_torch.cli`` with
``--device cpu`` and ``zkstream_tpu.cli``, against the same server (the
port's or the reference's, the ``server`` fixture of
tests/test_torch_basic.py), and the two outputs must be equal: byte for
byte where the command reads state both runs see alike, and with the
numbers that cannot repeat masked (latencies, times, zxids, counters
that the first run moved) where they cannot.  Commands that change the
tree run on a path of their own for each CLI (``/port`` and ``/ref``),
and their outputs are compared with the path swapped."""

import io
import json
import os
import re
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest

from zkstream_tpu import cli as ref_cli
from zkstream_tpu_torch import cli as port_cli
from test_torch_basic import server, server_cls  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM = re.compile(r'\d+(\.\d+)?')


async def _one(cli, argv, device):
    """One in-process CLI invocation -> (rc, stdout, stderr)."""
    pre = ['--device', 'cpu'] if device else []
    args = cli.build_parser().parse_args(pre + list(argv))
    # ``get`` writes its data to ``sys.stdout.buffer``
    out = io.TextIOWrapper(io.BytesIO(), encoding='utf-8',
                           write_through=True)
    err = io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        if args.cmd == 'mntr':
            rc = await cli._admin(args)
        elif args.cmd == 'reconfig':
            rc = await cli._reconfig(args)
        elif args.cmd == 'timeline':
            rc = await cli._timeline(args)
        elif args.cmd == 'top':
            rc = await cli._top(args)
        elif args.cmd in ('wal', 'blackbox', 'analyze'):
            rc = getattr(cli, '_' + args.cmd)(args)
        else:
            rc = await cli._run(args)
    return rc, out.buffer.getvalue().decode(), err.getvalue()


async def _both(argv, mask=False, swap=False):
    """Run ``argv`` through the port's CLI and the reference's and
    return both results, normalized alike.  ``swap``: the port's run
    uses ``/port`` where the argv says ``{p}``, the reference's
    ``/ref``."""
    got = []
    for cli, device, p in ((port_cli, True, '/port'),
                           (ref_cli, False, '/ref')):
        rc, out, err = await _one(
            cli, [a.replace('{p}', p) for a in argv], device)
        if swap:
            out, err = out.replace(p, '{p}'), err.replace(p, '{p}')
        if mask:
            out, err = NUM.sub('#', out), NUM.sub('#', err)
        got.append((rc, out, err))
    return got


@pytest.fixture(autouse=True)
def same_tiers():
    """Both packages' C extensions built and their transport probes
    refreshed, so both CLIs' clients pick the same batched backend (the
    ``metrics`` exposition labels it): an extension still building in
    the background leaves a probe on the next tier down."""
    from zkstream_tpu.io import transport as ref_transport
    from zkstream_tpu.utils import native as ref_native
    from zkstream_tpu_torch.io import transport
    from zkstream_tpu_torch.utils import native

    native.ensure_ext()
    ref_native.ensure_ext()
    assert transport.probe(refresh=True).chosen == \
        ref_transport.probe(refresh=True).chosen


def _srv(server):
    return ['--server', '127.0.0.1:%d' % server.port,
            '--session-timeout', '5000']


@pytest.fixture
def tree(event_loop, server):
    """/port and /ref with the same children, and /same for the reads
    both CLIs share."""
    async def setup():
        for root in ('/port', '/ref', '/same'):
            for path, data in ((root, 'r'), (root + '/a', 'hello'),
                               (root + '/b', '')):
                rc, _out, _err = await _one(
                    port_cli, _srv(server) + ['create', path, data], True)
                assert rc == 0
    event_loop.run_until_complete(setup())
    return server


READS = [
    ['get', '/same/a'], ['get', '/same/a', '--stat'], ['ls', '/same'],
    ['ls', '/same', '--stat'], ['stat', '/same/a'],
    ['getacl', '/same/a'], ['sync', '/same'], ['get', '/nope'],
    ['ls', '/nope'], ['get', 'bad-path'], ['stat', '/nope'],
]


@pytest.mark.parametrize('argv', READS, ids=['-'.join(a) for a in READS])
async def test_reads_print_the_same(tree, argv):
    port, ref = await _both(_srv(tree) + argv)
    assert port == ref


WRITES = [
    ['create', '{p}/c', 'x'], ['create', '-p', '{p}/d/e/f', 'y'],
    ['create', '-q', '{p}/q-', ''], ['create', '{p}/a', 'dup'],
    ['set', '{p}/a', 'world'], ['set', '-v', '7', '{p}/a', 'bad'],
    ['delete', '{p}/b'], ['delete', '{p}/nope'],
]


@pytest.mark.parametrize('argv', WRITES,
                         ids=['-'.join(a) for a in WRITES])
async def test_writes_print_the_same(tree, argv):
    port, ref = await _both(_srv(tree) + argv, swap=True)
    assert port == ref


async def test_ping_and_metrics_print_the_same(tree):
    port, ref = await _both(_srv(tree) + ['ping'], mask=True)
    assert port == ref and port[1] == 'ping ok: # ms\n'
    port, ref = await _both(_srv(tree) + ['metrics'], mask=True)
    assert port[0] == ref[0] == 0
    # the exposition lists the same series, and the port's own beside
    # them: the op stages (their values are timings) and the gauges of
    # the scope registrations' and the span ring's forms
    stage = 'zookeeper_op_stage_ms'
    own = (stage, 'zkstream_fsm_scope_registrations',
           'zkstream_trace_ring_spans')
    lines = port[1].splitlines()
    assert sorted(ln for ln in lines
                  if not any(name in ln for name in own)) == \
        sorted(ref[1].splitlines())
    assert any(ln.startswith(stage + '_count{stage="send"}')
               for ln in lines)
    assert any(ln.startswith(
        'zkstream_fsm_scope_registrations{form="method"} ')
        for ln in lines)
    assert any(ln.startswith(
        'zkstream_fsm_scope_registrations{form="callable"} ')
        for ln in lines)
    assert any(ln.startswith('zkstream_trace_ring_spans{form="row"} ')
               for ln in lines)


@pytest.mark.parametrize('word', ['mntr', 'ruok', 'srvr', 'stat'])
async def test_admin_words_print_the_same(tree, word):
    port, ref = await _both(_srv(tree) + ['mntr', word], mask=True)
    assert port[0] == ref[0] == 0
    if word == 'mntr':
        # the keys and the order; counters move between the two scrapes
        keys = [[ln.split('\t')[0] for ln in r[1].splitlines()]
                for r in (port, ref)]
        assert keys[0] == keys[1]
    else:
        assert port == ref


async def test_trce_and_top_print_the_same(tree):
    port, ref = await _both(_srv(tree) + ['mntr', 'trce'])
    assert port[0] == ref[0] == 0
    assert json.loads(port[1]).keys() == json.loads(ref[1]).keys()
    port, ref = await _both(_srv(tree) + ['top', '--count', '1',
                                          '--interval', '0'], mask=True)
    assert port == ref


async def test_unreachable_server_prints_the_same():
    argv = ['--server', '127.0.0.1:1', '--timeout', '0.5']
    for cmd in (['ping'], ['mntr'], ['reconfig', 'status']):
        port, ref = await _both(argv + cmd)
        assert port == ref and port[0] != 0


async def test_reconfig_and_timeline_print_the_same():
    """``reconfig status`` against the members of one in-process
    ensemble of each package, and the self-contained ``timeline`` demo
    (an in-process ensemble of the CLI's own package), numbers masked."""
    from zkstream_tpu.server import ZKEnsemble as RefZKEnsemble
    from zkstream_tpu_torch.server import ZKEnsemble

    for cls in (ZKEnsemble, RefZKEnsemble):
        ens = await cls(3).start()
        try:
            spec = ','.join('%s:%d' % a for a in ens.addresses())
            port, ref = await _both(['--server', spec, 'reconfig',
                                     'status'], mask=True)
            assert port == ref and port[0] == 0
        finally:
            await ens.stop()
    port, ref = await _both(['timeline', '--members', '2'], mask=True)
    assert port[0] == ref[0] == 0
    assert port[1].splitlines()[0] == ref[1].splitlines()[0]


def _wal_dir(tmp_path):
    from zkstream_tpu_torch.server.persist import WriteAheadLog
    from zkstream_tpu_torch.server.store import ZKDatabase

    d = str(tmp_path / 'wal')
    db = ZKDatabase()
    wal = WriteAheadLog(d, sync='always')
    wal.bind(db)
    from zkstream_tpu_torch.protocol.consts import CreateFlag
    from zkstream_tpu_torch.protocol.records import OPEN_ACL_UNSAFE
    for i in range(5):
        db.create('/w%d' % i, b'v%d' % i, OPEN_ACL_UNSAFE, CreateFlag(0),
                  None)
    wal.close()
    return d


@pytest.mark.parametrize('extra', [[], ['--records']])
async def test_wal_prints_the_same(tmp_path, extra):
    d = _wal_dir(tmp_path)
    port, ref = await _both(['wal', d] + extra)
    assert port == ref and port[0] == 0


async def test_blackbox_and_analyze_print_the_same(tmp_path):
    d = str(tmp_path / 'empty')
    os.makedirs(d)
    port, ref = await _both(['blackbox', d])
    assert port == ref
    corpus = os.path.join(REPO, 'tests', 'analyze_corpus')
    readme = os.path.join(corpus, 'corpus_readme.md')
    for name in sorted(os.listdir(corpus)):
        if not name.endswith('.py'):
            continue
        port, ref = await _both(['analyze', os.path.join(corpus, name),
                                 '--readme', readme])
        assert port == ref, name


def test_chaos_transport_prints_the_same(capsys):
    """One seeded transport-tier schedule through each CLI's ``main``:
    the same summary, numbers masked (the schedule's timing varies)."""
    outs = []
    for cli, pre in ((port_cli, ['--device', 'cpu']), (ref_cli, [])):
        rc = cli.main(pre + ['chaos', '--tier', 'transport',
                             '--schedules', '1', '--seed', '3',
                             '--quiet'])
        out = capsys.readouterr().out
        outs.append((rc, NUM.sub('#', out.splitlines()[-1])))
    assert outs[0] == outs[1] and outs[0][0] == 0


def test_parsers_take_the_same_commands():
    """Both parsers offer the same subcommands and options; the port's
    adds only ``--device``, whose default is the card."""
    def shape(p):
        sub = next(a for a in p._actions
                   if a.__class__.__name__ == '_SubParsersAction')
        opts = sorted(o for a in p._actions for o in a.option_strings)
        cmds = {name: sorted(o for a in sp._actions
                             for o in a.option_strings)
                for name, sp in sub.choices.items()}
        return opts, cmds
    popts, pcmds = shape(port_cli.build_parser())
    ropts, rcmds = shape(ref_cli.build_parser())
    assert pcmds == rcmds
    assert sorted(set(popts) - set(ropts)) == ['--device']
    assert port_cli.build_parser().parse_args(['ping']).device == 'cuda'
    assert sys.modules['zkstream_tpu_torch.cli'] is port_cli
