"""Command-line client: ``python -m zkstream_tpu_torch <cmd> ...``.

The reference ecosystem's workflow leans on the Apache ``zkCli`` for
poking at a ZooKeeper tree (the reference's own tests shell out to it
for cross-validation, test/zkserver.js:72-164); this is the rebuild's
equivalent, built on the public ``Client``.

Commands: ls, get, set, create, delete, stat, getacl, sync, ping,
watch.  Exit status 0 on success, 1 on a ZooKeeper error (message on
stderr), 2 on usage errors.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import sys

from .client import Client
from .protocol.consts import CreateFlag
from .protocol.errors import ZKError, ZKProtocolError
from .protocol.records import Stat


def _parse_servers(value: str) -> list[dict]:
    """--server argument type: ``host[:port][,host[:port]...]`` with
    ``[v6addr]:port`` brackets; a bare IPv6 literal is a host.  Raises
    ArgumentTypeError (argparse usage error, exit 2) on bad specs."""
    servers = []
    for spec in value.split(','):
        spec = spec.strip()
        try:
            if spec.startswith('['):
                host, sep, rest = spec[1:].partition(']')
                if not sep or (rest and not rest.startswith(':')):
                    raise ValueError('bad [v6]:port syntax')
                port = int(rest[1:]) if rest else 2181
            elif spec.count(':') == 1:
                host, port_s = spec.split(':')
                port = int(port_s)
            elif spec.count(':') >= 2:
                # Only a genuine IPv6 literal may contain multiple
                # colons; anything else (host:2181:junk, a missing
                # comma) is a usage error, not a hostname.
                import ipaddress
                try:
                    ipaddress.IPv6Address(spec)
                except ValueError:
                    raise ValueError(
                        'multiple colons but not an IPv6 literal '
                        '(use [v6addr]:port, or a comma between specs)')
                host, port = spec, 2181
            else:  # bare hostname or IPv4
                host, port = spec, 2181
            if not host or not 0 < port < 65536:
                raise ValueError('empty host or port out of range')
        except ValueError as e:
            raise argparse.ArgumentTypeError(
                'invalid server spec %r: %s' % (spec, e))
        servers.append({'address': host, 'port': port})
    return servers


def _print_stat(stat: Stat) -> None:
    for name in Stat._fields:
        print('%s = %s' % (name, getattr(stat, name)))


async def _run(args) -> int:
    # Validate user arguments BEFORE connecting, with the same checks
    # the client API applies, so bad input is a clean exit-2 usage
    # error while later ValueErrors (e.g. a malformed server reply)
    # still surface as real errors.
    try:
        if getattr(args, 'path', None) is not None:
            Client._check_path(args.path)
        if getattr(args, 'version', None) is not None:
            Client._check_version(args.version)
    except (ValueError, TypeError) as e:
        print('usage error: %s' % (e,), file=sys.stderr)
        return 2

    addrs = ','.join('%s:%d' % (s['address'], s['port'])
                     for s in args.server)
    use_native = {'auto': None, 'native': True,
                  'python': False, 'ingest': None}[args.codec]
    ingest = None
    if args.codec == 'ingest':
        # the batched device plane with its production defaults
        # (measured bypass crossover, background warm) — CROSSOVER.md;
        # on --device (cuda unless asked otherwise: no card, it raises)
        from .io.ingest import FleetIngest
        ingest = FleetIngest(body_mode='host', device=args.device)
    client = Client(servers=args.server,
                    session_timeout=args.session_timeout,
                    use_native_codec=use_native, ingest=ingest)
    client.start()
    try:
        try:
            await client.wait_connected(timeout=args.timeout)
        except (TimeoutError, asyncio.TimeoutError, ZKProtocolError):
            # timeout, or the pool exhausted its retry policy (failed)
            print('error: could not connect to %s' % (addrs,),
                  file=sys.stderr)
            return 1
        return await _dispatch(client, args)
    except (ZKError, ZKProtocolError) as e:
        print('error: %s (%s)' % (e.message, e.code), file=sys.stderr)
        return 1
    finally:
        await client.close()


async def _dispatch(client: Client, args) -> int:
    cmd = args.cmd
    if cmd == 'ping':
        latency = await client.ping()
        print('ping ok: %.1f ms' % (latency,))
    elif cmd == 'ls':
        children, stat = await client.list(args.path)
        for name in sorted(children):
            print(name)
        if args.stat:
            _print_stat(stat)
    elif cmd == 'get':
        data, stat = await client.get(args.path)
        out = sys.stdout.buffer
        out.write(data)
        if data and not data.endswith(b'\n'):
            out.write(b'\n')
        out.flush()
        if args.stat:
            _print_stat(stat)
    elif cmd == 'stat':
        _print_stat(await client.stat(args.path))
    elif cmd == 'getacl':
        from .protocol.consts import Perm
        for acl in await client.get_acl(args.path):
            # iterate the enum, not the flag value: Flag-member
            # iteration only exists on Python >= 3.11
            perms = '|'.join(sorted(
                p.name for p in Perm
                if p is not Perm.ALL and p in acl.perms))
            print('%s:%s = %s' % (acl.id.scheme, acl.id.id, perms))
    elif cmd == 'create':
        flags = CreateFlag(0)
        if args.ephemeral:
            flags |= CreateFlag.EPHEMERAL
        if args.sequential:
            flags |= CreateFlag.SEQUENTIAL
        data = args.data.encode() if args.data is not None else b''
        if args.parents:
            path = await client.create_with_empty_parents(
                args.path, data, flags=flags)
        else:
            path = await client.create(args.path, data, flags=flags)
        print(path)
        if args.ephemeral:
            # An ephemeral dies with its session: hold it until EOF so
            # the invocation is actually observable from elsewhere.  A
            # DAEMON thread (not the default executor) watches stdin so
            # ctrl-c exits promptly instead of hanging on executor join.
            print('holding ephemeral until EOF (ctrl-d) ...',
                  file=sys.stderr)
            import threading
            loop = asyncio.get_running_loop()
            eof: asyncio.Future = loop.create_future()

            def _stdin_eof():
                try:
                    sys.stdin.read()
                finally:
                    loop.call_soon_threadsafe(
                        lambda: eof.done() or eof.set_result(None))
            threading.Thread(target=_stdin_eof, daemon=True).start()
            await eof
    elif cmd == 'set':
        stat = await client.set(args.path, args.data.encode(),
                                version=args.version)
        print('version = %d' % (stat.version,))
    elif cmd == 'delete':
        await client.delete(args.path, args.version)
    elif cmd == 'sync':
        await client.sync(args.path)
    elif cmd == 'metrics':
        # one ping so the scrape is never empty of samples, then the
        # client collector's full Prometheus exposition (per-op
        # latency histograms, FSM transition counters, gauges)
        await client.ping()
        print(client.collector.expose())
    elif cmd == 'watch':
        return await _watch(client, args)
    else:  # pragma: no cover - argparse enforces choices
        raise AssertionError(cmd)
    return 0


async def _watch(client: Client, args) -> int:
    stop: asyncio.Future = asyncio.get_running_loop().create_future()
    seen = [0]

    def fire(evt):
        def cb(*a):
            extra = ''
            if evt == 'dataChanged' and a:
                extra = ' %r' % (bytes(a[0]),)
            elif evt == 'childrenChanged' and a:
                extra = ' %s' % (sorted(a[0]),)
            print('%s %s%s' % (evt, args.path, extra), flush=True)
            seen[0] += 1
            if args.count and seen[0] >= args.count and not stop.done():
                stop.set_result(None)
        return cb

    w = client.watcher(args.path)
    for evt in ('created', 'deleted', 'dataChanged', 'childrenChanged'):
        w.on(evt, fire(evt))
    client.on('expire', lambda *a: stop.done() or
              stop.set_exception(RuntimeError('session expired')))
    try:
        await stop
    except RuntimeError as e:
        print('error: %s' % (e,), file=sys.stderr)
        return 1
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog='python -m zkstream_tpu_torch',
        description='ZooKeeper command-line client '
                    '(zkstream_tpu_torch)')
    p.add_argument('--server', '-s', type=_parse_servers,
                   default=[{'address': '127.0.0.1', 'port': 2181}],
                   help='host[:port][,host[:port]...]; [v6]:port for '
                        'IPv6 (default 127.0.0.1:2181)')
    p.add_argument('--session-timeout', type=int, default=30000,
                   help='ZK session timeout, ms')
    p.add_argument('--timeout', type=float, default=10.0,
                   help='connect timeout, seconds')
    p.add_argument('--codec',
                   choices=('auto', 'native', 'python', 'ingest'),
                   default='auto',
                   help='receive decoder: the C extension when built '
                        '(native: require it; python: scalar codec; '
                        'ingest: the batched device plane with its '
                        'production crossover; default auto)')
    p.add_argument('--device', choices=('cuda', 'cpu'), default='cuda',
                   help='where the batched device plane runs its '
                        'ticks (--codec ingest, and the chaos '
                        "ensemble tier's ingests); default cuda, "
                        'which raises without a card rather than '
                        'fall back to the CPU')
    sub = p.add_subparsers(dest='cmd', required=True)

    sub.add_parser('ping', help='round-trip a ping')

    ls = sub.add_parser('ls', help='list children')
    ls.add_argument('path')
    ls.add_argument('--stat', action='store_true',
                    help='also print the Stat')

    get = sub.add_parser('get', help='print node data')
    get.add_argument('path')
    get.add_argument('--stat', action='store_true')

    st = sub.add_parser('stat', help='print the Stat record')
    st.add_argument('path')

    ga = sub.add_parser('getacl', help='print the ACL list')
    ga.add_argument('path')

    cr = sub.add_parser('create', help='create a node')
    cr.add_argument('path')
    cr.add_argument('data', nargs='?', default=None)
    cr.add_argument('--ephemeral', '-e', action='store_true')
    cr.add_argument('--sequential', '-q', action='store_true')
    cr.add_argument('--parents', '-p', action='store_true',
                    help='create missing parents (persistent, b"null")')

    se = sub.add_parser('set', help='set node data')
    se.add_argument('path')
    se.add_argument('data')
    se.add_argument('--version', '-v', type=int, default=-1)

    de = sub.add_parser('delete', help='delete a node')
    de.add_argument('path')
    de.add_argument('--version', '-v', type=int, default=-1)

    sy = sub.add_parser('sync', help='sync a path with the leader')
    sy.add_argument('path')

    mn = sub.add_parser(
        'mntr',
        help='scrape a live server with a ZooKeeper four-letter '
             'admin word (raw TCP, no session)')
    mn.add_argument('word', nargs='?', default='mntr',
                    choices=('mntr', 'ruok', 'stat', 'srvr', 'trce'),
                    help='which admin word to send (default mntr; '
                         'trce dumps the member span ring as JSON)')

    rc = sub.add_parser(
        'reconfig',
        help='dynamic membership admin (README "Dynamic '
             'membership"): show or change the ensemble '
             'voter/observer sets at runtime over the rcfg admin '
             'channel (raw TCP, no session)')
    rc.add_argument('action', nargs='?', default='status',
                    choices=('status', 'propose', 'commit', 'apply'),
                    help='status scrapes every --server member; '
                         'propose lands the reconfig record (the '
                         'JOINT record for a voter change) and '
                         'stops; commit finishes an open joint '
                         'window; apply = propose + await joint '
                         'quorum + commit + await final quorum '
                         '(mutating actions walk --server until a '
                         'member answers as leader)')
    rc.add_argument('voters', nargs='?', default=None,
                    help='comma-separated member ids of the NEW '
                         'voter set (propose/apply)')
    rc.add_argument('observers', nargs='?', default=None,
                    help='comma-separated member ids of the new '
                         'observer set ("-" for none; default: '
                         'current observers minus any promoted '
                         'member)')

    tl = sub.add_parser(
        'timeline',
        help='render a merged zxid-ordered causal timeline: one '
             'traced write followed across client, leader (commit, '
             'WAL append, shared group-fsync span), followers '
             '(apply) and watch fan-out delivery.  Default: run a '
             'self-contained in-process ensemble demo; --live '
             'scrapes the member rings of the --server list (trce '
             'admin word) instead')
    tl.add_argument('--live', action='store_true',
                    help='scrape live members (--server) rather than '
                         'running the in-process demo')
    tl.add_argument('--members', type=int, default=3,
                    help='demo ensemble size (default 3)')
    tl.add_argument('--json', dest='as_json', action='store_true',
                    help='emit trace_schema-stamped JSON (rings + '
                         'merged timeline) instead of text')

    sub.add_parser(
        'metrics',
        help='connect, ping once, and print the client collector '
             'in Prometheus exposition format')

    wa = sub.add_parser('watch', help='stream watch events for a path')
    wa.add_argument('path')
    wa.add_argument('--count', '-n', type=int, default=0,
                    help='exit after N events (default: forever)')

    wl = sub.add_parser(
        'wal',
        help='dump/verify a write-ahead-log directory '
             '(server/persist.py): segment listing with CRC32C '
             'verification, snapshot inventory, truncation point, '
             'recovery summary — no server, no session')
    wl.add_argument('dir', help='WAL directory (ZKSTREAM_WAL_DIR / '
                                'ZKServer(wal_dir=))')
    wl.add_argument('--records', action='store_true',
                    help='also list every decoded record '
                         '(index, zxid, op, path, bytes)')

    bb = sub.add_parser(
        'blackbox',
        help='verify and render the flight-recorder rings in a WAL '
             'directory (utils/blackbox.py): per-member frame '
             'listing with CRC32C verification — a dead member\'s '
             'last mntr counters, tick phases, FSM census and span '
             'tail.  Torn final frame tolerated (the crash '
             'signature), bit flips rejected; no server, no session')
    bb.add_argument('dir', help='the member\'s wal_dir (the rings '
                                'are blackbox.<member>.log '
                                'co-tenants of the WAL)')
    bb.add_argument('--json', dest='as_json', action='store_true',
                    help='emit blackbox_schema-stamped JSON (every '
                         'frame) instead of the text summary')

    tp = sub.add_parser(
        'top',
        help='continuous fleet collector: poll mntr across every '
             '--server member, render live per-member deltas (role, '
             'epoch, config version, slow ops, quorum degradations) '
             'and optionally append a top_schema-stamped JSONL '
             'time-series — point-in-time scrapes become '
             'trajectories (works against OS-process members)')
    tp.add_argument('--interval', type=float, default=2.0,
                    help='seconds between polls (default 2)')
    tp.add_argument('--count', type=int, default=0,
                    help='stop after N polls (default: forever)')
    tp.add_argument('--out', metavar='PATH', default=None,
                    help='append one JSON line per member per poll '
                         '(top_schema-stamped) to PATH')

    an = sub.add_parser(
        'analyze',
        help='run the semantic static-analysis tier '
             '(zkstream_tpu_torch/analysis/: loop-blocking, '
             'await-under-lock, span-leak, fault-order, knob/metric '
             'drift) and emit schema-stamped JSON findings — exit 1 '
             'when any exist, so chaos/CI harnesses consume it like '
             'wal/mntr.  No server, no session')
    an.add_argument('paths', nargs='*', default=None,
                    help='files/directories (default: the installed '
                         'zkstream_tpu_torch package)')
    an.add_argument('--readme', default=None,
                    help='README to diff the knob/metric inventory '
                         'against (default: walk up from the first '
                         'target)')
    an.add_argument('--text', action='store_true',
                    help='human-readable findings instead of JSON')

    ch = sub.add_parser(
        'chaos',
        help='run seeded fault-injection schedules against an '
             'in-process server and verify the resilience invariants')
    ch.add_argument('--tier',
                    choices=('transport', 'ensemble', 'process'),
                    default='transport',
                    help='transport: byte/socket faults against one '
                         'server; ensemble: member kills/restarts, '
                         'replication partitions and session '
                         'migration with the history-checked '
                         'invariant engine (io/invariants.py); '
                         'process: OS-process peer members — seeded '
                         'elected-leader kill loops (each leader '
                         'SIGKILLed immediately after acking a '
                         'quorum-committed write, which must survive '
                         'the election) plus full-ensemble SIGKILL '
                         '-> election from recovered WALs '
                         '(server/election.py)')
    ch.add_argument('--seed', type=int, default=0,
                    help='base seed; schedule i uses seed+i (default 0)')
    ch.add_argument('--schedules', type=int, default=20,
                    help='number of consecutive seeded schedules')
    ch.add_argument('--ops', type=int, default=None,
                    help='client ops per schedule (default 6 for '
                         'transport, 12 plan steps for ensemble)')
    ch.add_argument('--quiet', action='store_true',
                    help='only print failing schedules + the summary')
    ch.add_argument('--no-watchtable', action='store_true',
                    help='rerun on the per-connection emitter '
                         'fallback instead of the sharded watch '
                         'fan-out table (server/watchtable.py) — '
                         'bisects whether a failing seed implicates '
                         'the table')
    ch.add_argument('--clients', type=int, default=None,
                    help='ensemble/process tiers: drive N CONCURRENT '
                         'clients over a small shared key set '
                         '(io/faults.py run_concurrent_schedule) and '
                         'check the two-sided history per key with '
                         'the WGL linearizability pass '
                         '(analysis/linearize.py, invariant 9).  '
                         'Part of the rerun key: seed + this flag '
                         'reproduce the schedule exactly.  Default: '
                         '1 (the classic single-client workload)')
    ch.add_argument('--observers', type=int, default=None,
                    help='ensemble/process tiers: attach N '
                         'non-voting observer members (the read '
                         'plane, README "Read plane") — clients run '
                         'with read distribution on, the observer '
                         'lag/partition fault vocabulary draws from '
                         'its own RNG stream, and the newly wired '
                         'session-monotone read check '
                         '(analysis/linearize.py '
                         'check_session_reads) is the invariant '
                         'under test.  Part of the rerun key like '
                         '--clients.  Default: drawn per seed '
                         '(ensemble tier) / 0 (process tier)')
    ch.add_argument('--overload', action='store_true',
                    help='force overload bursts into every schedule '
                         '(README "Overload plane"): the ensemble/'
                         'concurrent tiers draw forced pressure '
                         'steps — raw connection floods against the '
                         'admission caps + pacer, stalled client '
                         'readers (slow-consumer defense), and '
                         'oversized declared frames the member must '
                         'refuse with a definite close.  Part of '
                         'the rerun key like --clients.  Default: '
                         'drawn per seed')
    ch.add_argument('--cached', action='store_true',
                    help='ensemble/process tiers: run every '
                         "schedule's clients with the watch-backed "
                         'client cache on (README "Client cache '
                         'plane", io/cache.py cache="/"): reads are '
                         'served from the persistent-recursive-'
                         'watch-backed local cache whenever '
                         'coherent, and check_session_reads must '
                         'still hold on every locally served read '
                         '(a cached read can never time-travel). '
                         'Part of the rerun key like --clients.  '
                         'Default: drawn per seed (ensemble tier) / '
                         'off (process tier)')
    ch.add_argument('--reconfig', action='store_true',
                    help='force membership reconfigurations into '
                         'every schedule (README "Dynamic '
                         'membership"): the ensemble/concurrent '
                         'tiers draw forced reconfig steps (observer '
                         'join/leave, voter add/remove/replace with '
                         'joint-majority handoff; the first step is '
                         'always a voter replace), the process tier '
                         'drives a fenced voter replace per elected '
                         'era plus one full-ensemble SIGKILL '
                         'mid-joint recovered from WAL CONTROL '
                         'records.  Part of the rerun key like '
                         '--clients/--observers.  Default: drawn '
                         'per seed (ensemble tiers) / off (process)')
    ch.add_argument('--elections', type=int, default=None,
                    help='ensemble tier: force N leader elections '
                         'per schedule (kill the current leader at '
                         'evenly spaced steps; each must elect a '
                         'successor).  Part of the rerun key: seed + '
                         'this flag reproduce the schedule exactly. '
                         'Default: drawn per seed')
    ch.add_argument('--no-election', action='store_true',
                    help='rerun with the static member-0 leader '
                         '(ZKSTREAM_NO_ELECTION=1) — bisects whether '
                         'a failing seed implicates the election '
                         'plane (server/election.py)')
    ch.add_argument('--transport',
                    choices=('uring', 'mmsg', 'asyncio'),
                    default=None,
                    help='rerun on a forced transport backend '
                         '(io/transport.py; ZKSTREAM_TRANSPORT) — '
                         'bisects whether a failing seed implicates '
                         'the batched-syscall tier.  Forcing an '
                         'unavailable backend falls DOWN the '
                         'uring>mmsg>asyncio order, so the rerun '
                         'still executes (the summary names the '
                         'resolved backend)')
    ch.add_argument('--ingress-shards', type=int, default=None,
                    dest='ingress_shards', metavar='N',
                    help='rerun with a forced ingress shard count '
                         '(io/ingress.py; ZKSTREAM_INGRESS_SHARDS) — '
                         'part of the rerun key like --transport: '
                         'N>1 forces the sharded accept + batched '
                         'receive drain, 1 forces the single-loop '
                         'validator, so a failing seed bisects to '
                         'the ingress plane')
    ch.add_argument('--trace-out', metavar='PATH', default=None,
                    help='write every schedule\'s xid-correlated span '
                         'dump — member kill/restart events included '
                         'on the ensemble tier — as JSON to PATH for '
                         'offline triage')
    return p


async def _admin_one(host: str, port: int, word: str,
                     timeout: float) -> bytes:
    """One raw four-letter-word round trip; raises OSError/timeout."""
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(host, port), timeout)
    try:
        writer.write(word.encode('ascii'))
        await writer.drain()
        return await asyncio.wait_for(reader.read(), timeout)
    finally:
        writer.close()


async def _admin(args) -> int:
    """Send one four-letter admin word over raw TCP (no ZK session)
    to EVERY server in --server — an ensemble health probe scrapes
    each member, it does not stop at the first — and print the
    replies (prefixed by member when more than one).  Exit 0 when all
    answered, 1 when any was unreachable."""
    failed = 0
    many = len(args.server) > 1
    for spec in args.server:
        host, port = spec['address'], spec['port']
        if many:
            print('--- %s:%d ---' % (host, port))
        try:
            data = await _admin_one(host, port, args.word,
                                    args.timeout)
        except (OSError, asyncio.TimeoutError, TimeoutError):
            print('error: could not connect to %s:%d' % (host, port),
                  file=sys.stderr)
            failed += 1
            continue
        sys.stdout.write(data.decode('utf-8', 'replace'))
        if data and not data.endswith(b'\n'):
            sys.stdout.write('\n')
    return 1 if failed else 0


async def _reconfig(args) -> int:
    """Drive the ``rcfg`` dynamic-membership admin channel (README
    "Dynamic membership") over raw TCP — no ZK session, like the
    four-letter words.  ``status`` scrapes every --server member;
    the mutating actions (propose/commit/apply) walk the member list
    until one answers as leader, since only the leader may land
    CONTROL records."""
    if args.action in ('propose', 'apply') and not args.voters:
        print('error: %s needs a voter list (comma-separated '
              'member ids)' % (args.action,), file=sys.stderr)
        return 2
    line = args.action
    if args.voters:
        line += ' ' + args.voters
        if args.observers:
            line += ' ' + args.observers
    if args.action == 'status':
        failed = 0
        many = len(args.server) > 1
        for spec in args.server:
            host, port = spec['address'], spec['port']
            if many:
                print('--- %s:%d ---' % (host, port))
            try:
                reply = await _admin_one(host, port, 'rcfg status\n',
                                         args.timeout)
            except (OSError, asyncio.TimeoutError, TimeoutError):
                print('error: could not connect to %s:%d'
                      % (host, port), file=sys.stderr)
                failed += 1
                continue
            sys.stdout.write(reply.decode('utf-8', 'replace'))
        return 1 if failed else 0
    for spec in args.server:
        host, port = spec['address'], spec['port']
        try:
            reply = (await _admin_one(
                host, port, 'rcfg %s\n' % (line,),
                args.timeout)).decode('utf-8', 'replace')
        except (OSError, asyncio.TimeoutError, TimeoutError):
            continue
        if reply.startswith('error not leader'):
            continue
        sys.stdout.write(reply)
        return 1 if reply.startswith('error') else 0
    print('error: no member accepted %r (no reachable leader?)'
          % (line,), file=sys.stderr)
    return 1


async def _chaos(args) -> int:
    """Drive the seeded chaos campaign (io/faults.py) and report.
    Exit 0 when every schedule's invariants held, 1 otherwise; each
    line carries the seed, so any failure reruns with --seed N
    (--tier ensemble for the failover tier) — and arrives with its
    xid-correlated span dump (utils/trace.py) plus, on the ensemble
    tier, the member-event timeline, so the failing interleaving is
    visible without log grepping."""
    from .io.faults import run_campaign, run_ensemble_campaign
    from .io.invariants import format_history
    from .utils.trace import (
        TRACE_SCHEMA,
        format_spans,
        format_timeline,
        merge_timelines,
    )

    if getattr(args, 'no_watchtable', False):
        # the schedule servers resolve their dispatch path from the
        # env at construction, exactly like the cork/codec tiers
        os.environ['ZKSTREAM_NO_WATCHTABLE'] = '1'
    if getattr(args, 'no_election', False):
        os.environ['ZKSTREAM_NO_ELECTION'] = '1'
    if getattr(args, 'transport', None):
        # the schedule servers/clients resolve their backend from the
        # env at construction (io/transport.py); part of the rerun key
        os.environ['ZKSTREAM_TRANSPORT'] = args.transport
        from .io.transport import backend_default
        print('# transport backend forced: %s (resolved: %s)'
              % (args.transport, backend_default()))
    if getattr(args, 'ingress_shards', None):
        # the schedule servers resolve their receive path from the
        # env at construction (io/ingress.py); part of the rerun key
        os.environ['ZKSTREAM_INGRESS_SHARDS'] = \
            str(args.ingress_shards)
        from .io.ingress import backend_default as rx_default
        print('# ingress shards forced: %d (backend: %s)'
              % (args.ingress_shards,
                 rx_default() if args.ingress_shards > 1
                 else 'asyncio'))

    def progress(r):
        if args.quiet and r.ok:
            return
        status = 'ok ' if r.ok else 'FAIL'
        print('seed %6d  %s  ops=%d acked=%d typed_errs=%d '
              'deadline=%d faults=%d watch_fires=%d%s%s%s'
              % (r.seed, status, r.ops, r.acked, r.typed_errors,
                 r.deadline_errors, r.faults, r.watch_fires,
                 '' if r.tier == 'transport'
                 else ' member_events=%d' % (len(r.member_events),),
                 '' if not r.elections
                 else ' elections=%d' % (r.elections,),
                 '' if r.clients <= 1
                 else ' clients=%d' % (r.clients,)))
        for v in r.violations:
            print('    violation: %s' % (v,))
        if not r.ok and r.history:
            timeline = format_history(r.history)
            if timeline:
                print('  member-event timeline:')
                print(timeline)
            if any(rec['kind'] == 'invoke' for rec in r.history):
                # the concurrent tier: a linearizability
                # counterexample window (in the violations above) is
                # read against the per-client interleaving
                print('  per-client interleaving:')
                print(format_history(r.history, columns=True))
        if not r.ok and r.trace:
            print('  span ring (oldest first):')
            print(format_spans(r.trace))
        if not r.ok and (r.trace or r.member_rings):
            # the cross-member view: client + member rings merged by
            # zxid, so the violated write's full causal path (commit,
            # fsync barrier, replication, follower apply, fan-out) is
            # on screen next to the seed
            merged = merge_timelines(
                dict({'client': r.trace}, **r.member_rings))
            if merged:
                print('  merged causal timeline (zxid order):')
                print(format_timeline(merged, limit=60))

    if args.tier == 'ensemble':
        results = await run_ensemble_campaign(
            args.seed, args.schedules,
            ops=args.ops if args.ops is not None else 12,
            progress=progress,
            elections=getattr(args, 'elections', None),
            clients=getattr(args, 'clients', None),
            observers=getattr(args, 'observers', None),
            # --reconfig forces two steps per schedule; the FIRST
            # executed step is always a voter replace (io/faults.py),
            # so every campaign holds >= 1 joint-majority handoff
            reconfigs=2 if getattr(args, 'reconfig', False) else None,
            # --overload likewise forces two pressure bursts per
            # schedule (flood / stalled reader / oversized frame)
            overloads=2 if getattr(args, 'overload', False)
            else None,
            # --cached forces the watch-backed client cache on for
            # every schedule (default: drawn per seed)
            cached=True if getattr(args, 'cached', False) else None,
            device=getattr(args, 'device', 'cuda'))
    elif args.tier == 'process':
        if getattr(args, 'no_election', False):
            # the process tier IS the election plane: there is no
            # static-leader variant of symmetric peers to bisect to
            print('error: --no-election has no meaning on the '
                  'process tier (symmetric peers have no static '
                  'leader); use --tier ensemble', file=sys.stderr)
            return 2
        if getattr(args, 'overload', False):
            print('error: --overload runs on the in-process '
                  'ensemble tier; use --tier ensemble',
                  file=sys.stderr)
            return 2
        from .server.election import run_process_campaign
        results = await run_process_campaign(
            args.seed, args.schedules,
            ops=args.ops if args.ops is not None else 6,
            progress=progress,
            elections=getattr(args, 'elections', None),
            clients=getattr(args, 'clients', None),
            observers=getattr(args, 'observers', None),
            reconfig=getattr(args, 'reconfig', False),
            cached=getattr(args, 'cached', False))
    else:
        if getattr(args, 'clients', None) and args.clients > 1:
            print('error: --clients needs the history-checked '
                  'tiers; use --tier ensemble or --tier process',
                  file=sys.stderr)
            return 2
        if getattr(args, 'observers', None):
            print('error: --observers needs an ensemble; use '
                  '--tier ensemble or --tier process',
                  file=sys.stderr)
            return 2
        if getattr(args, 'reconfig', False):
            print('error: --reconfig needs an ensemble; use '
                  '--tier ensemble or --tier process',
                  file=sys.stderr)
            return 2
        if getattr(args, 'overload', False):
            print('error: --overload needs an ensemble; use '
                  '--tier ensemble (the transport tier draws its '
                  'own overload slice per seed)', file=sys.stderr)
            return 2
        if getattr(args, 'cached', False):
            print('error: --cached needs the history-checked '
                  'tiers (check_session_reads is what holds the '
                  'cache coherent); use --tier ensemble or --tier '
                  'process', file=sys.stderr)
            return 2
        results = await run_campaign(
            args.seed, args.schedules,
            ops=args.ops if args.ops is not None else 6,
            progress=progress)
    if args.trace_out:
        import json
        with open(args.trace_out, 'w') as f:
            # member kill/restart events ride the span ring (kind
            # 'member') AND the structured history; bytes payloads in
            # history records serialize via repr.  Each schedule is
            # schema-stamped and carries every member's server-side
            # ring plus the merged zxid-ordered timeline.
            json.dump([{'trace_schema': TRACE_SCHEMA,
                        'seed': r.seed, 'ok': r.ok, 'tier': r.tier,
                        'violations': r.violations,
                        'member_events': r.member_events,
                        'trace': r.trace,
                        'member_rings': r.member_rings,
                        'timeline': merge_timelines(
                            dict({'client': r.trace},
                                 **r.member_rings)),
                        'history': r.history}
                       for r in results], f, indent=2, default=repr)
        print('span dumps written to %s' % (args.trace_out,))
    bad = [r for r in results if not r.ok]
    print('%d/%d schedules ok (%d faults injected, %d typed errors, '
          '%d deadline errors)'
          % (len(results) - len(bad), len(results),
             sum(r.faults for r in results),
             sum(r.typed_errors for r in results),
             sum(r.deadline_errors for r in results)))
    if bad:
        clients = getattr(args, 'clients', None)
        observers = getattr(args, 'observers', None)
        print('failing seeds (rerun: python -m zkstream_tpu_torch '
              'chaos --tier %s%s%s%s%s --seed N --schedules 1): %s'
              % (args.tier,
                 ' --clients %d' % (clients,)
                 if clients and clients > 1 else '',
                 ' --observers %d' % (observers,)
                 if observers else '',
                 ' --reconfig'
                 if getattr(args, 'reconfig', False) else '',
                 ' --overload'
                 if getattr(args, 'overload', False) else '',
                 ', '.join(str(r.seed) for r in bad)),
              file=sys.stderr)
        return 1
    return 0


async def _timeline(args) -> int:
    """The causal-timeline renderer.  Demo mode runs a 3-member
    in-process ensemble (WAL on, watch armed), performs one traced
    write, and prints the merged client+member timeline — the span
    chain README "Causal tracing" documents.  ``--live`` scrapes the
    ``trce`` admin word from every --server member (an OS-process
    ensemble included) and merges whatever rings they hold."""
    import json as _json

    from .utils.trace import (
        TRACE_SCHEMA,
        format_timeline,
        merge_timelines,
    )

    if args.live:
        rings: dict = {}
        dropped: dict = {}
        failed = 0
        for spec in args.server:
            host, port = spec['address'], spec['port']
            try:
                raw = await _admin_one(host, port, 'trce',
                                       args.timeout)
                dump = _json.loads(raw.decode('utf-8'))
            except (OSError, ValueError, asyncio.TimeoutError,
                    TimeoutError):
                print('error: could not scrape trce from %s:%d'
                      % (host, port), file=sys.stderr)
                failed += 1
                continue
            key = 'member:%s' % (dump.get('member', port),)
            if key in rings:
                # two members reporting the same id (e.g. two
                # standalone servers, both default '0'): qualify by
                # address rather than silently overwriting one ring
                key = 'member:%s@%s:%d' % (dump.get('member', port),
                                           host, port)
            rings[key] = dump.get('spans', [])
            # the ring is bounded: a wrapped ring silently lost spans
            # before this scrape — surface the count next to the ring
            # (the zk_trace_ring_dropped mntr row, per member)
            dropped[key] = dump.get('dropped', 0)
        if failed and not rings:
            return 1
        merged = merge_timelines(rings)
        if args.as_json:
            print(_json.dumps({'trace_schema': TRACE_SCHEMA,
                               'rings': rings, 'dropped': dropped,
                               'timeline': merged},
                              indent=2))
        else:
            for key in sorted(rings):
                print('# %s: %d span(s), %d dropped (ring '
                      'overwrites)' % (key, len(rings[key]),
                                       dropped.get(key, 0)))
            print(format_timeline(merged) or '(no zxid-keyed spans)')
        return 1 if failed else 0

    # -- demo: in-process ensemble, one write, full span chain --------
    import shutil
    import tempfile

    from .server.server import ZKEnsemble

    loop = asyncio.get_running_loop()
    wal_dir = tempfile.mkdtemp(prefix='zktimeline-wal-')
    ens = await ZKEnsemble(max(2, args.members),
                           wal_dir=wal_dir).start()
    client = Client(servers=[{'address': h, 'port': p}
                             for h, p in ens.addresses()],
                    shuffle_backends=False)
    client.start()
    try:
        await client.wait_connected(timeout=10)
        await client.create('/demo', b'v0')
        fires: list = []
        fired = loop.create_future()

        def on_change(*a):
            fires.append(a)
            if len(fires) >= 2 and not fired.done():
                fired.set_result(None)   # arm-time emit + the real one
        client.watcher('/demo').on('dataChanged', on_change)
        await asyncio.sleep(0.2)         # watch armed, arm-emit in
        await client.set('/demo', b'v1')
        await asyncio.wait_for(fired, 10)
        await client.sync('/demo')       # drain fan-out + fsync legs
        await asyncio.sleep(0.05)
        rings = {'client': client.trace.dump()}
        for s in ens.servers:
            if s.trace is not None:
                rings['member:%s' % (s.member,)] = s.trace.dump()
        merged = merge_timelines(rings)
        if args.as_json:
            print(_json.dumps({'trace_schema': TRACE_SCHEMA,
                               'rings': rings, 'timeline': merged},
                              indent=2))
        else:
            print('causal timeline for one create + one watched set '
                  '(%d members, WAL on):' % (len(ens.servers),))
            print(format_timeline(merged))
        return 0
    finally:
        await client.close()
        await ens.stop()
        shutil.rmtree(wal_dir, ignore_errors=True)


def _wal(args) -> int:
    """Dump/verify a WAL directory through the same scan recovery
    uses (server/persist.py scan_dir), so the CLI and the recovery
    path can never disagree on what is valid.  Exit 0 when the
    directory is recoverable (a torn *final* record is the normal
    crash signature and is tolerated, like recovery tolerates it);
    exit 1 on structural corruption — a mid-log CRC/decode failure or
    an invalid snapshot with nothing to fall back to."""
    from .server.persist import entry_zxid, recover_state, scan_dir

    scan = scan_dir(args.dir)
    if not scan.segments and not scan.snapshots:
        print('no WAL state in %s' % (args.dir,), file=sys.stderr)
        return 1
    print('wal dir: %s' % (args.dir,))
    print('segments:')
    corrupt = 0
    for i, seg in enumerate(scan.segments):
        last = i == len(scan.segments) - 1
        if seg.status == 'ok':
            note = 'ok'
        else:
            note = '%s@%d (%s)' % (seg.status, seg.valid_bytes,
                                   seg.error)
            # a torn tail on the FINAL segment is what dying
            # mid-write leaves; anything else is real corruption
            if not (last and seg.status in ('torn', 'crc')):
                corrupt += 1
        print('  %-28s start=%-6d records=%-5d bytes=%-8d %s'
              % (os.path.basename(seg.path), seg.start_index,
                 len(seg.records), seg.size, note))
        if args.records:
            for idx, entry in seg.records:
                extra = ('' if entry[0] != 'create'
                         else ' data=%dB' % (len(entry[2]),))
                # control records carry no path: epoch bumps hold the
                # fencing token (server/election.py), session records
                # the durable session edge (server/persist.py), and a
                # multi renders its whole all-or-nothing batch
                if entry[0] == 'epoch':
                    what = 'epoch=%d' % (entry[1],)
                elif entry[0] == 'session':
                    what = ('sid=%016x timeout=%dms'
                            % (entry[1], entry[3]))
                elif entry[0] == 'session_close':
                    what = 'sid=%016x (%s)' % (entry[1], entry[3])
                elif entry[0] == 'multi':
                    what = '%d sub-op(s): %s' % (
                        len(entry[1]),
                        ', '.join('%s %s' % (s[0], s[1])
                                  for s in entry[1]))
                elif entry[0] == 'reconfig':
                    # the membership CONTROL record: a surviving
                    # 'joint' with old_voters IS the crash-mid-window
                    # signature recovery resumes from
                    what = 'version=%d phase=%s voters=%s' % (
                        entry[1], entry[2],
                        ','.join(str(m) for m in entry[4]) or '-')
                    if entry[3]:
                        what += ' old_voters=%s' % (
                            ','.join(str(m) for m in entry[3]),)
                    if entry[5]:
                        what += ' observers=%s' % (
                            ','.join(str(m) for m in entry[5]),)
                else:
                    what = entry[1]
                print('    #%-6d zxid=%-6d %-8s %s%s'
                      % (idx, entry_zxid(entry), entry[0], what,
                         extra))
    print('snapshots:')
    if not scan.snapshots:
        print('  (none)')
    for snap in scan.snapshots:
        if snap.valid:
            print('  %-28s index=%-6d zxid=%-6d nodes=%-5d ok'
                  % (os.path.basename(snap.path), snap.index,
                     snap.zxid, len(snap.nodes)))
        else:
            print('  %-28s INVALID (%s)'
                  % (os.path.basename(snap.path), snap.error))
    newest = scan.newest_valid_snapshot()
    if any(not s.valid for s in scan.snapshots) and newest is None \
            and scan.snapshots:
        corrupt += 1
    if newest is not None:
        print('truncation point: index %d (zxid %d) — segments '
              'wholly below the oldest kept snapshot are reclaimable'
              % (newest.index, newest.zxid))
    rec = recover_state(args.dir)
    print('recovery: %s -> zxid %d (next index %d)'
          % (rec.detail, rec.zxid, rec.last_index))
    if corrupt:
        print('status: STRUCTURAL CORRUPTION (%d finding(s)); '
              'recovery stops at the last valid prefix' % (corrupt,),
              file=sys.stderr)
        return 1
    print('status: clean%s'
          % (' (torn final record tolerated)' if rec.torn else ''))
    return 0


def _blackbox(args) -> int:
    """Verify/render the flight-recorder rings of a WAL directory
    through the same scan recovery uses (utils/blackbox.py
    ``read_box``), so the CLI and the harvest path can never disagree
    on what is valid.  Exit 0 when every ring is recoverable (a torn
    FINAL frame is the normal crash signature and is tolerated); exit
    1 on structural corruption (a CRC failure, a torn rotated half)
    or when the directory holds no rings at all."""
    import json as _json

    from .utils.blackbox import BLACKBOX_SCHEMA, list_boxes, read_box

    members = list_boxes(args.dir)
    if not members:
        print('no black-box rings in %s' % (args.dir,),
              file=sys.stderr)
        return 1
    corrupt = 0
    out = []
    for member in members:
        box = read_box(args.dir, member)
        if box['status'] not in ('ok', 'torn'):
            corrupt += 1
        out.append(box)
    if args.as_json:
        print(_json.dumps({
            'blackbox_schema': BLACKBOX_SCHEMA,
            'dir': args.dir,
            'members': [{
                'member': b['member'], 'status': b['status'],
                'files': [{'path': os.path.basename(f.path),
                           'status': f.status, 'error': f.error,
                           'frames': len(f.frames),
                           'valid_bytes': f.valid_bytes,
                           'size': f.size} for f in b['files']],
                'frames': b['frames'],
            } for b in out]}, indent=2))
        return 1 if corrupt else 0
    print('blackbox dir: %s' % (args.dir,))
    for box in out:
        print('member %s: %d frame(s), status %s'
              % (box['member'], len(box['frames']), box['status']))
        for f in box['files']:
            note = 'ok' if f.status == 'ok' else (
                '%s@%d (%s)' % (f.status, f.valid_bytes, f.error))
            print('  %-28s frames=%-5d bytes=%-8d %s'
                  % (os.path.basename(f.path), len(f.frames),
                     f.size, note))
        for fr in box['frames']:
            mntr = fr.get('mntr') or {}
            slow = fr.get('slow')
            extra = ''
            if fr.get('phases'):
                extra += ' phases=%d' % (len(fr['phases']),)
            if fr.get('trace_tail') is not None:
                extra += ' spans=%d' % (len(fr['trace_tail']),)
            if slow is not None:
                extra += ' slow=%s %.1fms chain=%d' % (
                    slow.get('op'), slow.get('duration_ms') or 0.0,
                    len(fr.get('chain') or ()))
            print('    #%-5d %-8s role=%-9s zxid=%-8s slow_ops=%-4s'
                  '%s'
                  % (fr.get('seq', -1), fr.get('kind'),
                     mntr.get('zk_member_role', '-'),
                     mntr.get('zk_zxid', '-'),
                     mntr.get('zk_slow_ops_total', '-'), extra))
    if corrupt:
        print('status: STRUCTURAL CORRUPTION (%d ring(s)); harvest '
              'stops at each last valid prefix' % (corrupt,),
              file=sys.stderr)
        return 1
    torn = any(b['status'] == 'torn' for b in out)
    print('status: clean%s'
          % (' (torn final frame tolerated)' if torn else ''))
    return 0


def _parse_mntr_text(text: str) -> dict:
    """mntr reply lines ('key\\tvalue') to a dict, values coerced to
    int/float where they parse."""
    rows: dict = {}
    for line in text.splitlines():
        if '\t' not in line:
            continue
        key, _, val = line.partition('\t')
        for conv in (int, float):
            try:
                rows[key] = conv(val)
                break
            except ValueError:
                continue
        else:
            rows[key] = val
    return rows


async def _top(args) -> int:
    """The continuous fleet collector: one mntr scrape per member per
    interval, per-member delta rendering, optional JSONL append
    (top_schema-stamped, one line per member per poll) — the
    trajectory view the point-in-time words cannot give.  Exit 0 once
    stopped (--count or ctrl-c) if any member ever answered."""
    import json as _json
    import time as _time

    from .utils.blackbox import TOP_SCHEMA

    #: counters whose per-interval delta is the interesting number
    deltas = ('zk_packets_received', 'zk_packets_sent',
              'zk_slow_ops_total', 'zk_quorum_degraded',
              'zk_blackbox_frames', 'zk_trace_ring_dropped')
    prev: dict = {}
    ever = 0
    polls = 0
    out_f = open(args.out, 'a') if args.out else None
    try:
        while True:
            stamp = _time.strftime('%H:%M:%S')
            for spec in args.server:
                host, port = spec['address'], spec['port']
                who = '%s:%d' % (host, port)
                try:
                    raw = await _admin_one(host, port, 'mntr',
                                           args.timeout)
                    rows = _parse_mntr_text(
                        raw.decode('utf-8', 'replace'))
                except (OSError, asyncio.TimeoutError,
                        TimeoutError):
                    print('%s %-21s unreachable' % (stamp, who))
                    continue
                ever += 1
                last = prev.get(who) or {}
                moved = []
                for key in deltas:
                    cur = rows.get(key)
                    if not isinstance(cur, (int, float)):
                        continue
                    base = last.get(key)
                    d = (cur - base
                         if isinstance(base, (int, float)) else cur)
                    moved.append('%s+%g'
                                 % (key.replace('zk_', ''), d))
                prev[who] = rows
                print('%s %-21s %-9s epoch=%-3s cfg=%-3s '
                      'zxid=%-10s conns=%-5s %s'
                      % (stamp, who,
                         rows.get('zk_member_role', '?'),
                         rows.get('zk_epoch', '?'),
                         rows.get('zk_config_version', '-'),
                         rows.get('zk_zxid', '?'),
                         rows.get('zk_num_alive_connections', '?'),
                         ' '.join(moved)))
                if out_f is not None:
                    out_f.write(_json.dumps({
                        'top_schema': TOP_SCHEMA,
                        't_wall': round(_time.time(), 3),
                        'member': who,
                        'mntr': rows}) + '\n')
            if out_f is not None:
                out_f.flush()
            polls += 1
            if args.count and polls >= args.count:
                break
            await asyncio.sleep(args.interval)
    except (KeyboardInterrupt, asyncio.CancelledError):
        pass
    finally:
        if out_f is not None:
            out_f.close()
    return 0 if ever else 1


def _analyze(args) -> int:
    """The contract-lint tier as a subcommand: JSON findings with
    file:line positions (schema-stamped, like every other machine
    emission), exit 1 on findings — the gate `make analyze` wires
    into `make check`, consumable by CI without parsing text."""
    from .analysis import analyze_paths

    paths = args.paths or [os.path.dirname(os.path.abspath(
        __file__))]
    report = analyze_paths(paths, readme_path=args.readme)
    if args.text:
        for f in report.findings:
            print(f.format())
        print('%d file(s) analyzed, %d finding(s)'
              % (report.nfiles, len(report.findings)))
    else:
        print(report.to_json(indent=2))
    return 1 if report.findings else 0


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == 'analyze':
        # offline AST analysis: no server, no event loop
        return _analyze(args)
    if args.cmd == 'chaos':
        # chaos runs its own in-process servers; no --server dial.
        return asyncio.run(_chaos(args))
    if args.cmd == 'wal':
        # offline directory inspection: no server, no event loop
        return _wal(args)
    if args.cmd == 'blackbox':
        # offline flight-recorder inspection: no server, no loop
        return _blackbox(args)
    if args.cmd == 'top':
        # raw mntr polling loop: no client, no session
        return asyncio.run(_top(args))
    if args.cmd == 'mntr':
        # raw four-letter-word scrape: no client, no session
        return asyncio.run(_admin(args))
    if args.cmd == 'reconfig':
        # raw rcfg admin line: no client, no session
        return asyncio.run(_reconfig(args))
    if args.cmd == 'timeline':
        # self-contained demo (or raw trce scrape with --live):
        # never dials --server as a protocol client
        return asyncio.run(_timeline(args))
    return asyncio.run(_run(args))


if __name__ == '__main__':  # pragma: no cover - exercised via __main__
    sys.exit(main())
