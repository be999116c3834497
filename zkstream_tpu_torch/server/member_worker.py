"""One symmetric ensemble-member OS process (server/election.py).

A *member* has no pre-assigned role: it recovers whatever its WAL
directory holds, votes with the recovered (epoch, zxid) pair, and
ends up leading or following — re-electing on every leader loss —
until killed.  Spawned by the process-tier election harness
(``run_process_schedule``) and tests/test_torch_process_ensemble.py.

Usage::

    python member_worker.py ID WAL_DIR CLIENT_PORT ELECTION_PORT \
        [--observer] [PEER_ID:HOST:PORT[:observer] ...]

Prints ``READY <client_port> <election_port>`` once the member serves
clients under its first resolved role.  ``--observer`` makes this
member a non-voting read-serving replica (README "Read plane"); a
peer spec suffixed ``:observer`` marks that PEER as one, so the
voting total this member elects against excludes it.
``ZKSTREAM_MEMBER_SYNC`` picks the WAL fsync policy (default
``tick``).

Each member keeps a black-box flight recorder
(utils/blackbox.py) in its WAL_DIR: when the harness SIGKILLs this
process, the harvest pass lifts the durable frames — last mntr
counters, tick phases, span tail — back into the schedule's merged
timeline, and ``python -m zkstream_tpu_torch blackbox WAL_DIR`` renders
them by hand.  ``ZKSTREAM_NO_BLACKBOX=1`` disables the recorder,
``ZKSTREAM_BLACKBOX_MS`` its cadence.
"""

from __future__ import annotations

import asyncio
import os
import sys


def main() -> int:
    # the member runs the port's own server stack: pure asyncio, no
    # torch (the ingest defers it), so a spawn or respawn after a
    # SIGKILL pays for no accelerator import
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if root not in sys.path:
        sys.path.insert(0, root)
    from zkstream_tpu_torch.server.election import run_member

    # a read-plane member may serve up to a million sessions (`make
    # bench-million`): lift the soft fd limit as far as the host
    # allows, and name the binding constraint when it can't
    # (utils/fdlimit.py — ZKServer.start does the same against its
    # admission ceiling)
    from zkstream_tpu_torch.utils import fdlimit
    need = int(os.environ.get('ZKSTREAM_MEMBER_FDS', '0') or 0)
    fdlimit.raise_nofile(need + 256 if need else None)
    if need:
        err = fdlimit.headroom_error(need)
        if err:
            print('member %s fd headroom: %s'
                  % (sys.argv[1], err), file=sys.stderr)

    member_id = int(sys.argv[1])
    wal_dir = sys.argv[2]
    client_port = int(sys.argv[3])
    election_port = int(sys.argv[4])
    rest = sys.argv[5:]
    observer = '--observer' in rest
    peers = []
    voter_ids = [] if observer else [member_id]
    observer_ids = [member_id] if observer else []
    for spec in rest:
        if spec == '--observer':
            continue
        parts = spec.split(':')
        pid, host, port = parts[0], parts[1], parts[2]
        if len(parts) < 4 or parts[3] != 'observer':
            voter_ids.append(int(pid))
        else:
            observer_ids.append(int(pid))
        peers.append((int(pid), host, int(port)))
    voters = len(voter_ids)
    sync = os.environ.get('ZKSTREAM_MEMBER_SYNC', 'tick')
    asyncio.run(run_member(member_id, wal_dir, client_port,
                           election_port, peers, sync=sync,
                           observer=observer, voters=voters,
                           voter_ids=sorted(voter_ids),
                           observer_ids=sorted(observer_ids)))
    return 0


if __name__ == '__main__':
    sys.exit(main())
