"""One standalone port ``ZKServer`` in its own OS process.

    python -m zkbench.serve WAL_DIR

Serves on a free loopback port with the write-ahead log in ``WAL_DIR``
and group fsync once a busy tick (``durability='tick'``: every ack
follows the fsync that covers it), prints ``READY <port>`` and serves
until its standard input closes or it gets SIGTERM.  It is the
ZooKeeper Administrator's Guide's "Standalone Operation" with
``forceSync=yes``, as ``zkbench/configs/standalone-1024.json`` states.
"""

from __future__ import annotations

import asyncio
import signal
import sys


async def _serve(wal_dir: str) -> None:
    from zkstream_tpu_torch.server import ZKServer

    srv = await ZKServer(wal_dir=wal_dir, durability='tick').start()
    loop = asyncio.get_running_loop()
    done = loop.create_future()

    def finish() -> None:
        if not done.done():
            done.set_result(None)
    loop.add_signal_handler(signal.SIGTERM, finish)
    # the parent holds our stdin: its end (the harness exiting, however
    # it exits) ends this server too
    loop.add_reader(sys.stdin.fileno(), finish)
    print('READY %d' % (srv.port,), flush=True)
    try:
        await done
    finally:
        loop.remove_reader(sys.stdin.fileno())
        await srv.stop()


def main() -> int:
    asyncio.run(_serve(sys.argv[1]))
    return 0


if __name__ == '__main__':
    sys.exit(main())
