"""One read-load generator process for ``python -m
zkstream_tpu_torch.bench --read``: the port's copy of the JAX
package's ``tools/read_worker.py``, on the port's ``PacketCodec``.

Drives N raw-socket ZooKeeper sessions (real handshakes — each one a
session the serving member owns) spread round-robin across the given
member addresses, then pipelines GET_DATA requests on every
connection for a fixed window.  Raw sockets, not N ``Client``
objects: the point is to saturate the SERVERS, so the generator
carries no pool/session/watcher machinery — just the wire codec
(the C extension when built).

Protocol with the orchestrating bench:

- stdout ``READY <sessions>`` once every session is handshaken
  (sessions may be clamped by RLIMIT_NOFILE; the count is authoritative);
- stdin ``GO`` starts the timed window;
- stdout one JSON line ``{"reads": N, "sessions": M, "errors": E}``
  when the window closes.  Only replies received INSIDE the window
  count.

Usage::

    python zkstream_tpu_torch/tools/read_worker.py \
        HOST:PORT[,HOST:PORT...] SESSIONS DURATION_S [PIPELINE]
"""

from __future__ import annotations

import asyncio
import json
import os
import resource
import sys


def _setup_path() -> None:
    # the repository root: this file is zkstream_tpu_torch/tools/
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if root not in sys.path:
        sys.path.insert(0, root)


def _raise_nofile(need: int) -> int:
    """Lift the soft fd limit toward the hard one; return how many
    sessions actually fit (sockets + slack for the runtime)."""
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    want = need + 64
    if soft < want:
        try:
            resource.setrlimit(resource.RLIMIT_NOFILE,
                               (min(want, hard), hard))
        except (ValueError, OSError):
            pass
        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    return max(1, min(need, soft - 64))


async def main() -> int:
    _setup_path()
    from zkstream_tpu_torch.protocol.framing import PacketCodec

    addrs = [(h, int(p)) for h, p in
             (spec.rsplit(':', 1)
              for spec in sys.argv[1].split(','))]
    sessions = int(sys.argv[2])
    duration = float(sys.argv[3])
    pipeline = int(sys.argv[4]) if len(sys.argv) > 4 else 16
    sessions = _raise_nofile(sessions)

    loop = asyncio.get_running_loop()
    counted = [0, 0]                  # reads inside window, errors
    window_open = [False]
    stop_at = [0.0]

    class Conn:
        __slots__ = ('reader', 'writer', 'codec', 'xid')

        def __init__(self, reader, writer):
            self.reader = reader
            self.writer = writer
            self.codec = PacketCodec(server=False)
            self.xid = 0

        def send_get(self):
            self.xid += 1
            self.writer.write(self.codec.encode(
                {'opcode': 'GET_DATA', 'xid': self.xid,
                 'path': '/bench', 'watch': False}))

    async def dial(i: int) -> Conn | None:
        host, port = addrs[i % len(addrs)]
        try:
            reader, writer = await asyncio.open_connection(host, port)
        except OSError:
            counted[1] += 1
            return None
        sock = writer.get_extra_info('socket')
        if sock is not None:
            import socket as _socket
            try:
                sock.setsockopt(_socket.IPPROTO_TCP,
                                _socket.TCP_NODELAY, 1)
            except OSError:
                pass
        conn = Conn(reader, writer)
        conn.writer.write(conn.codec.encode(
            {'protocolVersion': 0, 'lastZxidSeen': 0,
             'timeOut': 30000, 'sessionId': 0,
             'passwd': b'\x00' * 16}))
        try:
            while True:
                data = await asyncio.wait_for(reader.read(65536), 30)
                if not data:
                    counted[1] += 1
                    return None
                if conn.codec.decode(data):
                    break
        except Exception:
            counted[1] += 1
            return None
        conn.codec.handshaking = False
        return conn

    # staggered dials: a 10k-session stampede would just trip the
    # members' accept backlogs
    conns: list = []
    sem = asyncio.Semaphore(128)

    async def one(i: int):
        async with sem:
            c = await dial(i)
            if c is not None:
                conns.append(c)
    await asyncio.gather(*(one(i) for i in range(sessions)))

    print('READY %d' % (len(conns),), flush=True)
    line = await loop.run_in_executor(None, sys.stdin.readline)
    assert line.strip() == 'GO', line

    window_open[0] = True
    stop_at[0] = loop.time() + duration

    async def pump(conn: Conn):
        try:
            for _ in range(pipeline):
                conn.send_get()
            await conn.writer.drain()
            while loop.time() < stop_at[0]:
                data = await asyncio.wait_for(
                    conn.reader.read(65536),
                    max(0.05, stop_at[0] - loop.time()))
                if not data:
                    counted[1] += 1
                    return
                n = sum(1 for p in conn.codec.decode(data)
                        if p.get('opcode') == 'GET_DATA')
                counted[0] += n
                for _ in range(n):
                    conn.send_get()
        except (OSError, asyncio.TimeoutError, TimeoutError):
            pass
        except Exception:
            counted[1] += 1

    await asyncio.gather(*(pump(c) for c in conns))
    for c in conns:
        try:
            c.writer.close()
        except Exception:
            pass
    print(json.dumps({'reads': counted[0], 'sessions': len(conns),
                      'errors': counted[1]}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(asyncio.run(main()))
