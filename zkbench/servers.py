"""The server side of a cell: the port's server in a process of its own.

A standalone cell runs ``zkbench/serve.py`` (one ``ZKServer`` with its
write-ahead log).  The process is the harness's child with
``PR_SET_PDEATHSIG``, so it does not outlive the run, and its standard
error goes to a file in the run's directory.
"""

from __future__ import annotations

import asyncio
import ctypes
import os
import select
import signal
import subprocess
import sys
import time

from .spec import ROOT

#: How long a server may take to print READY.
READY_S = 60.0


def _die_with_parent() -> None:
    libc = ctypes.CDLL(None, use_errno=True)
    libc.prctl(1, signal.SIGKILL)          # PR_SET_PDEATHSIG


class ServerProc:
    """One server process and its client port."""

    def __init__(self, args: list, wal_dir: str, err_path: str):
        self.wal_dir = wal_dir
        self.client_port = 0
        self.err_path = err_path
        self._err = open(err_path, 'wb')
        self.proc = subprocess.Popen(
            args, cwd=str(ROOT), stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=self._err,
            preexec_fn=_die_with_parent)

    def alive(self) -> bool:
        return self.proc.poll() is None

    def wait_ready(self, deadline: float) -> str:
        """The READY line, or '' when the process printed none before
        ``deadline`` (a monotonic time) or exited."""
        fd = self.proc.stdout.fileno()
        buf = b''
        while b'\n' not in buf:
            left = deadline - time.monotonic()
            if left <= 0 or not select.select([fd], [], [], left)[0]:
                return ''
            chunk = os.read(fd, 4096)
            if not chunk:
                return ''
            buf += chunk
        line = buf.split(b'\n', 1)[0].decode()
        return line if line.startswith('READY ') else ''

    def stderr_tail(self, limit: int = 4000) -> str:
        self._err.flush()
        with open(self.err_path, 'rb') as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - limit))
            return f.read().decode('utf-8', 'replace')

    def cpu_s(self) -> float:
        """User plus system seconds the process has run."""
        with open('/proc/%d/stat' % (self.proc.pid,)) as f:
            fields = f.read().rsplit(')', 1)[1].split()
        return (int(fields[11]) + int(fields[12])) \
            / os.sysconf('SC_CLK_TCK')

    def stop(self) -> None:
        """End the process and wait for it."""
        if self.alive():
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        for f in (self.proc.stdin, self.proc.stdout):
            if f is not None:
                f.close()
        self._err.close()


class Servers:
    """The server processes of one run, their files under ``root``.
    Making one starts them and returns at once, so the client side can
    set up meanwhile; :meth:`ready` waits for every READY line."""

    def __init__(self, root: str):
        self.root = root
        wal = os.path.join(root, 'wal0')
        self.procs = [ServerProc(
            [sys.executable, '-m', '%s.serve' % (__package__,), wal],
            wal, os.path.join(root, 'server0.err'))]

    def ready(self) -> 'Servers':
        """Wait for every READY line and take each client port."""
        deadline = time.monotonic() + READY_S
        for p in self.procs:
            line = p.wait_ready(deadline)
            if not line:
                self.stop()
                raise RuntimeError('a server printed no READY line:\n'
                                   + p.stderr_tail())
            p.client_port = int(line.split()[1])
        return self

    def addrs(self) -> list:
        return [('127.0.0.1', p.client_port) for p in self.procs]

    def cpu_s(self) -> list:
        return [p.cpu_s() for p in self.procs]

    def stop(self) -> None:
        for p in self.procs:
            p.stop()


async def admin_word(port: int, word: bytes, timeout: float = 10.0) -> str:
    """One four-letter admin word's reply from a server."""
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection('127.0.0.1', port), timeout)
    try:
        writer.write(word)
        await writer.drain()
        data = await asyncio.wait_for(reader.read(), timeout)
    finally:
        writer.close()
    return data.decode('utf-8', 'replace')

