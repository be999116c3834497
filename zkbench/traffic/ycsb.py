"""The YCSB mixes: every session a closed loop with one op in flight,
over the seeded streams of ``ycsb_ops.py``.

The load phase (YCSB's ``-load``: one create a record under the
table, each with its preloaded value) runs in set-up.  Then each
session runs its stream through the port's public ``Client``:
``get(path)`` for a read, ``set(path, value, version=-1)`` for an
update (a whole-record write, as YCSB's ZooKeeper binding does), and
issues its next op as the last settles (YCSB's ``-threads`` with no
``-target``).

Each op is recorded when it settles: its session and index, the
record, its call and settle times (``time.perf_counter``), and what the
client returned (data and Stat, or the error).  The first
``warmup_s`` of traffic runs before the window opens.

A reworking of ``zkstream_tpu_torch/tools/sweep_crossover.py``'s get
and write cells for a timed window: there, a fixed count of ops a
client and an in-process server; here, a window, YCSB's records and
key choice, and server processes of their own.
"""

from __future__ import annotations

import asyncio
import math
import time
import types
from array import array

from ..instruments import quantile
from . import ycsb_ops as ops


class OpLog:
    """Every settled op, in flat arrays: no Python object an op that
    the collector would have to walk (a ``Stat`` is a tuple subclass,
    which the collector never untracks)."""

    #: ints an op: session, index, kind, record, ok, the Stat's 11
    NI = 16
    #: times an op: call, settle

    def __init__(self):
        self.ints = array('q')
        self.times = array('d')
        self.data: list = []
        self.errors: dict = {}

    def add(self, session, index, kind, record, t0, t1, stat, data,
            error) -> None:
        if error is None:
            self.ints.extend((session, index, kind, record, 1))
            self.ints.extend(stat)
        else:
            self.errors[len(self.data)] = error
            self.ints.extend((session, index, kind, record, 0))
            self.ints.extend(_NO_STAT)
        self.times.extend((t0, t1))
        self.data.append(data)

    def __len__(self) -> int:
        return len(self.data)

    def rows(self):
        """The log as columns for the reference: ``session``,
        ``index``, ``kind``, ``record``, ``t0``, ``t1``,
        ``stat`` (a :class:`~..reference.ycsb.Stat` or None), ``data``
        and ``error`` (None or the error's text), one entry an op."""
        from ..reference.ycsb import Stat

        n = len(self)
        ints = [self.ints[i * self.NI:(i + 1) * self.NI] for i in range(n)]
        cols = types.SimpleNamespace()
        cols.session = [r[0] for r in ints]
        cols.index = [r[1] for r in ints]
        cols.kind = [r[2] for r in ints]
        cols.record = [r[3] for r in ints]
        cols.stat = [Stat(*r[5:]) if r[4] else None for r in ints]
        cols.t0 = list(self.times[0::2])
        cols.t1 = list(self.times[1::2])
        cols.data = self.data
        cols.error = [self.errors.get(i) for i in range(n)]
        return cols


_NO_STAT = (0,) * 11


class Mix:
    """One run of a YCSB mix on a fleet of clients."""

    def __init__(self, cell, seed: int, sessions: int | None = None,
                 records: int | None = None):
        self.mix = cell.traffic
        self.config = dict(cell.config)
        if records is not None:
            self.config['recordcount'] = records
        self.seed = seed
        #: fleet size: every session the configuration holds
        self.n_clients = sessions or self.config['sessions']
        self.paths = ops.record_paths(self.config)
        self.log = OpLog()
        #: session -> (index, record, t0) of its op in flight
        self.inflight: dict = {}
        self.streams = [ops.Stream(seed, s, self.mix, self.config)
                        for s in range(self.n_clients)]
        self._stop_at = None
        self._tasks: list = []

    # -- set-up --

    async def preload(self, clients) -> None:
        """YCSB's load phase: the table, then one create a record,
        spread over the sessions."""
        table = self.config['table']
        await clients[0].create(table, b'')
        vals = ops.preload_values(self.seed, self.config)
        n = len(clients)

        async def load(c, first):
            for i in range(first, len(vals), n):
                await c.create(self.paths[i], vals[i])
        await asyncio.gather(*[load(c, i) for i, c in enumerate(clients)])

    def start(self, clients) -> None:
        """Every session's loop."""
        loop = asyncio.get_running_loop()
        self._tasks = [loop.create_task(self._session(s, c))
                       for s, c in enumerate(clients)]

    async def _session(self, s: int, client) -> None:
        stream, log, paths = self.streams[s], self.log, self.paths
        clock = time.perf_counter
        while True:
            if self._stop_at is not None and clock() >= self._stop_at:
                return
            j = stream.n
            kind, rec, value = stream.next()
            t0 = clock()
            self.inflight[s] = (j, rec, t0)
            try:
                if kind == ops.READ:
                    data, stat = await client.get(paths[rec])
                else:
                    stat = await client.set(paths[rec], value, -1)
                    data = None
            except Exception as e:      # recorded; the loop runs on
                log.add(s, j, kind, rec, t0, clock(), None, None, repr(e))
                del self.inflight[s]
                await asyncio.sleep(0.01)
            else:
                log.add(s, j, kind, rec, t0, clock(), stat, data, None)
                del self.inflight[s]

    def stop(self, at: float) -> None:
        """No session issues an op at ``at`` or later."""
        self._stop_at = at

    async def drain(self, grace_s: float) -> None:
        """Wait for the ops in flight, ``grace_s`` at most."""
        _done, pending = await asyncio.wait(self._tasks, timeout=grace_s)
        for t in pending:
            t.cancel()
        await asyncio.gather(*pending, return_exceptions=True)

    # -- the window's numbers --

    def window(self, w0: float, w1: float) -> dict:
        """End-to-end numbers of the window ``[w0, w1)``: ops settled
        without error in it a second, and the 99th percentile, over
        every op called in it, of the time from its call to when it
        settled (an op that failed or never settled counts as missing
        every limit: infinite)."""
        t, errors = self.log.times, self.log.errors
        done, lat, failed = 0, [], 0
        for i in range(len(self.log)):
            t0, t1 = t[2 * i], t[2 * i + 1]
            ok = i not in errors
            if ok and w0 <= t1 < w1:
                done += 1
            if w0 <= t0 < w1:
                if ok:
                    lat.append((t1 - t0) * 1e3)
                else:
                    lat.append(math.inf)
                    failed += 1
        unsettled = sum(1 for (_j, _r, t0) in self.inflight.values()
                        if w0 <= t0 < w1)
        lat += [math.inf] * unsettled
        return {'ops_per_s': done / (w1 - w0),
                'op_p99_ms': quantile(lat, 0.99),
                'p50_ms': quantile(lat, 0.5),
                'attempted': len(lat), 'failed': failed + unsettled,
                'samples': len(lat)}

    def error_kinds(self) -> dict:
        """How many ops failed, by the error's type and code."""
        out: dict = {}
        for e in self.log.errors.values():
            k = e.split(':')[0][:80]
            out[k] = out.get(k, 0) + 1
        return out

    # -- what the reference judges --

    async def readback(self, client) -> dict:
        """Every record as ``client``'s server serves it, after a sync:
        ``{record: (data, stat)}``."""
        await client.sync(self.config['table'])
        got = await asyncio.gather(*[client.get(p) for p in self.paths],
                                   return_exceptions=True)
        return {i: g for i, g in enumerate(got)
                if not isinstance(g, BaseException)}

    def recovered(self, nodes: dict) -> dict:
        """Every record in a server's state recovered from its log:
        ``{record: (data, version, mzxid)}``."""
        out = {}
        for i, p in enumerate(self.paths):
            z = nodes.get(p)
            if z is not None:
                out[i] = (z.data, z.version, z.mzxid)
        return out

    def check(self, readbacks: list, recovered: list) -> dict:
        from ..reference.ycsb import check

        return check(self.seed, self.mix, self.config, self.log.rows(),
                     dict(self.inflight), readbacks, recovered)
