"""Mesh-aware fleet ingest: the runtime consumer of the sharded plane.

:class:`~zkstream_tpu_torch.io.ingest.FleetIngest` batches a live
connection fleet's receive streams into one decode per event-loop tick;
this subclass runs that tick **dp-sharded over a mesh** — the runtime
twin of :func:`~.sharded.sharded_wire_step` — and reduces fleet-global
session statistics on the way:

- the staged rows split over the dp shards, each shard runs the tick
  (kernel K1, or K2 and the torch body parse, on a CUDA shard), and the
  host reads back one packed array per plane kind, as the single-device
  ingest does;
- the fleet-wide reductions — total frames / replies / notifications /
  pings / errors and the **fleet max zxid** (the resume checkpoint a
  multi-host session manager persists, the distributed analogue of
  lib/zk-session.js:229-235) — sum and unsigned-64 max over the shards
  and the mesh's process group, and ride back appended to the packed
  ints: no extra readback.

Several shards may share one card (``make_mesh(devices=[cuda:0] * 4)``):
each still runs its own kernel launch on its rows.  On one card with no
process group the whole sharded step — every shard's decode, the fleet
globals and their appending — is captured per bucket into one CUDA graph
and replayed each tick, the counterpart of the reference's one
``jax.jit(shard_map(...))`` program.  A mesh over several cards and
:class:`MultihostFleetIngest` (an NCCL ``all_reduce`` inside the step)
run the step eagerly.  The port of ``zkstream_tpu.parallel.fleet``; the
tests drive it on 8 CPU shards with live in-process connections
(tests/test_torch_mesh_ingest.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.ingest import FleetIngest
from ..ops.bytesops import i64pair_to_int
from .mesh import make_mesh

#: appended global columns: frames, replies, notifications, pings,
#: errors, max_zxid_hi, max_zxid_lo
_N_GLOBALS = 7


class _MeshBucket:
    """The tensors of one ``(Bp, L)`` shape bucket of a mesh ingest: a
    host staging batch (pinned when the mesh has a card), each dp
    shard's input rows on its device (views of the staging rows on a
    CPU shard), and the host readbacks of the packed result; ``graph``
    as :class:`~zkstream_tpu_torch.io.ingest._Bucket`'s."""

    graph = None

    def __init__(self, Bp: int, L: int, F: int, mesh, n_ints: int,
                 n_bytes: int):
        pin = mesh.has_cuda()
        self.stage_buf = torch.empty((Bp, L), dtype=torch.uint8,
                                     pin_memory=pin)
        self.stage_lens = torch.zeros((Bp,), dtype=torch.int32,
                                      pin_memory=pin)
        self.buf_np = self.stage_buf.numpy()
        self.lens_np = self.stage_lens.numpy()
        self.rows = Bp // mesh.local_dp
        self.shards = []
        for s, d in enumerate(mesh.dp_devices):
            rows = slice(s * self.rows, (s + 1) * self.rows)
            if d.type == 'cpu':
                self.shards.append((self.stage_buf[rows],
                                    self.stage_lens[rows]))
            else:
                self.shards.append((
                    torch.empty((self.rows, L), dtype=torch.uint8, device=d),
                    torch.zeros((self.rows,), dtype=torch.int32, device=d)))
        self.readback = torch.empty((Bp, n_ints), dtype=torch.int32,
                                    pin_memory=pin)
        self.readback_bytes = (
            torch.empty((Bp, F, n_bytes), dtype=torch.uint8, pin_memory=pin)
            if n_bytes else None)

    def place(self, B: int) -> None:
        """Copy the first ``B`` staged rows and every length onto the
        shards."""
        for s, (db, dl) in enumerate(self.shards):
            if db.device.type == 'cpu':
                continue
            lo = s * self.rows
            k = min(max(B - lo, 0), self.rows)
            if k:
                db[:k].copy_(self.stage_buf[lo:lo + k], non_blocking=True)
            dl.copy_(self.stage_lens[lo:lo + self.rows], non_blocking=True)

    def inputs(self) -> tuple:
        """The sharded tick's arguments: the per-shard ``(bufs, lens)``."""
        return [b for b, _ in self.shards], [n for _, n in self.shards]


class MeshFleetIngest(FleetIngest):
    """FleetIngest whose tick is dp-sharded over ``mesh``.

    Args:
      mesh: a ``(dp, sp)`` mesh (default: every CUDA device of the
        process on the dp axis; raises without one).
      **kw: forwarded to :class:`FleetIngest`.  ``device`` defaults to
        the mesh's first device; ``bypass_bytes`` defaults to 0 and
        ``frag_guard`` to False here — a mesh proxy exists to run the
        device plane, not to bypass it.
    """

    def __init__(self, mesh=None, **kw):
        self.mesh = mesh if mesh is not None else make_mesh()
        kw.setdefault('device', self.mesh.first)
        if torch.device(kw['device']).type != self.mesh.first.type:
            raise ValueError('device %s does not match the mesh (%s)'
                             % (kw['device'], self.mesh.first))
        kw.setdefault('bypass_bytes', 0)
        kw.setdefault('frag_guard', False)
        super().__init__(**kw)
        #: fleet-global stats of the LAST device tick (None before the
        #: first); scalar/warming ticks do not update it.
        self.global_stats: dict | None = None
        #: running fleet-wide maximum zxid over all device ticks — the
        #: checkpoint a proxy-level session manager would persist.
        self.fleet_max_zxid = 0
        #: device_bodies -> the sharded tick step
        self._fns: dict = {}

    def bind_metrics(self, collector, prefix: str = '') -> None:
        super().bind_metrics(collector, prefix)
        collector.gauge(
            prefix + 'zkstream_fleet_max_zxid',
            lambda: self.fleet_max_zxid,
            'fleet-global max zxid (max over the mesh) — the '
            'proxy-level session resume checkpoint')

    def _bucket(self, n_streams: int, nbytes: int) -> tuple:
        Bp, L = super()._bucket(n_streams, nbytes)
        dp = self.mesh.local_dp
        # the batch axis must divide over the dp shards
        Bp = max(Bp, dp)
        Bp = ((Bp + dp - 1) // dp) * dp
        return Bp, L

    def _warm_bucket(self, key: tuple) -> _MeshBucket:
        Bp, L = key
        if self._on_card():
            self._load_kernel()
        n_ints, n_bytes = self._packed_widths()
        return _MeshBucket(Bp, L, self.max_frames, self.mesh,
                           n_ints + _N_GLOBALS, n_bytes)

    def _on_card(self) -> bool:
        return self.mesh.has_cuda()

    def _graphed(self) -> bool:
        """Ticks are graphed on one card with no process group: every
        shard on the same CUDA device."""
        return (self.mesh.group is None
                and len(set(self.mesh.dp_devices)) == 1
                and self.mesh.first.type == 'cuda')

    def _step_fn(self, device_bodies: bool):
        """The sharded tick: ``fn(bufs, lens)`` over per-shard inputs
        returns the per-shard packed ints, the seven fleet globals
        appended to every row (and, in device-body mode, the per-shard
        packed bytes)."""
        fn = self._fns.get(device_bodies)
        if fn is not None:
            return fn
        from .sharded import fleet_globals

        def fn(bufs, lens):
            outs = [self._trace_step(b, n) for b, n in zip(bufs, lens)]
            g = fleet_globals(self.mesh, [st for st, _i, _b in outs])
            # replicated globals ride appended to each local row: the
            # packed readback stays one array, no extra transfer
            ints = [torch.cat([i, g.to(i.device).expand(i.shape[0],
                                                        _N_GLOBALS)], dim=1)
                    for _st, i, _b in outs]
            return (ints, [b for _st, _i, b in outs]) if device_bodies \
                else ints

        self._fns[device_bodies] = fn
        return fn

    @staticmethod
    def _local_view(shards, out=None):
        """This process's rows of a dp-sharded result, in row order, as
        numpy (the inverse of the placement): copied into ``out`` (a
        host tensor, pinned for a card) and synchronised, or into a
        fresh array."""
        if out is None:
            return torch.cat([s.cpu() for s in shards]).numpy()
        k = 0
        for s in shards:
            out[k:k + s.shape[0]].copy_(s, non_blocking=True)
            k += s.shape[0]
        for d in {s.device for s in shards if s.device.type == 'cuda'}:
            torch.cuda.current_stream(d).synchronize()
        return out.numpy()

    def _run_step(self, bk: _MeshBucket, active):
        """Stage the active streams, run the sharded tick (one graph
        replay on one card) and read back the packed ``(ints,
        bytes-or-None)`` as numpy."""
        self._fill_staging(bk, active)
        bk.place(len(active))
        out = self._launch(bk)
        ints, byts = out if self.body_mode == 'device' else (out, None)
        return (self._local_view(ints, bk.readback),
                None if byts is None
                else self._local_view(byts, bk.readback_bytes))

    def _unpack(self, ints, byts):
        g = ints[0, -_N_GLOBALS:]
        self.global_stats = {
            'total_frames': int(g[0]),
            'total_replies': int(g[1]),
            'total_notifications': int(g[2]),
            'total_pings': int(g[3]),
            'total_errors': int(g[4]),
            'max_zxid': i64pair_to_int(g[5], g[6]),
        }
        self.fleet_max_zxid = max(self.fleet_max_zxid,
                                  self.global_stats['max_zxid'])
        return super()._unpack(ints[:, :-_N_GLOBALS], byts)


class MultihostFleetIngest(MeshFleetIngest):
    """Multi-process fleet proxy: every process serves its own live
    connections through ONE globally sharded tick.

    The single-process ingest ticks when bytes arrive; that cannot work
    across processes — a tick over a mesh with a process group is a
    collective, so every process must run it the same number of times.
    This class therefore runs on a **fixed cadence with fixed shapes**:

    - capacity is static: ``local_rows`` connection slots per process,
      each up to ``stream_len`` buffered bytes per tick (a longer
      backlog carries over — the decode consumes whole frames and
      leaves the remainder buffered);
    - a timer fires every ``tick_interval`` seconds and ALWAYS
      dispatches, even with every slot empty (empty rows decode zero
      frames) — no data-dependent control flow, so the collective
      counts stay aligned across processes with at most one interval
      of skew;
    - each process assembles only its own rows
      (:func:`~.multihost.host_local_wire_batch` — no stream byte
      leaves the process; the group carries just the sum/max scalars)
      and reads back only its own shards;
    - the fleet-global stats (total frames, fleet max zxid — the resume
      checkpoint of the WHOLE fleet's session population) reduce across
      all processes inside the tick.

    Lifecycle: ``start()`` begins the cadence; ``await
    stop(after_ticks=N)`` stops once N total ticks have run — stopping
    must be coordinated (same N everywhere), because a process that
    stops launching strands the others' collectives.
    """

    def __init__(self, mesh=None, local_rows: int = 8,
                 stream_len: int = 4096,
                 tick_interval: float = 0.005, **kw):
        kw.setdefault('min_len', stream_len)
        super().__init__(mesh=mesh, **kw)
        dp = self.mesh.shape['dp']
        procs = self.mesh.world_size
        global_rows = local_rows * procs
        if global_rows % dp:
            raise ValueError(
                'local_rows=%d x %d processes = %d global rows must '
                'divide over the dp axis (%d)' %
                (local_rows, procs, global_rows, dp))
        self.local_rows = local_rows
        self.stream_len = stream_len
        self.tick_interval = tick_interval
        self.tick_count = 0
        #: collective launches actually dispatched; == tick_count
        #: unless a dispatch itself failed (host-side assembly failures
        #: fall back to an empty aligned launch and so keep the two
        #: equal).  ``stop`` checks the invariant loudly.
        self.launch_count = 0
        self._rows: dict[int, int] = {}       # id(conn) -> row
        self._free = list(range(local_rows - 1, -1, -1))
        self._timer = None
        self._stop_at: int | None = None
        #: monotonic time of the last capacity warning; overflow warns
        #: at most once per interval so churn at saturation neither
        #: floods the log nor runs silent (one latch forever would)
        self._warned_capacity_at = float('-inf')

    # event-driven scheduling is disabled: the cadence launches ticks
    def _schedule(self) -> None:
        pass

    def register(self, conn) -> None:
        # Never raise here: register runs inside the connection FSM's
        # state-entry handler, and an exception there would strand a
        # half-wired connection.  Overflow connections get no row —
        # the cadence drains them through the scalar codec instead.
        if self._free:
            self._rows[id(conn)] = self._free.pop()
        else:
            import time
            now = time.monotonic()
            if now - self._warned_capacity_at >= 30.0:
                self._warned_capacity_at = now
                self.log.warning(
                    'MultihostFleetIngest capacity exceeded '
                    '(local_rows=%d); overflow connections are served '
                    'by the scalar drain — size the proxy for the '
                    'process\'s connection budget', self.local_rows)
        super().register(conn)

    def unregister(self, conn) -> None:
        row = self._rows.pop(id(conn), None)
        if row is not None:
            self._free.append(row)
        super().unregister(conn)

    def start(self) -> None:
        """Begin the tick cadence on the running loop."""
        import asyncio

        if self._timer is None:
            self._timer = asyncio.get_running_loop().create_task(
                self._cadence())

    def warmup_tick(self) -> None:
        """Run ONE aligned collective tick synchronously — call it the
        same number of times on every process before ``start()`` to
        build the kernels outside any session's clock."""
        self._mh_tick()

    async def prewarm(self, n_streams: int,
                      nbytes: int | None = None) -> None:
        raise NotImplementedError(
            'MultihostFleetIngest runs one fixed-shape GLOBAL tick; use '
            'warmup_tick() — the same number of times on every process '
            '— instead of the per-bucket prewarm')

    async def stop(self, after_ticks: int | None = None) -> None:
        """Stop the cadence.  With ``after_ticks`` (the coordinated
        form — pass the SAME value on every process) the cadence runs
        out to exactly that launch count and exits by itself, so every
        process ends with identical collective launch counts; without
        it the timer is cancelled immediately (single-process use)."""
        import asyncio

        if self._timer is None:
            return
        if after_ticks is not None:
            if self.tick_count > after_ticks:
                # the alignment contract is already broken — failing
                # loudly beats stranding the other processes' collectives
                raise RuntimeError(
                    'stop(after_ticks=%d) but %d ticks already ran; '
                    'launch counts would diverge across processes'
                    % (after_ticks, self.tick_count))
            self._stop_at = after_ticks
            await self._timer
        else:
            self._timer.cancel()
            try:
                await self._timer
            except asyncio.CancelledError:
                pass
        self._timer = None
        if self.launch_count != self.tick_count:
            # a dispatch failed somewhere along the run: this process
            # launched fewer collectives than its cadence counted, so
            # the other processes' matching collectives are stranded —
            # surface it here rather than letting them hang silently
            raise RuntimeError(
                'collective launch divergence: %d launches for %d '
                'ticks — a dispatch failed mid-cadence; the other '
                'processes\' launch counts no longer match this one'
                % (self.launch_count, self.tick_count))

    async def _cadence(self) -> None:
        import asyncio

        while self._stop_at is None or self.tick_count < self._stop_at:
            await asyncio.sleep(self.tick_interval)
            if self._stop_at is not None \
                    and self.tick_count >= self._stop_at:
                # stop() landed mid-sleep after the loop check: one
                # more tick here would exceed the coordinated launch
                # count and strand the other processes' collectives
                break
            try:
                self._mh_tick()
            except Exception:
                # keep launching: a dead cadence on one process strands
                # every other process's collectives, turning one local
                # error into a fleet-wide stall.  Pre-dispatch host-side
                # errors fall back to an empty aligned launch inside
                # _mh_tick; what reaches here is a failed dispatch (or
                # an empty launch that itself failed) or a routing/
                # delivery error after the dispatch — either way the
                # cadence continues and ``stop``'s launch/tick invariant
                # says whether alignment held.
                self.log.exception('multihost tick failed; '
                                   'cadence continues')

    def _assemble_tick(self):
        """Host-side tick assembly: copy each rowed connection's
        buffered bytes into the fixed-shape local batch.  Returns
        (batch, lens, active, overflow)."""
        batch = np.zeros((self.local_rows, self.stream_len), np.uint8)
        lens = np.zeros((self.local_rows,), np.int32)
        active = {}
        overflow = []
        for cid, (conn, buf) in list(self._slots.items()):
            if not buf or not conn.is_in_state('connected'):
                continue
            row = self._rows.get(cid)
            if row is None:          # over capacity: scalar-drained
                overflow.append((conn, buf))
                continue
            n = min(len(buf), self.stream_len)
            batch[row, :n] = np.frombuffer(memoryview(buf)[:n], np.uint8)
            lens[row] = n
            active[row] = (conn, buf)
        return batch, lens, active, overflow

    def _mh_tick(self) -> None:
        from .multihost import host_local_wire_batch

        self.tick_count += 1
        device = self.body_mode == 'device'
        try:
            batch, lens, active, overflow = self._assemble_tick()
            fn = self._step_fn(device)
            gbuf, glens = host_local_wire_batch(self.mesh, batch, lens)
        except Exception:
            # A pre-dispatch host-side failure (assembly, or the device
            # placement of the local shards) must not skip the
            # collective launch — the other processes' matching launches
            # would strand.  Retry the whole pre-dispatch path with an
            # EMPTY batch: nothing was consumed, so the buffered bytes
            # are intact and the next healthy tick delivers them one
            # interval late.  If even the empty placement fails, the
            # launch is genuinely impossible — the error propagates and
            # ``stop``'s launch/tick check reports the divergence.
            self.log.exception('multihost tick pre-dispatch failed; '
                               'launching an empty aligned tick')
            batch = np.zeros((self.local_rows, self.stream_len), np.uint8)
            lens = np.zeros((self.local_rows,), np.int32)
            active, overflow = {}, []
            fn = self._step_fn(device)
            gbuf, glens = host_local_wire_batch(self.mesh, batch, lens)
        # the launch itself is unconditional — collective alignment.
        # Global stats read back on every tick (they carry the OTHER
        # processes' traffic too); the body planes only when this
        # process has frames to route.
        if device:
            ints, byts = fn(gbuf, glens)
            self.launch_count += 1
            byts = self._local_view(byts) if active else None
        else:
            ints = fn(gbuf, glens)
            self.launch_count += 1
            byts = None
        ints = self._local_view(ints)
        st, bd = self._unpack(ints, byts)
        for conn, buf in overflow:
            if id(conn) in self._slots:
                self._deliver_scalar(conn, buf)
        if not active:
            return
        self.ticks += 1

        for row, (conn, buf) in active.items():
            # an earlier row's delivery callback may have torn this
            # connection down mid-tick (unregister already restored
            # its bytes to the codec)
            if id(conn) not in self._slots:
                continue
            if (int(st.n_frames[row]) == 0 and not bool(st.bad[row])
                    and int(st.resid[row]) == 0
                    and len(buf) >= self.stream_len):
                # a single frame larger than stream_len can never fit
                # a fixed-shape tick: drain this stream through the
                # scalar codec (which has no length bound) instead of
                # re-dispatching the same prefix forever
                self._deliver_scalar(conn, buf)
                continue
            self._route_stream(conn, buf, st, bd, row)
