"""Fleet ingest: the runtime consumer of the receive tick decode.

The reference drains every connection with its own scalar loop — bytes
-> frames -> header dispatch, once per socket
(lib/zk-streams.js:39-99, lib/connection-fsm.js:213-229).  This module
replaces that per-socket drain at fleet scale: N live connections
append their received bytes to per-connection accumulators, and a
per-event-loop-tick batcher packs them into one ``uint8 [Bp, L]``
tensor, decodes it in one launch sequence, reads back the packed
result, and routes it on the host — reply packets to each connection
through its ``ingestDeliver`` event, with observable semantics
identical to the scalar drain.

Two body modes:

- ``'host'``: the tick is
  :func:`~zkstream_tpu_torch.ops.pipeline.wire_pipeline_step_auto`
  (kernel K1 on a CUDA device) and reads back one packed int32 array.
  Where the connection's codec has the C-extension codec
  (``codec.ext``), each stream's frame-complete slice goes to it in one
  zero-copy call (:meth:`FleetIngest._assemble_ext`); otherwise bodies
  come from the scalar readers at the device-located offsets.
- ``'device'``: the tick is
  :func:`~zkstream_tpu_torch.ops.pipeline.wire_full_decode` (kernel K2
  on a CUDA device, K1 not launched), then the torch body parse
  (``parse_reply_bodies`` with K2's GET_DATA planes, and
  ``parse_list_bodies``); it reads back one packed int32 array and one
  packed uint8 array, and packets assemble from those planes.  A frame
  whose body does not fit the static widths (or is malformed) takes
  the scalar reader, counted in ``body_fallbacks``.

This is the port of ``zkstream_tpu.io.ingest.FleetIngest``: the host
logic (registry, the direct/batch regimes, the frame-guard EMA, fault
hooks, routing and packet assembly) is the reference's.  What differs:

- ``device=`` (default ``'cuda'``) names where ticks run; with no card
  the constructor raises.  There is no placement probe that moves
  ticks to the host CPU.
- A shape bucket's warm-up (:meth:`FleetIngest._compile`, the
  counterpart of the reference's per-bucket XLA compile) builds the
  kernel library (first use), allocates the bucket's pinned staging
  tensor, device input tensors and pinned readback tensors, and on a
  card captures the whole tick program (:meth:`FleetIngest._step_fn`)
  on those inputs into a CUDA graph (``ops/tick_graph.py``): a device
  tick is then two pinned copies in, one graph replay and the
  readbacks, not a chain of ~40 (host bodies) or ~3,500 (device bodies)
  launches.  A warm failure is the reference's failed compile where
  no kernel of the port failed: on the CPU any warm failure, on a card
  a failed capture of the torch program around the kernel.  It is
  logged at error level once and latches the bucket onto the scalar
  drain (its ticks count in ``ticks_scalar``; the warm is never
  retried).  A failed capture also retires the side stream and graph
  pool it used, so the next bucket captures on fresh ones.  On a card
  a kernel that fails to build or to launch (in the warm-up run before
  capture) is never served by the scalar codec: the error is kept and
  raised by ``prewarm`` and by every tick that needs the bucket.  No
  tick on a card runs the eager chain in place of the graph, and a
  failure when a graph replays raises, as the reference's executable
  call does.

torch is imported where a tick or a bucket needs it, never at module
import: the client and server stacks import this module, and a process
that never builds a ``FleetIngest`` (an ensemble member, the CLI
without ``--codec ingest``) loads no torch.

A connection needs three things: ``codec`` (a port ``PacketCodec``),
``is_in_state('connected')`` and ``emit('ingestDeliver', pkts, err)``.
"""

from __future__ import annotations

import asyncio
import queue
import threading
import time
import types

import numpy as np

from ..protocol.consts import (
    MAX_PACKET,
    REPLY_HDR,
    SPECIAL_XIDS,
    KeeperState,
    NotificationType,
    Perm,
    err_name,
)
from ..protocol.errors import ZKProtocolError
from ..protocol.jute import JuteReader
from ..protocol.records import _EMPTY_RESPONSES, _RESP_READERS, ACL, Id
from ..utils.logging import Logger
from ..utils.metrics import Histogram


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


#: sentinel distinguishing "never warmed" in the bucket cache
_MISSING = object()


def _guard_warm_exit(thread: threading.Thread, q: queue.Queue) -> None:
    """Interpreter-exit guard for one warm worker: a bounded join at
    threading shutdown lets an in-flight warm finish while a wedged one
    cannot hang exit (the worker stays a daemon)."""
    def _drain_and_join() -> None:
        q.put(None)
        thread.join(timeout=30.0)
    reg = getattr(threading, '_register_atexit', None)
    if reg is not None:
        try:
            reg(_drain_and_join)
            return
        except RuntimeError:    # already shutting down: nothing to do
            return
    import atexit
    atexit.register(_drain_and_join)


class _Bucket:
    """The tensors of one ``(Bp, L)`` shape bucket, reused every tick:
    a host staging batch (pinned for a CUDA device), the device inputs
    and host readbacks of the packed result: ``n_ints`` int32 columns
    and, in device-body mode, ``[F, n_bytes]`` uint8 planes per row.
    ``graph``: the tick program captured on the device inputs (a
    :class:`~zkstream_tpu_torch.ops.tick_graph.TickGraph`, set by
    :meth:`FleetIngest._compile` on a card), else None."""

    graph = None

    def __init__(self, Bp: int, L: int, F: int, device: torch.device,
                 n_ints: int, n_bytes: int = 0):
        import torch

        cuda = device.type == 'cuda'
        self.stage_buf = torch.empty((Bp, L), dtype=torch.uint8,
                                     pin_memory=cuda)
        self.stage_lens = torch.zeros((Bp,), dtype=torch.int32,
                                      pin_memory=cuda)
        # numpy views of the staging tensors: the tick fills these
        self.buf_np = self.stage_buf.numpy()
        self.lens_np = self.stage_lens.numpy()
        if cuda:
            self.dev_buf = torch.empty((Bp, L), dtype=torch.uint8,
                                       device=device)
            self.dev_lens = torch.zeros((Bp,), dtype=torch.int32,
                                        device=device)
            self.readback = torch.empty((Bp, n_ints), dtype=torch.int32,
                                        pin_memory=True)
            self.readback_bytes = (
                torch.empty((Bp, F, n_bytes), dtype=torch.uint8,
                            pin_memory=True) if n_bytes else None)
        else:
            self.dev_buf, self.dev_lens = self.stage_buf, self.stage_lens
            self.readback = self.readback_bytes = None

    def inputs(self) -> tuple:
        """The tick program's arguments: the device batch and lengths."""
        return self.dev_buf, self.dev_lens


class FleetIngest:
    """Batches the byte streams of many live connections through the
    tick decode, one device launch sequence per event-loop tick.

    Args:
      max_frames: per-stream frame bound per tick; streams with more
        complete frames buffered are finished on follow-up ticks.
      body_mode: ``'host'`` (device framing/headers, scalar body
        readers) or ``'device'`` (tensor body parse with scalar
        fallback).
      max_data / max_path: static widths of the device GET_DATA payload
        and CREATE/NOTIFICATION path planes (``body_mode='device'``
        only; ``max_data`` a multiple of 4, as kernel K2 reads words);
        larger fields fall back to the scalar reader.
      max_children / max_name / max_acls / max_scheme / max_id: bounds
        of the device children and ACL list parse; longer lists fall
        back to the scalar reader per frame.
      min_len: smallest padded stream length, to bound bucket churn.
      device: where ticks run (``'cuda'`` default, or ``'cpu'`` for the
        plain version).
      bypass_bytes: small-tick crossover — below this many bytes per
        tick the ingest runs as a pass-through scalar drain; 0 puts
        every tick on the device.
      warm: ``'background'`` (default) — a tick whose shape bucket is
        not warm yet delivers through the scalar codec while the bucket
        warms on a daemon thread; ``'block'`` — warm inline.
      frag_guard: route fragmented mega-fleet ticks back to the scalar
        drain.  ``None`` = auto: enabled when ``bypass_bytes > 0``.
      log: parent logger.
    """

    #: Dispatch calibration, from ``tools/sweep_crossover.py`` on one
    #: NVIDIA H100 80GB HBM3 at a 700.00 W power limit, each tick one
    #: graph replay (PERF.md section 5, "Crossover on the H100, graphed
    #: ticks"; each size paired against the C drain over 10 rounds,
    #: sign test): the default ``bypass_bytes``, and the fragmentation
    #: guard's fleet floor and its enter/exit fill of frames a tick over
    #: the fleet size.  With both guards off the batched path lost to
    #: the C drain at 64 connections (gets, 8,529 bytes a tick, p =
    #: 0.0215) and at no larger size (128: 15,540 bytes, p = 0.34;
    #: writes lost at no size, p >= 0.34), so the threshold stays 16
    #: KiB.  In a fleet of 1,024 sessions it lost at no fill from 0.06
    #: to 0.95 (64-1,024 active, p >= 0.34), so the guard's fills stay;
    #: no fleet under 600 sessions showed a sparse tick, so its floor
    #: stays.
    BYPASS_BYTES = 16384
    FRAG_MIN_FLEET = 600
    FRAG_ENTER = 0.25
    FRAG_EXIT = 0.40

    # int32 plane order in the packed tick output; the head columns
    # (n_frames, resid, bad) come first, then these [B, F] planes.
    _HDR_PLANES = ('starts', 'sizes', 'xids', 'errs',
                   'zxid_hi', 'zxid_lo')

    def __init__(self, max_frames: int = 32, body_mode: str = 'host',
                 max_data: int = 256, max_path: int = 256,
                 max_children: int = 16, max_name: int = 64,
                 max_acls: int = 4, max_scheme: int = 16,
                 max_id: int = 64,
                 min_len: int = 256, device='cuda',
                 bypass_bytes: int = BYPASS_BYTES,
                 warm: str = 'background',
                 frag_guard: bool | None = None,
                 log: Logger | None = None):
        from ..ops.pipeline import resolve_device

        if body_mode not in ('host', 'device'):
            raise ValueError('body_mode must be host or device, got %r'
                             % (body_mode,))
        if body_mode == 'device' and max_data % 4:
            raise ValueError('max_data must be a multiple of 4 (kernel '
                             'K2 reads whole words), got %d' % (max_data,))
        if warm not in ('background', 'block'):
            raise ValueError('warm must be background or block, got %r'
                             % (warm,))
        self.device = resolve_device(device)
        self.max_frames = max_frames
        self.body_mode = body_mode
        self.max_data = max_data
        self.max_path = max_path
        self.max_children = max_children
        self.max_name = max_name
        self.max_acls = max_acls
        self.max_scheme = max_scheme
        self.max_id = max_id
        self.min_len = min_len
        self.warm = warm
        self.bypass_bytes = bypass_bytes
        self.log = (log or Logger()).child(component='FleetIngest')
        #: id(conn) -> (conn, accumulator)
        self._slots: dict[int, tuple] = {}
        self._scheduled = False
        #: diagnostics: ``ticks`` counts device ticks; small ticks under
        #: ``bypass_bytes`` and ticks deferred to the scalar drain while
        #: a shape bucket warms count separately
        self.ticks = 0
        self.ticks_scalar = 0
        self.ticks_warming = 0
        self.tick_hist = Histogram(
            'zkstream_ingest_tick_ms',
            'Ingest tick (batched drain) duration, milliseconds')
        self.ticks_frag = 0
        self.frames_routed = 0
        #: seconds of device ticks by phase (``zkstream_ingest_phase_s``):
        #: the streams copied into the staging rows (``_fill_staging``);
        #: the device half (the rest of ``_run_step``: copies in, the
        #: replay, the readback and its synchronize); ``_unpack``; and
        #: the routing (``_route_stream``, assembly included).  The
        #: first, third and fourth are the tick's host half.  Of the
        #: routing, ``assemble_s`` went to building the packets
        #: (``_assemble_stream``, the C codec's pass included).
        self.staging_s = 0.0
        self.device_s = 0.0
        self.unpack_s = 0.0
        self.route_s = 0.0
        self.assemble_s = 0.0
        self.frag_guard = (bypass_bytes > 0 if frag_guard is None
                           else frag_guard)
        self._ema_frames: float | None = None
        self._frag_scalar = False
        #: Regime flag: in DIRECT mode ``feed`` delivers through the
        #: connection's own codec immediately; in BATCH mode bytes
        #: accumulate per slot and the tick dispatches the device step.
        self._direct = bypass_bytes > 0
        self._window_bytes = 0
        self._ema_bytes: float | None = None
        self._frames_mark = 0
        #: device-body mode: frames whose body needed the scalar
        #: reader (oversized/list-overflow/malformed)
        self.body_fallbacks = 0
        #: (Bp, L) -> _Bucket; None where its warm-up failed and the
        #: bucket drains scalar; or, on a card, the error of a kernel
        #: that failed to build or launch (raised by its ticks)
        self._exec: dict = {}
        #: the side stream every bucket's graph is captured on and the
        #: memory pool the graphs share (made at the first capture)
        self._graph_stream = self._graph_pool = None
        self._warm_events: dict = {}
        self._warm_queue: queue.Queue | None = None
        #: Optional seeded fault injector: tick-time faults in the
        #: BATCH regime (a slot's buffered suffix held back across a
        #: tick boundary, or a connection reset at tick time).
        self.faults = None
        #: id(conn) -> bytes withheld from the current tick
        self._held: dict[int, bytes] = {}
        #: slots whose withheld suffix was just released: exempt from
        #: a fresh hold for one tick
        self._no_hold: set[int] = set()

    # -- connection registry --

    def register(self, conn) -> None:
        slot = self._slots.setdefault(id(conn), (conn, bytearray()))
        # In the BATCH regime a partial frame buffered in the codec
        # migrates into the slot (the tick scan owns the stream); in the
        # DIRECT regime it stays in the codec, which keeps draining.
        if not self._direct and conn.codec is not None:
            resid = conn.codec.take_pending()
            if resid:
                slot[1].extend(resid)
                self._schedule()

    def unregister(self, conn) -> None:
        slot = self._slots.pop(id(conn), None)
        self._no_hold.discard(id(conn))
        held = self._held.pop(id(conn), None)
        if held is not None and slot is not None:
            slot[1].extend(held)     # withheld suffix rejoins in order
        # Return unprocessed bytes to the scalar decoder.
        if slot is not None and slot[1] and conn.codec is not None:
            conn.codec.restore_pending(bytes(slot[1]))

    def feed(self, conn, data: bytes) -> None:
        slot = self._slots.get(id(conn))
        if slot is None:  # raced a teardown; the bytes die with the conn
            return
        self._window_bytes += len(data)
        if self._direct:
            self._schedule()          # bookkeeping tick at cycle end
            if slot[1]:               # leftover from a regime flip
                slot[1].extend(data)
                data = bytes(slot[1])
                slot[1].clear()
            self._deliver_direct(conn, data)
            return
        if not slot[1]:
            # the read time of the oldest byte the slot holds: the
            # routed replies' ``t_rx`` (io/connection.py)
            conn._rx_t = time.perf_counter()
        slot[1].extend(data)
        self._schedule()

    @property
    def direct(self) -> bool:
        """True while the ingest is in its pass-through regime."""
        return self._direct

    def note_direct(self, nbytes: int, nframes: int) -> None:
        """Bookkeeping for a connection-side direct delivery."""
        self._window_bytes += nbytes
        self.frames_routed += nframes
        self._schedule()

    def _deliver_direct(self, conn, data: bytes) -> None:
        """The pass-through drain: decode straight through the
        connection's codec and emit."""
        err = None
        try:
            pkts = conn.codec.decode(data)
        except ZKProtocolError as e:
            pkts = getattr(e, 'packets', [])
            err = e
        self.frames_routed += len(pkts)
        if pkts or err is not None:
            conn.emit('ingestDeliver', pkts, err)

    def _schedule(self) -> None:
        if not self._scheduled:
            self._scheduled = True
            asyncio.get_running_loop().call_soon(self._tick)

    # -- shape-bucket warm-up (off the event loop by default) --

    def _bucket(self, n_streams: int, nbytes: int) -> tuple:
        Bp = _next_pow2(max(n_streams, 8))
        L = _next_pow2(max(self.min_len, nbytes))
        return (Bp, L)

    def _warm_bucket(self, key: tuple) -> _Bucket:
        """Build the tick's kernel (first use, on a CUDA device) and
        allocate one bucket's tensors."""
        Bp, L = key
        if self._on_card():
            self._load_kernel()
        return _Bucket(Bp, L, self.max_frames, self.device,
                       *self._packed_widths())

    def _on_card(self) -> bool:
        """Does a tick run the port's kernel (K1 or K2) on a card?"""
        return self.device.type == 'cuda'

    def _graphed(self) -> bool:
        """Does a tick run as a captured CUDA graph?  On a card, yes."""
        return self._on_card()

    def _compile(self, key: tuple):
        """Warm one shape bucket: allocate it (:meth:`_warm_bucket`) and,
        on a card, capture its tick program into a CUDA graph — the port
        of the reference's ``_compile`` (``fn.lower(batch,
        lens).compile()``).  Runs on the warm thread (or inline under
        ``warm='block'``)."""
        import torch

        from ..ops.tick_graph import TickGraph

        bk = self._warm_bucket(key)
        if self._graphed():
            if self._graph_pool is None:
                self._graph_stream = torch.cuda.Stream(self.device)
                self._graph_pool = torch.cuda.graph_pool_handle()
            step = self._step_fn(self.body_mode == 'device')
            try:
                bk.graph = TickGraph(lambda: step(*bk.inputs()),
                                     self.device, self._graph_stream,
                                     self._graph_pool)
            except BaseException:
                # a failed capture leaves its pool unusable (the next
                # capture into it fails the caching allocator's use-count
                # assertion): later buckets capture on a fresh stream
                # and pool
                self._graph_stream = self._graph_pool = None
                raise
        return bk

    def _load_kernel(self) -> None:
        """Build and bind the tick's kernel (K2 in device-body mode, K1
        otherwise)."""
        from ..ops import full_scan, wire_scan
        (full_scan if self.body_mode == 'device' else wire_scan).load()

    def _packed_widths(self) -> tuple:
        """``(int32 columns, uint8 bytes per frame)`` of a packed tick
        row in this body mode."""
        device_bodies = self.body_mode == 'device'
        n_planes = len(self._HDR_PLANES) + (
            self._n_body_planes() if device_bodies else 0)
        n_bytes = (sum(w for _n, w in self._bytes_schema())
                   if device_bodies else 0)
        return 3 + n_planes * self.max_frames, n_bytes

    def _try_warm(self, key: tuple):
        """Warm ``key`` (one policy for the inline and background warm
        paths, the reference's ``_try_compile``).  A failure logs at
        error level.  Where no kernel of the port failed (any failure on
        the CPU, a failed capture on a card) it returns None, which
        latches the bucket onto the scalar drain.  On a card, a kernel
        that fails to build or to launch returns its error, which the
        bucket's ticks raise: the scalar codec never serves a card's
        ticks in place of its kernel."""
        from ..ops.tick_graph import CaptureError

        try:
            return self._compile(key)
        except Exception as e:
            if self._on_card() and not isinstance(e, CaptureError):
                self.log.error('tick bucket %r failed to warm: %s', key, e)
                return e
            self.log.error('tick bucket %r failed to warm; it drains '
                           'through the scalar codec: %s', key, e)
            return None

    def _start_warm(self, key: tuple) -> asyncio.Event:
        """Queue (or join) the background warm for ``key``; returns the
        event set when the bucket is ready (or failed).  Warms drain
        FIFO through one daemon worker thread."""
        ev = self._warm_events.get(key)
        if ev is not None:
            return ev
        ev = asyncio.Event()
        self._warm_events[key] = ev
        loop = asyncio.get_running_loop()
        if self._warm_queue is None:
            q = self._warm_queue = queue.Queue()

            # the drain closure references only the QUEUE, never self;
            # None is the close() shutdown sentinel
            def drain():
                while True:
                    task = q.get()
                    try:
                        if task is None:
                            return
                        task()
                    finally:
                        q.task_done()

            t = threading.Thread(target=drain, daemon=True,
                                 name='ingest-warm')
            t.start()
            _guard_warm_exit(t, q)

        def work():
            ex = self._try_warm(key)

            def done():
                self._exec[key] = ex
                ev.set()
                # bytes may be waiting that deferred to scalar
                self._schedule()
            try:
                loop.call_soon_threadsafe(done)
            except RuntimeError:     # loop closed mid-warm
                pass

        self._warm_queue.put(work)
        return ev

    def close(self) -> None:
        """Release the background warm worker (idempotent)."""
        if self._warm_queue is not None:
            self._warm_queue.put(None)
            self._warm_queue = None

    def bind_metrics(self, collector, prefix: str = '') -> None:
        """Expose this ingest's tick/frame counters as pull-model
        gauges on ``collector`` (``utils.metrics.Collector``), and its
        tick-duration histogram.  When several ingests share one
        collector, give each a distinct ``prefix`` (name collisions
        raise rather than silently dropping a registrant's series)."""
        for name, attr, help_text in (
                ('zkstream_ingest_ticks', 'ticks',
                 'device ticks dispatched'),
                ('zkstream_ingest_scalar_ticks', 'ticks_scalar',
                 'ticks drained through the scalar codec (bypass or '
                 'failed bucket)'),
                ('zkstream_ingest_warming_ticks', 'ticks_warming',
                 'ticks deferred to scalar while a shape bucket '
                 'warmed'),
                ('zkstream_ingest_frag_ticks', 'ticks_frag',
                 'ticks routed to the scalar drain by the '
                 'fragmentation guard (fleet large, ticks sparse)'),
                ('zkstream_ingest_frames_routed', 'frames_routed',
                 'frames delivered through the ingest'),
                ('zkstream_ingest_body_fallbacks', 'body_fallbacks',
                 'device-body frames that needed the scalar reader')):
            collector.gauge(prefix + name,
                            (lambda a=attr: getattr(self, a)),
                            help_text)
        collector.multi_gauge(
            prefix + 'zkstream_ingest_phase_s',
            lambda: {(('phase', 'staging'),): self.staging_s,
                     (('phase', 'device'),): self.device_s,
                     (('phase', 'unpack'),): self.unpack_s,
                     (('phase', 'route'),): self.route_s},
            'seconds of device ticks by phase (staging | device | '
            'unpack | route)')
        # swap the standalone tick-duration histogram for a collector-
        # registered one; samples observed before binding stay with the
        # discarded instance (bind at setup time)
        self.tick_hist = collector.histogram(
            prefix + 'zkstream_ingest_tick_ms',
            'Ingest tick (batched drain) duration, milliseconds')

    async def prewarm(self, n_streams: int,
                      nbytes: int | None = None) -> None:
        """Warm the bucket for ``n_streams`` connections holding up to
        ``nbytes`` buffered bytes each tick (default: ``min_len``).  On
        a card, a kernel that failed to build or launch raises here."""
        key = self._bucket(n_streams, nbytes or self.min_len)
        if key not in self._exec:
            if self.warm == 'block':
                self._exec[key] = self._try_warm(key)
            else:
                await self._start_warm(key).wait()
        err = self._exec[key]
        if isinstance(err, BaseException):
            raise RuntimeError('tick bucket %r failed to warm'
                               % (key,)) from err

    # -- the packed tick output --

    def _body_schema(self):
        """Declarative layout of the device-body planes inside the
        packed int32 tick output — one source of truth for the pack
        (:meth:`_pack_bodies`) and the host-side unpack.  Entry kinds:

        - ``('plane', name)``: one int32 [B, F] plane;
        - ``('multi', name, K)``: an int32 [B, F, K] tensor as K planes;
        - ``('stat', name)``: a StatPlanes (one plane per field).
        """
        K, A = self.max_children, self.max_acls
        return (
            ('stat', 'stat0'), ('stat', 'stat_after_data'),
            ('plane', 'data_len'), ('plane', 'str0_len'),
            ('plane', 'ntype'), ('plane', 'nstate'),
            ('plane', 'npath_len'), ('plane', 'data_ok'),
            ('plane', 'str0_ok'), ('plane', 'npath_ok'),
            ('plane', 'ch_count'), ('plane', 'ch_ok'),
            ('multi', 'ch_len', K),
            ('stat', 'stat_after_children'),
            ('plane', 'acl_count'), ('plane', 'acl_ok'),
            ('multi', 'acl_perms', A),
            ('multi', 'acl_scheme_len', A),
            ('multi', 'acl_id_len', A),
            ('stat', 'stat_after_acl'),
        )

    def _bytes_schema(self):
        """Widths of the uint8 [B, F, w] segments concatenated into the
        packed byte planes (4-d sources flatten their trailing axes)."""
        return (
            ('data', self.max_data),
            ('str0', self.max_path),
            ('npath', self.max_path),
            ('ch_bytes', self.max_children * self.max_name),
            ('acl_scheme', self.max_acls * self.max_scheme),
            ('acl_id', self.max_acls * self.max_id),
        )

    def _n_body_planes(self) -> int:
        from ..ops.replies import StatPlanes

        width = {'plane': lambda e: 1, 'multi': lambda e: e[2],
                 'stat': lambda e: len(StatPlanes._fields)}
        return sum(width[e[0]](e) for e in self._body_schema())

    def _step_fn(self, device_bodies: bool):
        """The tick program, the counterpart of the reference's
        ``_step_fn``: ``fn(*bucket.inputs())`` decodes a bucket's batch
        into packed arrays.  :meth:`_compile` captures it into a CUDA
        graph on a card; the CPU runs it eagerly.  (``device_bodies`` is
        this ingest's body mode; the mesh ingest's program differs.)"""
        return self._step

    def _step(self, buf, lens):
        """The tick computation on ``buf``/``lens`` (device tensors):
        decode and pack into ``(ints [Bp, 3 + K*F], bytes [Bp, F, W])``,
        ``bytes`` None in host-body mode."""
        return self._trace_step(buf, lens)[1:]

    def _trace_step(self, buf, lens):
        """The reference's ``_trace_step``: :meth:`_step` with the
        tick's ``WireStats`` first, ``(st, ints, bytes)`` (the mesh
        ingest reduces ``st`` fleet-wide)."""
        from ..ops.pipeline import wire_full_decode, wire_pipeline_step_auto
        from ..ops.replies import parse_list_bodies, parse_reply_bodies

        F = self.max_frames
        if self.body_mode == 'host':
            st = wire_pipeline_step_auto(buf, lens, max_frames=F)
            return st, self._pack_ints(st, ()), None
        st, gd = wire_full_decode(buf, lens, max_frames=F,
                                  max_data=self.max_data)
        bd = parse_reply_bodies(buf, st.starts, st.sizes,
                                max_data=self.max_data,
                                max_path=self.max_path, getdata=gd)
        lb = parse_list_bodies(
            buf, st.starts, st.sizes,
            max_children=self.max_children, max_name=self.max_name,
            max_acls=self.max_acls, max_scheme=self.max_scheme,
            max_id=self.max_id)
        return (st,) + self._pack_bodies(st, bd, lb)

    def _pack_bodies(self, st, bd, lb):
        """Pack a device-body tick's ``WireStats``, ``ReplyBodies`` and
        ``ListBodies`` into ``(ints, bytes)`` in the schema's layout."""
        import torch

        from ..ops.replies import StatPlanes

        F = self.max_frames

        def src(name):
            v = getattr(bd, name, None)
            return v if v is not None else getattr(lb, name)

        extra = []
        for ent in self._body_schema():
            if ent[0] == 'plane':
                extra.append(src(ent[1]).to(torch.int32))
            elif ent[0] == 'multi':
                t = src(ent[1]).to(torch.int32)
                extra += [t[:, :, k] for k in range(ent[2])]
            else:
                sp = src(ent[1])
                extra += [getattr(sp, f).to(torch.int32)
                          for f in StatPlanes._fields]
        B = st.starts.shape[0]
        byts = torch.cat([src(name).reshape(B, F, -1)
                          for name, _w in self._bytes_schema()], dim=2)
        return self._pack_ints(st, extra), byts

    def _pack_ints(self, st, extra):
        import torch

        head = torch.stack([st.n_frames, st.resid,
                            st.bad.to(torch.int32)], dim=1)      # [Bp, 3]
        planes = [getattr(st, f) for f in self._HDR_PLANES] + list(extra)
        flat = torch.stack(planes, dim=1)                        # [Bp, K, F]
        return torch.cat([head, flat.reshape(head.shape[0], -1)], dim=1)

    def _unpack(self, ints, byts):
        """Host-side stat and body views of the packed arrays (numpy
        views, no copies), walking the schema the pack wrote."""
        from ..ops.replies import StatPlanes

        B = ints.shape[0]
        F = self.max_frames
        head, flat = ints[:, :3], ints[:, 3:].reshape(B, -1, F)
        st = types.SimpleNamespace(n_frames=head[:, 0],
                                   resid=head[:, 1], bad=head[:, 2])
        k = 0
        for name in self._HDR_PLANES:
            setattr(st, name, flat[:, k])
            k += 1
        if byts is None:
            return st, None

        bd = types.SimpleNamespace()
        for ent in self._body_schema():
            if ent[0] == 'plane':
                setattr(bd, ent[1], flat[:, k])
                k += 1
            elif ent[0] == 'multi':
                K = ent[2]
                # K consecutive planes -> a [B, F, K] view
                setattr(bd, ent[1], np.moveaxis(flat[:, k:k + K], 1, 2))
                k += K
            else:
                vals = {}
                for f in StatPlanes._fields:
                    vals[f] = flat[:, k]
                    k += 1
                vals['valid'] = vals['valid'].astype(bool)
                setattr(bd, ent[1], StatPlanes(**vals))
        off = 0
        for name, w in self._bytes_schema():
            setattr(bd, name, byts[:, :, off:off + w])
            off += w
        return st, bd

    def _note_frames(self, n: int) -> None:
        """Feed the fragmentation EMA with one tick's routed frames."""
        self._ema_frames = (float(n) if self._ema_frames is None
                            else 0.2 * n + 0.8 * self._ema_frames)

    def _frag_guarded(self) -> bool:
        """True routes this tick to the scalar drain because the fleet
        is large but its ticks are fragmented; hysteresis keeps the
        router from flapping on tick noise."""
        if not self.frag_guard:
            return False
        n = len(self._slots)
        if n < self.FRAG_MIN_FLEET or self._ema_frames is None:
            self._frag_scalar = False
            return False
        if self._frag_scalar:
            if self._ema_frames >= self.FRAG_EXIT * n:
                self._frag_scalar = False
        elif self._ema_frames < self.FRAG_ENTER * n:
            self._frag_scalar = True
        return self._frag_scalar

    def _want_direct(self) -> bool:
        """Should the ingest run as a pass-through drain?"""
        if self._frag_guarded():
            return True
        if not self.bypass_bytes or self._ema_bytes is None:
            return False
        if self._direct:
            return self._ema_bytes < 1.25 * self.bypass_bytes
        return self._ema_bytes < self.bypass_bytes

    def _flip_direct(self, active) -> None:
        """Batch -> pass-through: drain what the slots hold, hand each
        codec its partial-frame residue, switch."""
        self._release_held()
        self._drain_scalar(active)
        for _cid, (conn, buf) in list(self._slots.items()):
            if buf and conn.codec is not None:
                conn.codec.restore_pending(bytes(buf))
                buf.clear()
        self._direct = True

    def _flip_batch(self) -> None:
        """Pass-through -> batch: reclaim each codec's partial-frame
        residue into its slot so the next tick's scan continues it."""
        self._direct = False
        for _cid, (conn, buf) in list(self._slots.items()):
            if conn.codec is not None:
                resid = conn.codec.take_pending()
                if resid:
                    buf[:0] = resid

    def _tick(self) -> None:
        t0 = time.perf_counter()
        if self._tick_impl():
            self.tick_hist.observe((time.perf_counter() - t0) * 1000.0)

    def _tick_impl(self) -> bool:
        """One drain tick; returns True when it routed work."""
        self._scheduled = False
        win = self._window_bytes
        self._window_bytes = 0
        if win:
            self._ema_bytes = (float(win) if self._ema_bytes is None
                               else 0.2 * win + 0.8 * self._ema_bytes)
        if self._direct:
            if not win:
                return False
            self._note_frames(self.frames_routed - self._frames_mark)
            self._frames_mark = self.frames_routed
            self.ticks_scalar += 1
            still_direct = self._want_direct()
            if self._frag_scalar:
                self.ticks_frag += 1
            if not still_direct:
                self._flip_batch()
            return True
        if self.faults is not None:
            self._inject_tick_faults()
        active = [(conn, buf) for conn, buf in self._slots.values()
                  if buf and conn.is_in_state('connected')]
        if not active:
            if self._release_held():
                self._schedule()     # finish the withheld suffixes
            return False
        before = self.frames_routed
        try:
            self._tick_inner(active)
        finally:
            self._note_frames(self.frames_routed - before)
            self._frames_mark = self.frames_routed
            if self._release_held():
                self._schedule()
        return True

    def _inject_tick_faults(self) -> None:
        """Apply the injector's tick-time decisions to the batch-regime
        slots."""
        fi = self.faults
        for cid, (conn, buf) in list(self._slots.items()):
            if not buf or not conn.is_in_state('connected'):
                continue
            if fi.ingest_reset(conn):
                conn.emit('sockError', ConnectionResetError(
                    'injected ingest tick reset'))
                continue
            if cid in self._no_hold:
                self._no_hold.discard(cid)
                continue
            cut = fi.ingest_cut(conn, len(buf))
            if cut:
                self._held[cid] = \
                    self._held.get(cid, b'') + bytes(buf[-cut:])
                del buf[-cut:]

    def _release_held(self) -> bool:
        """Re-append every withheld suffix to its slot (in order)."""
        if not self._held:
            return False
        released = False
        held, self._held = self._held, {}
        for cid, tail in held.items():
            slot = self._slots.get(cid)
            if slot is None:
                continue             # conn died; its bytes die with it
            slot[1].extend(tail)
            self._no_hold.add(cid)
            released = True
        return released

    def _tick_inner(self, active) -> None:
        if self._want_direct():
            self.ticks_scalar += 1
            if self._frag_scalar:
                self.ticks_frag += 1
            self._flip_direct(active)
            return

        B = len(active)
        maxlen = max(len(buf) for _c, buf in active)
        key = self._bucket(B, maxlen)
        bk = self._exec.get(key, _MISSING)
        if bk is _MISSING:
            if self.warm == 'block':
                bk = self._exec[key] = self._try_warm(key)
            else:
                # never block the loop on a warm-up: drain this tick
                # through the scalar codec while the bucket warms
                self._start_warm(key)
                self.ticks_warming += 1
                self._drain_scalar(active)
                return
        if bk is None:  # warm failed: this bucket stays scalar
            self.ticks_scalar += 1
            self._drain_scalar(active)
            return
        if isinstance(bk, BaseException):
            raise RuntimeError('tick bucket %r failed to warm'
                               % (key,)) from bk
        self.ticks += 1
        out = self._run_step(bk, active)
        t0 = time.perf_counter()
        st, bd = self._unpack(*out)
        t1 = time.perf_counter()

        retick = False
        for i, (conn, buf) in enumerate(active):
            if self._route_stream(conn, buf, st, bd, i):
                retick = True
        self.unpack_s += t1 - t0
        self.route_s += time.perf_counter() - t1
        if retick:
            self._schedule()

    def _drain_scalar(self, active) -> None:
        """Deliver a tick's streams through the scalar codec, skipping
        any a delivery tore down mid-tick."""
        for conn, buf in active:
            if id(conn) in self._slots:
                self._deliver_scalar(conn, buf)

    @staticmethod
    def _fill_staging(bk, active) -> None:
        """Copy the active streams into the bucket's staging rows and
        lengths (rows past them get length 0)."""
        # Staging rows are reused without zeroing the bytes past a
        # row's length.  The frame scan reads only inside complete
        # frames; the body parse reads speculatively past frame ends,
        # but every such read lands in an output its extent mask
        # zeroes, so stale bytes never reach the packed result
        # (tests/test_torch_ingest.py holds a short tick after a long
        # one in the same bucket to the zero-filled reference).
        lens = bk.lens_np
        for i, (_conn, buf) in enumerate(active):
            n = len(buf)
            bk.buf_np[i, :n] = np.frombuffer(buf, np.uint8)
            lens[i] = n
        lens[len(active):] = 0

    def _launch(self, bk):
        """Run the tick program on the bucket's inputs: one replay of
        its CUDA graph where ticks are graphed (which counts the kernel
        launches it holds), the eager chain elsewhere (the CPU).  A
        graphed bucket without a graph raises: nothing runs the eager
        chain on a card in place of a graph."""
        if bk.graph is not None:
            return bk.graph.replay()
        if self._graphed():
            raise RuntimeError('tick bucket has no captured tick program')
        return self._step_fn(self.body_mode == 'device')(*bk.inputs())

    def _run_step(self, bk: _Bucket, active):
        """Stage the active streams, run the tick (:meth:`_launch`) and
        read back the packed ``(ints, bytes-or-None)`` as numpy: two
        pinned copies in, one graph replay, two pinned readbacks and one
        synchronize on a CUDA device."""
        import torch

        B = len(active)
        t0 = time.perf_counter()
        self._fill_staging(bk, active)
        t1 = time.perf_counter()
        self.staging_s += t1 - t0
        cuda = self.device.type == 'cuda'
        if cuda:
            bk.dev_buf[:B].copy_(bk.stage_buf[:B], non_blocking=True)
            bk.dev_lens.copy_(bk.stage_lens, non_blocking=True)
        ints, byts = self._launch(bk)
        if not cuda:
            out = ints.numpy(), None if byts is None else byts.numpy()
        else:
            bk.readback.copy_(ints, non_blocking=True)
            if byts is not None:
                bk.readback_bytes.copy_(byts, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
            out = (bk.readback.numpy(),
                   None if byts is None else bk.readback_bytes.numpy())
        self.device_s += time.perf_counter() - t1
        return out

    def _route_stream(self, conn, buf, st, bd, i: int) -> bool:
        """Deliver stream ``i``'s decoded tick results to its
        connection.  Returns True when more complete frames may still
        be buffered (the per-stream frame bound was hit)."""
        # A user callback from an earlier stream's delivery may have
        # torn this connection down mid-tick: skip it.
        if id(conn) not in self._slots:
            return False
        n = int(st.n_frames[i])
        if bool(st.bad[i]):
            # Exact scalar-error parity: re-run this stream through the
            # connection's own codec, which raises BAD_LENGTH/BAD_DECODE
            # with the pre-error packets attached.
            self._deliver_fallback(conn, buf)
            return False
        t0 = time.perf_counter()
        pkts, err = self._assemble_stream(conn, buf, st, bd, i, n)
        self.assemble_s += time.perf_counter() - t0
        resid = int(st.resid[i])
        if resid:
            del buf[:resid]
        self.frames_routed += n
        if pkts or err is not None:
            conn.emit('ingestDeliver', pkts, err)
        return (err is None and n == self.max_frames
                and len(buf) >= 4)

    def _deliver_scalar(self, conn, buf: bytearray,
                        keep_stream: bool = True) -> None:
        """Drain one stream through the connection's own codec and emit
        the result (``keep_stream=False``: the bad-frame fallback)."""
        data, err, pkts = bytes(buf), None, []
        buf.clear()
        try:
            pkts = conn.codec.decode(data)
        except ZKProtocolError as e:
            pkts = getattr(e, 'packets', [])
            err = e
        else:
            if keep_stream:
                resid = conn.codec.take_pending()
                if resid:
                    buf.extend(resid)
        if keep_stream:
            self.frames_routed += len(pkts)
            if not pkts and err is None:
                return
        conn.emit('ingestDeliver', pkts, err)

    def _deliver_fallback(self, conn, buf: bytearray) -> None:
        self._deliver_scalar(conn, buf, keep_stream=False)

    # -- host packet assembly --

    def _assemble_stream(self, conn, buf, st, bd, i: int, n: int):
        """Build the packet dicts for stream ``i``'s ``n`` frames.
        Returns (packets, err); a decode failure mid-stream keeps the
        packets decoded before it, like PacketCodec.decode."""
        if not n:
            return [], None
        if bd is None:
            ext = conn.codec.ext
            if ext is not None:
                return self._assemble_ext(conn, buf, st, ext, i)
        pkts: list[dict] = []
        xid_map = conn.codec.xid_map
        # bulk-convert this stream's header planes to Python ints once
        xids = st.xids[i, :n].tolist()
        zhis = st.zxid_hi[i, :n].tolist()
        zlos = st.zxid_lo[i, :n].tolist()
        errs = st.errs[i, :n].tolist()
        for f in range(n):
            xid = xids[f]
            opcode = SPECIAL_XIDS.get(xid)
            if opcode is None:
                opcode = xid_map.pop(xid, None)
            if opcode is None:
                return pkts, ZKProtocolError('BAD_DECODE',
                    'Failed to decode Response: ValueError: reply xid '
                    '%d matches no request' % (xid,))
            zxid = ((zhis[f] & 0xFFFFFFFF) << 32) | (zlos[f] & 0xFFFFFFFF)
            if zxid >= 1 << 63:
                zxid -= 1 << 64
            pkt = {
                'xid': xid,
                'zxid': zxid,
                'err': err_name(errs[f]),
                'opcode': opcode,
            }
            if pkt['err'] == 'OK' and opcode not in _EMPTY_RESPONSES:
                try:
                    self._read_body(pkt, buf, st, bd, i, f)
                except ZKProtocolError as e:
                    return pkts, e
                except Exception as e:
                    err = ZKProtocolError('BAD_DECODE',
                        'Failed to decode Response: %s: %s'
                        % (type(e).__name__, e))
                    err.__cause__ = e
                    return pkts, err
            pkts.append(pkt)
        return pkts, None

    def _assemble_ext(self, conn, buf, st, ext, i: int):
        """C fast path for ``body_mode='host'``: decode stream ``i``'s
        device-delimited complete-frame slice in one zero-copy pass of
        the C-extension codec — the same code the connection's scalar
        drain runs, so parity is by construction.  The device scan
        already proved the slice frame-complete and length-valid
        (``bad`` streams took :meth:`_deliver_fallback`), so the cap
        passed is the protocol's, not the codec's."""
        resid = int(st.resid[i])
        if not resid:
            return [], None
        mv = memoryview(buf)
        sl = mv[:resid]
        try:
            pkts, _consumed, kind, msg = ext.decode_responses(
                sl, conn.codec.xid_map, MAX_PACKET)
        except Exception as e:
            err = ZKProtocolError('BAD_DECODE',
                'Failed to decode Response: %s: %s'
                % (type(e).__name__, e))
            err.__cause__ = e
            return [], err
        finally:
            # Release the views NOW: an exception's traceback (kept
            # alive via err.__cause__) can pin the call frame and with
            # it the buffer export, and an exported bytearray cannot
            # be resized — the caller's `del buf[:resid]` would raise
            # BufferError and kill the whole tick.
            sl.release()
            mv.release()
        if kind is not None:
            return pkts, ZKProtocolError(kind, msg)
        return pkts, None

    def _read_body(self, pkt, buf, st, bd, i: int, f: int) -> None:
        """Fill ``pkt`` with its opcode-specific body: from the device
        body planes where they hold it, else the scalar reader
        positioned at the device-located body offset."""
        opcode = pkt['opcode']
        if bd is not None:
            if self._read_body_device(pkt, bd, i, f):
                return
            self.body_fallbacks += 1
        start = int(st.starts[i, f])
        size = int(st.sizes[i, f])
        r = JuteReader(bytes(buf[start + REPLY_HDR:start + size]))
        reader = _RESP_READERS.get(opcode)
        if reader is None:
            raise ValueError('unsupported reply opcode %r' % (opcode,))
        reader(r, pkt)

    def _read_body_device(self, pkt, bd, i: int, f: int) -> bool:
        """Assemble the body from the tensor planes; False = this frame
        needs the scalar fallback (list-shaped beyond the bounds,
        oversized, malformed)."""
        from ..ops.replies import stat_from_planes

        opcode = pkt['opcode']
        if opcode in ('EXISTS', 'SET_DATA'):
            if not bool(bd.stat0.valid[i, f]):
                return False  # truncated: scalar reader raises exactly
            pkt['stat'] = stat_from_planes(bd.stat0, i, f)
            return True
        if opcode == 'GET_DATA':
            dlen = int(bd.data_len[i, f])
            if dlen > self.max_data or not bool(bd.data_ok[i, f]) or \
                    not bool(bd.stat_after_data.valid[i, f]):
                return False
            pkt['data'] = bytes(bd.data[i, f, :max(dlen, 0)])
            pkt['stat'] = stat_from_planes(bd.stat_after_data, i, f)
            return True
        if opcode == 'CREATE':
            slen = int(bd.str0_len[i, f])
            # not-ok = the length field points past the frame: fall
            # back so the scalar reader raises BAD_DECODE, exactly as
            # the scalar drain would
            if slen > self.max_path or not bool(bd.str0_ok[i, f]):
                return False
            pkt['path'] = bytes(bd.str0[i, f, :max(slen, 0)]).decode()
            return True
        if opcode == 'NOTIFICATION':
            plen = int(bd.npath_len[i, f])
            if plen > self.max_path or not bool(bd.npath_ok[i, f]):
                return False
            pkt['type'] = NotificationType(int(bd.ntype[i, f])).name
            pkt['state'] = KeeperState(int(bd.nstate[i, f])).name
            pkt['path'] = bytes(bd.npath[i, f, :max(plen, 0)]).decode()
            return True
        if opcode in ('GET_CHILDREN', 'GET_CHILDREN2'):
            if not bool(bd.ch_ok[i, f]):
                return False  # oversized/malformed list: scalar reader
            if opcode == 'GET_CHILDREN2':
                if not bool(bd.stat_after_children.valid[i, f]):
                    return False  # truncated Stat: scalar raises
                pkt['stat'] = stat_from_planes(
                    bd.stat_after_children, i, f)
            cnt = int(bd.ch_count[i, f])
            # plane contract: ch_ok => lens already clamped to [0, S]
            lens = bd.ch_len[i, f, :cnt].tolist()
            row, S = bd.ch_bytes[i, f], self.max_name
            pkt['children'] = [
                bytes(row[k * S:k * S + lens[k]]).decode()
                for k in range(cnt)]
            return True
        if opcode == 'GET_ACL':
            if not bool(bd.acl_ok[i, f]) or \
                    not bool(bd.stat_after_acl.valid[i, f]):
                return False
            cnt = int(bd.acl_count[i, f])
            perms = bd.acl_perms[i, f, :cnt].tolist()
            slens = bd.acl_scheme_len[i, f, :cnt].tolist()
            ilens = bd.acl_id_len[i, f, :cnt].tolist()
            srow, SS = bd.acl_scheme[i, f], self.max_scheme
            irow, SI = bd.acl_id[i, f], self.max_id
            pkt['acl'] = [
                ACL(Perm(perms[k]), Id(
                    bytes(srow[k * SS:k * SS + slens[k]]).decode(),
                    bytes(irow[k * SI:k * SI + ilens[k]]).decode()))
                for k in range(cnt)]
            pkt['stat'] = stat_from_planes(bd.stat_after_acl, i, f)
            return True
        return False
