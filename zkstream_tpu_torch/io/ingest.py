"""Fleet ingest: the runtime consumer of the receive tick decode.

The reference drains every connection with its own scalar loop — bytes
-> frames -> header dispatch, once per socket
(lib/zk-streams.js:39-99, lib/connection-fsm.js:213-229).  This module
replaces that per-socket drain at fleet scale: N live connections
append their received bytes to per-connection accumulators, and a
per-event-loop-tick batcher packs them into one ``uint8 [Bp, L]``
tensor, runs :func:`~zkstream_tpu_torch.ops.pipeline.wire_pipeline_step_auto`
(kernel K1 on a CUDA device) in one launch sequence, reads back one
packed int32 array, and routes the results on the host — reply packets
to each connection through its ``ingestDeliver`` event, with
observable semantics identical to the scalar drain.

This is the port of ``zkstream_tpu.io.ingest.FleetIngest``: the host
logic (registry, the direct/batch regimes, the frame-guard EMA, fault
hooks, routing and packet assembly) is the reference's.  What differs:

- ``device=`` (default ``'cuda'``) names where ticks run; with no card
  the constructor raises.  There is no placement probe that moves
  ticks to the host CPU.
- A shape bucket's warm-up builds the K1 library (first use) and
  allocates the bucket's pinned staging tensor, device input tensors
  and pinned readback tensor — the counterpart of the reference's
  per-bucket XLA compile.  A warm failure raises on the next tick; it
  never latches the bucket onto the scalar drain.
- ``body_mode='host'`` only: bodies come from the scalar readers at
  the device-located offsets.

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
import torch

from ..protocol.consts import REPLY_HDR, SPECIAL_XIDS, err_name
from ..protocol.errors import ZKProtocolError
from ..protocol.jute import JuteReader
from ..protocol.records import _EMPTY_RESPONSES, _RESP_READERS
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
    and a host readback of the packed result."""

    def __init__(self, Bp: int, L: int, F: int, device: torch.device):
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
            self.readback = torch.empty((Bp, 3 + 6 * F), dtype=torch.int32,
                                        pin_memory=True)
        else:
            self.dev_buf, self.dev_lens = self.stage_buf, self.stage_lens
            self.readback = None


class FleetIngest:
    """Batches the byte streams of many live connections through the
    tick decode, one device launch sequence per event-loop tick.

    Args:
      max_frames: per-stream frame bound per tick; streams with more
        complete frames buffered are finished on follow-up ticks.
      body_mode: ``'host'`` (device framing/headers, scalar body
        readers).  ``'device'`` is not ported yet.
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

    #: Fragmentation-guard calibration (measured for the reference on
    #: its host, CROSSOVER.md; not yet re-measured for this port).
    FRAG_MIN_FLEET = 600
    FRAG_ENTER = 0.25
    FRAG_EXIT = 0.40

    # int32 plane order in the packed tick output; the head columns
    # (n_frames, resid, bad) come first, then these [B, F] planes.
    _HDR_PLANES = ('starts', 'sizes', 'xids', 'errs',
                   'zxid_hi', 'zxid_lo')

    def __init__(self, max_frames: int = 32, body_mode: str = 'host',
                 min_len: int = 256, device='cuda',
                 bypass_bytes: int = 16384,
                 warm: str = 'background',
                 frag_guard: bool | None = None,
                 log: Logger | None = None):
        from ..ops.pipeline import resolve_device

        if body_mode == 'device':
            raise NotImplementedError(
                "body_mode='device' needs the device body parse and "
                'kernel K2, which a later slice of the port brings')
        if body_mode != 'host':
            raise ValueError('body_mode must be host, got %r'
                             % (body_mode,))
        if warm not in ('background', 'block'):
            raise ValueError('warm must be background or block, got %r'
                             % (warm,))
        self.device = resolve_device(device)
        self.max_frames = max_frames
        self.body_mode = body_mode
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
        #: (Bp, L) -> _Bucket, or the exception its warm-up raised
        self._exec: dict = {}
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
        """Build K1 (first use, on a CUDA device) and allocate one
        bucket's tensors."""
        Bp, L = key
        if self.device.type == 'cuda':
            from ..ops import wire_scan
            wire_scan.load()
        return _Bucket(Bp, L, self.max_frames, self.device)

    def _try_warm(self, key: tuple):
        """Warm ``key``; a failure is returned (and raised by the tick
        that needs the bucket), never latched onto the scalar drain."""
        try:
            return self._warm_bucket(key)
        except Exception as e:
            self.log.error('tick bucket %r failed to warm: %s', key, e)
            return e

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

    async def prewarm(self, n_streams: int,
                      nbytes: int | None = None) -> None:
        """Warm the bucket for ``n_streams`` connections holding up to
        ``nbytes`` buffered bytes each tick (default: ``min_len``)."""
        key = self._bucket(n_streams, nbytes or self.min_len)
        if self._exec.get(key, _MISSING) is not _MISSING:
            return
        if self.warm == 'block':
            self._exec[key] = self._try_warm(key)
            return
        await self._start_warm(key).wait()

    def _unpack(self, ints):
        """Host-side stat views of the packed int32 array (numpy views,
        no copies)."""
        B = ints.shape[0]
        F = self.max_frames
        head, flat = ints[:, :3], ints[:, 3:].reshape(B, -1, F)
        st = types.SimpleNamespace(n_frames=head[:, 0],
                                   resid=head[:, 1], bad=head[:, 2])
        for k, name in enumerate(self._HDR_PLANES):
            setattr(st, name, flat[:, k])
        return st

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
        for conn, buf in active:
            if id(conn) not in self._slots:
                continue
            self._deliver_scalar(conn, buf)
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
                for conn, buf in active:
                    if id(conn) not in self._slots:
                        continue
                    self._deliver_scalar(conn, buf)
                return
        if isinstance(bk, BaseException):
            raise RuntimeError('tick bucket %r failed to warm'
                               % (key,)) from bk
        self.ticks += 1
        st = self._unpack(self._run_step(bk, active))

        retick = False
        for i, (conn, buf) in enumerate(active):
            if self._route_stream(conn, buf, st, i):
                retick = True
        if retick:
            self._schedule()

    def _run_step(self, bk: _Bucket, active) -> np.ndarray:
        """Stage the active streams, run the tick decode and read back
        the packed int32 ``[Bp, 3 + 6F]`` result as numpy."""
        from ..ops.pipeline import wire_pipeline_step_auto

        B = len(active)
        # Bytes past a row's length are never read (every read is
        # inside a complete frame), so the staging rows are not zeroed.
        lens = bk.lens_np
        for i, (_conn, buf) in enumerate(active):
            n = len(buf)
            bk.buf_np[i, :n] = np.frombuffer(buf, np.uint8)
            lens[i] = n
        lens[B:] = 0
        cuda = self.device.type == 'cuda'
        if cuda:
            bk.dev_buf[:B].copy_(bk.stage_buf[:B], non_blocking=True)
            bk.dev_lens.copy_(bk.stage_lens, non_blocking=True)
        st = wire_pipeline_step_auto(bk.dev_buf, bk.dev_lens,
                                     max_frames=self.max_frames)
        head = torch.stack([st.n_frames, st.resid,
                            st.bad.to(torch.int32)], dim=1)      # [Bp, 3]
        planes = torch.stack([getattr(st, f) for f in self._HDR_PLANES],
                             dim=1)                              # [Bp, 6, F]
        packed = torch.cat([head, planes.reshape(head.shape[0], -1)],
                           dim=1)
        if not cuda:
            return packed.numpy()
        bk.readback.copy_(packed, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return bk.readback.numpy()

    def _route_stream(self, conn, buf, st, i: int) -> bool:
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
        pkts, err = self._assemble_stream(conn, buf, st, i, n)
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

    def _assemble_stream(self, conn, buf, st, i: int, n: int):
        """Build the packet dicts for stream ``i``'s ``n`` frames.
        Returns (packets, err); a decode failure mid-stream keeps the
        packets decoded before it, like PacketCodec.decode."""
        if not n:
            return [], None
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
                    self._read_body(pkt, buf, st, i, f)
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

    def _read_body(self, pkt, buf, st, i: int, f: int) -> None:
        """Fill ``pkt`` with its opcode-specific body: the scalar reader
        positioned at the device-located body offset."""
        opcode = pkt['opcode']
        start = int(st.starts[i, f])
        size = int(st.sizes[i, f])
        r = JuteReader(bytes(buf[start + REPLY_HDR:start + size]))
        reader = _RESP_READERS.get(opcode)
        if reader is None:
            raise ValueError('unsupported reply opcode %r' % (opcode,))
        reader(r, pkt)
