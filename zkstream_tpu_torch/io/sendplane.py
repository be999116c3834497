"""Tick-corked outbound write coalescing — the send-side twin of the
batched ingest drain.

Without it, every client op and every server reply is its own
``transport.write`` — one syscall per frame, the per-message overhead
the RPC-batching literature (PAPERS.md: RPCAcc, the transparent
InfiniBand transports) amortizes at the transport boundary.  A
``SendPlane`` sits between a connection's encoder and its transport:
frames appended during one event-loop iteration are joined and written
as a single buffer when the loop's ready-callback batch drains (one
``call_soon``-scheduled flush per busy tick), with a size-capped early
flush so a large burst cannot balloon the cork.  ``TCP_NODELAY`` is
set on both ends (utils/aio.set_nodelay) so batching is this explicit
per-tick cork, not the kernel's implicit per-RTT one.

Ordering contract: every byte a connection sends goes through its
plane in call order — either corked (``send``) or after an explicit
``flush_hard`` for paths that must hit the wire mid-tick (fault
injection delivering a truncated frame before its scheduled reset,
CLOSE_SESSION ahead of ``write_eof``, a server connection closing).
Server planes may additionally carry a durability barrier: corked
acks wait (still corked, still ordered) for the WAL's off-loop group
fsync before they reach the transport — see ``barrier`` below and
server/persist.py.
The fault injector's tx hooks stay a per-frame boundary: injection
happens *before* the cork, and an injected delivery pre-flushes the
plane so the faulted frame cannot reorder ahead of earlier corked
frames.

Observability: per-flush batch size lands in the
``zookeeper_flush_batch_frames`` / ``zookeeper_flush_batch_bytes``
histograms (labelled ``plane="client"|"server"``; the watch table's
per-shard fan-out flushes record under ``plane="fanout"``,
server/watchtable.py), scraped by bench.py write-heavy cells,
``bench.py --fanout`` and tools/sweep_crossover.py.

``ZKSTREAM_NO_CORK=1`` (or ``cork=False`` on Client / ZKServer)
degrades to write-through — every frame still flows through the plane
(and the histograms), it just flushes per frame.

Beneath the plane sits the batched-syscall transport tier
(io/transport.py, ``ZKSTREAM_TRANSPORT=uring|mmsg|asyncio``): when a
tier is attached, a flush hands its chunk list to the tier's
per-tick submission queue instead of joining and writing — one
io_uring submission (or one C writev batch) then covers EVERY dirty
connection of the tick.  The plane's contracts are tier-independent:
``flush_hard`` still puts bytes on the wire before returning (the
tier drains that entry synchronously), the durability barrier still
gates BEFORE bytes reach any queue, and a disabled cork bypasses the
tier entirely (the frame-per-syscall validator).  The
``ZKSTREAM_FLUSH_CAP`` env (``flush_cap=`` on Client / ZKServer)
resizes the early-flush cap.

The receive direction mirrors this stack one module over
(io/ingress.py): accept shards + one batched receive drain per dirty
shard per tick beneath the unchanged decode path, with the
connection's accept shard doubling as its watch fan-out shard — so a
connection's corked replies, buffered notifications and drained
requests all live with one shard.
"""

from __future__ import annotations

import os
import time

from ..utils import trace as _trace
from ..utils.aio import ambient_loop
from .transport import METRIC_FLUSH_SYSCALLS

METRIC_FLUSH_FRAMES = 'zookeeper_flush_batch_frames'
METRIC_FLUSH_BYTES = 'zookeeper_flush_batch_bytes'

#: Frames-per-flush distribution buckets (a flush of 1 = no batching
#: happened this tick; the interesting mass is 2+).
FRAME_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)
#: Bytes-per-flush distribution buckets.
BYTE_BUCKETS = (64, 256, 1024, 4096, 16384, 65536, 262144, 1048576)

#: Early-flush cap: a burst larger than this flushes immediately
#: instead of waiting for the tick boundary (bounds cork memory and
#: keeps huge writes streaming).
DEFAULT_MAX_CORK = 256 * 1024


def cork_default() -> bool:
    """Process-wide default for new planes (env kill switch)."""
    return os.environ.get('ZKSTREAM_NO_CORK') != '1'


def flush_cap_default() -> int:
    """The early-flush cap for new planes: ``ZKSTREAM_FLUSH_CAP``
    (bytes) when set and positive, else :data:`DEFAULT_MAX_CORK`."""
    try:
        v = int(os.environ.get('ZKSTREAM_FLUSH_CAP', ''))
    except ValueError:
        return DEFAULT_MAX_CORK
    return v if v > 0 else DEFAULT_MAX_CORK


class SendPlane:
    """One connection's outbound cork.

    ``write`` is the underlying sink (``transport.write`` behind a
    liveness guard); it is only ever called with already-encoded,
    already-fault-screened frame bytes, joined in append order.
    """

    __slots__ = ('_write', '_chunks', '_pending', '_scheduled',
                 'enabled', 'max_bytes', '_frames_hist', '_bytes_hist',
                 '_labels', '_barrier', '_ledger', '_tier', '_entry',
                 '_syscall_ctr', '_transport_fn', '_spans', 'log_mark')

    def __init__(self, write, *, enabled: bool | None = None,
                 max_bytes: int | None = None,
                 collector=None, plane: str = 'client',
                 barrier=None, ledger=None,
                 tier=None, transport_fn=None, spans: list | None = None):
        self._write = write
        #: Optional list of the client op spans (utils/trace.py) whose
        #: frames are corked here, kept by the connection: the flush
        #: that hands them to the transport stamps their ``t_sent``
        #: and empties the list (reused, never replaced).
        self._spans = spans
        #: Server planes: the WAL position just past this connection's
        #: newest appended txn (the connection sets it), handed to the
        #: barrier so it can tell a hold for the connection's own
        #: writes from one for other sessions' (server/persist.py).
        self.log_mark = 0
        #: Optional io/transport.TransportTier + the live-transport
        #: accessor it resolves an fd from: flushed chunk lists defer
        #: to the tier's per-tick batched submission instead of being
        #: joined and written here.  The cork kill switch bypasses it
        #: (write-through means frame-per-syscall, the validator).
        self._tier = tier
        self._entry = (tier.channel(write, transport_fn)
                       if tier is not None and transport_fn is not None
                       else None)
        #: Kept tier or no tier: :meth:`buffered_bytes` needs the live
        #: transport to include its write buffer in the tx account.
        self._transport_fn = transport_fn
        #: Optional utils/metrics.TickLedger (server planes): flush
        #: time lands in the ``cork_flush`` tick phase, loop-blocking
        #: barrier time in ``fsync_gate``.
        self._ledger = ledger
        #: Optional durability barrier gating corked bytes
        #: (server/persist.py WriteAheadLog): the acks of one tick
        #: share one group fsync, and no ack byte reaches the sink
        #: before its txn is on disk.  ``barrier.gate_flush(release)``
        #: returns True when everything appended is already durable;
        #: otherwise the flush stays corked, a group fsync runs on an
        #: executor thread (the loop keeps serving), and ``release``
        #: re-flushes when durability catches up.  Paths that must
        #: hit the wire mid-tick use :meth:`flush_hard`, which takes
        #: the barrier synchronously instead.  With the cork disabled
        #: frames still flow through the gate one by one — stricter,
        #: never weaker.
        self._barrier = barrier
        self._chunks: list[bytes] = []
        self._pending = 0
        self._scheduled = False
        self.enabled = cork_default() if enabled is None else enabled
        self.max_bytes = (flush_cap_default() if max_bytes is None
                          else max_bytes)
        self._frames_hist = None
        self._bytes_hist = None
        self._syscall_ctr = None
        self._labels = {'plane': plane}
        if collector is not None:
            self._frames_hist = collector.histogram(
                METRIC_FLUSH_FRAMES,
                'Frames per coalesced transport write, by plane',
                buckets=FRAME_BUCKETS)
            self._bytes_hist = collector.histogram(
                METRIC_FLUSH_BYTES,
                'Bytes per coalesced transport write, by plane',
                buckets=BYTE_BUCKETS)
            self._syscall_ctr = collector.counter(
                METRIC_FLUSH_SYSCALLS,
                'Write submissions issued by the outbound plane, by '
                'plane and backend')

    @property
    def pending(self) -> int:
        """Bytes appended but not yet flushed."""
        return self._pending

    def buffered_bytes(self) -> int:
        """Everything this connection has accepted for transmission
        but not yet handed to the kernel: the cork's pending bytes,
        the transport tier entry's deferred chunks, and the asyncio
        transport's own write buffer — the tx-side account the
        overload plane's watermarks compare against (io/overload.py).
        A stalled reader grows exactly this number."""
        n = self._pending
        e = self._entry
        if e is not None:
            n += e.nbytes
        t = (self._transport_fn() if self._transport_fn is not None
             else None)
        if t is not None:
            try:
                n += t.get_write_buffer_size()
            except (OSError, RuntimeError, AttributeError):
                pass
        return n

    def send(self, data: bytes) -> None:
        """Append one encoded frame; it reaches the sink at the next
        tick flush (or immediately: cork disabled / size cap hit)."""
        if not self.enabled:
            if self._barrier is None:
                self._observe(1, len(data))
                self._count_legacy()
                self._write(data)
                if self._spans:
                    self._stamp_sent()
                return
            # write-through still rides the gate: the frame corks for
            # exactly one (usually immediate) gated flush
            self._chunks.append(data)
            self._pending += len(data)
            self.flush_now()
            return
        self._chunks.append(data)
        self._pending += len(data)
        if self._pending >= self.max_bytes:
            self.flush_now()
            return
        if not self._scheduled:
            self._scheduled = True
            if self._entry is not None:
                # a transport tier owns the tick boundary: ONE loop
                # callback flushes every registered plane and submits
                # the whole batch (instead of one call_soon per
                # connection per tick)
                self._tier.schedule_flush(self)
            else:
                ambient_loop().call_soon(self._tick_flush)

    def _tick_flush(self) -> None:
        self._scheduled = False
        self.flush_now()

    def send_flush(self, data: bytes) -> None:
        """Append one frame and flush immediately — for callers that
        ARE the tick boundary (the watch table's per-shard fan-out
        flush, server/watchtable.py): scheduling the usual deferred
        tick flush from here would add one loop-callback round trip
        per connection per tick, the dominant cost of a 100k-watcher
        fan-out.  Anything already corked (this tick's replies)
        leaves in the same buffer, order preserved; the durability
        barrier is honored exactly as in :meth:`flush_now`."""
        self._chunks.append(data)
        self._pending += len(data)
        self.flush_now()

    def flush_now(self) -> None:
        """Write everything corked, in order, as one buffer — once the
        durability barrier (if any) clears.  A gated flush keeps the
        frames corked while the group fsync runs off-loop and re-runs
        when it completes, so the stream order never changes; callers
        that need the bytes on the wire before they return use
        :meth:`flush_hard`."""
        if not self._chunks:
            return
        if self._barrier is not None:
            led = self._ledger
            if led is not None:
                # the barrier may take the fsync inline (fast-device
                # short-circuit): that is loop-blocked durability time
                led.enter('fsync_gate')
                try:
                    clear = self._barrier.gate_flush(self.flush_now,
                                                     self.log_mark)
                finally:
                    led.exit()
            else:
                clear = self._barrier.gate_flush(self.flush_now,
                                                 self.log_mark)
            if not clear:
                return          # durability pending: released later
        self._write_out()

    def flush_hard(self) -> None:
        """Barrier taken synchronously, bytes written before return —
        for paths where later writes must not overtake (fault-injected
        delivery, CLOSE_SESSION ahead of EOF, connection close).  With
        a transport tier attached the entry's pending bytes are
        submitted on the spot (single-entry submission), so the
        synchronous contract holds on every backend."""
        if self._barrier is not None:
            led = self._ledger
            if led is not None:
                led.enter('fsync_gate')
                try:
                    self._barrier.sync_for_flush()
                finally:
                    led.exit()
            else:
                self._barrier.sync_for_flush()
        self._write_out(hard=True)

    def _write_out(self, hard: bool = False) -> None:
        # the port's zk.flush range (utils/trace.py) covers the write
        # here; behind a transport tier, the tier's submission
        h = (_trace.range_enter('zk.flush')
             if _trace.profiler_ranges and (self._entry is None
                                           or not self.enabled)
             else None)
        try:
            if not self._chunks:
                # a hard flush must still drain bytes an earlier flush
                # (cap hit, barrier release) parked in the tier entry —
                # or a direct write issued right after would overtake
                # them
                if hard and self._entry is not None:
                    self._tier.drain(self._entry)
                return
            chunks = self._chunks
            n = len(chunks)
            size = self._pending
            self._chunks = []
            self._pending = 0
            self._observe(n, size)
            entry = self._entry
            if entry is not None and self.enabled:
                # deferred to the tier's tick submission (one batched
                # syscall chain covering every dirty connection); the
                # tier accounts the syscalls and the ledger's
                # cork_flush.  A hard flush drains this entry
                # synchronously instead.
                self._tier.enqueue(entry, chunks, size)
                if hard:
                    self._tier.drain(entry)
            else:
                self._count_legacy()
                led = self._ledger
                data = chunks[0] if n == 1 else b''.join(chunks)
                if led is not None:
                    led.enter('cork_flush')
                    try:
                        self._write(data)
                    finally:
                        led.exit()
                else:
                    self._write(data)
            if self._spans:
                self._stamp_sent()
        finally:
            if h is not None:
                _trace.range_exit(h)

    def _stamp_sent(self) -> None:
        """Every corked op's frame has just been handed over."""
        t = time.perf_counter()
        spans = self._spans
        for span in spans:
            span.t_sent = t
            if span.status != 'open':
                span.restamp()      # settled before its frame went out
        spans.clear()

    def reset(self) -> None:
        """Drop corked frames without writing (connection aborted:
        the bytes have nowhere to go) — anything already deferred to
        the transport tier goes with them."""
        self._chunks = []
        self._pending = 0
        if self._spans:
            self._spans.clear()
        if self._entry is not None:
            self._tier.discard(self._entry)

    def _observe(self, frames: int, nbytes: int) -> None:
        if self._frames_hist is not None:
            self._frames_hist.observe(frames, self._labels)
            self._bytes_hist.observe(nbytes, self._labels)

    def _count_legacy(self) -> None:
        if self._syscall_ctr is not None:
            self._syscall_ctr.increment(
                {'plane': self._labels['plane'], 'backend': 'asyncio'})


def scrape_flush_cells(collector) -> dict:
    """Summarize the flush-batch histograms per plane for bench cells
    (bench.py client_ops, tools/sweep_crossover.py): flush count,
    mean/p50/p99 frames per flush, p50/p99 bytes per flush."""
    out: dict = {}
    try:
        fr = collector.get_collector(METRIC_FLUSH_FRAMES)
        by = collector.get_collector(METRIC_FLUSH_BYTES)
    except ValueError:
        return out
    for key in fr.label_keys():
        labels = dict(key)
        n = fr.count(labels)
        if not n:
            continue
        out[labels.get('plane', '')] = {
            'flushes': n,
            'frames_mean': round(fr.sum(labels) / n, 2),
            'frames_p50': round(fr.percentile(50, labels), 2),
            'frames_p99': round(fr.percentile(99, labels), 2),
            'bytes_p50': round(by.percentile(50, labels), 1),
            'bytes_p99': round(by.percentile(99, labels), 1),
        }
    return out
