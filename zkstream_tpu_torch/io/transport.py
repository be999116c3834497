"""Batched-syscall transport backends beneath the send plane.

The tick cork (io/sendplane.py) already joins every frame a connection
sends within one event-loop iteration into one ``transport.write`` —
but a WIDE tick still costs one write(2) per dirty connection, so a
busy server at 1k–10k connections spends its ``cork_flush`` /
``fanout_flush`` tick phases (the tick ledger's numbers) on pure
syscall dispatch.  This module swaps the syscall layer underneath the
unchanged SendPlane API — the PAPERS.md thread (RPCAcc, ACCL+,
transparent InfiniBand under netty) applied here: the RPC surface
stays put, the batching decision lives in exactly one place.

Three tiers, capability-probed and env-forced exactly like the codec
tiers (``ZKSTREAM_TRANSPORT=uring|mmsg|asyncio``):

- ``uring``   — a shared io_uring submission queue: ONE
  ``io_uring_enter`` per corked tick covers every dirty connection
  (one ``IORING_OP_SENDMSG`` SQE per connection, iovec-joined, so no
  intermediate Python ``bytes`` is materialized per connection
  either).  Requires Linux >= 5.1 and the native extension
  (csrc/zkwire_ext.c ``uring_*``).
- ``mmsg``    — per-connection vectored writes: one ``writev(2)`` per
  dirty connection per tick, submitted for the whole batch in ONE C
  call (``zkwire_ext.submit_writev``) when the extension is built, an
  ``os.writev`` loop otherwise.  TCP has no cross-fd ``sendmmsg``;
  the vectored submit is its stream-socket equivalent — the syscall
  count stays O(dirty conns) but the join and the per-write asyncio
  transport walk disappear.
- ``asyncio`` — the existing per-plane ``transport.write`` path,
  untouched: the env-gated validator (and the only tier off Linux).

The default is the best available tier; forcing an unavailable tier
falls DOWN the order (never up), so an exported ``uring`` on an old
kernel degrades to ``mmsg`` instead of failing — ``probe()`` records
why, and the ``zk_transport_backend`` mntr row shows what a member
actually runs.

Correctness contract (the parity suite in tests/test_torch_transport.py
holds all tiers to byte-identical per-connection streams):

- **Per-connection ordering is submission order.**  An entry's chunks
  append in plane-flush order; raw submission happens at the tick
  boundary; a partial or refused (``EAGAIN``) raw write routes the
  REMAINDER through the asyncio transport, and every subsequent tick
  defers to the transport until its buffer drains (`` raw writes only
  when get_write_buffer_size() == 0``) — so the kernel sees every
  byte exactly once, in order, whichever path carried it.
- **Hard flushes stay synchronous.**  ``SendPlane.flush_hard`` (fault
  injection delivering mid-tick, CLOSE_SESSION ahead of EOF,
  connection close) drains that entry's pending bytes with an
  immediate single-entry submission before returning — the fault
  injector's per-frame boundary rule (io/faults.py) is unchanged.
- **The durability barrier is upstream.**  The plane gates corked
  acks on the WAL's group fsync BEFORE handing bytes to the tier
  (SendPlane.flush_now), so no ack byte reaches a submission queue
  before its txn is on disk — backend-independent.

Observability: ``zookeeper_flush_syscalls_total{plane,backend}``
counts actual write submissions (the A/B number: O(dirty conns) per
tick on mmsg/asyncio, O(1) on uring) and ``zookeeper_submit_depth``
histograms connections covered per batched submission.  Scraped by
``bench.py --transport`` (`make bench-transport`).
"""

from __future__ import annotations

import dataclasses
import errno
import logging
import os
import sys

from ..utils.aio import ambient_loop

log = logging.getLogger('zkstream_tpu_torch.transport')

TRANSPORT_ENV = 'ZKSTREAM_TRANSPORT'

#: Fallback order: forcing an unavailable tier falls DOWN this list.
BACKENDS = ('uring', 'mmsg', 'asyncio')

METRIC_FLUSH_SYSCALLS = 'zookeeper_flush_syscalls_total'
METRIC_SUBMIT_DEPTH = 'zookeeper_submit_depth'

#: Connections per batched submission (the depth distribution: 1 =
#: batching bought nothing that tick, the interesting mass is 2+).
DEPTH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096)

#: Per-entry chunk-count guard: above this the entry's chunks are
#: coalesced in place before submission so one connection's frame
#: count can never overflow an iovec array (IOV_MAX is 1024).
IOV_GUARD = 512

#: io_uring submission-queue depth (entries per ring; batches wider
#: than this submit in waves — still one enter syscall per wave).
URING_DEPTH = 1024

#: Raw-write errnos meaning the connection itself is gone (drop the
#: bytes, exactly as an aborted transport would) — anything else
#: (EAGAIN backpressure, ring-level transients like EBUSY/ENOMEM/
#: ENOBUFS) re-routes through the asyncio transport, which either
#: delivers or runs its own teardown.  EIO doubles as the native
#: uring layer's "submission state unknown" sentinel: a resend there
#: could duplicate bytes, so those drop.
_DEAD_ERRNOS = frozenset({errno.EPIPE, errno.ECONNRESET,
                          errno.EBADF, errno.ENOTCONN,
                          errno.ESHUTDOWN, errno.ECONNABORTED,
                          errno.EIO})


@dataclasses.dataclass(frozen=True)
class Probe:
    """What the capability probe found (``zk_transport_backend`` and
    the pytest skip markers read this)."""

    platform: str
    uring: bool
    uring_reason: str
    mmsg: bool
    mmsg_reason: str
    forced: str | None
    chosen: str

    def available(self, backend: str) -> bool:
        if backend == 'uring':
            return self.uring
        if backend == 'mmsg':
            return self.mmsg
        return True


#: Cached CAPABILITY results only — the env force is re-read on every
#: probe() call (like cork_default), so tests and the chaos CLI can
#: flip ZKSTREAM_TRANSPORT mid-process.
_caps_cache: tuple[tuple[bool, str], tuple[bool, str]] | None = None


def _probe_uring() -> tuple[bool, str]:
    """Can this process create an io_uring?  Needs Linux, the native
    extension (the ring lives in csrc/zkwire_ext.c), and a kernel
    that answers io_uring_setup (>= 5.1)."""
    if not sys.platform.startswith('linux'):
        return False, 'not linux'
    from ..utils.native import get_ext
    ext = get_ext()
    if ext is None:
        return False, 'native ext unavailable (build pending or off)'
    if not hasattr(ext, 'uring_create'):
        return False, 'native ext predates uring support'
    try:
        ring = ext.uring_create(8)
    except OSError as e:
        return False, 'io_uring_setup: %s' % (e.strerror or e,)
    ext.uring_close(ring)
    return True, 'ok'


def _probe_mmsg() -> tuple[bool, str]:
    if not hasattr(os, 'writev'):
        return False, 'os.writev unavailable'
    if sys.platform.startswith('win'):
        return False, 'not posix'
    return True, 'ok'


def probe(refresh: bool = False) -> Probe:
    """Resolve the process's transport tier: capability probe
    (cached; ``refresh=True`` re-probes — tests that build the native
    extension mid-process use it, and a tier created before the
    background ext build lands simply runs one tier lower) plus the
    env force, re-read every call."""
    global _caps_cache
    if _caps_cache is None or refresh:
        _caps_cache = (_probe_uring(), _probe_mmsg())
    (uring_ok, uring_why), (mmsg_ok, mmsg_why) = _caps_cache
    forced = os.environ.get(TRANSPORT_ENV) or None
    if forced is not None and forced not in BACKENDS:
        forced = None
    order = BACKENDS[BACKENDS.index(forced):] if forced else BACKENDS
    chosen = 'asyncio'
    for b in order:
        if (b == 'uring' and uring_ok) or (b == 'mmsg' and mmsg_ok) \
                or b == 'asyncio':
            chosen = b
            break
    return Probe(platform=sys.platform, uring=uring_ok,
                 uring_reason=uring_why, mmsg=mmsg_ok,
                 mmsg_reason=mmsg_why, forced=forced, chosen=chosen)


def backend_default() -> str:
    """The process-wide backend (env force resolved against the
    probe) — what a knobless ZKServer/Client runs."""
    return probe().chosen


def resolve_backend(arg: str | None) -> str:
    """Resolve an explicit constructor knob ('uring'|'mmsg'|'asyncio',
    None = process default) against availability, falling down the
    tier order like the env force does."""
    if arg is None:
        return backend_default()
    if arg not in BACKENDS:
        raise ValueError('unknown transport backend %r (choose from '
                         '%s)' % (arg, '|'.join(BACKENDS)))
    p = probe()
    for b in BACKENDS[BACKENDS.index(arg):]:
        if p.available(b):
            return b
    return 'asyncio'


class _Entry:
    """One connection's slot in the tier: the transport accessor (the
    live asyncio transport, or None once the socket is gone), the
    legacy sink for fallback writes, and the chunks deferred to the
    next tick submission.  The resolved fd is cached keyed on the
    transport's identity — safe against fd reuse because it is only
    consulted while ``transport_fn()`` returns that same, still-open
    transport object."""

    __slots__ = ('transport_fn', 'write', 'chunks', 'nbytes',
                 '_t', '_fd')

    def __init__(self, write, transport_fn):
        self.write = write              # the plane's asyncio sink
        self.transport_fn = transport_fn
        self.chunks: list[bytes] = []
        self.nbytes = 0
        self._t = None
        self._fd = -1

    def resolve_fd(self, t) -> int:
        if t is self._t:
            return self._fd
        fd = -1
        sock = t.get_extra_info('socket')
        if sock is not None:
            try:
                fd = sock.fileno()
            except (OSError, ValueError):
                fd = -1
        self._t = t
        self._fd = fd
        return fd

    def take(self) -> list[bytes]:
        chunks = self.chunks
        self.chunks = []
        self.nbytes = 0
        return chunks


class TransportTier:
    """One event loop's batched submission queue: SendPlanes enqueue
    their flushed chunk lists here instead of writing, and ONE
    deferred callback per busy tick submits every dirty connection's
    buffer in a single batched syscall chain."""

    def __init__(self, backend: str, collector=None,
                 plane: str = 'server', ledger=None):
        assert backend in ('uring', 'mmsg'), backend
        self.backend = backend
        self.plane = plane
        #: Optional utils/metrics.TickLedger: submission time is the
        #: tick's ``cork_flush`` phase (the same phase the per-plane
        #: asyncio writes account under, so ledger shares stay
        #: comparable across backends).
        self.ledger = ledger
        self._dirty: list[_Entry] = []
        #: Planes that corked frames this tick and delegated their
        #: tick flush here: ONE loop callback flushes them all and
        #: submits the resulting batch — the per-connection
        #: ``call_soon`` the legacy path pays per tick (measured at
        #: ~45% of a wide fan-out, PROFILE.md) collapses into this
        #: single callback.
        self._tick_work: list = []
        #: The loop holding the pending tick callback (None = none).
        #: Loop identity, not a bool: a callback stranded on a dead
        #: loop (a client reused across asyncio.run calls) must not
        #: block scheduling on the next loop forever.
        self._scheduled_on = None
        self._uring = None
        self._uring_dead = False
        self.syscalls = 0        # lifetime submissions (tests/mntr)
        self.submissions = 0     # batched submit rounds
        self._syscall_ctr = None
        self._depth_hist = None
        if collector is not None:
            self._syscall_ctr = collector.counter(
                METRIC_FLUSH_SYSCALLS,
                'Write submissions issued by the outbound plane, by '
                'plane and backend')
            self._depth_hist = collector.histogram(
                METRIC_SUBMIT_DEPTH,
                'Connections covered per batched transport '
                'submission, by plane and backend',
                buckets=DEPTH_BUCKETS)

    # -- SendPlane-facing API --

    def channel(self, write, transport_fn) -> _Entry:
        """One per SendPlane: created at plane construction, reused
        for the connection's lifetime."""
        return _Entry(write, transport_fn)

    def enqueue(self, entry: _Entry, chunks: list[bytes],
                nbytes: int) -> None:
        """Defer one plane flush to the tick submission.  The entry's
        transport is resolved at submit time — an entry whose
        transport is already gone falls back to its plane sink there
        (where the write is a no-op on a dead connection anyway)."""
        if not entry.chunks:
            self._dirty.append(entry)
            entry.chunks = chunks       # adopt: the plane released it
        else:
            entry.chunks.extend(chunks)
        entry.nbytes += nbytes
        if len(entry.chunks) > IOV_GUARD:
            # bound the iovec array a pathological tick could build
            entry.chunks = [b''.join(entry.chunks)]
        self._schedule()

    def _schedule(self) -> None:
        """Ensure the tick callback is pending on the CURRENT loop.
        ``is_closed`` on the stored loop (cheap, ~75 ns) — not a loop
        compare via ``get_running_loop`` (which pays a getpid syscall
        per call on this image) — detects a callback stranded on a
        dead loop, so a tier reused across asyncio.run calls can
        never wedge."""
        sched = self._scheduled_on
        if sched is not None and not sched.is_closed():
            return
        loop = ambient_loop()
        self._scheduled_on = loop
        loop.call_soon(self._tick)

    def schedule_flush(self, plane) -> None:
        """Register one plane for the tick's shared flush callback
        (SendPlane.send calls this instead of scheduling its own
        ``call_soon`` when a tier is attached).  The plane guards
        against double registration with its own ``_scheduled``
        flag."""
        self._tick_work.append(plane._tick_flush)
        self._schedule()

    def schedule_call(self, fn) -> None:
        """Run ``fn`` inside the tick callback, BEFORE the batched
        submission — for flush work that feeds the tier (the watch
        table's per-shard fan-out flushes): scheduling it as its own
        ``call_soon`` would land its bytes one loop hop after the
        submission that should have carried them."""
        self._tick_work.append(fn)
        self._schedule()

    def drain(self, entry: _Entry) -> None:
        """Hard flush: submit THIS entry's pending bytes now (the
        flush_hard contract — bytes on the wire before return).  The
        entry may stay in the dirty list; the tick submission skips
        entries whose chunks are already gone."""
        if entry.chunks:
            self._submit([entry])

    def discard(self, entry: _Entry) -> None:
        """Connection aborted: its pending bytes have nowhere to go
        (SendPlane.reset)."""
        entry.take()

    # -- the tick submission --

    def _tick(self) -> None:
        """The tick boundary: run every registered flush (plane tick
        flushes and shard fan-out flushes — their enqueues land while
        the schedule slot is still held, so they cannot re-schedule),
        then submit the whole dirty set as one batch — flush and
        submission share the one callback, so batched bytes reach the
        kernel in the same loop iteration the legacy per-plane
        flushes would have used.

        One raising flush must not take the rest of the tick with it:
        the legacy path isolated a callback failure to its one
        connection (each flush was its own ``call_soon``), and the
        shared callback must be no weaker — errors are logged per
        flush, and the submission + schedule-slot release always
        run."""
        work, self._tick_work = self._tick_work, []
        try:
            for fn in work:
                try:
                    fn()
                except Exception:
                    log.exception('transport tick flush failed')
        finally:
            self._scheduled_on = None
            dirty, self._dirty = self._dirty, []
            self._submit(dirty)

    def _count(self, n: int, backend: str) -> None:
        self.syscalls += n
        if self._syscall_ctr is not None and n:
            self._syscall_ctr.increment(
                {'plane': self.plane, 'backend': backend}, by=n)

    def _submit(self, entries: list[_Entry]) -> None:
        """Resolve each entry's fd and submit the whole batch through
        the backend; anything raw-ineligible (no socket, transport
        already buffering, closing) routes through its asyncio sink —
        the FIFO transport buffer keeps ordering either way."""
        batch_fds: list[int] = []
        batch_chunks: list[list[bytes]] = []
        raw_entries: list[tuple[_Entry, list[bytes], int]] = []
        for e in entries:
            chunks = e.chunks
            if not chunks:
                continue        # drained hard mid-tick, or reset
            # take the chunks NOW: a hard-drained entry re-dirtied in
            # the same tick appears in `entries` twice, and only an
            # emptied entry makes the second visit a no-op
            nbytes = e.nbytes
            e.chunks = []
            e.nbytes = 0
            fd = -1
            t = e.transport_fn()
            if t is not None:
                # fast paths over the selector transport's private
                # state: is_closing() is an attribute read behind a
                # method call, and get_write_buffer_size() allocates
                # (sum(map(len, deque))) — at 10k dirty connections
                # per tick both matter.  Transports without the
                # attributes (uvloop, proactor) take the public API.
                closing = getattr(t, '_closing', None)
                if closing is None:
                    closing = t.is_closing()
                if not closing:
                    wbuf = getattr(t, '_buffer', None)
                    if (not wbuf if wbuf is not None
                            else t.get_write_buffer_size() == 0):
                        fd = e.resolve_fd(t)
            if fd < 0:
                self._count(1, 'asyncio')
                e.write(chunks[0] if len(chunks) == 1
                        else b''.join(chunks))
                continue
            batch_fds.append(fd)
            batch_chunks.append(chunks)
            raw_entries.append((e, chunks, nbytes))
        if not batch_fds:
            return
        led = self.ledger
        if led is not None:
            led.enter('cork_flush')
        try:
            results, nsys = self._submit_raw(batch_fds, batch_chunks)
        finally:
            if led is not None:
                led.exit()
        self.submissions += 1
        self._count(nsys, self.backend)
        if self._depth_hist is not None:
            self._depth_hist.observe(
                len(batch_fds), {'plane': self.plane,
                                 'backend': self.backend})
        for (e, chunks, nbytes), res in zip(raw_entries, results):
            if res != nbytes:       # the hot path writes everything
                self._settle(e, chunks, nbytes, res)

    def _settle(self, entry: _Entry, chunks: list[bytes],
                nbytes: int, res: int) -> None:
        """Apply one incomplete raw-write result: a short or refused
        write hands the remainder to the asyncio transport (which
        queues FIFO and re-enables raw writes only once drained); a
        dead-socket errno drops the bytes exactly as a closed
        transport would.  Transient errnos (backpressure, a failed
        ring submission that provably sent nothing) resend through
        the transport — never a silent drop on a live connection."""
        if res < 0:
            if -res not in _DEAD_ERRNOS:
                self._count(1, 'asyncio')
                entry.write(b''.join(chunks))
            return
        if res >= nbytes:
            return
        # partial write: the kernel buffer filled mid-entry — the
        # remainder must queue in the transport so later ticks (which
        # see a nonzero write buffer) stay behind it
        rem = memoryview(b''.join(chunks))[res:]
        self._count(1, 'asyncio')
        entry.write(bytes(rem))

    # -- backends --

    def _submit_raw(self, fds, chunklists) -> tuple[list[int], int]:
        if self.backend == 'uring':
            out = self._submit_uring(fds, chunklists)
            if out is not None:
                return out
            # ring creation failed after probe said OK (fd limits,
            # seccomp): latch down to the mmsg path for this tier
        return self._submit_mmsg(fds, chunklists)

    def _submit_uring(self, fds, chunklists
                      ) -> tuple[list[int], int] | None:
        if self._uring_dead:
            return None
        from ..utils.native import get_ext
        ext = get_ext()
        if ext is None or not hasattr(ext, 'uring_submit'):
            return None
        if self._uring is None:
            try:
                self._uring = ext.uring_create(URING_DEPTH)
            except OSError:
                self._uring_dead = True
                return None
        try:
            results, enters = ext.uring_submit(self._uring, fds,
                                               chunklists)
        except OSError:
            self._uring_dead = True
            return None
        return results, enters

    def _submit_mmsg(self, fds, chunklists) -> tuple[list[int], int]:
        from ..utils.native import get_ext
        ext = get_ext()
        if ext is not None and hasattr(ext, 'submit_writev'):
            # ONE C call for the whole batch: per-entry writev loops
            # (the join-and-write boundary) without a Python-level
            # join or per-connection Python syscall dispatch
            return ext.submit_writev(fds, chunklists), len(fds)
        results = []
        for fd, chunks in zip(fds, chunklists):
            try:
                results.append(os.writev(fd, chunks))
            except BlockingIOError:
                results.append(-errno.EAGAIN)
            except OSError as e:
                results.append(-(e.errno or 1))
        return results, len(fds)

    def close(self) -> None:
        """Release the ring fd + mmaps now (ZKServer.stop /
        Client.close call this — the plane/entry closures hold the
        tier in reference cycles, so refcount-time release never
        happens; the capsule destructor remains the GC backstop).
        The next submission lazily re-creates the ring, so a
        restarted server/client keeps working."""
        if self._uring is not None:
            from ..utils.native import get_ext
            ext = get_ext()
            if ext is not None:
                try:
                    ext.uring_close(self._uring)
                except (OSError, ValueError):
                    pass
            self._uring = None


def make_tier(arg: str | None, collector=None, plane: str = 'server',
              ledger=None) -> TransportTier | None:
    """Build the tier for one server/client, or None when the
    resolved backend is ``asyncio`` (planes then keep their legacy
    write path untouched)."""
    backend = resolve_backend(arg)
    if backend == 'asyncio':
        return None
    return TransportTier(backend, collector=collector, plane=plane,
                         ledger=ledger)
