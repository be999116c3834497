"""The black-box plane: a crash-durable flight recorder per member.

Every other telemetry surface — the span ring (utils/trace.py), the
tick ledger and Collector (utils/metrics.py), the FSM census
(utils/fsm.py) — lives in process memory, so the one member whose
story matters most in a chaos post-mortem (the SIGKILL'd leader)
contributes nothing to the merged timeline.  This module fixes that:
each member appends schema-stamped **frames** to a bounded on-disk
ring in its WAL directory, CRC32C-framed exactly like the WAL itself
(server/persist.py: a torn *final* record is the normal crash
signature and is tolerated; a bit-flip anywhere fails the checksum
and nothing at or past it is trusted).

A frame snapshots, at a configurable cadence (``ZKSTREAM_BLACKBOX_MS``):

- the full ``mntr`` counter inventory (``ZKServer.monitor_stats``),
- the tick ledger's per-phase p99s,
- the FSM census (live state machines per (fsm, state)),
- the tail of the member's span ring,

plus one explicit ``final`` frame flushed on clean ``stop()`` and one
``slow_op`` frame per span that exceeded ``ZKSTREAM_SLOW_OP_MS``
(carrying the span's whole zxid-keyed causal chain — the real-ZK
warn-threshold log line, but with spans).  Writes ride the same
executor-thread pattern as the WAL's group fsync: the loop snapshots,
a worker thread writes — the hot path never waits on the device.

Recovery side: :func:`scan_box` / :func:`read_box` verify and decode
a ring (the ``blackbox DIR`` CLI verb), and
:func:`harvest_spans` lifts dead members' trace tails back into
``merge_timelines``-ready rings — which is how both chaos tiers give
a SIGKILL'd member a voice in ``chaos --trace-out``.

On-disk ring: ``blackbox.<member>.log`` plus at most one rotated
``blackbox.<member>.log.old`` — disk is bounded at ~2x
``cap_bytes`` regardless of uptime.  The files are co-tenants of the
WAL directory by design: ``scan_dir``/``reset_dir`` match only the
``wal.``/``snap.`` prefixes, so the recorder's files survive a
follower's snapshot bootstrap and never confuse WAL recovery.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time

#: Version stamp inside every frame body; consumers key on it.
BLACKBOX_SCHEMA = 1

#: Version stamp on every ``top --out`` CLI JSONL row (the
#: continuous fleet collector's time-series).
TOP_SCHEMA = 1

#: File magic, persist.py style: module, version, newline.
MAGIC_BLACKBOX = b'ZKSBBX1\n'

#: Record framing shared with the WAL: ``>I length | >I crc32c(body)``
#: then the JSON body.  Reusing the exact layout keeps the torn/
#: bit-flip semantics (and the test corpus discipline) identical.
_REC_HDR = struct.Struct('>II')

#: Sanity cap on one frame (a full mntr inventory + a 64-span tail is
#: a few tens of KiB; anything near this is corruption, not data).
MAX_FRAME = 8 * 1024 * 1024

#: How many trailing spans of the member ring ride in each frame.
TRACE_TAIL = 64

#: ``zookeeper_slow_op_ms`` histogram buckets (ms): the slow-op
#: threshold family — sub-threshold ops never observe here.
SLOW_OP_BUCKETS = (1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                   1000.0, 2500.0, 5000.0, 10000.0)

METRIC_SLOW_OP_MS = 'zookeeper_slow_op_ms'


def blackbox_enabled() -> bool:
    """Process-wide default for the flight recorder.
    ``ZKSTREAM_NO_BLACKBOX=1`` disables it — the off arm of the
    paired overhead family (`bench.py --blackbox`), mirroring the
    WAL/trace/watchtable kill switches."""
    return os.environ.get('ZKSTREAM_NO_BLACKBOX') != '1'


def blackbox_interval_ms() -> float:
    """Frame cadence in ms (``ZKSTREAM_BLACKBOX_MS``, default 250):
    how much history one frame covers, and the most telemetry a crash
    can lose."""
    try:
        return float(os.environ.get('ZKSTREAM_BLACKBOX_MS', '250'))
    except ValueError:
        return 250.0


def slow_op_ms() -> float:
    """The slow-op digest threshold in ms (``ZKSTREAM_SLOW_OP_MS``,
    default 500): any span on an instrumented ring whose duration
    meets it gets its causal chain persisted and counted
    (``zk_slow_ops_total``).  Clean schedules at the default must
    count zero."""
    try:
        return float(os.environ.get('ZKSTREAM_SLOW_OP_MS', '500'))
    except ValueError:
        return 500.0


def box_path(directory: str, member: str) -> str:
    return os.path.join(directory, 'blackbox.%s.log' % (member,))


def _crc32c(data: bytes) -> int:
    # the WAL's tiered impl (C extension when built, else the sliced
    # software Castagnoli) — one checksum algorithm per repo
    from ..server.persist import crc32c
    return crc32c(data)


def encode_frame(body: dict) -> bytes:
    """One CRC-framed record: length, crc32c(body), JSON body."""
    raw = json.dumps(body, separators=(',', ':'),
                     default=repr).encode('utf-8')
    return _REC_HDR.pack(len(raw), _crc32c(raw)) + raw


class BoxScan:
    """One ring file's verified contents.  ``status`` mirrors the WAL
    segment statuses: 'ok' | 'torn' (truncated tail — the crash
    signature, tolerated) | 'crc' (bit flip: rejected, nothing at or
    past it trusted) | 'corrupt' (bad magic / insane length /
    undecodable body)."""

    __slots__ = ('path', 'frames', 'status', 'error', 'valid_bytes',
                 'size')

    def __init__(self, path, frames, status, error, valid_bytes,
                 size):
        self.path = path
        self.frames = frames
        self.status = status
        self.error = error
        self.valid_bytes = valid_bytes
        self.size = size


def scan_box(path: str) -> BoxScan:
    """Verify + decode one ring file; replay stops at the first
    invalid record (the WAL's scan discipline — persist.py
    ``_scan_segment``)."""
    with open(path, 'rb') as f:
        buf = f.read()
    size = len(buf)
    if not buf.startswith(MAGIC_BLACKBOX):
        return BoxScan(path, [], 'corrupt', 'bad magic', 0, size)
    off = len(MAGIC_BLACKBOX)
    frames: list[dict] = []
    status, error = 'ok', None
    while off < size:
        if off + _REC_HDR.size > size:
            status, error = 'torn', 'truncated frame header'
            break
        ln, crc = _REC_HDR.unpack_from(buf, off)
        if not 0 < ln <= MAX_FRAME:
            status, error = 'corrupt', 'insane frame length %d' % ln
            break
        if off + _REC_HDR.size + ln > size:
            status, error = 'torn', 'truncated frame body'
            break
        body = buf[off + _REC_HDR.size:off + _REC_HDR.size + ln]
        if _crc32c(body) != crc:
            status, error = 'crc', ('frame %d fails CRC32C'
                                    % (len(frames),))
            break
        try:
            frames.append(json.loads(body.decode('utf-8')))
        except (ValueError, UnicodeDecodeError) as e:
            status, error = 'corrupt', ('frame %d undecodable: %s'
                                        % (len(frames), e))
            break
        off += _REC_HDR.size + ln
    return BoxScan(path, frames, status, error, off, size)


def list_boxes(directory: str) -> list[str]:
    """Member ids with a ring in ``directory`` (current files only;
    ``read_box`` folds each member's rotated half in itself)."""
    try:
        names = os.listdir(directory)
    except (FileNotFoundError, NotADirectoryError):
        return []
    out = []
    for name in sorted(names):
        if name.startswith('blackbox.') and name.endswith('.log'):
            out.append(name[len('blackbox.'):-len('.log')])
    return out


def read_box(directory: str, member: str) -> dict:
    """One member's full ring — the rotated ``.old`` half (always
    cleanly written: rotation happens between frames, never mid-one)
    followed by the current file, whose torn tail is tolerated.
    Returns ``{'member', 'frames', 'files': [BoxScan...], 'status'}``
    where ``status`` is the worst file status ('ok' < 'torn' <
    'crc' < 'corrupt')."""
    frames: list[dict] = []
    files: list[BoxScan] = []
    rank = {'ok': 0, 'torn': 1, 'crc': 2, 'corrupt': 3}
    status = 'ok'
    cur = box_path(directory, member)
    for path in (cur + '.old', cur):
        if not os.path.exists(path):
            continue
        scan = scan_box(path)
        files.append(scan)
        frames.extend(scan.frames)
        # a tear in the ROTATED half is not a crash signature (that
        # file was sealed by a live process): grade it corrupt
        st = scan.status
        if path.endswith('.old') and st == 'torn':
            st = 'corrupt'
        if rank[st] > rank[status]:
            status = st
    return {'member': member, 'frames': frames, 'files': files,
            'status': status}


def harvest_spans(directory: str) -> dict[str, list[dict]]:
    """Lift every member ring found in ``directory`` back into
    ``merge_timelines``-ready form: ``{'member:<id>': [span dicts]}``.

    Consecutive frames snapshot overlapping ring tails, so spans are
    deduplicated by (span id, op, wall time); slow-op frames
    contribute their persisted causal chains too.  Unreadable or
    corrupt rings contribute what their valid prefix holds — the
    whole point is salvaging a dead member's last words."""
    out: dict[str, list[dict]] = {}
    for member in list_boxes(directory):
        box = read_box(directory, member)
        seen: set = set()
        spans: list[dict] = []
        for frame in box['frames']:
            for span in (frame.get('trace_tail') or []) \
                    + (frame.get('chain') or []):
                key = (span.get('span'), span.get('op'),
                       span.get('t_wall'))
                if key in seen:
                    continue
                seen.add(key)
                spans.append(span)
        if spans:
            out['member:%s' % (member,)] = spans
    return out


class BlackBoxRecorder:
    """The per-member flight recorder: builds frames on the loop,
    writes them on an executor thread (the WAL group-fsync pattern —
    one write in flight, later frames queue behind it), rotates at
    ``cap_bytes`` so disk stays bounded, and flushes one final frame
    synchronously on clean stop.

    ``server`` supplies the snapshots (``monitor_stats``, ``ledger``,
    ``trace``); ``collector`` (optional) supplies the FSM registry
    and receives the ``zookeeper_slow_op_ms`` histogram."""

    def __init__(self, directory: str, member: str = '0',
                 server=None, interval_ms: float | None = None,
                 cap_bytes: int = 4 * 1024 * 1024,
                 collector=None):
        self.dir = directory
        self.member = member
        self.server = server
        self.interval_ms = (blackbox_interval_ms()
                            if interval_ms is None else interval_ms)
        self.cap_bytes = cap_bytes
        self.path = box_path(directory, member)
        #: frames appended + bytes written since construction (the
        #: ``zk_blackbox_frames`` / ``zk_blackbox_bytes`` mntr rows)
        self.frames = 0
        self.bytes_written = 0
        #: spans that crossed the slow-op threshold (the
        #: ``zk_slow_ops_total`` mntr row)
        self.slow_ops = 0
        self._seq = 0
        self._file = None
        self._file_bytes = 0
        self._loop = None
        self._handle = None
        self._inflight = False
        #: the frames the executor write in flight carries: taken by
        #: that write or by stop(), whichever holds ``_lock`` first,
        #: so none lands after the final frame
        self._inflight_blob = b''
        self._lock = threading.Lock()
        self._pending: list[bytes] = []
        self._closed = False
        self._hist = None
        if collector is not None:
            try:
                self._hist = collector.histogram(
                    METRIC_SLOW_OP_MS,
                    'Duration of ops/txn stages that crossed the '
                    'slow-op threshold (sub-threshold ops never '
                    'observe here)', buckets=SLOW_OP_BUCKETS)
            except ValueError:
                pass                  # shared collector, already bound

    # -- file plumbing ------------------------------------------------

    def _ensure_file(self) -> None:
        if self._file is not None:
            return
        os.makedirs(self.dir, exist_ok=True)
        self._file = open(self.path, 'ab')
        if self._file.tell() == 0:
            self._file.write(MAGIC_BLACKBOX)
            self._file.flush()
        self._file_bytes = self._file.tell()

    def _maybe_rotate(self) -> None:
        """Flip the ring: the current file becomes ``.old`` (replacing
        any previous one) and a fresh file starts — between frames
        only, and never while an executor write is in flight."""
        if self._file_bytes < self.cap_bytes or self._inflight:
            return
        self._file.close()
        self._file = None
        os.replace(self.path, self.path + '.old')
        self._ensure_file()

    def _write_sync(self, blob: bytes) -> None:
        """Blocking write + fsync — executor threads and the
        (sync) stop path only; never the loop."""
        self._ensure_file()
        self._file.write(blob)
        self._file.flush()
        os.fsync(self._file.fileno())
        self._file_bytes += len(blob)
        self.bytes_written += len(blob)

    def _dispatch(self) -> None:
        """Ship the queued frames to the executor (one write in
        flight at a time, like the WAL's group sync)."""
        if self._inflight or self._closed or not self._pending:
            return
        self._inflight_blob = b''.join(self._pending)
        self._pending.clear()
        self._inflight = True

        def done(fut) -> None:
            self._inflight = False
            try:
                fut.result()
            except OSError:
                pass                  # telemetry: never take the
                # member down over its own black box
            if not self._closed:
                self._maybe_rotate()
                self._dispatch()      # frames queued meanwhile

        self._loop.run_in_executor(
            None, self._write_inflight).add_done_callback(done)

    def _write_inflight(self) -> None:
        """The executor's half of :meth:`_dispatch`: write the frames in
        flight, unless stop() already wrote them ahead of its final
        frame."""
        with self._lock:
            blob, self._inflight_blob = self._inflight_blob, b''
            if blob:
                self._write_sync(blob)

    def _append(self, body: dict) -> None:
        if self._closed and self._loop is not None:
            # stop() sealed the box with its final frame; a span that
            # settles after it (a WAL's last group fsync) stays out
            return
        rec = encode_frame(body)
        self.frames += 1
        self._seq += 1
        if self._loop is not None:
            self._pending.append(rec)
            self._dispatch()
        else:
            # no loop (offline/unit use): inline
            self._write_sync(rec)
            self._maybe_rotate()

    # -- frame content ------------------------------------------------

    def _snapshot(self, kind: str) -> dict:
        srv = self.server
        body: dict = {
            'blackbox_schema': BLACKBOX_SCHEMA,
            'kind': kind,
            'member': self.member,
            'seq': self._seq,
            't_wall': round(time.time(), 6),
        }
        if srv is None:
            return body
        try:
            body['mntr'] = {k: v for k, v in srv.monitor_stats()}
        except Exception as e:        # a half-torn-down server must
            body['mntr_error'] = repr(e)   # not lose the frame
        ledger = getattr(srv, 'ledger', None)
        if ledger is not None:
            phases = {}
            for phase in type(ledger).PHASES:
                p99 = ledger.phase_p99(phase)
                if p99 is not None:
                    phases[phase] = round(p99, 4)
            body['phases'] = phases
            body['ticks'] = ledger.ticks
        collector = getattr(srv, 'collector', None)
        registry = getattr(collector, '_fsm_registry', None)
        if registry is not None:
            from .fsm import _fsm_state_counts
            body['fsm'] = {
                ','.join('%s=%s' % kv for kv in key): n
                for key, n in _fsm_state_counts(registry).items()}
        trace = getattr(srv, 'trace', None)
        if trace is not None:
            body['trace_dropped'] = trace.dropped
            body['trace_tail'] = trace.dump()[-TRACE_TAIL:]
        return body

    # -- public surface -----------------------------------------------

    def start(self, loop) -> None:
        """Arm the cadence on ``loop``; idempotent (restart re-arms
        a recorder its server's stop() closed)."""
        self._loop = loop
        self._closed = False
        self._ensure_file()
        if self._handle is None:
            self._schedule()

    def _schedule(self) -> None:
        self._handle = self._loop.call_later(
            self.interval_ms / 1000.0, self._tick)

    def _tick(self) -> None:
        self._handle = None
        if self._closed:
            return
        self._append(self._snapshot('periodic'))
        self._schedule()

    def capture(self, kind: str = 'periodic') -> None:
        """Record one frame now (out of cadence)."""
        self._append(self._snapshot(kind))

    def slow_span(self, span) -> None:
        """The span ring's slow-op hook (utils/trace.py
        ``TraceRing.on_slow``): persist the offending span's whole
        zxid-keyed causal chain as a ``slow_op`` frame and count it.
        Counting is loop-side; the write rides the executor queue."""
        self.slow_ops += 1
        if self._hist is not None and span.duration_ms is not None:
            self._hist.observe(span.duration_ms)
        body = self._snapshot('slow_op')
        body['slow'] = span.to_dict()
        trace = getattr(self.server, 'trace', None)
        if trace is not None and span.zxid is not None:
            body['chain'] = [s.to_dict() for s in trace.spans()
                             if s.zxid == span.zxid]
        else:
            body['chain'] = [span.to_dict()]
        self._append(body)

    def stop(self, final: bool = True) -> None:
        """Disarm the cadence, drain queued frames, flush one final
        frame synchronously (fsynced — the very thing a post-mortem
        reads first), and close the file.  Clean-stop only; a SIGKILL
        leaves whatever the executor had durably written, torn tail
        included — which scan_box tolerates by design."""
        if self._handle is not None:
            self._handle.cancel()
            self._handle = None
        if self._closed:
            return
        self._closed = True
        with self._lock:
            blob = self._inflight_blob + b''.join(self._pending)
            self._inflight_blob = b''
            self._pending.clear()
            if final:
                blob += encode_frame(self._snapshot('final'))
                self.frames += 1
                self._seq += 1
            if blob:
                try:
                    self._write_sync(blob)
                except OSError:
                    pass
            if self._file is not None:
                self._file.close()
                self._file = None
