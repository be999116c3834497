"""The durability plane: write-ahead log, fuzzy snapshots, recovery.

Every byte of ensemble state used to be RAM: ``NodeTree.snapshot()``
existed only to bootstrap late-joining replicas, and a killed member
recovered solely by resyncing from a *live* leader — kill the whole
ensemble and every acked write was gone.  This module adds the disk
half of real ZooKeeper's guarantee: a length-prefixed, CRC32C-framed
**write-ahead log** of committed transactions, **fuzzy snapshots** of
the znode tree stamped with their log position, and **recovery** that
loads the newest valid snapshot and replays the log tail — tolerating
a torn final record, the normal signature of dying mid-write.

Group commit (the fsync policy) reuses the shape the outbound plane
proved out (io/sendplane.py, PROFILE.md "Encode side"): one fsync per
busy event-loop tick instead of one per append, with an ordering
barrier so durability still *precedes* every ack:

- ``sync='always'`` — flush + fsync on every append (one syscall pair
  per committed txn; the strict, slow policy);
- ``sync='tick'`` (default) — appends of one event-loop iteration
  share ONE group fsync that runs on an executor thread (real ZK's
  sync-thread shape: the loop keeps serving reads and later writes
  while the device syncs), and the server send-plane carries the WAL
  as its ``barrier``: corked acks stay corked — still in order —
  until the fsync covering their txns completes, so **no ack byte
  reaches the transport before its txn is on disk** while the loop
  never blocks on the device;
- ``sync='never'`` — OS-buffered only (bench baseline / explicit
  opt-out; a crash may lose acked writes, the guarantee matrix in
  README "Durability" says so).

Snapshots are *fuzzy* in the ZooKeeper sense: applies continue while
the image is persisted.  The stamp (``next log index``, ``tree.zxid``)
and the pickle of the node map are captured synchronously in one tick
— so replay needs no idempotence — and the file write + fsync +
atomic rename happen off the hot path; segment truncation is anchored
to the newest *durable* snapshot only.  Record bodies ride the jute
primitive codec (`protocol/jute.py`) as the validating spec tier with
a single-pass struct-packed fast tier in front, mirroring
``protocol/fastencode.py``; the two are A/B-tested byte-identical
(tests/test_torch_wal.py).

Wire format, one record: ``>I length | >I crc32c(body) | body``.
Records use CRC32C (Castagnoli — the checksum real ZK's and most
storage formats' tooling expects); snapshot payloads, megabytes not
tens of bytes, are covered by zlib.crc32 for C-speed — the goal there
is bit-flip detection, and a pure-Python CRC32C over a large tree
would cost more than the pickle itself.

Knobs: ``ZKServer(durability=, wal_dir=)``, ``ZKSTREAM_WAL_DIR``
(ambient default dir), ``ZKSTREAM_NO_WAL=1`` (global kill switch).
The ``wal DIR`` CLI verb dumps/verifies a log directory (the format is
the JAX package's, byte for byte).
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import os
import pickle
import struct
import time
import zlib

from ..protocol.jute import JuteReader, JuteWriter
from ..protocol.records import ACL, Id
from ..utils.aio import ambient_loop

log = logging.getLogger('zkstream_tpu_torch.server.persist')

# ---------------------------------------------------------------------
# CRC32C (Castagnoli), software table.  Small-record checksumming only;
# snapshot payloads use zlib.crc32 (see module docstring).
# ---------------------------------------------------------------------

_CRC32C_POLY = 0x82F63B78


def _crc32c_table() -> tuple:
    out = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _CRC32C_POLY if c & 1 else c >> 1
        out.append(c)
    return tuple(out)


_CRC_TABLE = _crc32c_table()


def software_crc32c(data: bytes, crc: int = 0) -> int:
    """The spec tier: pure-Python table walk (always present).
    Known-answer: ``crc32c(b'123456789') == 0xE3069283``."""
    c = crc ^ 0xFFFFFFFF
    tbl = _CRC_TABLE
    for b in data:
        c = tbl[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


_crc_impl = None


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32C over ``data`` (standard reflected form; chainable via
    ``crc``).  Tiered like the wire codec: the C extension's
    table walk when built (~60x — it checksums every appended record
    on the commit hot path), the Python spec otherwise; A/B-tested
    equal in tests/test_torch_wal.py.  The binding resolves once, at first
    use, through the same already-built-artifact rule the frame
    scanner uses (utils/native.get_ext — never a blocking build)."""
    global _crc_impl
    if _crc_impl is None:
        impl = software_crc32c
        try:
            from ..utils import native
            ext = native.get_ext()
            if ext is not None and hasattr(ext, 'crc32c'):
                impl = ext.crc32c
        except Exception:  # pragma: no cover - packaging-broken ext
            pass
        _crc_impl = impl
    return _crc_impl(data, crc)


# ---------------------------------------------------------------------
# Txn record body codec: fast single-pass tier + jute spec tier.
# ---------------------------------------------------------------------

#: Tag 4 ('epoch') is a *control* record — a leadership-epoch bump
#: (server/election.py), logged for recovery but never applied to the
#: tree and never entered into the replication log.  Tags 5/6
#: ('session' / 'session_close') are the durable-session records:
#: session lifecycle rides the WAL (and the replication log — a
#: follower's mirror must carry the table for failover) but never
#: touches the tree; they carry the zxid CURRENT at the edge, consume
#: none, and recovery filters them by log index, not zxid.  Tag 7
#: ('multi') is one all-or-nothing transaction: every sub-entry in
#: ONE CRC-framed record, so a torn multi replays atomically or not
#: at all.  Tag 8 ('reconfig') is the membership CONTROL record
#: (server/store.py ``propose_reconfig``/``commit_reconfig``): a
#: config change rides the WAL and the replication log — phase
#: 'joint' installs C_old+C_new (quorum-commit and elections need
#: majorities of BOTH voter sets), phase 'final' commits C_new alone
#: — it consumes a zxid (the joint window is bounded by sequenced,
#: committed records), and recovery filters it by LOG INDEX like the
#: session records, so an in-progress reconfig survives a
#: full-ensemble SIGKILL and the promoted successor can finish it.
_TAGS = {'create': 1, 'delete': 2, 'set_data': 3, 'epoch': 4,
         'session': 5, 'session_close': 6, 'multi': 7, 'reconfig': 8}
_OPS = {v: k for k, v in _TAGS.items()}

#: ('reconfig', version, phase, old_voters, new_voters, observers,
#: zxid) phase byte values.
_RECONFIG_PHASES = {'joint': 0, 'final': 1}
_RECONFIG_NAMES = {v: k for k, v in _RECONFIG_PHASES.items()}

#: ('session_close', sid, zxid, reason) reason byte values.
_CLOSE_REASONS = {'close': 0, 'expire': 1}
_CLOSE_NAMES = {v: k for k, v in _CLOSE_REASONS.items()}

_REC_HDR = struct.Struct('>II')       # length, crc32c(body)
_I = struct.Struct('>i')
_Q3 = struct.Struct('>qqq')
_Q2 = struct.Struct('>qq')

#: Sanity cap on one record body (a txn's data is bounded by the wire
#: MAX_PACKET of 16 MiB; anything bigger is corruption, not data).
MAX_RECORD = 64 * 1024 * 1024

MAGIC_SEGMENT = b'ZKSWAL1\n'
#: Snapshot format 3 puts the SESSION TABLE into the image (payload
#: becomes ``{'nodes': ..., 'sessions': {sid: (passwd, timeout)}}``)
#: so ephemerals survive a full-ensemble restart inside the session
#: timeout.  Format 2 added the leadership epoch to the stamp (a
#: snapshot that anchors truncation may be the only survivor of the
#: epoch record it covers).  OLDER FORMATS STAY READABLE (epoch 0 /
#: empty session table): truncation may already have deleted the
#: segments under an existing snapshot, so rejecting it would orphan
#: the acked writes it covers.
MAGIC_SNAPSHOT = b'ZKSSNP3\n'
MAGIC_SNAPSHOT_V2 = b'ZKSSNP2\n'
MAGIC_SNAPSHOT_V1 = b'ZKSSNP1\n'
_SNAP_HDR = struct.Struct('>QQQI')    # index, zxid, epoch, crc32(payload)
_SNAP_HDR_V1 = struct.Struct('>QQI')  # index, zxid, crc32(payload)


def entry_zxid(entry: tuple) -> int:
    """The zxid a commit-log entry was sequenced at (store.py shapes:
    create[5], delete[2], set_data[3]; epoch and session control
    records carry the zxid current at the edge — they consume no zxid
    themselves; a multi is positioned at its LAST sub-entry's zxid)."""
    op = entry[0]
    if op == 'create':
        return entry[5]
    if op == 'delete':
        return entry[2]
    if op == 'set_data':
        return entry[3]
    if op in ('epoch', 'session_close'):
        return entry[2]
    if op == 'session':
        return entry[4]
    if op == 'reconfig':
        return entry[6]
    if op == 'multi':
        return entry_zxid(entry[1][-1])
    raise ValueError('unknown log entry %r' % (op,))


def _spec_encode_entry(entry: tuple) -> bytes:
    """The validating spec tier: jute primitives, field by field —
    exactly what the fast tier below must reproduce byte for byte."""
    w = JuteWriter()
    op = entry[0]
    w.write_byte(_TAGS[op])
    if op == 'epoch':
        _, epoch, zxid = entry
        w.write_long(epoch)
        w.write_long(zxid)
        return w.to_bytes()
    if op == 'session':
        _, sid, passwd, timeout, zxid = entry
        w.write_long(sid)
        w.write_buffer(passwd)
        w.write_int(timeout)
        w.write_long(zxid)
        return w.to_bytes()
    if op == 'session_close':
        _, sid, zxid, reason = entry
        w.write_long(sid)
        w.write_long(zxid)
        w.write_byte(_CLOSE_REASONS[reason])
        return w.to_bytes()
    if op == 'reconfig':
        _, version, phase, old_voters, new_voters, observers, \
            zxid = entry
        w.write_long(version)
        w.write_byte(_RECONFIG_PHASES[phase])
        for members in (old_voters, new_voters, observers):
            w.write_int(len(members))
            for m in members:
                w.write_int(m)
        w.write_long(zxid)
        return w.to_bytes()
    if op == 'multi':
        subs = entry[1]
        w.write_int(len(subs))
        for sub in subs:
            w.write_buffer(_spec_encode_entry(sub))
        return w.to_bytes()
    if op == 'create':
        _, path, data, acl, eph_owner, zxid, now = entry
        w.write_ustring(path)
        w.write_buffer(data)
        w.write_int(len(acl))
        for a in acl:
            w.write_int(int(a.perms))
            w.write_ustring(a.id.scheme)
            w.write_ustring(a.id.id)
        w.write_long(eph_owner)
        w.write_long(zxid)
        w.write_long(now)
    elif op == 'delete':
        _, path, zxid = entry
        w.write_ustring(path)
        w.write_long(zxid)
    else:
        assert op == 'set_data', op
        _, path, data, zxid, now = entry
        w.write_ustring(path)
        w.write_buffer(data)
        w.write_long(zxid)
        w.write_long(now)
    return w.to_bytes()


def _buf(data: bytes) -> bytes:
    """Jute buffer: length prefix (-1 for empty — the wire quirk the
    spec tier inherits from protocol/jute.py)."""
    if not data:
        return b'\xff\xff\xff\xff'
    return _I.pack(len(data)) + data


def encode_entry(entry: tuple) -> bytes:
    """Single-pass fast tier (the fastencode idiom: batched
    ``struct.pack`` + join); byte-identical to the spec tier by test."""
    op = entry[0]
    if op == 'set_data':
        _, path, data, zxid, now = entry
        p = path.encode('utf-8')
        return b''.join((b'\x03', _I.pack(len(p)), p, _buf(data),
                         _Q2.pack(zxid, now)))
    if op == 'epoch':
        return b'\x04' + _Q2.pack(entry[1], entry[2])
    if op == 'session':
        _, sid, passwd, timeout, zxid = entry
        return b''.join((b'\x05', struct.pack('>q', sid),
                         _buf(passwd), _I.pack(timeout),
                         struct.pack('>q', zxid)))
    if op == 'session_close':
        _, sid, zxid, reason = entry
        return (b'\x06' + _Q2.pack(sid, zxid)
                + bytes((_CLOSE_REASONS[reason],)))
    if op == 'reconfig':
        _, version, phase, old_voters, new_voters, observers, \
            zxid = entry
        parts = [b'\x08', struct.pack('>q', version),
                 bytes((_RECONFIG_PHASES[phase],))]
        for members in (old_voters, new_voters, observers):
            parts.append(_I.pack(len(members)))
            parts.extend(_I.pack(m) for m in members)
        parts.append(struct.pack('>q', zxid))
        return b''.join(parts)
    if op == 'multi':
        subs = entry[1]
        parts = [b'\x07', _I.pack(len(subs))]
        for sub in subs:
            body = encode_entry(sub)
            parts.append(_I.pack(len(body)))
            parts.append(body)
        return b''.join(parts)
    if op == 'create':
        _, path, data, acl, eph_owner, zxid, now = entry
        p = path.encode('utf-8')
        parts = [b'\x01', _I.pack(len(p)), p, _buf(data),
                 _I.pack(len(acl))]
        for a in acl:
            s = a.id.scheme.encode('utf-8')
            i = a.id.id.encode('utf-8')
            parts.append(_I.pack(int(a.perms)))
            parts.append(_buf(s))
            parts.append(_buf(i))
        parts.append(_Q3.pack(eph_owner, zxid, now))
        return b''.join(parts)
    if op == 'delete':
        _, path, zxid = entry
        p = path.encode('utf-8')
        return b''.join((b'\x02', _I.pack(len(p)), p,
                         struct.pack('>q', zxid)))
    raise ValueError('unknown log entry %r' % (op,))


def decode_entry(body: bytes) -> tuple:
    """Decode one record body back to the store.py entry tuple."""
    r = JuteReader(body)
    tag = r.read_byte()
    op = _OPS.get(tag)
    if op is None:
        raise ValueError('unknown WAL record tag %d' % (tag,))
    if op == 'create':
        path = r.read_ustring()
        data = bytes(r.read_buffer())
        n = r.read_int()
        # bounded by what can physically fit (an empty ACL encodes to
        # 12 bytes) — never by an arbitrary cap tighter than what the
        # write path accepts, or a legitimately-acked record would
        # poison its own recovery
        if not 0 <= n <= len(body) // 12:
            raise ValueError('insane ACL count %d' % (n,))
        acl = tuple(
            ACL(_perm(r.read_int()),
                Id(r.read_ustring(), r.read_ustring()))
            for _ in range(n))
        eph_owner = r.read_long()
        zxid = r.read_long()
        now = r.read_long()
        return ('create', path, data, acl, eph_owner, zxid, now)
    if op == 'delete':
        return ('delete', r.read_ustring(), r.read_long())
    if op == 'epoch':
        return ('epoch', r.read_long(), r.read_long())
    if op == 'session':
        return ('session', r.read_long(), bytes(r.read_buffer()),
                r.read_int(), r.read_long())
    if op == 'session_close':
        sid, zxid = r.read_long(), r.read_long()
        reason = _CLOSE_NAMES.get(r.read_byte())
        if reason is None:
            raise ValueError('unknown session-close reason')
        return ('session_close', sid, zxid, reason)
    if op == 'reconfig':
        version = r.read_long()
        phase = _RECONFIG_NAMES.get(r.read_byte())
        if phase is None:
            raise ValueError('unknown reconfig phase')
        sets = []
        for _ in range(3):
            n = r.read_int()
            # bounded by what can physically fit (4 bytes per member)
            if not 0 <= n <= len(body) // 4:
                raise ValueError('insane member count %d' % (n,))
            sets.append(tuple(r.read_int() for _ in range(n)))
        return ('reconfig', version, phase, sets[0], sets[1],
                sets[2], r.read_long())
    if op == 'multi':
        n = r.read_int()
        # bounded by what can physically fit (a sub-record is at least
        # its 4-byte length prefix + 1-byte tag)
        if not 0 < n <= len(body) // 5:
            raise ValueError('insane multi sub-count %d' % (n,))
        subs = []
        for _ in range(n):
            sub = decode_entry(bytes(r.read_buffer()))
            if sub[0] not in ('create', 'delete', 'set_data'):
                raise ValueError('control record inside a multi')
            subs.append(sub)
        return ('multi', tuple(subs))
    return ('set_data', r.read_ustring(), bytes(r.read_buffer()),
            r.read_long(), r.read_long())


def _perm(v: int):
    from ..protocol.consts import Perm
    return Perm(v)


# ---------------------------------------------------------------------
# Directory scan: segments + snapshots (shared by recovery and the
# ``wal`` CLI subcommand, so the two can never disagree on validity).
# ---------------------------------------------------------------------


@dataclasses.dataclass
class SegmentInfo:
    path: str
    start_index: int
    #: decoded (index, entry) pairs up to the first invalid record
    records: list
    #: byte offset of the first invalid record (== file size when the
    #: whole segment is valid) — the truncation point a reopening WAL
    #: cuts the file back to
    valid_bytes: int
    size: int
    #: 'ok' | 'torn' (truncated tail: short header/body) |
    #: 'crc' (checksum mismatch) | 'corrupt' (bad magic/length/decode)
    status: str
    error: str | None = None

    @property
    def end_index(self) -> int:
        return self.start_index + len(self.records)


@dataclasses.dataclass
class SnapshotInfo:
    path: str
    index: int
    zxid: int
    valid: bool
    nodes: dict | None = None
    error: str | None = None
    #: leadership epoch at capture (format 2 stamp)
    epoch: int = 0
    #: live sessions at capture, {sid: (passwd, timeout)} (format 3
    #: payload; empty for older images)
    sessions: dict = dataclasses.field(default_factory=dict)
    #: membership config at capture (format 3 payload 'config' key;
    #: None for older images or never-reconfigured ensembles)
    config: dict | None = None


@dataclasses.dataclass
class WalScan:
    dir: str
    segments: list          # SegmentInfo, by start_index
    snapshots: list         # SnapshotInfo, by index (valid and not)

    def newest_valid_snapshot(self) -> SnapshotInfo | None:
        for s in reversed(self.snapshots):
            if s.valid:
                return s
        return None


def _scan_segment(path: str, start_index: int,
                  with_entries: bool = True) -> SegmentInfo:
    with open(path, 'rb') as f:
        buf = f.read()
    size = len(buf)
    if not buf.startswith(MAGIC_SEGMENT):
        return SegmentInfo(path, start_index, [], 0, size, 'corrupt',
                           'bad segment magic')
    off = len(MAGIC_SEGMENT)
    records: list = []
    status, error = 'ok', None
    idx = start_index
    while off < size:
        if off + _REC_HDR.size > size:
            status, error = 'torn', 'truncated record header'
            break
        ln, crc = _REC_HDR.unpack_from(buf, off)
        if not 0 < ln <= MAX_RECORD:
            status, error = 'corrupt', 'insane record length %d' % ln
            break
        if off + _REC_HDR.size + ln > size:
            status, error = 'torn', 'truncated record body'
            break
        body = buf[off + _REC_HDR.size:off + _REC_HDR.size + ln]
        if crc32c(body) != crc:
            status, error = 'crc', ('record %d fails CRC32C' % (idx,))
            break
        try:
            entry = decode_entry(body) if with_entries else None
        except Exception as e:
            status, error = 'corrupt', ('record %d undecodable: %s'
                                        % (idx, e))
            break
        records.append((idx, entry))
        off += _REC_HDR.size + ln
        idx += 1
    return SegmentInfo(path, start_index, records, off, size, status,
                       error)


def _read_snapshot(path: str, load_nodes: bool = True) -> SnapshotInfo:
    name = os.path.basename(path)
    try:
        with open(path, 'rb') as f:
            buf = f.read()
        dict_payload = False
        if buf.startswith(MAGIC_SNAPSHOT):
            index, zxid, epoch, crc = _SNAP_HDR.unpack_from(
                buf, len(MAGIC_SNAPSHOT))
            body_off = len(MAGIC_SNAPSHOT) + _SNAP_HDR.size
            dict_payload = True       # {'nodes', 'sessions'}
        elif buf.startswith(MAGIC_SNAPSHOT_V2):
            index, zxid, epoch, crc = _SNAP_HDR.unpack_from(
                buf, len(MAGIC_SNAPSHOT_V2))
            body_off = len(MAGIC_SNAPSHOT_V2) + _SNAP_HDR.size
        elif buf.startswith(MAGIC_SNAPSHOT_V1):
            # pre-election format: no epoch in the stamp
            index, zxid, crc = _SNAP_HDR_V1.unpack_from(
                buf, len(MAGIC_SNAPSHOT_V1))
            epoch = 0
            body_off = len(MAGIC_SNAPSHOT_V1) + _SNAP_HDR_V1.size
        else:
            raise ValueError('bad snapshot magic')
        payload = buf[body_off:]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            raise ValueError('snapshot payload fails CRC')
        nodes, sessions, config = None, {}, None
        if load_nodes:
            image = pickle.loads(payload)
            if dict_payload:
                nodes = image['nodes']
                sessions = image.get('sessions', {})
                config = image.get('config')
            else:
                nodes = image
            if '/' not in nodes:
                raise ValueError('snapshot image has no root')
        return SnapshotInfo(path, index, zxid, True, nodes,
                            epoch=epoch, sessions=sessions,
                            config=config)
    except Exception as e:
        # parse the stamp out of the filename so the CLI can still
        # list the corrupt file next to its intended position
        idx = -1
        parts = name.split('.')
        if len(parts) >= 2 and parts[1].isdigit():
            idx = int(parts[1])
        return SnapshotInfo(path, idx, -1, False, None, str(e))


def scan_dir(path: str, with_entries: bool = True,
             load_snapshots: bool = True) -> WalScan:
    """Inventory a WAL directory.  Never mutates it — reopening for
    writes (``WriteAheadLog``) is what truncates a torn tail.

    Co-tenancy contract: only the ``wal.``/``snap.`` prefixes belong
    to this module.  The black-box flight recorder
    (utils/blackbox.py) keeps its ``blackbox.<member>.log`` rings in
    the same directory, invisible to this scan and to
    :func:`reset_dir` — a member's telemetry must survive its own
    snapshot bootstrap."""
    segments, snapshots = [], []
    try:
        names = sorted(os.listdir(path))
    except FileNotFoundError:
        names = []
    for name in names:
        full = os.path.join(path, name)
        if name.endswith('.tmp'):
            continue                  # in-flight snapshot: not durable
        if name.startswith('wal.') and name.endswith('.log'):
            try:
                start = int(name.split('.')[1])
            except (IndexError, ValueError):
                continue
            segments.append(_scan_segment(full, start,
                                          with_entries=with_entries))
        elif name.startswith('snap.'):
            snapshots.append(_read_snapshot(full,
                                            load_nodes=load_snapshots))
    segments.sort(key=lambda s: s.start_index)
    snapshots.sort(key=lambda s: s.index)
    return WalScan(path, segments, snapshots)


@dataclasses.dataclass
class Recovery:
    """What recovery reconstructed from disk."""

    nodes: dict             # full node map (root included)
    zxid: int
    last_index: int         # next append slot (one past newest entry)
    snapshot_index: int     # -1 when no snapshot was used
    snapshot_zxid: int
    replayed: int           # log entries applied on top of the image
    torn: bool              # a torn/invalid tail was tolerated
    detail: str = ''
    #: newest leadership epoch on disk (snapshot stamp or epoch
    #: control records, whichever is higher) — what a recovered
    #: member votes with (server/election.py)
    epoch: int = 0
    #: sessions alive at the crash, {sid: (passwd, timeout)} — the
    #: snapshot's table plus the session control records replayed by
    #: log index; :func:`restore_sessions` re-arms them with a fresh
    #: expiry clock so ephemerals survive a restart inside the
    #: session timeout
    sessions: dict = dataclasses.field(default_factory=dict)
    #: newest membership config on disk (snapshot 'config' key plus
    #: reconfig control records replayed by log index) — a dict
    #: ``{'version', 'phase', 'voters', 'old_voters', 'observers'}``,
    #: or None when this ensemble was never reconfigured.  A
    #: recovered ``phase == 'joint'`` is an IN-PROGRESS reconfig: the
    #: member promoted over this WAL must finish it (commit the final
    #: record) before the joint window can close.
    config: dict | None = None


def recover_state(path: str, trace=None) -> Recovery:
    """Load the newest valid snapshot, replay the log tail, tolerate a
    torn final record.  Replay stops at the first invalid record and
    ignores later segments (bytes after a tear are unordered garbage).

    ``trace`` (a utils/trace.TraceRing) gets a ``WAL_RECOVER`` span so
    campaign dumps show recovery next to the ops around it."""
    from .store import NodeTree, Znode

    t0 = time.monotonic()
    scan = scan_dir(path)
    snap = scan.newest_valid_snapshot()
    tree = NodeTree()
    if snap is not None:
        tree.install({'zxid': snap.zxid, 'nodes': snap.nodes})
    base_zxid = tree.zxid
    base_index = snap.index if snap is not None else 0
    epoch = snap.epoch if snap is not None else 0
    sessions = dict(snap.sessions) if snap is not None else {}
    config = (dict(snap.config)
              if snap is not None and snap.config else None)
    replayed = 0
    torn = False
    last_index = base_index
    for n, seg in enumerate(scan.segments):
        if seg.end_index <= base_index and seg.status == 'ok':
            last_index = max(last_index, seg.end_index)
            continue                   # fully under the snapshot
        nxt = (scan.segments[n + 1].start_index
               if n + 1 < len(scan.segments) else None)
        if nxt is not None and nxt <= base_index:
            # even a corrupt segment is irrelevant when its whole
            # intended range [start, next segment's start) is inside
            # the snapshot image — do not let it stop the replay of
            # newer, valid segments
            last_index = max(last_index, nxt)
            continue
        for idx, entry in seg.records:
            if entry[0] == 'epoch':
                # control record: adopt the epoch (zxid filter does
                # not apply — a bump consumes no zxid), never applied
                # to the tree
                epoch = max(epoch, entry[1])
                last_index = max(last_index, idx + 1)
                continue
            if entry[0] == 'reconfig':
                # membership control record: filtered by LOG INDEX
                # like the session records (the snapshot's 'config'
                # key covers everything before its stamp)
                if idx >= base_index:
                    _, ver, phase, old_v, new_v, obs, _z = entry
                    config = {'version': ver, 'phase': phase,
                              'voters': tuple(new_v),
                              'old_voters': (tuple(old_v)
                                             if phase == 'joint'
                                             else None),
                              'observers': tuple(obs)}
                last_index = max(last_index, idx + 1)
                continue
            if entry[0] in ('session', 'session_close'):
                # session control records carry the zxid current at
                # the edge, so the zxid filter cannot place them:
                # filter by LOG INDEX against the snapshot stamp (the
                # image's session table covers everything before it)
                if idx >= base_index:
                    if entry[0] == 'session':
                        sessions[entry[1]] = (entry[2], entry[3])
                    else:
                        sessions.pop(entry[1], None)
                last_index = max(last_index, idx + 1)
                continue
            if entry_zxid(entry) <= base_zxid:
                last_index = max(last_index, idx + 1)
                continue               # covered by the image
            tree.apply_entry(entry)
            _restore_seq(tree, entry)
            replayed += 1
            last_index = max(last_index, idx + 1)
        if seg.status != 'ok':
            torn = True
            break                      # nothing after a tear is usable
    if snap is None and not scan.segments:
        tree.nodes.setdefault('/', Znode())
    detail = ('snapshot idx=%d zxid=%d + %d replayed%s'
              % (base_index, base_zxid, replayed,
                 ' (torn tail tolerated)' if torn else '')
              if snap is not None else
              '%d replayed from empty tree%s'
              % (replayed, ' (torn tail tolerated)' if torn else ''))
    rec = Recovery(nodes=tree.nodes, zxid=tree.zxid,
                   last_index=last_index,
                   snapshot_index=snap.index if snap else -1,
                   snapshot_zxid=snap.zxid if snap else 0,
                   replayed=replayed, torn=torn, detail=detail,
                   epoch=epoch, sessions=sessions, config=config)
    if trace is not None:
        trace.note('WAL_RECOVER', path=path, zxid=rec.zxid,
                   kind='recovery',
                   duration_ms=round((time.monotonic() - t0) * 1e3, 3))
    log.info('recovered %s: %s -> zxid %d', path, detail, rec.zxid)
    return rec


def _advance_seq(tree, path: str) -> None:
    """Advance the parent's sequential counter past ``path``'s
    10-digit suffix (when it has one).  The ONE copy of the
    heuristic — replay recovery and leader promotion both use it; it
    can only over-advance a counter (a user node that merely looks
    sequential skips numbers — harmless), never reuse one."""
    name = path.rsplit('/', 1)[-1]
    if len(name) > 10 and name[-10:].isdigit():
        from .store import parent_path
        parent = tree.nodes.get(parent_path(path))
        if parent is not None:
            parent.seq = max(parent.seq, int(name[-10:]) + 1)


def _restore_seq(tree, entry) -> None:
    """Leader-side sequential counters are resolved *before* a create
    is logged, so replay must re-derive them: a recovered leader whose
    parent.seq lagged would hand out an already-used number."""
    if entry[0] == 'create':
        _advance_seq(tree, entry[1])
    elif entry[0] == 'multi':
        for sub in entry[1]:
            _restore_seq(tree, sub)


# ---------------------------------------------------------------------
# The log itself.
# ---------------------------------------------------------------------

METRIC_FSYNC = 'zookeeper_fsync_latency_ms'
METRIC_APPEND_BYTES = 'zkstream_wal_append_bytes'

FSYNC_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
                 50.0, 100.0, 250.0)
APPEND_BUCKETS = (32, 64, 128, 256, 512, 1024, 4096, 16384, 65536)

DEFAULT_SEGMENT_BYTES = 4 * 1024 * 1024
DEFAULT_SEGMENT_AGE_S = 300.0
SYNC_POLICIES = ('always', 'tick', 'never')
#: Fast-device short-circuit: when the EWMA of measured device sync
#: latency sits under this, the tick group fsync runs inline instead
#: of on the executor — on tmpfs-class devices (~10 us) the thread
#: handoff + completion callback cost more than the fsync itself,
#: while on a real disk (100s of us and up) overlapping the loop wins.
FAST_SYNC_MS = 0.15
#: Snapshot fallback depth: how many older snapshots survive a new one.
KEEP_SNAPSHOTS = 2


def wal_enabled() -> bool:
    """Global kill switch (mirrors the cork's ``ZKSTREAM_NO_CORK``)."""
    return os.environ.get('ZKSTREAM_NO_WAL') != '1'


def default_wal_dir() -> str | None:
    """The ambient WAL directory, if any (``ZKSTREAM_WAL_DIR``)."""
    return os.environ.get('ZKSTREAM_WAL_DIR') or None


class WriteAheadLog:
    """One directory of CRC32C-framed segments plus snapshots.

    Opening an existing directory continues it: the scan finds the
    newest index, a torn tail (the signature of a crash mid-write) is
    truncated back to the last whole record, and appends resume from
    there.  ``bind(tree)`` attaches the tree snapshots are taken of.
    """

    def __init__(self, path: str, *, sync: str = 'tick',
                 segment_bytes: int = DEFAULT_SEGMENT_BYTES,
                 segment_age_s: float = DEFAULT_SEGMENT_AGE_S,
                 collector=None, faults=None):
        assert sync in SYNC_POLICIES, sync
        self.dir = path
        self.sync = sync
        self.segment_bytes = segment_bytes
        self.segment_age_s = segment_age_s
        #: Optional seeded FaultInjector (io/faults.py 'disk'
        #: category): fsync latency / fsync error injection.
        self.faults = faults
        #: Optional gate a snapshot must pass (the follower mirror
        #: sets "replica caught up to the mirror" here, so a fuzzy
        #: image can never stamp entries the tree hasn't applied).
        self.snapshot_gate = None
        #: Optional utils/trace.TraceRing (the owning member's —
        #: server/server.py wires it): every append records a
        #: ``WAL_APPEND`` span and every completed fsync a
        #: ``GROUP_FSYNC`` span stamped with the barrier's batch size,
        #: so a txn's durability leg is traceable by zxid.
        self.trace = None
        #: Optional utils/metrics.TickLedger: loop-blocking sync time
        #: (sync='always' appends, the tick-sync fast path) lands in
        #: the ``fsync_gate`` tick phase.
        self.ledger = None
        self._tree = None
        # counters (gauges read these; cheap ints, no hot-path cost)
        self.appends = 0
        self.fsyncs = 0
        self.sync_errors = 0
        self.snapshots_taken = 0
        self.last_zxid = 0
        self.durable_zxid = 0
        self.next_index = 0
        self._written = 0             # bytes written to current segment
        self._durable = 0             # bytes covered by the last fsync
        #: bytes the newest *completed* fsync attempt covered, even a
        #: failed one — the ack gate releases on attempt, so a broken
        #: device degrades to acked-but-not-durable (counted in
        #: ``sync_errors``, demoted by the recovery invariant's
        #: floor) instead of wedging every reply forever
        self._attempted = 0
        #: cumulative appends covered by completed fsyncs — the delta
        #: at each fsync is that barrier's batch size (GROUP_FSYNC
        #: span + the group-commit story in the timeline)
        self._synced_appends = 0
        self._sync_scheduled = False
        self._inflight = False        # a group fsync is on the executor
        self._waiters: list = []      # send-plane releases awaiting it
        #: EWMA of measured device sync latency, ms (None until the
        #: first sync) — drives the FAST_SYNC_MS short-circuit
        self._sync_ewma_ms: float | None = None
        self._closed = False
        self._closed_segments: list[tuple[int, str]] = []
        self._snapshot_files: list[tuple[int, str]] = []
        self._fsync_hist = None
        self._append_hist = None
        if collector is not None:
            self.bind_metrics(collector)

        self._open_dir()

    def _open_dir(self) -> None:
        """Scan-and-continue the directory: shared by construction and
        :meth:`reopen`.  Mirrors :func:`recover_state`'s stop-at-
        first-invalid rule exactly — anything replay would never reach
        is quarantined (renamed ``*.dead``), never silently rejoined
        to the live history."""
        os.makedirs(self.dir, exist_ok=True)
        scan = scan_dir(self.dir, with_entries=True)
        self._closed_segments = []
        self._snapshot_files = []
        self.next_index = 0
        last_zxid = 0
        for s in scan.snapshots:
            if s.valid:
                self._snapshot_files.append((s.index, s.path))
                last_zxid = max(last_zxid, s.zxid)
        snap = scan.newest_valid_snapshot()
        base_index = snap.index if snap is not None else 0
        kept: list = []
        dead = False
        for n, seg in enumerate(scan.segments):
            if dead:
                # recovery stopped before this segment: its entries
                # are history the served state never contained —
                # rejoining them to the live log would let the NEXT
                # recovery replay across the gap
                self._quarantine(seg.path)
                continue
            if seg.status != 'ok':
                nxt = (scan.segments[n + 1].start_index
                       if n + 1 < len(scan.segments) else None)
                if nxt is not None and nxt <= base_index:
                    # wholly superseded by the snapshot image (the
                    # same rule recover_state applies): irrelevant to
                    # replay — quarantine just this one and go on
                    self._quarantine(seg.path)
                    continue
                # truncate the torn/invalid tail in place: bytes after
                # the last whole record are garbage, and leaving them
                # would poison the next recovery's stop-at-first-
                # invalid rule once a fresh segment follows them
                log.warning('truncating %s at %d (%s: %s)',
                            seg.path, seg.valid_bytes, seg.status,
                            seg.error)
                with open(seg.path, 'r+b') as f:
                    f.truncate(seg.valid_bytes)
                seg = dataclasses.replace(seg, size=seg.valid_bytes,
                                          status='ok', error=None)
                dead = True           # later segments are unreachable
            self.next_index = max(self.next_index, seg.end_index)
            if seg.records:
                last_zxid = max(last_zxid,
                                entry_zxid(seg.records[-1][1]))
            kept.append(seg)
        self.last_zxid = self.durable_zxid = last_zxid
        tail = kept[-1] if kept else None
        for seg in kept[:-1]:
            self._closed_segments.append((seg.start_index, seg.path))
        if tail is not None:
            # continue the newest kept segment in place (the bytes
            # already there survived a restart: they are on disk)
            self._file = open(tail.path, 'ab')
            self._seg_path = tail.path
            self._seg_start = tail.start_index
            self._written = self._durable = tail.size
            self._attempted = tail.size
            self._seg_gen = getattr(self, '_seg_gen', 0) + 1
            self._seg_opened = time.monotonic()
        else:
            self._open_segment()

    @staticmethod
    def _quarantine(path: str) -> None:
        dead = path + '.dead'
        log.warning('quarantining unreachable WAL segment %s', path)
        try:
            os.replace(path, dead)
        except OSError:  # pragma: no cover - permissions
            pass

    # -- metrics --

    def bind_metrics(self, collector) -> None:
        self._fsync_hist = collector.histogram(
            METRIC_FSYNC, 'WAL fsync latency, ms',
            buckets=FSYNC_BUCKETS)
        self._append_hist = collector.histogram(
            METRIC_APPEND_BYTES, 'Bytes per WAL record appended',
            buckets=APPEND_BUCKETS)
        # gauges are never idempotent on a Collector; two WALs sharing
        # one collector keep the first registrant's series
        for name, fn, help_text in (
                ('zkstream_wal_segments',
                 lambda: len(self._closed_segments) + 1,
                 'Live WAL segment files'),
                ('zkstream_wal_bytes', lambda: self.total_bytes(),
                 'Bytes across live WAL segments'),
                ('zkstream_wal_snapshots',
                 lambda: len(self._snapshot_files),
                 'Durable snapshot files'),
                ('zkstream_wal_last_index', lambda: self.next_index,
                 'One past the newest appended log index'),
                ('zkstream_wal_unsynced_bytes',
                 lambda: self._written - self._durable,
                 'Bytes appended to the open segment but not fsynced')):
            try:
                collector.gauge(name, fn, help_text)
            except ValueError:
                pass

    def total_bytes(self) -> int:
        n = self._written
        for _start, p in self._closed_segments:
            try:
                n += os.path.getsize(p)
            except OSError:
                pass
        return n

    # -- wiring --

    def bind(self, tree) -> None:
        """Attach the tree snapshots serialize (ZKDatabase for the
        leader, the replica store for a follower mirror)."""
        self._tree = tree

    # -- append path --

    def append(self, entry: tuple) -> int:
        """Append one committed txn; returns its absolute log index.
        Runs *before* the txn's ack is corked (store.py `_commit`), so
        the sync policy's barrier covers it."""
        assert not self._closed, 'append to a closed WAL'
        body = encode_entry(entry)
        rec = _REC_HDR.pack(len(body), crc32c(body)) + body
        self._file.write(rec)
        self._written += len(rec)
        self.appends += 1
        idx = self.next_index
        self.next_index += 1
        self.last_zxid = entry_zxid(entry)
        if self._append_hist is not None:
            self._append_hist.observe(len(rec))
        if self.trace is not None:
            self.trace.note('WAL_APPEND', zxid=self.last_zxid,
                            kind='server', nbytes=len(rec))
        if self.sync == 'always':
            if self.ledger is not None:
                self.ledger.enter('fsync_gate')
                try:
                    self.sync_now()
                finally:
                    self.ledger.exit()
            else:
                self.sync_now()
        elif self.sync == 'tick':
            self._schedule_tick_sync()
        else:
            self._file.flush()        # OS-buffered only
        self._maybe_roll()
        return idx

    def _schedule_tick_sync(self) -> None:
        if self._sync_scheduled:
            return
        self._sync_scheduled = True
        try:
            ambient_loop().call_soon(self._tick_sync)
        except RuntimeError:
            self._sync_scheduled = False
            self.sync_now()           # no loop: degrade to always

    def _tick_sync(self) -> None:
        self._sync_scheduled = False
        if self._closed:
            return
        if self.ledger is not None:
            # the fast-device short-circuit fsyncs inline here: that
            # is the tick's loop-blocked durability time
            self.ledger.enter('fsync_gate')
            try:
                self._ensure_group_sync()
            finally:
                self.ledger.exit()
        else:
            self._ensure_group_sync()

    # -- the ack gate (group commit riding the send-plane cork) --

    def gate_flush(self, release) -> bool:
        """The send-plane's durability gate (io/sendplane.py
        ``barrier``): True when every appended txn is already covered
        by a completed fsync attempt — the corked acks may leave.
        Otherwise the flush stays corked, ONE group fsync runs on an
        executor thread (the event loop keeps serving — real ZK's
        sync-thread shape), and ``release`` re-flushes when it
        completes.  ``sync='never'`` forfeits the gate;
        ``sync='always'`` already fsynced inside ``append`` and only
        re-syncs here after an earlier failure."""
        if self._closed or self.sync == 'never':
            return True
        if self._durable >= self._written \
                or self._attempted >= self._written:
            return True
        if self.sync == 'always':
            self.sync_now()
            return True
        self._ensure_group_sync()     # may complete inline (fast dev)
        if self._durable >= self._written \
                or self._attempted >= self._written:
            return True
        self._waiters.append(release)
        return False

    def _ensure_group_sync(self) -> None:
        """Start (at most one) group fsync covering everything written
        so far — inline when the device has been measuring fast (the
        executor round trip would cost more than the fsync), off-loop
        otherwise."""
        if self._inflight or self._closed:
            return
        if self._durable >= self._written:
            self._drain_waiters()
            return
        fast = (self._sync_ewma_ms is not None
                and self._sync_ewma_ms < FAST_SYNC_MS)
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            loop = None               # no loop to overlap with
        if fast or loop is None:
            self.sync_now()
            self._drain_waiters()
            return
        delay_ms, err = (self.faults.fsync_fault()
                         if self.faults is not None else (0.0, False))
        self._file.flush()
        snap_off, snap_zxid = self._written, self.last_zxid
        snap_n = self.appends
        fd = self._file.fileno()

        def work() -> float:
            t0 = time.perf_counter()
            if delay_ms > 0:
                time.sleep(delay_ms / 1000.0)   # device latency: it
                # delays acks, not the loop — exactly like real fsync
            if err:
                raise OSError('injected fsync error')
            os.fsync(fd)
            return (time.perf_counter() - t0) * 1000.0

        self._inflight = True
        gen = self._seg_gen
        fut = loop.run_in_executor(None, work)
        fut.add_done_callback(
            lambda f: self._group_sync_done(f, snap_off, snap_zxid,
                                            gen, snap_n))

    def _group_sync_done(self, fut, snap_off: int, snap_zxid: int,
                         gen: int, snap_n: int = 0) -> None:
        self._inflight = False
        if gen != self._seg_gen:
            # the segment rolled while this fsync ran: roll's
            # synchronous sync already covered those bytes, and the
            # old-segment offsets must not touch the new segment's
            # accounting (a spurious EBADF from the closed fd is the
            # same stale completion).  Re-gate any waiters against
            # the current segment.
            fut.exception()           # consume, never raises here
            self._drain_waiters()
            if self._written > max(self._durable, self._attempted):
                self._ensure_group_sync()
            return
        self._attempted = max(self._attempted, snap_off)
        if self._closed:
            self._drain_waiters()
            return
        exc = fut.exception()
        if exc is None:
            dur_ms = fut.result()
            self._note_sync(dur_ms, snap_n=snap_n,
                            snap_zxid=snap_zxid)
            if snap_off > self._durable:
                self._durable = snap_off
                self.durable_zxid = snap_zxid
        else:
            self.sync_errors += 1
            log.warning('WAL group fsync failed (%s); acked writes '
                        'since zxid %d are not durable', exc,
                        self.durable_zxid)
        self._drain_waiters()
        if self._written > max(self._durable, self._attempted):
            # appends landed while the fsync ran: cover them too
            self._ensure_group_sync()

    def _note_sync(self, dur_ms: float, snap_n: int = 0,
                   snap_zxid: int = 0) -> None:
        self.fsyncs += 1
        if self._fsync_hist is not None:
            self._fsync_hist.observe(dur_ms)
        if self.trace is not None and snap_n > self._synced_appends:
            # ONE span for the whole barrier, shared by every txn it
            # covered: stamped with the newest covered zxid and the
            # batch size (the group-commit shape, visible per write
            # in the merged timeline)
            self.trace.note('GROUP_FSYNC', zxid=snap_zxid,
                            kind='server',
                            batch=snap_n - self._synced_appends,
                            duration_ms=round(dur_ms, 3))
        if snap_n > self._synced_appends:
            self._synced_appends = snap_n
        self._sync_ewma_ms = (dur_ms if self._sync_ewma_ms is None
                              else 0.8 * self._sync_ewma_ms
                              + 0.2 * dur_ms)

    def _drain_waiters(self) -> None:
        waiters, self._waiters = self._waiters, []
        for release in waiters:
            try:
                release()
            except Exception:  # pragma: no cover - plane teardown
                log.exception('WAL gate release failed')

    def sync_for_flush(self) -> None:
        """The *synchronous* barrier: whatever the caller is about to
        put on the wire must be durable when this returns.  Used by
        the send-plane's ``flush_hard`` (fault-injected delivery,
        close paths) and the replication control channel's forwarded-
        write acks.  No-op under ``sync='never'`` — that policy
        explicitly forfeits the guarantee — and when nothing is
        pending."""
        if self.sync == 'never' or self._closed:
            return
        if self._durable != self._written:
            self.sync_now()

    def sync_now(self) -> bool:
        """Flush + fsync the open segment, blocking; returns False on
        an fsync error (injected or real — the write is then *not*
        durable and ``sync_errors``/``durable_zxid`` say so; retried
        at the next barrier)."""
        if self._durable >= self._written:
            return True
        t0 = time.perf_counter()
        snap_off, snap_zxid = self._written, self.last_zxid
        snap_n = self.appends
        try:
            if self.faults is not None:
                delay_ms, err = self.faults.fsync_fault()
                if delay_ms > 0:
                    time.sleep(delay_ms / 1000.0)
                if err:
                    raise OSError('injected fsync error')
            self._file.flush()
            os.fsync(self._file.fileno())
        except OSError as e:
            self.sync_errors += 1
            self._attempted = max(self._attempted, snap_off)
            log.warning('WAL fsync failed (%s); acked writes since '
                        'zxid %d are not yet durable', e,
                        self.durable_zxid)
            return False
        self._note_sync((time.perf_counter() - t0) * 1000.0,
                        snap_n=snap_n, snap_zxid=snap_zxid)
        self._attempted = max(self._attempted, snap_off)
        if snap_off > self._durable:
            self._durable = snap_off
            self.durable_zxid = snap_zxid
        return True

    # -- rotation + snapshots --

    def _seg_name(self, start: int) -> str:
        return os.path.join(self.dir, 'wal.%016d.log' % (start,))

    def _open_segment(self) -> None:
        self._seg_start = self.next_index
        self._seg_path = self._seg_name(self._seg_start)
        self._file = open(self._seg_path, 'ab')
        if self._file.tell() == 0:
            self._file.write(MAGIC_SEGMENT)
            self._file.flush()
        # offsets are per-segment: everything (durable, attempted, the
        # in-flight-fsync generation) re-bases here, or a stale count
        # from the previous segment would read as coverage of bytes
        # this segment has not fsynced
        self._written = self._durable = self._file.tell()
        self._attempted = self._written
        self._seg_gen = getattr(self, '_seg_gen', 0) + 1
        self._seg_opened = time.monotonic()

    def _maybe_roll(self) -> None:
        if (self._written < self.segment_bytes
                and (time.monotonic() - self._seg_opened)
                < self.segment_age_s):
            return
        if self.snapshot_gate is not None and not self.snapshot_gate():
            return                    # fuzzy image not consistent yet
        self.roll()

    def roll(self) -> None:
        """Close the open segment (fsynced), open the next, and take
        the snapshot that anchors truncation of everything before it."""
        self.sync_now()
        self._file.close()
        self._closed_segments.append((self._seg_start, self._seg_path))
        self._open_segment()
        self.snapshot_now()

    def snapshot_now(self) -> bool:
        """Take one fuzzy snapshot: stamp + image captured atomically
        in this tick, persisted concurrently with later applies (the
        file write/fsync/rename runs on an executor thread when a loop
        is available), truncation scheduled only once the file is
        durable."""
        tree = self._tree
        if tree is None:
            return False
        index, zxid = self.next_index, tree.zxid
        epoch = getattr(tree, 'epoch', 0)
        # format 3: the session table enters the image (captured in
        # the same synchronous tick as the stamp), so a restart inside
        # the session timeout keeps sessions — and their ephemerals
        snap_sessions = getattr(tree, 'session_snapshot',
                                lambda: {})()
        image = {'nodes': tree.nodes, 'sessions': snap_sessions}
        snap_config = getattr(tree, 'config_snapshot',
                              lambda: None)()
        if snap_config is not None:
            image['config'] = snap_config
        payload = pickle.dumps(image,
                               protocol=pickle.HIGHEST_PROTOCOL)
        final = os.path.join(self.dir, 'snap.%016d' % (index,))
        tmp = final + '.tmp'
        blob = (MAGIC_SNAPSHOT
                + _SNAP_HDR.pack(index, zxid, epoch,
                                 zlib.crc32(payload) & 0xFFFFFFFF)
                + payload)

        def persist() -> None:
            with open(tmp, 'wb') as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            if self._closed:
                # the log closed while this image was in flight: do
                # not materialize state into a directory the owner
                # already considers final
                os.unlink(tmp)
                return
            os.replace(tmp, final)

        def done() -> None:
            if self._closed:
                return
            self.snapshots_taken += 1
            self._snapshot_files.append((index, final))
            self._truncate_to(index)

        try:
            loop = ambient_loop()
            fut = loop.run_in_executor(None, persist)

            def _cb(f):
                if f.exception() is None:
                    done()
                else:  # pragma: no cover - disk-full class failures
                    log.warning('snapshot %s failed: %s', final,
                                f.exception())
            fut.add_done_callback(_cb)
        except RuntimeError:
            persist()                 # no loop: synchronous
            done()
        return True

    def _truncate_to(self, index: int) -> None:
        """Snapshot-anchored truncation.  Old snapshots beyond the
        keep depth go first; then closed segments wholly below the
        *oldest kept* snapshot — not merely the newest (``index``) —
        are dropped, so a recovery forced onto an older snapshot by a
        corrupt newer one still finds every entry it must replay."""
        self._snapshot_files.sort()
        while len(self._snapshot_files) > KEEP_SNAPSHOTS:
            _idx, p = self._snapshot_files.pop(0)
            try:
                os.unlink(p)
            except OSError:
                pass
        anchor = min((i for i, _p in self._snapshot_files),
                     default=index)
        keep: list[tuple[int, str]] = []
        ends = ([s for s, _ in self._closed_segments[1:]]
                + [self._seg_start])
        for (start, p), end in zip(self._closed_segments, ends):
            if end <= anchor:
                try:
                    os.unlink(p)
                except OSError:
                    pass
            else:
                keep.append((start, p))
        self._closed_segments = keep

    # -- crash simulation (chaos campaigns) --

    def materialize_crash(self, dst: str,
                          before_fsync: bool) -> int:
        """Write the directory a SIGKILL would leave behind into
        ``dst`` and return the zxid floor known durable in it.

        ``before_fsync=True`` is the harsher window: the open
        segment's un-fsynced tail is gone (the page cache died with
        the OS's cooperation withdrawn); ``False`` models dying just
        after the pending fsync completed.  Closed segments and
        completed snapshots were fsynced before becoming visible, so
        they survive either window whole; ``*.tmp`` never survives."""
        os.makedirs(dst, exist_ok=True)
        for _start, p in self._closed_segments:
            self._copy(p, dst)
        for _idx, p in self._snapshot_files:
            self._copy(p, dst)
        self._file.flush()
        n = self._durable if before_fsync else self._written
        with open(self._seg_path, 'rb') as f:
            data = f.read(n)
        with open(os.path.join(dst,
                               os.path.basename(self._seg_path)),
                  'wb') as f:
            f.write(data)
        return self.durable_zxid if before_fsync else self.last_zxid

    @staticmethod
    def _copy(src: str, dst_dir: str) -> None:
        try:
            with open(src, 'rb') as f:
                data = f.read()
        except OSError:
            return
        with open(os.path.join(dst_dir, os.path.basename(src)),
                  'wb') as f:
            f.write(data)

    @property
    def closed(self) -> bool:
        return self._closed

    def reopen(self) -> None:
        """Reopen a closed log over the same directory — the restart
        half of an in-process stop/restart cycle, and what
        ``ZKDatabase.recover_from_disk`` uses so collector-bound
        gauges and histograms (closures over THIS object) keep
        reading live state instead of a discarded instance.
        Cumulative counters (appends/fsyncs/sync_errors/snapshots)
        survive — they are process-lifetime metrics; positional state
        is re-derived from disk."""
        assert self._closed, 'reopen() is for a closed WAL'
        self._closed = False
        self._sync_scheduled = False
        self._inflight = False
        self._waiters = []
        self._sync_ewma_ms = None
        self._open_dir()

    def close(self) -> None:
        if self._closed:
            return
        if self.sync != 'never':
            self.sync_now()
        else:
            try:
                self._file.flush()
            except OSError:
                pass
        self._closed = True
        self._drain_waiters()        # gate reads closed -> released
        try:
            self._file.close()
        except OSError:
            pass


# ---------------------------------------------------------------------
# Database-level glue.
# ---------------------------------------------------------------------


def reset_dir(path: str) -> None:
    """Drop every segment and snapshot in a WAL directory — what a
    follower does when the leader bootstraps it from a snapshot
    despite its recovered state (the on-disk history is then stale
    relative to the installed image and must not be replayed over
    it).  Prefix-scoped on purpose: a co-tenant ``blackbox.*`` ring
    (utils/blackbox.py) records a history of the member, not of the
    tree — bootstrap must not erase it."""
    try:
        names = os.listdir(path)
    except FileNotFoundError:
        return
    for name in names:
        if (name.startswith(('wal.', 'snap.'))):
            try:
                os.unlink(os.path.join(path, name))
            except OSError:
                pass


def attach_wal(db, wal: WriteAheadLog) -> None:
    """Wire a log into a leader database: every committed txn is
    appended (store.py ``_commit``) before its ack can leave."""
    db.wal = wal
    wal.bind(db)


def restore_sequential_counters(tree) -> None:
    """Re-derive every parent's sequential counter from the node names
    it holds — what a follower promoted to leader (server/election.py)
    must do before allocating sequential names: its replica tree never
    consulted ``seq``, so the counters are all zero."""
    for path in list(tree.nodes):
        _advance_seq(tree, path)


def restore_sessions(db, sessions: dict) -> int:
    """Re-seat recovered sessions into a leader database: each gets a
    live :class:`~.store.ZKServerSession` with its ephemeral set
    rebuilt from the recovered tree and a FRESH expiry clock — a
    client that resumes inside the timeout keeps its session (and its
    ephemerals); one that never returns expires normally, and the
    expiry replays the ephemeral deletes as logged writes, exactly
    like real ZK's timeout-based expiry replay.  Outside a loop the
    clock stays unarmed until the first touch (unit-test contexts)."""
    from .store import ZKServerSession

    for sid, (passwd, timeout) in sessions.items():
        sess = ZKServerSession(id=sid, passwd=passwd, timeout=timeout)
        db.sessions[sid] = sess
    if sessions:
        for path, node in db.nodes.items():
            sess = db.sessions.get(node.ephemeral_owner) \
                if node.ephemeral_owner else None
            if sess is not None:
                sess.ephemerals.add(path)
        for sess in db.sessions.values():
            try:
                db.touch_session(sess)
            except RuntimeError:
                break                 # no loop: clocks start later
    return len(sessions)


def reap_orphan_ephemerals(db) -> int:
    """Delete recovered ephemerals whose owning session did NOT
    survive the crash — i.e. is absent from the recovered session
    table (closed/expired before the crash, or never durably
    created).  Sessions that *were* live stay live (restored with
    fresh expiry clocks by :func:`restore_sessions`), so their
    ephemerals survive a restart inside the session timeout; if the
    client never resumes, the normal expiry path reaps them by logged
    deletes.  The reaping deletes here are sequenced and logged like
    any write, so a second crash cannot resurrect them."""
    orphans = [p for p, n in db.nodes.items()
               if n.ephemeral_owner
               and n.ephemeral_owner not in db.sessions]
    for path in sorted(orphans, key=len, reverse=True):
        try:
            db.delete(path, -1)
        except Exception:
            log.warning('could not reap recovered ephemeral %s', path)
    return len(orphans)


def open_wal_database(path: str, *, sync: str = 'tick',
                      segment_bytes: int = DEFAULT_SEGMENT_BYTES,
                      segment_age_s: float = DEFAULT_SEGMENT_AGE_S,
                      collector=None, faults=None, trace=None):
    """Recover (or initialize) a leader ``ZKDatabase`` from a WAL
    directory and attach a live log continuing it — the restart-from-
    disk entry point for ``ZKServer``, ``ZKEnsemble`` and the
    OS-process leader worker."""
    from .store import ZKDatabase

    rec = recover_state(path, trace=trace)
    db = ZKDatabase()
    db.nodes = rec.nodes
    db.zxid = rec.zxid
    db.epoch = rec.epoch
    db.log_start_zxid = rec.zxid
    if rec.config is not None:
        db.install_config(rec.config)
    wal = WriteAheadLog(path, sync=sync, segment_bytes=segment_bytes,
                        segment_age_s=segment_age_s,
                        collector=collector, faults=faults)
    attach_wal(db, wal)
    # sessions first: a recovered-live session keeps its ephemerals
    # (the restart-inside-timeout guarantee); only dead ones reap
    restore_sessions(db, rec.sessions)
    reap_orphan_ephemerals(db)
    return db


def scrape_wal_cells(collector) -> dict:
    """Summarize the WAL histograms for bench cells (`bench.py --wal`):
    fsync count + latency p50/p99, append count + bytes p50/p99."""
    out: dict = {}
    try:
        fs = collector.get_collector(METRIC_FSYNC)
        ap = collector.get_collector(METRIC_APPEND_BYTES)
    except ValueError:
        return out
    n = fs.count()
    if n:
        out['fsyncs'] = n
        out['fsync_p50_ms'] = round(fs.percentile(50), 3)
        out['fsync_p99_ms'] = round(fs.percentile(99), 3)
        out['fsync_mean_ms'] = round(fs.sum() / n, 3)
    m = ap.count()
    if m:
        out['appends'] = m
        out['append_p50_b'] = round(ap.percentile(50), 1)
        out['append_p99_b'] = round(ap.percentile(99), 1)
    return out
