"""The deployed-shaped mixed-opcode reply corpus.

A fleet of B framed reply streams, each carrying ``frames`` valid
replies in a fixed 16-frame opcode pattern: 256 B GET_DATA payloads,
genuine children and ACL lists, watch notifications, error replies and
ping replies (reference layouts: lib/zk-buffer.js:275-370,428-442).  At
the default B = 16384 and 64 frames a stream is ~15.4 KiB and a tick
~247 MiB.  Byte for byte the corpus ``bench.py``'s ``_fleet`` builds
for the same B and seed (the port keeps its own copy).
"""

from __future__ import annotations

import numpy as np

DATA_LEN = 256       # GET_DATA payload bytes
CH2_N, CH2_NAME = 8, 12      # GET_CHILDREN2: children x name bytes
CH_N, CH_NAME = 6, 10        # GET_CHILDREN (no Stat)
ACL_N, ACL_SCHEME, ACL_ID = 2, 6, 24
NOTIF_PATH = 20

#: Per-16-frame opcode pattern, repeated frames/16 times per stream.
SLOT_PATTERN = (
    'data', 'data', 'children2', 'data', 'notif', 'data', 'acl',
    'data', 'data', 'children', 'data_err', 'data', 'data',
    'children2', 'ping', 'data')

_BODY_LEN = {
    'data': 16 + 4 + DATA_LEN + 68,
    'data_err': 16,                       # error reply: header only
    'children2': 16 + 4 + CH2_N * (4 + CH2_NAME) + 68,
    'children': 16 + 4 + CH_N * (4 + CH_NAME),
    'acl': 16 + 4 + ACL_N * (4 + 4 + ACL_SCHEME + 4 + ACL_ID) + 68,
    'notif': 16 + 4 + 4 + 4 + NOTIF_PATH,
    'ping': 16,
}

_OPCODE = {
    'data': 'GET_DATA', 'data_err': 'GET_DATA',
    'children2': 'GET_CHILDREN2', 'children': 'GET_CHILDREN',
    'acl': 'GET_ACL', 'notif': 'NOTIFICATION', 'ping': 'PING',
}


def slot_schedule(frames: int = 64):
    """The corpus's static frame layout: every stream carries the same
    (opcode, width) sequence at the same byte offsets.  Returns
    (slots, stream_len); each slot is a dict with ``kind``, ``opcode``,
    ``off`` (frame start), ``body_len`` and ``xid_index`` (None for the
    special-xid notification/ping frames)."""
    if frames % len(SLOT_PATTERN):
        raise ValueError('frames must be a multiple of %d'
                         % len(SLOT_PATTERN))
    kinds = SLOT_PATTERN * (frames // len(SLOT_PATTERN))
    slots, off, xi = [], 0, 0
    for kind in kinds:
        bl = _BODY_LEN[kind]
        has_xid = kind not in ('notif', 'ping')
        slots.append({'kind': kind, 'opcode': _OPCODE[kind],
                      'off': off, 'body_len': bl,
                      'xid_index': xi if has_xid else None})
        if has_xid:
            xi += 1
        off += 4 + bl
    return slots, off


def fleet(B: int = 16384, seed: int = 42, frames: int = 64):
    """Build the corpus: returns ``(buf uint8 [B, L], lens int32 [B],
    slots, xid_maps)`` where ``xid_maps[i]`` is stream i's xid ->
    opcode map, as its connection's send side would have recorded it
    (notification and ping frames carry reserved xids and never enter
    it)."""
    rng = np.random.RandomState(seed)
    slots, L = slot_schedule(frames)
    v = np.zeros((B, L), np.uint8)

    def be(field, width, out):
        shifts = np.arange(8 * (width - 1), -1, -8, dtype=np.int64)
        out[...] = ((field[..., None] >> shifts) & 0xFF).astype(np.uint8)

    def ri(lo, hi):
        return rng.randint(lo, hi, (B,)).astype(np.int64)

    def full(x):
        return np.full((B,), x, np.int64)

    def ascii_bytes(n):
        return rng.randint(97, 123, (B, n), dtype=np.uint8)  # a-z

    def write_stat(off, mzxid, data_len=0, num_children=0):
        be(ri(1, 1 << 40), 8, v[:, off:off + 8])          # czxid
        be(mzxid, 8, v[:, off + 8:off + 16])              # mzxid
        be(ri(1, 1 << 41), 8, v[:, off + 16:off + 24])    # ctime
        be(ri(1, 1 << 41), 8, v[:, off + 24:off + 32])    # mtime
        be(ri(0, 1 << 10), 4, v[:, off + 32:off + 36])    # version
        be(ri(0, 1 << 10), 4, v[:, off + 36:off + 40])    # cversion
        be(ri(0, 1 << 10), 4, v[:, off + 40:off + 44])    # aversion
        # ephemeralOwner stays 0
        be(full(data_len), 4, v[:, off + 52:off + 56])    # dataLength
        be(full(num_children), 4, v[:, off + 56:off + 60])
        be(ri(1, 1 << 40), 8, v[:, off + 60:off + 68])    # pzxid

    # xids: sequential per stream from a random base, like the
    # connection's allocator — a reply xid is unique in flight
    xbase = rng.randint(1, 1 << 19, (B,)).astype(np.int64)

    for s in slots:
        o, kind = s['off'], s['kind']
        be(full(s['body_len']), 4, v[:, o:o + 4])
        if kind == 'notif':
            xid, zxid, err = full(-1), full(-1), 0
        elif kind == 'ping':
            xid, zxid, err = full(-2), ri(1, 1 << 40), 0
        else:
            xid, zxid = xbase + s['xid_index'], ri(1, 1 << 40)
            err = -101 if kind == 'data_err' else 0  # NO_NODE
        be(xid, 4, v[:, o + 4:o + 8])
        be(zxid, 8, v[:, o + 8:o + 16])
        be(full(err), 4, v[:, o + 16:o + 20])
        p = o + 20                                  # payload start
        if kind == 'data':
            be(full(DATA_LEN), 4, v[:, p:p + 4])
            v[:, p + 4:p + 4 + DATA_LEN] = rng.randint(
                0, 256, (B, DATA_LEN), dtype=np.uint8)
            write_stat(p + 4 + DATA_LEN, zxid, data_len=DATA_LEN)
        elif kind in ('children2', 'children'):
            n, w = ((CH2_N, CH2_NAME) if kind == 'children2'
                    else (CH_N, CH_NAME))
            be(full(n), 4, v[:, p:p + 4])
            c = p + 4
            for _k in range(n):
                be(full(w), 4, v[:, c:c + 4])
                v[:, c + 4:c + 4 + w] = ascii_bytes(w)
                c += 4 + w
            if kind == 'children2':
                write_stat(c, zxid, num_children=n)
        elif kind == 'acl':
            be(full(ACL_N), 4, v[:, p:p + 4])
            c = p + 4
            for _k in range(ACL_N):
                be(full(0x1F), 4, v[:, c:c + 4])    # perms: ALL
                be(full(ACL_SCHEME), 4, v[:, c + 4:c + 8])
                v[:, c + 8:c + 8 + ACL_SCHEME] = ascii_bytes(ACL_SCHEME)
                c += 8 + ACL_SCHEME
                be(full(ACL_ID), 4, v[:, c:c + 4])
                v[:, c + 4:c + 4 + ACL_ID] = ascii_bytes(ACL_ID)
                c += 4 + ACL_ID
            write_stat(c, zxid)
        elif kind == 'notif':
            be(ri(1, 5), 4, v[:, p:p + 4])          # type: valid enum
            be(full(3), 4, v[:, p + 4:p + 8])       # SYNC_CONNECTED
            be(full(NOTIF_PATH), 4, v[:, p + 8:p + 12])
            v[:, p + 12] = ord('/')
            v[:, p + 13:p + 12 + NOTIF_PATH] = ascii_bytes(
                NOTIF_PATH - 1)
        # 'ping' / 'data_err': header-only bodies, nothing more
    lens = np.full((B,), L, np.int32)
    return v, lens, slots, xid_maps(v, slots)


def xid_maps(buf, slots) -> list[dict]:
    """Per-stream xid -> opcode maps read from the corpus bytes."""
    xslots = [s for s in slots if s['xid_index'] is not None]
    if not xslots:
        return [{} for _ in range(buf.shape[0])]
    cols = np.stack([buf[:, s['off'] + 4:s['off'] + 8] for s in xslots],
                    axis=1).astype(np.int64)              # [B, K, 4]
    xids = ((cols[..., 0] << 24) | (cols[..., 1] << 16)
            | (cols[..., 2] << 8) | cols[..., 3])
    xids = np.where(xids >= 1 << 31, xids - (1 << 32), xids)
    ops = [s['opcode'] for s in xslots]
    return [dict(zip(row, ops)) for row in xids.tolist()]


def adversarial(seed: int = 0, B: int = 37, L: int = 512):
    """A batch of hostile and edge-case rows for holding K1 against its
    plain version: negative, oversized and near-INT32_MAX length
    prefixes, frames shorter than the 16-byte header, zero-length
    frames, truncated tails, empty rows, a row filled exactly to ``L``,
    more frames than a small ``max_frames``, ``lens > L`` and
    ``lens < 0``, then random fleets (odd ``B`` by default).  Returns
    ``(buf uint8 [B, L], lens int32 [B])``."""
    import random
    import struct

    if B < 16 or L < 256:
        raise ValueError('adversarial batch needs B >= 16 and L >= 256')
    rng = random.Random(seed)

    def frame(xid, zxid, err, body=b''):
        hdr = struct.pack('>iqi', xid, zxid, err)
        return struct.pack('>i', len(hdr) + len(body)) + hdr + body

    def good():
        xid = rng.choice([-2, -1, rng.randrange(0, 1 << 31)])
        return frame(xid, rng.randrange(-(1 << 63), 1 << 63),
                     rng.choice([0, 0, -101, -4]),
                     bytes(rng.randrange(256)
                           for _ in range(rng.randrange(0, 24))))

    P = struct.Struct('>i').pack
    rows = [
        b'',                                               # empty
        frame(5, 9, 0, b'\x01' * (L - 20)),                # fills L
        P(8) + b'\x02' * 8 + good(),                       # short frame
        good() + P(-5) + b'junk',                          # negative
        good() + P((16 << 20) + 1) + b'\0' * 8,            # oversized
        P(0x7FFFFFF0) + b'\0' * 20,                        # near INT32_MAX
        good() + P(16 << 20) + b'\0' * 30,                 # MAX_PACKET
        good() + good() + P(40) + b'\xab' * 11,            # truncated
        P(0) * 3 + good(),                                 # zero-length
        b''.join(frame(i, i, 0) for i in range(12)),       # > 8 frames
        P(-1) + P(-1),                                     # 0xFFFFFFFF
        frame(-1, -1, 0) + frame(1, -(1 << 63), 0),        # u64 edges
    ]
    buf = np.zeros((B, L), np.uint8)
    lens = np.zeros((B,), np.int32)
    for i in range(B):
        if i < len(rows):
            s = rows[i]
        elif i % 5 == 0:                                   # random bytes
            s = bytes(rng.randrange(256) for _ in range(rng.randrange(L)))
        else:
            s = b''.join(good() for _ in range(rng.randrange(0, 9)))
            if rng.random() < 0.5:
                s += P(rng.randrange(16, 64)) + b'\xcd' * rng.randrange(20)
        s = s[:L]
        buf[i, :len(s)] = np.frombuffer(s, np.uint8)
        lens[i] = len(s)
    lens[len(rows)] = L + 100                              # lens > L
    lens[len(rows) + 1] = -5                               # lens < 0
    lens[len(rows) + 2] = 3                                # < a prefix
    return buf, lens


def getdata_fleet(seed: int = 0, B: int = 13, L: int = 512,
                  max_data: int = 16):
    """Streams of GET_DATA-layout frames for holding K2 against its plain
    version: buffer(data) then Stat, with adversarial shapes mixed in —
    empty data as length -1, a truncated Stat, a buffer length that
    overruns the frame, one near INT32_MAX, and header-only frames.
    Row by row the batch the JAX package's Pallas tests build from
    ``random.Random(seed)``.  Returns ``(buf uint8 [B, L], lens int32
    [B])``."""
    import random
    import struct

    rng = random.Random(seed)

    def frame(xid, zxid, err, body):
        hdr = struct.pack('>iqi', xid, zxid, err)
        return struct.pack('>i', len(hdr) + len(body)) + hdr + body

    buf = np.zeros((B, L), np.uint8)
    lens = np.zeros((B,), np.int32)
    for i in range(B):
        s = b''
        for _ in range(rng.randrange(0, 5)):
            kind = rng.random()
            if kind < 0.5:      # well-formed GET_DATA reply
                dlen = rng.choice([0, 1, 3, max_data - 1, max_data,
                                   max_data + 5])
                data = bytes(rng.randrange(256) for _ in range(dlen))
                body = struct.pack('>i', dlen) + data + bytes(
                    rng.randrange(256) for _ in range(68))
            elif kind < 0.6:    # empty buffer as length -1
                body = struct.pack('>i', -1) + bytes(
                    rng.randrange(256) for _ in range(68))
            elif kind < 0.7:    # Stat truncated
                body = struct.pack('>i', 2) + b'xy' + b'\x01' * 30
            elif kind < 0.75:   # buffer length overruns the frame
                body = struct.pack('>i', 4096) + b'zz'
            elif kind < 0.85:   # wire length near INT32_MAX
                body = struct.pack('>i', 0x7FFFFFF4) + b'zz' + b'\x00' * 70
            else:               # header-only (PING-like)
                body = b''
            s += frame(rng.randrange(1, 1000), rng.randrange(1 << 40), 0,
                       body)
        s = s[:L]
        buf[i, :len(s)] = np.frombuffer(s, np.uint8)
        lens[i] = len(s)
    return buf, lens


def ring_fleet(seed: int = 0, B: int = 96, L: int = 6004,
               stage_bytes: int = 1024, stages: int = 4):
    """Rows that put kernel K2's shared-memory ring at its edges, for
    holding it against its plain version.  K2 stages a row's 16-byte
    aligned interior in stages of ``stage_bytes`` (row offsets
    ``hoff + k * stage_bytes``, ``hoff = -row_address mod 16``; a
    ``[B, L]`` batch at a 16-byte aligned address puts row ``i`` at
    ``i * L``), ``stages`` of them in flight per warp.

    The batch holds: frames whose length prefix, header, jute length,
    data or Stat start 4 bytes before to 4 bytes after a stage boundary
    (GET_DATA frames of assorted payload lengths, placed by a pad frame);
    runs of frames one stage long, give or take 1-4 bytes; a frame
    longer than the whole ring, then more frames; a bad length prefix
    after a long frame; GET_DATA frames with jute lengths -1, 0, 255,
    256 and 257; a jute length that overruns its frame; a row filled to
    exactly ``L``; an empty row; rows with ``lens > L``, ``lens < 0``
    and ``lens = 0`` over real frames.  Pick ``L % 16 != 0`` (the
    default) and rows start at every alignment.  Returns ``(buf uint8
    [B, L], lens int32 [B])``."""
    import random
    import struct

    SB = stage_bytes
    if L < stages * SB + 512:
        raise ValueError('ring_fleet needs L >= stages * stage_bytes + 512 '
                         'for a frame longer than the ring')
    rng = random.Random(seed)
    P = struct.Struct('>i').pack

    def rb(k):
        return rng.randbytes(k)

    def head():
        return struct.pack('>iqi', rng.randrange(1, 1 << 20),
                           rng.randrange(1 << 40), rng.choice([0, 0, -101]))

    def getdata(dlen, data=None):
        body = head() + P(dlen)
        body += rb(max(dlen, 0)) if data is None else data
        body += rb(68)
        return P(len(body)) + body

    def sized(total):
        """A frame of exactly ``total`` bytes (``total >= 4``): a
        GET_DATA reply where it has room for one, else header (and
        junk) only."""
        ln = total - 4
        if ln >= 88:
            return getdata(ln - 88)
        if ln >= 16:
            return P(ln) + head() + rb(ln - 16)
        return P(ln) + rb(ln)

    def pad_to(s, upto):
        gap = upto - len(s)
        if gap == 0:
            return s
        if gap < 4:
            raise AssertionError('pad gap %d' % gap)
        return s + sized(gap)

    def stage_runs(s):
        while len(s) < L:
            s += sized(SB + rng.choice([-4, -3, -2, -1, 1, 2, 3, 4]))
        return s

    def hoff(i):
        return (-i * L) % 16

    dlens = (0, 1, 3, 64, 255, 256, 257, 300)
    fields = ('len', 'xid', 'zxid', 'err', 'dlen', 'data', 'data_mid',
              'stat')

    def straddle(i, k):
        f = fields[k % len(fields)]
        delta = (k // len(fields)) % 9 - 4
        dlen = dlens[(k // 3) % len(dlens)]
        at = {'len': 0, 'xid': 4, 'zxid': 8, 'err': 16, 'dlen': 20,
              'data': 24, 'data_mid': 24 + (dlen // 2 & ~3),
              'stat': 24 + dlen}[f]
        bound = hoff(i) + SB * (1 + k % 2)
        start = bound + delta - at
        if 0 < start < 4:
            start += SB
        s = pad_to(b'', start) + getdata(dlen)
        return stage_runs(s)

    specials = [
        lambda i: b'',                                           # empty
        lambda i: sized(stages * SB + 300) + getdata(256)        # > ring
        + getdata(-1) + sized(SB + 2) + getdata(17),
        lambda i: sized(stages * SB + 37) + P(-7) + rb(40),      # bad
        lambda i: b''.join(getdata(d) for d in (-1, 0, 255, 256, 257,
                                                -1, 257, 0)),
        lambda i: pad_to(b'', hoff(i) + SB - 22)                 # overrun
        + P(16 + 4 + 40) + head() + P(4096) + rb(40) + getdata(5),
        lambda i: pad_to(b'', L - 4 - 100) + sized(104),         # exactly L
    ]
    lens_over = [
        # a last frame that runs past L but ends inside lens
        ('gt', lambda i: pad_to(b'', L - 200) + getdata(300), L + 200),
        ('neg', lambda i: stage_runs(b''), -3),
        ('zero', lambda i: stage_runs(b''), 0),
    ]
    buf = np.zeros((B, L), np.uint8)
    lens = np.zeros((B,), np.int32)
    n_fixed = len(specials) + len(lens_over)
    for i in range(B):
        forced = None
        if i < len(specials):
            s = specials[i](i)
        elif i < n_fixed:
            _kind, make, forced = lens_over[i - len(specials)]
            s = make(i)
        elif i - n_fixed < len(fields) * 9:
            s = straddle(i, i - n_fixed)
        else:
            s = b''
            while len(s) < L:
                s += rng.choice([
                    sized(SB + rng.randrange(-4, 5)),
                    sized(rng.randrange(4, 200)),
                    getdata(rng.choice(dlens + (-1,)))])
        s = s[:L]
        buf[i, :len(s)] = np.frombuffer(s, np.uint8)
        lens[i] = len(s) if forced is None else forced
    return buf, lens
