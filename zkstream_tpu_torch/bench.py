"""Benchmark: batched wire-decode throughput on the card vs the scalar
codecs — the port of the JAX package's root ``bench.py``.

Run as ``python -m zkstream_tpu_torch.bench [--device cuda|cpu]
[--wal|--election|...]``.  The reference publishes no benchmark
numbers (BASELINE.md), so the measurable baseline is defined here:
decode a fleet of framed ZooKeeper reply streams — frame slicing +
reply-header parse + xid routing + max-zxid session reduction, exactly
the per-connection hot path of lib/zk-streams.js:39-99 /
lib/connection-fsm.js:213-229, over a mixed-opcode corpus (256 B
GET_DATA replies, genuine children/ACL lists, notifications, error and
ping replies — deployed-shaped traffic, not toy frames;
``corpus.fleet``) — and compare

  baseline:  the scalar bytes-loop codec (zkstream_tpu_torch.protocol),
             the same implementation idiom as the reference's
             JavaScript (per-byte buffer walking on one core), and the
             port's C-extension codec as a context line;
  value:     the batched tensor pipeline (zkstream_tpu_torch.ops) on
             the CUDA card: the tick through kernel K1, the full
             decode through kernel K2 and the torch body parse.

``--device cpu`` runs the plain torch versions instead (the tests use
it at a small ``B``).  Without a card and without ``--device cpu`` the
bench raises: it never falls back to the CPU.

Prints three JSON lines, the flagship last:
  {"metric": "wire_decode_throughput", "value": <MiB/s>,
   "unit": "MiB/s", "vs_baseline": <card/scalar ratio>, ...}
  {"metric": "wire_full_decode_toy_width", ...}
  {"metric": "wire_full_decode_throughput", ...}
each with ``backend``, ``device`` (the card's name) and
``power_limit`` (``nvidia-smi``'s, for a CUDA run).

The host-only families (``--wal``, ``--election``, ``--quorum``,
``--reconfig``, ``--traceov``, ``--blackbox``, ``--overload``,
``--transport``, ``--ingress``, ``--fanout``, ``--read``,
``--million``) touch no device and load no torch; ``--write`` runs the
client-ops cells, whose ingest arm runs on ``--device``.
"""

from __future__ import annotations

import json
import os
import struct
import sys
import time

import numpy as np

from . import corpus
from .corpus import (
    ACL_N,
    CH2_N,
    CH_N,
    DATA_LEN,
)

B = 16384        # streams (connections) per tick
FRAMES = 64      # frames per stream
REPEATS = 30     # dispatches per timing round (x4 rounds, min taken)

# -- deployed decode-plane widths (io/ingest.py defaults).  One source
# of truth: the full_deployed program, the differential gate, and the
# scalar agreement walks must all use the SAME bounds, or the gates
# would validate against different limits than the timed program --
DEP_DATA, DEP_PATH = 256, 256
DEP_CHILDREN, DEP_NAME = 16, 64
DEP_ACLS, DEP_SCHEME, DEP_ID = 4, 16, 64

def _slot_schedule():
    """The corpus's static frame layout (``corpus.slot_schedule``):
    every stream carries the same (opcode, width) sequence at the same
    byte offsets — contents are random per stream — so the gates know
    each frame's ground-truth opcode without re-parsing.  Returns
    (slots, stream_len); each slot is a dict with ``kind``, ``opcode``,
    ``off`` (frame start), ``body_len`` and ``xid_index`` (None for the
    special-xid notification/ping frames)."""
    return corpus.slot_schedule(FRAMES)


def _fleet():
    """The bench corpus, ``corpus.fleet(B, seed=42)``: [B, L] framed
    streams of **valid mixed-opcode replies** — reply headers then
    per-opcode bodies (reference layouts: lib/zk-buffer.js:275-370,
    428-442) per the :func:`_slot_schedule` pattern, so the full-decode
    benchmark decodes deployed-shaped traffic (16384 x ~15.4 KiB =
    ~247 MiB per tick).  Returns (buf, lens, streams, slots)."""
    buf, lens, slots, _maps = corpus.fleet(B, seed=42, frames=FRAMES)
    streams = [buf[i].tobytes() for i in range(B)]
    return buf, lens, streams, slots


def bench_scalar(streams) -> float:
    """Scalar protocol-tick baseline, MiB/s: length-prefix walk +
    reply-header parse + routing counts + max-zxid per stream —
    exactly the work the device tick metric does (headers only, no
    body materialization, so the comparison is equal-work), as an
    interpreted per-byte loop in the reference's idiom
    (lib/zk-streams.js:39-64 + lib/connection-fsm.js:213-229)."""
    ln_s = struct.Struct('>i')
    hdr = struct.Struct('>iqi')
    total = sum(len(s) for s in streams)
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        for s in streams:
            off, n = 0, len(s)
            max_zxid = 0
            n_notif = n_ping = n_err = 0
            while n - off >= 4:
                (ln,) = ln_s.unpack_from(s, off)
                if ln < 0 or ln > 16 << 20 or n - off < 4 + ln:
                    break
                xid, zxid, err = hdr.unpack_from(s, off + 4)
                if xid == -1:
                    n_notif += 1
                elif xid == -2:
                    n_ping += 1
                else:
                    if err:
                        n_err += 1
                    if zxid > max_zxid:
                        max_zxid = zxid
                off += 4 + ln
    dt = time.perf_counter() - t0
    return total * reps / dt / (1024 * 1024)


SCALAR_FULL_STREAMS = 1024   # subset for the interpreted full decode
                             # (throughput is per-byte; ~65k frames is
                             # plenty and keeps the bench under budget)

CHECK_STREAMS = 64           # subset whose scalar packets are retained
                             # frame-for-frame for the differential
                             # device-decode gates


def _xid_maps(sub, slots):
    """Per-stream xid -> opcode maps, as each connection's send side
    would have recorded them (lib/zk-streams.js:145).  Notification and
    ping frames carry reserved xids and never enter the map."""
    hdr_xid = struct.Struct('>i')
    maps = []
    for s in sub:
        m = {}
        for sl in slots:
            if sl['xid_index'] is None:
                continue
            (xid,) = hdr_xid.unpack_from(s, sl['off'] + 4)
            m[xid] = sl['opcode']
        maps.append(m)
    return maps


def bench_scalar_full(streams, slots):
    """Scalar **full decode** baseline, MiB/s: framing + reply header +
    opcode-dispatched body parse into packet dicts (data bytes, child
    lists, ACLs, Stat records) — the complete per-frame receive work of
    the reference client (lib/zk-buffer.js:275-442), interpreted Python
    in the reference's idiom.  Returns (MiB/s, pkts) where ``pkts`` is
    the per-frame packet list of the first CHECK_STREAMS streams — the
    ground truth for the device full-decode differential gates."""
    from .protocol.framing import FrameDecoder
    from .protocol.jute import JuteReader
    from .protocol.records import read_response

    sub = streams[:SCALAR_FULL_STREAMS]
    maps = _xid_maps(sub, slots)
    total = sum(len(s) for s in sub)
    pkts = []
    t0 = time.perf_counter()
    for i, (s, m) in enumerate(zip(sub, maps)):
        dec = FrameDecoder(use_native=False)
        mm = dict(m)
        row = [read_response(JuteReader(body), mm)
               for body in dec.feed(s)]
        if i < CHECK_STREAMS:
            pkts.append(row)
    dt = time.perf_counter() - t0
    return total / dt / (1024 * 1024), pkts


def bench_ext_full(streams, slots) -> float | None:
    """The repo's own C-extension full decode over the same subset —
    context line so the flagship ratio is read against both the
    reference-idiom interpreted loop and this framework's native
    scalar path."""
    from .utils import native

    ext = native.ensure_ext()
    if ext is None:
        return None
    from .protocol.consts import MAX_PACKET

    sub = streams[:SCALAR_FULL_STREAMS]
    maps = _xid_maps(sub, slots)
    total = sum(len(s) for s in sub)
    t0 = time.perf_counter()
    for s, m in zip(sub, maps):
        pkts, _consumed, kind, _msg = ext.decode_responses(
            s, dict(m), MAX_PACKET)
        assert kind is None and len(pkts) == FRAMES
    dt = time.perf_counter() - t0
    return total / dt / (1024 * 1024)


def bench_tensor(buf, lens, streams, pkts, slots, device='cuda',
                 calls: dict | None = None
                 ) -> tuple[float, float, float]:
    """Tensor pipeline MiB/s on ``device``: the protocol tick (header
    decode + routing) and the **full decode** (tick + batched
    reply-body parse, ops/replies.py — the work of
    lib/zk-buffer.js:275-442).  Returns (tick_mibs, full_mibs,
    full_deployed_mibs).  ``calls``, when given, receives the calls
    each candidate made, warm-up included: on a card the tick launches
    K1 once a call and each full decode K2 once a call.

    Three candidates, each timed as the min over 4 rounds of ``reps``
    calls, with a device synchronize closing each batch of calls:

    - ``tick``: ``wire_pipeline_step_auto`` — kernel K1 on a CUDA
      tensor (its plain torch version on a CPU tensor);
    - ``full``: the toy-width full decode (``max_data=16``,
      ``max_path=8``) — ``wire_full_decode`` (kernel K2) feeding
      ``parse_reply_bodies`` its GET_DATA planes;
    - ``full-deployed``: the same at the deployed widths plus
      ``parse_list_bodies`` — the step ``FleetIngest(body_mode=
      'device')`` runs.

    All three are mandatory: a failure fails the run.  The correctness
    gates read host copies of each candidate's planes after every
    candidate has been timed, so no readback sits inside a timed
    window."""
    import torch

    from .ops.pipeline import (
        batch_to_device,
        wire_full_decode,
        wire_pipeline_step_auto,
    )
    from .ops.replies import (
        parse_list_bodies,
        parse_reply_bodies,
    )

    jb, jl = batch_to_device(buf, lens, device)
    cuda = jb.device.type == 'cuda'

    def sync():
        if cuda:
            torch.cuda.synchronize(jb.device)

    def full(b, l):
        st, gd = wire_full_decode(b, l, max_frames=FRAMES, max_data=16)
        bd = parse_reply_bodies(b, st.starts, st.sizes,
                                max_data=16, max_path=8, getdata=gd)
        return st, bd

    def full_deployed(b, l):
        # the configuration the SHIPPED ingest runs (io/ingest.py
        # defaults): 256-byte data/path planes plus the speculative
        # children/ACL list planes — every layout parsed at every
        # frame, exactly the deployed device-bodies work
        st, gd = wire_full_decode(b, l, max_frames=FRAMES,
                                  max_data=DEP_DATA)
        bd = parse_reply_bodies(b, st.starts, st.sizes,
                                max_data=DEP_DATA, max_path=DEP_PATH,
                                getdata=gd)
        lb = parse_list_bodies(b, st.starts, st.sizes,
                               max_children=DEP_CHILDREN,
                               max_name=DEP_NAME, max_acls=DEP_ACLS,
                               max_scheme=DEP_SCHEME, max_id=DEP_ID)
        return st, bd, lb

    # the plain versions on the host CPU are orders slower per byte;
    # fewer repeats keep a CPU run short without changing what is
    # measured (min-of-rounds either way)
    reps = REPEATS if cuda else max(6, REPEATS // 3)
    candidates = [
        ('tick', lambda b, l: wire_pipeline_step_auto(
            b, l, max_frames=FRAMES), reps, None),
        ('full', full, reps, None),
        # deployed widths cost ~20x the toy planes in output bytes
        # (ONE output is ~2.2 GiB: 256 B data + 256 B path + 16x64
        # children names + ACL planes per slot, over 16384x64 slots);
        # fewer repeats AND a 2-deep cap on the calls queued between
        # synchronizes bound the memory the queued calls hold
        ('full-deployed', full_deployed, max(4, reps // 5), 2),
    ]
    total = int(lens.sum())
    timed = []
    if calls is None:
        calls = {}
    for name, fn, reps, inflight in candidates:
        out = fn(jb, jl)  # build the kernel + warm
        sync()
        calls[name] = 1

        def time_rounds(cap, rounds=4):
            # each call's outputs are dropped as soon as it is queued:
            # the synchronize closing a batch of ``cap`` calls waits for
            # all of them (valid timing), and the allocator reuses the
            # big body planes of a retired call instead of holding
            # REPEATS full-decode outputs (0.5-4 GiB each)
            dts = []
            for _ in range(rounds):
                t0 = time.perf_counter()
                done = 0
                while done < reps:
                    k = min(cap, reps - done)
                    for _ in range(k):
                        fn(jb, jl)
                        calls[name] += 1
                    sync()
                    done += k
                dts.append((time.perf_counter() - t0) / reps)
            return dts

        try:
            dts = time_rounds(inflight or reps)
        except torch.cuda.OutOfMemoryError as e:
            if inflight is None or inflight <= 1:
                raise
            # a device OOM mid-timing (big planes) must not kill the
            # flagship: serialize the calls and retry.  Only an OOM
            # qualifies — anything else is deterministic
            print(f'# {name}: timing at inflight={inflight} hit '
                  f'device OOM ({e!r}); retrying serialized',
                  file=sys.stderr)
            torch.cuda.empty_cache()
            dts = time_rounds(1)
        mibs = total / min(dts) / (1024 * 1024)
        timed.append((name, mibs, out))

    tick_best = full_best = full_deployed_best = 0.0
    for name, mibs, out in timed:
        # correctness gates, after ALL timing: a decode mismatch must
        # fail the benchmark
        if name == 'full':
            st, bd = out
            _gate_planes(st, bd, None, slots)
            _gate_differential(st, bd, None, pkts, slots,
                               max_data=16, max_path=8)
            full_best = mibs
        elif name == 'full-deployed':
            st, bd, lb = out
            _gate_planes(st, bd, lb, slots)
            _gate_differential(st, bd, lb, pkts, slots,
                               max_data=DEP_DATA, max_path=DEP_PATH)
            _gate_list_agreement(lb, streams, slots)
            full_deployed_best = mibs
        else:
            assert int(_np(out.n_frames).sum()) == B * FRAMES, \
                f'{name} decode mismatch'
            tick_best = mibs
        print(f'# {name} path: {mibs:.2f} MiB/s', file=sys.stderr)
    assert tick_best > 0, 'no tick path timed'
    assert full_best > 0, 'full-decode path never timed'
    assert full_deployed_best > 0, 'deployed-width path never timed'
    return tick_best, full_best, full_deployed_best


def _np(x) -> np.ndarray:
    """A host numpy copy of one plane (a torch tensor on any device)."""
    if hasattr(x, 'detach'):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _host_planes(planes, n):
    """First-``n``-streams host copy of a NamedTuple of [B, F, ...]
    device planes (slice on the device first: the full body planes are
    GiB-scale and only the checked subset needs to come back)."""
    return type(planes)(*[
        _host_planes(x, n) if hasattr(x, '_fields')
        else _np(x[:n]) for x in planes])


def _gate_planes(st, bd, lb, slots) -> None:
    """Plane-wide cheap gates over ALL streams: every frame found, and
    every slot's [B, F] summary planes uniform at the corpus's known
    per-slot ground truth (the per-byte field comparison happens on the
    checked subset in :func:`_gate_differential`)."""
    assert int(_np(st.n_frames).sum()) == B * FRAMES, \
        'full decode lost frames'
    data_len = _np(bd.data_len)
    data_ok = _np(bd.data_ok)
    sad_valid = _np(bd.stat_after_data.valid)
    for f, sl in enumerate(slots):
        if sl['kind'] == 'data':
            assert data_ok[:, f].all(), f'data_ok hole at slot {f}'
            assert (data_len[:, f] == DATA_LEN).all(), \
                f'data_len mismatch at slot {f}'
            assert sad_valid[:, f].all(), f'Stat hole at slot {f}'
    if lb is None:
        return
    ch_ok = _np(lb.ch_ok)
    ch_count = _np(lb.ch_count)
    sac_valid = _np(lb.stat_after_children.valid)
    acl_ok = _np(lb.acl_ok)
    acl_count = _np(lb.acl_count)
    saa_valid = _np(lb.stat_after_acl.valid)
    for f, sl in enumerate(slots):
        if sl['kind'] in ('children', 'children2'):
            n = CH2_N if sl['kind'] == 'children2' else CH_N
            assert ch_ok[:, f].all(), f'ch_ok hole at slot {f}'
            assert (ch_count[:, f] == n).all(), \
                f'ch_count mismatch at slot {f}'
            if sl['kind'] == 'children2':
                assert sac_valid[:, f].all(), \
                    f'children2 Stat hole at slot {f}'
        elif sl['kind'] == 'acl':
            assert acl_ok[:, f].all(), f'acl_ok hole at slot {f}'
            assert (acl_count[:, f] == ACL_N).all(), \
                f'acl_count mismatch at slot {f}'
            assert saa_valid[:, f].all(), f'ACL Stat hole at slot {f}'


def _gate_differential(st, bd, lb, pkts, slots, max_data: int,
                       max_path: int) -> None:
    """The differential gate: every frame of the
    checked subset must decode field-for-field to what the scalar codec
    (``records.read_response``) produced from the same bytes — headers,
    payload bytes (up to the plane width, with the true length reported
    either way), child lists, ACLs, notification fields, and Stats."""
    from .ops.replies import stat_from_planes
    from .protocol.consts import (
        KeeperState,
        NotificationType,
    )

    C = len(pkts)
    xids = _np(st.xids[:C])
    errs = _np(st.errs[:C])
    b = _host_planes(bd, C)
    lw = _host_planes(lb, C) if lb is not None else None
    for i, row in enumerate(pkts):
        assert len(row) == FRAMES
        for f, pkt in enumerate(row):
            sl = slots[f]
            op = pkt['opcode']
            assert op == sl['opcode'], (i, f, op)
            assert int(xids[i, f]) == pkt['xid'], (i, f)
            if pkt['err'] != 'OK':
                assert sl['kind'] == 'data_err' and int(errs[i, f]) != 0
                continue
            assert int(errs[i, f]) == 0, (i, f)
            if op == 'GET_DATA':
                n = len(pkt['data'])
                assert bool(b.data_ok[i, f])
                assert int(b.data_len[i, f]) == n
                k = min(n, max_data)
                assert bytes(b.data[i, f, :k]) == pkt['data'][:k]
                assert bool(b.stat_after_data.valid[i, f])
                assert stat_from_planes(b.stat_after_data, i, f) \
                    == pkt['stat'], (i, f)
            elif op == 'NOTIFICATION':
                assert NotificationType(int(b.ntype[i, f])).name \
                    == pkt['type']
                assert KeeperState(int(b.nstate[i, f])).name \
                    == pkt['state']
                path = pkt['path'].encode()
                assert bool(b.npath_ok[i, f])
                assert int(b.npath_len[i, f]) == len(path)
                k = min(len(path), max_path)
                assert bytes(b.npath[i, f, :k]) == path[:k]
            elif op in ('GET_CHILDREN', 'GET_CHILDREN2'):
                if lw is None:
                    continue                 # toy run: no list planes
                assert bool(lw.ch_ok[i, f]), (i, f)
                cnt = int(lw.ch_count[i, f])
                assert cnt == len(pkt['children'])
                got = [bytes(lw.ch_bytes[i, f, k,
                                         :int(lw.ch_len[i, f, k])]
                             ).decode() for k in range(cnt)]
                assert got == pkt['children'], (i, f)
                if op == 'GET_CHILDREN2':
                    assert bool(lw.stat_after_children.valid[i, f])
                    assert stat_from_planes(
                        lw.stat_after_children, i, f) == pkt['stat']
            elif op == 'GET_ACL':
                if lw is None:
                    continue
                assert bool(lw.acl_ok[i, f]), (i, f)
                cnt = int(lw.acl_count[i, f])
                assert cnt == len(pkt['acl'])
                for k in range(cnt):
                    want = pkt['acl'][k]
                    assert int(lw.acl_perms[i, f, k]) == int(want.perms)
                    assert bytes(lw.acl_scheme[
                        i, f, k, :int(lw.acl_scheme_len[i, f, k])]
                        ).decode() == want.id.scheme
                    assert bytes(lw.acl_id[
                        i, f, k, :int(lw.acl_id_len[i, f, k])]
                        ).decode() == want.id.id
                assert bool(lw.stat_after_acl.valid[i, f])
                assert stat_from_planes(lw.stat_after_acl, i, f) \
                    == pkt['stat']
            elif op == 'PING':
                pass
            else:
                raise AssertionError('unexpected opcode %r' % (op,))


def _scalar_children_walk(body: bytes, max_children: int,
                          max_name: int):
    """The scalar codec's speculative children-list read, mirroring
    exactly what the device plane promises to accept: a leading count
    within the static bound, then count jute buffers, each fitting the
    frame (negative length decodes as empty — the jute.py:182-183
    quirk) and no longer than the name plane.  Returns the element
    list, or None where the walk rejects."""
    from .protocol.jute import JuteReader

    r = JuteReader(body[16:])
    try:
        count = r.read_int()
        if count < 0 or count > max_children:
            return None
        out = []
        for _ in range(count):
            e = r.read_buffer()
            if len(e) > max_name:
                return None
            out.append(e)
        return out
    except Exception:
        return None


def _scalar_acl_walk(body: bytes, max_acls: int, max_scheme: int,
                     max_id: int):
    """Speculative ACL-list read with the device plane's bounds; see
    :func:`_scalar_children_walk`."""
    from .protocol.jute import JuteReader

    r = JuteReader(body[16:])
    try:
        count = r.read_int()
        if count < 0 or count > max_acls:
            return None
        out = []
        for _ in range(count):
            perms = r.read_int()
            scheme = r.read_buffer()
            ident = r.read_buffer()
            if len(scheme) > max_scheme or len(ident) > max_id:
                return None
            out.append((perms, scheme, ident))
        return out
    except Exception:
        return None


def _gate_list_agreement(lb, streams, slots) -> None:
    """The list planes' ok masks must agree with the scalar codec's
    speculative read over the same bytes — INCLUDING coincidental
    accepts, where a random GET_DATA payload legitimately parses as a
    list under the negative-length=>empty quirk (a gate asserting zero
    accepts could never pass on random payloads).  Checked over
    the scalar-subset streams: device-accept => scalar-accept with the
    same element count, and scalar ground truth (the corpus's genuine
    list slots) => device-accept, verified plane-wide in
    :func:`_gate_planes`."""
    C = min(SCALAR_FULL_STREAMS, len(streams))
    ch_ok = _np(lb.ch_ok[:C])
    ch_count = _np(lb.ch_count[:C])
    acl_ok = _np(lb.acl_ok[:C])
    acl_count = _np(lb.acl_count[:C])
    n_coincident = 0
    for i in range(C):
        s = streams[i]
        for f in np.nonzero(ch_ok[i])[0]:
            sl = slots[f]
            body = s[sl['off'] + 4:sl['off'] + 4 + sl['body_len']]
            walk = _scalar_children_walk(body, DEP_CHILDREN, DEP_NAME)
            assert walk is not None, \
                ('device ch_ok but scalar walk rejects', i, int(f))
            assert len(walk) == int(ch_count[i, f]), (i, int(f))
            if sl['kind'] not in ('children', 'children2'):
                n_coincident += 1
        for f in np.nonzero(acl_ok[i])[0]:
            sl = slots[f]
            body = s[sl['off'] + 4:sl['off'] + 4 + sl['body_len']]
            walk = _scalar_acl_walk(body, DEP_ACLS, DEP_SCHEME, DEP_ID)
            assert walk is not None, \
                ('device acl_ok but scalar walk rejects', i, int(f))
            assert len(walk) == int(acl_count[i, f]), (i, int(f))
    print('# list-plane agreement: %d coincidental accepts over %d '
          'frames, all scalar-confirmed' % (n_coincident, C * FRAMES),
          file=sys.stderr)


CLIENT_SCALES = (32, 128)  # fleet sizes for the runtime bench (the
                           # reference's, chosen from its crossover
                           # sweep, CROSSOVER.md; not yet re-measured
                           # on the card)
OPS_TOTAL = 1920           # measured ops per workload, fleet-wide


def _percentiles(lat_ms):
    lat_ms = sorted(lat_ms)

    def pct(p):
        return lat_ms[min(len(lat_ms) - 1,
                          int(p / 100.0 * len(lat_ms)))]
    return pct(50), pct(99)


async def _client_ops_run(mode: str, n_clients: int,
                          write_heavy: bool = False,
                          wal: str | None = None,
                          device: str = 'cuda') -> dict:
    """One end-to-end runtime measurement: ops/sec and latency
    percentiles for get/set/create plus a watch fan-out, with
    ``n_clients`` concurrent clients against the in-process server.

    Modes: ``python`` (pure-Python scalar codec, the reference-idiom
    baseline), ``native`` (C++ frame scanner), ``ingest`` (batched
    decode via FleetIngest on ``device``: kernel K1 on a card).
    ``write_heavy`` flips the op mix to SET_DATA/CREATE-dominated (the
    outbound-plane cell family, ``--write``); every cell also scrapes the flush-batch-size
    histograms (io/sendplane.py) from both planes.  ``wal`` attaches
    the durability plane (server/persist.py) at that fsync policy
    ('tick' | 'always' | 'never'; None = off — the `--wal`
    paired family) and scrapes its fsync-latency histogram into the
    cell.  An ``ingest`` cell reports the ingest's device ticks
    (``ingest_ticks``): one K1 launch each on a card."""
    import asyncio
    import shutil
    import tempfile

    from . import Client
    from .io.sendplane import scrape_flush_cells
    from .server import ZKServer

    ingest = None
    use_native = None
    if mode == 'ingest':
        from .io.ingest import FleetIngest
        # bypass_bytes=0: this mode exists to measure the batched
        # device pipeline end-to-end; the production small-tick
        # crossover would route this workload through the scalar codec
        # (which the python/native modes already measure).  max_frames
        # fleet-sized per CROSSOVER.md (oversized per-stream slots are
        # padding waste at fleet scale).
        ingest = FleetIngest(device=device, body_mode='host',
                             max_frames=8, bypass_bytes=0)
    elif mode == 'native':
        use_native = True
    elif mode == 'python':
        use_native = False

    loop = asyncio.get_running_loop()
    # one shared collector: every client's per-op latency lands in the
    # same zookeeper_op_latency_ms histogram, scraped into the result
    # below so BENCH_*.json carries histogram-derived p50/p99 per op
    # next to the workload-timed percentiles; the server shares it so
    # both planes' flush-batch histograms land in the same scrape
    from .utils.metrics import Collector
    collector = Collector()
    # WAL cells default to tmpfs (/dev/shm) when available: the paired
    # family isolates the durability PLANE's cost (encode + CRC32C +
    # group-commit machinery + ack gating) from the ambient device —
    # a container's network filesystem syncs slowly, an artifact of the
    # container, not of the design.  Point ZKSTREAM_BENCH_WAL_DIR at a
    # real data dir to measure a device-bound envelope instead; either
    # way the cell's fsync-latency histogram says which device it saw.
    wal_dir = None
    db = None
    if wal:
        base = os.environ.get('ZKSTREAM_BENCH_WAL_DIR') or (
            '/dev/shm' if os.path.isdir('/dev/shm') else None)
        wal_dir = tempfile.mkdtemp(prefix='zkbench-wal-', dir=base)
    else:
        # the off/baseline arm must stay WAL-free even when the
        # ambient ZKSTREAM_WAL_DIR default is set — an explicit db
        # skips the server's env resolution (and a shared ambient dir
        # would leak state between rounds on top of it)
        from .server import ZKDatabase
        db = ZKDatabase()
    srv = await ZKServer(db=db, collector=collector, wal_dir=wal_dir,
                         durability=wal).start()
    clients = [Client(address='127.0.0.1', port=srv.port,
                      session_timeout=30000, ingest=ingest,
                      use_native_codec=use_native,
                      collector=collector)
               for _ in range(n_clients)]
    for c in clients:
        c.start()
    await asyncio.gather(*[c.wait_connected(timeout=30)
                           for c in clients])
    out = {'mode': mode, 'conns': n_clients,
           'workload': 'write' if write_heavy else 'mixed'}
    if wal:
        out['wal'] = wal
    try:
        await clients[0].create('/b', b'x' * 64)
        if ingest is not None:
            # compile every (batch, length) bucket the workload can
            # touch up front: the bench measures the steady state, and
            # production servers do the same at startup (prewarm docs)
            bp = 8
            while bp <= n_clients:
                for nb in (None, 512):
                    await ingest.prewarm(bp, nb)
                bp *= 2

        # Warm the path before timing: connection steady state, and —
        # for the ingest — the jit cache across the padded batch-size
        # buckets the tick loop will hit.  Tolerant of a transient
        # disconnect (a client mid-resume raises ZKNotConnectedError;
        # on this single shared core a scheduling blip can trip one).
        from .protocol.errors import ZKNotConnectedError

        async def warm(c):
            for _attempt in range(3):
                try:
                    return await c.get('/b')
                except ZKNotConnectedError:
                    await c.wait_connected(timeout=30)
            return await c.get('/b')  # reconnected on the last wait
        for _ in range(5):
            await asyncio.gather(*[warm(c) for c in clients])

        async def timed(coro_fn, n):
            lat = []
            for _ in range(n):
                t0 = loop.time()
                await coro_fn()
                lat.append((loop.time() - t0) * 1000.0)
            return lat

        async def measure(name, coro_of, n_per_client):
            t0 = loop.time()
            lats = await asyncio.gather(*[
                timed(coro_of(c, i), n_per_client)
                for i, c in enumerate(clients)])
            dt = loop.time() - t0
            flat = [x for l in lats for x in l]
            p50, p99 = _percentiles(flat)
            out[name] = {
                'ops_per_sec': round(len(flat) / dt, 1),
                'p50_ms': round(p50, 3), 'p99_ms': round(p99, 3)}

        per = max(8, OPS_TOTAL // n_clients)
        seqs = [0] * n_clients

        def mk_create(c, i):
            async def run():
                seqs[i] += 1
                await c.create('/c%d-%d' % (i, seqs[i]), b'')
            return run
        if write_heavy:
            # SET_DATA/CREATE-dominated: the outbound plane's shape
            await measure('set',
                          lambda c, i: lambda: c.set('/b', b'y' * 64),
                          per)
            await measure('create', mk_create, per // 2)
            await measure('get', lambda c, i: lambda: c.get('/b'),
                          per // 4)
        else:
            await measure('get', lambda c, i: lambda: c.get('/b'),
                          per)
            await measure('set',
                          lambda c, i: lambda: c.set('/b', b'y' * 64),
                          per // 2)
            await measure('create', mk_create, per // 4)

        # watch fan-out: every client watches one node; one set fires
        # n_clients notifications + re-arm reads through the stack.
        # Arming a dataChanged watch on an existing node emits once
        # immediately (the arming read) — wait those out and reset so
        # the timed window measures only the real notifications.
        fired = []
        armed = loop.create_future()
        done = loop.create_future()

        def on_fire(*a):
            fired.append(1)
            if len(fired) >= n_clients:
                if not armed.done():
                    armed.set_result(None)
                elif len(fired) >= n_clients and not done.done():
                    done.set_result(None)
        for c in clients:
            c.watcher('/b').on('dataChanged', on_fire)
        await asyncio.wait_for(armed, 10)   # all arm-time emits in
        await asyncio.sleep(0.2)            # all watches re-armed
        fired.clear()
        t0 = loop.time()
        await clients[0].set('/b', b'z' * 64)
        await asyncio.wait_for(done, 10)
        dt = loop.time() - t0
        out['watch_fanout'] = {
            'events': len(fired),
            'events_per_sec': round(len(fired) / dt, 1),
            'total_ms': round(dt * 1000.0, 2)}
        if ingest is not None:
            out['ingest_ticks'] = ingest.ticks
            out['ingest_scalar_ticks'] = ingest.ticks_scalar
            # nonzero = a bucket miss sent timed ops through the
            # scalar drain while its program compiled; published so
            # 'ingest'-labeled numbers are honest about it
            out['ingest_warming_ticks'] = ingest.ticks_warming
            out['ingest_frames'] = ingest.frames_routed

        # Per-op latency distribution from the production histogram
        # (zookeeper_op_latency_ms, every completion path, warm-up
        # and watch re-arm reads included): the same series a scrape
        # of a live deployment shows, published alongside the
        # workload-timed percentiles above so the two views are
        # cross-checkable in BENCH_*.json.
        hist = collector.get_collector('zookeeper_op_latency_ms')
        ops_hist = {}
        for key in hist.label_keys():
            labels = dict(key)
            opname = labels.get('op', '')
            n = hist.count(labels)
            if not n:
                continue
            ops_hist[opname.lower()] = {
                'count': n,
                'p50_ms': round(hist.percentile(50, labels), 3),
                'p99_ms': round(hist.percentile(99, labels), 3),
            }
        out['op_latency_hist'] = ops_hist
        # Flush-batch-size distributions (io/sendplane.py), both
        # planes — the coalescing observability the write-heavy cells
        # exist to publish.
        out['flush_batches'] = scrape_flush_cells(collector)
        # The tick ledger (utils/metrics.TickLedger): what fraction of
        # each busy loop tick the decode/fsync/cork/fan-out planes
        # ate — the per-cell phase table PROFILE.md's accept-shard and
        # io_uring items are gated on.
        from .utils.metrics import scrape_tick_cells
        if srv.ledger is not None:
            srv.ledger.close_tick()   # flush the residual burst
        tick = scrape_tick_cells(collector)
        if tick:
            out['tick_ledger'] = tick
        if wal:
            from .server.persist import scrape_wal_cells
            out['wal_stats'] = scrape_wal_cells(collector)
            out['wal_stats']['sync_errors'] = srv.db.wal.sync_errors
    finally:
        await asyncio.gather(*[c.close() for c in clients])
        await srv.stop()
        if srv.db.wal is not None:
            srv.db.wal.close()
        if wal_dir is not None:
            shutil.rmtree(wal_dir, ignore_errors=True)
    return out


def bench_client_ops(write_heavy: bool = False,
                     device: str = 'cuda') -> None:
    """End-to-end runtime numbers: the full asyncio client stack
    against the in-process server, per codec mode (the ``ingest`` arm
    on ``device``).  Secondary metrics: printed to stderr, one JSON
    line per mode, after the flagship decode numbers are measured.

    ``write_heavy`` runs the SET_DATA/CREATE-dominated cell family
    instead (`--write`); the headline op becomes ``set``."""
    import asyncio

    from .utils import native

    headline = 'set' if write_heavy else 'get'
    modes = ['python']
    if native.ensure_lib() is not None:
        modes.append('native')
    modes.append('ingest')
    results: dict = {}
    # Interleaved best-of-2 per cell: this image runs everything on one
    # shared core, so a single sequential pass can swing +-30% on
    # scheduling noise alone.
    for _ in range(2):
        for n in CLIENT_SCALES:
            for mode in modes:
                try:
                    r = asyncio.run(_client_ops_run(
                        mode, n, write_heavy=write_heavy,
                        device=device))
                except Exception as e:
                    # a failed round must not kill the already-printed
                    # headline metric; the other round still reports
                    print('# client_ops %s@%d round failed: %r'
                          % (mode, n, e), file=sys.stderr)
                    continue
                key = (mode, n)
                if (key not in results
                        or r[headline]['ops_per_sec']
                        > results[key][headline]['ops_per_sec']):
                    results[key] = r
    for n in CLIENT_SCALES:
        for mode in modes:
            if (mode, n) in results:
                print('# client_ops %s'
                      % json.dumps(results[(mode, n)]), file=sys.stderr)
    for n in CLIENT_SCALES:
        cell = {m: results[(m, n)] for m in modes if (m, n) in results}
        if not cell:
            continue
        base = cell.get('python', {}).get(headline,
                                          {}).get('ops_per_sec')
        best_mode = max(
            cell, key=lambda m: cell[m][headline]['ops_per_sec'])
        best = cell[best_mode][headline]['ops_per_sec']
        print(json.dumps({
            'metric': 'client_%s_ops_per_sec' % (headline,),
            'conns': n,
            'value': best,
            'unit': 'ops/s',
            'vs_baseline': round(best / base, 3) if base else None,
            'mode': best_mode,
        }), file=sys.stderr)


#: `--wal` fleet sizes (the acceptance envelope: sync=tick
#: must not be significantly slower than wal-off at 16 and 64).
WAL_SCALES = (16, 64)
WAL_ARMS = (None, 'tick', 'always')


def bench_wal() -> None:
    """The durability plane's cost envelope (`--wal`):
    paired write-heavy cells — wal-off vs sync=tick (group commit:
    one fsync per tick, riding the send-plane cork) vs sync=always
    (one fsync per txn) — at fleet 16/64, with the fsync-latency
    histogram scraped into every wal cell.  Per-round adjacent A/B/C
    runs, sign of the per-round headline (set ops/s) delta, exact
    two-sided sign test; the measured table lives in PROFILE.md
    "Durability plane"."""
    import asyncio

    from .utils import native
    from .utils.metrics import sign_test_p

    mode = 'native' if native.ensure_lib() is not None else 'python'
    rounds = int(os.environ.get('ZKSTREAM_BENCH_WAL_ROUNDS', '10'))
    # rows[(conns, arm)] -> list of per-round set-ops/s
    rows: dict = {}
    cells: dict = {}
    for rnd in range(rounds):
        for n in WAL_SCALES:
            for arm in WAL_ARMS:
                try:
                    r = asyncio.run(_client_ops_run(
                        mode, n, write_heavy=True, wal=arm))
                except Exception as e:
                    print('# wal cell %s@%d round failed: %r'
                          % (arm or 'off', n, e), file=sys.stderr)
                    continue
                key = (n, arm or 'off')
                rows.setdefault(key, []).append(
                    r['set']['ops_per_sec'])
                if key not in cells or r['set']['ops_per_sec'] > \
                        cells[key]['set']['ops_per_sec']:
                    cells[key] = r
    for key in sorted(cells, key=str):
        print('# wal_cell %s' % json.dumps(cells[key]),
              file=sys.stderr)
    for n in WAL_SCALES:
        for a_arm, b_arm, label in (
                ('tick', 'off', 'tick-vs-off'),
                ('always', 'tick', 'always-vs-tick'),
                ('always', 'off', 'always-vs-off')):
            a = rows.get((n, a_arm), [])
            b = rows.get((n, b_arm), [])
            if not a or not b:
                continue
            paired = list(zip(a, b))
            deltas = [(x - y) / y * 100.0 for x, y in paired if y]
            wins = sum(1 for x, y in paired if x > y)
            losses = sum(1 for x, y in paired if x < y)
            print(json.dumps({
                'metric': 'wal_group_commit_sign_test',
                'pair': label,
                'conns': n,
                'rounds': len(paired),
                'wins': wins,
                'losses': losses,
                'mean_delta_pct': round(sum(deltas)
                                        / max(1, len(deltas)), 1),
                'sign_p': round(sign_test_p(wins, losses), 4),
            }), flush=True)


#: `--election` ensemble sizes: does failover time move with
#: membership (more voters, same one-round tally)?
ELECTION_SCALES = (3, 5)


async def _election_round(members: int, heartbeat_ms: int = 40
                          ) -> dict:
    """One failover measurement: fresh in-process ensemble + client,
    kill the leader, time (a) the election itself (zk_election_ms —
    detection to promotion inside the coordinator) and (b) the
    client-observed failover (kill to the first acked write through
    the elected successor)."""
    import asyncio as aio
    import time as _t

    from . import Client
    from .protocol.errors import ZKError, ZKProtocolError
    from .server import ZKEnsemble
    from .server.election import METRIC_ELECTION
    from .utils.metrics import Collector

    collector = Collector()
    ens = await ZKEnsemble(members, heartbeat_ms=heartbeat_ms,
                           seed=members, collector=collector).start()
    c = Client(servers=ens.addresses(), shuffle_backends=False,
               session_timeout=8000)
    c.start()
    try:
        await c.wait_connected(timeout=10)
        await c.create('/warm', b'w')
        elected = aio.get_running_loop().create_future()
        ens.election.on(
            'elected',
            lambda m, e, d: (not elected.done()
                             and elected.set_result(d)))
        t0 = _t.perf_counter()
        await ens.kill(0)
        election_ms = await aio.wait_for(elected, 15)
        # client-observed: first acked write through the successor
        while True:
            try:
                await c.set('/warm', b'x', version=-1)
                break
            except (ZKError, ZKProtocolError):
                await aio.sleep(0.01)
        failover_ms = (_t.perf_counter() - t0) * 1000.0
        hist = collector.get_collector(METRIC_ELECTION)
        return {'members': members,
                'election_ms': round(election_ms, 3),
                'election_p50_ms': round(hist.percentile(50), 3),
                'failover_ms': round(failover_ms, 3)}
    finally:
        await c.close()
        await ens.stop()


def bench_election() -> None:
    """The coordination plane's failover envelope (``--election``):
    paired leader-kill cells at 3- vs 5-member
    ensembles — per-round adjacent A/B runs, exact two-sided sign
    test on the client-observed failover time, zk_election_ms
    distribution per cell.  Rounds via
    ZKSTREAM_BENCH_ELECTION_ROUNDS."""
    import asyncio

    from .utils.metrics import sign_test_p

    rounds = int(os.environ.get('ZKSTREAM_BENCH_ELECTION_ROUNDS',
                                '10'))
    rows: dict = {n: [] for n in ELECTION_SCALES}
    cells: dict = {}
    paired_rounds: list = []
    for _rnd in range(rounds):
        this_round: dict = {}
        for n in ELECTION_SCALES:
            try:
                r = asyncio.run(_election_round(n))
            except Exception as e:
                print('# election cell members=%d round failed: %r'
                      % (n, e), file=sys.stderr)
                continue
            rows[n].append(r['failover_ms'])
            this_round[n] = r['failover_ms']
            if n not in cells or r['failover_ms'] \
                    < cells[n]['failover_ms']:
                cells[n] = r
        if len(this_round) == len(ELECTION_SCALES):
            # only rounds where EVERY arm completed pair up — a
            # failed cell must not shift later rounds against
            # earlier ones (the adjacent-pairing contract)
            paired_rounds.append(tuple(this_round[n]
                                       for n in ELECTION_SCALES))
    for n in sorted(cells):
        print('# election_cell %s' % json.dumps(cells[n]),
              file=sys.stderr)

    for n in ELECTION_SCALES:
        if rows[n]:
            p50, p99 = _percentiles(rows[n])
            print(json.dumps({
                'metric': 'election_failover_ms',
                'members': n,
                'rounds': len(rows[n]),
                'p50_ms': round(p50, 3),
                'p99_ms': round(p99, 3),
            }), flush=True)
    paired = paired_rounds
    if paired:
        wins = sum(1 for x, y in paired if x < y)   # 3-member faster
        losses = sum(1 for x, y in paired if x > y)
        deltas = [(y - x) / x * 100.0 for x, y in paired if x]
        print(json.dumps({
            'metric': 'election_members_sign_test',
            'pair': '%d-vs-%d-members' % ELECTION_SCALES,
            'rounds': len(paired),
            'wins_smaller_faster': wins,
            'losses': losses,
            'mean_delta_pct': round(sum(deltas)
                                    / max(1, len(deltas)), 1),
            'sign_p': round(sign_test_p(wins, losses), 4),
        }), flush=True)


#: `--reconfig` per-arm write counts: each arm keeps
#: writing until the concurrent membership change completes, with at
#: least MIN and at most CAP acked sets, so the paired p50s compare
#: like against like while the cell stays bounded.
RECONFIG_MIN_OPS = 60
RECONFIG_CAP_OPS = 400


async def _reconfig_round(idx: int) -> dict:
    """One dynamic-membership cell: fresh 3-voter + 1-observer
    in-process ensemble, one client writing sequentially.  Three
    adjacent arms on the same ensemble: steady state, during an
    OBSERVER JOIN (snapshot bootstrap + attach + CONTROL record),
    and during a VOTER REPLACE (joint-majority handoff).  Returns
    per-arm write p50 plus the wall duration of each change."""
    import asyncio as aio
    import time as _t

    from . import Client
    from .server import ZKEnsemble

    ens = await ZKEnsemble(3, observers=1, seed=300 + idx).start()
    c = Client(servers=ens.addresses(), shuffle_backends=False,
               session_timeout=8000)
    c.start()

    def p50(lats: list) -> float:
        return sorted(lats)[len(lats) // 2]

    async def burst(until=None) -> list:
        """Sequential acked sets; with ``until`` keeps writing while
        the membership change runs (>= MIN, <= CAP ops)."""
        lats = []
        i = 0
        while True:
            t0 = _t.perf_counter()
            await c.set('/rw', b'x%d' % (i,), version=-1)
            lats.append((_t.perf_counter() - t0) * 1000.0)
            i += 1
            if until is None:
                if i >= RECONFIG_MIN_OPS:
                    return lats
            elif (until.done() and i >= RECONFIG_MIN_OPS) \
                    or i >= RECONFIG_CAP_OPS:
                return lats

    try:
        await c.wait_connected(timeout=10)
        await c.create('/rw', b'w')
        steady = await burst()
        t0 = _t.perf_counter()
        join = aio.ensure_future(ens.add_observer())
        during_join = await burst(until=join)
        await join
        join_ms = (_t.perf_counter() - t0) * 1000.0
        t0 = _t.perf_counter()
        rep = aio.ensure_future(ens.replace_voter(2))
        during_replace = await burst(until=rep)
        await rep
        replace_ms = (_t.perf_counter() - t0) * 1000.0
        return {'steady_p50_ms': round(p50(steady), 3),
                'join_p50_ms': round(p50(during_join), 3),
                'replace_p50_ms': round(p50(during_replace), 3),
                'observer_join_ms': round(join_ms, 3),
                'voter_replace_ms': round(replace_ms, 3),
                'config_version': ens.db.config_version}
    finally:
        await c.close()
        await ens.stop()


def bench_reconfig() -> None:
    """The dynamic-membership cost envelope (`--reconfig`):
    per-round adjacent steady / during-observer-join /
    during-voter-replace write cells on one ensemble, exact
    two-sided sign tests against the steady arm.  The acceptance bar
    (README "Dynamic membership") is that the OBSERVER JOIN arm is
    NOT significantly slower — an observer never widens the write
    quorum, so attaching one must not tax the write path.  The voter
    replace arm is reported without a bar: a joint window briefly
    holds writes to two majorities by design.  Rounds via
    ZKSTREAM_BENCH_RECONFIG_ROUNDS."""
    import asyncio

    from .utils.metrics import sign_test_p

    rounds = int(os.environ.get('ZKSTREAM_BENCH_RECONFIG_ROUNDS',
                                '10'))
    rows: dict = {'steady': [], 'join': [], 'replace': []}
    durs: dict = {'observer_join_ms': [], 'voter_replace_ms': []}
    paired: list = []
    for rnd in range(rounds):
        try:
            r = asyncio.run(_reconfig_round(rnd))
        except Exception as e:
            print('# reconfig round %d failed: %r' % (rnd, e),
                  file=sys.stderr)
            continue
        print('# reconfig_cell %s' % json.dumps(r), file=sys.stderr)
        rows['steady'].append(r['steady_p50_ms'])
        rows['join'].append(r['join_p50_ms'])
        rows['replace'].append(r['replace_p50_ms'])
        durs['observer_join_ms'].append(r['observer_join_ms'])
        durs['voter_replace_ms'].append(r['voter_replace_ms'])
        paired.append((r['steady_p50_ms'], r['join_p50_ms'],
                       r['replace_p50_ms']))
    for arm in ('steady', 'join', 'replace'):
        if rows[arm]:
            p50, p99 = _percentiles(rows[arm])
            print(json.dumps({
                'metric': 'reconfig_write_p50_ms',
                'arm': arm,
                'rounds': len(rows[arm]),
                'p50_ms': round(p50, 3),
                'p99_ms': round(p99, 3),
            }), flush=True)
    for name, vals in durs.items():
        if vals:
            p50, p99 = _percentiles(vals)
            print(json.dumps({
                'metric': name, 'rounds': len(vals),
                'p50_ms': round(p50, 3), 'p99_ms': round(p99, 3),
            }), flush=True)
    for arm, col in (('join', 1), ('replace', 2)):
        if not paired:
            continue
        wins = sum(1 for t in paired if t[col] > t[0])   # arm slower
        losses = sum(1 for t in paired if t[col] < t[0])
        deltas = [(t[col] - t[0]) / t[0] * 100.0
                  for t in paired if t[0]]
        print(json.dumps({
            'metric': 'reconfig_%s_sign_test' % (arm,),
            'pair': 'steady-vs-during-%s' % (arm,),
            'rounds': len(paired),
            'slower': wins,
            'faster': losses,
            'mean_delta_pct': round(sum(deltas)
                                    / max(1, len(deltas)), 1),
            'sign_p': round(sign_test_p(wins, losses), 4),
        }), flush=True)


#: `--quorum` ensemble sizes (the acceptance envelope:
#: quorum-on must not be significantly slower than quorum-off at
#: either membership — with synchronous in-process replicas the gate
#: clears at flush time and its cost is bookkeeping).
QUORUM_SCALES = (3, 5)
#: MULTI batching cells: one multi of K creates vs K pipelined
#: singleton creates (same client, same server, adjacent runs).
MULTI_BATCHES = (4, 16)
QUORUM_OPS = 200


async def _quorum_round(members: int, quorum_on: bool) -> dict:
    """One write-heavy cell against a fresh in-process ensemble with
    the quorum gate on or off: sequential acked sets through the
    leader, headline set ops/s plus the zk_quorum_ack_ms scrape."""
    import asyncio as aio

    from . import Client
    from .server import ZKEnsemble
    from .server.replication import METRIC_QUORUM_ACK
    from .utils.metrics import Collector

    collector = Collector()
    ens = await ZKEnsemble(members, quorum=quorum_on,
                           collector=collector).start()
    c = Client(servers=ens.addresses(), shuffle_backends=False,
               session_timeout=8000)
    c.start()
    loop = aio.get_running_loop()
    try:
        await c.wait_connected(timeout=10)
        await c.create('/q', b'w')
        for _ in range(10):
            await c.set('/q', b'warm', version=-1)
        t0 = loop.time()
        for i in range(QUORUM_OPS):
            await c.set('/q', b'v%d' % (i,), version=-1)
        dt = loop.time() - t0
        out = {'members': members,
               'quorum': 'on' if quorum_on else 'off',
               'set': {'ops_per_sec': round(QUORUM_OPS / dt, 1)}}
        if quorum_on:
            hist = collector.get_collector(METRIC_QUORUM_ACK)
            n = hist.count()
            if n:
                out['quorum_ack'] = {
                    'count': n,
                    'p50_ms': round(hist.percentile(50), 3),
                    'p99_ms': round(hist.percentile(99), 3)}
            out['quorum_degraded'] = ens.quorum.degraded_releases
        return out
    finally:
        await c.close()
        await ens.stop()


async def _multi_round(k: int) -> dict:
    """One batching cell: K pipelined singleton creates vs ONE multi
    of K creates, adjacent on the same client/server — sub-op
    throughput both ways."""
    import asyncio as aio

    from . import Client
    from .server import ZKServer

    srv = await ZKServer().start()
    c = Client(address='127.0.0.1', port=srv.port)
    c.start()
    loop = aio.get_running_loop()
    try:
        await c.wait_connected(timeout=10)
        await c.create('/warm', b'')
        reps = max(1, 64 // k)
        t0 = loop.time()
        for r in range(reps):
            await aio.gather(*[
                c.create('/s%d-%d' % (r, i), b'x')
                for i in range(k)])
        dt_single = loop.time() - t0
        t0 = loop.time()
        for r in range(reps):
            await c.multi([
                {'op': 'create', 'path': '/m%d-%d' % (r, i),
                 'data': b'x'}
                for i in range(k)])
        dt_multi = loop.time() - t0
        n = reps * k
        return {'batch': k,
                'singleton_subops_per_sec': round(n / dt_single, 1),
                'multi_subops_per_sec': round(n / dt_multi, 1)}
    finally:
        await c.close()
        await srv.stop()


def bench_quorum() -> None:
    """The quorum-commit cost envelope (`--quorum`): paired
    quorum-on/off write-heavy cells at 3/5 members, plus
    MULTI-vs-N-singletons batching cells — per-round adjacent runs,
    exact two-sided sign tests (the acceptance bar: neither quorum-on
    nor MULTI significantly slower in any paired cell).  Rounds via
    ZKSTREAM_BENCH_QUORUM_ROUNDS; the measured table lives in
    PROFILE.md "Quorum commit"."""
    import asyncio

    from .utils.metrics import sign_test_p

    rounds = int(os.environ.get('ZKSTREAM_BENCH_QUORUM_ROUNDS', '10'))
    rows: dict = {}
    cells: dict = {}
    mrows: dict = {k: [] for k in MULTI_BATCHES}
    for _rnd in range(rounds):
        for n in QUORUM_SCALES:
            for q_on in (True, False):
                try:
                    r = asyncio.run(_quorum_round(n, q_on))
                except Exception as e:
                    print('# quorum cell %s@%d round failed: %r'
                          % ('on' if q_on else 'off', n, e),
                          file=sys.stderr)
                    continue
                key = (n, 'on' if q_on else 'off')
                rows.setdefault(key, []).append(
                    r['set']['ops_per_sec'])
                if key not in cells or r['set']['ops_per_sec'] > \
                        cells[key]['set']['ops_per_sec']:
                    cells[key] = r
        for k in MULTI_BATCHES:
            try:
                r = asyncio.run(_multi_round(k))
            except Exception as e:
                print('# multi cell batch=%d round failed: %r'
                      % (k, e), file=sys.stderr)
                continue
            mrows[k].append((r['multi_subops_per_sec'],
                             r['singleton_subops_per_sec']))
            mkey = ('multi', k)
            if mkey not in cells or r['multi_subops_per_sec'] > \
                    cells[mkey]['multi_subops_per_sec']:
                cells[mkey] = r
    for key in sorted(cells, key=str):
        print('# quorum_cell %s' % json.dumps(cells[key]),
              file=sys.stderr)
    for n in QUORUM_SCALES:
        a = rows.get((n, 'on'), [])
        b = rows.get((n, 'off'), [])
        if not a or not b:
            continue
        paired = list(zip(a, b))
        deltas = [(x - y) / y * 100.0 for x, y in paired if y]
        wins = sum(1 for x, y in paired if x > y)
        losses = sum(1 for x, y in paired if x < y)
        print(json.dumps({
            'metric': 'quorum_commit_sign_test',
            'pair': 'on-vs-off',
            'members': n,
            'rounds': len(paired),
            'wins': wins,
            'losses': losses,
            'mean_delta_pct': round(sum(deltas)
                                    / max(1, len(deltas)), 1),
            'sign_p': round(sign_test_p(wins, losses), 4),
        }), flush=True)
    for k in MULTI_BATCHES:
        paired = mrows[k]
        if not paired:
            continue
        deltas = [(x - y) / y * 100.0 for x, y in paired if y]
        wins = sum(1 for x, y in paired if x > y)
        losses = sum(1 for x, y in paired if x < y)
        print(json.dumps({
            'metric': 'multi_batching_sign_test',
            'pair': 'multi-vs-%d-singletons' % (k,),
            'batch': k,
            'rounds': len(paired),
            'wins': wins,
            'losses': losses,
            'mean_delta_pct': round(sum(deltas)
                                    / max(1, len(deltas)), 1),
            'sign_p': round(sign_test_p(wins, losses), 4),
        }), flush=True)


#: `--traceov` fleet sizes (the acceptance envelope: the
#: server trace plane — member span rings + tick ledger — must not be
#: significantly slower than the untraced arm at either scale).
TRACE_SCALES = (16, 64)


def bench_trace_overhead() -> None:
    """The server trace plane's cost envelope (`--traceov`):
    paired write-heavy cells — trace plane on (the default: member
    span rings + tick ledger) vs ``ZKSTREAM_NO_SERVER_TRACE=1`` — at
    fleet 16/64.  Per-round adjacent A/B runs with the arm order
    ALTERNATING per round: the first cell of an adjacent pair can run
    slower regardless of arm (an A/A probe of the reference showed a
    first-slot penalty), and a fixed order folds that bias straight
    into the sign test.  Sign of
    the per-round headline (set ops/s) delta, exact two-sided sign
    test: otherwise the same PROFILE.md methodology as the cork, WAL
    and fan-out families."""
    import asyncio

    from .utils import native
    from .utils.metrics import sign_test_p

    mode = 'native' if native.ensure_lib() is not None else 'python'
    rounds = int(os.environ.get('ZKSTREAM_BENCH_TRACE_ROUNDS', '10'))
    # the arms toggle the env var the server reads at construction;
    # snapshot and restore any operator-set value, and force BOTH
    # states explicitly — an inherited ZKSTREAM_NO_SERVER_TRACE=1
    # would otherwise turn the traced arm into a second untraced one
    ambient = os.environ.get('ZKSTREAM_NO_SERVER_TRACE')
    rows: dict = {}
    cells: dict = {}
    try:
        for rnd in range(rounds):
            arms = (('traced', 'untraced') if rnd % 2 == 0
                    else ('untraced', 'traced'))
            for n in TRACE_SCALES:
                # the sign test pairs ADJACENT A/B runs: a round where
                # either arm failed contributes to neither, so the
                # surviving pairs stay aligned round-for-round (the
                # fan-out family's rule)
                pair: dict = {}
                for arm in arms:
                    if arm == 'untraced':
                        os.environ['ZKSTREAM_NO_SERVER_TRACE'] = '1'
                    else:
                        os.environ.pop('ZKSTREAM_NO_SERVER_TRACE',
                                       None)
                    try:
                        r = asyncio.run(_client_ops_run(
                            mode, n, write_heavy=True))
                    except Exception as e:
                        print('# trace cell %s@%d round failed: %r'
                              % (arm, n, e), file=sys.stderr)
                        continue
                    r['trace_arm'] = arm
                    pair[arm] = r
                for arm, r in pair.items():
                    key = (n, arm)
                    if len(pair) == 2:
                        rows.setdefault(key, []).append(
                            r['set']['ops_per_sec'])
                    if key not in cells or r['set']['ops_per_sec'] > \
                            cells[key]['set']['ops_per_sec']:
                        cells[key] = r
    finally:
        if ambient is None:
            os.environ.pop('ZKSTREAM_NO_SERVER_TRACE', None)
        else:
            os.environ['ZKSTREAM_NO_SERVER_TRACE'] = ambient
    for key in sorted(cells, key=str):
        print('# trace_cell %s' % json.dumps(cells[key]),
              file=sys.stderr)
    for n in TRACE_SCALES:
        a = rows.get((n, 'traced'), [])
        b = rows.get((n, 'untraced'), [])
        if not a or not b:
            continue
        paired = list(zip(a, b))
        deltas = [(x - y) / y * 100.0 for x, y in paired if y]
        wins = sum(1 for x, y in paired if x > y)
        losses = sum(1 for x, y in paired if x < y)
        print(json.dumps({
            'metric': 'trace_plane_sign_test',
            'pair': 'traced-vs-untraced',
            'conns': n,
            'rounds': len(paired),
            'wins': wins,
            'losses': losses,
            'mean_delta_pct': round(sum(deltas)
                                    / max(1, len(deltas)), 1),
            'sign_p': round(sign_test_p(wins, losses), 4),
        }), flush=True)


#: `--blackbox` fleet sizes (the acceptance envelope: the
#: flight recorder — periodic frames + slow-op digest off the hot
#: path — must not be significantly slower than the recorder-off arm
#: at either scale).
BLACKBOX_SCALES = (16, 64)


def bench_blackbox_overhead() -> None:
    """The black-box plane's cost envelope (`--blackbox`):
    paired write-heavy WAL-backed cells — flight recorder on (the
    default: periodic snapshot frames + slow-op digest, written on
    the executor) vs ``ZKSTREAM_NO_BLACKBOX=1`` — at fleet 16/64.
    WAL 'tick' cells on purpose: only a server with a wal_dir has a
    recorder at all, and the recorder shares the executor with the
    group fsync — the one interaction that could plausibly cost.
    Per-round adjacent A/B with the arm order ALTERNATING per round
    (the first-slot penalty rationale in bench_trace_overhead), sign
    of the per-round set-ops/s delta, exact two-sided sign test —
    the PROFILE.md methodology shared by every paired family."""
    import asyncio

    from .utils import native
    from .utils.metrics import sign_test_p

    mode = 'native' if native.ensure_lib() is not None else 'python'
    rounds = int(os.environ.get('ZKSTREAM_BENCH_BLACKBOX_ROUNDS',
                                '10'))
    # both arm states forced explicitly, ambient value restored — an
    # inherited ZKSTREAM_NO_BLACKBOX=1 would silently turn the
    # recorded arm into a second unrecorded one
    ambient = os.environ.get('ZKSTREAM_NO_BLACKBOX')
    rows: dict = {}
    cells: dict = {}
    try:
        for rnd in range(rounds):
            arms = (('blackbox', 'nobox') if rnd % 2 == 0
                    else ('nobox', 'blackbox'))
            for n in BLACKBOX_SCALES:
                pair: dict = {}
                for arm in arms:
                    if arm == 'nobox':
                        os.environ['ZKSTREAM_NO_BLACKBOX'] = '1'
                    else:
                        os.environ.pop('ZKSTREAM_NO_BLACKBOX', None)
                    try:
                        r = asyncio.run(_client_ops_run(
                            mode, n, write_heavy=True, wal='tick'))
                    except Exception as e:
                        print('# blackbox cell %s@%d round failed: '
                              '%r' % (arm, n, e), file=sys.stderr)
                        continue
                    r['blackbox_arm'] = arm
                    pair[arm] = r
                for arm, r in pair.items():
                    key = (n, arm)
                    if len(pair) == 2:
                        # adjacent pairs only: a round where either
                        # arm failed contributes to neither
                        rows.setdefault(key, []).append(
                            r['set']['ops_per_sec'])
                    if key not in cells or r['set']['ops_per_sec'] \
                            > cells[key]['set']['ops_per_sec']:
                        cells[key] = r
    finally:
        if ambient is None:
            os.environ.pop('ZKSTREAM_NO_BLACKBOX', None)
        else:
            os.environ['ZKSTREAM_NO_BLACKBOX'] = ambient
    for key in sorted(cells, key=str):
        print('# blackbox_cell %s' % json.dumps(cells[key]),
              file=sys.stderr)
    for n in BLACKBOX_SCALES:
        a = rows.get((n, 'blackbox'), [])
        b = rows.get((n, 'nobox'), [])
        if not a or not b:
            continue
        paired = list(zip(a, b))
        deltas = [(x - y) / y * 100.0 for x, y in paired if y]
        wins = sum(1 for x, y in paired if x > y)
        losses = sum(1 for x, y in paired if x < y)
        print(json.dumps({
            'metric': 'blackbox_plane_sign_test',
            'pair': 'blackbox-vs-off',
            'conns': n,
            'rounds': len(paired),
            'wins': wins,
            'losses': losses,
            'mean_delta_pct': round(sum(deltas)
                                    / max(1, len(deltas)), 1),
            'sign_p': round(sign_test_p(wins, losses), 4),
        }), flush=True)


#: `--overload` fleet sizes for the plane-overhead family
#: (the acceptance envelope: the overload plane's accounting must not
#: be significantly slower than ``ZKSTREAM_NO_OVERLOAD=1``).
OVERLOAD_SCALES = (16, 64)
#: Stalled pipelining readers per defense cell, and the reads each
#: one aims at the member's tx account (32 KiB replies apiece).
OVERLOAD_STALLED = 3
OVERLOAD_STALLED_READS = 60


async def _overload_defense_round(defense: bool) -> dict:
    """One stalled-consumer defense cell: a writer fans out sets to a
    healthy watcher while OVERLOAD_STALLED subscribers stop reading
    and pipeline fat gets — the wedged-socket reply backlog the hard
    watermark exists for.  Returns the writer's set throughput, the
    healthy watcher's observed fires, the peak per-connection tx
    backlog the member carried, and the defense counters (zero on the
    no-defense arm, where the backlog is the point of the row)."""
    import asyncio
    import time as _time

    from . import Client
    from .io.backoff import BackoffPolicy
    from .io.overload import OverloadConfig
    from .server import ZKServer

    fast = dict(
        connect_policy=BackoffPolicy(timeout=300, retries=2, delay=30,
                                     cap=200),
        default_policy=BackoffPolicy(timeout=500, retries=3, delay=20,
                                     cap=120))
    if defense:
        srv = await ZKServer(overload_config=OverloadConfig(
            tx_soft=8 * 1024, tx_hard=64 * 1024)).start()
    else:
        srv = await ZKServer(overload=False).start()
    cls = [Client(address='127.0.0.1', port=srv.port, **fast)
           for _ in range(2 + OVERLOAD_STALLED)]
    writer, healthy, stalled = cls[0], cls[1], cls[2:]
    pending: list = []
    try:
        for c in cls:
            c.start()
            await c.wait_connected(timeout=5)
        await writer.create('/fan', b'f')
        await writer.create('/big', b'p' * (32 * 1024))
        fires: list = []
        healthy.watcher('/fan').on(
            'dataChanged', lambda data, stat: fires.append(1))
        while not fires:
            await asyncio.sleep(0.005)
        import socket as socketmod
        for c in stalled:
            tr = c.current_connection().transport
            sock = tr.get_extra_info('socket')
            if sock is not None:
                # shrink the stalled reader's receive window so the
                # kernel can't mask the backlog — the member's own tx
                # account is what the cell measures
                sock.setsockopt(socketmod.SOL_SOCKET,
                                socketmod.SO_RCVBUF, 4096)
            tr.pause_reading()
            pending.extend(asyncio.ensure_future(c.get('/big'))
                           for _ in range(OVERLOAD_STALLED_READS))
        await asyncio.sleep(0)
        # a tight background sampler: the cork drains at tick
        # boundaries, so only a between-callbacks probe sees the real
        # backlog crest (post-await samples always land after flush)
        peak = [0]

        async def _sample() -> None:
            while True:
                peak[0] = max(peak[0], max(
                    (c._tx.buffered_bytes() for c in srv.conns
                     if not c.closed), default=0))
                await asyncio.sleep(0)
        sampler = asyncio.ensure_future(_sample())
        t0 = _time.perf_counter()
        for _ in range(100):
            await writer.set('/fan', b'f', version=-1)
        dt = _time.perf_counter() - t0
        sampler.cancel()
        await asyncio.gather(sampler, return_exceptions=True)
        ov = srv.overload
        return {
            'defense': defense,
            'set_ops_per_sec': round(100 / dt, 1),
            'healthy_fires': len(fires),
            'peak_tx_buffered': peak[0],
            'evictions': ov.evictions if ov is not None else 0,
            'notifications_dropped':
                ov.notifications_dropped if ov is not None else 0,
        }
    finally:
        for t in pending:
            t.cancel()
        await asyncio.gather(*pending, return_exceptions=True)
        for c in cls:
            try:
                await asyncio.wait_for(c.close(), 5)
            except Exception:
                pass
        await srv.stop()


def bench_overload() -> None:
    """The overload plane's cost + defense envelope (``--overload``),
    two paired families:

    - **defense cells** — the stalled-consumer scenario above,
      defense on vs ``overload=False``: the on-arm's peak tx backlog
      must stay bounded by the hard watermark while the off-arm's
      grows with the pipelined reads, and the writer's fan-out
      throughput must not be significantly SLOWER with the defense
      (sign of the per-round set-ops/s delta, exact two-sided test);
    - **overhead cells** — healthy write-heavy client-ops runs,
      plane on vs ``ZKSTREAM_NO_OVERLOAD=1`` at fleet 16/64 with the
      arm order alternating per round (the first-slot penalty
      rationale in bench_trace_overhead): the plane's per-op
      accounting must not be significantly slower.

    Rounds via ZKSTREAM_BENCH_OVERLOAD_ROUNDS; the measured tables
    live in PROFILE.md "Overload plane"."""
    import asyncio as _aio

    from .utils import native
    from .utils.metrics import sign_test_p

    rounds = int(os.environ.get('ZKSTREAM_BENCH_OVERLOAD_ROUNDS',
                                '8'))
    drows: list = []
    dcells: dict = {}
    for rnd in range(rounds):
        arms = ((True, False) if rnd % 2 == 0 else (False, True))
        pair: dict = {}
        for defense in arms:
            try:
                pair[defense] = _aio.run(
                    _overload_defense_round(defense))
            except Exception as e:
                print('# overload defense cell %s round failed: %r'
                      % ('on' if defense else 'off', e),
                      file=sys.stderr)
        for defense, r in pair.items():
            key = 'on' if defense else 'off'
            if key not in dcells or r['set_ops_per_sec'] > \
                    dcells[key]['set_ops_per_sec']:
                dcells[key] = r
        if len(pair) == 2:
            drows.append((pair[True]['set_ops_per_sec'],
                          pair[False]['set_ops_per_sec'],
                          pair[True]['peak_tx_buffered'],
                          pair[False]['peak_tx_buffered']))
    for key in sorted(dcells):
        print('# overload_defense_cell %s' % json.dumps(dcells[key]),
              file=sys.stderr)
    if drows:
        deltas = [(a - b) / b * 100.0 for a, b, _, _ in drows if b]
        wins = sum(1 for a, b, _, _ in drows if a > b)
        losses = sum(1 for a, b, _, _ in drows if a < b)
        print(json.dumps({
            'metric': 'overload_defense_sign_test',
            'pair': 'defense-vs-off',
            'stalled': OVERLOAD_STALLED,
            'rounds': len(drows),
            'wins': wins,
            'losses': losses,
            'mean_delta_pct': round(sum(deltas)
                                    / max(1, len(deltas)), 1),
            'sign_p': round(sign_test_p(wins, losses), 4),
            'peak_tx_on': max(p for _, _, p, _ in drows),
            'peak_tx_off': max(p for _, _, _, p in drows),
        }), flush=True)
    mode = 'native' if native.ensure_lib() is not None else 'python'
    # both arm states forced explicitly, ambient value restored — an
    # inherited ZKSTREAM_NO_OVERLOAD=1 would silently turn the
    # defended arm into a second undefended one
    ambient = os.environ.get('ZKSTREAM_NO_OVERLOAD')
    rows: dict = {}
    cells: dict = {}
    try:
        for rnd in range(rounds):
            arms = (('overload', 'nooverload') if rnd % 2 == 0
                    else ('nooverload', 'overload'))
            for n in OVERLOAD_SCALES:
                pair = {}
                for arm in arms:
                    if arm == 'nooverload':
                        os.environ['ZKSTREAM_NO_OVERLOAD'] = '1'
                    else:
                        os.environ.pop('ZKSTREAM_NO_OVERLOAD', None)
                    try:
                        r = _aio.run(_client_ops_run(
                            mode, n, write_heavy=True))
                    except Exception as e:
                        print('# overload cell %s@%d round failed: '
                              '%r' % (arm, n, e), file=sys.stderr)
                        continue
                    r['overload_arm'] = arm
                    pair[arm] = r
                for arm, r in pair.items():
                    key = (n, arm)
                    if len(pair) == 2:
                        rows.setdefault(key, []).append(
                            r['set']['ops_per_sec'])
                    if key not in cells or r['set']['ops_per_sec'] \
                            > cells[key]['set']['ops_per_sec']:
                        cells[key] = r
    finally:
        if ambient is None:
            os.environ.pop('ZKSTREAM_NO_OVERLOAD', None)
        else:
            os.environ['ZKSTREAM_NO_OVERLOAD'] = ambient
    for key in sorted(cells, key=str):
        print('# overload_cell %s' % json.dumps(cells[key]),
              file=sys.stderr)
    for n in OVERLOAD_SCALES:
        a = rows.get((n, 'overload'), [])
        b = rows.get((n, 'nooverload'), [])
        if not a or not b:
            continue
        paired = list(zip(a, b))
        deltas = [(x - y) / y * 100.0 for x, y in paired if y]
        wins = sum(1 for x, y in paired if x > y)
        losses = sum(1 for x, y in paired if x < y)
        print(json.dumps({
            'metric': 'overload_plane_sign_test',
            'pair': 'overload-vs-off',
            'conns': n,
            'rounds': len(paired),
            'wins': wins,
            'losses': losses,
            'mean_delta_pct': round(sum(deltas)
                                    / max(1, len(deltas)), 1),
            'sign_p': round(sign_test_p(wins, losses), 4),
        }), flush=True)


#: `--fanout` sweep (the serving-plane cell family): sessions
#: on the box x watchers on the hot path.  -1 = every session watches.
FANOUT_SESSIONS = (1000, 10000, 100000)
FANOUT_WATCHERS = (1, 100, -1)


class _NullWriter:
    """A transport sink for fan-out cells: counts what the server
    writes, delivers nowhere.  The cell measures the serving plane's
    dispatch + encode + flush path (the thing the watch table owns);
    100k real sockets would measure the kernel instead."""

    __slots__ = ('nbytes', 'writes', 'sink')

    def __init__(self, sink):
        self.nbytes = 0
        self.writes = 0
        self.sink = sink

    def write(self, data):
        self.nbytes += len(data)
        self.writes += 1
        self.sink[0] += len(data)

    def close(self):
        pass

    def get_extra_info(self, name, default=None):
        return default


#: Decode ceiling of ONE Python client pump, ops/s: the reference's
#: calibration on its own host (not re-measured for the port), kept so
#: the cells carry the reference's fields.  Every cell a Python client
#: drives carries ``client_capped: true`` plus this number so its
#: absolute throughput can't be mistaken for a server limit; the C
#: loadgen cells (csrc/loadgen.c) carry ``client_capped: false``.
PY_CLIENT_CEILING_OPS = 11000


async def fanout_cell(sessions: int, watchers: int, table: bool,
                      events: int | None = None,
                      collector=None) -> dict:
    """One serving-plane fan-out measurement: ``sessions`` in-process
    server connections over a null transport, ``watchers`` of them
    holding a data watch on one hot path.  Fires ``events`` SET_DATA
    mutations (re-arming between events) and times each
    mutation -> all-notification-bytes-flushed window.

    ``table=True`` runs the sharded watch table
    (server/watchtable.py); ``table=False`` the per-connection emitter
    fallback — the paired arm, where every event costs O(sessions)
    callbacks regardless of ``watchers``."""
    import asyncio

    from .protocol.consts import CreateFlag
    from .server import ZKDatabase, ZKServer
    from .server.server import ServerConnection

    loop = asyncio.get_running_loop()
    db = ZKDatabase()
    # never started: no listener, no kernel sockets — connections are
    # wired straight to null transports below
    srv = ZKServer(db=db, watchtable=table, collector=collector)
    total = [0]
    conns = []
    for _ in range(sessions):
        conn = ServerConnection(srv, reader=None,
                                writer=_NullWriter(total))
        conn._subscribe()
        srv.conns.add(conn)
        conns.append(conn)
    db.create('/hot', b'', [], CreateFlag(0))
    watcher_conns = conns[:watchers]
    # one frame's wire size (constant per event: fixed-width header +
    # this path), to know when an event's fan-out has fully flushed
    frame_len = len(srv.encode_notification('DATA_CHANGED', '/hot', 1))
    if events is None:
        # emitter-arm cost is O(sessions) per event: keep big cells
        # bounded, small cells statistically useful
        events = max(3, min(30, 200000 // max(sessions, 1)))
    lat_ms = []
    payload = b'z' * 64
    try:
        for _ in range(events):
            for c in watcher_conns:
                c._arm_data('/hot')
            expect = total[0] + watchers * frame_len
            t0 = loop.time()
            db.set_data('/hot', payload, -1)
            deadline = t0 + 30.0
            while total[0] < expect:
                await asyncio.sleep(0)
                if loop.time() > deadline:
                    raise TimeoutError(
                        'fan-out stalled: %d/%d bytes'
                        % (total[0], expect))
            lat_ms.append((loop.time() - t0) * 1000.0)
    finally:
        if not table:
            # The emitter arm's clean close is O(listeners) PER
            # CONNECTION (EventEmitter.remove_listener scans the
            # store's listener list), i.e. O(sessions^2) for the whole
            # fleet — hours at 100k, and itself part of why the table
            # exists (table-mode close is O(paths watched)).  The cell
            # measures dispatch, not teardown: drop the listeners
            # wholesale first so close() sees empty lists.
            for evt in ('created', 'deleted', 'dataChanged',
                        'childrenChanged'):
                db.remove_all_listeners(evt)
        for c in conns:
            c.close()
        if srv.ledger is not None:
            srv.ledger.close_tick()   # flush the residual burst
    p50, p99 = _percentiles(lat_ms)
    out = {'sessions': sessions, 'watchers': watchers,
           'table': table, 'events': events,
           # paired A/B cell driven by one in-process Python loop:
           # relative deltas are honest, absolute rates are capped by
           # the Python driver (see the loadgen fan-out cells)
           'client_capped': True,
           'client_ceiling_ops_per_sec': PY_CLIENT_CEILING_OPS,
           'event_ms_mean': round(sum(lat_ms) / len(lat_ms), 3),
           'event_ms_p50': round(p50, 3),
           'event_ms_p99': round(p99, 3),
           'notifs_per_sec': round(
               watchers * events / (sum(lat_ms) / 1000.0), 1)}
    if collector is not None and table:
        from .server.watchtable import METRIC_FANOUT_TICK
        try:
            tick = collector.get_collector(METRIC_FANOUT_TICK)
        except ValueError:
            tick = None
        if tick is not None and tick.count({'plane': 'fanout'}):
            labels = {'plane': 'fanout'}
            out['fanout_tick_ms'] = {
                'count': tick.count(labels),
                'p50': round(tick.percentile(50, labels), 3),
                'p99': round(tick.percentile(99, labels), 3)}
        from .io.sendplane import scrape_flush_cells
        flush = scrape_flush_cells(collector).get('fanout')
        if flush:
            out['fanout_flush_batches'] = flush
    if collector is not None:
        from .utils.metrics import scrape_tick_cells
        tick = scrape_tick_cells(collector)
        if tick:
            out['tick_ledger'] = tick
    return out


def _arg_ints(flag: str) -> list[int] | None:
    """Parse ``--flag 1000,10000`` style comma-lists from sys.argv."""
    if flag not in sys.argv:
        return None
    idx = sys.argv.index(flag)
    if idx + 1 >= len(sys.argv):
        return None
    return [int(x) for x in sys.argv[idx + 1].split(',') if x]


def bench_fanout() -> None:
    """The serving-plane fan-out envelope (`--fanout`):
    paired table-vs-emitter cells over the sessions x watchers sweep,
    per-round adjacent A/B runs, exact two-sided sign test on the
    per-event fan-out latency — PROFILE.md methodology, same as the
    cork and WAL families.  The acceptance bar: the table is not
    significantly slower at any cell and significantly faster at the
    high-watcher/low-coverage cells where the emitter pays
    O(sessions) per event.  Scale with ZKSTREAM_BENCH_FANOUT_ROUNDS;
    narrow the sweep with ``--sessions/--watchers`` comma-lists."""
    import asyncio

    from .utils.metrics import Collector, sign_test_p

    sessions_sweep = _arg_ints('--sessions') or list(FANOUT_SESSIONS)
    watchers_sweep = _arg_ints('--watchers') or list(FANOUT_WATCHERS)
    rounds = int(os.environ.get('ZKSTREAM_BENCH_FANOUT_ROUNDS', '10'))
    rows: dict = {}
    cells: dict = {}
    for rnd in range(rounds):
        for s in sessions_sweep:
            for w in watchers_sweep:
                wn = s if w < 0 else w
                if wn > s:
                    continue
                # the sign test pairs ADJACENT A/B runs: a round where
                # either arm failed contributes to neither, so the
                # surviving pairs stay aligned round-for-round
                pair = {}
                for arm_table in (True, False):
                    col = Collector()
                    try:
                        pair[arm_table] = asyncio.run(fanout_cell(
                            s, wn, arm_table, collector=col))
                    except Exception as e:
                        print('# fanout cell %dx%d table=%s round '
                              'failed: %r' % (s, wn, arm_table, e),
                              file=sys.stderr)
                for arm_table, r in pair.items():
                    key = (s, wn, 'table' if arm_table else 'emitter')
                    if len(pair) == 2:
                        rows.setdefault(key, []).append(
                            r['event_ms_mean'])
                    if key not in cells or r['event_ms_mean'] < \
                            cells[key]['event_ms_mean']:
                        cells[key] = r
    for key in sorted(cells, key=str):
        print('# fanout_cell %s' % json.dumps(cells[key]),
              file=sys.stderr)
    for s in sessions_sweep:
        for w in watchers_sweep:
            wn = s if w < 0 else w
            if wn > s:
                continue
            a = rows.get((s, wn, 'table'), [])
            b = rows.get((s, wn, 'emitter'), [])
            if not a or not b:
                continue
            paired = list(zip(a, b))
            # positive delta = table faster (lower per-event latency)
            deltas = [(y - x) / y * 100.0 for x, y in paired if y]
            wins = sum(1 for x, y in paired if x < y)
            losses = sum(1 for x, y in paired if x > y)
            print(json.dumps({
                'metric': 'fanout_table_sign_test',
                'sessions': s,
                'watchers': wn,
                'rounds': len(paired),
                'wins': wins,
                'losses': losses,
                'mean_delta_pct': round(sum(deltas)
                                        / max(1, len(deltas)), 1),
                'sign_p': round(sign_test_p(wins, losses), 4),
            }), flush=True)
    # absolute cells: the null-transport family above isolates
    # dispatch cost but its driver is Python (client_capped); these
    # push REAL notifications through real sockets — every session
    # holds a watch, the loadgen's writer fires, and the cell times
    # mutation -> all-notifications-on-the-wire per round
    from .utils import loadgen as _lg
    if _lg.mode() == 'c' and _lg.available() is not None:
        for s in sessions_sweep:
            try:
                cell = asyncio.run(_loadgen_fleet_cell(
                    1, s, duration=0, arm_watch=True,
                    fanout_sets=5))
            except Exception as e:
                print('# fanout loadgen cell %d failed: %r'
                      % (s, e), file=sys.stderr)
                continue
            if cell is None:
                break
            print('# fanout_loadgen_cell %s' % (json.dumps(cell),),
                  file=sys.stderr)


#: `--transport` sweep (the batched-syscall transport-tier
#: cell family): connections on the box x workload shape.  Real
#: kernel sockets — the thing being measured IS the syscall layer —
#: so the 10k cell needs ~2 fds per connection and clamps to the
#: process's fd limit when necessary.
TRANSPORT_SCALES = (128, 1000, 10000)
TRANSPORT_WORKLOADS = ('write', 'fanout')


def _transport_fd_clamp(conns: int) -> int:
    """Largest connection count the fd limit allows (2 fds per conn +
    headroom for the process's own files)."""
    try:
        import resource
        soft, _hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    except Exception:
        return conns
    ceiling = max(64, (soft - 128) // 2)
    return min(conns, ceiling)


async def transport_cell(conns: int, workload: str, backend: str,
                         collector=None, events: int | None = None,
                         ingress_shards: int | None = None,
                         ingress_backend: str | None = None,
                         time_arms: bool = False
                         ) -> dict:
    """One transport-tier measurement over REAL kernel sockets:
    ``conns`` raw TCP connections into one server, each holding a
    session.

    ``ingress_shards`` / ``ingress_backend`` parameterize the server's
    receive path (io/ingress.py) — ``--ingress`` pairs the
    sharded batched drain against the single-loop validator through
    this same cell, with the transport backend held at the process
    default for both arms so the delta isolates the rx direction.

    ``workload='write'``: per event every connection sends one
    pipelined EXISTS and the cell times the all-requests ->
    all-replies-received window — the reply path's corked flush is
    what the tier batches.  ``workload='fanout'``: every connection
    data-watches one hot path; per event one SET_DATA (through
    connection 0) fans a notification to every other connection via
    the watch table's shard flushes — the fanout_flush path.

    ``backend`` forces the tier ('uring' | 'mmsg' | 'asyncio' — the
    paired A/B arms); the cell scrapes
    ``zookeeper_flush_syscalls_total`` and ``zookeeper_submit_depth``
    so the syscalls-per-tick claim is measured, not asserted.

    ``time_arms`` moves the fanout workload's watcher re-arm burst
    INSIDE the timed window (the ingress pairing sets it: the
    all-watchers pipelined GET_DATA+watch burst is the cell's
    receive-heavy leg — the transport pairing keeps the legacy
    notify-only window, which contains almost no rx work)."""
    import asyncio
    import selectors
    import socket

    from .protocol.framing import PacketCodec
    from .server import ZKServer
    from .io.transport import METRIC_FLUSH_SYSCALLS, \
        METRIC_SUBMIT_DEPTH

    loop = asyncio.get_running_loop()
    srv = await ZKServer(transport=backend, collector=collector,
                         ingress_shards=ingress_shards,
                         ingress_backend=ingress_backend).start()
    resolved = ('asyncio' if srv.transport_tier is None
                else srv.transport_tier.backend)
    resolved_ingress = ('asyncio' if srv.ingress is None
                        else srv.ingress.backend)
    resolved_shards = 1 if srv.ingress is None else srv.ingress.nshards
    socks: list = []
    codecs: list = []
    inbox: dict[int, list] = {}
    sel = selectors.DefaultSelector()
    try:
        # raw non-blocking client sockets: the client side must not
        # cost an asyncio protocol per connection — the cell measures
        # the SERVER's outbound tier, the client just drains bytes
        connect_pkt = {'protocolVersion': 0, 'lastZxidSeen': 0,
                       'timeOut': 30000, 'sessionId': 0, 'passwd': b''}

        def _dial(i: int) -> None:
            s = socket.socket()
            s.setblocking(False)
            try:
                s.connect(('127.0.0.1', srv.port))
            except BlockingIOError:
                pass
            socks.append(s)
            codecs.append(PacketCodec())
            sel.register(s, selectors.EVENT_READ, i)

        async def send_all(pkt: dict, idxs=None):
            # encoded per connection so each codec's xid -> opcode
            # reply map stays correct (the bytes are identical)
            for i in (range(len(socks)) if idxs is None else idxs):
                s = socks[i]
                view = memoryview(codecs[i].encode(dict(pkt)))
                while view:
                    try:
                        n = s.send(view)
                        view = view[n:]
                    except (BlockingIOError, OSError):
                        await asyncio.sleep(0)

        async def recv_frames(need_per_conn: int, idxs=None,
                              timeout: float = 60.0):
            """Drain until every polled socket produced
            ``need_per_conn`` decoded packets; returns per-conn packet
            lists (handshake replies included on the first call).
            epoll-driven (selectors) so an idle pass costs one poll,
            not one recv per connection — the pump must not charge
            either arm O(conns) per event-loop iteration.  Packets
            for connections outside ``idxs`` land in the persistent
            inbox and seed that connection's next wait."""
            idxs = list(range(len(socks))) if idxs is None else idxs
            got: dict[int, list] = {i: inbox.pop(i, []) for i in idxs}
            pendset = {i for i in idxs
                       if len(got[i]) < need_per_conn}
            deadline = loop.time() + timeout
            while pendset:
                for key, _ev in sel.select(timeout=0):
                    i = key.data
                    try:
                        data = key.fileobj.recv(1 << 16)
                    except BlockingIOError:
                        continue
                    if not data:
                        raise ConnectionError('conn %d closed' % i)
                    pkts = codecs[i].decode(data)
                    if i in got:
                        got[i].extend(pkts)
                        if len(got[i]) >= need_per_conn:
                            pendset.discard(i)
                    else:
                        inbox.setdefault(i, []).extend(pkts)
                if loop.time() > deadline:
                    raise TimeoutError('%d conns still pending'
                                       % len(pendset))
                if pendset:
                    await asyncio.sleep(0)
            return got

        async def recv_bytes(targets: dict, timeout: float = 60.0):
            """The timed pump: count bytes per connection against
            ``targets`` (conn -> expected bytes) — every reply and
            notification frame in the timed phases has a fixed wire
            size, so tallying lengths verifies delivery without
            charging the window a Python frame decode per packet
            (which would dilute the A/B delta with equal-cost
            work)."""
            remaining = dict(targets)
            pend = len(remaining)
            deadline = loop.time() + timeout
            while pend:
                for key, _ev in sel.select(timeout=0):
                    i = key.data
                    try:
                        data = key.fileobj.recv(1 << 16)
                    except BlockingIOError:
                        continue
                    if not data:
                        raise ConnectionError('conn %d closed' % i)
                    r = remaining.get(i)
                    if r is None or r <= 0:
                        continue
                    r -= len(data)
                    remaining[i] = r
                    if r <= 0:
                        pend -= 1
                if loop.time() > deadline:
                    raise TimeoutError('%d conns still pending'
                                       % pend)
                if pend:
                    await asyncio.sleep(0)

        # dial + handshake in waves bounded by the server's listen
        # backlog, so a 10k-conn cell can't overflow the accept queue
        wave = min(conns, 512)
        done = 0
        while done < conns:
            n = min(wave, conns - done)
            for i in range(done, done + n):
                _dial(i)
            await asyncio.sleep(0)
            await send_all(connect_pkt, idxs=range(done, done + n))
            hs = await recv_frames(1, idxs=list(range(done, done + n)))
            for i, pkts in hs.items():
                assert pkts[0]['sessionId'] != 0
                codecs[i].handshaking = False
            done += n

        from .protocol.consts import CreateFlag
        srv.db.create('/hot', b'z' * 64, [], CreateFlag(0))

        if events is None:
            events = max(4, min(40, 80000 // max(conns, 1)))
        lat_ms: list[float] = []
        xid = [0]

        def req(pkt):
            xid[0] += 1
            return dict(pkt, xid=xid[0])

        async def probe_len(pkt) -> int:
            """One frame's wire size, measured on conn 0 (every timed
            frame is fixed-width: int64 zxids, constant path/data)."""
            await send_all(req(pkt), idxs=[0])
            buf = b''
            while len(buf) < 4 or \
                    len(buf) < 4 + int.from_bytes(buf[:4], 'big'):
                try:
                    buf += socks[0].recv(1 << 16)
                except BlockingIOError:
                    await asyncio.sleep(0)
            return 4 + int.from_bytes(buf[:4], 'big')

        if workload == 'write':
            reply_len = await probe_len({'opcode': 'EXISTS',
                                         'path': '/hot',
                                         'watch': False})
            for _ in range(events):
                frame = req({'opcode': 'EXISTS', 'path': '/hot',
                             'watch': False})
                t0 = loop.time()
                await send_all(frame)
                await recv_bytes({i: reply_len
                                  for i in range(len(socks))})
                lat_ms.append((loop.time() - t0) * 1000.0)
        else:
            watchers = list(range(1, len(socks)))
            arm_len = await probe_len({'opcode': 'GET_DATA',
                                       'path': '/hot',
                                       'watch': False})
            set_len = await probe_len({'opcode': 'SET_DATA',
                                       'path': '/hot',
                                       'data': b'z' * 64,
                                       'version': -1})
            notif_len = len(srv.encode_notification(
                'DATA_CHANGED', '/hot', 1))
            fan_targets = {w: notif_len for w in watchers}
            fan_targets[0] = set_len
            for ev in range(events):
                if time_arms:
                    t0 = loop.time()
                await send_all(req({'opcode': 'GET_DATA',
                                    'path': '/hot', 'watch': True}),
                               idxs=watchers)
                await recv_bytes({w: arm_len for w in watchers})
                if not time_arms:
                    t0 = loop.time()
                await send_all(req({'opcode': 'SET_DATA',
                                    'path': '/hot',
                                    'data': b'z' * 64,
                                    'version': -1}), idxs=[0])
                # each watcher: one notification; conn 0: the reply
                await recv_bytes(dict(fan_targets))
                lat_ms.append((loop.time() - t0) * 1000.0)
    finally:
        sel.close()
        for s in socks:
            try:
                s.close()
            except OSError:
                pass
        await srv.stop()
        if srv.ledger is not None:
            srv.ledger.close_tick()
    p50, p99 = _percentiles(lat_ms)
    out = {'conns': conns, 'workload': workload,
           'backend': backend, 'resolved_backend': resolved,
           'ingress_backend': resolved_ingress,
           'ingress_shards': resolved_shards,
           # one Python pump paces every event: the A/B delta is the
           # measurement, the absolute rate is the client's ceiling
           'client_capped': True,
           'client_ceiling_ops_per_sec': PY_CLIENT_CEILING_OPS,
           'events': events,
           'event_ms_mean': round(sum(lat_ms) / len(lat_ms), 3),
           'event_ms_p50': round(p50, 3),
           'event_ms_p99': round(p99, 3)}
    if collector is not None:
        try:
            ctr = collector.get_collector(METRIC_FLUSH_SYSCALLS)
        except ValueError:
            ctr = None
        if ctr is not None:
            # exact series: {plane, backend} -> count
            sys_by_backend = {}
            for key in ctr.label_keys():
                labels = dict(key)
                if labels.get('plane') == 'server':
                    sys_by_backend[labels.get('backend', '?')] = \
                        ctr.value(labels)
            out['server_syscalls'] = sys_by_backend
            total = sum(sys_by_backend.values())
            out['syscalls_per_event'] = round(total / max(1, events), 2)
        try:
            dep = collector.get_collector(METRIC_SUBMIT_DEPTH)
        except ValueError:
            dep = None
        if dep is not None and resolved != 'asyncio':
            labels = {'plane': 'server', 'backend': resolved}
            n = dep.count(labels)
            if n:
                out['submit_depth'] = {
                    'submissions': n,
                    'mean': round(dep.sum(labels) / n, 1),
                    'p99': round(dep.percentile(99, labels), 1)}
        # the rx direction: receive submissions by backend + drain
        # depth (io/ingress.py) — syscalls-per-tick accounted BOTH
        # ways per cell
        from .io.ingress import scrape_recv_cells
        out.update(scrape_recv_cells(collector))
        from .utils.metrics import scrape_tick_cells
        tick = scrape_tick_cells(collector)
        if tick:
            out['tick_ledger'] = tick
    return out


def bench_transport() -> None:
    """The batched-syscall transport envelope (`--transport`):
    paired batched-vs-asyncio cells over the conns x workload sweep
    (128/1k/10k x write-heavy/fanout), per-round adjacent A/B runs,
    exact two-sided sign test on the per-event latency — the PROFILE.md
    methodology, same as the cork/WAL/fan-out families.  The syscall
    reduction is printed per cell from
    ``zookeeper_flush_syscalls_total`` (O(dirty conns) -> O(1) per
    tick on the uring path).  Scale with ZKSTREAM_BENCH_TRANSPORT_ROUNDS;
    narrow with ``--conns`` / ``--workloads`` comma-lists."""
    import asyncio

    from .io.transport import probe
    from .utils.metrics import Collector, sign_test_p

    p = probe()
    batched = 'uring' if p.uring else ('mmsg' if p.mmsg else None)
    if batched is None:
        print('# no batched transport backend available on this '
              'platform (uring: %s; mmsg: %s) — nothing to pair'
              % (p.uring_reason, p.mmsg_reason), file=sys.stderr)
        return
    print('# transport probe: %s (pairing %s vs asyncio)'
          % (p, batched), file=sys.stderr)
    conns_sweep = _arg_ints('--conns') or list(TRANSPORT_SCALES)
    workloads = TRANSPORT_WORKLOADS
    if '--workloads' in sys.argv:
        idx = sys.argv.index('--workloads')
        if idx + 1 < len(sys.argv):
            workloads = tuple(w for w in sys.argv[idx + 1].split(',')
                              if w)
    rounds = int(os.environ.get('ZKSTREAM_BENCH_TRANSPORT_ROUNDS',
                                '10'))
    rows: dict = {}
    cells: dict = {}
    for rnd in range(rounds):
        for conns in conns_sweep:
            clamped = _transport_fd_clamp(conns)
            if clamped < conns:
                if rnd == 0:
                    print('# transport cell %d clamped to %d conns '
                          '(fd limit)' % (conns, clamped),
                          file=sys.stderr)
            for wl in workloads:
                pair = {}
                for backend in (batched, 'asyncio'):
                    col = Collector()
                    try:
                        pair[backend] = asyncio.run(transport_cell(
                            clamped, wl, backend, collector=col))
                    except Exception as e:
                        print('# transport cell %dx%s %s round '
                              'failed: %r' % (clamped, wl, backend, e),
                              file=sys.stderr)
                for backend, r in pair.items():
                    key = (conns, wl, backend)
                    if len(pair) == 2:
                        rows.setdefault(key, []).append(
                            r['event_ms_mean'])
                    if key not in cells or r['event_ms_mean'] < \
                            cells[key]['event_ms_mean']:
                        cells[key] = r
    for key in sorted(cells, key=str):
        print('# transport_cell %s' % json.dumps(cells[key]),
              file=sys.stderr)
    for conns in conns_sweep:
        for wl in workloads:
            a = rows.get((conns, wl, batched), [])
            b = rows.get((conns, wl, 'asyncio'), [])
            if not a or not b:
                continue
            paired = list(zip(a, b))
            # positive delta = batched faster (lower latency)
            deltas = [(y - x) / y * 100.0 for x, y in paired if y]
            wins = sum(1 for x, y in paired if x < y)
            losses = sum(1 for x, y in paired if x > y)
            print(json.dumps({
                'metric': 'transport_backend_sign_test',
                'conns': conns,
                'workload': wl,
                'backend': batched,
                'rounds': len(paired),
                'wins': wins,
                'losses': losses,
                'mean_delta_pct': round(sum(deltas)
                                        / max(1, len(deltas)), 1),
                'sign_p': round(sign_test_p(wins, losses), 4),
            }), flush=True)


#: `--ingress` sweep (the shared-nothing ingress cell
#: family): connections x workload, multi-shard batched drain vs the
#: single-loop validator.  Real kernel sockets (the thing measured IS
#: the receive path); the 10k/100k cells clamp to the fd limit.
INGRESS_SCALES = (1000, 10000, 100000)
INGRESS_WORKLOADS = ('write', 'fanout')


def bench_ingress() -> None:
    """The shared-nothing ingress envelope (`--ingress`):
    paired multi-shard vs single-loop cells over the conns x workload
    sweep (1k/10k/100k x write-heavy/fanout), per-round adjacent A/B
    runs, exact two-sided sign test on the per-event latency — the
    PROFILE.md methodology, same as the cork/WAL/fan-out/transport
    families.  Syscalls-per-tick are printed per cell in BOTH
    directions: tx from ``zookeeper_flush_syscalls_total``, rx from
    ``zookeeper_recv_syscalls_total`` + ``zookeeper_recv_drain_depth``
    (drain submissions are O(dirty shards) per tick on the batched
    tier; the per-fd recv count inside the one C call stays O(dirty
    conns) until the uring arm — re-measured on a >= 5.1 kernel).
    Both arms run the same transport backend (the process default) so
    the delta isolates the receive direction.  Scale with
    ZKSTREAM_BENCH_INGRESS_ROUNDS; narrow with ``--conns`` /
    ``--workloads`` comma-lists."""
    import asyncio

    from .io.ingress import probe, shards_default
    from .utils.metrics import Collector, sign_test_p

    p = probe()
    batched = 'uring' if p.uring else ('mmsg' if p.mmsg else None)
    if batched is None:
        print('# no batched ingress backend available on this '
              'platform (uring: %s; mmsg: %s) — nothing to pair'
              % (p.uring_reason, p.mmsg_reason), file=sys.stderr)
        return
    shards = shards_default()
    if shards < 2:
        shards = 2      # a 1-core box still pairs sharded vs single
    print('# ingress probe: %s (pairing %d-shard %s vs single-loop)'
          % (p, shards, batched), file=sys.stderr)
    conns_sweep = _arg_ints('--conns') or list(INGRESS_SCALES)
    workloads = INGRESS_WORKLOADS
    if '--workloads' in sys.argv:
        idx = sys.argv.index('--workloads')
        if idx + 1 < len(sys.argv):
            workloads = tuple(w for w in sys.argv[idx + 1].split(',')
                              if w)
    rounds = int(os.environ.get('ZKSTREAM_BENCH_INGRESS_ROUNDS',
                                '10'))
    # both arms ride the SAME (default) transport backend: the A/B
    # delta must isolate the receive direction
    from .io.transport import backend_default
    txb = backend_default()
    #: (arm label) -> (ingress_shards, ingress_backend) cell args
    arms = {'sharded': (shards, batched), 'single': (1, 'asyncio')}
    rows: dict = {}
    cells: dict = {}
    for rnd in range(rounds):
        #: (clamped width, workload) -> measured pair: two nominal
        #: scales clamping to the SAME width (10k and 100k on a 20k
        #: fd limit) are one measurement, not two — the duplicate
        #: row reuses it instead of burning a full re-run per round
        measured: dict = {}
        for conns in conns_sweep:
            clamped = _transport_fd_clamp(conns)
            if clamped < conns and rnd == 0:
                print('# ingress cell %d clamped to %d conns '
                      '(fd limit)' % (conns, clamped),
                      file=sys.stderr)
            for wl in workloads:
                pair = measured.get((clamped, wl))
                if pair is None:
                    pair = {}
                    for arm, (ns, ib) in arms.items():
                        col = Collector()
                        try:
                            pair[arm] = asyncio.run(transport_cell(
                                clamped, wl, txb,
                                collector=col, ingress_shards=ns,
                                ingress_backend=ib, time_arms=True))
                        except Exception as e:
                            print('# ingress cell %dx%s %s round '
                                  'failed: %r'
                                  % (clamped, wl, arm, e),
                                  file=sys.stderr)
                    measured[(clamped, wl)] = pair
                for arm, r in pair.items():
                    key = (conns, wl, arm)
                    if len(pair) == 2:
                        rows.setdefault(key, []).append(
                            r['event_ms_mean'])
                    if key not in cells or r['event_ms_mean'] < \
                            cells[key]['event_ms_mean']:
                        cells[key] = dict(r, arm=arm)
    for key in sorted(cells, key=str):
        print('# ingress_cell %s' % json.dumps(cells[key]),
              file=sys.stderr)
    for conns in conns_sweep:
        for wl in workloads:
            a = rows.get((conns, wl, 'sharded'), [])
            b = rows.get((conns, wl, 'single'), [])
            if not a or not b:
                continue
            paired = list(zip(a, b))
            # positive delta = sharded faster (lower latency)
            deltas = [(y - x) / y * 100.0 for x, y in paired if y]
            wins = sum(1 for x, y in paired if x < y)
            losses = sum(1 for x, y in paired if x > y)
            print(json.dumps({
                'metric': 'ingress_shards_sign_test',
                'conns': conns,
                'workload': wl,
                'shards': shards,
                'ingress_backend': batched,
                'rounds': len(paired),
                'wins': wins,
                'losses': losses,
                'mean_delta_pct': round(sum(deltas)
                                        / max(1, len(deltas)), 1),
                'sign_p': round(sign_test_p(wins, losses), 4),
            }), flush=True)
    # absolute cells: the paired family above is paced by one
    # in-process Python pump (client_capped in its JSON); these
    # re-measure the same widths with the C loadgen driving a real
    # leader process — write-heavy steady load plus the unpaced
    # handshake wave, the numbers the ingress tier is actually for
    from .utils import loadgen as _lg
    if _lg.mode() == 'c' and _lg.available() is not None:
        for conns in conns_sweep:
            try:
                cell = asyncio.run(_loadgen_fleet_cell(
                    1, conns, duration=2.0, mix='set=100'))
            except Exception as e:
                print('# ingress loadgen cell %d failed: %r'
                      % (conns, e), file=sys.stderr)
                continue
            if cell is None:
                break
            print('# ingress_loadgen_cell %s' % (json.dumps(cell),),
                  file=sys.stderr)


#: `--read` (`--read`): read-serving member counts
#: (1 = the leader alone; 3/5 = leader + 2/4 OBSERVERS — non-voting
#: read replicas, so the write quorum stays a single member across
#: every cell and only read capacity varies), session sweep and
#: workloads.  Members are REAL OS processes (server/election.py
#: ProcMember + member_worker --observer): in-process members share
#: one event loop and could never show read scale-out.
READ_MEMBERS = (1, 3, 5)
READ_SESSIONS = (1000, 10000)
READ_WORKLOADS = ('read', 'mixed')
READ_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           'tools', 'read_worker.py')


async def _read_cell(members: int, sessions: int, workload: str,
                     duration_s: float, cached: bool = False) -> dict:
    """One read-plane cell: spawn 1 voter + (members-1) observer
    processes, park ``sessions`` raw-socket read sessions across them
    (reader worker processes, zkstream_tpu_torch/tools/read_worker.py),
    pipeline GET_DATA for ``duration_s`` and sum the replies; the ``mixed``
    workload concurrently drives sets through the leader and records
    per-write latency.  Scrapes the zxid read-gate counters and the
    leader's tick-ledger phase rows after the window."""
    import shutil
    import subprocess
    import tempfile

    from . import Client
    from .server.election import (
        ProcMember,
        _scrape_mntr,
        allocate_ports,
        find_leader,
    )

    import asyncio

    root = tempfile.mkdtemp(prefix='zkbench-read-')
    ports = allocate_ports(2 * members)
    fleet = [ProcMember(i, os.path.join(root, 'm%d' % i),
                        ports[2 * i], ports[2 * i + 1],
                        observer=i > 0)
             for i in range(members)]
    procs: list = []
    c = None
    loop = asyncio.get_running_loop()
    try:
        for m in fleet:
            m.spawn(fleet)
        for m in fleet:
            await m.wait_ready()
        await find_leader(fleet, min_epoch=1)
        # a generous session: at 10k sessions x 1 member the
        # handshake storm can starve pings for seconds — the cell
        # must still report its (honest, terrible) number
        c = Client(servers=[('127.0.0.1', fleet[0].client_port)],
                   shuffle_backends=False, session_timeout=120000,
                   op_timeout=60000)
        c.start()
        await c.wait_connected(timeout=20)
        await c.create('/bench', b'x' * 128)

        # driver arm: the C loadgen (csrc/loadgen.c) by default —
        # one process, epoll threads, streaming decode — with the
        # Python read_worker pool kept as the ZKSTREAM_LOADGEN=py
        # validator arm (parity-checked in tests/test_torch_loadgen.py).
        # Both speak the same READY/GO stdio protocol.
        from .utils import loadgen as lg
        lg_cmd = None
        if lg.mode() == 'c':
            lg_cmd = lg.argv(
                [('127.0.0.1', m.client_port) for m in fleet],
                sessions, duration=duration_s, mix='get=100',
                path='/bench', stdio_sync=True,
                session_timeout_ms=120000, close_sessions=True,
                ensure_path=False, cached=cached)
            if lg_cmd is None:
                print('# C loadgen unavailable (no compiler?); '
                      'falling back to the Python worker arm',
                      file=sys.stderr)
        if cached and lg_cmd is None:
            raise RuntimeError('cached read arm needs the C loadgen')
        driver = 'c' if lg_cmd is not None else 'py'
        nworkers = 0
        if driver == 'c':
            procs.append(subprocess.Popen(
                lg_cmd, stdin=subprocess.PIPE,
                stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL, text=True))
        else:
            nworkers = max(1, min(8, (os.cpu_count() or 2)
                                  - members))
            per = sessions // nworkers
            addrs = ','.join('127.0.0.1:%d' % (m.client_port,)
                             for m in fleet)
            for w in range(nworkers):
                n = per + (sessions - per * nworkers
                           if w == 0 else 0)
                procs.append(subprocess.Popen(
                    [sys.executable, READ_WORKER, addrs, str(n),
                     '%g' % (duration_s,)],
                    stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                    stderr=subprocess.DEVNULL, text=True))
        connected = 0
        for p in procs:
            line = await asyncio.wait_for(
                loop.run_in_executor(None, p.stdout.readline), 180)
            assert line.startswith('READY'), line
            connected += int(line.split()[1])
        t0 = loop.time()
        for p in procs:
            p.stdin.write('GO\n')
            p.stdin.flush()
        write_lat: list[float] = []
        seq = 0
        if workload == 'mixed':
            while loop.time() - t0 < duration_s:
                w0 = loop.time()
                await c.set('/bench', b'y%07d' % (seq,) + b'x' * 120,
                            version=-1)
                write_lat.append((loop.time() - w0) * 1000.0)
                seq += 1
        outs = []
        for p in procs:
            line = await asyncio.wait_for(
                loop.run_in_executor(None, p.stdout.readline),
                duration_s + 120)
            outs.append(json.loads(line))
            p.wait()
        if driver == 'c':
            summary = outs[0]
            reads = summary['window']['ops']
        else:
            reads = sum(o['reads'] for o in outs)
        # quiet-phase write burst: the read window is over, so this
        # isolates what ATTACHING OBSERVERS costs a write (replication
        # pushes to N mirrors) from where the read load happened to
        # land — the apples-to-apples series the write-p50 sign test
        # compares across member counts
        qlat: list[float] = []
        for i in range(200):
            w0 = loop.time()
            await c.set('/bench', b'q%07d' % (i,) + b'x' * 120,
                        version=-1)
            qlat.append((loop.time() - w0) * 1000.0)
        qlat.sort()
        cell = {
            'members': members, 'sessions': connected,
            'workload': workload, 'driver': driver,
        }
        if driver == 'c':
            cell['client_capped'] = False
            cell['read'] = {
                'ops_per_sec': summary['window']['ops_per_sec']}
            # server_ops_per_sec is the wire rate the SERVER saw: for
            # the cached arm local hits never cross the wire, so only
            # the invalidation-driven refills count against it
            cache = summary.get('cache')
            if cache is not None:
                secs = summary['window']['secs']
                cell['cache'] = cache
                cell['read']['server_ops_per_sec'] = round(
                    cache['wire_reads_win'] / secs, 1) if secs else 0.0
                cell['read']['local_hits_per_sec'] = cache.get(
                    'hits_per_sec', 0.0)
            else:
                cell['read']['server_ops_per_sec'] = (
                    summary['window']['ops_per_sec'])
            cell['reader_errors'] = (
                sum(v['errors'] for v in summary['ops'].values())
                + summary['errors']['io']
                + summary['errors']['proto'])
            cell['zxid'] = summary['zxid']
            cell['handshake'] = summary.get('handshake')
            cell['loadgen_rc'] = procs[0].returncode
        else:
            # the Python arm is the validator: its absolute rate is
            # the client pool's decode ceiling, not the server's
            cell['client_capped'] = True
            cell['client_ceiling'] = {
                'workers': nworkers,
                'per_worker_ops_per_sec': round(
                    reads / duration_s / max(1, nworkers), 1),
                'decode_ceiling_ops_per_sec':
                    PY_CLIENT_CEILING_OPS}
            cell['read'] = {
                'ops_per_sec': round(reads / duration_s, 1)}
            cell['reader_errors'] = sum(o['errors'] for o in outs)
        if write_lat:
            lat = sorted(write_lat)
            cell['write'] = {
                'ops_per_sec': round(len(lat) / duration_s, 1),
                'p50_ms': round(lat[len(lat) // 2], 3),
                'p99_ms': round(lat[min(len(lat) - 1,
                                        int(len(lat) * 0.99))], 3),
            }
        cell['write_quiet'] = {
            'p50_ms': round(qlat[len(qlat) // 2], 3),
            'p99_ms': round(qlat[min(len(qlat) - 1,
                                     int(len(qlat) * 0.99))], 3),
        }
        blocks = bounces = 0
        for m in fleet:
            try:
                rows = await _scrape_mntr(m.client_port)
            except (OSError, TimeoutError):
                continue
            blocks += int(rows.get('zk_read_zxid_gate_blocks', 0))
            bounces += int(rows.get('zk_read_zxid_gate_bounces', 0))
            if m is fleet[0]:
                cell['tick_phases'] = {
                    k.split('"')[1]: float(v)
                    for k, v in rows.items()
                    if k.startswith('zk_tick_phase_ms_p99')}
        cell['gate'] = {'blocks': blocks, 'bounces': bounces}
        return cell
    finally:
        if c is not None:
            try:
                await asyncio.wait_for(c.close(), 5)
            except Exception:
                c.pool.stop()
        for p in procs:
            if p.poll() is None:
                p.kill()
            try:
                p.stdout.close()
                p.stdin.close()
            except Exception:
                pass
        for m in fleet:
            try:
                m.kill()
            except Exception:
                pass
        shutil.rmtree(root, ignore_errors=True)


def _proc_stats(pid: int) -> dict:
    """RSS + open-fd count of one process, from /proc."""
    out: dict = {}
    try:
        with open('/proc/%d/status' % pid) as f:
            for ln in f:
                if ln.startswith('VmRSS:'):
                    out['rss_mb'] = round(
                        int(ln.split()[1]) / 1024.0, 1)
                    break
        out['fds'] = len(os.listdir('/proc/%d/fd' % pid))
    except OSError:
        pass
    return out


async def _loadgen_fleet_cell(members: int, sessions: int, *,
                              duration=None, mix=None, ramp=None,
                              idle_ping=None, arm_watch=False,
                              fanout_sets=None,
                              setwatches_storm=False,
                              pipeline=None) -> dict | None:
    """One ABSOLUTE (non-paired) cell: a real leader + observers
    fleet driven by the C loadgen.  The loadgen's READY/GO stdio sync
    lets us scrape every member's RSS and fd count at the
    all-sessions-connected peak before the load window opens.
    Returns the loadgen summary annotated with the fleet shape, or
    None when the binary can't be built (no compiler)."""
    import shutil
    import subprocess
    import tempfile

    from .server.election import (
        ProcMember,
        allocate_ports,
        find_leader,
    )
    from .utils import loadgen as lg

    import asyncio

    if lg.available() is None:   # build before spawning the fleet
        return None
    loop = asyncio.get_running_loop()
    root = tempfile.mkdtemp(prefix='zkbench-lg-')
    ports = allocate_ports(2 * members)
    # each member sees ~sessions/members connections (round-robin);
    # tell it so it can lift its fd limit before the wave hits, and
    # lift the overload plane's admission cap (default 4096, a
    # production defense) to the same budget — the campaign measures
    # the HOST's fd ceiling, not the admission knob's default
    need = -(-sessions // members) + 1024
    os.environ['ZKSTREAM_MEMBER_FDS'] = str(need)
    os.environ['ZKSTREAM_MAX_CONNS'] = str(need)
    fleet = [ProcMember(i, os.path.join(root, 'm%d' % i),
                        ports[2 * i], ports[2 * i + 1],
                        observer=i > 0)
             for i in range(members)]
    proc = None
    try:
        for m in fleet:
            m.spawn(fleet)
        for m in fleet:
            await m.wait_ready()
        await find_leader(fleet, min_epoch=1)
        # the session timeout must cover the WHOLE connect wave: no
        # pings flow while a thread is still handshaking, and a
        # single-core accept path sustains on the order of a thousand
        # handshakes a second — a fixed 120 s timeout would expire the
        # first sessions of a large wave before the last one connects
        st_ms = max(120000, int(sessions * 1.5))
        cmd = lg.argv(
            [('127.0.0.1', m.client_port) for m in fleet],
            sessions, duration=duration, mix=mix, ramp=ramp,
            idle_ping=idle_ping, arm_watch=arm_watch,
            fanout_sets=fanout_sets,
            setwatches_storm=setwatches_storm, pipeline=pipeline,
            stdio_sync=True, session_timeout_ms=st_ms)
        proc = subprocess.Popen(
            cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True)
        ready_s = 120.0 + sessions / 500.0
        line = await asyncio.wait_for(
            loop.run_in_executor(None, proc.stdout.readline),
            ready_s)
        assert line.startswith('READY'), line
        connected = int(line.split()[1])
        peak = [dict(_proc_stats(m.proc.pid),
                     member=m.member_id, observer=m.observer)
                for m in fleet if m.proc is not None]
        proc.stdin.write('GO\n')
        proc.stdin.flush()
        win_s = (300.0 + (duration or 0.0)
                 + sessions / 500.0
                 + (60.0 if fanout_sets else 0.0)
                 + (60.0 if setwatches_storm else 0.0))
        line = await asyncio.wait_for(
            loop.run_in_executor(None, proc.stdout.readline),
            win_s)
        proc.wait()
        cell = dict(json.loads(line), members=members, driver='c',
                    rc=proc.returncode)
        cell['connected'] = connected
        cell['members_at_peak'] = peak
        return cell
    finally:
        os.environ.pop('ZKSTREAM_MEMBER_FDS', None)
        os.environ.pop('ZKSTREAM_MAX_CONNS', None)
        if proc is not None and proc.poll() is None:
            proc.kill()
        if proc is not None:
            try:
                proc.stdout.close()
                proc.stdin.close()
            except Exception:
                pass
        for m in fleet:
            try:
                m.kill()
            except Exception:
                pass
        shutil.rmtree(root, ignore_errors=True)


def bench_million() -> None:
    """The million-session campaign (`--million`): ONE
    loadgen run per member count against a real leader + observers
    fleet — handshake wave (optionally paced with
    ZKSTREAM_BENCH_MILLION_RAMP handshakes/s), keepalive-only hold
    window with live pings, a watch armed per session, fan-out
    rounds through every armed watcher, and a post-failover-shaped
    SET_WATCHES storm.  Member RSS and fd counts are scraped at the
    all-connected peak; when the host fd/memory cap (not the server)
    bounds the session count, the cell says so by name in
    ``caps.binding_constraint``.

    The default is tier-1-safe (2000 sessions x 2s); the real
    campaign (PROFILE.md round 19) scales with
    ZKSTREAM_BENCH_MILLION_SESSIONS=1000000,
    ZKSTREAM_BENCH_MILLION_MEMBERS=3 (comma-list),
    ZKSTREAM_BENCH_MILLION_SECS and ZKSTREAM_BENCH_MILLION_RAMP."""
    import asyncio

    from .utils import loadgen as lg

    if lg.mode() != 'c' or lg.available() is None:
        print('# bench-million needs the C loadgen (no compiler or '
              'ZKSTREAM_LOADGEN=py); nothing to run',
              file=sys.stderr)
        return
    env = os.environ.get
    sessions = int(env('ZKSTREAM_BENCH_MILLION_SESSIONS', '2000'))
    member_list = [int(x) for x in
                   env('ZKSTREAM_BENCH_MILLION_MEMBERS',
                       '3').split(',') if x]
    secs = float(env('ZKSTREAM_BENCH_MILLION_SECS', '2'))
    ramp = float(env('ZKSTREAM_BENCH_MILLION_RAMP', '0'))
    for members in member_list:
        try:
            cell = asyncio.run(_loadgen_fleet_cell(
                members, sessions, duration=secs,
                ramp=ramp if ramp > 0 else None,
                idle_ping=max(1.0, secs / 2.0),
                arm_watch=True, fanout_sets=3,
                setwatches_storm=True, pipeline=1))
        except Exception as e:
            print('# million cell m=%d s=%d failed: %r'
                  % (members, sessions, e), file=sys.stderr)
            continue
        if cell is None:
            return
        print('# million_cell %s' % (json.dumps(cell),),
              file=sys.stderr)


def bench_read() -> None:
    """The read scale-out envelope (`--read`; README "Read
    plane"): paired cells at 1 vs 3 vs 5 read-serving members (leader
    + observers, real OS processes) x session sweep x read-heavy /
    mixed workloads.  Acceptance: read throughput significantly
    HIGHER at 3 and 5 members than 1 on the read-heavy cells (exact
    sign test over per-round adjacent runs), and write p50 NOT
    significantly worse with observers attached (the quorum never
    widened: observers don't vote).  Rounds via
    ZKSTREAM_BENCH_READ_ROUNDS; window via ZKSTREAM_BENCH_READ_SECS;
    narrow with --sessions / --workloads.  Table in PROFILE.md "Read
    plane"."""
    import asyncio as aio

    from .utils.metrics import sign_test_p

    rounds = int(os.environ.get('ZKSTREAM_BENCH_READ_ROUNDS', '8'))
    duration = float(os.environ.get('ZKSTREAM_BENCH_READ_SECS',
                                    '2.0'))
    sessions_sweep = _arg_ints('--sessions') or list(READ_SESSIONS)
    workloads = list(READ_WORKLOADS)
    if '--workloads' in sys.argv:
        idx = sys.argv.index('--workloads')
        workloads = sys.argv[idx + 1].split(',')
    env_sessions = os.environ.get('ZKSTREAM_BENCH_READ_SESSIONS')
    if env_sessions:
        sessions_sweep = [int(x) for x in env_sessions.split(',')]

    reads: dict = {}
    writes: dict = {}
    cells: dict = {}
    for _rnd in range(rounds):
        for sessions in sessions_sweep:
            for wl in workloads:
                for n in READ_MEMBERS:
                    key = (sessions, wl, n)
                    try:
                        r = aio.run(_read_cell(n, sessions, wl,
                                               duration))
                    except Exception as e:
                        print('# read cell m=%d s=%d %s failed: %r'
                              % (n, sessions, wl, e),
                              file=sys.stderr)
                        # placeholder keeps the per-round pairing
                        # aligned: sign() drops pairs with a None
                        reads.setdefault(key, []).append(None)
                        writes.setdefault(key, []).append(None)
                        continue
                    reads.setdefault(key, []).append(
                        r['read']['ops_per_sec'])
                    writes.setdefault(key, []).append(
                        r['write_quiet']['p50_ms'])
                    if key not in cells or r['read']['ops_per_sec'] \
                            > cells[key]['read']['ops_per_sec']:
                        cells[key] = r
    for key in sorted(cells):
        print('# read_cell %s' % (json.dumps(cells[key]),),
              file=sys.stderr)

    def sign(metric: str, rows: dict, sessions: int, wl: str,
             n: int, higher_is_better: bool) -> None:
        a = rows.get((sessions, wl, n), [])
        b = rows.get((sessions, wl, 1), [])
        paired = [(x, y) for x, y in zip(a, b)
                  if x is not None and y is not None]
        if not paired:
            return
        deltas = [(x - y) / y * 100.0 for x, y in paired if y]
        wins = sum(1 for x, y in paired
                   if (x > y) == higher_is_better and x != y)
        losses = sum(1 for x, y in paired
                     if (x > y) != higher_is_better and x != y)
        print(json.dumps({
            'metric': metric,
            'pair': '%d-vs-1' % (n,),
            'sessions': sessions,
            'workload': wl,
            'rounds': len(paired),
            'wins': wins,
            'losses': losses,
            'mean_delta_pct': round(sum(deltas)
                                    / max(1, len(deltas)), 1),
            'sign_p': round(sign_test_p(wins, losses), 4),
        }), flush=True)

    for sessions in sessions_sweep:
        for wl in workloads:
            for n in READ_MEMBERS[1:]:
                sign('read_scaleout_sign_test', reads, sessions, wl,
                     n, higher_is_better=True)
                # quiet-phase write p50: LOWER is better; the bar
                # is "not significantly worse with observers
                # attached" (the quorum never widened)
                sign('read_write_p50_sign_test', writes,
                     sessions, wl, n, higher_is_better=False)

    _bench_read_cached(rounds, duration)


def _bench_read_cached(rounds: int, duration: float) -> None:
    """The cached arm of `--read` (README "Client cache
    plane"): paired uncached-vs-cached C-loadgen cells against the
    same single-member fleet shape.  The cached arm arms one
    persistent-recursive ADD_WATCH per session (io/cache.py shape)
    and serves steady reads from the local entry, so the server only
    sees invalidation-driven refill reads.  Acceptance: server-side
    read QPS reduced >= 95% on every pair (exact sign test at the
    95% bar, not at break-even) and cached p50 in single-digit
    microseconds.  Narrow with ZKSTREAM_BENCH_READ_CACHED_ROUNDS /
    _SESSIONS; table in PROFILE.md "Read plane"."""
    import asyncio as aio

    from .utils import loadgen as lg
    from .utils.metrics import sign_test_p

    if lg.mode() != 'c' or lg.available() is None:
        print('# cached read arm needs the C loadgen (no compiler '
              'or ZKSTREAM_LOADGEN=py); skipped', file=sys.stderr)
        return
    rounds = int(os.environ.get('ZKSTREAM_BENCH_READ_CACHED_ROUNDS',
                                str(rounds)))
    sessions = int(os.environ.get(
        'ZKSTREAM_BENCH_READ_CACHED_SESSIONS', '100'))
    pairs: list[tuple[dict, dict]] = []
    best: dict = {}
    for _rnd in range(rounds):
        row: dict = {}
        for cached in (False, True):
            arm = 'cached' if cached else 'uncached'
            try:
                r = aio.run(_read_cell(1, sessions, 'read', duration,
                                       cached=cached))
            except Exception as e:
                print('# cached read cell %s s=%d failed: %r'
                      % (arm, sessions, e), file=sys.stderr)
                row = {}
                break
            row[arm] = r
            if arm not in best or (r['read']['ops_per_sec']
                                   > best[arm]['read']['ops_per_sec']):
                best[arm] = r
        if row:
            pairs.append((row['uncached'], row['cached']))
    for arm in sorted(best):
        print('# read_cached_cell %s'
              % (json.dumps(dict(best[arm], arm=arm)),),
              file=sys.stderr)
    if not pairs:
        return
    # exact sign test AT THE 95% BAR: a pair only counts as a win
    # when the cached arm's server-side read rate is below 5% of the
    # uncached arm's — break-even or a mere improvement is a loss
    wins = losses = 0
    reductions: list[float] = []
    p50s: list[float] = []
    for u, cc in pairs:
        uq = u['read']['server_ops_per_sec']
        cq = cc['read']['server_ops_per_sec']
        if uq > 0:
            reductions.append((uq - cq) / uq * 100.0)
        if cq < uq * 0.05:
            wins += 1
        else:
            losses += 1
        p50s.append(cc['cache']['hit_p50_us'])
    print(json.dumps({
        'metric': 'read_cached_qps_reduction_sign_test',
        'pair': 'cached-vs-uncached',
        'bar': 'server read QPS reduced >= 95%',
        'sessions': sessions,
        'rounds': len(pairs),
        'wins': wins,
        'losses': losses,
        'mean_reduction_pct': round(
            sum(reductions) / max(1, len(reductions)), 2),
        'cached_hit_p50_us': round(
            sorted(p50s)[len(p50s) // 2], 3),
        'sign_p': round(sign_test_p(wins, losses), 4),
    }), flush=True)


def _device_arg() -> str:
    """``--device cuda|cpu`` from sys.argv; ``cuda`` by default, as the
    port's CLI."""
    if '--device' not in sys.argv:
        return 'cuda'
    idx = sys.argv.index('--device')
    if idx + 1 >= len(sys.argv) or sys.argv[idx + 1] not in ('cuda',
                                                               'cpu'):
        raise SystemExit('bench: --device takes cuda or cpu')
    return sys.argv[idx + 1]


def _card(dev) -> dict:
    """What a result line says of the device it ran on: the card's
    name and its power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them (a card set below
    its maximum runs slower under load), or the host CPU's name."""
    if dev.type != 'cuda':
        import platform
        return {'device': platform.processor() or platform.machine(),
                'power_limit': None}
    import subprocess

    import torch

    rows = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    row = rows[dev.index or 0]
    return {'device': torch.cuda.get_device_name(dev),
            'power_limit': row.rsplit(',', 1)[1].strip()}


#: The host-only families, in the order their flags are matched: none
#: touches a device or loads torch.
_HOST_FAMILIES = (
    # the paired durability-plane cell family (wal-off vs sync=tick vs
    # sync=always, write-heavy)
    ('--wal', 'bench_wal'),
    # the coordination-plane failover family (leader kill -> elected
    # successor, 3 vs 5 members)
    ('--election', 'bench_election'),
    # the quorum-commit cost family (quorum-on/off at 3/5 members +
    # MULTI batching cells)
    ('--quorum', 'bench_quorum'),
    # the dynamic-membership cost family (steady vs during-observer-
    # join vs during-voter-replace write p50s, paired sign tests)
    ('--reconfig', 'bench_reconfig'),
    # the paired trace-plane overhead family (server span rings + tick
    # ledger vs ZKSTREAM_NO_SERVER_TRACE=1)
    ('--traceov', 'bench_trace_overhead'),
    # the paired black-box-plane overhead family (flight recorder +
    # slow-op digest vs ZKSTREAM_NO_BLACKBOX=1, WAL-backed cells)
    ('--blackbox', 'bench_blackbox_overhead'),
    # the overload plane's cost + defense family (stalled-consumer
    # defense cells + plane-overhead cells vs ZKSTREAM_NO_OVERLOAD=1)
    ('--overload', 'bench_overload'),
    # the batched-syscall transport-tier family (io/transport.py:
    # uring/mmsg vs the asyncio validator) over real kernel sockets
    ('--transport', 'bench_transport'),
    # the shared-nothing ingress family (io/ingress.py: multi-shard
    # batched receive drain vs the single-loop validator)
    ('--ingress', 'bench_ingress'),
    # the serving-plane fan-out family (sharded watch table vs
    # per-connection emitter dispatch); no kernel sockets
    ('--fanout', 'bench_fanout'),
    # the read scale-out family (README "Read plane": 1 vs 3 vs 5
    # read-serving members as real OS processes)
    ('--read', 'bench_read'),
    # the million-session campaign (README "Load generation"):
    # handshake waves, keepalive hold, per-session watches with
    # fan-out and a SET_WATCHES storm, driven by the C loadgen
    # against a real member fleet
    ('--million', 'bench_million'),
)


def metric_lines(tick: float, full: float, full_deployed: float,
                 scalar: float, scalar_full: float,
                 where: dict) -> list[dict]:
    """The bench's three result lines, the flagship last, each with
    ``where``'s keys (``backend``, ``device``, ``power_limit``)."""
    return [
        # the protocol tick (headers + routing) against the scalar tick
        dict({'metric': 'wire_decode_throughput',
              'value': round(tick, 2),
              'unit': 'MiB/s',
              'vs_baseline': round(tick / scalar, 3)}, **where),
        # the toy-width full decode (kept for series comparability with
        # the reference bench's lines)
        dict({'metric': 'wire_full_decode_toy_width',
              'value': round(full, 2),
              'unit': 'MiB/s',
              'vs_baseline': round(full / scalar_full, 3),
              'widths': 'data16/path8'}, **where),
        # the flagship: FULL decode at the DEPLOYED body configuration
        # (io/ingest.py defaults: 256-byte data/path planes +
        # children/ACL list planes) vs the scalar codec doing the same
        # complete work
        dict({'metric': 'wire_full_decode_throughput',
              'value': round(full_deployed, 2),
              'unit': 'MiB/s',
              'vs_baseline': round(full_deployed / scalar_full, 3),
              'widths': 'data256/path256/ch16x64/acl4',
              'corpus': 'mixed-opcode %dx%d (data/children/acl/notif/'
                        'err/ping)' % (B, FRAMES),
              'toy_width_mibs': round(full, 2)}, **where),
    ]


def main() -> None:
    for flag, fn in _HOST_FAMILIES:
        if flag in sys.argv:
            globals()[fn]()
            return
    device = _device_arg()
    if '--write' in sys.argv:
        # the write-heavy client-ops cell family only — no flagship
        # decode stages (they are unrelated to the outbound plane);
        # its ingest arm runs on --device
        bench_client_ops(write_heavy=True, device=device)
        return

    from .ops import full_scan, wire_scan
    from .ops.pipeline import resolve_device

    dev = resolve_device(device)      # raises without a card
    card = _card(dev)
    buf, lens, streams, slots = _fleet()
    scalar = bench_scalar(streams)
    scalar_full, pkts = bench_scalar_full(streams, slots)
    ext_full = bench_ext_full(streams, slots)
    calls: dict = {}
    wire_scan.launches = full_scan.launches = 0
    tick, full, full_deployed = bench_tensor(buf, lens, streams, pkts,
                                             slots, device=dev,
                                             calls=calls)
    k1, k2 = wire_scan.launches, full_scan.launches
    want = ((calls['tick'], calls['full'] + calls['full-deployed'])
            if dev.type == 'cuda' else (0, 0))
    print('# kernel launches in bench_tensor on %s: K1 %d (tick calls '
          '%d), K2 %d (full-decode calls %d + %d)'
          % (dev, k1, calls['tick'], k2, calls['full'],
             calls['full-deployed']), file=sys.stderr)
    assert (k1, k2) == want, \
        'kernel launches %r, expected %r' % ((k1, k2), want)
    print(f'# scalar tick baseline: {scalar:.2f} MiB/s over {B} '
          f'streams x {FRAMES} frames (headers only, equal work)',
          file=sys.stderr)
    print(f'# scalar full-decode baseline: {scalar_full:.2f} MiB/s '
          f'over {SCALAR_FULL_STREAMS} streams (framing + header + '
          f'body -> packet dicts, mixed opcodes)', file=sys.stderr)
    if ext_full is not None:
        print(f'# C-extension full decode: {ext_full:.2f} MiB/s '
              f'(this framework\'s own native scalar path)',
              file=sys.stderr)
    # MiB/s here counts WIRE BYTES PROCESSED per second, not bytes
    # touched: the header scan reads the ~20 B of a frame's prefix and
    # header, and the full decode ~(20 + data + Stat) B of each frame,
    # so a rate above the card's memory rate does not break its bound
    # (most wire bytes are payload the decode only slices)
    print('# note: MiB/s = wire bytes processed; see the note in '
          'the bench\'s main()', file=sys.stderr)
    tick_line, toy_line, flagship = metric_lines(
        tick, full, full_deployed, scalar, scalar_full,
        dict(card, backend=dev.type))
    print(json.dumps(tick_line), flush=True)
    print(json.dumps(toy_line), flush=True)
    try:
        bench_client_ops(device=device)
    except Exception as e:  # secondary metrics never sink the run
        print('# client_ops stage failed: %r' % (e,), file=sys.stderr)
    sys.stderr.flush()
    # the flagship, printed last: the headline is the number the shipped
    # configuration produces
    print(json.dumps(flagship), flush=True)


if __name__ == '__main__':
    main()
