"""The plain reference of the YCSB cells.

From the seed alone it regenerates every session's ops (``traffic/
ycsb_ops.py``: records, reads or updates, and each update's value) and
every record's preloaded value, then judges what the harness recorded
the port returning:

- each reply: a read's data must be a value that was written to that
  record (preloaded, or an update to it that had been called before
  the read settled), with that write's ``mzxid``, ``version`` and
  ``mtime`` as the update's own reply gave them; an update's Stat
  must carry the record's one ``czxid``, a data length of the value's,
  no children, no owner, and, over every acknowledged update of a
  record in ``mzxid`` order, versions that count up by one from the
  load's 0;
- the read guarantee the configuration states, linearizable reads: no
  read returns a value older than an update acknowledged before the
  read was called, or older than one its own session had already
  seen;
- the end state: every record as the server serves it after the run,
  and as its write-ahead log recovers it, is the value of its
  acknowledged update with the highest ``mzxid`` (or its preload), at
  the version of its count of updates.

Every compared number is a count of failures, with the limit 0.
"""

from __future__ import annotations

import bisect
import collections

from ..traffic import ycsb_ops as ops

#: The znode Stat record's eleven fields, as the wire carries them.
Stat = collections.namedtuple('Stat', (
    'czxid', 'mzxid', 'ctime', 'mtime', 'version', 'cversion', 'aversion',
    'ephemeralOwner', 'dataLength', 'numChildren', 'pzxid'))

#: The Stat fields of a record that no op of these mixes changes.
_STILL = ('cversion', 'aversion', 'ephemeralOwner', 'numChildren')


def _streams(seed, mix, config, log, inflight) -> dict:
    """session -> its ops regenerated, as far as the run got."""
    counts: dict = {}
    for s, j in zip(log.session, log.index):
        counts[s] = max(counts.get(s, 0), j + 1)
    for s, (j, _r, _t0) in inflight.items():
        counts[s] = max(counts.get(s, 0), j + 1)
    return {s: ops.Stream(seed, s, mix, config).take(n)
            for s, n in counts.items()}


def check(seed: int, mix: dict, config: dict, log, inflight: dict,
          readbacks: list, recovered: list) -> dict:
    """The counts the run is judged by: ``{name: (value, limit)}``."""
    if config['guarantees']['reads'] != 'linearizable':
        raise ValueError('the reference judges linearizable reads only')
    width = config['value_bytes']
    streams = _streams(seed, mix, config, log, inflight)
    preload = ops.preload_values(seed, config)
    origin = {v: ('load', r) for r, v in enumerate(preload)}
    for s, st in streams.items():
        for j, (kind, r, v) in enumerate(st):
            if kind == ops.UPDATE:
                origin[v] = (s, j)
    wrong = 0
    # the log's ops against the streams, and each session's op order
    op_at: dict = {}
    for i in range(len(log.session)):
        s, j = log.session[i], log.index[i]
        kind, r, _v = streams[s][j]
        if kind != log.kind[i] or r != log.record[i]:
            wrong += 1
        op_at[(s, j)] = i
    # acknowledged updates per record: (mzxid, version, mtime, t0, t1,
    # session, index)
    acked: dict = {}
    unacked: dict = {}                   # record -> values maybe applied
    czxids: dict = {}
    for i in range(len(log.session)):
        if log.kind[i] != ops.UPDATE:
            continue
        r = log.record[i]
        if log.error[i] is not None:
            unacked.setdefault(r, set()).add(
                streams[log.session[i]][log.index[i]][2])
            continue
        st = log.stat[i]
        acked.setdefault(r, []).append(
            (st.mzxid, st.version, st.mtime, log.t0[i], log.t1[i],
             log.session[i], log.index[i]))
        czxids.setdefault(r, {}).setdefault(st.czxid, 0)
        czxids[r][st.czxid] += 1
        if (st.dataLength != width or st.pzxid != st.czxid
                or st.mzxid <= st.czxid
                or any(getattr(st, f) for f in _STILL)):
            wrong += 1
    for s, (j, r, _t0) in inflight.items():
        kind, _r, v = streams[s][j]
        if kind == ops.UPDATE:
            unacked.setdefault(r, set()).add(v)
    for i in range(len(log.session)):
        if log.kind[i] == ops.READ and log.error[i] is None:
            st = log.stat[i]
            czxids.setdefault(log.record[i], {}).setdefault(st.czxid, 0)
            czxids[log.record[i]][st.czxid] += 1
    # the record's one czxid: every Stat of it must carry the same
    czxid = {}
    for r, seen in czxids.items():
        best = max(seen, key=seen.get)
        czxid[r] = best
        wrong += sum(n for z, n in seen.items() if z != best)
    by_zxid: dict = {}                   # record -> acked sorted by mzxid
    by_done: dict = {}                   # record -> (t1s, running max mzxid)
    for r, ws in acked.items():
        ws.sort()
        zx = [w[0] for w in ws]
        if len(set(zx)) != len(zx):
            wrong += len(zx) - len(set(zx))
        versions = [w[1] for w in ws]
        if r in unacked:
            wrong += sum(1 for a, b in zip(versions, versions[1:])
                         if b <= a)
        else:
            wrong += sum(1 for k, v in enumerate(versions) if v != k + 1)
        by_zxid[r] = (zx, ws)
        done = sorted((w[4], w[0]) for w in ws)
        t1s, hi, m = [], [], 0
        for t1, z in done:
            m = max(m, z)
            t1s.append(t1)
            hi.append(m)
        by_done[r] = (t1s, hi)
    # the reads
    floors: dict = {}                    # session -> newest mzxid seen
    order = sorted(range(len(log.session)),
                   key=lambda i: (log.session[i], log.index[i]))
    for i in order:
        s, st = log.session[i], log.stat[i]
        if log.error[i] is not None:
            continue
        floor = floors.get(s, 0)
        if log.kind[i] == ops.UPDATE:
            floors[s] = max(floor, st.mzxid)
            continue
        r, data = log.record[i], bytes(log.data[i])
        src = origin.get(data)
        if (src is None or len(data) != st.dataLength
                or st.czxid != czxid.get(r) or st.pzxid != st.czxid
                or any(getattr(st, f) for f in _STILL)):
            wrong += 1
            continue
        if src[0] == 'load':
            ok = src[1] == r and st.version == 0 and st.mzxid == st.czxid
        else:
            ws, wj = src
            _kind, wr, _v = streams[ws][wj]
            wi = op_at.get((ws, wj))
            ok = wr == r
            if ok and wi is not None and log.error[wi] is None:
                w = log.stat[wi]
                ok = (st.mzxid == w.mzxid and st.version == w.version
                      and st.mtime == w.mtime
                      and log.t0[wi] <= log.t1[i])
            elif ok:
                # an update that failed or never settled may still have
                # been applied; it must have been called before this
                # read settled
                t_call = (log.t0[wi] if wi is not None
                          else inflight[ws][2])
                ok = t_call <= log.t1[i]
        if ok and r in by_zxid:
            zx, _ws = by_zxid[r]
            # the oldest acknowledged update newer than what was read
            k = bisect.bisect_right(zx, st.mzxid)
            newer = zx[k] if k < len(zx) else None
            if newer is not None and newer <= floor:
                ok = False               # older than the session's view
            if ok:
                t1s, hi = by_done[r]
                n = bisect.bisect_left(t1s, log.t0[i])
                if n and hi[n - 1] > st.mzxid:
                    ok = False           # older than an acked update
        if not ok:
            wrong += 1
        floors[s] = max(floor, st.mzxid)
    # the end state, as served and as recovered
    final = {}
    for r in range(config['recordcount']):
        ws = by_zxid.get(r, ([], []))[1]
        if ws:
            last = ws[-1]
            final[r] = (streams[last[5]][last[6]][2], len(ws), last[0])
        else:
            final[r] = (preload[r], 0, None)

    def lost(state: dict, served: bool) -> int:
        bad = 0
        for r, (want, n, mzxid) in final.items():
            got = state.get(r)
            if got is None:
                bad += 1
                continue
            if served:
                data, st = got
                version, zx = st.version, st.mzxid
            else:
                data, version, zx = got
            if r in unacked:
                ok = ((data == want or data in unacked[r])
                      and version >= n)
            else:
                ok = (data == want and version == n
                      and (mzxid is None or zx == mzxid))
            bad += not ok
        return bad

    return {
        'wrong_replies': (wrong, 0),
        'failed_ops': (sum(1 for e in log.error if e is not None), 0),
        'unsettled_ops': (len(inflight), 0),
        'lost_writes': (sum(lost(rb, True) for rb in readbacks), 0),
        'wal_lost_writes': (sum(lost(rc, False) for rc in recovered), 0),
    }
