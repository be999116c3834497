"""The plain reference against hand-built histories: a sound one reads
0 on every count, and each kind of fault reads above it."""

from zkbench.reference import ycsb as ref_ycsb
from zkbench.traffic import ycsb_ops
from zkbench.traffic.ycsb import OpLog

Stat = ref_ycsb.Stat
SEED = 2**31 + 17
CONFIG = {'recordcount': 3, 'value_bytes': 16, 'table': '/t',
          'guarantees': {'reads': 'linearizable'}}
MIX = {'readproportion': 0.5, 'updateproportion': 0.5,
       'requestdistribution': 'zipfian', 'zipfian_constant': 0.99}


def _history(sessions=2, per=30):
    """Run the sessions' streams one op at a time, round robin, on a
    plain model of the records, as a sound server would answer."""
    preload = ycsb_ops.preload_values(SEED, CONFIG)
    czxid = {r: r + 1 for r in range(3)}
    state = {r: (preload[r], 0, czxid[r], 1000 + r) for r in range(3)}
    zxid, clock = 10, 0.0
    log = OpLog()
    streams = [ycsb_ops.Stream(SEED, s, MIX, CONFIG) for s in range(sessions)]
    for _ in range(per):
        for s, st in enumerate(streams):
            j = st.n
            kind, r, v = st.next()
            t0, t1 = clock, clock + 0.5
            clock += 1.0
            if kind == ycsb_ops.UPDATE:
                zxid += 1
                version = state[r][1] + 1
                state[r] = (v, version, zxid, 2000 + zxid)
                data = None
            else:
                data = state[r][0]
            val, version, mzxid, mtime = state[r]
            stat = Stat(czxid[r], mzxid, 1000 + r, mtime, version, 0, 0, 0,
                        len(val), 0, czxid[r])
            log.add(s, j, kind, r, t0, t1, stat, data, None)
    served = {r: (state[r][0], Stat(czxid[r], state[r][2], 1000 + r,
                                    state[r][3], state[r][1], 0, 0, 0,
                                    len(state[r][0]), 0, czxid[r]))
              for r in range(3)}
    recovered = {r: (state[r][0], state[r][1], state[r][2])
                 for r in range(3)}
    return log, served, recovered


def _check(log, served, recovered, inflight=None):
    out = ref_ycsb.check(SEED, MIX, CONFIG, log.rows(), inflight or {},
                         [served], [recovered])
    return {k: v for k, (v, _lim) in out.items()}


def test_sound_history_reads_zero():
    log, served, recovered = _history()
    assert set(_check(log, served, recovered).values()) == {0}


def test_a_stale_read_is_wrong():
    log, served, recovered = _history()
    rows = log.rows()
    # the last read of a record that was updated before it: hand it the
    # record's preloaded value instead
    preload = ycsb_ops.preload_values(SEED, CONFIG)
    for i in reversed(range(len(rows.kind))):
        r = rows.record[i]
        if (rows.kind[i] == ycsb_ops.READ
                and rows.data[i] != preload[r]):
            log.data[i] = preload[r]
            break
    else:
        raise AssertionError('no read after an update')
    assert _check(log, served, recovered)['wrong_replies'] >= 1


def test_an_altered_byte_is_wrong():
    log, served, recovered = _history()
    i = next(i for i, d in enumerate(log.data) if d)
    log.data[i] = bytes([log.data[i][0] ^ 1]) + log.data[i][1:]
    assert _check(log, served, recovered)['wrong_replies'] == 1


def test_a_lost_write_is_lost_on_the_server_and_in_the_log():
    log, served, recovered = _history()
    r = 0
    preload = ycsb_ops.preload_values(SEED, CONFIG)
    served[r] = (preload[r], served[r][1]._replace(version=0))
    recovered[r] = (preload[r], 0, 1)
    out = _check(log, served, recovered)
    assert out['lost_writes'] == 1 and out['wal_lost_writes'] == 1


def test_an_op_that_never_settled_and_one_that_failed():
    log, served, recovered = _history()
    log.errors[3] = 'ZKDeadlineError()'
    out = _check(log, served, recovered, inflight={1: (99, 0, 0.0)})
    assert out['failed_ops'] == 1 and out['unsettled_ops'] == 1
