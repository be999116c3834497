"""Cost guard for the port's WGL linearizability checker: the port's
copy of the JAX package's ``tools/bench_linearize.py``, on the port's
``analysis/linearize.check_linearizable`` and ``io/invariants.History``.

WGL is exponential in the worst case; what keeps invariant 9 cheap on
real campaign histories is the per-key partition (MULTI links merge
components) plus the zxid-order pruning over completed writes.  This
tool measures check time against synthetic-but-valid concurrent
histories across (history length x client width) cells — generated
by simulating the sequential spec under randomly overlapping
intervals, ambiguous ops included, so every history is linearizable
by construction and a finding here would be a checker false positive
— and ASSERTS the budget the 120-schedule concurrent campaign
depends on:

- the campaign-shaped cell (one schedule's worth: ~3 clients x 12
  ops each) must check in under ``CAMPAIGN_BUDGET_MS``;
- every cell, up to 8 clients x 960 ops, must check in under
  ``CELL_BUDGET_MS``.

Exit 0 when every cell is inside budget and every generated history
checks clean; 1 otherwise.

Usage: python -m zkstream_tpu_torch.tools.bench_linearize [--rounds 3]
"""

from __future__ import annotations

import argparse
import random
import sys
import time

from ..analysis.linearize import check_linearizable
from ..io.invariants import History

#: Per-cell hard ceiling, ms (median of the measured rounds).
CELL_BUDGET_MS = 2000.0
#: The campaign-shaped cell's ceiling, ms: 120 schedules x this
#: bound stays well under a minute of checker time per campaign.
CAMPAIGN_BUDGET_MS = 250.0

#: (total ops, concurrent clients) cells; the first is the shape one
#: concurrent schedule produces (3 clients x 12 ops).
CELLS = ((36, 3), (60, 2), (60, 4), (240, 4), (240, 8), (960, 8))

KEYS = ('/k0', '/k1', '/k2')


def synth_history(seed: int, length: int, clients: int,
                  p_ambig: float = 0.06,
                  p_multi: float = 0.08) -> tuple[History, dict]:
    """A valid concurrent history: ops apply to the sequential spec
    at invocation (so the invoke order IS a linearization) but
    settle after a random number of later invokes — genuinely
    overlapping intervals the checker must disentangle.  Ambiguous
    ops randomly apply or vanish and never settle with an outcome.
    Returns ``(history, final_states)``."""
    rng = random.Random('bench-lin/%d' % (seed,))
    h = History()
    state: dict = {}                  # key -> (data, version, mzxid)
    zxid = [0]
    #: calls waiting to settle: [(remaining_invokes, settle_thunk)]
    pending: list = []
    outstanding: set[int] = set()     # clients with an open call

    def flush(force: bool = False) -> None:
        keep = []
        for left, ci, thunk in pending:
            if left <= 0 or force:
                thunk()
                outstanding.discard(ci)
            else:
                keep.append((left - 1, ci, thunk))
        pending[:] = keep

    def mutate(key: str, op: str, data, known_zxid: bool):
        """Apply a write to the spec; returns (outcome, zxid)."""
        st = state.get(key)
        if op == 'create':
            if st is not None:
                return 'NODE_EXISTS', None
            zxid[0] += 1
            z = zxid[0] if known_zxid else None
            state[key] = (data, 0, z)
            return 'ok', z
        if op == 'set':
            if st is None:
                return 'NO_NODE', None
            zxid[0] += 1
            z = zxid[0] if known_zxid else None
            state[key] = (data, st[1] + 1, z)
            return 'ok', z
        assert op == 'delete'
        if st is None:
            return 'NO_NODE', None
        zxid[0] += 1
        state[key] = None
        return 'ok', zxid[0] if known_zxid else None

    invoked = 0
    while invoked < length:
        free = [ci for ci in range(clients)
                if ci not in outstanding]
        if not free:
            flush(force=False)
            if all(left > 0 for left, _, _ in pending):
                flush(force=True)
            continue
        ci = rng.choice(free)
        key = rng.choice(KEYS)
        tag = b'b%d' % (invoked,)
        roll = rng.random()
        delay = rng.randint(0, 3)
        if roll < p_multi:
            ka, kb = rng.sample(KEYS, 2)
            subs = [('set_data', ka, tag + b'a', -1),
                    ('set_data', kb, tag + b'b', -1)]
            call = h.invoke('multi', None, client=ci, subs=subs)
            if state.get(ka) is None or state.get(kb) is None:
                thunk = (lambda c=call: h.settle(
                    c, 'error', error='MULTI_REJECTED'))
            else:
                # one zxid PER sub-op; the reply carries the last
                sa, sb = state[ka], state[kb]
                state[ka] = (tag + b'a', sa[1] + 1, zxid[0] + 1)
                state[kb] = (tag + b'b', sb[1] + 1, zxid[0] + 2)
                zxid[0] += 2
                thunk = (lambda c=call, z=zxid[0]: h.settle(
                    c, 'ok', zxid=z))
        elif roll < p_multi + 0.35:
            call = h.invoke('get', key, client=ci)
            st = state.get(key)
            if st is None:
                thunk = (lambda c=call: h.settle(
                    c, 'error', error='NO_NODE'))
            else:
                thunk = (lambda c=call, st=st: h.settle(
                    c, 'ok', zxid=st[2], data=st[0],
                    version=st[1]))
        else:
            op = rng.choice(('create', 'set', 'set', 'set',
                             'delete'))
            ambig = rng.random() < p_ambig
            call = h.invoke(op, key, client=ci,
                            data=tag if op != 'delete' else None)
            if ambig:
                # never settles; applies on a coin flip
                if rng.random() < 0.5:
                    mutate(key, op, tag, known_zxid=False)
                thunk = None
            else:
                outcome, z = mutate(key, op, tag, known_zxid=True)
                if outcome == 'ok':
                    ver = (state[key][1]
                           if state.get(key) is not None else None)
                    thunk = (lambda c=call, z=z, v=ver: h.settle(
                        c, 'ok', zxid=z, version=v))
                else:
                    thunk = (lambda c=call, o=outcome: h.settle(
                        c, 'error', error=o))
        invoked += 1
        if thunk is not None:
            outstanding.add(ci)
            pending.append((delay, ci, thunk))
    flush(force=True)
    finals = {k: (st[0] if st is not None else None)
              for k, st in state.items()}
    for k in KEYS:
        finals.setdefault(k, None)
    return h, finals


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--rounds', type=int, default=3,
                    help='timed repetitions per cell (median wins)')
    args = ap.parse_args(argv)

    print('%-8s %-8s %-10s %-12s %s'
          % ('ops', 'clients', 'intervals', 'check_ms', 'verdict'))
    failed = False
    for length, clients in CELLS:
        h, finals = synth_history(length, length, clients)
        n_ops = sum(1 for r in h.records if r['kind'] == 'invoke')
        times = []
        findings = None
        for _ in range(max(1, args.rounds)):
            t0 = time.perf_counter()
            findings = check_linearizable(h, finals)
            times.append((time.perf_counter() - t0) * 1000.0)
        ms = sorted(times)[len(times) // 2]
        budget = CAMPAIGN_BUDGET_MS if (length, clients) == CELLS[0] \
            else CELL_BUDGET_MS
        ok = not findings and ms <= budget
        verdict = 'ok' if ok else 'OVER BUDGET (%.0f ms cap)' \
            % (budget,) if not findings else 'FALSE POSITIVE'
        print('%-8d %-8d %-10d %-12.2f %s'
              % (length, clients, n_ops, ms, verdict))
        if findings:
            for v in findings[:2]:
                print('  finding on a valid history: %s' % (v,))
        failed = failed or not ok
    if failed:
        print('bench-linearize: BUDGET EXCEEDED or checker false '
              'positive', file=sys.stderr)
        return 1
    print('bench-linearize: every cell inside budget '
          '(campaign cell <= %.0f ms, all cells <= %.0f ms)'
          % (CAMPAIGN_BUDGET_MS, CELL_BUDGET_MS))
    return 0


if __name__ == '__main__':
    sys.exit(main())
