"""FleetIngest's dispatch policy held to the JAX package's, on the CPU.

The byte threshold (``bypass_bytes``) and the fragmentation guard
(``FRAG_MIN_FLEET``, ``FRAG_ENTER``, ``FRAG_EXIT``) route every tick of
a default ``FleetIngest()`` to the device or to the scalar drain.  The
same seeded tick sequence (bytes a tick, frames a tick, fleet size)
goes through the port's and the reference's ingest, with the
reference's constants and with the port's shipped ones, and both must
route it tick for tick alike.  The port's crossover tool can top its
cells up with idle sessions; with none, a cell keeps the reference
tool's keys.
"""

from __future__ import annotations

import asyncio
import inspect

import numpy as np
import pytest

from test_torch_ingest_failures import (PORT, REF, FakeConn, drain,
                                        mk_ingest, reply_frame)
from test_torch_tools import reference_cell_keys  # noqa: F401 (fixture)
from zkstream_tpu.io.ingest import FleetIngest as RefFleetIngest
from zkstream_tpu_torch.io.ingest import FleetIngest
from zkstream_tpu_torch.tools import sweep_crossover as SC

#: the reference's dispatch constants (its bypass is an argument
#: default, the guard class attributes) and the port's shipped ones
CONSTANTS = {
    'reference': (
        inspect.signature(RefFleetIngest.__init__)
        .parameters['bypass_bytes'].default,
        RefFleetIngest.FRAG_MIN_FLEET, RefFleetIngest.FRAG_ENTER,
        RefFleetIngest.FRAG_EXIT),
    'port': (FleetIngest.BYPASS_BYTES, FleetIngest.FRAG_MIN_FLEET,
             FleetIngest.FRAG_ENTER, FleetIngest.FRAG_EXIT),
}

#: a notification frame is 32 bytes and its path
_NOTIFY_OVERHEAD = 32
_TICKS_A_PHASE = 8


def tick_sequence(seed: int, bypass: int, min_fleet: int, enter: float,
                  exit_: float) -> list[tuple[int, int, int]]:
    """``(bytes, frames, fleet)`` for each tick: phases of eight ticks,
    each phase with a fleet below or above ``min_fleet``, a fill below
    ``enter``, between ``enter`` and ``exit_`` or above ``exit_``, and
    bytes a tick well below or above ``bypass``; every tick jittered."""
    rng = np.random.default_rng(seed)
    fills = (enter / 3, (enter + exit_) / 2, min(1.0, 2 * exit_))
    seq = []
    for _phase in range(12):
        fleet = int(min_fleet * rng.choice((0.5, 1.25)))
        fill = fills[rng.integers(len(fills))]
        nbytes = bypass * rng.choice((0.25, 4.0))
        for _ in range(_TICKS_A_PHASE):
            frames = int(np.clip(round(fill * fleet * rng.uniform(0.8, 1.2)),
                                 1, fleet))
            b = int(nbytes * rng.uniform(0.8, 1.2))
            seq.append((max(b, frames * (_NOTIFY_OVERHEAD + 1)), frames,
                        fleet))
    return seq


async def route(pkg, seq, consts) -> list[str]:
    """Feed ``seq`` through ``pkg``'s ingest at ``consts``: every tick,
    ``frames`` connections of a fleet of ``fleet`` each get one
    notification, ``bytes`` in all.  Returns each tick's route:
    ``device``, ``scalar`` or ``frag`` (a scalar tick the guard sent)."""
    bypass, min_fleet, enter, exit_ = consts
    ing = mk_ingest(pkg, bypass_bytes=bypass, frag_guard=True,
                    max_frames=2)
    ing.FRAG_MIN_FLEET, ing.FRAG_ENTER, ing.FRAG_EXIT = \
        min_fleet, enter, exit_
    conns: list = []
    made: list = []
    routes = []
    for t, (nbytes, frames, fleet) in enumerate(seq):
        while len(conns) < fleet:
            conns.append(FakeConn(pkg))
            made.append(conns[-1])
            ing.register(conns[-1])
        while len(conns) > fleet:
            ing.unregister(conns.pop())
        size = nbytes // frames
        for i in range(frames):
            path = '/' + 'p' * (size - _NOTIFY_OVERHEAD - 1)
            ing.feed(conns[i], reply_frame(-1, 'NOTIFICATION', zxid=t,
                                           pkg=pkg, type='DATA_CHANGED',
                                           state='SYNC_CONNECTED',
                                           path=path))
        before = (ing.ticks, ing.ticks_scalar, ing.ticks_frag)
        await drain()
        d = tuple(a - b for a, b in zip(
            (ing.ticks, ing.ticks_scalar, ing.ticks_frag), before))
        routes.append({(1, 0, 0): 'device', (0, 1, 0): 'scalar',
                       (0, 1, 1): 'frag'}[d])
    # every frame delivered, whichever way its tick went
    assert sum(len(p) for c in made for p, _e in c.delivered) == \
        sum(f for _b, f, _fleet in seq)
    return routes


@pytest.mark.parametrize('which', sorted(CONSTANTS))
async def test_routing_sequence_equals_reference(which):
    """Device, scalar and frag ticks, tick for tick, alike on both
    packages at the same constants; the sequence reaches all three."""
    consts = CONSTANTS[which]
    seq = tick_sequence(17, *consts)
    got = await route(PORT, seq, consts)
    assert got == await route(REF, seq, consts)
    assert {'device', 'scalar', 'frag'} <= set(got), got


async def test_shipped_constants_are_defaults():
    """A default ingest routes by the class constants, on both
    packages' names."""
    ing = FleetIngest(device='cpu')
    assert (ing.bypass_bytes, ing.FRAG_MIN_FLEET, ing.FRAG_ENTER,
            ing.FRAG_EXIT) == CONSTANTS['port']
    assert ing.frag_guard is True
    assert FleetIngest.FRAG_ENTER < FleetIngest.FRAG_EXIT
    ref = RefFleetIngest(placement='host')
    assert (ref.bypass_bytes, ref.FRAG_MIN_FLEET, ref.FRAG_ENTER,
            ref.FRAG_EXIT) == CONSTANTS['reference']


#: what the port's cells hold beside the reference tool's keys: the
#: get count and its expected value, the storms' fired counts, and the
#: ingest's bytes and kernel launches
_PORT_EXTRA = {'get': {'count', 'expected'}, 'fanout': {'fired'},
               'ingest': {'bytes', 'bytes_per_tick', 'body_fallbacks',
                          'k1_launches', 'k2_launches'}}


def _cell_keys(r: dict) -> dict:
    return {k: sorted(v) if isinstance(v, dict) and k != 'flush' else None
            for k, v in r.items()}


def test_idle_sessions_engage_frag_guard(reference_cell_keys,  # noqa: F811
                                         monkeypatch):
    """8 active clients and 8 idle ones on one ingest: the guard's fleet
    floor, scaled to the 16 sessions, is reached only with the idle
    sessions, and the guard then sends fragmented ticks to the scalar
    drain.  With no idle sessions the cell has the reference tool's
    keys, and the port's counters beside them."""
    monkeypatch.setattr(SC, 'GETS_TOTAL', 256)
    monkeypatch.setattr(FleetIngest, 'FRAG_MIN_FLEET', 16)
    cells = {idle: asyncio.run(SC.run_cell('ingest-auto', 8, 'get',
                                           device='cpu', idle=idle))
             for idle in (0, 8)}
    plain, topped = cells[0], cells[8]
    assert plain['ingest']['frag_ticks'] == 0
    assert topped['ingest']['frag_ticks'] > 0
    assert topped['idle'] == 8 and 'idle' not in plain
    for r in cells.values():
        assert r['get']['count'] == r['get']['expected'] == 256
        assert r['fanout']['fired'] == [8] * SC.STORMS
    want = reference_cell_keys['ingest-auto/get']
    got = _cell_keys(plain)
    assert set(got) == set(want)
    for k, sub in want.items():
        if sub is not None:
            assert set(got[k]) == set(sub) | _PORT_EXTRA.get(k, set()), k
    assert set(_cell_keys(topped)) == set(want) | {'idle'}


def test_paired_summary_reports_fill_and_routing(monkeypatch, capsys):
    """``run_paired`` with two modes against one and a topped-up fleet:
    one summary a mode and size, each with its pairs, the median bytes
    and frames a tick, the fill over the whole fleet and the routing
    pooled over the rounds."""
    monkeypatch.setattr(SC, 'GETS_TOTAL', 64)
    monkeypatch.setattr(FleetIngest, 'FRAG_MIN_FLEET', 16)
    s = SC.run_paired(('ingest', 'ingest-auto'), 'native', [8], 2,
                      device='cpu', fleet=16)
    assert [x['paired'] for x in s] == ['ingest-vs-native',
                                        'ingest-auto-vs-native']
    for x in s:
        assert x['pairs'] == 2 and x['fleet'] == 16 and x['conns'] == 8
        assert x['fill_median'] == pytest.approx(
            x['frames_per_tick_median'] / 16, abs=1e-3)
        assert x['fill_median'] > 0 and x['bytes_per_tick_median'] > 0
    raw, auto = s[0]['routing'], s[1]['routing']
    # the guards off: every tick on the device, but those that met a
    # bucket still warming
    assert raw['scalar_frac'] == raw['frag_frac'] == 0.0
    assert raw['device_frac'] > 0.5
    assert auto['device_frac'] == 0.0 and auto['frag_frac'] > 0.0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('# ')]
    assert len(lines) == 2 * 3          # two rounds of three cells
