"""Deterministic, seedable fault injection for the transport stack.

The whole value of this client is surviving failure — session
resumption, watcher re-arm, retry policies — yet hand-rolled failure
tests only ever exercise the failure modes someone thought of.  This
module injects faults *at the byte/socket boundary* on a seeded
schedule, so randomized-but-reproducible campaigns
(tests/test_torch_chaos.py, ``python -m zkstream_tpu_torch chaos``) can
drive the stack through fault interleavings nobody hand-wrote:

- **connection refusal** and **added connect latency** (client dial);
- **mid-frame TCP resets** in either direction (a frame's prefix is
  delivered, then the connection dies);
- **partial/slow frame delivery** (byte-level splits with delays);
- **delayed and duplicated segments** (a duplicated stream segment is
  a framing-corruption-class fault: it must surface as a typed
  protocol error and a reconnect, never a hang or a wrong reply);
- **accept-loop refusal** on the server;
- **asymmetric partition** between replication peers (the leader's
  push channel to one follower drops while the follower's control
  channel still flows — server/replication.py);
- member **crash scheduling** helpers (the campaign SIGKILLs / stops
  ensemble members at injector-chosen points).

Determinism: every decision is drawn from a per-category
``random.Random`` seeded from ``(seed, category)`` (string seeding
hashes via SHA-512, stable across processes).  The *schedule* — the
sequence of decisions at each injection point — is therefore a pure
function of the seed and config: the interleaving of categories may
vary with event-loop timing, but each category's Nth decision never
does, and ``schedule_digest()`` captures the whole plan for equality
checks.  Faults stop after ``max_faults`` fires so every campaign
converges to a verifiable steady state.

The hooks are duck-typed: ``ZKConnection`` reads ``client.faults``,
``ZKServer``/``ReplicationService`` carry a ``faults`` slot.  With no
injector installed every hook site is a single ``is None`` check.
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import random
import struct

from ..protocol.errors import (
    ZKError,
    ZKNotConnectedError,
    ZKProtocolError,
)
from ..utils.aio import ambient_loop
from .invariants import AMBIGUOUS_CODES

#: Decision streams, one seeded RNG each.  'plan' is reserved for the
#: campaign driver's op/crash scheduling so workload choices never
#: perturb transport-fault draws; 'ingest' drives the FleetIngest
#: batched drain's tick-time faults; 'disk' drives the durability
#: plane (fsync latency/errors, crash-before-fsync vs crash-after-
#: fsync windows — server/persist.py).
#: 'overload' drives the overload plane's pressure bursts (raw
#: connection floods, stalled readers, oversized declared frames —
#: io/overload.py).
CATEGORIES = ('connect', 'rx', 'tx', 'accept', 'server_tx',
              'partition', 'plan', 'ingest', 'disk', 'server_rx',
              'overload')


class InjectedRefusal(ConnectionRefusedError):
    """A dial refused by the fault schedule (client side)."""


@dataclasses.dataclass
class FaultConfig:
    """Probabilities and bounds for one campaign's fault mix.  All
    probabilities are per-decision-point; delays are ms ranges."""

    # client dial
    p_connect_refuse: float = 0.0
    connect_latency_ms: float = 0.0
    # server -> client byte stream (client rx)
    p_rx_reset: float = 0.0
    p_rx_split: float = 0.0
    p_rx_delay: float = 0.0
    p_rx_dup: float = 0.0
    rx_delay_ms: tuple[float, float] = (1.0, 25.0)
    # client -> server byte stream (client tx)
    p_tx_reset: float = 0.0
    # server accept loop
    p_accept_refuse: float = 0.0
    # server reply/notification writes
    p_server_tx_reset: float = 0.0
    p_server_tx_split: float = 0.0
    server_tx_delay_ms: tuple[float, float] = (0.0, 10.0)
    # server receive path (client -> server bytes AT the server):
    # injected at the per-frame boundary BEFORE the ingress drain's
    # decode (io/ingress.py / ServerConnection.feed) — the send
    # plane's before-the-cork rule mirrored on the rx side
    p_server_rx_reset: float = 0.0
    p_server_rx_split: float = 0.0
    server_rx_delay_ms: tuple[float, float] = (0.0, 8.0)
    # replication: leader -> follower push drop (asymmetric partition)
    p_push_drop: float = 0.0
    # FleetIngest batched drain: tick-time faults (io/ingest.py) — a
    # slot suffix withheld across a tick boundary (partial frame into
    # the device scan) or a connection reset at tick time
    p_ingest_hold: float = 0.0
    p_ingest_reset: float = 0.0
    # durability plane (server/persist.py): injected fsync latency
    # (fsync is a blocking syscall; so is its injected delay) and
    # fsync *errors* — a failed fsync leaves acked writes non-durable
    # until the next barrier succeeds, which the recovery invariant's
    # floor demotion accounts for
    p_fsync_delay: float = 0.0
    fsync_delay_ms: tuple[float, float] = (0.2, 5.0)
    p_fsync_error: float = 0.0
    # overload plane (io/overload.py): plan-level pressure bursts —
    # raw connection floods against the admission path, stalled
    # client readers (slow consumers growing the member's tx
    # backlog), and oversized declared frame lengths (the frame cap
    # must refuse BEFORE buffering)
    p_conn_flood: float = 0.0
    flood_conns: int = 12
    p_stall_reader: float = 0.0
    stall_window_ms: tuple[float, float] = (20.0, 120.0)
    p_oversize_frame: float = 0.0
    #: stop firing after this many injected faults (None = unbounded);
    #: the budget is what makes randomized campaigns converge
    max_faults: int | None = 8

    @classmethod
    def randomized(cls, seed: int) -> 'FaultConfig':
        """A randomized-but-reproducible fault mix: which fault classes
        are active, and how hard, is itself drawn from the seed."""
        rng = random.Random('cfg/%d' % (seed,))
        cfg = cls()
        picks = rng.sample([
            ('p_connect_refuse', 0.3), ('p_rx_reset', 0.08),
            ('p_rx_split', 0.5), ('p_rx_delay', 0.4),
            ('p_rx_dup', 0.06), ('p_tx_reset', 0.08),
            ('p_accept_refuse', 0.3), ('p_server_tx_reset', 0.08),
            ('p_server_tx_split', 0.5), ('p_push_drop', 0.3),
        ], k=rng.randint(1, 4))
        for name, ceil in picks:
            setattr(cfg, name, rng.uniform(0.01, ceil))
        cfg.connect_latency_ms = rng.choice([0.0, 0.0, 10.0, 50.0])
        cfg.rx_delay_ms = (0.5, rng.uniform(2.0, 20.0))
        cfg.server_tx_delay_ms = (0.0, rng.uniform(1.0, 8.0))
        cfg.max_faults = rng.randint(1, 5)
        # disk faults ride their own config stream so adding the
        # durability plane never perturbed the transport mixes the
        # existing seeds were tuned on
        drng = random.Random('cfg-disk/%d' % (seed,))
        if drng.random() < 0.4:
            cfg.p_fsync_delay = drng.uniform(0.02, 0.3)
            cfg.fsync_delay_ms = (0.1, drng.uniform(0.5, 4.0))
        if drng.random() < 0.15:
            cfg.p_fsync_error = drng.uniform(0.02, 0.15)
        # server-rx faults likewise ride their own stream (added with
        # the ingress plane): existing streams' draws are
        # untouched, the new fault class just joins the mix
        rrng = random.Random('cfg-srx/%d' % (seed,))
        if rrng.random() < 0.35:
            cfg.p_server_rx_split = rrng.uniform(0.02, 0.4)
            cfg.server_rx_delay_ms = (0.1, rrng.uniform(0.5, 6.0))
        if rrng.random() < 0.1:
            cfg.p_server_rx_reset = rrng.uniform(0.01, 0.08)
        # overload faults likewise ride their own stream:
        # the transport mixes existing seeds pin stay untouched
        ovrng = random.Random('cfg-overload/%d' % (seed,))
        if ovrng.random() < 0.3:
            cfg.p_conn_flood = ovrng.uniform(0.1, 0.5)
            cfg.flood_conns = ovrng.randint(6, 24)
        if ovrng.random() < 0.3:
            cfg.p_stall_reader = ovrng.uniform(0.1, 0.5)
            cfg.stall_window_ms = (10.0, ovrng.uniform(40.0, 150.0))
        if ovrng.random() < 0.2:
            cfg.p_oversize_frame = ovrng.uniform(0.1, 0.4)
        return cfg

    @classmethod
    def randomized_ensemble(cls, seed: int) -> 'FaultConfig':
        """The ensemble campaign's fault mix: the transport mix of
        :meth:`randomized` (drawn from the same stream, so the two
        tiers' transport schedules stay comparable per seed) plus
        ingest tick faults, drawn from a separate stream so adding
        them never perturbed the transport tier's existing
        schedules."""
        cfg = cls.randomized(seed)
        rng = random.Random('cfg-ens/%d' % (seed,))
        if rng.random() < 0.5:
            cfg.p_ingest_hold = rng.uniform(0.05, 0.6)
        if rng.random() < 0.25:
            cfg.p_ingest_reset = rng.uniform(0.02, 0.10)
        # member kills dominate the ensemble tier; give the byte-level
        # faults a slightly larger budget so both layers keep firing
        cfg.max_faults = rng.randint(2, 8)
        return cfg


class _Gate:
    """Strictly-FIFO delayed delivery of byte segments to a sink.

    TCP never reorders within a stream, so a delayed segment holds
    everything behind it (slow delivery), it does not overtake.  A
    ``reset`` sentinel queued behind segments delivers the prefix
    first, then fires the reset callback — that is what makes injected
    resets genuinely *mid-frame*."""

    _RESET = object()

    def __init__(self, sink, on_reset):
        self._sink = sink
        self._on_reset = on_reset
        self._q: list = []       # (delay_ms, payload) pending delivery
        self._timer = None
        self.dead = False

    @property
    def pending(self) -> bool:
        """True while segments are still queued or a delayed head is
        waiting on its timer — later writes must queue behind them to
        keep the stream FIFO."""
        return bool(self._q) or self._timer is not None

    def push(self, data: bytes, delay_ms: float = 0.0) -> None:
        if self.dead:
            return
        self._q.append((delay_ms, data))
        self._drain()

    def push_reset(self) -> None:
        if self.dead:
            return
        self._q.append((0.0, _Gate._RESET))
        self._drain()

    def _drain(self) -> None:
        if self._timer is not None:
            return                        # a delayed head is pending
        while self._q and not self.dead:
            delay_ms, payload = self._q[0]
            if delay_ms > 0:
                self._q[0] = (0.0, payload)

                def fire():
                    self._timer = None
                    self._drain()
                self._timer = ambient_loop().call_later(
                    delay_ms / 1000.0, fire)
                return
            self._q.pop(0)
            if payload is _Gate._RESET:
                self.dead = True
                self._q.clear()
                self._on_reset()
                return
            self._sink(payload)

    def close(self) -> None:
        self.dead = True
        self._q.clear()
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None


class FaultInjector:
    def __init__(self, seed: int = 0,
                 config: FaultConfig | None = None):
        self.seed = seed
        self.config = config if config is not None else FaultConfig()
        self._streams = {cat: random.Random('%d/%s' % (seed, cat))
                         for cat in CATEGORIES}
        self.active = True
        #: (category, description) of every fault actually fired —
        #: printed on campaign failure next to the seed
        self.fired: list[tuple[str, str]] = []
        self._gates: list[_Gate] = []

    # -- bookkeeping --

    def _take(self, cat: str, p: float, desc: str) -> bool:
        """One decision point: ALWAYS draws from the category stream
        (so the schedule is a pure function of the seed regardless of
        which faults are enabled), fires only while active and under
        the fault budget."""
        r = self._streams[cat].random()
        if not self.active or p <= 0.0 or r >= p:
            return False
        if self.config.max_faults is not None and \
                len(self.fired) >= self.config.max_faults:
            return False
        self.fired.append((cat, desc))
        return True

    def rand(self, cat: str) -> float:
        return self._streams[cat].random()

    def randint(self, cat: str, a: int, b: int) -> int:
        return self._streams[cat].randint(a, b)

    def choice(self, cat: str, seq):
        return self._streams[cat].choice(seq)

    def uniform(self, cat: str, a: float, b: float) -> float:
        return self._streams[cat].uniform(a, b)

    def stop(self) -> None:
        """Stop injecting (verification phase).  Segments already in
        flight through gates still deliver — they are real bytes."""
        self.active = False

    def close(self) -> None:
        self.active = False
        for g in self._gates:
            g.close()
        self._gates.clear()

    def schedule_digest(self, per_category: int = 64) -> str:
        """A digest of the fault plan: config + the first N draws of
        every category stream.  Same seed + config => same digest,
        independent of anything that happened at runtime."""
        h = hashlib.sha256()
        h.update(repr(dataclasses.astuple(self.config)).encode())
        for cat in CATEGORIES:
            rng = random.Random('%d/%s' % (self.seed, cat))
            for _ in range(per_category):
                h.update(struct.pack('<d', rng.random()))
        return h.hexdigest()

    @classmethod
    def randomized(cls, seed: int) -> 'FaultInjector':
        return cls(seed, FaultConfig.randomized(seed))

    # -- client dial --

    async def before_connect(self, backend_key: str) -> None:
        """Called by the connection's dial task before the TCP connect:
        sleeps the injected reconnect latency, then may refuse."""
        refuse = self._take('connect', self.config.p_connect_refuse,
                            'refuse dial to %s' % (backend_key,))
        if self.config.connect_latency_ms > 0:
            await asyncio.sleep(self.config.connect_latency_ms / 1000.0)
        if refuse:
            raise InjectedRefusal(
                'injected connection refusal (%s)' % (backend_key,))

    # -- client rx (server -> client bytes) --

    def rx(self, conn, data: bytes) -> None:
        """Route received bytes through the fault schedule, then on to
        the connection's normal ``sockData`` path, in order."""
        gate = getattr(conn, '_fault_rx_gate', None)
        if gate is None or gate.dead:
            def on_reset(c=conn):
                c.emit('sockError', ConnectionResetError(
                    'injected connection reset (rx)'))
            gate = _Gate(lambda d, c=conn: c.emit('sockData', d),
                         on_reset)
            conn._fault_rx_gate = gate
            self._gates.append(gate)
        cfg = self.config
        if self._take('rx', cfg.p_rx_reset, 'rx mid-frame reset'):
            # deliver a strict prefix, then die: the codec is left
            # holding a half frame when the teardown path runs
            cut = self._streams['rx'].randrange(len(data)) \
                if len(data) > 1 else 0
            if cut:
                gate.push(data[:cut])
            gate.push_reset()
            return
        segments = [data]
        if len(data) > 1 and self._take('rx', cfg.p_rx_split,
                                        'rx split'):
            cut = self._streams['rx'].randrange(1, len(data))
            segments = [data[:cut], data[cut:]]
        if self._take('rx', cfg.p_rx_dup, 'rx duplicate segment'):
            segments.append(segments[self._streams['rx']
                            .randrange(len(segments))])
        lo, hi = cfg.rx_delay_ms
        for seg in segments:
            delay = 0.0
            if self._take('rx', cfg.p_rx_delay, 'rx delay'):
                delay = self._streams['rx'].uniform(lo, hi)
            gate.push(seg, delay)

    # -- client tx (client -> server bytes) --

    def tx(self, conn, data: bytes) -> bytes | None:
        """May truncate an outbound frame and schedule a reset; returns
        the bytes to actually write (None = write nothing)."""
        if self._take('tx', self.config.p_tx_reset,
                      'tx mid-frame reset'):
            cut = self._streams['tx'].randrange(len(data)) \
                if len(data) > 1 else 0

            def die(c=conn):
                c.emit('sockError', ConnectionResetError(
                    'injected connection reset (tx)'))
            ambient_loop().call_soon(die)
            return data[:cut] if cut else None
        return data

    # -- server side --

    def accept_refuse(self) -> bool:
        return self._take('accept', self.config.p_accept_refuse,
                          'refuse accepted client')

    def server_tx(self, server_conn, data: bytes, pre=None) -> bool:
        """Server-side write hook.  Returns True when the injector took
        over delivery (split/delay/reset), False for pass-through.

        ``pre`` (the connection's send-plane ``flush_hard``, or — on
        the watch-table fan-out path — its ``_preflush_fanout``, which
        drains the buffered notifications first) runs before the
        injector's first delivery whenever it takes over: frames
        corked in earlier (un-faulted) writes must hit the wire first
        or the stream would reorder in a way TCP never does.  The hook
        itself stays a per-frame boundary — injection happens before
        the cork (send plane AND shard cork alike), and a faulted
        frame bypasses both.  This holds on every transport backend
        (io/transport.py): ``flush_hard`` drains the batched tier's
        pending submission for the connection synchronously, so the
        gate's direct ``writer.write`` deliveries can never overtake
        bytes the tier still held."""
        cfg = self.config
        wants_reset = self._take('server_tx', cfg.p_server_tx_reset,
                                 'server tx mid-frame reset')
        wants_split = self._take('server_tx', cfg.p_server_tx_split,
                                 'server tx split/delay')
        gate = getattr(server_conn, '_fault_tx_gate', None)
        if not (wants_reset or wants_split):
            if gate is None or gate.dead or not gate.pending:
                return False
            # A delayed segment from an earlier write is still in the
            # gate: this (un-faulted) write must queue behind it, or
            # the stream would reorder in a way TCP never does.
            if pre is not None:
                pre()
            gate.push(data)
            return True
        if pre is not None:
            pre()
        if gate is None or gate.dead:
            def sink(d, c=server_conn):
                if not c.closed:
                    try:
                        c.writer.write(d)
                    except (ConnectionError, RuntimeError):
                        pass

            def on_reset(c=server_conn):
                try:
                    t = c.writer.transport
                    if t is not None:
                        t.abort()
                except (ConnectionError, RuntimeError):
                    pass
                c.close()
            gate = _Gate(sink, on_reset)
            server_conn._fault_tx_gate = gate
            self._gates.append(gate)
        if wants_reset:
            cut = self._streams['server_tx'].randrange(len(data)) \
                if len(data) > 1 else 0
            if cut:
                gate.push(data[:cut])
            gate.push_reset()
            return True
        cut = self._streams['server_tx'].randrange(1, len(data)) \
            if len(data) > 1 else 0
        lo, hi = cfg.server_tx_delay_ms
        delay = self._streams['server_tx'].uniform(lo, hi)
        if cut:
            gate.push(data[:cut])
            gate.push(data[cut:], delay)
        else:
            gate.push(data, delay)
        return True

    def server_rx(self, server_conn, data: bytes) -> bool:
        """Server-side receive hook.  Returns True when the injector
        took over delivery (split/delay/reset), False for
        pass-through.

        Called per connection-chunk BEFORE any decode — by
        ``ServerConnection.feed`` on BOTH receive paths (the
        single-loop validator's read loop and the ingress plane's
        batched drain, io/ingress.py), so injection stays a per-frame
        boundary ahead of the batch: a faulted chunk perturbs one
        connection's stream without reordering it, whichever backend
        drained the bytes.  Delayed segments re-enter through
        ``_feed`` (the injector-free half), never through ``feed`` —
        a faulted chunk is screened exactly once."""
        cfg = self.config
        wants_reset = self._take('server_rx', cfg.p_server_rx_reset,
                                 'server rx mid-frame reset')
        wants_split = self._take('server_rx', cfg.p_server_rx_split,
                                 'server rx split/delay')
        gate = getattr(server_conn, '_fault_srx_gate', None)
        if not (wants_reset or wants_split):
            if gate is None or gate.dead or not gate.pending:
                return False
            # a delayed segment from an earlier chunk is still in the
            # gate: this (un-faulted) chunk must queue behind it, or
            # the server would decode a reordering TCP never delivers
            gate.push(data)
            return True
        if gate is None or gate.dead:
            def sink(d, c=server_conn):
                if not c.closed and not c._feed(d):
                    c.close()

            def on_reset(c=server_conn):
                try:
                    t = c.writer.transport
                    if t is not None:
                        t.abort()
                except (ConnectionError, RuntimeError):
                    pass
                c.close()
            gate = _Gate(sink, on_reset)
            server_conn._fault_srx_gate = gate
            self._gates.append(gate)
        if wants_reset:
            # deliver a strict prefix, then die: the server codec is
            # left holding a half frame when teardown runs
            cut = self._streams['server_rx'].randrange(len(data)) \
                if len(data) > 1 else 0
            if cut:
                gate.push(data[:cut])
            gate.push_reset()
            return True
        cut = self._streams['server_rx'].randrange(1, len(data)) \
            if len(data) > 1 else 0
        lo, hi = cfg.server_rx_delay_ms
        delay = self._streams['server_rx'].uniform(lo, hi)
        if cut:
            gate.push(data[:cut])
            gate.push(data[cut:], delay)
        else:
            gate.push(data, delay)
        return True

    # -- replication partition --

    def drop_push(self, follower_token: str) -> bool:
        """Leader->follower push drop: the asymmetric half-partition
        (the follower's control channel keeps working)."""
        return self._take('partition', self.config.p_push_drop,
                          'drop push to follower %s' % (follower_token,))

    # -- FleetIngest batched drain (tick-time faults) --

    def ingest_reset(self, conn) -> bool:
        """Kill this connection at the tick boundary (teardown while
        other streams of the same batch still route)."""
        return self._take('ingest', self.config.p_ingest_reset,
                          'ingest tick reset')

    def ingest_cut(self, conn, nbytes: int) -> int:
        """How many trailing bytes of a slot to withhold from this
        tick (0 = none): the device scan sees a partial frame at an
        arbitrary cut and must finish it on the follow-up tick."""
        if nbytes < 2:
            return 0
        if not self._take('ingest', self.config.p_ingest_hold,
                          'ingest tick hold'):
            return 0
        return self._streams['ingest'].randrange(1, nbytes)

    # -- durability plane (server/persist.py) --

    def fsync_fault(self) -> tuple[float, bool]:
        """One WAL fsync decision point: returns ``(delay_ms, error)``.
        A delay models a congested device (fsync blocks the loop; so,
        deliberately, does the injected delay); an error models the
        fsync failing outright — the WAL counts it and the acked
        writes under it stay non-durable until the next barrier."""
        delay = 0.0
        if self._take('disk', self.config.p_fsync_delay,
                      'fsync delay'):
            delay = self._streams['disk'].uniform(
                *self.config.fsync_delay_ms)
        err = self._take('disk', self.config.p_fsync_error,
                         'fsync error')
        return delay, err

    def overload_action(self) -> str | None:
        """One per-step overload decision ('overload' stream,
        fault-budget accounted): 'stall' (park a client reader —
        the slow-consumer shape), 'flood' (raw connection burst
        against the admission path), 'oversize' (an absurd declared
        frame length), or None.  The campaign drivers map each to
        the matching pressure action (io/faults.py force_overload)."""
        cfg = self.config
        if self._take('overload', cfg.p_stall_reader,
                      'stalled client reader'):
            return 'stall'
        if self._take('overload', cfg.p_conn_flood,
                      'raw connection flood'):
            return 'flood'
        if self._take('overload', cfg.p_oversize_frame,
                      'oversized declared frame'):
            return 'oversize'
        return None

    def crash_window_before_fsync(self) -> bool:
        """The campaign's SIGKILL placement relative to the pending
        fsync: True = die before it completes (the open segment's
        un-fsynced tail is lost), False = die just after.  A plan
        decision, not a fault — it draws from the 'disk' stream but
        never spends the fault budget."""
        return self._streams['disk'].random() < 0.5


# ---------------------------------------------------------------------
# Campaign driver: one seeded schedule end to end.  Shared by
# tests/test_torch_chaos.py and the ``chaos`` CLI subcommand so the
# invariant checks cannot diverge between them.
# ---------------------------------------------------------------------

#: Per-op deadline for campaign ops, ms.  Generous slack on top of this
#: is what "bounded" is asserted against.
CAMPAIGN_OP_DEADLINE_MS = 400
#: Hard per-op bound: deadline plus scheduling slack.  An op neither
#: completing nor raising inside this window is a violation ("silent
#: hang").
CAMPAIGN_OP_HARD_S = 4.0


async def _bounded_op(res: 'ScheduleResult', coro, what: str,
                      on_ambiguous=None):
    """Run one campaign op under the hard bound; returns
    ``(acked, result)``.  Shared by both campaign tiers so the typed-
    error tally, deadline counting and the silent-hang violation
    cannot drift between them.  ``on_ambiguous`` (ensemble tier) is
    called when the op was sent but its outcome is unknown."""
    try:
        return True, await asyncio.wait_for(coro, CAMPAIGN_OP_HARD_S)
    except ZKNotConnectedError:
        res.typed_errors += 1        # raised before any send: the op
        return False, None           # definitely did not apply
    except (ZKError, ZKProtocolError) as e:
        res.typed_errors += 1
        code = getattr(e, 'code', '')
        if code == 'DEADLINE_EXCEEDED':
            res.deadline_errors += 1
        if on_ambiguous is not None and code in AMBIGUOUS_CODES:
            on_ambiguous()
        return False, None
    except (asyncio.TimeoutError, TimeoutError):
        res.violations.append(
            '%s hung past the %.1fs hard bound (deadline %d ms '
            'never fired)' % (what, CAMPAIGN_OP_HARD_S,
                              CAMPAIGN_OP_DEADLINE_MS))
        if on_ambiguous is not None:
            on_ambiguous()
        return False, None


def record_settle_error(res: 'ScheduleResult', h, call_id: int,
                        exc) -> None:
    """Classify one typed op failure into its interval settle plus
    the shared tallies — ONE ladder for both concurrent tiers
    (io/faults.py ``run_concurrent_schedule`` and the process tier's
    concurrent workload, server/election.py), the ``_bounded_op``
    no-drift discipline applied to two-sided records: a definite
    spec verdict settles ``'error'``, a rejected MULTI likewise
    (whole-batch, no effect), an op that provably never left the
    client (not-connected) or bounced on the epoch fence settles
    ``'fail'`` (excluded from the search), and everything else —
    the outcome-unknown family included — settles ``'unknown'``."""
    from ..analysis.linearize import SPEC_ERRORS
    from ..protocol.errors import ZKMultiError

    res.typed_errors += 1
    code = getattr(exc, 'code', None) or type(exc).__name__
    if code == 'DEADLINE_EXCEEDED':
        res.deadline_errors += 1
    if isinstance(exc, ZKNotConnectedError):
        h.settle(call_id, 'fail', error='NOT_CONNECTED')
    elif isinstance(exc, ZKMultiError):
        h.settle(call_id, 'error', error='MULTI_REJECTED')
    elif code in SPEC_ERRORS:
        h.settle(call_id, 'error', error=code)
    elif code in ('EPOCH_FENCED', 'THROTTLED'):
        # typed bounces that provably never applied: the epoch
        # fence, and the overloaded member's write throttle (README
        # "Overload plane" — the bounce happens BEFORE proposing)
        h.settle(call_id, 'fail', error=code)
    else:
        h.settle(call_id, 'unknown', error=code)


def _note_open_spans(res: 'ScheduleResult', trace) -> None:
    """Teardown invariant shared by both campaign tiers: every span
    must be settled once the client is closed — an op evicted from the
    pending table without a settle is a span-leak bug (abandoned ops
    finish status='abandoned', never stay 'open')."""
    leaked = trace.open_spans()
    if leaked:
        res.violations.append(
            '%d trace span(s) left open after teardown: %s'
            % (len(leaked),
               ', '.join('#%d %s' % (s.span_id, s.op)
                         for s in leaked[:8])))


def _harvest_blackboxes(wal_dir: str) -> dict:
    """Lift every flight-recorder ring out of a schedule's wal_dir
    (utils/blackbox.py) before teardown removes it — the dead
    member's last spans, `merge_timelines`-ready.  Best-effort:
    salvage must never turn a passing schedule into an error."""
    try:
        from ..utils.blackbox import harvest_spans
        return harvest_spans(wal_dir)
    except Exception:
        return {}


@dataclasses.dataclass
class ScheduleResult:
    seed: int
    ops: int = 0
    acked: int = 0
    typed_errors: int = 0
    deadline_errors: int = 0
    faults: int = 0
    watch_fires: int = 0
    violations: list = dataclasses.field(default_factory=list)
    #: The client's xid-correlated span ring (utils/trace.py), dumped
    #: after the schedule: on a violation this is the exact
    #: request/reply/notification interleaving that produced it.
    trace: list = dataclasses.field(default_factory=list)
    #: Every member's server-side span ring ('member:N' -> dump):
    #: merged with the client ring by zxid (utils/trace.
    #: merge_timelines) this is the cross-member causal path of each
    #: write — printed on failure, carried in ``chaos --trace-out``.
    member_rings: dict = dataclasses.field(default_factory=dict)
    #: Which campaign tier produced this result ('transport' or
    #: 'ensemble').
    tier: str = 'transport'
    #: How many concurrent clients drove the schedule (1 = the
    #: classic single-client workload; >1 = the concurrent tier,
    #: ``run_concurrent_schedule`` — part of the rerun key:
    #: ``chaos --tier ensemble --clients N --seed S``).
    clients: int = 1
    #: Ensemble tier only: the member-event timeline (kill / restart /
    #: partition / heal / lag / migrate), in schedule order — printed
    #: next to the seed on failure so the failing interleaving of
    #: member churn is visible without rerunning.
    member_events: list = dataclasses.field(default_factory=list)
    #: Ensemble tier only: the full op/ack/watch/member history the
    #: invariant engine (io/invariants.py) checked, as JSON-ready
    #: dicts.
    history: list = dataclasses.field(default_factory=list)
    #: Ensemble/process tiers: completed leader elections observed
    #: during the schedule (server/election.py; invariant 7 replays
    #: the election records carried in ``history``).
    elections: int = 0

    @property
    def ok(self) -> bool:
        return not self.violations


async def run_schedule(seed: int, ops: int = 6,
                       collector=None) -> ScheduleResult:
    """Run one seeded fault schedule against a fresh in-process server
    and client; returns the invariant-check result.  ``collector``
    (utils/metrics.Collector) is threaded to the client when given, so
    a caller can scrape latency histograms / FSM metrics after the
    schedule; the client's span ring is always dumped into the result.

    Invariants asserted (violations listed in the result, seed
    attached, so any failure is reproducible with the same seed):

    - every client op completes or raises a *typed* error
      (ZKError / ZKProtocolError, ZKDeadlineError included) within the
      hard per-op bound — never a silent hang;
    - no acked write is lost: an acked create (without a later acked
      delete) exists with its data; an acked delete stays deleted; the
      newest acked set is <= the server's final value (a later
      *unacked* set may have applied — at-least-once ambiguity);
    - no duplicated watch fire: no two dataChanged emits carry the
      same mzxid.
    """
    import shutil
    import tempfile

    from ..client import Client
    from ..server.server import ZKServer
    from ..server.store import ZKOpError
    from .backoff import BackoffPolicy

    inj = FaultInjector.randomized(seed)
    res = ScheduleResult(seed=seed)
    # the durability plane rides every schedule: txns are logged to a
    # throwaway WAL dir and the verification phase recovers a SIGKILL
    # crash image from it (sync policy drawn per seed; fsync faults
    # come from the injector's 'disk' category)
    wal_dir = tempfile.mkdtemp(prefix='zkchaos-wal-')
    crash_dir = tempfile.mkdtemp(prefix='zkchaos-crash-')
    durability = 'always' if inj.rand('disk') < 0.25 else 'tick'
    srv = await ZKServer(wal_dir=wal_dir, durability=durability).start()
    srv.faults = inj
    if srv.db.wal is not None:          # ZKSTREAM_NO_WAL honored
        srv.db.wal.faults = inj
    client = Client(
        address='127.0.0.1', port=srv.port, session_timeout=3000,
        seed=seed, faults=inj, op_timeout=CAMPAIGN_OP_DEADLINE_MS,
        collector=collector,
        connect_policy=BackoffPolicy(timeout=400, retries=2,
                                     delay=30, cap=200),
        default_policy=BackoffPolicy(timeout=400, retries=3,
                                     delay=50, cap=400))
    client.start()

    created: dict[str, bytes] = {}     # acked creates, path -> data
    deleted: set[str] = set()          # acked deletes
    ambig_deleted: set[str] = set()    # deletes with unknown outcome
    last_acked_set = -1                # newest acked /w value index
    fires: list[int] = []              # dataChanged mzxids

    # overload slice (README "Overload plane"), its own fresh stream
    # so existing transport seeds stay pinned: ~1 in 4 schedules
    # fires one mid-schedule pressure burst — a raw connection flood
    # against the admission path, or an oversized declared frame the
    # member must refuse with a definite close
    ovrng = random.Random('churn-overload/%d' % (seed,))
    overload_burst = (ovrng.choice(('none', 'none', 'none', 'flood',
                                    'flood', 'oversize'))
                      if ovrng.random() < 0.4 else 'none')

    async def bounded(coro, what):
        """Run one op under the shared hard bound (_bounded_op)."""
        return await _bounded_op(res, coro, what)

    try:
        try:
            await client.wait_connected(timeout=10, fail_fast=False)
        except (asyncio.TimeoutError, TimeoutError):
            res.violations.append(
                'never connected within 10s (fault budget %r should '
                'have exhausted)' % (inj.config.max_faults,))
            return res

        client.watcher('/w').on(
            'dataChanged',
            lambda data, stat: fires.append(stat.mzxid))

        ok, _ = await bounded(client.create('/w', b'v0'), 'create /w')
        if ok:
            created['/w'] = b'v0'

        set_idx = 0
        for i in range(ops):
            if not client.is_connected():
                # A fault killed the connection: give the redial loop a
                # bounded window so later ops exercise the *recovered*
                # path too, not just fail-fast ZKNotConnectedError.
                try:
                    await client.wait_connected(timeout=1.0,
                                                fail_fast=False)
                except (asyncio.TimeoutError, TimeoutError):
                    pass
            res.ops += 1
            if i == ops // 2 and overload_burst != 'none':
                if overload_burst == 'flood':
                    await _overload_flood('127.0.0.1', srv.port,
                                          ovrng.randint(6, 16))
                else:
                    hung = await _overload_oversize('127.0.0.1',
                                                    srv.port)
                    if hung:
                        res.violations.append(
                            'oversized raw frame: no definite close '
                            'within 2s (the frame cap must refuse '
                            'before buffering)')
            kind = inj.choice('plan', ('set', 'create', 'delete',
                                       'get', 'list', 'sync'))
            if kind == 'set':
                set_idx += 1
                ok, _ = await bounded(
                    client.set('/w', b'v%d' % set_idx, version=-1),
                    'set /w v%d' % set_idx)
                if ok:
                    res.acked += 1
                    last_acked_set = set_idx
            elif kind == 'create':
                path, data = '/c%d' % i, b'd%d' % i
                ok, _ = await bounded(client.create(path, data),
                                      'create %s' % path)
                if ok:
                    res.acked += 1
                    created[path] = data
            elif kind == 'delete':
                live = sorted(set(created) - deleted - {'/w'})
                if not live:
                    continue
                path = inj.choice('plan', live)
                # ambiguity-aware, like the ensemble tier: a delete
                # failing with CONNECTION_LOSS etc. may still have
                # applied, which must excuse the acked create's
                # absence below (not count as acked-write loss)
                ok, _ = await _bounded_op(
                    res, client.delete(path, -1), 'delete %s' % path,
                    on_ambiguous=lambda p=path: ambig_deleted.add(p))
                if ok:
                    res.acked += 1
                    deleted.add(path)
            elif kind == 'get':
                await bounded(client.get('/w'), 'get /w')
            elif kind == 'list':
                await bounded(client.list('/'), 'list /')
            else:
                await bounded(client.sync('/w'), 'sync /w')

        # -- verification: faults off, check the server's own tree --
        inj.stop()
        res.faults = len(inj.fired)

        def check_acked_tree(db, prefix=''):
            vs = []
            for path, data in created.items():
                if path in deleted:
                    continue
                try:
                    got, _stat = db.get_data(path)
                except ZKOpError:
                    if path in ambig_deleted:
                        continue  # an unacked delete may have landed
                    vs.append(
                        '%sacked create %s lost (NO_NODE after '
                        'campaign)' % (prefix, path))
                    continue
                if path != '/w' and bytes(got) != data:
                    vs.append(
                        '%sacked create %s holds %r, expected %r'
                        % (prefix, path, bytes(got), data))
            for path in deleted:
                try:
                    db.get_data(path)
                    vs.append('%sacked delete %s did not stick'
                              % (prefix, path))
                except ZKOpError:
                    pass
            if last_acked_set >= 0:
                try:
                    got, _stat = db.get_data('/w')
                    idx = int(bytes(got)[1:])
                    if idx < last_acked_set:
                        vs.append('%sacked set v%d lost: /w holds %r'
                                  % (prefix, last_acked_set,
                                     bytes(got)))
                except (ZKOpError, ValueError):
                    vs.append('%sacked set v%d lost: /w unreadable'
                              % (prefix, last_acked_set))
            return vs

        res.violations.extend(check_acked_tree(srv.db))

        # -- durability: SIGKILL crash image + restart-from-disk ----
        # (invariant 6 — io/invariants.py).  The crash window is
        # injector-chosen: before the pending fsync (the open
        # segment's un-fsynced tail dies with the page cache) or just
        # after.  Acks under sync='always'/'tick' are fsynced before
        # they leave (the send-plane barrier), so the recovered tree
        # must hold every acked write regardless of the window —
        # except past fsync *errors*, whose acks the transport tier
        # cannot zxid-correlate (no per-ack zxids here; the ensemble
        # tier's history can, and does, via the floor demotion).
        wal = srv.db.wal
        if wal is not None and not wal.sync_errors:
            from ..server.persist import recover_state
            from ..server.store import NodeTree

            before = inj.crash_window_before_fsync()
            wal.materialize_crash(crash_dir, before_fsync=before)
            rec = recover_state(crash_dir, trace=client.trace)
            rtree = NodeTree()
            rtree.install({'zxid': rec.zxid, 'nodes': rec.nodes})
            res.violations.extend(check_acked_tree(
                rtree, prefix='durability (crash %s fsync): '
                % ('before' if before else 'after')))

        res.watch_fires = len(fires)
        dupes = [z for z in set(fires) if fires.count(z) > 1]
        if dupes:
            res.violations.append(
                'duplicated watch fires for mzxid(s) %r' % (dupes,))
        return res
    finally:
        try:
            await asyncio.wait_for(client.close(), 5)
        except (asyncio.TimeoutError, TimeoutError):
            client.pool.stop()
            res.violations.append('client.close() hung past 5s')
        await srv.stop()
        if srv.db.wal is not None:
            srv.db.wal.close()
        # black-box harvest before the wal_dir goes: a crash-phase
        # restart may have lost in-memory spans this ring still holds
        salvaged = _harvest_blackboxes(wal_dir)
        shutil.rmtree(wal_dir, ignore_errors=True)
        shutil.rmtree(crash_dir, ignore_errors=True)
        inj.close()
        _note_open_spans(res, client.trace)
        # dump after teardown so close-phase errors are captured too
        res.trace = client.trace.dump()
        if srv.trace is not None:
            res.member_rings = {
                'member:%s' % (srv.member,): srv.trace.dump()}
        for key, spans in salvaged.items():
            res.member_rings.setdefault(key, spans)


async def run_campaign(base_seed: int, schedules: int,
                       ops: int = 6,
                       progress=None) -> list[ScheduleResult]:
    """Run ``schedules`` consecutive seeded schedules starting at
    ``base_seed``.  ``progress(result)`` is called after each one."""
    out = []
    for i in range(schedules):
        r = await run_schedule(base_seed + i, ops=ops)
        out.append(r)
        if progress is not None:
            progress(r)
    return out


# ---------------------------------------------------------------------
# Ensemble tier: deterministic failover campaigns.  One seeded
# FaultPlan schedules member kills/restarts, replication partitions,
# follower lag and forced session migration AROUND a concurrent client
# workload whose every op lands in an append-only history; the
# invariant engine (io/invariants.py) replays the history afterwards.
# Shared by tests/test_torch_chaos_ensemble.py and ``chaos --tier
# ensemble``.
# ---------------------------------------------------------------------

#: The workload/member-event mix one plan step draws from ('plan'
#: stream; repetition = weight): 13 op entries vs 10 member-churn
#: entries (~60/40), so most schedules see several ops land *between*
#: failures while member events still dominate the fault surface.
PLAN_ACTIONS = (
    'set', 'set', 'set', 'get', 'get', 'list', 'sync',
    'create', 'create', 'create_seq', 'create_seq', 'create_eph',
    'delete',
    'kill_serving', 'kill_follower', 'kill_leader', 'kill_during_op',
    'restart', 'restart',
    'partition', 'partition', 'lag', 'migrate',
)


@dataclasses.dataclass
class FaultPlan:
    """One ensemble schedule's deterministic shape: everything about
    the campaign that is fixed before the first byte flows.  The
    step-by-step decisions (which action, which victim) are drawn at
    runtime from the injector's 'plan' stream, so plan + seed fully
    determine the schedule."""

    seed: int
    config: FaultConfig
    ops: int = 12
    #: client-facing members: 1 leader + (members - 1) replica-store
    #: followers (one shared leader database, killable listeners)
    members: int = 3
    session_timeout: int = 6000
    #: 'none' | 'direct' (pass-through regime) | 'batch' (device
    #: drain, bypass_bytes=0) — which receive path the client runs
    ingest_mode: str = 'none'
    #: decoherence interval, ms (None = production default): small
    #: values force live session migration back toward the leader
    #: mid-schedule
    decoherence_ms: int | None = None
    #: WAL fsync policy for the schedule ('always' | 'tick'; 'never'
    #: forfeits the guarantee the campaign exists to check, so it
    #: stays a bench arm) — server/persist.py
    durability: str = 'tick'
    #: small segments force rotation + fuzzy snapshots mid-schedule
    wal_segment_bytes: int = 1 << 16
    #: forced leader elections (server/election.py): the schedule
    #: kills the CURRENT leader at evenly spaced plan steps —
    #: restarting members first when the survivors would fall under a
    #: quorum — and each kill must produce an elected successor at a
    #: strictly higher epoch within the bounded wait, with invariant
    #: 7 replaying the election records afterwards
    elections: int = 0
    #: forced MULTI batches (store.py ``ZKDatabase.multi``): evenly
    #: spaced steps each fire one all-or-nothing batch over fresh
    #: paths, recorded whatever the outcome — invariant 8
    #: (check_multi_atomic) then demands whole-or-nothing visibility
    #: in the final tree AND across the crash-image recovery
    multis: int = 0
    #: non-voting observer members attached to the ensemble (README
    #: "Read plane"); their lag/partition churn draws come from their
    #: OWN RNG stream, and the schedule's clients run with the
    #: client-side read plane on (reads fan out over the whole
    #: membership, zxid-gated) — the session-monotone read check
    #: (check_session_reads, wired into check_history) is the
    #: invariant under test.  Part of the rerun key:
    #: ``chaos --observers N``.
    observers: int = 0
    #: forced membership changes (README "Dynamic membership"):
    #: evenly spaced plan steps each run one runtime reconfig under
    #: traffic — the FIRST is always a voter REPLACE through a joint
    #: window (the acceptance shape: both majorities must hold the
    #: joint record), later steps draw from the fresh reconfig
    #: stream.  Invariant 7's extension (check_reconfig) replays the
    #: config records.  Part of the rerun key: ``chaos --reconfig N``.
    reconfigs: int = 0
    #: read-plane subset cap for the schedule's clients (the
    #: ``ZKSTREAM_READ_SUBSET`` knob): drawn on the reconfig stream —
    #: a subset-capped plane must rebalance correctly when the
    #: resolver adopts a post-reconfig member list
    read_subset: int | None = None
    #: forced overload bursts (README "Overload plane"): evenly
    #: spaced plan steps each fire one pressure action against a
    #: live member — a raw connection flood (admission caps +
    #: pacer), a stalled client reader (slow-consumer defense), or
    #: an oversized declared frame (the frame cap).  The action mix
    #: draws from a fresh 'churn-overload' stream; part of the
    #: rerun key: ``chaos --overload N``.
    overloads: int = 0
    #: watch-backed client cache (README "Client cache plane",
    #: io/cache.py): the schedule's clients run with ``cache='/'`` —
    #: every read consults the persistent-recursive-watch-backed
    #: local cache first, and the history must still pass
    #: check_session_reads (a cached read can never time-travel:
    #: serve gate + fill gate + invalidation floor).  Part of the
    #: rerun key: ``chaos --cached``.
    cached: bool = False

    @classmethod
    def randomized(cls, seed: int, ops: int = 12) -> 'FaultPlan':
        rng = random.Random('plan/%d' % (seed,))
        plan = cls(
            seed=seed,
            config=FaultConfig.randomized_ensemble(seed),
            ops=ops,
            session_timeout=rng.choice([2000, 4000, 8000]),
            ingest_mode=rng.choice(['none', 'none', 'direct',
                                    'batch']),
            decoherence_ms=rng.choice([None, None, 50, 120]))
        # drawn AFTER the existing fields so the durability plane
        # never perturbed the plan shapes the existing seeds produce
        plan.durability = rng.choice(['tick', 'tick', 'always'])
        plan.wal_segment_bytes = rng.choice([1 << 12, 1 << 14,
                                             1 << 20])
        # its own stream, same rule: adding the election plane must
        # not perturb the transport/plan draws existing seeds pin
        erng = random.Random('plan-elect/%d' % (seed,))
        plan.elections = erng.choice([0, 0, 0, 1, 2])
        # same rule again for the MULTI pillar
        mrng = random.Random('plan-multi/%d' % (seed,))
        plan.multis = mrng.choice([0, 1, 1, 2])
        # and again for the read plane: the observer count
        # rides a fresh stream, so every draw existing seeds pinned
        # still produces the same value
        obrng = random.Random('plan-observers/%d' % (seed,))
        plan.observers = obrng.choice([0, 0, 0, 1, 2])
        # and for dynamic membership: reconfig count and the
        # read-plane subset cap ride one fresh stream, so every draw
        # existing seeds pinned still produces the same value
        rrng = random.Random('plan-reconfig/%d' % (seed,))
        plan.reconfigs = rrng.choice([0, 0, 0, 1, 2])
        plan.read_subset = rrng.choice([None, None, 2, 3])
        # and for the overload plane: the burst count rides
        # a fresh stream, so every draw existing seeds pinned still
        # produces the same value
        ovrng = random.Random('plan-overload/%d' % (seed,))
        plan.overloads = ovrng.choice([0, 0, 0, 1, 2])
        # and for the cache plane: the cached-client draw
        # rides a fresh stream, so every draw existing seeds pinned
        # still produces the same value
        carng = random.Random('plan-cache/%d' % (seed,))
        plan.cached = carng.choice([False, False, False, True])
        return plan

    def forced_election_steps(self) -> set[int]:
        """The plan steps that force an election (evenly spaced
        through the schedule, before the drawn action of that step)."""
        if self.elections <= 0:
            return set()
        return {((k + 1) * self.ops) // (self.elections + 1)
                for k in range(self.elections)}

    def forced_multi_steps(self) -> set[int]:
        """The plan steps that fire a MULTI batch (evenly spaced,
        before the drawn action; may share a step with a forced
        election — both then run)."""
        if self.multis <= 0:
            return set()
        return {((2 * k + 1) * self.ops) // (2 * self.multis + 1)
                for k in range(self.multis)}

    def forced_reconfig_steps(self) -> set[int]:
        """The plan steps that run a forced membership change
        (evenly spaced, before the drawn action; the first executed
        is always a voter replace)."""
        if self.reconfigs <= 0:
            return set()
        return {((k + 1) * self.ops) // (self.reconfigs + 1)
                for k in range(self.reconfigs)}

    def forced_overload_steps(self) -> set[int]:
        """The plan steps that fire an overload burst (evenly
        spaced, before the drawn action; offset from the reconfig
        spacing so the two rarely collide)."""
        if self.overloads <= 0:
            return set()
        return {((2 * k + 1) * self.ops) // (2 * self.overloads + 1)
                for k in range(self.overloads)}


class EnsembleUnderTest:
    """The campaign's ensemble: a ``ZKEnsemble`` (member 0 = leader
    endpoint; followers serve from their own ReplicaStore, so they
    genuinely lag when told to) composed — not subclassed, so the
    client-side io package keeps its lazy server imports — with
    dead-member tracking, a ReplicationService, and one
    cross-process-protocol replica: a RemoteLeader mirror over real
    TCP through server/replication.py that the plan partitions and
    heals.  Member lifecycle (start/kill/restart/lag) delegates to
    the ZKEnsemble, so the two harnesses cannot drift.

    The replica does not serve clients: a RemoteLeader forwards writes
    over a *blocking* control socket, and with every member on the one
    campaign event loop that RPC would deadlock against the
    ReplicationService it is calling (the OS-process tier exists
    precisely because of this — server/member_worker.py); the
    SIGKILL acceptance test keeps that tier covered.  Here the replica
    is the partition target, and its convergence with the leader after
    heal + sync barrier is one of the campaign's checks."""

    def __init__(self, members: int = 3, wal_dir: str | None = None,
                 durability: str | None = None,
                 wal_segment_bytes: int | None = None,
                 seed: int | None = None, observers: int = 0):
        from ..server.replication import ReplicationService
        from ..server.server import ZKEnsemble

        #: heartbeat shrunk for campaign pace: leader-loss detection
        #: inside a few plan steps instead of half a second
        self._ens = ZKEnsemble(members, lag=0.0, wal_dir=wal_dir,
                               durability=durability,
                               wal_segment_bytes=wal_segment_bytes,
                               heartbeat_ms=40, seed=seed,
                               observers=observers)
        self.db = self._ens.db
        self.servers = self._ens.servers
        self.coordinator = self._ens.election
        self.svc = ReplicationService(self.db)
        self.dead: set[int] = set()
        #: members a reconfig removed from the ensemble outright
        #: (observer leave): stopped and detached, never restarted
        self.removed: set[int] = set()
        self.remote = None           # RemoteLeader (events/control)
        self.replica = None          # RemoteReplicaStore over it

    @property
    def leader_idx(self) -> int:
        return self._ens.leader_idx

    @property
    def voters(self) -> int:
        """Voting-member count — live through reconfigs (the
        ZKEnsemble re-derives it on every config change)."""
        return self._ens.voters

    def voter_idxs(self) -> list[int]:
        """Current voter member indices, from the installed config
        (after a reconfig they are no longer ``range(voters)``)."""
        if getattr(self.db, 'voter_ids', None) is not None:
            return sorted(self.db.voter_ids)
        return list(range(self._ens.voters))

    def observer_idxs(self) -> list[int]:
        """Current observer member indices, from the installed
        config."""
        if getattr(self.db, 'voter_ids', None) is not None:
            return sorted(self.db.observer_ids)
        return list(range(self._ens.voters, len(self.servers)))

    def config_addresses(self) -> list[tuple[str, int]]:
        """The live config's member addresses (voters + observers) —
        what a client resolver adopts after a membership change."""
        idxs = sorted(set(self.voter_idxs())
                      | set(self.observer_idxs()))
        return [self.servers[i].address for i in idxs
                if i < len(self.servers)]

    async def start(self) -> 'EnsembleUnderTest':
        from ..server.replication import (
            RemoteLeader,
            RemoteReplicaStore,
        )

        await self._ens.start()
        await self.svc.start()
        self.remote = await RemoteLeader('127.0.0.1',
                                         self.svc.port).connect()
        self.replica = RemoteReplicaStore(self.remote, lag=0.0)
        return self

    def install_faults(self, inj: FaultInjector) -> None:
        self._ens.install_faults(inj)
        self.svc.faults = inj
        if self.db.wal is not None:
            self.db.wal.faults = inj

    def addresses(self) -> list[tuple[str, int]]:
        return self._ens.addresses()

    def live(self) -> list[int]:
        return [i for i in range(len(self.servers))
                if i not in self.dead and i not in self.removed]

    async def kill(self, idx: int) -> None:
        await self._ens.kill(idx)
        self.dead.add(idx)

    async def restart(self, idx: int) -> None:
        await self._ens.restart(idx)
        self.dead.discard(idx)

    def set_lag(self, idx: int, lag: float | None) -> None:
        """Delayed follower catch-up: None parks the follower's
        replica until the next write/sync through it; restoring a
        non-positive lag applies the parked backlog immediately."""
        self._ens.set_lag(idx, lag)
        if lag is not None and lag <= 0:
            self.servers[idx].store.catch_up()

    # -- runtime membership changes (delegated to the ZKEnsemble so
    # the two harnesses cannot drift) --

    async def add_observer(self) -> int:
        return await self._ens.add_observer()

    async def remove_observer(self, idx: int) -> None:
        await self._ens.remove_observer(idx)
        self.removed.add(idx)

    async def add_voter(self) -> int:
        return await self._ens.add_voter()

    async def remove_voter(self, idx: int) -> None:
        # the demoted member drains on as an out-of-config observer
        # (still killable, still serving) — not `removed`
        await self._ens.remove_voter(idx)

    async def replace_voter(self, old_idx: int) -> int:
        return await self._ens.replace_voter(old_idx)

    def partition_replica(self) -> bool:
        """Toggle the scheduled asymmetric partition of the TCP
        replica; returns True when now partitioned."""
        token = self.remote.token
        if token in self.svc.partitioned:
            self.svc.partitioned.discard(token)
            return False
        self.svc.partitioned.add(token)
        return True

    def heal(self) -> None:
        self.svc.partitioned.clear()

    async def stop(self) -> None:
        if self.remote is not None:
            self.remote.close()
        await self._ens.stop()
        await self.svc.stop()


#: The forced-reconfig action mix ('churn-reconfig' stream;
#: repetition = weight).  The first executed step of every schedule
#: bypasses the draw: it is always 'replace-voter', the full joint
#: handoff the acceptance criteria pin.
RECONFIG_ACTIONS = ('replace-voter', 'add-observer', 'add-observer',
                    'remove-observer', 'add-voter', 'remove-voter')


def _make_force_reconfig(ens, res, rrng, note_member,
                         force_election, update_resolvers):
    """Build the forced-reconfig step shared by the ensemble
    schedules (single-client and concurrent): one membership change
    under traffic per call.  The db's config-change hook (wrapped by
    the caller) records every config record into the history, so
    invariant 7's extension replays exactly what landed."""
    done = {'k': 0}

    async def force_reconfig() -> None:
        db = ens.db
        if getattr(db, 'voter_ids', None) is None \
                or ens.coordinator is None:
            return
        k, done['k'] = done['k'], done['k'] + 1
        # a joint commit needs majorities of BOTH configs audible:
        # bring dead members back before opening the window
        for back in sorted(ens.dead):
            note_member('restart', back)
            await ens.restart(back)
        act = ('replace-voter' if k == 0
               else rrng.choice(RECONFIG_ACTIONS))
        voter_change = act not in ('add-observer',
                                   'remove-observer')
        if voter_change and db.reconfig_epoch == db.epoch:
            # at most one voter-set change per epoch (invariant 7
            # extension): a second change needs a fresh era — earn
            # it the legitimate way, through an election
            await force_election()
            for back in sorted(ens.dead):
                note_member('restart', back)
                await ens.restart(back)
        try:
            if act == 'add-observer':
                idx = await asyncio.wait_for(ens.add_observer(), 10)
                note_member('reconfig-add-observer', idx)
            elif act == 'remove-observer':
                obs = [i for i in ens.observer_idxs()
                       if i not in ens.dead and i not in ens.removed]
                if not obs:
                    return
                idx = obs[rrng.randrange(len(obs))]
                await asyncio.wait_for(ens.remove_observer(idx), 10)
                note_member('reconfig-remove-observer', idx)
            elif act == 'add-voter':
                idx = await asyncio.wait_for(ens.add_voter(), 10)
                note_member('reconfig-add-voter', idx)
            elif act == 'remove-voter':
                cands = [i for i in ens.voter_idxs()
                         if i != ens.leader_idx]
                if len(ens.voter_idxs()) <= 2 or not cands:
                    return
                idx = cands[rrng.randrange(len(cands))]
                await asyncio.wait_for(ens.remove_voter(idx), 10)
                note_member('reconfig-remove-voter', idx)
            else:
                cands = [i for i in ens.voter_idxs()
                         if i != ens.leader_idx]
                if not cands:
                    return
                old = cands[rrng.randrange(len(cands))]
                idx = await asyncio.wait_for(
                    ens.replace_voter(old), 10)
                note_member('reconfig-replace-voter(%d->%d)'
                            % (old, idx), idx)
        except ValueError as e:
            # a legal refusal (the per-epoch fence, an empty voter
            # set): the fence HOLDING is the invariant — record it
            # in the timeline and move on
            note_member('reconfig-refused(%s)' % (e,), act)
            return
        except (asyncio.TimeoutError, TimeoutError):
            res.violations.append(
                'forced reconfig (%s) hung past 10s: joint quorum '
                'never assembled' % (act,))
            return
        # the elastic client side: resolvers adopt the new member
        # list, subset-capped read planes rebalance onto it
        update_resolvers()
        note_member('resolver-update', '-')

    return force_reconfig


#: The forced-overload action mix ('churn-overload' stream;
#: repetition = weight).  Every action must observe a definite
#: outcome — an oversized raw frame left hanging open is a
#: violation, a shed flood connection is the defense working.
OVERLOAD_ACTIONS = ('flood', 'flood', 'stall', 'stall', 'oversize')


async def _overload_flood(address: str, port: int, n: int,
                          hold_s: float = 0.05) -> None:
    """Open ``n`` raw TCP connections at once and hold them briefly:
    the admission path (per-shard/global caps + handshake pacer,
    io/overload.py) must shed or accept every one with the member
    still serving — never wedge the accept loop.  A refused or
    RST-shed dial IS the defense working, so errors are swallowed."""
    async def one():
        try:
            _r, w = await asyncio.wait_for(
                asyncio.open_connection(address, port), 1.0)
        except (OSError, asyncio.TimeoutError, TimeoutError):
            return
        try:
            await asyncio.sleep(hold_s)
        finally:
            w.close()
    await asyncio.gather(*(one() for _ in range(n)),
                         return_exceptions=True)


async def _overload_oversize(address: str, port: int,
                             declared: int = 1 << 27) -> bool:
    """Declare an absurd frame length on a raw socket: the member
    must refuse it BEFORE buffering (a typed frame-cap eviction,
    io/overload.py) and the socket must observe a definite close.
    Returns True when the socket HUNG open instead — the caller
    records that as a violation."""
    try:
        r, w = await asyncio.wait_for(
            asyncio.open_connection(address, port), 1.0)
    except (OSError, asyncio.TimeoutError, TimeoutError):
        return False
    try:
        w.write(struct.pack('>i', declared) + b'\x00' * 16)
        try:
            await asyncio.wait_for(w.drain(), 1.0)
        except (OSError, asyncio.TimeoutError, TimeoutError):
            pass
        try:
            await asyncio.wait_for(r.read(1 << 16), 2.0)
        except (asyncio.TimeoutError, TimeoutError):
            return True
        except OSError:
            return False
        return False
    finally:
        try:
            w.close()
        except OSError:
            pass


def _make_force_overload(res, ovrng, note_member, live_address,
                         pick_client, cfg=None):
    """Build the overload pressure step shared by the ensemble
    schedules (single-client and concurrent): one burst per call
    against a live member — a forced plan step draws its own action
    (``act=None``), a config-probability firing passes the
    injector's drawn action in.  ``live_address()`` returns a live
    member's ``(host, port)`` or None; ``pick_client()`` returns
    the client whose reader the 'stall' action parks (the
    slow-consumer shape — the member's tx backlog for that session
    grows until the soft watermark starts shedding notifications).
    ``cfg`` (FaultConfig) bounds the flood size and stall window."""
    async def force_overload(act: str | None = None) -> None:
        addr = live_address()
        if addr is None:
            return
        if act is None:
            act = ovrng.choice(OVERLOAD_ACTIONS)
        if act == 'flood':
            n = (ovrng.randint(6, max(7, cfg.flood_conns))
                 if cfg is not None else ovrng.randint(6, 20))
            note_member('overload-flood(%d)' % (n,), '-')
            await _overload_flood(addr[0], addr[1], n)
        elif act == 'stall':
            c = pick_client()
            conn = (c.current_connection()
                    if c is not None else None)
            t = getattr(conn, 'transport', None)
            if t is None:
                return
            lo, hi = (cfg.stall_window_ms if cfg is not None
                      else (20.0, 120.0))
            window = ovrng.uniform(lo, hi) / 1000.0
            note_member('overload-stall(%.0fms)'
                        % (window * 1e3), '-')
            try:
                t.pause_reading()
            except (RuntimeError, OSError):
                return
            await asyncio.sleep(window)
            try:
                t.resume_reading()
            except (RuntimeError, OSError):
                pass
        else:
            note_member('overload-oversize', '-')
            hung = await _overload_oversize(addr[0], addr[1])
            if hung:
                res.violations.append(
                    'oversized raw frame: no definite close within '
                    '2s (the frame cap must refuse before '
                    'buffering)')
    return force_overload


async def run_ensemble_schedule(seed: int, ops: int = 12,
                                collector=None,
                                plan: FaultPlan | None = None,
                                elections: int | None = None,
                                clients: int | None = None,
                                observers: int | None = None,
                                reconfigs: int | None = None,
                                overloads: int | None = None,
                                cached: bool | None = None,
                                device='cuda'
                                ) -> ScheduleResult:
    """Run one seeded ensemble-tier schedule: member churn around a
    client workload, every op recorded into an append-only history,
    then the history invariants (io/invariants.py) checked against
    the leader's final database.  ``clients`` > 1 switches to the
    concurrent tier (:func:`run_concurrent_schedule`): N clients
    writing overlapping keys, checked per key for linearizability
    (invariant 9).  ``observers`` overrides the plan's non-voting
    member count (read plane; their churn rides a fresh RNG
    stream).  Any failure is reproducible with ``python -m
    zkstream_tpu_torch chaos --tier ensemble --seed N [--clients N]
    [--observers N]``.  ``device`` is where a plan's ``FleetIngest``
    runs its ticks (``'cuda'`` by default; it raises without a card).
    It is not part of the plan: a seed draws the same schedule on any
    device."""
    if clients is not None and clients > 1:
        return await run_concurrent_schedule(
            seed, ops=ops, clients=clients, collector=collector,
            plan=plan, elections=elections, observers=observers,
            reconfigs=reconfigs, overloads=overloads, cached=cached,
            device=device)
    from ..client import Client
    from ..protocol.consts import CreateFlag
    from .backoff import BackoffPolicy
    from .invariants import History, check_ephemerals, check_history
    from .pool import DEFAULT_DECOHERENCE_INTERVAL

    import shutil
    import tempfile

    if plan is None:
        plan = FaultPlan.randomized(seed, ops=ops)
    if elections is not None:
        # explicit override (chaos --elections N): part of the rerun
        # key — seed + flags reproduce the schedule exactly
        plan.elections = elections
    if observers is not None:
        plan.observers = observers
    if reconfigs is not None:
        plan.reconfigs = reconfigs
    if overloads is not None:
        plan.overloads = overloads
    if cached is not None:
        plan.cached = cached
    #: observer churn draws ride their own stream (fresh per seed):
    #: attaching observers must not shift any draw existing seeds pin
    orng = random.Random('churn-obs/%d' % (seed,))
    #: forced-reconfig draws (victim/action choice) — fresh stream,
    #: same rule
    rrng = random.Random('churn-reconfig/%d' % (seed,))
    #: forced-overload draws (action/size choice) — fresh stream,
    #: same rule
    ovrng = random.Random('churn-overload/%d' % (seed,))
    inj = FaultInjector(seed, plan.config)
    res = ScheduleResult(seed=seed, tier='ensemble')
    h = History()

    wal_dir = tempfile.mkdtemp(prefix='zkchaos-ens-wal-')
    crash_dir = tempfile.mkdtemp(prefix='zkchaos-ens-crash-')
    ens = await EnsembleUnderTest(
        plan.members, wal_dir=wal_dir, durability=plan.durability,
        wal_segment_bytes=plan.wal_segment_bytes, seed=seed,
        observers=plan.observers).start()
    ens.install_faults(inj)

    # every config record — joint and final — lands in the history
    # with the epoch it was appended under; check_reconfig (the
    # invariant-7 extension) replays them.  Chained UNDER the
    # ZKEnsemble's own hook, which re-derives the quorum/ballot sets.
    _prev_cfg_hook = ens.db.on_config_change

    def _on_cfg(phase, entry, _prev=_prev_cfg_hook):
        if _prev is not None:
            _prev(phase, entry)
        h.reconfig(entry[1], entry[2], ens.db.epoch,
                   voters=entry[4], old_voters=entry[3],
                   observers=entry[5])
    ens.db.on_config_change = _on_cfg

    ingest = None
    if plan.ingest_mode != 'none':
        from .ingest import FleetIngest
        ingest = FleetIngest(
            body_mode='host', max_frames=8, device=device,
            bypass_bytes=(0 if plan.ingest_mode == 'batch'
                          else FleetIngest.BYPASS_BYTES))
        ingest.faults = inj

    client = Client(
        servers=ens.addresses(), shuffle_backends=False,
        session_timeout=plan.session_timeout, seed=seed, faults=inj,
        op_timeout=CAMPAIGN_OP_DEADLINE_MS, collector=collector,
        ingest=ingest, trace_capacity=512,
        # with observers attached the client-side read plane is on:
        # reads fan out across the whole membership, zxid-gated, and
        # check_session_reads holds the session-monotone rung
        read_distribution=plan.observers > 0,
        read_subset=plan.read_subset,
        # --cached: the watch-backed cache plane rides the whole
        # fault vocabulary; check_session_reads must still hold on
        # every locally-served read (cache=False pins the knob OFF
        # regardless of ZKSTREAM_CACHE, keeping schedules seeded)
        cache='/' if plan.cached else False,
        decoherence_interval=(plan.decoherence_ms
                              if plan.decoherence_ms is not None
                              else DEFAULT_DECOHERENCE_INTERVAL),
        connect_policy=BackoffPolicy(timeout=400, retries=2,
                                     delay=30, cap=200),
        default_policy=BackoffPolicy(timeout=400, retries=3,
                                     delay=50, cap=400))

    def on_op(span):
        h.op(span.op, span.path, status=span.status, zxid=span.zxid,
             session_id=int(span.session_id, 16)
             if span.session_id else 0,
             error=span.error)
    client.on_op = on_op
    client.on('expire', lambda: h.session_event(
        'expired', client.session.session_id
        if client.session is not None else 0))
    client.start()

    def note_member(event: str, member) -> None:
        h.member_event(event, member)
        client.trace.note('MEMBER_' + event.upper(),
                          path='member:%s' % (member,), kind='member')

    if ens.coordinator is None:
        # static-leader validator path (ZKSTREAM_NO_ELECTION=1 /
        # election=False): a drawn election count is meaningless here
        # and must not read as a missed-election violation — and a
        # reconfig's joint handoff has no election to lean on either
        plan.elections = 0
        plan.reconfigs = 0
    else:
        # every completed election lands in the history (invariant 7
        # replays these) AND the client span ring, so a failing seed's
        # timeline shows the failover causally
        def on_elected(member, epoch, dur_ms):
            h.election(member, epoch)
            client.trace.note('ELECTED',
                              path='member:%s' % (member,),
                              kind='member',
                              detail='epoch=%d' % (epoch,),
                              duration_ms=round(dur_ms, 3))
        ens.coordinator.on('elected', on_elected)

    def elections_seen() -> int:
        return sum(1 for r in h.records if r['kind'] == 'election')

    async def force_election() -> None:
        """Kill the CURRENT leader and wait for the coordinator to
        elect a successor — restarting dead members first when the
        survivors would fall under a quorum.  The detection path is
        the real one (heartbeat monitor), not a direct call."""
        if ens.coordinator is None:
            return
        voter_set = set(ens.voter_idxs())
        need = len(voter_set) // 2 + 1
        while ens.dead and \
                len([j for j in ens.live() if j in voter_set]) - 1 \
                < need:
            back = sorted(ens.dead)[0]
            note_member('restart', back)
            await ens.restart(back)
        lead = ens.leader_idx
        before = elections_seen()
        if lead not in ens.dead:
            note_member('kill-leader', lead)
            await ens.kill(lead)
        deadline = 8.0
        step = 0.02
        while elections_seen() <= before and deadline > 0:
            await asyncio.sleep(step)
            deadline -= step
        if elections_seen() <= before:
            res.violations.append(
                'forced election: no successor elected within 8s of '
                'killing leader %d' % (lead,))

    force_reconfig = _make_force_reconfig(
        ens, res, rrng, note_member, force_election,
        lambda: client.update_backends(ens.config_addresses()))

    def _live_address():
        live = ens.live()
        if not live:
            return None
        return ens.servers[live[0]].address

    force_overload = _make_force_overload(
        res, ovrng, note_member, _live_address, lambda: client,
        cfg=plan.config)

    def sid() -> int:
        for r in reversed(h.records):
            if r['kind'] == 'op':
                return r['session_id']
        return 0

    def last_zxid() -> int | None:
        """The reply zxid of the op that just completed (its span
        settles — and lands in the history via on_op — before the op
        future resolves); stamps acks so the recovery invariant can
        demote acks past a failed fsync's durable floor."""
        for r in reversed(h.records):
            if r['kind'] == 'op':
                return r.get('zxid')
        return None

    async def bounded(coro, what, op=None, path=None, seq_parent=None):
        """One op under the shared hard bound (_bounded_op); writes
        with an unknown outcome are recorded as ambiguous."""
        on_amb = None
        if op is not None:
            def on_amb():
                h.ambiguous(op, path, session_id=sid(),
                            sequential_parent=seq_parent)
        return await _bounded_op(res, coro, what, on_amb)

    async def do_create(path, data, flags=0, seq_parent=None):
        ok, made = await bounded(
            client.create(path, data, flags=flags),
            'create %s' % path, op='create', path=path,
            seq_parent=seq_parent)
        if ok:
            res.acked += 1
            h.acked_create(made, data, sid(),
                           ephemeral=bool(CreateFlag(flags)
                                          & CreateFlag.EPHEMERAL),
                           sequential_parent=seq_parent,
                           zxid=last_zxid())
        return ok, made

    async def wait_usable(timeout: float) -> bool:
        if client.is_connected():
            return True
        try:
            await client.wait_connected(timeout=timeout,
                                        fail_fast=False)
            return True
        except (asyncio.TimeoutError, TimeoutError):
            return False

    fires: list = []
    created: list[str] = []          # deletable acked paths
    set_idx = 0
    try:
        if not await wait_usable(10):
            res.violations.append(
                'never connected within 10s (fault budget %r should '
                'have exhausted)' % (inj.config.max_faults,))
            return res

        client.watcher('/w').on(
            'dataChanged',
            lambda data, stat: (fires.append(stat.mzxid),
                                h.watch_fire('/w', 'dataChanged',
                                             stat.mzxid)))
        client.watcher('/').on(
            'childrenChanged',
            lambda ch, stat: h.watch_fire('/', 'childrenChanged',
                                          stat.pzxid))

        # bootstrap nodes the workload mutates; a failed bootstrap is
        # fine — the dependent ops surface typed errors
        ok, _ = await do_create('/w', b'v0')
        if ok:
            h.acked_set('/w', 0, sid(), zxid=last_zxid())
        await do_create('/seq', b'')

        async def do_multi(i: int) -> None:
            """One forced all-or-nothing batch over fresh paths:
            create two nodes and overwrite the first, as ONE txn.
            Recorded whatever the outcome — invariant 8 demands
            whole-or-nothing visibility either way."""
            a, b = '/m%da' % (i,), '/m%db' % (i,)
            za, yb = b'z%d' % (i,), b'y%d' % (i,)
            ops_ = [{'op': 'create', 'path': a, 'data': b'x'},
                    {'op': 'create', 'path': b, 'data': yb},
                    {'op': 'set_data', 'path': a, 'data': za}]
            h.multi_batch([('create', a, za), ('create', b, yb)],
                          session_id=sid())
            ok, _ = await bounded(client.multi(ops_),
                                  'multi %d' % (i,), op='multi')
            if ok:
                res.acked += 1
                h.acked_create(a, za, sid(), zxid=last_zxid())
                h.acked_create(b, yb, sid(), zxid=last_zxid())

        forced_steps = plan.forced_election_steps()
        multi_steps = plan.forced_multi_steps()
        reconfig_steps = plan.forced_reconfig_steps()
        overload_steps = plan.forced_overload_steps()
        for i in range(plan.ops):
            await wait_usable(1.5)
            res.ops += 1
            if i in forced_steps:
                await force_election()
            if i in reconfig_steps:
                await force_reconfig()
            if i in overload_steps:
                await force_overload()
            if i in multi_steps:
                await do_multi(i)
            act = inj.choice('plan', PLAN_ACTIONS)
            if act == 'set':
                set_idx += 1
                ok, _ = await bounded(
                    client.set('/w', b'v%d' % set_idx, version=-1),
                    'set /w v%d' % set_idx, op='set', path='/w')
                if ok:
                    res.acked += 1
                    h.acked_set('/w', set_idx, sid(),
                                zxid=last_zxid())
            elif act == 'create':
                ok, made = await do_create('/c%d' % i, b'd%d' % i)
                if ok:
                    created.append(made)
            elif act == 'create_seq':
                await do_create('/seq/n-', b's%d' % i,
                                flags=CreateFlag.SEQUENTIAL,
                                seq_parent='/seq')
            elif act == 'create_eph':
                await do_create('/e%d' % i, b'e%d' % i,
                                flags=CreateFlag.EPHEMERAL)
            elif act == 'delete':
                if not created:
                    continue
                path = inj.choice('plan', created)
                ok, _ = await bounded(client.delete(path, -1),
                                      'delete %s' % path,
                                      op='delete', path=path)
                if ok:
                    res.acked += 1
                    h.acked_delete(path, sid(), zxid=last_zxid())
                    created.remove(path)
            elif act == 'get':
                await bounded(client.get('/w'), 'get /w')
            elif act == 'list':
                await bounded(client.list('/'), 'list /')
            elif act == 'sync':
                await bounded(client.sync('/w'), 'sync /w',
                              op='sync', path='/w')
            elif act in ('kill_serving', 'kill_during_op'):
                conn = client.current_connection()
                live = ens.live()
                if conn is None or len(live) <= 1:
                    continue
                victim = next((j for j in live
                               if ens.servers[j].port ==
                               conn.backend.port), None)
                if victim is None:
                    continue
                if act == 'kill_during_op':
                    set_idx += 1
                    inflight = asyncio.get_running_loop().create_task(
                        client.set('/w', b'v%d' % set_idx,
                                   version=-1))
                    await asyncio.sleep(0.003)
                    note_member('kill-mid-op', victim)
                    await ens.kill(victim)
                    ok, _ = await bounded(
                        inflight, 'mid-kill set /w v%d' % set_idx,
                        op='set', path='/w')
                    if ok:
                        res.acked += 1
                        h.acked_set('/w', set_idx, sid(),
                                    zxid=last_zxid())
                else:
                    note_member('kill', victim)
                    await ens.kill(victim)
            elif act == 'kill_follower':
                # voters only: observer churn rides its own stream
                # (the CONFIG's voter set — after a reconfig the
                # voters are no longer ``range(voters)``)
                voter_set = set(ens.voter_idxs())
                live = [j for j in ens.live()
                        if j != 0 and j in voter_set]
                if not live or len(ens.live()) <= 1:
                    continue
                victim = inj.choice('plan', live)
                note_member('kill', victim)
                await ens.kill(victim)
            elif act == 'kill_leader':
                # the CURRENT leader: with election on it may be any
                # member (a previous kill already moved leadership)
                lead = ens.leader_idx
                if lead in ens.dead or len(ens.live()) <= 1:
                    continue
                note_member('kill', lead)
                await ens.kill(lead)
            elif act == 'restart':
                if not ens.dead:
                    continue
                back = inj.choice('plan', sorted(ens.dead))
                note_member('restart', back)
                await ens.restart(back)
            elif act == 'partition':
                if ens.partition_replica():
                    note_member('partition', 'replica')
                else:
                    note_member('heal', 'replica')
            elif act == 'lag':
                # non-member-0 voters (same list as range(1, voters)
                # until a reconfig moves the membership; same length
                # either way, so the 'plan' stream stays aligned)
                idx = inj.choice('plan',
                                 [j for j in ens.voter_idxs()
                                  if j != 0])
                lag = inj.choice('plan', (None, 0.05, 0.0))
                note_member('lag=%r' % (lag,), idx)
                ens.set_lag(idx, lag)
            else:
                assert act == 'migrate', act
                note_member('migrate', '-')
                client.pool.rebalance_now()
            if plan.observers:
                # observer fault vocabulary, on its OWN stream: lag
                # windows, a sustained park (the partition shape — a
                # partitioned observer's replica stops applying, so
                # only ITS sessions' reads gate-block or bounce) and
                # heals.  The zxid read gate is the invariant under
                # test: check_session_reads must stay clean.
                oact = orng.choice(('none', 'none', 'lag', 'park',
                                    'heal'))
                if oact != 'none':
                    # the CONFIG's observers (identical to
                    # voters+range(observers) until a reconfig moves
                    # the membership; one draw either way, so the
                    # stream stays aligned)
                    obs = [j for j in ens.observer_idxs()
                           if j not in ens.removed]
                    pick = orng.randrange(max(1, len(obs)))
                    if not obs:
                        continue
                    oidx = obs[pick]
                    if oact == 'lag':
                        olag = orng.choice((0.05, 0.0))
                        note_member('observer-lag=%r' % (olag,), oidx)
                        ens.set_lag(oidx, olag)
                    elif oact == 'park':
                        note_member('observer-partition', oidx)
                        ens.set_lag(oidx, None)
                    else:
                        note_member('observer-heal', oidx)
                        ens.set_lag(oidx, 0.0)
            # config-probability overload firings ('overload'
            # stream, fault-budget accounted) on top of the plan's
            # forced steps
            ov_act = inj.overload_action()
            if ov_act is not None:
                await force_overload(ov_act)

        # -- verification: faults off, ensemble healed --------------
        inj.stop()
        ens.heal()
        for back in sorted(ens.dead):
            note_member('restart', back)
            await ens.restart(back)
        for j in range(1, len(ens.servers)):
            ens.set_lag(j, 0.0)
        if not await wait_usable(10):
            res.violations.append(
                'never reconnected after every member was restarted '
                'and faults stopped')
        else:
            await bounded(client.sync('/w'), 'final sync /w',
                          op='sync', path='/w')
        # the TCP replica must converge once partitions heal: the
        # sync barrier rides the (never-partitioned) control channel
        try:
            await asyncio.wait_for(
                asyncio.get_running_loop().run_in_executor(
                    None, ens.replica.sync_flush), 5)
        except (asyncio.TimeoutError, TimeoutError):
            res.violations.append(
                'replica sync barrier hung after partitions healed')
        else:
            if ens.replica.zxid != ens.db.zxid:
                res.violations.append(
                    'replica did not converge after heal: replica '
                    'zxid %d, leader zxid %d'
                    % (ens.replica.zxid, ens.db.zxid))
            else:
                diverged = [
                    p for p in ens.db.nodes
                    if p not in ens.replica.nodes
                    or bytes(ens.replica.nodes[p].data)
                    != bytes(ens.db.nodes[p].data)]
                extra = [p for p in ens.replica.nodes
                         if p not in ens.db.nodes]
                if diverged or extra:
                    res.violations.append(
                        'replica tree diverged from leader at equal '
                        'zxid %d: missing/stale %r, extra %r'
                        % (ens.db.zxid, sorted(diverged)[:8],
                           sorted(extra)[:8]))

        res.watch_fires = len(fires)
        # compare against the steps actually SCHEDULED: with ops <
        # elections+1 the evenly-spaced steps collide and fewer
        # elections are forced — that is a plan-shape fact, not a
        # missed election
        forced_n = len(plan.forced_election_steps())
        if forced_n and elections_seen() < forced_n:
            res.violations.append(
                'plan forced %d election(s) but only %d completed'
                % (forced_n, elections_seen()))
        # a forced reconfig may legally refuse (the per-epoch fence),
        # but a plan that forces any must land at least one config
        # record — the first step's voter replace has no fence to hit
        if plan.forced_reconfig_steps() and \
                not h.of_kind('reconfig'):
            res.violations.append(
                'plan forced %d reconfig step(s) but no config '
                'record landed' % (plan.reconfigs,))
        res.violations.extend(check_history(h, ens.db))

        # -- durability: full-ensemble SIGKILL + restart-from-disk --
        # (invariant 6).  The crash image is the WAL directory as a
        # SIGKILL would leave it — cut at an injector-chosen fsync
        # window — and the recovered database must hold every
        # unambiguously-acked write.  The floor demotion only engages
        # when an injected fsync error left acks non-durable; under
        # the clean sync barrier every ack is enforced.
        wal = ens.db.wal
        if wal is not None:
            from ..server.persist import recover_state
            from ..server.store import ZKDatabase
            from .invariants import check_durable_recovery

            before = inj.crash_window_before_fsync()
            floor = wal.materialize_crash(crash_dir,
                                          before_fsync=before)
            h.member_event(
                'sigkill-recover(%s-fsync)'
                % ('before' if before else 'after'), 'ensemble')
            rec = recover_state(crash_dir, trace=client.trace)
            rdb = ZKDatabase()
            rdb.nodes = rec.nodes
            rdb.zxid = rec.zxid
            res.violations.extend(check_durable_recovery(
                h, rdb,
                floor_zxid=floor if wal.sync_errors else None))
        return res
    finally:
        # stop injecting on every exit path (the never-connected early
        # return included), and count fired faults only once quiet —
        # the teardown below must not race new faults into the tally
        # or past close()'s 5 s cap.  Each teardown step is guarded
        # individually: a teardown bug is exactly the kind of failure
        # this tier exists to surface, and it must still arrive with
        # its seed, violations, span ring and member timeline — never
        # abort the campaign or leak the ensemble's listeners.
        inj.stop()
        res.faults = len(inj.fired)
        try:
            await asyncio.wait_for(client.close(), 5)
        except (asyncio.TimeoutError, TimeoutError):
            client.pool.stop()
            res.violations.append('client.close() hung past 5s')
        except Exception as e:
            client.pool.stop()
            res.violations.append('client.close() raised: %r' % (e,))
        else:
            # confirmed close/expiry: ephemerals must not outlive it
            # (only NEW findings — the pre-close check_history pass
            # already reported anything visible before close)
            res.violations.extend(
                v for v in check_ephemerals(h, ens.db)
                if v not in res.violations)
        try:
            await ens.stop()
        except Exception as e:
            res.violations.append('ensemble teardown raised: %r'
                                  % (e,))
        inj.close()
        if ingest is not None:
            ingest.close()
        salvaged = _harvest_blackboxes(wal_dir)
        shutil.rmtree(wal_dir, ignore_errors=True)
        shutil.rmtree(crash_dir, ignore_errors=True)
        _note_open_spans(res, client.trace)
        res.trace = client.trace.dump()
        res.member_rings = {
            'member:%s' % (s.member,): s.trace.dump()
            for s in ens.servers if s.trace is not None}
        # harvested black boxes fill only the gaps: a live member's
        # ring dump is fresher than its on-disk frames
        for key, spans in salvaged.items():
            res.member_rings.setdefault(key, spans)
        res.history = list(h.records)
        # derived, never dual-appended: the history's member records
        # ARE the timeline
        res.member_events = h.member_timeline()
        res.elections = sum(1 for r in h.records
                            if r['kind'] == 'election')


async def run_ensemble_campaign(base_seed: int, schedules: int,
                                ops: int = 12, progress=None,
                                elections: int | None = None,
                                clients: int | None = None,
                                observers: int | None = None,
                                reconfigs: int | None = None,
                                overloads: int | None = None,
                                cached: bool | None = None,
                                device='cuda'
                                ) -> list[ScheduleResult]:
    """Run ``schedules`` consecutive seeded ensemble schedules
    starting at ``base_seed`` (``clients`` > 1: the concurrent
    tier, every schedule linearizability-checked; ``observers``
    overrides every plan's non-voting member count; ``reconfigs``
    every plan's forced membership-change count; ``overloads``
    every plan's forced overload-burst count; ``cached`` every
    plan's watch-backed client-cache draw; ``device`` where the
    plans' ingests run)."""
    out = []
    for i in range(schedules):
        r = await run_ensemble_schedule(base_seed + i, ops=ops,
                                        elections=elections,
                                        clients=clients,
                                        observers=observers,
                                        reconfigs=reconfigs,
                                        overloads=overloads,
                                        cached=cached,
                                        device=device)
        out.append(r)
        if progress is not None:
            progress(r)
    return out


# ---------------------------------------------------------------------
# Concurrent tier: N clients writing OVERLAPPING keys through the
# full fault vocabulary (kills, elections, partitions, disk faults,
# server_rx), every op recorded as a two-sided interval
# (History.invoke/settle), checked per key by the WGL
# linearizability pass (analysis/linearize.py, invariant 9).  Shared
# by tests/test_torch_linearize.py, tests/test_torch_chaos_ensemble.py
# and ``chaos --tier ensemble --clients N``.
# ---------------------------------------------------------------------

#: The shared key set the concurrent workload contends on — small by
#: design: overlap is what exposes lost updates and stale reads.
CONCURRENT_KEYS = ('/k0', '/k1', '/k2')

#: Per-client workload mix (repetition = weight): read-heavy enough
#: that most writes are observed by somebody else's read.
CONCURRENT_ACTIONS = ('set', 'set', 'set', 'get', 'get', 'get',
                      'exists', 'create', 'create', 'delete',
                      'multi')

#: The churn driver's mix (its own RNG stream — per-client streams
#: and churn draws are fresh, so existing single-client seeds are
#: unperturbed).  'pause' keeps churn sparser than ops.
CONCURRENT_CHURN = ('kill_any', 'kill_leader', 'restart', 'restart',
                    'partition', 'lag', 'migrate',
                    'pause', 'pause', 'pause')


async def run_concurrent_schedule(seed: int, ops: int = 12,
                                  clients: int = 3,
                                  collector=None,
                                  plan: FaultPlan | None = None,
                                  elections: int | None = None,
                                  observers: int | None = None,
                                  reconfigs: int | None = None,
                                  overloads: int | None = None,
                                  cached: bool | None = None,
                                  device='cuda'
                                  ) -> ScheduleResult:
    """One seeded concurrent schedule: ``clients`` Clients driven
    from per-client RNG streams drawn fresh from the FaultPlan, each
    issuing ``ops`` overlapping create/set/delete/get/exists/multi
    ops on :data:`CONCURRENT_KEYS` while a churn driver kills,
    restarts, partitions and lags members (forced elections
    included).  Reads record their observed data/version/mzxid;
    writes their reply zxid; outcome-unknown ops stay ambiguous.
    After the schedule ``check_history`` replays the history — on a
    concurrent history the binding checks are invariants 2 (zxid
    monotone per session), 5 (watch at-most-once), 7 (elections)
    and 9 (per-key WGL linearizability, pinned to the leader's
    final tree: acked-write loss and torn MULTIs on the shared keys
    surface through that pinning, not through the single-client
    tier's ``ack``/``multi`` records, which this tier does not
    emit) — and the crash-image recovery is checked against the
    zxid-ordered replay prefix
    (:func:`~zkstream_tpu_torch.analysis.linearize.check_recovered_prefix`).
    Rerun any failure with ``python -m zkstream_tpu_torch chaos --tier
    ensemble --clients N --seed S``.  ``device`` is where the shared
    ``FleetIngest`` runs, as in :func:`run_ensemble_schedule`."""
    from ..client import Client
    from .backoff import BackoffPolicy
    from .invariants import History, check_ephemerals, check_history
    from .pool import DEFAULT_DECOHERENCE_INTERVAL

    import shutil
    import tempfile

    if plan is None:
        plan = FaultPlan.randomized(seed, ops=ops)
    if elections is not None:
        plan.elections = elections
    if observers is not None:
        plan.observers = observers
    if reconfigs is not None:
        plan.reconfigs = reconfigs
    if overloads is not None:
        plan.overloads = overloads
    if cached is not None:
        plan.cached = cached
    inj = FaultInjector(seed, plan.config)
    res = ScheduleResult(seed=seed, tier='ensemble',
                         clients=clients)
    h = History()
    rngs = [random.Random('client/%d/%d' % (seed, ci))
            for ci in range(clients)]
    crng = random.Random('churn/%d' % (seed,))
    #: observer churn rides its own stream — attaching observers
    #: must not shift the per-client or churn draws existing seeds pin
    orng = random.Random('churn-obs/%d' % (seed,))
    #: forced-reconfig draws — fresh stream, same rule
    rrng = random.Random('churn-reconfig/%d' % (seed,))
    #: forced-overload draws — fresh stream, same rule
    ovrng = random.Random('churn-overload/%d' % (seed,))

    wal_dir = tempfile.mkdtemp(prefix='zkchaos-conc-wal-')
    crash_dir = tempfile.mkdtemp(prefix='zkchaos-conc-crash-')
    ens = await EnsembleUnderTest(
        plan.members, wal_dir=wal_dir, durability=plan.durability,
        wal_segment_bytes=plan.wal_segment_bytes, seed=seed,
        observers=plan.observers).start()
    ens.install_faults(inj)

    # config records land in the history with their epoch (the
    # invariant-7 extension replays them) — chained under the
    # ZKEnsemble's own quorum/ballot re-derivation hook
    _prev_cfg_hook = ens.db.on_config_change

    def _on_cfg(phase, entry, _prev=_prev_cfg_hook):
        if _prev is not None:
            _prev(phase, entry)
        h.reconfig(entry[1], entry[2], ens.db.epoch,
                   voters=entry[4], old_voters=entry[3],
                   observers=entry[5])
    ens.db.on_config_change = _on_cfg

    ingest = None
    if plan.ingest_mode != 'none':
        from .ingest import FleetIngest
        # ONE shared ingest across all N clients — shared batched
        # drains are the plane's deployment shape
        ingest = FleetIngest(
            body_mode='host', max_frames=8, device=device,
            bypass_bytes=(0 if plan.ingest_mode == 'batch'
                          else FleetIngest.BYPASS_BYTES))
        ingest.faults = inj

    spans: list = [None] * clients
    cls: list = []
    for ci in range(clients):
        c = Client(
            servers=ens.addresses(), shuffle_backends=False,
            session_timeout=plan.session_timeout,
            seed=seed * 131 + ci, faults=inj,
            op_timeout=CAMPAIGN_OP_DEADLINE_MS, collector=collector,
            ingest=ingest, trace_capacity=512,
            # the read plane rides along whenever observers are
            # attached: distributed reads are zxid-gated and the
            # history must still pass check_session_reads
            read_distribution=plan.observers > 0,
            read_subset=plan.read_subset,
            # --cached: every client consults the watch-backed
            # cache first; contended keys make the invalidation
            # stream do real work and check_session_reads holds
            # the no-time-travel rung on every local serve
            cache='/' if plan.cached else False,
            decoherence_interval=(plan.decoherence_ms
                                  if plan.decoherence_ms is not None
                                  else DEFAULT_DECOHERENCE_INTERVAL),
            connect_policy=BackoffPolicy(timeout=400, retries=2,
                                         delay=30, cap=200),
            default_policy=BackoffPolicy(timeout=400, retries=3,
                                         delay=50, cap=400))

        def on_op(span, ci=ci):
            spans[ci] = span
            h.op(span.op, span.path, status=span.status,
                 zxid=span.zxid,
                 session_id=int(span.session_id, 16)
                 if span.session_id else 0,
                 error=span.error)
        c.on_op = on_op
        c.on('expire', lambda c=c: h.session_event(
            'expired', c.session.session_id
            if c.session is not None else 0))
        cls.append(c)

    def note_member(event: str, member) -> None:
        h.member_event(event, member)
        cls[0].trace.note('MEMBER_' + event.upper(),
                          path='member:%s' % (member,),
                          kind='member')

    if ens.coordinator is None:
        plan.elections = 0
        plan.reconfigs = 0
    else:
        def on_elected(member, epoch, dur_ms):
            h.election(member, epoch)
            cls[0].trace.note('ELECTED',
                              path='member:%s' % (member,),
                              kind='member',
                              detail='epoch=%d' % (epoch,),
                              duration_ms=round(dur_ms, 3))
        ens.coordinator.on('elected', on_elected)

    def elections_seen() -> int:
        return sum(1 for r in h.records if r['kind'] == 'election')

    async def force_election() -> None:
        if ens.coordinator is None:
            return
        voter_set = set(ens.voter_idxs())
        need = len(voter_set) // 2 + 1
        while ens.dead and \
                len([j for j in ens.live() if j in voter_set]) - 1 \
                < need:
            back = sorted(ens.dead)[0]
            note_member('restart', back)
            await ens.restart(back)
        lead = ens.leader_idx
        before = elections_seen()
        if lead not in ens.dead:
            note_member('kill-leader', lead)
            await ens.kill(lead)
        deadline = 8.0
        step = 0.02
        while elections_seen() <= before and deadline > 0:
            await asyncio.sleep(step)
            deadline -= step
        if elections_seen() <= before:
            res.violations.append(
                'forced election: no successor elected within 8s '
                'of killing leader %d' % (lead,))

    def _update_resolvers() -> None:
        addrs = ens.config_addresses()
        for c in cls:
            c.update_backends(addrs)

    force_reconfig = _make_force_reconfig(
        ens, res, rrng, note_member, force_election,
        _update_resolvers)

    def _live_address():
        live = ens.live()
        if not live:
            return None
        return ens.servers[live[0]].address

    force_overload = _make_force_overload(
        res, ovrng, note_member, _live_address,
        lambda: cls[ovrng.randrange(len(cls))], cfg=plan.config)

    async def usable(c, timeout: float) -> bool:
        if c.is_connected():
            return True
        try:
            await c.wait_connected(timeout=timeout, fail_fast=False)
            return True
        except (asyncio.TimeoutError, TimeoutError):
            return False

    async def call(ci: int, op: str, path: str | None, factory,
                   data: bytes | None = None,
                   version: int | None = None,
                   subs: list | None = None):
        """One interval-recorded op: invoke before the send, settle
        on every completion path with the observed payload.  Returns
        the op result on ack, None otherwise."""
        call_id = h.invoke(op, path, client=ci, data=data,
                           version=version, subs=subs)
        try:
            out = await asyncio.wait_for(factory(),
                                         CAMPAIGN_OP_HARD_S)
        except (ZKError, ZKProtocolError) as e:
            record_settle_error(res, h, call_id, e)
            return None
        except (asyncio.TimeoutError, TimeoutError):
            res.violations.append(
                'client %d: %s %s hung past the %.1fs hard bound '
                '(deadline %d ms never fired)'
                % (ci, op, path, CAMPAIGN_OP_HARD_S,
                   CAMPAIGN_OP_DEADLINE_MS))
            h.settle(call_id, 'unknown', error='HARD_BOUND')
            return None
        span = spans[ci]
        zxid = span.zxid if span is not None else None
        if op == 'set':
            h.settle(call_id, 'ok', zxid=out.mzxid,
                     version=out.version)
        elif op == 'get':
            got, stat = out
            h.settle(call_id, 'ok', zxid=stat.mzxid,
                     data=bytes(got), version=stat.version)
        elif op == 'exists':
            h.settle(call_id, 'ok', zxid=out.mzxid,
                     version=out.version)
        else:                        # create / delete / multi
            h.settle(call_id, 'ok', zxid=zxid)
        if op not in ('get', 'exists'):
            res.acked += 1
        return out

    fires: list = []
    obs_ver: list[dict] = [{} for _ in range(clients)]

    def pick_version(ci: int, key: str, rng) -> int:
        """Mostly unconditional; 1-in-4 pins the last version this
        client observed — BAD_VERSION under interleaving is a
        definite spec verdict the checker must explain."""
        if rng.random() < 0.25 and key in obs_ver[ci]:
            return obs_ver[ci][key]
        return -1

    async def worker(ci: int) -> None:
        c, rng = cls[ci], rngs[ci]
        if not await usable(c, 10):
            res.violations.append(
                'client %d never connected within 10s (fault '
                'budget %r should have exhausted)'
                % (ci, inj.config.max_faults))
            return
        for step in range(ops):
            await usable(c, 1.5)
            res.ops += 1
            act = rng.choice(CONCURRENT_ACTIONS)
            key = rng.choice(CONCURRENT_KEYS)
            tag = b'c%d-%d' % (ci, step)
            if act == 'create':
                await call(ci, 'create', key,
                           lambda: c.create(key, tag), data=tag)
            elif act == 'set':
                ver = pick_version(ci, key, rng)
                out = await call(
                    ci, 'set', key,
                    lambda: c.set(key, tag, version=ver),
                    data=tag, version=ver)
                if out is not None:
                    obs_ver[ci][key] = out.version
            elif act == 'delete':
                ver = pick_version(ci, key, rng)
                await call(ci, 'delete', key,
                           lambda: c.delete(key, ver),
                           version=ver)
                # whatever the outcome, the cached version is stale
                obs_ver[ci].pop(key, None)
            elif act == 'get':
                out = await call(ci, 'get', key,
                                 lambda: c.get(key))
                if out is not None:
                    obs_ver[ci][key] = out[1].version
            elif act == 'exists':
                out = await call(ci, 'exists', key,
                                 lambda: c.stat(key))
                if out is not None:
                    obs_ver[ci][key] = out.version
            else:                     # multi: atomic across 2 keys
                ka, kb = rng.sample(CONCURRENT_KEYS, 2)
                da, db_ = tag + b'a', tag + b'b'
                if rng.random() < 0.5:
                    subs = [('set_data', ka, da, -1),
                            ('set_data', kb, db_, -1)]
                    mops = [{'op': 'set_data', 'path': ka,
                             'data': da},
                            {'op': 'set_data', 'path': kb,
                             'data': db_}]
                else:
                    subs = [('create', ka, da, None),
                            ('set_data', kb, db_, -1)]
                    mops = [{'op': 'create', 'path': ka,
                             'data': da},
                            {'op': 'set_data', 'path': kb,
                             'data': db_}]
                await call(ci, 'multi', None,
                           lambda: c.multi(mops), subs=subs)

    async def churn() -> None:
        forced = plan.forced_election_steps()
        reconfig_steps = plan.forced_reconfig_steps()
        overload_steps = plan.forced_overload_steps()
        for i in range(ops):
            if i in forced:
                await force_election()
            if i in reconfig_steps:
                await force_reconfig()
            if i in overload_steps:
                await force_overload()
            act = crng.choice(CONCURRENT_CHURN)
            if act == 'kill_any':
                voter_set = set(ens.voter_idxs())
                live = [j for j in ens.live() if j in voter_set]
                if len(live) > 1:
                    victim = crng.choice(live)
                    note_member('kill', victim)
                    await ens.kill(victim)
            elif act == 'kill_leader':
                lead = ens.leader_idx
                if lead not in ens.dead and len(ens.live()) > 1:
                    note_member('kill', lead)
                    await ens.kill(lead)
            elif act == 'restart':
                if ens.dead:
                    back = crng.choice(sorted(ens.dead))
                    note_member('restart', back)
                    await ens.restart(back)
            elif act == 'partition':
                if ens.partition_replica():
                    note_member('partition', 'replica')
                else:
                    note_member('heal', 'replica')
            elif act == 'lag':
                idx = crng.choice([j for j in ens.voter_idxs()
                                   if j != 0])
                lag = crng.choice((None, 0.05, 0.0))
                note_member('lag=%r' % (lag,), idx)
                ens.set_lag(idx, lag)
            elif act == 'migrate':
                note_member('migrate', '-')
                for c in cls:
                    c.pool.rebalance_now()
            if plan.observers:
                # observer lag/partition vocabulary on its own
                # stream (same shape as the single-client tier)
                oact = orng.choice(('none', 'none', 'lag', 'park',
                                    'heal'))
                if oact != 'none':
                    # the CONFIG's observers (one draw either way,
                    # so the stream stays aligned through reconfigs)
                    obs = [j for j in ens.observer_idxs()
                           if j not in ens.removed]
                    pick = orng.randrange(max(1, len(obs)))
                    oidx = obs[pick] if obs else None
                    if oidx is None:
                        pass
                    elif oact == 'lag':
                        olag = orng.choice((0.05, 0.0))
                        note_member('observer-lag=%r' % (olag,),
                                    oidx)
                        ens.set_lag(oidx, olag)
                    elif oact == 'park':
                        note_member('observer-partition', oidx)
                        ens.set_lag(oidx, None)
                    else:
                        note_member('observer-heal', oidx)
                        ens.set_lag(oidx, 0.0)
            # config-probability overload firings ('overload'
            # stream, fault-budget accounted)
            ov_act = inj.overload_action()
            if ov_act is not None:
                await force_overload(ov_act)
            await asyncio.sleep(crng.uniform(0.005, 0.04))

    try:
        for c in cls:
            c.start()
        if not await usable(cls[0], 10):
            res.violations.append(
                'client 0 never connected within 10s (fault budget '
                '%r should have exhausted)'
                % (inj.config.max_faults,))
            return res

        cls[0].watcher(CONCURRENT_KEYS[0]).on(
            'dataChanged',
            lambda data, stat: (fires.append(stat.mzxid),
                                h.watch_fire(CONCURRENT_KEYS[0],
                                             'dataChanged',
                                             stat.mzxid)))

        await asyncio.gather(churn(),
                             *(worker(ci) for ci in range(clients)))

        # -- verification: faults off, ensemble healed --------------
        inj.stop()
        ens.heal()
        for back in sorted(ens.dead):
            note_member('restart', back)
            await ens.restart(back)
        for j in range(1, len(ens.servers)):
            ens.set_lag(j, 0.0)
        if not await usable(cls[0], 10):
            res.violations.append(
                'never reconnected after every member was restarted '
                'and faults stopped')
        else:
            try:
                await asyncio.wait_for(
                    cls[0].sync(CONCURRENT_KEYS[0]),
                    CAMPAIGN_OP_HARD_S)
            except (ZKError, ZKProtocolError,
                    asyncio.TimeoutError, TimeoutError):
                pass                  # sync is a barrier, not an op
        res.watch_fires = len(fires)
        forced_n = len(plan.forced_election_steps())
        if forced_n and elections_seen() < forced_n:
            res.violations.append(
                'plan forced %d election(s) but only %d completed'
                % (forced_n, elections_seen()))
        if plan.forced_reconfig_steps() and \
                not h.of_kind('reconfig'):
            res.violations.append(
                'plan forced %d reconfig step(s) but no config '
                'record landed' % (plan.reconfigs,))
        # the full invariant engine, invariant 9 (per-key WGL
        # linearizability pinned to the final tree) included
        res.violations.extend(check_history(h, ens.db))

        # -- durability: SIGKILL crash image + zxid-ordered replay --
        wal = ens.db.wal
        if wal is not None:
            from ..analysis.linearize import check_recovered_prefix
            from ..server.persist import recover_state
            from ..server.store import ZKDatabase

            before = inj.crash_window_before_fsync()
            wal.materialize_crash(crash_dir, before_fsync=before)
            h.member_event(
                'sigkill-recover(%s-fsync)'
                % ('before' if before else 'after'), 'ensemble')
            rec = recover_state(crash_dir, trace=cls[0].trace)
            rdb = ZKDatabase()
            rdb.nodes = rec.nodes
            rdb.zxid = rec.zxid
            res.violations.extend(check_recovered_prefix(h, rdb))
        return res
    finally:
        inj.stop()
        res.faults = len(inj.fired)
        for ci, c in enumerate(cls):
            try:
                await asyncio.wait_for(c.close(), 5)
            except (asyncio.TimeoutError, TimeoutError):
                c.pool.stop()
                res.violations.append(
                    'client %d close() hung past 5s' % (ci,))
            except Exception as e:
                c.pool.stop()
                res.violations.append(
                    'client %d close() raised: %r' % (ci, e))
        res.violations.extend(
            v for v in check_ephemerals(h, ens.db)
            if v not in res.violations)
        try:
            await ens.stop()
        except Exception as e:
            res.violations.append('ensemble teardown raised: %r'
                                  % (e,))
        inj.close()
        if ingest is not None:
            ingest.close()
        salvaged = _harvest_blackboxes(wal_dir)
        shutil.rmtree(wal_dir, ignore_errors=True)
        shutil.rmtree(crash_dir, ignore_errors=True)
        for c in cls:
            _note_open_spans(res, c.trace)
        res.trace = cls[0].trace.dump()
        res.member_rings = {
            'member:%s' % (s.member,): s.trace.dump()
            for s in ens.servers if s.trace is not None}
        for key, spans in salvaged.items():
            res.member_rings.setdefault(key, spans)
        res.history = list(h.records)
        res.member_events = h.member_timeline()
        res.elections = sum(1 for r in h.records
                            if r['kind'] == 'election')
