"""Unit tests for the port's retry backoff policy (io/backoff.py; the
port of tests/test_backoff.py):
cap, full-jitter bounds, reset-on-success, determinism — all against a
fake clock (the policy returns delays, it never sleeps), so the whole
module runs in milliseconds with zero real waiting."""

from __future__ import annotations

import pytest

from zkstream_tpu_torch.io.backoff import Backoff, BackoffPolicy


class FakeClock:
    """Accumulates the delays a retry loop would have slept."""

    def __init__(self):
        self.now = 0.0
        self.sleeps = []

    def sleep(self, ms):
        self.sleeps.append(ms)
        self.now += ms


def test_ceiling_grows_exponentially_then_caps():
    p = BackoffPolicy(delay=100, cap=1000, factor=2.0)
    assert p.ceiling(0) == 100.0
    assert p.ceiling(1) == 200.0
    assert p.ceiling(2) == 400.0
    assert p.ceiling(3) == 800.0
    assert p.ceiling(4) == 1000.0     # capped
    assert p.ceiling(50) == 1000.0    # stays capped, no overflow
    # a huge attempt count must not overflow float exponentiation
    assert p.ceiling(100000) == 1000.0


def test_ceiling_rejects_negative_attempt():
    with pytest.raises(ValueError):
        BackoffPolicy().ceiling(-1)


def test_full_jitter_bounds_and_cap():
    p = BackoffPolicy(delay=100, cap=1000, factor=2.0)
    bo = p.backoff(seed=7)
    clock = FakeClock()
    for i in range(200):
        d = bo.next_delay()
        clock.sleep(d)
        # full jitter: every delay drawn from [0, ceiling(attempt)],
        # and the ceiling itself never exceeds the cap
        assert 0.0 <= d <= p.ceiling(i)
        assert d <= p.cap
    # with 200 draws, jitter must actually jitter: both halves of the
    # range get hits (probability of failure ~2^-200)
    caps = [p.ceiling(i) for i in range(200)]
    assert any(d < c / 2 for d, c in zip(clock.sleeps, caps))
    assert any(d > c / 2 for d, c in zip(clock.sleeps, caps))


def test_no_jitter_gives_exact_ceilings():
    p = BackoffPolicy(delay=100, cap=500, factor=2.0, jitter=False)
    bo = p.backoff()
    assert [bo.next_delay() for _ in range(4)] == \
        [100.0, 200.0, 400.0, 500.0]


def test_reset_on_success_restarts_the_schedule():
    p = BackoffPolicy(delay=100, cap=10000, factor=2.0, jitter=False)
    bo = p.backoff()
    for _ in range(5):
        bo.next_delay()
    assert bo.attempt == 5
    assert bo.peek_ceiling() == 3200.0
    bo.reset()                         # the guarded operation succeeded
    assert bo.attempt == 0
    assert bo.next_delay() == 100.0    # back to the base delay


def test_seeded_backoff_is_deterministic():
    p = BackoffPolicy(delay=50, cap=2000)
    a = [p.backoff(seed=42).next_delay() for _ in range(1)]
    seq1 = p.backoff(seed=42)
    seq2 = p.backoff(seed=42)
    assert [seq1.next_delay() for _ in range(32)] == \
        [seq2.next_delay() for _ in range(32)]
    assert a[0] == p.backoff(seed=42).next_delay()
    # ...and a different seed gives a different schedule
    seq3 = p.backoff(seed=43)
    seq1.reset()
    assert [seq1.next_delay() for _ in range(32)] != \
        [seq3.next_delay() for _ in range(32)]


def test_recovery_policy_alias_still_constructs():
    """The reference-era RecoveryPolicy(timeout, retries, delay)
    constructor calls (and the pool defaults) keep working."""
    from zkstream_tpu_torch.io.pool import (
        DEFAULT_CONNECT_POLICY,
        DEFAULT_POLICY,
        RecoveryPolicy,
    )

    p = RecoveryPolicy(timeout=300, retries=2, delay=50)
    assert isinstance(p, BackoffPolicy)
    assert (p.timeout, p.retries, p.delay) == (300, 2, 50)
    assert p.jitter                       # upgraded default
    assert DEFAULT_CONNECT_POLICY.retries == 3
    assert DEFAULT_POLICY.cap >= DEFAULT_POLICY.delay


def test_simulated_dial_loop_total_wait_is_bounded():
    """A retry loop sleeping on the policy is bounded by sum(ceilings)
    — proven on the fake clock, no real sleeping."""
    p = BackoffPolicy(delay=100, cap=800, factor=2.0)
    bo = Backoff(p, seed=3)
    clock = FakeClock()
    attempts = 12
    for _ in range(attempts):
        clock.sleep(bo.next_delay())
    assert clock.now <= sum(p.ceiling(i) for i in range(attempts))
