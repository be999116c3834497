"""Retry backoff: capped exponential delay with full jitter.

The reference's cueball recovery objects carry fixed ``{timeout,
retries, delay}`` numbers (reference: lib/client.js:96-107).  Fixed
delays are exactly wrong at fleet scale: when an ensemble member dies
under heavy traffic, every client that was attached to it redials on
the same fixed cadence — a correlated reconnect storm that lands on the
survivors in synchronized waves.  This module upgrades the policy to
capped exponential backoff with *full jitter* (each delay drawn
uniformly from ``[0, min(cap, delay * factor**attempt)]``), which is
the standard storm-decorrelation scheme, while keeping the reference's
field names so existing callers (and tests) construct policies
unchanged.

Two classes, deliberately split:

- :class:`BackoffPolicy` — the immutable description (dataclass).  The
  old ``RecoveryPolicy`` name is kept as an alias in ``io/pool.py``.
- :class:`Backoff` — one retry sequence's mutable state (attempt
  counter + RNG).  ``next_delay()`` advances it, ``reset()`` is called
  on success.  It never sleeps itself: callers own their sleeps, which
  is what makes the policy unit-testable against a fake clock with no
  real delays (tests/test_torch_backoff.py).

Seeding: a ``Backoff`` built with a seed is fully deterministic — the
chaos harness (io/faults.py) relies on this to make fault campaigns
reproducible from a single integer.
"""

from __future__ import annotations

import dataclasses
import random


@dataclasses.dataclass
class BackoffPolicy:
    """Connect/retry policy (reference: lib/client.js:96-107, plus the
    cap/factor/jitter upgrade).

    ``timeout`` is the per-attempt budget in ms; ``retries`` the number
    of attempts under the *initial* policy before a pool reports
    ``failed``; ``delay`` the base delay (the attempt-0 ceiling) in ms.
    ``cap`` bounds the exponential growth; ``jitter=False`` restores
    the reference's fixed-delay behavior (useful for tests that assert
    exact timing)."""

    timeout: int = 5000
    retries: int = 3
    delay: int = 1000
    cap: int = 30000
    factor: float = 2.0
    jitter: bool = True

    def ceiling(self, attempt: int) -> float:
        """The delay ceiling for ``attempt`` (0-based), in ms."""
        if attempt < 0:
            raise ValueError('attempt must be >= 0')
        # Cap the exponent too: delay * factor**attempt overflows to
        # inf for large attempt counts long after the cap has won.
        ceil = float(self.delay)
        for _ in range(attempt):
            ceil *= self.factor
            if ceil >= self.cap:
                return float(self.cap)
        return min(ceil, float(self.cap))

    def backoff(self, seed: int | None = None) -> 'Backoff':
        """A fresh retry sequence under this policy."""
        return Backoff(self, seed=seed)


class Backoff:
    """One retry sequence: attempt counter + jitter RNG.

    ``next_delay()`` returns the next delay in **ms** and advances the
    attempt counter; ``reset()`` rewinds to attempt 0 (call it when the
    guarded operation succeeds).  With ``policy.jitter`` the delay is
    drawn uniformly from ``[0, ceiling(attempt)]`` (full jitter);
    without, it is exactly the ceiling (the legacy fixed schedule when
    ``factor`` is 1)."""

    def __init__(self, policy: BackoffPolicy, seed: int | None = None):
        self.policy = policy
        self.attempt = 0
        #: The jitter's generator, made at the first draw: most
        #: schedules never draw, and it would be one more object for
        #: the collector to walk for each of them.
        self._seed = seed
        self._rng: random.Random | None = None

    def next_delay(self) -> float:
        ceil = self.policy.ceiling(self.attempt)
        self.attempt += 1
        if not self.policy.jitter:
            return ceil
        if self._rng is None:
            self._rng = random.Random(self._seed)
        return self._rng.uniform(0.0, ceil)

    def peek_ceiling(self) -> float:
        """The ceiling the *next* ``next_delay()`` will draw under."""
        return self.policy.ceiling(self.attempt)

    def reset(self) -> None:
        self.attempt = 0
