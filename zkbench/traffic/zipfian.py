"""YCSB's key choice, frozen here as the benchmark's yardstick.

A copy of what YCSB's core workload does (``site.ycsb.Utils.fnvhash64``,
``site.ycsb.generator.ZipfianGenerator``,
``site.ycsb.generator.ScrambledZipfianGenerator`` and
``CoreWorkload.buildKeyName`` with ``insertorder=hashed``), with Java's
64-bit signed arithmetic spelled out.  The uniform draws come from a
numpy ``Generator`` seeded by the caller, where YCSB takes
``ThreadLocalRandom``; the rest is YCSB's arithmetic.
"""

from __future__ import annotations

import math

_MASK = (1 << 64) - 1
FNV_OFFSET_BASIS_64 = 0xCBF29CE484222325
FNV_PRIME_64 = 1099511628211

#: ScrambledZipfianGenerator's constants: the zipfian it scrambles runs
#: over ITEM_COUNT items with the precomputed zeta at constant 0.99.
ZETAN = 26.46902820178302
USED_ZIPFIAN_CONSTANT = 0.99
ITEM_COUNT = 10_000_000_000


def _signed(x: int) -> int:
    x &= _MASK
    return x - (1 << 64) if x >> 63 else x


def fnvhash64(val: int) -> int:
    """``Utils.fnvhash64``: FNV-1a over the value's eight little-endian
    bytes, in Java longs, then ``Math.abs``."""
    h = FNV_OFFSET_BASIS_64
    v = val & _MASK
    for _ in range(8):
        h ^= v & 0xFF
        v >>= 8
        h = (h * FNV_PRIME_64) & _MASK
    h = _signed(h)
    # Math.abs(Long.MIN_VALUE) stays negative in Java
    return h if h >= 0 or h == -(1 << 63) else -h


def key_name(keynum: int) -> str:
    """``CoreWorkload.buildKeyName`` with hashed insert order."""
    return 'user%d' % (fnvhash64(keynum),)


def _zeta(n: int, theta: float) -> float:
    return sum(1.0 / math.pow(i + 1, theta) for i in range(n))


class ScrambledZipfian:
    """``ScrambledZipfianGenerator(0, items - 1)`` at constant 0.99: a
    zipfian over ``ITEM_COUNT`` ranks, each rank hashed onto the
    ``items`` keys."""

    def __init__(self, items: int, constant: float = USED_ZIPFIAN_CONSTANT):
        if constant != USED_ZIPFIAN_CONSTANT:
            raise ValueError('YCSB precomputes zeta only at constant 0.99')
        self.items = items
        self.n = ITEM_COUNT + 1            # ZipfianGenerator(0, ITEM_COUNT)
        self.theta = constant
        self.zetan = ZETAN
        self.alpha = 1.0 / (1.0 - self.theta)
        zeta2 = _zeta(2, self.theta)
        self.eta = ((1.0 - math.pow(2.0 / self.n, 1.0 - self.theta))
                    / (1.0 - zeta2 / self.zetan))
        self._half = 1.0 + math.pow(0.5, self.theta)

    def rank(self, u: float) -> int:
        """``ZipfianGenerator.nextValue`` for the uniform draw ``u``."""
        uz = u * self.zetan
        if uz < 1.0:
            return 0
        if uz < self._half:
            return 1
        return int(self.n * math.pow(self.eta * u - self.eta + 1,
                                     self.alpha))

    def key(self, u: float) -> int:
        """The record number for the uniform draw ``u``."""
        return fnvhash64(self.rank(u)) % self.items


def fnvhash64_array(vals):
    """:func:`fnvhash64` of every value of an int64 numpy array (the
    ``Long.MIN_VALUE`` corner, which stays negative in Java, maps to
    itself here too)."""
    import numpy as np

    h = np.full(vals.shape, FNV_OFFSET_BASIS_64, dtype=np.uint64)
    v = vals.astype(np.uint64)
    prime = np.uint64(FNV_PRIME_64)
    for _ in range(8):
        h ^= v & np.uint64(0xFF)
        v >>= np.uint64(8)
        h *= prime
    return np.abs(h.view(np.int64))


def keys_array(z: ScrambledZipfian, u):
    """:meth:`ScrambledZipfian.key` of every uniform draw in ``u``."""
    import numpy as np

    uz = u * z.zetan
    tail = (z.n * np.power(z.eta * u - z.eta + 1.0, z.alpha)).astype(
        np.int64)
    ranks = np.where(uz < 1.0, 0, np.where(uz < z._half, 1, tail))
    return fnvhash64_array(ranks) % z.items
