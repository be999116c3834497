"""The seeded op streams of the YCSB mixes, shared by the generator
that drives the port and the plain reference that judges it.

Session ``s`` of a run with seed ``seed`` draws its ops from its own
numpy ``Generator`` (PCG64 on ``SeedSequence([seed, s])``), 64 ops at a
time: the uniform draws that choose read or update (YCSB's operation
chooser, read first), the uniform draws that choose the record (YCSB's
scrambled zipfian), then one value a write (``value_bytes`` printable
bytes, as YCSB's ``RandomByteIterator``).  The same seed gives every
session the same ops in the same order however far a run gets, so the
reference regenerates op ``j`` of session ``s`` from nothing but the
seed.
"""

from __future__ import annotations

import numpy as np

from .zipfian import ScrambledZipfian, key_name, keys_array

#: Ops drawn at a time; part of the stream's definition.
CHUNK = 64
READ, UPDATE = 0, 1
#: Stream id of the records' preloaded values (sessions are 0..n-1).
PRELOAD_STREAM = 1 << 32


def seed64(seed: int) -> int:
    return seed % (1 << 64)


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64(
        np.random.SeedSequence([seed64(seed), stream])))


def printable(g: np.random.Generator, shape) -> np.ndarray:
    return g.integers(0x20, 0x7F, size=shape, dtype=np.uint8)


def record_paths(config: dict) -> list:
    """The znode of each record: ``<table>/user<fnvhash64(i)>``."""
    return ['%s/%s' % (config['table'], key_name(i))
            for i in range(config['recordcount'])]


def preload_values(seed: int, config: dict) -> list:
    """Each record's value as the load phase writes it."""
    vals = printable(rng(seed, PRELOAD_STREAM),
                     (config['recordcount'], config['value_bytes']))
    return [bytes(v) for v in vals]


class Stream:
    """Session ``session``'s ops, in order: :meth:`next` returns
    ``(kind, record, value or None)``."""

    def __init__(self, seed: int, session: int, mix: dict, config: dict):
        if (mix['requestdistribution'] != 'zipfian'
                or abs(mix['readproportion'] + mix['updateproportion']
                       - 1.0) > 1e-9):
            raise ValueError('a YCSB mix here is zipfian reads and '
                             'updates only: %r' % (mix,))
        self._g = rng(seed, session)
        self._read = float(mix['readproportion'])
        self._zipf = ScrambledZipfian(config['recordcount'],
                                      float(mix['zipfian_constant']))
        self._width = config['value_bytes']
        self._ops: list = []
        self._at = 0
        #: ops handed out so far
        self.n = 0

    def _refill(self) -> None:
        g = self._g
        kinds = np.where(g.random(CHUNK) < self._read, READ, UPDATE)
        keys = keys_array(self._zipf, g.random(CHUNK))
        vals = printable(g, (int((kinds == UPDATE).sum()), self._width))
        out, w = [], 0
        for k, r in zip(kinds.tolist(), keys.tolist()):
            if k == UPDATE:
                out.append((UPDATE, r, vals[w].tobytes()))
                w += 1
            else:
                out.append((READ, r, None))
        self._ops, self._at = out, 0

    def next(self) -> tuple:
        if self._at == len(self._ops):
            self._refill()
        op = self._ops[self._at]
        self._at += 1
        self.n += 1
        return op

    def take(self, n: int) -> list:
        """The next ``n`` ops."""
        return [self.next() for _ in range(n)]
