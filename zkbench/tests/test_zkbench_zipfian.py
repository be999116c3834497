"""YCSB's key choice as the benchmark copies it (traffic/zipfian.py)."""

import numpy as np

from zkbench.traffic import ycsb_ops
from zkbench.traffic.zipfian import (
    ZETAN,
    ScrambledZipfian,
    fnvhash64,
    fnvhash64_array,
    key_name,
    keys_array,
)

CONFIG = {'recordcount': 1000, 'value_bytes': 1000, 'table': '/usertable'}
MIX = {'readproportion': 0.95, 'updateproportion': 0.05,
       'requestdistribution': 'zipfian', 'zipfian_constant': 0.99}


def _fnv1a64(data: bytes) -> int:
    """FNV-1a over bytes, written from the published algorithm."""
    h = 0xCBF29CE484222325
    for b in data:
        h = ((h ^ b) * 0x100000001B3) % (1 << 64)
    return h


def test_fnvhash64_is_fnv1a_of_the_long_then_abs():
    for v in (0, 1, 2, 999, 123456789, 10**10, 2**40 + 7):
        h = _fnv1a64(v.to_bytes(8, 'little'))
        signed = h - (1 << 64) if h >> 63 else h
        assert fnvhash64(v) == abs(signed)


def test_first_ycsb_key():
    # the first key of every YCSB load with hashed inserts
    assert key_name(0) == 'user6284781860667377211'


def test_array_versions_match_the_scalar_ones():
    z = ScrambledZipfian(1000)
    u = np.random.default_rng(7).random(20000)
    assert keys_array(z, u).tolist() == [z.key(x) for x in u]
    vals = np.arange(0, 5000, 7, dtype=np.int64)
    assert fnvhash64_array(vals).tolist() == [fnvhash64(int(v)) for v in vals]


def test_same_seed_same_keys_and_ops():
    a = ycsb_ops.Stream(2**31 + 5, 3, MIX, CONFIG).take(300)
    b = ycsb_ops.Stream(2**31 + 5, 3, MIX, CONFIG).take(300)
    c = ycsb_ops.Stream(2**31 + 6, 3, MIX, CONFIG).take(300)
    assert a == b
    assert a != c


def test_top_key_share_at_099_over_1000_keys():
    # rank 0 has 1/zetan of the draws; other ranks hash onto its key
    # about one time in 1,000
    z = ScrambledZipfian(1000)
    u = np.random.default_rng(11).random(400_000)
    counts = np.bincount(keys_array(z, u), minlength=1000)
    top = counts.argmax()
    assert top == fnvhash64(0) % 1000
    share = counts[top] / len(u)
    assert 1 / ZETAN < share < 1 / ZETAN + 0.004


def test_update_share_and_value_width():
    ops = ycsb_ops.Stream(99, 0, MIX, CONFIG).take(20000)
    updates = [o for o in ops if o[0] == ycsb_ops.UPDATE]
    assert abs(len(updates) / len(ops) - 0.05) < 0.006
    assert all(len(v) == 1000 for _k, _r, v in updates)
    assert all(0 <= r < 1000 for _k, r, _v in ops)
