"""The chunk walk's tiled design against the JAX package's ``_walk``.

The port's chunk walk (ops/seq_walk.py) runs in three steps on a card:
a tile exit map built before the ring, a hop chain once the entry is
known, and a per-tile mark.  Their plain versions composed
(``tiled_walk_plain``) must equal ``zkstream_tpu.parallel.seqscan._walk``
on the same chunk, tolerance 0 on the exit cursor, the mask and ``bad``,
at tiles small enough (8, 16 and 64 bytes) that frames span tiles.  The
exit map itself (``tile_exits_plain``) must equal the plain serial walk
started at every offset and stopped at its tile's stop.  Inputs are made
from numpy seeds.
"""

import struct

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from zkstream_tpu.parallel.seqscan import _walk  # noqa: E402
from zkstream_tpu_torch import parallel as TP  # noqa: E402
from zkstream_tpu_torch.ops import seq_walk as SW  # noqa: E402

TILES = (8, 16, 64)
_WALK = jax.jit(_walk)                   # one compile per chunk width


def _stream(rng, count: int, max_body: int) -> tuple[bytes, list]:
    """``count`` frames (a 4-byte prefix and a random body of up to
    ``max_body`` bytes) and their starts."""
    out, starts = bytearray(), []
    for _ in range(count):
        body = int(rng.randint(0, max_body + 1))
        starts.append(len(out))
        out += struct.pack('>i', body)
        out += rng.randint(0, 256, body).astype(np.uint8).tobytes()
    return bytes(out), starts


def _chunk(s: bytes, base: int, C: int) -> np.ndarray:
    """Chunk ``[base, base + C)`` of ``s`` and its 4-byte halo, zero past
    the end of ``s``."""
    ext = np.zeros(C + 4, np.uint8)
    part = np.frombuffer(s[base:base + C + 4], np.uint8)
    ext[:len(part)] = part
    return ext


def _both(ext: np.ndarray, base: int, chunk_end: int, n: int, entry: int,
          tile: int):
    """``_walk`` and the tiled plain walk on one chunk, held equal; also
    the plain serial walk.  Returns ``(exit, mask, bad)``."""
    q, mask, bad = _WALK(jnp.asarray(ext), jnp.int32(base),
                         jnp.int32(chunk_end), jnp.int32(n),
                         jnp.int32(entry))
    t = torch.from_numpy(ext)
    got = SW.tiled_walk_plain(t, base, chunk_end, n, entry, tile)
    args = (base, chunk_end, n, entry, tile)
    assert (got[0], got[2]) == (int(q), bool(bad)), args
    np.testing.assert_array_equal(np.asarray(mask), got[1].numpy(),
                                  err_msg=str(args))
    serial = SW.walk_plain(t, base, chunk_end, n, entry)
    assert (serial[0], serial[2]) == (got[0], got[2])
    assert torch.equal(serial[1], got[1])
    return got


def _entries(rng, base: int, C: int, n: int, starts: list) -> list:
    """Entry cursors for a chunk: the true one (the first frame start at
    or past ``min(base, n)``), the chunk's first byte, one inside the
    chunk, one before it, one past its end and ``SATURATED``."""
    true = next((s for s in starts if s >= min(base, n)), n)
    return [true, base, base + int(rng.randint(0, C)),
            int(rng.randint(0, base + 1)), base + C + int(rng.randint(0, 9)),
            SW.SATURATED]


def _case_straddle(rng, tile):
    """A prefix straddling a tile boundary: a frame starts two bytes
    before the boundary, so its length reads into the next tile."""
    body = 2 * tile - 2 - 4
    s = struct.pack('>i', body) + b'\x01' * body + struct.pack('>i', 3) \
        + b'abc' + struct.pack('>i', 0)
    assert (4 + body) % tile == tile - 2
    C = 3 * tile
    yield _chunk(s, 0, C), 0, min(C, len(s)), len(s), 0


def _case_ragged(rng, tile):
    """A last tile shorter than the others."""
    s, starts = _stream(rng, 40, 3 * tile)
    C = 2 * tile + tile // 2 + 3
    for base in (0, starts[3], len(s) // 2):
        n = len(s)
        for e in _entries(rng, base, C, n, starts):
            yield _chunk(s, base, C), base, min(base + C, n), n, e


def _case_end_inside(rng, tile):
    """``chunk_end`` inside the chunk: the stream ends there."""
    s, starts = _stream(rng, 12, 2 * tile)
    C = 6 * tile
    base = starts[-2]
    for n in (len(s), base + C // 3, base + 5):
        assert n < base + C
        yield _chunk(s[:n], base, C), base, min(base + C, n), n, \
            next(x for x in starts if x >= base)


def _case_end_before(rng, tile):
    """``chunk_end`` before the chunk: the stream ended in an earlier
    chunk."""
    s, starts = _stream(rng, 10, tile)
    C = 2 * tile
    base = len(s) + tile
    for e in (starts[-1], len(s) - 2, len(s), SW.SATURATED):
        yield _chunk(s, base, C), base, min(base + C, len(s)), len(s), e


def _case_entries(rng, tile):
    """Entries before the chunk (a zero first byte: a run of empty
    frames up to it), past ``chunk_end`` and saturated."""
    s, starts = _stream(rng, 30, 2 * tile)
    C = 3 * tile
    for base in (starts[5], starts[5] + 1):
        ext = _chunk(s, base, C)
        for e in _entries(rng, base, C, len(s), starts):
            yield ext, base, min(base + C, len(s)), len(s), e
        zero = ext.copy()
        zero[0] = 0
        for e in (0, 1, base - 5, base - 4, base - 3, base - 1):
            if e >= 0:
                yield zero, base, min(base + C, len(s)), len(s), e


def _case_bad_middle(rng, tile):
    """A bad length prefix in a middle tile."""
    s, starts = _stream(rng, 24, tile)
    k = next(i for i, x in enumerate(starts) if x >= 2 * tile)
    cut = starts[k]
    for prefix in (-7, (16 << 20) + 1):
        t = s[:cut] + struct.pack('>i', prefix) + s[cut + 4:]
        C = max(4 * tile, cut + tile)
        yield _chunk(t, 0, C), 0, min(C, len(t)), len(t), 0


def _case_truncated(rng, tile):
    """A frame longer than the rest of the stream."""
    s, starts = _stream(rng, 16, tile)
    t = s + struct.pack('>i', 3 * tile) + b'\x00' * tile
    C = len(t) + 3
    yield _chunk(t, 0, C), 0, min(C, len(t)), len(t), 0
    base = starts[4]
    yield _chunk(t, base, C), base, min(base + C, len(t)), len(t), base


def _case_missing_prefix(rng, tile):
    """A stream that ends with fewer than four bytes after its last
    frame."""
    s, starts = _stream(rng, 16, tile)
    for tail in (b'', b'\x00', b'\x00\x01\x02'):
        t = s + tail
        C = 2 * tile + 5
        base = max(0, len(t) - C + 2)
        yield _chunk(t, base, C), base, min(base + C, len(t)), len(t), \
            next((x for x in starts if x >= base), len(s))


def _case_small_chunk(rng, tile):
    """A chunk shorter than a tile."""
    s, starts = _stream(rng, 10, 12)
    for C in (1, 5, tile - 1):
        if C >= tile:
            continue
        for base in (0, starts[2], starts[2] + 1):
            for e in _entries(rng, base, C, len(s), starts):
                yield _chunk(s, base, C), base, min(base + C, len(s)), \
                    len(s), e


CASES = {
    'straddle': _case_straddle,
    'ragged_last_tile': _case_ragged,
    'chunk_end_inside': _case_end_inside,
    'chunk_end_before': _case_end_before,
    'entries': _case_entries,
    'bad_middle_tile': _case_bad_middle,
    'truncated': _case_truncated,
    'missing_final_prefix': _case_missing_prefix,
    'chunk_shorter_than_tile': _case_small_chunk,
}


@pytest.mark.parametrize('tile', TILES)
@pytest.mark.parametrize('case', sorted(CASES))
def test_tiled_walk_matches_walk(case, tile):
    """Each named case, at each small tile: the tiled plain walk ==
    ``_walk`` (and == the serial plain walk), tolerance 0."""
    rng = np.random.RandomState(sorted(CASES).index(case) * 101 + tile)
    seen = []
    for ext, base, end, n, entry in CASES[case](rng, tile):
        seen.append(_both(ext, base, end, n, entry, tile))
    assert seen
    if case == 'bad_middle_tile':
        assert all(b for _, _, b in seen)
    if case == 'truncated':
        assert all(q == SW.SATURATED and not b for q, _, b in seen)
    if case == 'straddle':
        assert seen[0][1].nonzero().flatten().tolist() == [
            0, 2 * tile - 2, 2 * tile + 5]


@pytest.mark.parametrize('tile', TILES)
@pytest.mark.parametrize('seed', range(3))
def test_tiled_walk_matches_walk_on_random_chunks(seed, tile):
    """Random chunks, half of them frames of a stream (bodies up to three
    tiles, so frames span tiles) and half sparse junk with bad bytes, at
    random bases, stream ends and entries."""
    rng = np.random.RandomState(seed * 7 + tile)
    for _ in range(40):
        C = int(rng.choice([5, 40, 100, 200]))
        if rng.rand() < 0.5:
            s, starts = _stream(rng, int(rng.randint(1, 40)), 3 * tile)
            base = int(rng.choice([0, starts[rng.randint(len(starts))],
                                   rng.randint(0, len(s) + 8)]))
            n = int(rng.choice([len(s), rng.randint(0, len(s) + 1)]))
            ext = _chunk(s, base, C)
        else:
            ext = np.where(rng.rand(C + 4) < 0.3,
                           rng.randint(0, 256, C + 4), 0).astype(np.uint8)
            if rng.rand() < 0.3:
                ext[rng.randint(C)] = rng.choice([0x80, 0xff])
            base, n, starts = int(rng.randint(0, 100)), \
                int(rng.randint(0, 300)), []
        for e in _entries(rng, base, C, n, starts):
            _both(ext, base, min(base + C, n), n, e, tile)


@pytest.mark.parametrize('tile', TILES)
@pytest.mark.parametrize('seed', range(2))
def test_tile_exits_plain_matches_serial_walk_from_every_offset(seed, tile):
    """Each offset's exit == the serial plain walk from that offset,
    stopped at its tile's stop: its exit cursor, ``EXIT_BAD`` when it
    went bad, ``EXIT_STOPPED`` when it met a truncated frame."""
    rng = np.random.RandomState(1000 + seed * 7 + tile)
    for trial in range(6):
        s, starts = _stream(rng, 20, 2 * tile)
        if trial % 3 == 1:
            s = s[:len(s) - int(rng.randint(1, 8))]         # cut short
        elif trial % 3 == 2:
            k = int(rng.randint(len(starts)))
            s = s[:starts[k]] + struct.pack('>i', -3) + s[starts[k] + 4:]
        C = int(rng.choice([tile - 3, 3 * tile + 5, 7 * tile]))
        if C < 1:
            C = 1
        base = int(rng.choice([0, starts[1], len(s) // 3]))
        n = len(s)
        ext = torch.from_numpy(_chunk(s, base, C))
        end = min(base + C, n)
        exits = SW.tile_exits_plain(ext, base, end, n, tile)
        assert exits.dtype == torch.int32 and exits.shape == (C,)
        want = []
        for i in range(C):
            stop = min(base + (i // tile + 1) * tile, end)
            q, _mask, bad = SW.walk_plain(ext, base, stop, n, base + i)
            want.append(SW.EXIT_BAD if bad else
                        SW.EXIT_STOPPED if q == SW.SATURATED else q)
        assert exits.tolist() == want


def test_prepare_on_the_cpu_records_the_chunk_and_builds_no_map():
    """``seq_walk_prepare`` on a CPU state records the chunk, counts no
    launch and leaves ``exits`` as it was: the walk on the CPU reads no
    map, and still equals the plain walk."""
    s, _ = _stream(np.random.RandomState(5), 20, 40)
    ext = torch.from_numpy(_chunk(s, 0, 200))
    st = SW.new_state(200, 'cpu', tile=16)
    assert st.tile_entry.shape == (200 // 16 + 1 + 1,)
    st.exits.fill_(7)
    before = SW.prepare_launches
    SW.seq_walk_prepare(ext, 0, len(s), st)
    assert SW.prepare_launches == before
    assert bool((st.exits == 7).all())
    assert st.prepared == (ext.data_ptr(), 0)
    SW.seq_walk(ext, 0, len(s), torch.zeros((), dtype=torch.int32), st)
    q, mask, bad = SW.walk_plain(ext, 0, min(200, len(s)), len(s), 0)
    assert (int(st.exit), bool(st.bad)) == (q, bad)
    assert torch.equal(st.mask, mask)
    for base, n in ((2**31 - 204, len(s)), (-1, len(s)), (0, -1),
                    (0, 2**31)):
        with pytest.raises(ValueError):   # cursors past int32
            SW.seq_walk_prepare(ext, base, n, st)
    with pytest.raises(ValueError):       # n on the CPU: an int32 tensor
        SW.seq_walk_prepare(ext, 0, torch.tensor(len(s)), st)
    for bad in (4, 12, 1 << 17):
        with pytest.raises(ValueError):
            SW.new_state(200, 'cpu', tile=bad)


@pytest.mark.parametrize('sp', [1, 4])
def test_seq_scan_prepares_every_chunk_before_the_ring(monkeypatch, sp):
    """The sp scan prepares each chunk once, all before the first walk,
    each for its own chunk."""
    calls, maps = [], []
    prep, walk = SW.seq_walk_prepare, SW.seq_walk

    def counted_prepare(ext, base, n, state):
        calls.append('prepare')
        prep(ext, base, n, state)
        maps.append(state.prepared == (ext.data_ptr(), base))

    def counted_walk(*a):
        calls.append('walk')
        walk(*a)
    monkeypatch.setattr(SW, 'seq_walk_prepare', counted_prepare)
    monkeypatch.setattr(SW, 'seq_walk', counted_walk)
    s, starts = _stream(np.random.RandomState(sp), 30, 50)
    N = -(-(len(s) + 8) // (4 * sp)) * 4 * sp
    buf = torch.zeros(N, dtype=torch.uint8)
    buf[:len(s)] = torch.frombuffer(bytearray(s), dtype=torch.uint8)
    mesh = TP.make_mesh(dp=1, sp=sp, devices=['cpu'] * sp)
    mask, total, bad = TP.seq_parallel_frame_scan(mesh)(buf, len(s))
    assert calls == ['prepare'] * sp + ['walk'] * (1 + max(sp - 1, 1) * sp)
    assert maps == [True] * sp
    assert mask.nonzero().flatten().tolist() == starts
    assert int(total) == len(starts) and not bool(bad)


def test_bounds_count_the_prefixes_and_the_stream():
    """The walk's bound reads 4 bytes a frame; this design's floor reads
    the chunk and its halo; the map's reads the chunk and writes 4
    bytes an offset; every one writes the mask once."""
    assert SW.bound_bytes(1000, 10) == 40 + 4 + 1000 + 9
    assert SW.stream_bound_bytes(1000) == 1004 + 4 + 1000 + 9
    assert SW.prepare_bound_bytes(1000) == 1004 + 4000
