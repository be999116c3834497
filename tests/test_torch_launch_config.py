"""The launch geometry of kernels K1 and K2, computed in Python by
``wire_scan.launch_config`` and ``full_scan.launch_config`` and passed
to the C launchers, checked on the CPU for the repo's shapes: the
bench corpus, every ingest bucket from 8 x 256 to 2048 x 16384, larger
rows, and edge shapes (no frames, odd B)."""

import pytest

from zkstream_tpu_torch import corpus
from zkstream_tpu_torch.ops import full_scan as TK2
from zkstream_tpu_torch.ops import wire_scan as TW

_CORPUS_L = corpus.slot_schedule(64)[1]
_SHAPES = ([(16384, _CORPUS_L, 64)]
           + [(1 << b, 1 << l, 64) for b in range(3, 12)
              for l in range(8, 15)]
           + [(2048, 1 << 16, 64), (64, 1 << 20, 256), (8, 256, 1024),
              (1001, 512, 64), (13, 300, 1), (5, 6004, 0), (1, 1, 16)])


@pytest.mark.parametrize('B,L,F', _SHAPES)
def test_k2_launch_config(B, L, F):
    c = TK2.launch_config(B, L, F)
    sb, S, wpb, hf = (c['stage_bytes'], c['stages'], c['warps'],
                      c['hdr_frames'])
    assert sb % 16 == 0 and sb == 1 << c['stage_shift']
    assert 64 <= sb <= TK2.MAX_STAGE_BYTES
    assert S & (S - 1) == 0 and 1 <= wpb <= TK2.WARPS
    # the header buffer holds every frame of a row, or a run of 64
    assert hf % 4 == 0 and (hf >= F or hf == TK2.MAX_HDR_FRAMES)
    bars = -(-wpb * S * 8 // 16) * 16
    assert c['smem_bytes'] == bars + wpb * S * sb + wpb * 7 * hf * 4
    assert c['smem_bytes'] <= TK2.SMEM_LIMIT
    # uncapped, every row gets a warp
    assert c['blocks'] * wpb >= B > (c['blocks'] - 1) * wpb


@pytest.mark.parametrize('B,L,F', _SHAPES)
def test_k1_launch_config(B, L, F):
    c = TW.launch_config(B)
    T = c['threads']
    assert T == TW.K1_THREADS == 64
    assert c['blocks'] * T >= B > (c['blocks'] - 1) * T


@pytest.mark.parametrize('resident', [1, 528, 10**6])
def test_k2_grid_is_capped_at_the_resident_blocks(resident):
    """With the card's resident blocks given, the grid is persistent:
    never more blocks than fit at once, never more than the rows need."""
    for B, L, F in _SHAPES:
        c = TK2.launch_config(B, L, F, resident)
        need = TK2.launch_config(B, L, F)['blocks']
        assert c['blocks'] == min(need, resident)


def test_k2_stages_at_the_bench_shape():
    """At the corpus and the ingest bucket a warp's ring is 4 KB in
    1 KB stages, 8 warps a block, 46.25 KiB of shared memory: four
    blocks (32 rows in flight) fit on an SM."""
    for B, L in ((16384, _CORPUS_L), (2048, 16384)):
        c = TK2.launch_config(B, L, 64)
        assert (c['stage_bytes'], c['stages'], c['warps']) == (1024, 4, 8)
        assert c['smem_bytes'] == 47360
        assert 4 * c['smem_bytes'] <= TK2.SMEM_LIMIT
