"""Kernels K1 and K2 against their plain versions on a CUDA card, and
the device-body tick on the card against the same tick on the CPU (no
JAX here, so the file also runs where only the port is installed:
``python -m pytest --noconftest tests/test_torch_cuda.py``).  Every
test is marked ``cuda`` and skips without a card; the decision is made
in a fixture.  Tolerance 0: every plane is an integer or bool plane."""

import numpy as np
import pytest
import torch

from zkstream_tpu_torch import corpus
from zkstream_tpu_torch.ops import full_scan as TK2
from zkstream_tpu_torch.ops import pipeline as TP
from zkstream_tpu_torch.ops import wire_scan as TW


def _corpus_small():
    buf, lens, _slots, _maps = corpus.fleet(B=257, seed=5, frames=32)
    return buf, lens


def _random_bytes():
    rng = np.random.RandomState(3)
    buf = rng.randint(0, 256, (64, 300)).astype(np.uint8)
    buf[:, :2] = 0                       # small first prefixes
    lens = rng.randint(-4, 340, (64,)).astype(np.int32)
    return buf, lens


def _ring(seed, B, L):
    """``corpus.ring_fleet`` at the stage size K2 takes for ``[B, L]``."""
    cfg = TK2.launch_config(B, L, 64)
    return corpus.ring_fleet(seed, B, L, cfg['stage_bytes'], cfg['stages'])


_INPUTS = {
    'adversarial': lambda: corpus.adversarial(0),
    'adversarial_odd': lambda: corpus.adversarial(1, B=17, L=256),
    'random_bytes': _random_bytes,
    'corpus': _corpus_small,
    # K2's ring edges: L % 16 == 4 and B not a multiple of 8 warps
    'ring': lambda: _ring(0, 96, 6004),
    'ring_odd': lambda: _ring(1, 61, 4700),
}

#: K2's inputs: K1's plus GET_DATA-layout fleets at both widths
_K2_INPUTS = dict(_INPUTS, **{
    'getdata16': lambda: corpus.getdata_fleet(0, 13, 512, 16),
    'getdata256': lambda: corpus.getdata_fleet(7, 64, 4096, 256),
})


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (K1 has no CPU mode)')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('name', sorted(_INPUTS))
@pytest.mark.parametrize('max_frames', [1, 16, 64])
def test_k1_matches_plain_on_card(cuda_device, name, max_frames):
    buf, lens = _INPUTS[name]()
    db, dl = TP.batch_to_device(buf, lens, cuda_device)
    before = TW.launches
    got = TW.wire_scan(db, dl, max_frames)
    torch.cuda.synchronize()
    assert TW.launches == before + 1
    want = TW.wire_scan_plain(db, dl, max_frames)
    for k in want:
        assert torch.equal(want[k], got[k]), k


@pytest.mark.cuda
def test_auto_step_takes_k1_on_card(cuda_device):
    buf, lens = corpus.adversarial(2)
    db, dl = TP.batch_to_device(buf, lens, cuda_device)
    before = TW.launches
    got = TP.wirestats_to_numpy(TP.wire_pipeline_step_auto(db, dl, 8))
    assert TW.launches == before + 1
    want = TP.wirestats_to_numpy(TP.wire_pipeline_step(db, dl, 8))
    for f in want:
        np.testing.assert_array_equal(want[f], got[f], err_msg=f)


@pytest.mark.cuda
@pytest.mark.parametrize('name', sorted(_K2_INPUTS))
@pytest.mark.parametrize('max_data', [16, 256])
def test_k2_matches_plain_on_card(cuda_device, name, max_data):
    buf, lens = _K2_INPUTS[name]()
    db, dl = TP.batch_to_device(buf, lens, cuda_device)
    before = TK2.launches, TW.launches
    got = TK2.full_scan(db, dl, 16, max_data)
    torch.cuda.synchronize()
    assert (TK2.launches, TW.launches) == (before[0] + 1, before[1])
    want = TK2.full_scan_plain(db, dl, 16, max_data)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(want[k], got[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['ring', 'ring_odd'])
@pytest.mark.parametrize('max_frames', [0, 1, 16, 64])
@pytest.mark.parametrize('max_data', [0, 20, 256])
def test_k2_ring_edges_on_card(cuda_device, name, max_frames, max_data):
    """K2 on the ring-edge rows at every walk depth and at data widths
    with no words, with a width not a multiple of 4 words (scalar
    stores), and the main path's."""
    buf, lens = _K2_INPUTS[name]()
    db, dl = TP.batch_to_device(buf, lens, cuda_device)
    before = TK2.launches
    got = TK2.full_scan(db, dl, max_frames, max_data)
    torch.cuda.synchronize()
    assert TK2.launches == before + 1
    want = TK2.full_scan_plain(db, dl, max_frames, max_data)
    for k in want:
        assert torch.equal(want[k], got[k]), k


#: Batches with more than twice as many rows as K2 keeps warps resident
#: (4,224 on an H100 at their geometries): odd B, every row kind repeated
_MANY_ROWS = {
    'adversarial': lambda: corpus.adversarial(4, B=9001, L=512),
    'ring': lambda: _ring(2, 9001, 6004),
}


@pytest.mark.cuda
@pytest.mark.parametrize('name', sorted(_MANY_ROWS))
@pytest.mark.parametrize('max_frames,max_data', [(16, 20), (64, 256)])
def test_k2_warps_walk_several_rows(cuda_device, name, max_frames,
                                    max_data):
    """Every warp of K2's persistent grid walks two rows or more, rows
    that stop early (bad prefixes, incomplete frames, lens < 0 or > L)
    followed by others: the ring's copies are drained, its mbarrier
    phases carried and the next row's stages started across rows."""
    buf, lens = _MANY_ROWS[name]()
    B, L = buf.shape
    cfg = TK2.launch_config(B, L, max_frames)
    cfg = TK2.launch_config(B, L, max_frames, TK2.resident_blocks(
        cuda_device, cfg['warps'], cfg['smem_bytes']))
    assert B > 2 * cfg['blocks'] * cfg['warps']
    db, dl = TP.batch_to_device(buf, lens, cuda_device)
    got = TK2.full_scan(db, dl, max_frames, max_data)
    want = TK2.full_scan_plain(db, dl, max_frames, max_data)
    for k in want:
        assert torch.equal(want[k], got[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['getdata256', 'corpus', 'adversarial',
                                  'ring'])
def test_full_decode_on_card_equals_cpu(cuda_device, name):
    buf, lens = _K2_INPUTS[name]()
    cpu = TP.wire_full_decode(*TP.batch_to_device(buf, lens, 'cpu'),
                              max_frames=32, max_data=256)
    card = TP.wire_full_decode(*TP.batch_to_device(buf, lens, cuda_device),
                               max_frames=32, max_data=256)

    def flat(t):
        for x in t:
            if hasattr(x, '_fields'):
                yield from flat(x)
            else:
                yield x
    for a, b in zip(flat(cpu), flat(card)):
        assert torch.equal(a, b.cpu())


@pytest.mark.cuda
def test_device_body_tick_launches_k2_only(cuda_device):
    """A CUDA device-body tick is one K2 launch (no K1) and packs what
    the same tick packs on the CPU."""
    from zkstream_tpu_torch.io.ingest import FleetIngest

    buf, _lens, _slots, _maps = corpus.fleet(B=12, seed=2, frames=16)
    rows = [bytearray(r.tobytes()) for r in buf]
    rows += [bytearray(r[:n].tobytes()) for r, n in
             zip(*corpus.getdata_fleet(4, 4, 1024, 64))]
    kw = dict(body_mode='device', max_frames=16, max_data=64,
              max_path=32, max_children=6, max_name=12)
    key = (16, 4096)
    card = FleetIngest(device='cuda', **kw)
    before = TK2.launches, TW.launches
    got = card._run_step(card._warm_bucket(key),
                         [(None, r) for r in rows])
    assert (TK2.launches, TW.launches) == (before[0] + 1, before[1])
    cpu = FleetIngest(device='cpu', **kw)
    want = cpu._run_step(cpu._warm_bucket(key), [(None, r) for r in rows])
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
