"""Kernel K1 against its plain version on a CUDA card (no JAX here, so
the file also runs where only the port is installed:
``python -m pytest --noconftest tests/test_torch_cuda.py``).  Every
test is marked ``cuda`` and skips without a card; the decision is made
in a fixture."""

import numpy as np
import pytest
import torch

from zkstream_tpu_torch import corpus
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


_INPUTS = {
    'adversarial': lambda: corpus.adversarial(0),
    'adversarial_odd': lambda: corpus.adversarial(1, B=17, L=256),
    'random_bytes': _random_bytes,
    'corpus': _corpus_small,
}


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
