"""The port's tick decode against zkstream_tpu's: the same numpy batch
through JAX ``wire_pipeline_step``, through the Pallas kernel in
interpret mode (``pallas_wire_scan(interpret=True)`` +
``_stats_from_scan``) and through the port's plain version and K1
wrapper (which serves a CPU tensor with the plain version).  Every
plane is an integer plane, so every field must be equal (tolerance 0).
K1 itself is held against the plain version on the card by
tests/test_torch_cuda.py."""

import random
import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zkstream_tpu.ops import frame_scan as JF
from zkstream_tpu.ops import headers as JH
from zkstream_tpu.ops import pipeline as JP
from zkstream_tpu.ops.pallas_scan import pallas_wire_scan
from zkstream_tpu_torch import corpus
from zkstream_tpu_torch.ops import frame_scan as TF
from zkstream_tpu_torch.ops import headers as TH
from zkstream_tpu_torch.ops import pipeline as TP
from zkstream_tpu_torch.ops import wire_scan as TW


def _random_fleet(seed, B=24, L=512):
    """Random reply streams in the test_ops.py style, with partial
    tails on about half the rows."""
    rng = random.Random(seed)
    buf = np.zeros((B, L), np.uint8)
    lens = np.zeros((B,), np.int32)
    for i in range(B):
        s = b''
        for _ in range(rng.randrange(0, 10)):
            xid = rng.choice([-2, -1, rng.randrange(1, 1000)])
            zxid = rng.randrange(0, 1 << 48) if xid >= 0 else -1
            hdr = struct.pack('>iqi', xid, zxid, rng.choice([0, 0, -101]))
            body = bytes(rng.randrange(256)
                         for _ in range(rng.randrange(0, 40)))
            s += struct.pack('>i', len(hdr) + len(body)) + hdr + body
        if rng.random() < 0.5:
            s += struct.pack('>i', 40) + b'\xab' * rng.randrange(0, 20)
        s = s[:L]
        buf[i, :len(s)] = np.frombuffer(s, np.uint8)
        lens[i] = len(s)
    return buf, lens


def _corpus_small():
    buf, lens, _slots, _maps = corpus.fleet(B=12, seed=3, frames=16)
    return buf, lens


_INPUTS = {
    'random0': lambda: _random_fleet(0),
    'random1': lambda: _random_fleet(1),
    'random2': lambda: _random_fleet(2, B=5, L=200),
    'adversarial': lambda: corpus.adversarial(0),
    'adversarial_odd': lambda: corpus.adversarial(1, B=17, L=256),
    'corpus': _corpus_small,
}


def _port(buf, lens):
    return TP.batch_to_device(buf, lens, 'cpu')


def _assert_same(want, got, fields=None):
    for f in fields or want._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(want, f)), np.asarray(getattr(got, f)),
            err_msg='field %s' % f)


@pytest.mark.parametrize('name', sorted(_INPUTS))
@pytest.mark.parametrize('max_frames', [8, 16])
def test_pipeline_matches_jax(name, max_frames):
    buf, lens = _INPUTS[name]()
    want = JP.wire_pipeline_step(jnp.asarray(buf), jnp.asarray(lens),
                                 max_frames=max_frames)
    tb, tl = _port(buf, lens)
    for step in (TP.wire_pipeline_step, TP.wire_pipeline_step_kernel,
                 TP.wire_pipeline_step_auto):
        got = TP.wirestats_to_numpy(step(tb, tl, max_frames=max_frames))
        for f in want._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(want, f)), got[f],
                err_msg='%s field %s' % (step.__name__, f))


@pytest.mark.parametrize('name', sorted(_INPUTS))
def test_pipeline_matches_pallas_interpret(name):
    """Against the TPU kernel run in interpret mode.  Rows with
    ``lens < 0`` or ``lens > L`` are left out: the Pallas kernel starts
    ``bad`` at 0 and reads its zero padding past ``L``, where the plain
    version (the port's spec) flags ``lens < 0`` and clamps reads."""
    buf, lens = _INPUTS[name]()
    keep = (lens >= 0) & (lens <= buf.shape[1])
    buf, lens = buf[keep], lens[keep]
    r = pallas_wire_scan(jnp.asarray(buf), jnp.asarray(lens),
                         max_frames=8, block_rows=8, interpret=True)
    want = JP._stats_from_scan(r)
    got = TP.wire_pipeline_step_kernel(*_port(buf, lens), max_frames=8)
    _assert_same(want, got)


@pytest.mark.parametrize('name', ['random0', 'adversarial', 'corpus'])
def test_scan_headers_stats_match_jax(name):
    buf, lens = _INPUTS[name]()
    F = 16
    jbuf, jlens = jnp.asarray(buf), jnp.asarray(lens)
    tb, tl = _port(buf, lens)
    want = JF.frame_cursor_scan(jbuf, jlens, F)
    got = TF.frame_cursor_scan(tb, tl, F)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    jh = JH.parse_reply_headers(jbuf, want[0], want[1])
    th = TH.parse_reply_headers(tb, got[0], got[1])
    for k in jh:
        np.testing.assert_array_equal(np.asarray(jh[k]), th[k].numpy(),
                                      err_msg=k)
    js, ts = JH.stream_stats(jh), TH.stream_stats(th)
    for k in js:
        np.testing.assert_array_equal(np.asarray(js[k]), ts[k].numpy(),
                                      err_msg=k)


def test_adversarial_rows_hit_their_cases():
    """The adversarial batch reaches the paths it is meant to."""
    buf, lens = corpus.adversarial(0)
    st = TP.wirestats_to_numpy(
        TP.wire_pipeline_step(*_port(buf, lens), max_frames=8))
    assert st['n_frames'][0] == 0 and not st['bad'][0]        # empty
    assert st['n_frames'][1] == 1 and st['resid'][1] == buf.shape[1]
    assert st['bad'][2]                                      # short
    assert st['bad'][3] and st['bad'][4] and st['bad'][5]    # prefixes
    assert not st['bad'][6] and st['n_frames'][6] == 1       # MAX_PACKET
    assert st['n_frames'][9] == 8                            # > F frames
    assert st['bad'][13]                                     # lens < 0


def test_wire_scan_checks_inputs():
    buf = torch.zeros((2, 8), dtype=torch.uint8)
    with pytest.raises(ValueError):
        TW.wire_scan(buf, torch.zeros((2,), dtype=torch.int64), 4)
    with pytest.raises(ValueError):
        TW.wire_scan(buf.to(torch.int32), torch.zeros((2,),
                     dtype=torch.int32), 4)
    with pytest.raises(ValueError):
        TW.wire_scan(buf, torch.zeros((3,), dtype=torch.int32), 4)


def test_bound_bytes_counts_reads_and_writes():
    # 10 frames found in 4 rows of 8 slots
    assert TW.bound_bytes(4, 8, 10) == 20 * 10 + 4 * 4 + 24 * 32 + 9 * 4


def test_corpus_matches_bench_fleet(monkeypatch):
    """The port's corpus is byte-equal to bench._fleet at the same B."""
    import bench

    monkeypatch.setattr(bench, 'B', 6)
    want_buf, want_lens, _streams, want_slots = bench._fleet()
    buf, lens, slots, maps = corpus.fleet(B=6, seed=42)
    np.testing.assert_array_equal(buf, want_buf)
    np.testing.assert_array_equal(lens, want_lens)
    assert slots == want_slots
    assert maps == bench._xid_maps([r.tobytes() for r in buf], slots)
