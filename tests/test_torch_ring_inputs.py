"""The port's tick decode and full decode on ``corpus.ring_fleet`` — rows
that put kernel K2's shared-memory ring at its edges (fields straddling
stage boundaries, a frame longer than the ring, a bad prefix after a
long frame, jute lengths -1/0/255/256/257, rows at every 16-byte
alignment, ``lens > L``, ``lens < 0``, ``lens = 0``) — against
zkstream_tpu's, on the CPU, where the port runs its plain versions.
Every plane is an integer or bool plane: tolerance 0.  The unpacked
``(WireStats, GetDataBodies)`` are compared, not the raw
``dlen_raw``/``data_words``: at masked slots, and for ``lens < 0`` and
``lens > L``, the Pallas kernel reads zero padding where the jnp path
and the port clamp.  The kernels themselves are held to the plain
versions on these inputs by tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_replies import _same
from zkstream_tpu.ops import pipeline as JP
from zkstream_tpu_torch import corpus
from zkstream_tpu_torch.ops import full_scan as TK2
from zkstream_tpu_torch.ops import pipeline as TP

B, L = 96, 6004                     # L % 16 == 4: rows at every alignment


def _ring_batch(seed=0):
    cfg = TK2.launch_config(B, L, 64)
    return corpus.ring_fleet(seed, B, L, cfg['stage_bytes'], cfg['stages'])


def _port(buf, lens):
    return torch.from_numpy(buf), torch.from_numpy(lens)


def test_ring_fleet_covers_its_edges():
    buf, lens = _ring_batch()
    cfg = TK2.launch_config(B, L, 64)
    assert cfg['stages'] * cfg['stage_bytes'] < L - 512
    assert L % 16 and (lens > L).any() and (lens < 0).any()
    assert (lens == 0).sum() >= 2 and (lens == L).any()
    out = TK2.full_scan(*_port(buf, lens), 64, 256)
    sizes, dlen = out['sizes'].numpy(), out['dlen_raw'].numpy()
    hdr_ok = (out['starts'].numpy() >= 0) & (sizes >= 16)
    # a complete frame longer than the whole ring, and the bad rows
    assert (sizes > cfg['stages'] * cfg['stage_bytes']).any()
    assert out['bad'].numpy().sum() >= 2
    for d in (-1, 0, 255, 256, 257):
        assert (hdr_ok & (dlen == d)).any(), d
    # a jute length that overruns its frame
    assert (hdr_ok & (dlen > sizes)).any()


@pytest.mark.parametrize('max_frames', [1, 16, 64])
def test_tick_decode_matches_jax(max_frames):
    buf, lens = _ring_batch()
    want = JP.wire_pipeline_step(jnp.asarray(buf), jnp.asarray(lens),
                                 max_frames=max_frames)
    got = TP.wire_pipeline_step(*_port(buf, lens), max_frames=max_frames)
    _same(want, got, 'stats')


@pytest.mark.parametrize('max_frames', [1, 16, 64])
@pytest.mark.parametrize('max_data', [16, 256])
def test_full_decode_matches_jnp(max_frames, max_data):
    buf, lens = _ring_batch(seed=max_frames)
    jb = jnp.asarray(buf)
    jst = JP.wire_pipeline_step(jb, jnp.asarray(lens), max_frames=max_frames)
    want = JP.getdata_bodies_jnp(jb, jst, max_data)
    st, gd = TP.wire_full_decode(*_port(buf, lens), max_frames=max_frames,
                                 max_data=max_data)
    _same(jst, st, 'stats')
    _same(want, gd, 'getdata')


def test_full_decode_matches_pallas_interpret():
    """The rows the Pallas kernel reads as the port does (no
    ``lens < 0``, no ``lens > L``), against the Pallas full decode in
    interpret mode."""
    from zkstream_tpu.ops.pipeline import wire_full_decode_pallas

    buf, lens = _ring_batch(seed=3)
    keep = (lens >= 0) & (lens <= L)
    buf, lens = np.ascontiguousarray(buf[keep]), lens[keep]
    want = wire_full_decode_pallas(jnp.asarray(buf), jnp.asarray(lens),
                                   max_frames=16, max_data=256,
                                   block_rows=8, interpret=True)
    got = TP.wire_full_decode(*_port(buf, lens), max_frames=16, max_data=256)
    _same(want[0], got[0], 'stats')
    _same(want[1], got[1], 'getdata')
