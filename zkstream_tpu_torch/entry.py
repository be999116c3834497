"""Single-device entry point of the port: the receive tick decode.

``entry()`` returns ``(fn, args)``: ``fn`` is
:func:`~zkstream_tpu_torch.ops.pipeline.wire_pipeline_step_auto` with
``max_frames=64`` (kernel K1 on a CUDA device), and ``args`` is an
example batch of framed reply streams already on the device.  The
multi-device dry run waits for the port's mesh plane.
"""

from __future__ import annotations

import functools
import struct

import numpy as np


def _example_batch(B=64, L=2048, seed=0):
    """Deterministic synthetic reply streams: B rows of framed reply
    packets (16-byte header + small body) padded to L bytes."""
    rng = np.random.RandomState(seed)
    buf = np.zeros((B, L), np.uint8)
    lens = np.zeros((B,), np.int32)
    for i in range(B):
        s = b''
        while len(s) < L - 64:
            xid = int(rng.randint(1, 1 << 20))
            zxid = int(rng.randint(1, 1 << 40))
            body = bytes(rng.randint(0, 256, rng.randint(0, 40),
                                     dtype=np.uint8))
            hdr = struct.pack('>iqi', xid, zxid, 0)
            s += struct.pack('>i', len(hdr) + len(body)) + hdr + body
        buf[i, :len(s)] = np.frombuffer(s, np.uint8)
        lens[i] = len(s)
    return buf, lens


def entry(device='cuda'):
    """Return ``(fn, args)``: the tick decode and an example batch on
    ``device`` (raises when ``'cuda'`` is asked for and absent)."""
    from .ops.pipeline import batch_to_device, wire_pipeline_step_auto

    buf, lens = _example_batch()
    args = batch_to_device(buf, lens, device)
    return functools.partial(wire_pipeline_step_auto, max_frames=64), args
