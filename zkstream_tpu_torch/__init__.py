"""zkstream_tpu_torch — the PyTorch/CUDA port of zkstream_tpu.

The port is a package of its own beside ``zkstream_tpu`` (the JAX/TPU
reference, which it never imports).  This slice carries the receive
tick decode and its runtime consumer:

    io/ingest.py         FleetIngest — batches a fleet's buffered bytes
      |                    into one [Bp, L] tick, routes packets on host
    ops/pipeline.py      wire_pipeline_step_auto — the tick decode
    ops/wire_scan.py     kernel K1 (csrc/wire_scan.cu, CUDA C++ for
      |                    sm_90a) and its plain torch version
    ops/frame_scan.py    frame cursor scan (plain torch)
    ops/headers.py       reply-header parse + per-stream reductions
    ops/bytesops.py      big-endian gathers, (hi, lo) u64 pairs
    protocol/            the scalar codec (own copy of the reference's)
    corpus.py            the deployed-shaped mixed-opcode corpus
    entry.py             entry(device='cuda') -> (fn, args)

Entry points take ``device`` and default to ``'cuda'``; with no card
they raise rather than run on the CPU.  Run ``python3 chip_smoke.py``
on an H100 to build K1 and drive the slice end to end.
"""

__version__ = '0.1.0'
