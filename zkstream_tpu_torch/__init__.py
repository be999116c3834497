"""zkstream_tpu_torch — the PyTorch/CUDA port of zkstream_tpu.

The port is a package of its own beside ``zkstream_tpu`` (the JAX/TPU
reference, which it never imports).  It carries the receive tick
decode, with and without the reply bodies, and its runtime consumer:

    io/ingest.py         FleetIngest — batches a fleet's buffered bytes
      |                    into one [Bp, L] tick, routes packets on host
    ops/pipeline.py      wire_pipeline_step_auto (body_mode='host') and
      |                    wire_full_decode (body_mode='device')
    ops/replies.py       reply-body parse: Stat, GET_DATA, CREATE,
      |                    NOTIFICATION, children and ACL lists
    ops/wire_scan.py     kernel K1 and its plain torch version
    ops/full_scan.py     kernel K2 (K1's walk + GET_DATA body words)
      |                    and its plain torch version; both kernels are
      |                    CUDA C++ for sm_90a in csrc/wire_scan.cu
    ops/frame_scan.py    frame cursor scan (plain torch)
    ops/headers.py       reply-header parse + per-stream reductions
    ops/bytesops.py      big-endian gathers, (hi, lo) u64 pairs
    protocol/            the scalar codec (own copy of the reference's)
    corpus.py            the deployed-shaped mixed-opcode corpus and
                           adversarial batches
    entry.py             entry(device='cuda') -> (fn, args)

Entry points take ``device`` and default to ``'cuda'``; with no card
they raise rather than run on the CPU.  Run ``python3 chip_smoke.py``
on an H100 to build the kernels and drive the port end to end.
"""

__version__ = '0.2.0'
