"""zkstream_tpu_torch — the PyTorch/CUDA port of zkstream_tpu.

The port is a package of its own beside ``zkstream_tpu`` (the JAX/TPU
reference, which it never imports).  It carries the ZooKeeper client
stack, an in-process single-member server, and the receive tick decode
that a fleet of clients can share on the device:

    client.py            Client — public API facade, event surface
      |                    (``Client(ingest=FleetIngest())`` drains every
      |                    connection through the device tick)
    io/pool.py           ConnectionPool, read plane, resolver
    io/connection.py     ZKConnection — one TCP connection's lifecycle;
      |                    io/session.py ZKSession, io/watcher.py
      |                    ZKWatcher, io/cache.py CachePlane
    io/sendplane.py      tick-corked writes; io/transport.py the batched
      |                    syscall tiers (uring / mmsg / asyncio)
    server/              ZKServer (one in-memory or WAL-backed member):
      |                    store, watch table, persist, io/ingress.py
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
    protocol/            the scalar codec (own copy of the reference's),
      |                    with its C tiers when they are built
    utils/native.py      builds and loads the host codec tier: the frame
                           scanner (csrc/zkwire.cpp) and the C-extension
                           codec with its transport calls
                           (csrc/zkwire_ext.c), gcc into build/
    corpus.py            the deployed-shaped mixed-opcode corpus and
                           adversarial batches
    entry.py             entry(device='cuda') -> (fn, args)

Entry points take ``device`` and default to ``'cuda'``; with no card
they raise rather than run on the CPU.  Run ``python3 chip_smoke.py``
on an H100 to build the kernels and drive the port end to end.
"""

__version__ = '0.3.0'

from .client import Client  # noqa: F401
from .protocol.consts import CreateFlag, Perm  # noqa: F401
from .protocol.errors import (  # noqa: F401
    ZKDeadlineError,
    ZKError,
    ZKNotConnectedError,
    ZKPingTimeoutError,
    ZKProtocolError,
)
from .protocol.records import ACL, OPEN_ACL_UNSAFE, Id, Stat  # noqa: F401
from .utils.logging import Logger  # noqa: F401
from .utils.metrics import Collector, Histogram  # noqa: F401
from .utils.trace import TraceRing  # noqa: F401
