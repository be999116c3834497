"""Tensor wire-codec ops — the device data plane of the port.

- :mod:`bytesops` — gather-based big-endian field extraction, 64-bit
  fields as (hi, lo) int32 pairs;
- :mod:`frame_scan` — the lockstep frame cursor scan;
- :mod:`headers` — reply-header parse and per-stream reductions;
- :mod:`wire_scan` — kernel K1 (scan + header parse in one CUDA
  launch) and its plain version;
- :mod:`pipeline` — the tick decode over a [B, L] batch.
"""

from .bytesops import (  # noqa: F401
    be_i32_at,
    be_i64pair_at,
    u64pair_lt,
    u64pair_max,
    u64pair_reduce_max,
)
from .frame_scan import frame_cursor_scan  # noqa: F401
from .headers import parse_reply_headers, stream_stats  # noqa: F401
from .pipeline import (  # noqa: F401
    WireStats,
    batch_to_device,
    wire_pipeline_step,
    wire_pipeline_step_auto,
    wire_pipeline_step_kernel,
    wirestats_to_numpy,
)
