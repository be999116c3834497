"""Tensor wire-codec ops — the device data plane of the port.

- :mod:`bytesops` — gather-based big-endian field extraction, 64-bit
  fields as (hi, lo) int32 pairs;
- :mod:`frame_scan` — the lockstep frame cursor scan;
- :mod:`headers` — reply-header parse and per-stream reductions;
- :mod:`wire_scan` — kernel K1 (scan + header parse in one CUDA
  launch) and its plain version;
- :mod:`full_scan` — kernel K2 (K1's walk plus the GET_DATA body in
  one CUDA launch) and its plain version;
- :mod:`replies` — the reply-body parse (fixed layouts and lists);
- :mod:`pipeline` — the tick decode over a [B, L] batch, with or
  without the GET_DATA bodies.
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
    GetDataBodies,
    WireStats,
    batch_to_device,
    getdata_bodies,
    wire_full_decode,
    wire_pipeline_step,
    wire_pipeline_step_auto,
    wire_pipeline_step_kernel,
    wirestats_to_numpy,
)
from .replies import (  # noqa: F401
    ListBodies,
    ReplyBodies,
    StatPlanes,
    parse_list_bodies,
    parse_reply_bodies,
    parse_stats,
    stat_from_planes,
)
