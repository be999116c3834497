"""Tensor wire-codec ops — the device data plane of the port.

- :mod:`bytesops` — gather-based big-endian field extraction, 64-bit
  fields as (hi, lo) int32 pairs;
- :mod:`frame_scan` — the lockstep frame cursor scan, and the
  pointer-doubling scan of one long stream;
- :mod:`headers` — reply-header parse and per-stream reductions;
- :mod:`wire_scan` — kernel K1 (scan + header parse in one CUDA
  launch) and its plain version;
- :mod:`full_scan` — kernel K2 (K1's walk plus the GET_DATA body in
  one CUDA launch) and its plain version;
- :mod:`seq_walk` — the sequence-parallel scan's chunk walk (one CUDA
  thread) and its plain version;
- :mod:`replies` — the reply-body parse (fixed layouts and lists);
- :mod:`bodies` — frame bodies sliced into a padded tensor;
- :mod:`encode` — the inverse direction: field planes -> framed reply
  streams;
- :mod:`pipeline` — the tick decode over a [B, L] batch, with or
  without the GET_DATA bodies.
"""

from .bodies import slice_frame_bodies
from .bytesops import (
    be_i32_at,
    be_i64pair_at,
    u64pair_lt,
    u64pair_max,
    u64pair_reduce_max,
)
from .encode import build_reply_streams
from .frame_scan import (
    MAX_PACKET,
    frame_cursor_scan,
    frame_starts_pointer_doubling,
)
from .headers import parse_reply_headers, stream_stats
from .pipeline import (
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
from .replies import (
    ListBodies,
    ReplyBodies,
    StatPlanes,
    parse_list_bodies,
    parse_reply_bodies,
    parse_stats,
    slice_var_bytes,
    stat_from_planes,
)

__all__ = [
    'slice_frame_bodies',
    'be_i32_at',
    'be_i64pair_at',
    'u64pair_lt',
    'u64pair_max',
    'u64pair_reduce_max',
    'build_reply_streams',
    'MAX_PACKET',
    'frame_cursor_scan',
    'frame_starts_pointer_doubling',
    'parse_reply_headers',
    'stream_stats',
    'GetDataBodies',
    'WireStats',
    'batch_to_device',
    'getdata_bodies',
    'wire_full_decode',
    'wire_pipeline_step',
    'wire_pipeline_step_auto',
    'wire_pipeline_step_kernel',
    'wirestats_to_numpy',
    'ListBodies',
    'ReplyBodies',
    'StatPlanes',
    'parse_list_bodies',
    'parse_reply_bodies',
    'parse_stats',
    'slice_var_bytes',
    'stat_from_planes',
]
