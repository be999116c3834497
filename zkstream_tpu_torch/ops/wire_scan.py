"""Kernel K1: fused frame scan + reply-header parse, one CUDA launch.

Replaces the TPU kernel ``zkstream_tpu/ops/pallas_scan.py::_kernel``
(launched by ``pallas_wire_scan``).  The CUDA C++ source is
``zkstream_tpu_torch/csrc/wire_scan.cu``; the same library holds kernel
K2 (ops/full_scan.py), which shares K1's frame step; this module builds
and loads it.

What bounds it on an H100: dependent device-memory round trips, not
bandwidth.  It must move only 20 bytes per frame found (the 4-byte
length prefix and the 16-byte reply header) plus 4 bytes of ``lens``
per row, and 24 bytes per frame slot (six int32 planes) plus 9 per row
written — :func:`bound_bytes` counts exactly that, about 14 us at the
bench shape.  But where a frame starts depends on the length of the one
before it, so a row of 64 frames is 64 round trips one after the other:
one row alone takes longer than the whole bound (``chip_smoke.py``
measures this latency floor), so no walk that touches device memory
once a frame comes near the bound.  With every row of a tick in flight
the round trips also queue behind one another's scattered sectors,
so a step should fetch no sector it does not use.

The design (:func:`launch_config` computes its geometry): one thread per
row with every row of a tick resident in one wave, so the rows' chains
overlap.  Each frame step issues all of its loads — the two or three
aligned 16-byte words covering ``[cur, cur+20)``, no sector more than
the head spans — before it uses any, one round trip a step, and cuts
the length and header words out of them with funnel shifts.  A thread
keeps eight frames' values in registers and writes each of the six
``[B, F]`` planes' eight as two 16-byte streaming stores: whole 32-byte
sectors, which device memory takes without merging partial ones.
(Staging a block's planes in shared memory to write them as runs of
frames took longer.)

The library is built with ``nvcc`` for ``sm_90a`` into ``build/`` at
the repository root on first use (:func:`load`) and bound with
``ctypes``.  :func:`wire_scan` runs the plain torch version for a
tensor on the CPU and the kernel for a tensor on a CUDA device; there
is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from .frame_scan import frame_cursor_scan
from .headers import parse_reply_headers

#: Where the TPU kernel this module replaces lives.
REPLACES = 'zkstream_tpu/ops/pallas_scan.py:99'

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / 'csrc' / 'wire_scan.cu'
BUILD_DIR = _PKG.parent / 'build'

#: Launches of the CUDA kernel since the last reset (the plain version
#: never counts).
launches = 0

_lib = None
_build_log = ''
_lock = threading.Lock()

_PLANES = ('starts', 'sizes', 'xid', 'zxid_hi', 'zxid_lo', 'err')

#: Rows (threads) per K1 block, the kernel's ``__launch_bounds__``.
K1_THREADS = 64
#: The kernels' row offsets are 32-bit: rows of at most INT32_MAX bytes.
_MAX_ROW = 2**31 - 1


def _nvcc() -> str:
    for cand in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if cand and os.path.exists(os.path.join(cand, 'bin', 'nvcc')):
            return os.path.join(cand, 'bin', 'nvcc')
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found: %s cannot be built'
                           % (SOURCE.name,))
    return found


def build() -> tuple[Path, str]:
    """Compile ``csrc/wire_scan.cu`` (K1 and K2) for sm_90a into
    ``build/`` (once per source content) and return ``(library path,
    ptxas report)``."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / ('libwire_scan.%s.so' % tag)
    log = BUILD_DIR / ('libwire_scan.%s.log' % tag)
    if out.exists() and log.exists():
        return out, log.read_text()
    tmp = out.with_name(out.name + '.%d.tmp' % os.getpid())
    cmd = [_nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a',
           '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC',
           '-Xptxas', '-v', '-o', str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError('nvcc failed (%d):\n%s%s'
                           % (res.returncode, res.stdout, res.stderr))
    report = res.stdout + res.stderr
    log.write_text(report)
    os.replace(tmp, out)
    return out, report


def load():
    """Build (if needed) and bind the K1 launcher; idempotent."""
    global _lib, _build_log
    with _lock:
        if _lib is None:
            path, _build_log = build()
            lib = ctypes.CDLL(str(path))
            fn = lib.wire_scan_launch
            fn.argtypes = ([ctypes.c_void_p] * 2
                           + [ctypes.c_int, ctypes.c_longlong]
                           + [ctypes.c_int] * 3
                           + [ctypes.c_void_p] * 5)
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def build_report() -> str:
    """The ``nvcc -Xptxas -v`` output of the loaded library."""
    return _build_log


def wire_scan_plain(buf, lens, max_frames: int) -> dict:
    """The plain torch version: ``frame_cursor_scan`` +
    ``parse_reply_headers``, in K1's output layout."""
    starts, sizes, counts, bad, resid = frame_cursor_scan(
        buf, lens, max_frames)
    h = parse_reply_headers(buf, starts, sizes)
    return {'starts': starts, 'sizes': sizes, 'xid': h['xid'],
            'zxid_hi': h['zxid_hi'], 'zxid_lo': h['zxid_lo'],
            'err': h['err'], 'counts': counts, 'resid': resid,
            'bad': bad}


def _check(buf, lens, max_frames: int) -> None:
    if buf.dtype != torch.uint8 or buf.dim() != 2:
        raise ValueError('buf must be uint8 [B, L], got %s %s'
                         % (buf.dtype, tuple(buf.shape)))
    if lens.dtype != torch.int32 or lens.shape != (buf.shape[0],):
        raise ValueError('lens must be int32 [B], got %s %s'
                         % (lens.dtype, tuple(lens.shape)))
    if lens.device != buf.device:
        raise ValueError('buf and lens on different devices')
    if buf.shape[1] < 1:
        raise ValueError('buf needs at least one column')
    if max_frames < 0:
        raise ValueError('max_frames must be >= 0')


def launch_config(B: int) -> dict:
    """K1's launch geometry for a batch of ``B`` rows: ``threads`` rows a
    block and ``blocks`` to cover ``B``.  Each thread walks its row in
    registers; the kernel takes no shared memory."""
    return {'threads': K1_THREADS, 'blocks': -(-B // K1_THREADS)}


def wire_scan(buf, lens, max_frames: int) -> dict:
    """Frame scan + header parse of a ``uint8 [B, L]`` batch.

    Returns int32 ``[B, F]`` planes ``starts``, ``sizes``, ``xid``,
    ``zxid_hi``, ``zxid_lo``, ``err``; int32 ``[B]`` ``counts`` and
    ``resid``; bool ``[B]`` ``bad`` — field for field what
    :func:`wire_scan_plain` returns.  A CPU tensor runs the plain
    version; a CUDA tensor launches K1 on the current stream.
    """
    global launches
    _check(buf, lens, max_frames)
    dev = buf.device
    if dev.type == 'cpu':
        return wire_scan_plain(buf, lens, max_frames)
    if dev.type != 'cuda':
        raise ValueError('K1 runs on CUDA or CPU tensors, not %s' % (dev,))
    if not (buf.is_contiguous() and lens.is_contiguous()):
        raise ValueError('K1 needs contiguous buf and lens')
    if buf.shape[1] > _MAX_ROW:
        raise ValueError('K1 takes rows of at most %d bytes' % _MAX_ROW)
    lib = load()
    B, L = buf.shape
    cfg = launch_config(B)
    hdr = torch.empty((len(_PLANES), B, max_frames), dtype=torch.int32,
                      device=dev)
    out = dict(zip(_PLANES, hdr.unbind(0)))
    out['counts'] = torch.empty((B,), dtype=torch.int32, device=dev)
    out['resid'] = torch.empty((B,), dtype=torch.int32, device=dev)
    out['bad'] = torch.empty((B,), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.wire_scan_launch(
            buf.data_ptr(), lens.data_ptr(), B, L, max_frames,
            cfg['threads'], cfg['blocks'], hdr.data_ptr(),
            out['counts'].data_ptr(), out['resid'].data_ptr(),
            out['bad'].data_ptr(), stream)
    if rc != 0:
        raise RuntimeError('K1 launch failed: cudaError %d' % (rc,))
    launches += 1
    return out


def bound_bytes(B: int, max_frames: int, frames_found: int) -> int:
    """Bytes K1 must move for one call: 20 read per frame found plus 4
    of ``lens`` per row; 24 written per frame slot plus 9 per row."""
    return 20 * frames_found + 4 * B + 24 * B * max_frames + 9 * B
