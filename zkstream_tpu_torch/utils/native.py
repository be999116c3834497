"""Loader for the port's host codec tier: the C-ABI frame scanner
(``csrc/zkwire.cpp``) and the CPython-extension codec
(``csrc/zkwire_ext.c``), and the builder of the C load generator
(``csrc/loadgen.c``).

This is the port's own copy of ``zkstream_tpu.utils.native`` for those
three artifacts.  All three build on first use with the ambient ``g++`` /
``gcc`` into ``build/`` at the repository root (the directory the CUDA
kernels build into, listed in ``.gitignore``).  Design constraints, in
order:

- **Never block the event loop.**  ``get_lib()`` / ``get_ext()`` only
  load an already-built artifact; when a build is needed it is kicked
  off on a daemon thread and they return None until it lands, so the
  connection path runs pure-Python in the meantime.  ``ensure_lib()`` /
  ``ensure_ext()`` build synchronously (tests, tools, ``chip_smoke.py``).
- **Stale artifacts can't poison the process.**  The artifact names
  embed the ABI version; an old build is a different filename that is
  never loaded.  A build writes a per-process tmp file and publishes it
  with ``os.replace``, so concurrent builds (test workers) never mix
  halves.
- **Graceful degradation.**  No compiler, failed build, failed load ->
  None, and callers keep the pure-Python implementations.

The extension is its own module, ``_zkwire_ext_torch``, set up from this
package's ``protocol.records`` and ``protocol.consts``: its packets
carry this package's ``Stat`` class even when the JAX package's
``_zkwire_ext`` is loaded in the same process.

``ZKSTREAM_NO_NATIVE=1`` forces the pure-Python path.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import sysconfig
import threading

log = logging.getLogger('zkstream_tpu_torch.native')

_ABI_VERSION = 1

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_failed = False
_build_thread: threading.Thread | None = None


def _pkg() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_dir() -> str:
    """``build/`` at the repository root."""
    return os.path.join(os.path.dirname(_pkg()), 'build')


def _stale(src: str, out: str) -> bool:
    return not (os.path.exists(out)
                and os.path.getmtime(out) >= os.path.getmtime(src))


def _tmp(out: str) -> str:
    """A build's private output path beside ``out``: one per process and
    thread, so a background build and a blocking one in the same
    process never publish each other's file."""
    return '%s.tmp.%d.%d' % (out, os.getpid(), threading.get_ident())


def _compile(cmd: list[str], out: str, what: str) -> str | None:
    """Run ``cmd`` (which writes ``cmd[-1]``, a tmp path) and publish its
    output at ``out``; None (logged) when the compiler is missing or
    fails."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = cmd[-1]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        log.info('%s build unavailable: %s', what, e)
        return None
    if r.returncode != 0:
        log.warning('%s build failed: %s', what, r.stderr.strip())
        return None
    os.replace(tmp, out)  # atomic: concurrent builds can't mix halves
    return out


def source_path() -> str:
    return os.path.join(_pkg(), 'csrc', 'zkwire.cpp')


def lib_path() -> str:
    return os.path.join(build_dir(), 'libzkwire_torch.v%d.so'
                        % _ABI_VERSION)


def build() -> str | None:
    """Compile the frame scanner if missing or stale; return its path or
    None.  Synchronous — call from tests/tools, not the event loop
    (:func:`get_lib` wraps it in a background thread)."""
    src, out = source_path(), lib_path()
    if not os.path.exists(src):
        return None
    if not _stale(src, out):
        return out
    return _compile(['g++', '-O2', '-shared', '-fPIC', '-std=c++17', src,
                     '-o', _tmp(out)], out,
                    'native scanner')


def _bind(path: str) -> ctypes.CDLL | None:
    lib = ctypes.CDLL(path)
    lib.zkwire_abi_version.restype = ctypes.c_int32
    lib.zkwire_abi_version.argtypes = []
    if lib.zkwire_abi_version() != _ABI_VERSION:
        log.warning('libzkwire_torch ABI mismatch (version-named '
                    'artifact should make this impossible)')
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.zkwire_frame_scan.restype = ctypes.c_int32
    lib.zkwire_frame_scan.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, i32p]
    return lib


def _try_load() -> None:
    """Bind the on-disk artifact if present and current (fast: one
    stat + dlopen).  Sets _lib/_load_failed; caller holds _lock."""
    global _lib, _load_failed
    out, src = lib_path(), source_path()
    if not os.path.exists(src) or _stale(src, out):
        return
    try:
        _lib = _bind(out)
    except OSError as e:
        log.warning('libzkwire_torch load failed: %s', e)
        _lib = None
    if _lib is None:
        _load_failed = True


def get_lib() -> ctypes.CDLL | None:
    """The bound library, or None if unavailable (yet).

    Non-blocking: when the artifact is missing the build runs on a
    daemon thread and this returns None until a later call finds the
    artifact ready."""
    global _build_thread
    if os.environ.get('ZKSTREAM_NO_NATIVE') == '1':
        return None
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        _try_load()
        if _lib is not None or _load_failed:
            return _lib
        if _build_thread is None or not _build_thread.is_alive():
            _build_thread = threading.Thread(
                target=_build_or_latch, name='zkwire-torch-build',
                daemon=True)
            _build_thread.start()
        return None


def _build_or_latch() -> None:
    """Background-build the C-ABI library; a failed compile latches
    ``_load_failed`` so later ``get_lib`` calls don't respawn the
    compiler for the life of the process."""
    global _load_failed
    if build() is None:
        with _lock:
            _load_failed = True


def ensure_lib() -> ctypes.CDLL | None:
    """Blocking variant for tests/tools: build synchronously and bind."""
    if os.environ.get('ZKSTREAM_NO_NATIVE') == '1':
        return None
    if build() is None:
        return None
    return get_lib()


# -- CPython-extension codec (csrc/zkwire_ext.c) ----------------------
#
# Separate artifact from the C-ABI scanner: it links against the
# interpreter ABI (Python.h), decodes whole accumulation buffers into
# packet dicts (framing + bodies in one C pass) and carries the
# transport calls, loaded with the same version-named-artifact /
# background-build discipline.

_EXT_NAME = '_zkwire_ext_torch'
_EXT_ABI_VERSION = 2

#: The extension's transport calls (ABI 2 on): the WAL checksum, the
#: send plane's batched writes, the server's batched receive and the
#: io_uring ring (io/transport.py, io/ingress.py, server/persist.py).
EXT_TRANSPORT_CALLS = ('crc32c', 'submit_writev', 'drain_recv',
                       'uring_create', 'uring_submit', 'uring_recv',
                       'uring_close')

_ext = None
_ext_load_failed = False
_ext_build_thread: threading.Thread | None = None


def ext_source_path() -> str:
    return os.path.join(_pkg(), 'csrc', 'zkwire_ext.c')


def ext_path() -> str:
    tag = sysconfig.get_config_var('SOABI') or 'abi3'
    return os.path.join(build_dir(), '%s.v%d.%s.so'
                        % (_EXT_NAME, _EXT_ABI_VERSION, tag))


def build_ext() -> str | None:
    """Compile the extension if missing or stale; return path or None."""
    src, out = ext_source_path(), ext_path()
    if not os.path.exists(src):
        return None
    if not _stale(src, out):
        return out
    return _compile(['gcc', '-O2', '-shared', '-fPIC',
                     '-I', sysconfig.get_paths()['include'], src,
                     '-o', _tmp(out)], out,
                    'native ext')


#: opcode -> reply-body-layout enum shared with zkwire_ext.c (keep in
#: sync with records._RESP_READERS / _EMPTY_RESPONSES).
_EXT_LAYOUTS = {
    'SET_WATCHES': 0, 'SET_WATCHES2': 0, 'ADD_WATCH': 0, 'PING': 0,
    'SYNC': 0, 'DELETE': 0, 'CLOSE_SESSION': 0, 'AUTH': 0,
    'GET_CHILDREN': 1, 'GET_CHILDREN2': 2, 'CREATE': 3, 'GET_ACL': 4,
    'GET_DATA': 5, 'EXISTS': 6, 'SET_DATA': 6, 'NOTIFICATION': 7,
    'MULTI': 8,
}

#: opcode -> request-body-layout enum (keep in sync with
#: records._REQ_READERS): 0 empty, 1 path, 2 path+watch, 3 create,
#: 4 delete, 5 set_data, 6 set_watches, 7 multi, 8 add_watch,
#: 9 set_watches2.
_EXT_REQ_LAYOUTS = {
    'GET_CHILDREN': 2, 'GET_CHILDREN2': 2, 'GET_DATA': 2, 'EXISTS': 2,
    'CREATE': 3, 'DELETE': 4, 'GET_ACL': 1, 'SET_DATA': 5, 'SYNC': 1,
    'SET_WATCHES': 6, 'CLOSE_SESSION': 0, 'PING': 0, 'MULTI': 7,
    'ADD_WATCH': 8, 'SET_WATCHES2': 9,
}

#: Opcodes the spec tier decodes but the extension deliberately PUNTS
#: (decode_stream returns kind='UNSUPPORTED' at the frame boundary and
#: PacketCodec hands the rest of the buffer to the Python spec tier).
#: Empty: every spec reader has a C layout in both directions; the punt
#: machinery stays for the next variable-shape opcode.  The sync test
#: in tests/test_torch_native_ext.py holds ``layouts | punts == spec
#: readers``.
_EXT_PUNT_OPS = frozenset()


def ext_setup_args() -> tuple:
    """The argument tuple for ``_zkwire_ext_torch.setup``, from this
    package's record classes and enums."""
    from ..protocol import records
    from ..protocol.consts import (
        CreateFlag,
        ErrCode,
        KeeperState,
        NotificationType,
        OpCode,
        Perm,
    )

    return (
        records.Stat, records.ACL, records.Id, Perm, CreateFlag,
        {int(e): e.name for e in ErrCode},
        {int(t): t.name for t in NotificationType},
        {int(s): s.name for s in KeeperState},
        dict(_EXT_LAYOUTS),
        {int(OpCode[name]): (name, layout)
         for name, layout in _EXT_REQ_LAYOUTS.items()},
        {int(o): o.name for o in OpCode},
        {e.name: int(e) for e in ErrCode},
        {t.name: int(t) for t in NotificationType},
        {s.name: int(s) for s in KeeperState},
        {o.name: int(o) for o in OpCode},
    )


def _bind_ext(path: str):
    import importlib.machinery
    import importlib.util

    loader = importlib.machinery.ExtensionFileLoader(_EXT_NAME, path)
    spec = importlib.util.spec_from_file_location(
        _EXT_NAME, path, loader=loader)
    mod = importlib.util.module_from_spec(spec)
    loader.exec_module(mod)
    if mod.abi_version() != _EXT_ABI_VERSION:
        log.warning('%s ABI mismatch', _EXT_NAME)
        return None
    mod.setup(*ext_setup_args())
    return mod


def _try_load_ext() -> None:
    global _ext, _ext_load_failed
    out, src = ext_path(), ext_source_path()
    if not os.path.exists(src) or _stale(src, out):
        return
    try:
        _ext = _bind_ext(out)
    except (OSError, ImportError) as e:
        log.warning('%s load failed: %s', _EXT_NAME, e)
        _ext = None
    if _ext is None:
        _ext_load_failed = True


def get_ext():
    """The bound extension module, or None if unavailable (yet).
    Non-blocking, same contract as :func:`get_lib`."""
    global _ext_build_thread
    if os.environ.get('ZKSTREAM_NO_NATIVE') == '1':
        return None
    with _lock:
        if _ext is not None or _ext_load_failed:
            return _ext
        _try_load_ext()
        if _ext is not None or _ext_load_failed:
            return _ext
        if _ext_build_thread is None or not _ext_build_thread.is_alive():
            _ext_build_thread = threading.Thread(
                target=_build_ext_or_latch, name='zkwire-ext-torch-build',
                daemon=True)
            _ext_build_thread.start()
        return None


def _build_ext_or_latch() -> None:
    """Background-build the extension; latch failure like
    :func:`_build_or_latch`."""
    global _ext_load_failed
    if build_ext() is None:
        with _lock:
            _ext_load_failed = True


def ensure_ext():
    """Blocking variant for tests/tools: build synchronously and bind."""
    if os.environ.get('ZKSTREAM_NO_NATIVE') == '1':
        return None
    if build_ext() is None:
        return None
    return get_ext()


# -- C load generator (csrc/loadgen.c) ---------------------------------
#
# A standalone binary, not a shared library: it drives the real wire
# protocol over raw sockets (the measuring instrument the bench
# families spawn instead of the Python read workers — README "Load
# generation").  Same discipline as the other two artifacts:
# version-named output in build/, atomic tmp+rename publish, graceful
# None when the host has no compiler.  It is a host tool: None means
# no load generator, never a device fallback.

_LOADGEN_VERSION = 1


def loadgen_source_path() -> str:
    return os.path.join(_pkg(), 'csrc', 'loadgen.c')


def loadgen_path() -> str:
    return os.path.join(build_dir(), 'zkloadgen.v%d' % _LOADGEN_VERSION)


def build_loadgen() -> str | None:
    """Compile the load generator if missing or stale; return its
    path or None.  Synchronous (tools/bench only, never the event
    loop)."""
    src, out = loadgen_source_path(), loadgen_path()
    if not os.path.exists(src):
        return None
    if not _stale(src, out):
        return out
    return _compile(['gcc', '-O2', '-pthread', src, '-o',
                     _tmp(out)], out, 'loadgen')


class NativeFrameScanner:
    """ctypes facade over zkwire_frame_scan for one connection.

    ``scan`` reads the caller's accumulation buffer zero-copy (ctypes
    ``from_buffer`` on the bytearray) and returns ``(spans, resid,
    bad_at)``: (start, size) body spans, the cursor after the last
    complete frame, and the offset of an invalid length prefix (or
    None).  The caller must not mutate the bytearray during the call
    (single-threaded asyncio guarantees that here)."""

    __slots__ = ('_lib', '_cap', '_starts', '_sizes')

    def __init__(self, lib: ctypes.CDLL, cap: int = 256):
        self._lib = lib
        self._cap = cap
        self._starts = (ctypes.c_int32 * cap)()
        self._sizes = (ctypes.c_int32 * cap)()

    def scan(self, buf: bytearray, max_packet: int):
        n_total = len(buf)
        if n_total < 4:
            return [], 0, None
        arr = (ctypes.c_uint8 * n_total).from_buffer(buf)
        try:
            addr = ctypes.addressof(arr)
            spans: list[tuple[int, int]] = []
            base = 0
            while True:
                resid = ctypes.c_int32(0)
                n = self._lib.zkwire_frame_scan(
                    addr + base, n_total - base, max_packet, self._cap,
                    self._starts, self._sizes, ctypes.byref(resid))
                if n < 0:
                    bad = base + resid.value
                    return spans, bad, bad
                spans.extend((base + self._starts[i], self._sizes[i])
                             for i in range(n))
                base += resid.value
                if n < self._cap:
                    return spans, base, None
        finally:
            del arr  # release the buffer export before caller mutates
