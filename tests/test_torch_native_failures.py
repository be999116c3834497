"""The port's utils/native.py failure paths: build failures, ABI
mismatches, load latches, the ZKSTREAM_NO_NATIVE kill switch, and the
background build thread — the code that only runs when the toolchain or
artifacts are broken.  The port of tests/test_native_failures.py, with
the port's names: the build threads are ``_build_thread`` and
``_ext_build_thread``, the extension module is ``_zkwire_ext_torch``,
and the real artifacts live in ``build_dir()``.

Every test redirects the source/artifact paths into a tmpdir so the
real build products are never touched, and restores the module-level
latches afterward.
"""

from __future__ import annotations

import os
import subprocess
import sysconfig
import threading
import time

import pytest

from zkstream_tpu_torch.utils import native


@pytest.fixture
def pristine(monkeypatch, tmp_path):
    """Snapshot/restore the loader's global latches and point every
    path helper into a private tmpdir."""
    saved = (native._lib, native._load_failed, native._build_thread,
             native._ext, native._ext_load_failed, native._ext_build_thread)
    native._lib = None
    native._load_failed = False
    native._build_thread = None
    native._ext = None
    native._ext_load_failed = False
    native._ext_build_thread = None
    monkeypatch.setattr(native, 'source_path',
                        lambda: str(tmp_path / 'zkwire.cpp'))
    monkeypatch.setattr(native, 'lib_path',
                        lambda: str(tmp_path / 'libzkwire.test.so'))
    monkeypatch.setattr(native, 'ext_source_path',
                        lambda: str(tmp_path / 'zkwire_ext.c'))
    monkeypatch.setattr(native, 'ext_path',
                        lambda: str(tmp_path / '_zkwire_ext_torch.test.so'))
    yield tmp_path
    (native._lib, native._load_failed, native._build_thread,
     native._ext, native._ext_load_failed, native._ext_build_thread) = saved


def have_cc() -> bool:
    try:
        subprocess.run(['g++', '--version'], capture_output=True,
                       timeout=30)
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False


def test_build_missing_source_returns_none(pristine):
    assert native.build() is None
    assert native.build_ext() is None


def test_build_compile_failure_returns_none(pristine):
    if not have_cc():
        pytest.skip('no compiler')
    (pristine / 'zkwire.cpp').write_text('int main( {')   # broken
    (pristine / 'zkwire_ext.c').write_text('int main( {')
    assert native.build() is None
    assert native.build_ext() is None
    # no artifact and no half-written tmp left behind
    leftovers = [p for p in os.listdir(pristine) if '.so' in p]
    assert leftovers == []


def test_ensure_lib_and_ext_fail_cleanly(pristine):
    """The blocking variants return None (never raise) when the build
    cannot produce an artifact."""
    assert native.ensure_lib() is None
    assert native.ensure_ext() is None


def test_kill_switch_disables_everything(pristine, monkeypatch):
    monkeypatch.setenv('ZKSTREAM_NO_NATIVE', '1')
    assert native.get_lib() is None
    assert native.ensure_lib() is None
    assert native.get_ext() is None
    assert native.ensure_ext() is None
    assert native._build_thread is None  # no build thread ever spawned
    assert native._ext_build_thread is None


def test_abi_mismatch_latches_lib(pristine):
    """A stale-ABI artifact (version-named files should prevent this,
    but belt-and-braces) must latch load-failed, not bind."""
    if not have_cc():
        pytest.skip('no compiler')
    src = pristine / 'zkwire.cpp'
    src.write_text('extern "C" int zkwire_abi_version() '
                   '{ return 987654; }\n')
    out = native.build()
    assert out is not None               # the build itself succeeded
    with native._lock:
        native._try_load()
    assert native._lib is None
    assert native._load_failed           # latched: no rebind attempts
    assert native.get_lib() is None


def test_abi_mismatch_latches_ext(pristine):
    if not have_cc():
        pytest.skip('no compiler')
    src = pristine / 'zkwire_ext.c'
    src.write_text(
        '#include <Python.h>\n'
        'static PyObject* abi_version(PyObject* s, PyObject* a)'
        '{ return PyLong_FromLong(987654); }\n'
        'static PyMethodDef m[] = {{"abi_version", abi_version, '
        'METH_NOARGS, ""}, {NULL, NULL, 0, NULL}};\n'
        'static struct PyModuleDef mod = {PyModuleDef_HEAD_INIT, '
        '"_zkwire_ext_torch", NULL, -1, m};\n'
        'PyMODINIT_FUNC PyInit__zkwire_ext_torch(void)'
        '{ return PyModule_Create(&mod); }\n')
    out = native.build_ext()
    if out is None:
        pytest.skip('Python.h unavailable')
    with native._lock:
        native._try_load_ext()
    assert native._ext is None
    assert native._ext_load_failed
    assert native.get_ext() is None


def test_get_lib_background_build_failure_latches(pristine):
    """get_lib with no artifact spawns the background build thread; a build
    failure latches load-failed so gcc is never respawned."""
    (pristine / 'zkwire.cpp').write_text('int main( {')
    assert native.get_lib() is None      # starts the build thread
    thread = native._build_thread
    assert thread is not None
    thread.join(120)
    assert not thread.is_alive()
    assert native._load_failed
    # the latch holds: no new build thread on subsequent calls
    assert native.get_lib() is None
    assert native._build_thread is thread


def test_get_ext_background_build_failure_latches(pristine):
    (pristine / 'zkwire_ext.c').write_text('int main( {')
    assert native.get_ext() is None
    thread = native._ext_build_thread
    assert thread is not None
    thread.join(120)
    assert native._ext_load_failed
    assert native.get_ext() is None
    assert native._ext_build_thread is thread


def test_corrupt_artifact_load_failure_latches(pristine):
    """An artifact dlopen cannot load (truncated/garbage .so) latches
    rather than raising into the caller."""
    src = pristine / 'zkwire.cpp'
    src.write_text('// source\n')
    bad = pristine / 'libzkwire.test.so'
    bad.write_bytes(b'\x7fELF garbage')
    os.utime(str(bad), (time.time() + 60, time.time() + 60))
    with native._lock:
        native._try_load()
    assert native._lib is None and native._load_failed

    esrc = pristine / 'zkwire_ext.c'
    esrc.write_text('// source\n')
    ebad = pristine / '_zkwire_ext_torch.test.so'
    ebad.write_bytes(b'\x7fELF garbage')
    os.utime(str(ebad), (time.time() + 60, time.time() + 60))
    with native._lock:
        native._try_load_ext()
    assert native._ext is None and native._ext_load_failed


def test_concurrent_get_lib_single_builder(pristine):
    """Hammering get_lib from threads while no artifact exists spawns
    at most one live build thread (the lock-guarded spawn)."""
    (pristine / 'zkwire.cpp').write_text('int main( {')
    seen = set()

    def hit():
        for _ in range(5):
            native.get_lib()
            b = native._build_thread
            if b is not None:
                seen.add(b)
    ts = [threading.Thread(target=hit) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    # build threads may chain if one exits between calls, but never two
    # alive at once; after the latch lands no more spawn
    if native._build_thread is not None:
        native._build_thread.join(120)
    assert native._load_failed
    before = native._build_thread
    native.get_lib()
    assert native._build_thread is before


def test_ext_path_is_abi_tagged():
    """The artifact name carries both the extension ABI version and
    the interpreter SOABI tag, so a Python upgrade or ABI bump can
    never bind a stale artifact (no fixture here: the real paths)."""
    tag = sysconfig.get_config_var('SOABI') or 'abi3'
    assert tag in native.ext_path()
    assert 'v%d' % native._EXT_ABI_VERSION in native.ext_path()
    assert os.path.basename(native.ext_path()).startswith(
        '_zkwire_ext_torch.')
    assert os.path.dirname(native.ext_path()) == native.build_dir()
