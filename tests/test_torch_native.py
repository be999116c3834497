"""A/B tests: the port's native C++ frame scanner against its pure-Python
loop, which is the semantic spec, and against the JAX package's scanner.

The port's ``FrameDecoder(use_native=True)`` (``csrc/zkwire.cpp`` via
ctypes, built into ``build/``) must match ``FrameDecoder(use_native=
False)`` and the reference's ``FrameDecoder(use_native=True)`` on every
stream, chunking and error case.  Mirrors tests/test_native.py.
"""

import os
import random
import struct

import pytest

from zkstream_tpu.protocol.errors import ZKProtocolError as RefProtocolError
from zkstream_tpu.protocol.framing import FrameDecoder as RefDecoder
from zkstream_tpu_torch.protocol.consts import MAX_PACKET
from zkstream_tpu_torch.protocol.errors import ZKProtocolError
from zkstream_tpu_torch.protocol.framing import FrameDecoder
from zkstream_tpu_torch.utils import native


@pytest.fixture(scope='module', autouse=True)
def _built():
    if native.ensure_lib() is None:
        pytest.skip('no C++ compiler: the port\'s scanner cannot build')


def _frames_blob(rng, n, max_body=64):
    bodies = [bytes(rng.randrange(0, 256)
                    for _ in range(rng.randrange(0, max_body)))
              for _ in range(n)]
    blob = b''.join(struct.pack('>i', len(b)) + b for b in bodies)
    return bodies, blob


def _feed_chunked(dec, blob, rng, max_chunk):
    out, i = [], 0
    while i < len(blob):
        step = rng.randrange(1, max_chunk + 1)
        out += dec.feed(blob[i:i + step])
        i += step
    return out


def _three():
    """The port's scanner, the port's Python loop, the reference's
    scanner."""
    return (FrameDecoder(use_native=True), FrameDecoder(use_native=False),
            RefDecoder(use_native=True))


def test_scanner_is_the_ports_own_build():
    lib = native.ensure_lib()
    assert lib._name == native.lib_path()
    assert os.path.dirname(lib._name) == native.build_dir()
    assert os.path.basename(native.build_dir()) == 'build'
    assert FrameDecoder(use_native=True)._scanner is not None
    assert FrameDecoder(use_native=False)._scanner is None


@pytest.mark.parametrize('seed', [0, 1, 2, 3])
def test_native_matches_python_random_streams(seed):
    rng = random.Random(seed)
    bodies, blob = _frames_blob(rng, rng.randrange(1, 40))
    for max_chunk in (1, 3, 7, len(blob) or 1):
        got = [_feed_chunked(dec, blob, random.Random(seed), max_chunk)
               for dec in _three()]
        assert got[0] == got[1] == got[2] == bodies


@pytest.mark.parametrize('prefix', [-5, -2**31])
def test_native_bad_length_contract(prefix):
    good = struct.pack('>i', 4) + b'abcd'
    bad = struct.pack('>i', prefix)
    decs = _three()
    for dec in decs:
        with pytest.raises((ZKProtocolError, RefProtocolError)) as ei:
            dec.feed(good + bad)
        assert ei.value.code == 'BAD_LENGTH'
    # all leave the buffer positioned at the offending prefix
    assert [d.pending() for d in decs] == [len(bad)] * 3


@pytest.mark.parametrize('max_frame,length', [
    (None, MAX_PACKET + 1), (None, 2**31 - 1), (64, 65), (64, 4096)])
def test_native_oversize_length(max_frame, length):
    """An over-cap prefix is the typed frame-size rejection in every
    tier, raised from the prefix before any body byte is buffered."""
    blob = struct.pack('>i', 4) + b'abcd' + struct.pack('>i', length) \
        + b'\0' * 16
    for dec in (FrameDecoder(use_native=True, max_frame=max_frame),
                FrameDecoder(use_native=False, max_frame=max_frame),
                RefDecoder(use_native=True, max_frame=max_frame)):
        with pytest.raises((ZKProtocolError, RefProtocolError)) as ei:
            dec.feed(blob)
        assert ei.value.code == 'FRAME_TOO_LARGE'
        assert ei.value.length == length
        assert ei.value.cap == (max_frame or MAX_PACKET)
        assert dec.pending() == 4 + 16


def test_native_cap_is_inclusive():
    body = b'\x01' * 64
    for dec in (FrameDecoder(use_native=True, max_frame=64),
                FrameDecoder(use_native=False, max_frame=64)):
        assert dec.feed(struct.pack('>i', 64) + body) == [body]


def test_native_partial_then_complete():
    body = b'\x55' * 1000
    blob = struct.pack('>i', len(body)) + body
    dec = FrameDecoder(use_native=True)
    assert dec.feed(blob[:500]) == []
    assert dec.pending() == 500
    assert dec.feed(blob[500:]) == [body]
    assert dec.pending() == 0


def test_native_many_frames_exceeding_scan_cap():
    """More frames in one feed than the per-call native cap (256)."""
    rng = random.Random(9)
    bodies, blob = _frames_blob(rng, 700, max_body=8)
    got = [dec.feed(blob) for dec in _three()]
    assert got[0] == got[1] == got[2] == bodies


def test_native_large_frame_incremental_chunks():
    """A large frame arriving in socket-sized chunks must reassemble
    (and must not choke on the zero-copy buffer export)."""
    body = bytes(range(256)) * 2048  # 512 KiB
    blob = struct.pack('>i', len(body)) + body
    dec = FrameDecoder(use_native=True)
    out = []
    for i in range(0, len(blob), 65536):
        out += dec.feed(blob[i:i + 65536])
    assert out == [body]
    assert dec.pending() == 0


def test_take_and_restore_pending_across_tiers():
    """Residue handed out of one decoder continues in another tier."""
    rng = random.Random(5)
    bodies, blob = _frames_blob(rng, 20)
    cut = len(blob) // 2 + 1
    a = FrameDecoder(use_native=True)
    got = a.feed(blob[:cut])
    b = FrameDecoder(use_native=False)
    b.restore_pending(a.take_pending())
    assert a.pending() == 0
    got += b.feed(blob[cut:])
    assert got == bodies


def test_no_native_env_forces_python(monkeypatch):
    monkeypatch.setenv('ZKSTREAM_NO_NATIVE', '1')
    assert native.get_lib() is None and native.ensure_lib() is None
    assert FrameDecoder()._scanner is None
    with pytest.raises(RuntimeError, match='native codec unavailable'):
        FrameDecoder(use_native=True)


def test_concurrent_builds_in_one_process_both_publish(tmp_path, monkeypatch):
    """A background build and a blocking one of the same artifact in one
    process (``get_ext()``'s thread beside ``ensure_ext()``) each write
    their own tmp file, so both publish and neither raises."""
    import threading

    monkeypatch.setattr(native, 'build_dir', lambda: str(tmp_path))
    barrier = threading.Barrier(2)
    results, errors = [], []

    def one():
        barrier.wait()
        try:
            results.append(native.build())
        except Exception as e:     # the race surfaced as FileNotFoundError
            errors.append(e)
    threads = [threading.Thread(target=one) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert results == [native.lib_path()] * 2
    assert os.path.exists(native.lib_path())
    assert not [f for f in os.listdir(tmp_path) if '.tmp.' in f]
