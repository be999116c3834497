"""Sanitizer checks for the port's C-extension codec
(``zkstream_tpu_torch/csrc/zkwire_ext.c``, module ``_zkwire_ext_torch``):
the port's copy of the JAX package's ``tools/asan_check.py``.

Builds the extension under a sanitizer into the temporary directory
and drives both decode directions with valid corpora plus a mutation
storm (random
truncations/bit flips/suffixes of valid wire), so every bounds check
in the C code gets adversarial coverage:

- default: AddressSanitizer — any out-of-bounds
  access aborts the process with an ASAN report;
- ``--ubsan``: UndefinedBehaviorSanitizer with
  ``-fno-sanitize-recover=undefined`` — shift/overflow/alignment/
  null-deref UB aborts instead of silently miscomputing.

Must run as a child process with the sanitizer runtime preloaded;
this script re-execs itself with LD_PRELOAD when needed.

``ASAN_ROUNDS`` sets the mutation storm's rounds (default 20000).

Usage:  python -m zkstream_tpu_torch.tools.asan_check [--ubsan]
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

from ..utils import native

#: the repository root: this file is zkstream_tpu_torch/tools/
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_EXT_NAME = '_zkwire_ext_torch'
ROUNDS = int(os.environ.get('ASAN_ROUNDS', '20000'))

#: Per-mode build recipe: compile flags, runtime library to preload,
#: runtime options env var.
MODES = {
    'asan': {
        'so': '_zkwire_ext_torch_asan.so',
        'cflags': ['-fsanitize=address'],
        'runtime': 'libasan.so',
        'env': ('ASAN_OPTIONS', 'detect_leaks=0:abort_on_error=1'),
    },
    'ubsan': {
        'so': '_zkwire_ext_torch_ubsan.so',
        'cflags': ['-fsanitize=undefined',
                   '-fno-sanitize-recover=undefined'],
        'runtime': 'libubsan.so',
        'env': ('UBSAN_OPTIONS', 'print_stacktrace=1:halt_on_error=1'),
    },
}


def so_path(mode: str) -> str:
    """Where ``mode``'s sanitized build goes: the temporary directory."""
    return os.path.join(tempfile.gettempdir(), MODES[mode]['so'])


def build(mode: str) -> str | None:
    """Build the sanitized extension; returns the sanitizer runtime's
    path (or None when the build fails)."""
    import sysconfig
    spec = MODES[mode]
    cmd = (['gcc', '-O1', '-g'] + spec['cflags']
           + ['-shared', '-fPIC',
              '-I', sysconfig.get_paths()['include'],
              native.ext_source_path(), '-o', so_path(mode)])
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        print('build failed:\n%s' % r.stderr, file=sys.stderr)
        return None
    r = subprocess.run(['gcc', '-print-file-name=%s'
                        % spec['runtime']],
                       capture_output=True, text=True)
    return r.stdout.strip()


def main() -> int:
    mode = 'ubsan' if '--ubsan' in sys.argv[1:] else 'asan'
    if os.environ.get('_SAN_CHILD') != '1':
        runtime = build(mode)
        if not runtime or not os.path.exists(runtime):
            print('%s unavailable; skipping' % (mode,),
                  file=sys.stderr)
            return 0
        opt_var, opt_val = MODES[mode]['env']
        pypath = os.environ.get('PYTHONPATH')
        env = dict(os.environ, _SAN_CHILD='1', _SAN_MODE=mode,
                   LD_PRELOAD=runtime, **{opt_var: opt_val},
                   PYTHONPATH=(REPO + os.pathsep + pypath if pypath
                               else REPO))
        return subprocess.run(
            [sys.executable, '-m', 'zkstream_tpu_torch.tools.asan_check']
            + sys.argv[1:], env=env).returncode

    mode = os.environ.get('_SAN_MODE', mode)
    so = so_path(mode)

    import importlib.machinery
    import importlib.util
    import random

    loader = importlib.machinery.ExtensionFileLoader(_EXT_NAME, so)
    spec = importlib.util.spec_from_file_location(
        _EXT_NAME, so, loader=loader)
    mod = importlib.util.module_from_spec(spec)
    loader.exec_module(mod)

    from ..protocol import records
    from ..protocol.framing import PacketCodec

    mod.setup(*native.ext_setup_args())

    st = records.Stat(1, 2, 3, 4, 5, 6, 7, 0, 3, 2, 8)
    enc = PacketCodec(server=True, use_native=False)
    enc.handshaking = False
    wire = b''.join(enc.encode(p) for p in [
        {'xid': 1, 'zxid': 1, 'opcode': 'GET_DATA', 'err': 'OK',
         'data': b'abc', 'stat': st},
        {'xid': 2, 'zxid': 2, 'opcode': 'GET_CHILDREN2', 'err': 'OK',
         'children': ['x', 'y'], 'stat': st},
        {'xid': 3, 'zxid': 3, 'opcode': 'GET_ACL', 'err': 'OK',
         'acl': list(records.OPEN_ACL_UNSAFE), 'stat': st},
        {'xid': -1, 'zxid': 4, 'opcode': 'NOTIFICATION', 'err': 'OK',
         'type': 'CREATED', 'state': 'SYNC_CONNECTED', 'path': '/p'},
    ])
    cenc = PacketCodec(use_native=False)
    cenc.handshaking = False
    rwire = b''.join(cenc.encode(dict(p)) for p in [
        {'xid': 1, 'opcode': 'CREATE', 'path': '/n', 'data': b'd',
         'acl': list(records.OPEN_ACL_UNSAFE), 'flags': 1},
        {'xid': -8, 'opcode': 'SET_WATCHES', 'relZxid': 9, 'events': {
            'dataChanged': ['/a'], 'createdOrDestroyed': [],
            'childrenChanged': []}},
        {'xid': 2, 'opcode': 'SET_DATA', 'path': '/n',
         'data': b'x' * 100, 'version': 2},
    ])

    xm = {i: 'GET_DATA' for i in range(1, 50)}
    for _ in range(2000):
        mod.decode_responses(wire, dict(xm), 16 << 20)
        mod.decode_requests(rwire, 16 << 20)
    print('valid corpora: OK')

    rng = random.Random(7)
    for _ in range(ROUNDS):
        base = rng.choice((wire, rwire))
        blob = bytearray(base[:rng.randrange(0, len(base) + 1)])
        for _ in range(rng.randrange(0, 6)):
            if blob:
                blob[rng.randrange(len(blob))] = rng.randrange(256)
        if rng.random() < 0.3:
            blob += bytes(rng.randrange(256)
                          for _ in range(rng.randrange(0, 40)))
        for call in (lambda b: mod.decode_responses(b, dict(xm),
                                                    16 << 20),
                     lambda b: mod.decode_requests(b, 16 << 20)):
            try:
                call(bytes(blob))
            except Exception:
                pass
    # encode paths: well-formed and near-miss dicts
    enc_cases = [
        {'xid': 1, 'opcode': 'GET_DATA', 'path': '/a', 'watch': True},
        {'xid': 1, 'opcode': 'SET_DATA', 'path': '/a', 'data': b'x',
         'version': 0},
        {'xid': 1, 'opcode': 'CREATE', 'path': '/n', 'data': b'd',
         'acl': list(records.OPEN_ACL_UNSAFE), 'flags': 1},
        {'xid': 1, 'opcode': 'CREATE', 'path': '/n', 'data': b'd',
         'acl': [object()], 'flags': 1},     # near-miss ACL entry
        {'xid': 1, 'opcode': 'GET_DATA', 'path': 42, 'watch': True},
        {'xid': 'bad', 'opcode': 'PING'},
    ]
    for _ in range(5000):
        for pkt in enc_cases:
            try:
                mod.encode_request(dict(pkt))
            except Exception:
                pass
        try:
            mod.encode_response({'xid': 1, 'zxid': 2, 'err': 'OK',
                                 'opcode': 'GET_DATA', 'data': b'd',
                                 'stat': records.Stat()})
        except Exception:
            pass
    print('mutation storm (%d rounds x 2 calls): no %s reports'
          % (ROUNDS, mode.upper()))
    return 0


if __name__ == '__main__':
    sys.exit(main())
