"""Driver glue for the C load generator (csrc/loadgen.c), the port's
copy of ``zkstream_tpu.utils.loadgen``.

The bench families spawn ``zkloadgen`` instead of the Python read
workers by default: a Python worker process decodes replies far slower
than a server serves them, so a ceiling it measured would be the
client's.  This module owns the build (via utils/native.py's graceful
skip-when-no-compiler discipline; the binary lands in ``build/``) and
the knob surface:

- ``ZKSTREAM_LOADGEN``: ``c`` (default) drives benches with the C
  loadgen; ``py`` keeps the Python worker validator arm.
- ``ZKSTREAM_LOADGEN_THREADS``: epoll threads per loadgen process
  (default: auto = min(cores, 8)).
- ``ZKSTREAM_LOADGEN_PIPELINE``: outstanding ops per connection
  (default 16; the million-session campaign uses 1).
- ``ZKSTREAM_LOADGEN_RAMP``: handshakes/s for the connect wave
  (default 0 = unpaced).
- ``ZKSTREAM_LOADGEN_SRC_ADDRS``: loopback source addresses to spread
  connections over (default 0 = auto: one per ~20k sessions, with
  ``IP_BIND_ADDRESS_NO_PORT`` where the kernel has it) so a single
  host can open ~1M sockets without exhausting one address's ~28k
  ephemeral ports.

All knobs are documented in README "Load generation"; the zkanalyze
knob-drift baseline stays at zero.
"""

from __future__ import annotations

import os

from . import native


def mode() -> str:
    """``'c'`` (default) or ``'py'`` (the validator arm)."""
    m = os.environ.get('ZKSTREAM_LOADGEN', 'c').strip().lower()
    return 'py' if m == 'py' else 'c'


def available() -> str | None:
    """Build (if needed) and return the binary path, or None when the
    host has no compiler — callers fall back to the Python arm."""
    return native.build_loadgen()


def argv(servers, sessions, *, duration=None, count=None, mix=None,
         pipeline=None, threads=None, ramp=None, idle_ping=None,
         arm_watch=False, fanout_sets=None, setwatches_storm=False,
         path=None, data=None, stdio_sync=False, src_addrs=None,
         session_timeout_ms=None, close_sessions=False,
         ensure_path=True, quiet=True, cached=False,
         cached_write_ms=None) -> list[str] | None:
    """The zkloadgen command line for one run, env knobs applied.
    Returns None when the binary can't be built."""
    binary = available()
    if binary is None:
        return None
    cmd = [binary,
           '--servers', ','.join('%s:%d' % (h, p) for h, p in servers),
           '--sessions', str(int(sessions))]
    env = os.environ.get
    if duration is not None:
        cmd += ['--duration', str(float(duration))]
    if count is not None:
        cmd += ['--count', str(int(count))]
    if mix:
        cmd += ['--mix', mix]
    pipeline = pipeline if pipeline is not None else env(
        'ZKSTREAM_LOADGEN_PIPELINE')
    if pipeline is not None:
        cmd += ['--pipeline', str(int(pipeline))]
    threads = threads if threads is not None else env(
        'ZKSTREAM_LOADGEN_THREADS')
    if threads is not None:
        cmd += ['--threads', str(int(threads))]
    ramp = ramp if ramp is not None else env('ZKSTREAM_LOADGEN_RAMP')
    if ramp is not None:
        cmd += ['--ramp', str(float(ramp))]
    if idle_ping is not None:
        cmd += ['--idle-ping', str(float(idle_ping))]
    if arm_watch:
        cmd += ['--arm-watch']
    if fanout_sets:
        cmd += ['--fanout-sets', str(int(fanout_sets))]
    if setwatches_storm:
        cmd += ['--setwatches-storm']
    if path:
        cmd += ['--path', path]
    if data is not None:
        cmd += ['--data', str(int(data))]
    if stdio_sync:
        cmd += ['--stdio-sync']
    src_addrs = src_addrs if src_addrs is not None else env(
        'ZKSTREAM_LOADGEN_SRC_ADDRS')
    if src_addrs is not None:
        cmd += ['--src-addrs', str(int(src_addrs))]
    if session_timeout_ms is not None:
        cmd += ['--session-timeout', str(int(session_timeout_ms))]
    if close_sessions:
        cmd += ['--close-sessions']
    if not ensure_path:
        cmd += ['--no-ensure-path']
    if quiet:
        cmd += ['--quiet']
    if cached:
        cmd += ['--cached']
    if cached_write_ms is not None:
        cmd += ['--cached-write-ms', str(float(cached_write_ms))]
    return cmd
