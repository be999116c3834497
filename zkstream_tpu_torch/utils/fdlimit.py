"""RLIMIT_NOFILE handling for million-session serving (README "Load
generation").

The first honest million-session campaign (PROFILE.md round 19) made
fd limits a first-class failure mode instead of a mystery EMFILE
deep in accept(2): every server entry point lifts the soft limit as
far as the host allows **at startup**, and when the host cap is the
binding constraint the error says so by name — which limit, what it
fits, and which knob raises it (the hard limit / ``fs.nr_open``
sysctl need privilege; this code never silently degrades).

The C loadgen does the same dance on its side (tools/loadgen.c
``raise_nofile``) and reports the outcome in its summary JSON under
``caps`` / ``binding_constraint``.
"""

from __future__ import annotations

import logging

log = logging.getLogger('zkstream_tpu_torch.fdlimit')


def raise_nofile(need: int | None = None) -> tuple[int, int]:
    """Lift the soft RLIMIT_NOFILE toward the hard limit (and, where
    the process has the privilege, the hard limit toward ``need``).
    Returns the resulting ``(soft, hard)``.  Never raises: a host
    that refuses stays at its cap and the caller decides whether
    that's binding (:func:`headroom_error`)."""
    import resource
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    want = hard if need is None else max(need, soft)
    if need is not None and want > hard:
        # raising the hard limit needs CAP_SYS_RESOURCE and is
        # bounded by fs.nr_open; try, keep what sticks
        try:
            resource.setrlimit(resource.RLIMIT_NOFILE, (want, want))
        except (ValueError, OSError):
            pass
        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        want = min(want, hard)
    if soft < want:
        try:
            resource.setrlimit(resource.RLIMIT_NOFILE, (want, hard))
        except (ValueError, OSError):
            pass
        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    return soft, hard


def headroom_error(need: int, *, reserve: int = 256) -> str | None:
    """A clear binding-constraint message when the current soft limit
    cannot fit ``need`` descriptors (plus a reserve for WAL segments,
    listeners, pipes), or None when there is room.  The message names
    the limit and the fix — it is what lands in logs and in bench
    cell JSON as ``binding_constraint``."""
    import resource
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    fit = soft - reserve
    if fit >= need:
        return None
    return ('RLIMIT_NOFILE: soft/hard %d/%d fits %d connections '
            '(wanted %d); raise the hard limit (needs privilege) '
            'and fs.nr_open to go higher' % (soft, hard, fit, need))
