"""``k1_roofline``: kernel K1's share of its roofline over the window:
the least time its launches could take, the bytes they must move
(``instruments.k1_bytes`` a replay of the tick's graph) at the H100's
3.35 TB/s, over K1's device time in the profiler's trace.  Nothing to
read where no K1 ran in the window."""

from zkbench.instruments import HBM_BYTES_PER_S


def read(ctx):
    t = ctx.trace
    if not t or not t['k1_device_s'] or not t['k1_replays']:
        return None
    return 100.0 * t['k1_bytes'] / HBM_BYTES_PER_S / t['k1_device_s']
