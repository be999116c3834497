"""``client.loop_lag_p99_ms``: how late the harness's 10 ms timer on the
client process's event loop woke, 99th percentile over the window
(``instruments.LoopLag``)."""

from zkbench.instruments import quantile


def read(ctx):
    if not ctx.lag_ms:
        return None
    return quantile(ctx.lag_ms, 0.99)
