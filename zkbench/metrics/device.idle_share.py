"""``device.idle_share``: the share of the traced window in which no
kernel, copy or fill ran on the device: 1 - the union of their
intervals over the window (``devtrace.Tracer.read``).  Nothing to read
where no device op ran."""


def read(ctx):
    t = ctx.trace
    if not t or not t['busy_s']:
        return None
    return 100.0 * (1.0 - t['busy_s'] / t['window_s'])
