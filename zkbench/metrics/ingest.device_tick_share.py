"""``ingest.device_tick_share``: of the ticks that routed work in the
window, the share that ran on the device: the change of ``ticks`` over
the change of ``ticks + ticks_scalar + ticks_warming`` (a tick the
fragmentation guard routes counts in ``ticks_scalar`` and, besides, in
``ticks_frag``, so ``ticks_frag`` is not added again)."""


def read(ctx):
    i = ctx.ingest
    n = i['ticks'] + i['ticks_scalar'] + i['ticks_warming']
    return 100.0 * i['ticks'] / n if n else None
