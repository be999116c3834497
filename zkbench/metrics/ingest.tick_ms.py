"""``ingest.tick_ms``: the mean ``FleetIngest`` tick over the window:
the change of ``zkstream_ingest_tick_ms``'s sum over the change of its
count (the ingest's own histogram, bound to the harness's
``Collector``)."""


def read(ctx):
    n = ctx.ingest['tick_ms_count']
    return ctx.ingest['tick_ms_sum'] / n if n else None
