"""``server.cpu_share``: the busiest server process's user and system
time over the window (``/proc/<pid>/stat``), as a share of one core."""


def read(ctx):
    if not ctx.server_cpu_s:
        return None
    return 100.0 * max(ctx.server_cpu_s) / ctx.window_s
