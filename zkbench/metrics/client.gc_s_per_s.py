"""``client.gc_s_per_s``: seconds the client process's garbage
collector held the interpreter, a second of the window
(``instruments.GcPauses``)."""


def read(ctx):
    return ctx.gc_s / ctx.window_s
