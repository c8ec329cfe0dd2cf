"""Milliseconds of garbage collection a second of the window, from the
interpreter's `gc.callbacks`, set by the harness for the window."""


def read(ctx):
    t0, t1 = ctx.window
    paused = sum(max(0.0, min(b, t1) - max(a, t0)) for _g, a, b in ctx.gc)
    return paused * 1e3 / ctx.window_s
