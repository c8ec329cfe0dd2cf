"""Share (%) of the window in which no kernel, copy or set ran on the
card, from the profiler's trace."""


def read(ctx):
    d = ctx.device
    if d is None or d.window_s <= 0:
        return None
    return 100.0 * (1.0 - d.busy_s / d.window_s)
