"""The longest stretch of the window with nothing on the card (ms)."""


def read(ctx):
    if ctx.device is None:
        return None
    g = ctx.device.longest_gap()
    return None if g is None else g * 1e3
