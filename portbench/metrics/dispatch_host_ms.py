"""Host part of a fused dispatch (ms): pack, upload and view, from the
dispatch timeline's records launched in the window
(server/select_batch.py)."""
from . import mean


def read(ctx):
    t0, t1 = ctx.window
    return mean([r["host_ms"] for r in ctx.dispatches
                 if r["host_ms"] is not None
                 and t0 <= r["start_unix"] <= t1])
