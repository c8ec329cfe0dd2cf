"""Share (%) of the chain and wave kernels' roofline: the least time of
the window's dispatches at the card's data-sheet peaks
(`portbench/roofline.py` `chain_floor`, a floor on the count) over their
device time in the trace."""
from .. import roofline
from . import lane_kernels


def read(ctx):
    t = lane_kernels(ctx)
    if not t or ctx.peaks is None:
        return None
    t0, t1 = ctx.window
    flops_s, bytes_s = ctx.peaks
    cj = ctx.config["job"]
    least = 0.0
    for r in ctx.dispatches:
        if not t0 <= r["start_unix"] <= t1:
            continue
        b, ops = roofline.chain_floor(ctx.n_rows, 8, r["programs"],
                                      cj["max_allocs_bucket"],
                                      len(cj["constraints"]))
        least += max(b / bytes_s, ops / flops_s)
    return 100.0 * least / t if least else None
