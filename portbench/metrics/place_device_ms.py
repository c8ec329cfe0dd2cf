"""Device time of the chain and wave kernels (`lane_cluster`,
`lane_fold`) a dispatch (ms), from the profiler's trace of the window."""
from . import dispatches, lane_kernels


def read(ctx):
    t, d = lane_kernels(ctx), dispatches(ctx)
    if not t or not d:
        return None
    return t * 1e3 / d
