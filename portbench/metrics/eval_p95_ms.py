"""Eval latency's 95th percentile (ms): create -> terminal status, as
the server stamps them, over every eval that reached a terminal status in
the window. Under a standing backlog it is about the backlog over the
rate."""
import math


def read(ctx):
    lat = sorted((r["modify"] - r["create"]) * 1e3 for r in ctx.evals)
    if not lat:
        return None
    return lat[max(math.ceil(0.95 * len(lat)) - 1, 0)]
