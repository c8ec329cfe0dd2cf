"""Mean self time of the `schedule` span a eval (ms): the span less the
part of it its child spans (pack, delta_apply, kernel, plan_apply) cover
- reconcile, compile and the waits between (scheduler/generic.py,
reconcile.py, stack.py)."""
from ..devtrace import overlap, union
from . import mean

CHILDREN = ("pack", "delta_apply", "kernel", "plan_apply")


def read(ctx):
    out = []
    for spans in ctx.spans.values():
        kids = union([(a, b) for p, a, b in spans if p in CHILDREN])
        for p, a, b in spans:
            if p == "schedule":
                out.append((b - a - overlap(a, b, kids)) * 1e3)
    return mean(out)
