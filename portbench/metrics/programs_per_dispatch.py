"""Placement programs a fused dispatch: the `pipeline.programs` counter
over `pipeline.dispatches`, across the window."""
from . import delta, dispatches


def read(ctx):
    d = dispatches(ctx)
    return delta(ctx, "pipeline.programs") / d if d else None
