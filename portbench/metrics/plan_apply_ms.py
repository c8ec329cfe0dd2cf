"""Mean `plan_apply` span a eval (ms): submit -> result, the queue hop,
the check and the commit (server/plan_apply.py)."""
from . import mean, span_ms


def read(ctx):
    return mean(span_ms(ctx, "plan_apply"))
