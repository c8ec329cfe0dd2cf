"""Mean `claim` span a eval (ms): dequeue -> scheduler start, the batch
drain and the hand-off to a pool thread (server/worker.py)."""
from . import mean, span_ms


def read(ctx):
    return mean(span_ms(ctx, "claim"))
