"""Bytes the device view and the program table move a dispatch: the
transfer ledger's `stack.*` and `select_batch.table_insert` sites
(kernels/rows.py, K7 and K8) over the window's dispatches."""
from . import dispatches


def read(ctx):
    d = dispatches(ctx)
    return ctx.ledger_bytes / d if d else None
