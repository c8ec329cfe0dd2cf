"""Per-layer metrics, one reader a file, found by the metric's name.

Each module has `read(ctx) -> float | None`; None when the run gave it
nothing to read, and the harness then leaves the metric out of the line.
`ctx` (built in `portbench/harness.py`) holds the window, the evals that
reached a terminal status in it, their tracer spans, the dispatch
timeline's records, the server's counters before and after, the device
trace and the garbage collector's pauses.
"""
from __future__ import annotations

from typing import List, Optional


def mean(xs: List[float]) -> Optional[float]:
    return sum(xs) / len(xs) if xs else None


def span_ms(ctx, phase: str) -> List[float]:
    """Durations (ms) of one phase's spans, summed a eval, over the
    window's evals that have it."""
    out = []
    for spans in ctx.spans.values():
        d = [b - a for p, a, b in spans if p == phase]
        if d:
            out.append(sum(d) * 1e3)
    return out


def delta(ctx, name: str) -> float:
    return ctx.counters1.get(name, 0.0) - ctx.counters0.get(name, 0.0)


def dispatches(ctx) -> float:
    return delta(ctx, "pipeline.dispatches")


def lane_kernels(ctx) -> Optional[float]:
    """Seconds of device time of the chain and wave kernels."""
    if ctx.device is None:
        return None
    return ctx.device.device_time(("lane_cluster", "lane_fold"))
