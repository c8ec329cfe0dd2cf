"""The card's activity over the window, from `torch.profiler`'s trace.

The profiler records device activity alone (kernels, copies, sets); its
trace is written to `TMPDIR`, read, and removed. A marker kernel launched
at a known host time ties the trace's clock to the host's, so each idle
gap can be named by what the host was doing in it.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple

#: trace categories that are work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the marker: `torch.cuda._sleep` launches ATen's `spin_kernel`
MARKER = "spin_kernel"
#: host phases that hold no work of the worker's: an eval waits in the
#: queue for all of the window under a standing backlog
_NOT_HOST_WORK = ("queue_wait", "ack")


def short_name(name: str) -> str:
    """A trace event's name without its namespaces, arguments and
    templates."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.split("(")[0].split("<")[0].strip()
    if name.startswith("void "):
        name = name[5:]
    return name.replace(" ", "_") or "unnamed"


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def overlap(a0: float, a1: float, intervals) -> float:
    return sum(max(0.0, min(a1, b1) - max(a0, b0)) for b0, b1 in intervals)


class DeviceTrace:
    def __init__(self, torch) -> None:
        self.torch = torch
        self.prof = None
        self.mark_host = 0.0
        #: (short name, start, end) in host seconds, clipped to the window
        self.events: List[Tuple[str, float, float]] = []
        self.window = (0.0, 0.0)
        #: the trace's own kernel names, as the profiler gave them
        self.raw_names: set = set()

    def start(self) -> None:
        torch = self.torch
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.mark_host = time.time()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    def stop(self, t0: float, t1: float) -> "DeviceTrace":
        self.torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                raw = json.load(f)
        finally:
            os.remove(path)
        self.prof = None
        evs = [e for e in raw.get("traceEvents", [])
               if e.get("ph") == "X"
               and str(e.get("cat", "")).lower() in DEVICE_CATS]
        marks = [e for e in evs if MARKER in e.get("name", "")]
        if not marks:
            raise RuntimeError("the profiler's trace holds no marker "
                               f"kernel ({MARKER}); its clock cannot be "
                               "tied to the host's")
        offset = self.mark_host - float(marks[0]["ts"]) / 1e6
        self.window = (t0, t1)
        for e in evs:
            a = float(e["ts"]) / 1e6 + offset
            b = a + float(e.get("dur", 0.0)) / 1e6
            a, b = max(a, t0), min(b, t1)
            if b > a and MARKER not in e["name"]:
                self.events.append((short_name(e["name"]), a, b))
                self.raw_names.add(e["name"][:120])
        return self

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in union([(a, b)
                                            for _n, a, b in self.events]))

    def gaps(self) -> List[Tuple[float, float]]:
        t0, t1 = self.window
        out, at = [], t0
        for a, b in union([(a, b) for _n, a, b in self.events]):
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if t1 > at:
            out.append((at, t1))
        return out

    def device_time(self, names) -> float:
        """Seconds of the events whose short name holds one of `names`."""
        return sum(b - a for n, a, b in self.events
                   if any(k in n for k in names))

    def ops(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n, a, b in self.events:
            out[n] = out.get(n, 0.0) + (b - a)
        return out

    def name_gap(self, g0: float, g1: float, ctx) -> str:
        """What the host was doing in a gap: a garbage collection, or the
        eval phase that covers the most of it, where one covers a quarter
        or more; else `schedule` (its self time: reconcile and compile),
        which spans every eval's whole trip through the batch; else
        `none`."""
        cover: Dict[str, List] = {}
        for spans in ctx.all_spans.values():
            for phase, a, b in spans:
                if phase not in _NOT_HOST_WORK and b > g0 and a < g1:
                    cover.setdefault(phase, []).append((a, b))
        for gen, a, b in ctx.gc:
            if b > g0 and a < g1:
                cover.setdefault(f"gc.gen{gen}", []).append((a, b))
        share = {name: overlap(g0, g1, union(ivs)) / (g1 - g0)
                 for name, ivs in cover.items()}
        gcs = [k for k in share if k.startswith("gc.") and share[k] >= 0.25]
        if gcs:
            return max(gcs, key=share.get)
        rest = [k for k in share if k != "schedule" and share[k] >= 0.25]
        if rest:
            return max(rest, key=share.get)
        return "schedule" if share.get("schedule") else "none"

    def breakdown(self, ctx, n: int = 10) -> Dict:
        ops = sorted(self.ops().items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[self.name_gap(a, b, ctx), b - a]
                              for a, b in gaps]}

    def longest_gap(self) -> Optional[float]:
        gaps = self.gaps()
        return max((b - a for a, b in gaps), default=None)
