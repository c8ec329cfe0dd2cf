"""Eval-lifecycle span tracer.

Each evaluation's trip through the control plane — broker enqueue →
dequeue → worker claim → snapshot resolution → batch pack → kernel
dispatch → plan apply → ack — is recorded as monotonic-clock spans
keyed by the eval id (the trace id). Queryable per eval via
`/v1/evaluation/:id/trace` and aggregated into per-phase latency
histograms on the owning registry (`eval.phase.<name>_ms`), so perf
work targets the measured bottleneck instead of the suspected one.

The reference has no per-eval tracer; the span taxonomy maps its
structures 1:1 — `queue_wait` is eval_broker.go Enqueue→Dequeue,
`plan_apply` is worker.go SubmitPlan→applyPlan, `ack` Ack. Traces live
in a bounded LRU (evictions are telemetry loss, never an error), and
every recorder is a no-op for ids the tracer never saw enqueued, so
cold paths (restored evals, tests driving the broker directly) cost a
dict miss.

Phase taxonomy (what each span bounds):

- `queue_wait`  broker enqueue → worker dequeue (queue depth + serialization)
- `claim`       dequeue → scheduler start (batch drain + thread handoff)
- `snapshot`    state.snapshot_min_index (MVCC view resolution)
- `schedule`    scheduler process() total (reconcile + compile + select + plan)
- `pack`        coordinator param stack/pack (host-side batch prep)
- `delta_apply` device cluster-view refresh at dispatch (delta row
                update or full upload — TPUStack.device_arrays)
- `kernel`      fused placement-kernel dispatch (device + transfer)
- `plan_apply`  submit_plan → PlanResult (queue hop + verify + commit)
- `ack`         broker ack/nack point (zero-length terminator)
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

from .metrics import MetricsRegistry
from .tracectx import SpanStore, TraceContext, new_span_id

#: canonical span order for display/aggregation
PHASES = ("queue_wait", "claim", "snapshot", "schedule", "pack",
          "delta_apply", "kernel", "plan_apply", "ack")


class _Trace:
    __slots__ = ("spans", "marks", "wall_anchor", "mono_anchor", "ctx")

    def __init__(self) -> None:
        self.spans: List[Dict] = []
        self.marks: Dict[str, float] = {}
        self.wall_anchor = time.time()
        self.mono_anchor = time.monotonic()
        #: distributed-trace binding: the eval's own span
        #: context, bound once at broker enqueue from the ingress-
        #: minted ids riding the Evaluation struct. When set, every
        #: phase span this tracer records is mirrored into the process
        #: SpanStore as `eval.<phase>`, parented under the eval span.
        self.ctx: "TraceContext | None" = None


class EvalTracer:
    """Bounded, thread-safe per-eval span store + phase histograms."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 capacity: int = 512,
                 spans: Optional[SpanStore] = None,
                 source: str = "") -> None:
        self.registry = registry
        self.capacity = max(int(capacity), 1)
        self.spans = spans
        self.source = source
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, _Trace]" = OrderedDict()

    # ---- recording ----

    def begin(self, trace_id: str) -> None:
        """Start (or refresh) a trace — called at broker enqueue."""
        with self._lock:
            tr = self._traces.get(trace_id)
            if tr is None:
                tr = self._traces[trace_id] = _Trace()
                while len(self._traces) > self.capacity:
                    self._traces.popitem(last=False)
            else:
                self._traces.move_to_end(trace_id)
            tr.marks["enqueue"] = time.monotonic()

    def bind(self, trace_id: str, ctx: Optional[TraceContext]) -> None:
        """Attach the eval's distributed span context (first bind wins
        — nack redeliveries must not re-parent an in-flight trace;
        no-op for unknown ids or a None ctx)."""
        if ctx is None:
            return
        with self._lock:
            tr = self._traces.get(trace_id)
            if tr is not None and tr.ctx is None:
                tr.ctx = ctx

    def binding(self, trace_id: str) -> Optional[TraceContext]:
        with self._lock:
            tr = self._traces.get(trace_id)
            return tr.ctx if tr is not None else None

    def emit_root(self, trace_id: str) -> None:
        """Record the eval's ROOT span (enqueue anchor → now) into the
        SpanStore — called once at the terminal ack/fail point, after
        the final phase span mirrored."""
        with self._lock:
            tr = self._traces.get(trace_id)
            if tr is None or tr.ctx is None:
                return
            ctx, wall0 = tr.ctx, tr.wall_anchor
        if self.spans is not None:
            self.spans.record(
                "eval", trace_id=ctx.trace_id, span_id=ctx.span_id,
                parent_span_id=ctx.parent_span_id, start_unix=wall0,
                end_unix=time.time(), source=self.source,
                detail={"eval_id": trace_id})

    def mark(self, trace_id: str, name: str) -> None:
        """Store a named monotonic timestamp (no-op for unknown ids)."""
        with self._lock:
            tr = self._traces.get(trace_id)
            if tr is not None:
                tr.marks[name] = time.monotonic()

    def record(self, trace_id: str, phase: str,
               start: Optional[float] = None,
               end: Optional[float] = None) -> None:
        """Append a span; monotonic start/end default to now (a
        zero-length point span). Feeds the phase histogram either way."""
        now = time.monotonic()
        start = now if start is None else start
        end = now if end is None else end
        dur_ms = max(end - start, 0.0) * 1e3
        if self.registry is not None:
            self.registry.add_sample(f"eval.phase.{phase}_ms", dur_ms)
        with self._lock:
            tr = self._traces.get(trace_id)
            if tr is None:
                return
            tr.spans.append({"phase": phase, "start": start, "end": end})
            ctx = tr.ctx
            # monotonic → wall against the trace's anchors, so the
            # mirrored span lines up with spans from other processes
            wall0 = tr.wall_anchor + (start - tr.mono_anchor)
            wall1 = tr.wall_anchor + (end - tr.mono_anchor)
        if ctx is not None and self.spans is not None:
            self.spans.record(
                "eval." + phase, trace_id=ctx.trace_id,
                span_id=new_span_id(), parent_span_id=ctx.span_id,
                start_unix=wall0, end_unix=wall1, source=self.source,
                detail={"eval_id": trace_id})

    def span_from_mark(self, trace_id: str, mark: str, phase: str) -> None:
        """Record `phase` spanning the stored mark → now (no-op when the
        mark is missing — the eval predates the tracer)."""
        with self._lock:
            tr = self._traces.get(trace_id)
            start = tr.marks.get(mark) if tr is not None else None
        if start is not None:
            self.record(trace_id, phase, start=start)

    def span(self, trace_id: str, phase: str) -> "_SpanCtx":
        return _SpanCtx(self, trace_id, phase)

    # ---- querying ----

    def get(self, trace_id: str) -> Optional[Dict]:
        """Ordered span view: offsets are seconds since the trace's
        enqueue anchor (monotonic deltas stamped onto a wall anchor)."""
        with self._lock:
            tr = self._traces.get(trace_id)
            if tr is None:
                return None
            spans = [dict(s) for s in tr.spans]
            anchor_mono = tr.mono_anchor
            anchor_wall = tr.wall_anchor
        spans.sort(key=lambda s: (s["start"], s["end"]))
        out = []
        for s in spans:
            out.append({
                "phase": s["phase"],
                "start_s": round(s["start"] - anchor_mono, 6),
                "duration_ms": round((s["end"] - s["start"]) * 1e3, 3),
            })
        return {"trace_id": trace_id, "anchor_unix": round(anchor_wall, 3),
                "spans": out}

    def trace_ids(self) -> List[str]:
        with self._lock:
            return list(self._traces)


class _SpanCtx:
    __slots__ = ("tracer", "trace_id", "phase", "_t0")

    def __init__(self, tracer: EvalTracer, trace_id: str, phase: str):
        self.tracer = tracer
        self.trace_id = trace_id
        self.phase = phase
        self._t0 = 0.0

    def __enter__(self) -> "_SpanCtx":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        self.tracer.record(self.trace_id, self.phase, start=self._t0)
