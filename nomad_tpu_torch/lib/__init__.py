"""Shared low-level primitives mirroring the reference's `lib/` package:

- `DelayHeap`  — time-ordered heap of named waiters (ref `lib/delayheap/delay_heap.go`);
  consumers: eval-broker delayed evals, node-drainer deadlines.
- `KHeap`      — bounded top-K min-heap by score (ref `lib/kheap/score_heap.go`);
  consumer: `AllocMetric.PopulateScoreMetaData`.
- `CircBufWriter` — fixed-size circular write buffer with non-blocking flush
  (ref `lib/circbufwriter/writer.go`); consumer: task log capture (logmon).
- `TimeTable`  — wall-clock ↔ state-index mapping for GC thresholds
  (ref `nomad/timetable.go:14`); consumer: core GC scheduler.
- `MetricsRegistry` / `ErrorStreak` — thread-safe telemetry instruments
  (ref armon/go-metrics via command/agent/command.go setupTelemetry);
  consumers: broker/worker/plan-apply stats, thread-loop error sinks.
- `EvalTracer`  — per-eval lifecycle spans + phase histograms (no direct
  reference analog; see lib/trace.py); consumers: broker, worker,
  select coordinator, `/v1/evaluation/:id/trace`.
"""
from .delayheap import DelayHeap, WaitItem
from .kheap import KHeap
from .circbuf import CircBufWriter
from .metrics import ErrorStreak, MetricsRegistry, default_registry
from .timetable import TimeTable
from .trace import EvalTracer

__all__ = ["DelayHeap", "WaitItem", "KHeap", "CircBufWriter", "TimeTable",
           "MetricsRegistry", "ErrorStreak", "default_registry",
           "EvalTracer"]
