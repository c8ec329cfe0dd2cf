"""Cross-process trace context + span store + scheduling SLOs.

The ninth telemetry layer. The eight before it are
per-process islands: the EvalTracer's spans, the DispatchTimeline, and
the flight recorder each see ONE server, so a job submitted through a
follower, forwarded to the leader, scheduled by a worker, committed via
raft, and started on a client leaves five disconnected fragments with
no shared causal id. This module supplies the shared id — a W3C
traceparent-style `TraceContext` (trace_id, span_id, parent_span_id)
minted at the ingress edge (`agent/http.py`), carried on a thread-local
so the RPC transport can inject it into the frame envelope and restore
it handler-side, and bound to evals/plans/allocs so every hop's spans
parent into one tree. The reference propagates no trace context at all
(`nomad/rpc.go` forwarding); this is Dapper/OpenTelemetry-style context
propagation grown onto the repo's existing long-poll telemetry idioms.

Three replica-determinism ground rules (NLR01–04 are hard constraints):

* trace/span ids are minted ONLY ingress-side (HTTP edge, RPC client
  hop, broker enqueue) or LEADER-side stamped onto the raft entry like
  `now=` — never inside FSM apply;
* ids come from `utils.fast_uuid` (module-cached PRNG seeded once from
  os.urandom) — no per-call getrandom(2) on the submit path, and the
  NLR02-clean discipline the scheduler already uses for eval/alloc ids;
* the `SpanStore` is pure telemetry OUTSIDE the state store: eviction
  is telemetry loss, never an error, and nothing in `structs/` or the
  FSM reads it.

`SpanStore` is the flight-recorder shape verbatim (bounded ring,
strictly monotonic seq, `spans_after` long-poll per events.py — no
dup, no loss, wrap drops oldest) with span names closed over
`analysis/vocab.SPAN_NAMES` and a runtime NLS01 belt: a span detail
carrying anything secret-shaped is a programming error, fail fast.

`SloTracker` turns the unified trace into per-priority scheduling SLOs:
submit→alloc-start latency objectives per priority band (high ≥ 70,
normal 30–69, low < 30; targets via `NOMAD_TPU_SLO_<BAND>_MS`),
attainment + error-budget-remaining gauges, latency summaries (p99 by
band), and a Google-SRE-style multiwindow burn-rate evaluator that
records a `slo.burn` flight event when budget consumption crosses the
fast- or slow-window threshold (edge-triggered; re-arms when the rate
falls back under).
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Deque, Dict, Iterator, List, Optional, Tuple

from ..analysis.vocab import SPAN_NAMES
from ..utils import fast_uuid
from .metrics import MetricsRegistry, default_registry

__all__ = [
    "TraceContext", "current", "set_current", "use", "mint",
    "new_trace_id", "new_span_id", "parse_traceparent",
    "format_traceparent", "trace_enabled", "SpanStore", "default_spans",
    "SloTracker", "SLO_BANDS", "slo_band",
]


def trace_enabled() -> bool:
    """Tracing kill switch (`NOMAD_TPU_TRACE=0`) — the bench A/B lever
    for measuring trace overhead. Read per call: cheap, and lets one
    process flip it between bench phases."""
    return os.environ.get("NOMAD_TPU_TRACE", "1") != "0"


# ---- ids + context ---------------------------------------------------------

def new_trace_id() -> str:
    """32-hex trace id (W3C trace-id width) off the seeded PRNG."""
    return fast_uuid().replace("-", "")


def new_span_id() -> str:
    """16-hex span id (W3C parent-id width) off the seeded PRNG."""
    return fast_uuid().replace("-", "")[:16]


@dataclass(frozen=True)
class TraceContext:
    """One hop's position in a distributed trace. Immutable — crossing
    a boundary mints a `child()`, it never mutates in place."""

    trace_id: str
    span_id: str
    parent_span_id: str = ""

    def child(self) -> "TraceContext":
        """New context one level down: same trace, fresh span id,
        parented under this span."""
        return TraceContext(self.trace_id, new_span_id(), self.span_id)

    def to_wire(self) -> Dict[str, str]:
        """Compact frame-envelope form (rpc/transport.py `ctx` slot)."""
        return {"t": self.trace_id, "s": self.span_id,
                "p": self.parent_span_id}

    @staticmethod
    def from_wire(d: object) -> Optional["TraceContext"]:
        """Parse a frame `ctx` slot; malformed input is a None, never
        an exception — a bad peer must not kill the serve loop."""
        if not isinstance(d, dict):
            return None
        tid, sid = d.get("t"), d.get("s")
        if not isinstance(tid, str) or not isinstance(sid, str) \
                or not tid or not sid:
            return None
        parent = d.get("p", "")
        return TraceContext(tid, sid,
                            parent if isinstance(parent, str) else "")


def mint(parent: Optional[TraceContext] = None) -> TraceContext:
    """Fresh root context, or a child when continuing an inbound trace
    (the SDK's `traceparent` header)."""
    if parent is not None:
        return parent.child()
    return TraceContext(new_trace_id(), new_span_id(), "")


def parse_traceparent(header: object) -> Optional[TraceContext]:
    """W3C `traceparent` → context (`00-<32hex>-<16hex>-<2hex>`).
    Anything malformed — wrong field widths, non-hex, all-zero ids —
    is None: the ingress then mints a fresh root instead of trusting
    garbage."""
    if not isinstance(header, str):
        return None
    parts = header.strip().lower().split("-")
    if len(parts) != 4:
        return None
    ver, tid, sid, flags = parts
    if len(ver) != 2 or len(tid) != 32 or len(sid) != 16 \
            or len(flags) != 2:
        return None
    try:
        int(ver, 16), int(tid, 16), int(sid, 16), int(flags, 16)
    except ValueError:
        return None
    if ver == "ff" or tid == "0" * 32 or sid == "0" * 16:
        return None
    return TraceContext(tid, sid, "")


def format_traceparent(ctx: TraceContext) -> str:
    return f"00-{ctx.trace_id}-{ctx.span_id}-01"


# ---- thread-local propagation ----------------------------------------------

_tls = threading.local()


def current() -> Optional[TraceContext]:
    """The context bound to this thread (None outside any trace)."""
    return getattr(_tls, "ctx", None)


def set_current(ctx: Optional[TraceContext]) -> None:
    _tls.ctx = ctx


@contextmanager
def use(ctx: Optional[TraceContext]) -> Iterator[Optional[TraceContext]]:
    """Bind `ctx` for the dynamic extent; restores the previous binding
    even on exception (the RPC handler's restore-then-clear path)."""
    prev = current()
    set_current(ctx)
    try:
        yield ctx
    finally:
        set_current(prev)


# ---- span store ------------------------------------------------------------

class SpanStore:
    """Bounded ring of finished spans + index long-poll.

    The flight-recorder/events.py contract: strictly monotonic `seq`,
    `spans_after(index)` never returns a duplicate or an out-of-order
    span, wrap drops only the OLDEST spans, and a long-poller wakes on
    record instead of sleeping out its timeout. Span names are a closed
    vocabulary (`analysis/vocab.SPAN_NAMES`) — the waterfall renderer
    and the cross-server stitcher key on them, so an unknown name is a
    programming error, not a new taxonomy leaking in silently."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 capacity: int = 4096) -> None:
        self.registry = registry
        self._cv = threading.Condition()
        self._ring: "deque[dict]" = deque(maxlen=max(int(capacity), 2))
        self._seq = 0
        self._counts: Dict[str, int] = {}

    # -- recording --

    def record(self, name: str, *, trace_id: str, span_id: str,
               parent_span_id: str = "",
               start_unix: Optional[float] = None,
               end_unix: Optional[float] = None,
               source: str = "", detail: Optional[dict] = None) -> int:
        """Append one FINISHED span; returns its sequence number.
        `start_unix`/`end_unix` are wall-clock seconds (monotonic spans
        get converted against their trace's wall anchor before landing
        here); both default to now — a zero-length point span."""
        if name not in SPAN_NAMES:
            raise ValueError(f"unknown span name {name!r} "
                             f"(vocabulary: {sorted(SPAN_NAMES)})")
        detail = dict(detail or {})
        for k in detail:
            if "secret" in str(k).lower():
                # NLS01 runtime belt: traces are an operator-readable,
                # cross-process surface — secrets never ride them
                raise ValueError(
                    f"span detail key {k!r} is secret-shaped; spans "
                    f"must not carry secrets")
        now = time.time()
        start = now if start_unix is None else float(start_unix)
        end = start if end_unix is None else float(end_unix)
        with self._cv:
            self._seq += 1
            seq = self._seq
            self._ring.append({
                "seq": seq,
                "name": name,
                "trace_id": str(trace_id),
                "span_id": str(span_id),
                "parent_span_id": str(parent_span_id),
                "start_unix": round(start, 6),
                "duration_ms": round(max(end - start, 0.0) * 1e3, 3),
                "source": str(source),
                "detail": detail,
            })
            self._counts[name] = self._counts.get(name, 0) + 1
            self._cv.notify_all()
        if self.registry is not None:
            self.registry.inc("trace.spans")
        return seq

    # -- querying --

    def spans_after(self, index: int, trace_id: Optional[str] = None,
                    timeout: float = 0.0) -> Tuple[int, List[dict]]:
        """Spans with seq > `index` (optionally one trace only); blocks
        up to `timeout` when none are ready. Returns (last_seq, spans)
        — dict copies, safe to serialize off-thread."""
        deadline = time.time() + timeout
        while True:
            with self._cv:
                out = [dict(s) for s in self._ring
                       if s["seq"] > index
                       and (trace_id is None
                            or s["trace_id"] == trace_id)]
                if out or timeout <= 0:
                    return self._seq, out
                remaining = deadline - time.time()
                if remaining <= 0:
                    return self._seq, []
                self._cv.wait(min(remaining, 1.0))

    def for_trace(self, trace_id: str) -> List[dict]:
        """All retained spans of one trace, oldest first (the
        `GET /v1/trace/:trace_id` body)."""
        with self._cv:
            return [dict(s) for s in self._ring
                    if s["trace_id"] == trace_id]

    def last_index(self) -> int:
        with self._cv:
            return self._seq

    def snapshot(self, limit: int = 256) -> List[dict]:
        """The newest `limit` retained spans (debug-bundle capture)."""
        with self._cv:
            recs = list(self._ring)
        return [dict(s) for s in recs[-max(int(limit), 0):]]

    def counts(self) -> Dict[str, int]:
        """Lifetime per-name span counts (survive ring eviction)."""
        with self._cv:
            return dict(self._counts)


_default_spans = SpanStore(registry=default_registry())


def default_spans() -> SpanStore:
    """Process-global span store (the flight-recorder convention): one
    ring per PROCESS, spans carry a `source` so co-hosted servers in
    in-process cluster tests stay tellable apart. The agent serves it
    at `GET /v1/trace/:trace_id` and folds it into `operator debug`."""
    return _default_spans


# ---- scheduling SLOs -------------------------------------------------------

#: priority bands, highest first (render/aggregation order)
SLO_BANDS = ("high", "normal", "low")

_DEFAULT_TARGET_MS = {"high": 2000.0, "normal": 5000.0, "low": 15000.0}


def slo_band(priority: int) -> str:
    """Priority → band: high ≥ 70, low < 30, else normal (the repo's
    existing broker priority convention)."""
    p = int(priority)
    if p >= 70:
        return "high"
    if p < 30:
        return "low"
    return "normal"


class SloTracker:
    """Per-priority-band submit→alloc-start SLOs + burn-rate alerting.

    Attainment is lifetime met/total per band; error-budget remaining
    is `1 − (1 − attainment) / (1 − objective)` (1.0 untouched, 0.0
    exactly spent, negative when overspent — deliberately unclamped so
    the gauge shows HOW overspent). Burn rate over a window is
    `fail_fraction(window) / (1 − objective)` — the Google SRE
    multiwindow shape: a fast window (default 5 min, threshold 14.4×)
    catches sharp regressions, a slow window (default 1 h, threshold
    6×) catches sustained leaks. Each (band, window) alert is
    edge-triggered with re-arm, so a sustained burn records ONE
    `slo.burn` flight event per excursion, not one per observation.

    `observe(..., now=)` takes an injectable clock so the SLO math is
    pinned exactly in tests (tier-1, no sleeps)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 flight=None, source: str = "",
                 env: Optional[Dict[str, str]] = None) -> None:
        e = os.environ if env is None else env
        self.registry = registry
        self.flight = flight
        self.source = source
        self.objective = min(max(float(
            e.get("NOMAD_TPU_SLO_OBJECTIVE", "0.99")), 0.0), 0.999999)
        self.target_ms = {
            b: float(e.get(f"NOMAD_TPU_SLO_{b.upper()}_MS",
                           str(_DEFAULT_TARGET_MS[b])))
            for b in SLO_BANDS}
        self.fast_window_s = float(e.get("NOMAD_TPU_SLO_FAST_S", "300"))
        self.slow_window_s = float(e.get("NOMAD_TPU_SLO_SLOW_S", "3600"))
        self.fast_burn = float(e.get("NOMAD_TPU_SLO_FAST_BURN", "14.4"))
        self.slow_burn = float(e.get("NOMAD_TPU_SLO_SLOW_BURN", "6.0"))
        self._lock = threading.Lock()
        self._obs: Dict[str, Deque[Tuple[float, bool]]] = {
            b: deque() for b in SLO_BANDS}
        self._met = {b: 0 for b in SLO_BANDS}
        self._total = {b: 0 for b in SLO_BANDS}
        self._armed = {(b, w): True
                       for b in SLO_BANDS for w in ("fast", "slow")}
        if registry is not None:
            # pre-create every promised series so the exposition pins
            # hold on an agent that never placed an alloc: attainment
            # and budget start FULL (no data is not a violation)
            registry.counter("slo.observations")
            for b in SLO_BANDS:
                registry.set_gauge("slo.attainment." + b, 1.0)
                registry.set_gauge("slo.budget_remaining." + b, 1.0)
                registry.histogram("slo.latency." + b + "_ms")

    def observe(self, priority: int, latency_ms: float,
                now: Optional[float] = None) -> dict:
        """Record one submit→alloc-start latency; returns the updated
        band view (the bench tail and the pinned-math tests read it)."""
        now = time.time() if now is None else float(now)
        band = slo_band(priority)
        ok = float(latency_ms) <= self.target_ms[band]
        budget = 1.0 - self.objective
        burns: List[dict] = []
        with self._lock:
            dq = self._obs[band]
            dq.append((now, ok))
            cutoff = now - self.slow_window_s
            while dq and dq[0][0] < cutoff:
                dq.popleft()
            self._total[band] += 1
            if ok:
                self._met[band] += 1
            attainment = self._met[band] / self._total[band]
            budget_remaining = 1.0 - (1.0 - attainment) / budget
            rates: Dict[str, float] = {}
            for wname, wsec, thresh in (
                    ("fast", self.fast_window_s, self.fast_burn),
                    ("slow", self.slow_window_s, self.slow_burn)):
                wobs = [o for o in dq if o[0] >= now - wsec]
                fails = sum(1 for o in wobs if not o[1])
                rate = (fails / len(wobs)) / budget if wobs else 0.0
                rates[wname] = rate
                if rate >= thresh:
                    if self._armed[(band, wname)]:
                        self._armed[(band, wname)] = False
                        burns.append({
                            "window": wname,
                            "burn_rate": round(rate, 3),
                            "threshold": thresh,
                            "observations": len(wobs),
                        })
                else:
                    self._armed[(band, wname)] = True
        if self.registry is not None:
            self.registry.inc("slo.observations")
            self.registry.add_sample("slo.latency." + band + "_ms",
                                     float(latency_ms))
            self.registry.set_gauge("slo.attainment." + band, attainment)
            self.registry.set_gauge("slo.budget_remaining." + band,
                                    budget_remaining)
        if self.flight is not None:
            for b in burns:
                detail = dict(b)
                detail["objective"] = self.objective
                self.flight.record("slo.burn", key=band,
                                   source=self.source, severity="warn",
                                   detail=detail)
        return {"band": band, "ok": ok, "target_ms": self.target_ms[band],
                "attainment": attainment,
                "budget_remaining": budget_remaining, "burn": rates,
                "fired": burns}

    def snapshot(self) -> dict:
        """Per-band SLO state (the bench `e2e_slo` tail + debug
        bundle): objective, target, totals, attainment, budget."""
        budget = 1.0 - self.objective
        out: Dict[str, dict] = {}
        with self._lock:
            for b in SLO_BANDS:
                total, met = self._total[b], self._met[b]
                att = met / total if total else 1.0
                out[b] = {
                    "objective": self.objective,
                    "target_ms": self.target_ms[b],
                    "total": total,
                    "met": met,
                    "attainment": round(att, 6),
                    "budget_remaining": round(
                        1.0 - (1.0 - att) / budget, 6),
                }
        return out
