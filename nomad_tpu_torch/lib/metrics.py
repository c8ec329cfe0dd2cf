"""Telemetry — metrics registry + sinks (the go-metrics analog).

Behavioral reference: `command/agent/command.go:952-1012` setupTelemetry
(armon/go-metrics with inmem + statsd/statsite sinks) and go-metrics'
`IncrCounter` / `SetGauge` / `AddSample` API:

- `MetricsRegistry` — thread-safe counters, gauges and sliding-window
  histograms (the inmem sink's aggregates, served on `/v1/metrics`).
  Subsystems (eval broker, worker, plan applier, RPC transport) record
  through a registry instead of ad-hoc unlocked dicts; histograms carry
  p50/p95/p99 over a bounded sample window like go-metrics'
  `AggregateSample` + quantile math.
- `StatsdSink` / `TelemetryEmitter` — the push side: a background
  emitter flattens the metrics tree to `gauge` lines and ships them
  over UDP statsd (`nomad.<path>:<value>|g`) at an interval.
- `ErrorStreak` — the sanctioned thread-loop failure sink: counts every
  swallowed exception in a registry counter and logs the FIRST failure
  of a streak at WARNING (the rest at DEBUG), so a permanently wedged
  loop leaves a visible trace without spamming a line per tick
  (task_runner._template_watch precedent; burns NLT03 findings).
"""
from __future__ import annotations

import logging
import math
import socket
import threading
from typing import Callable, Dict, List, Optional


def escape_label_value(value: str) -> str:
    """Prometheus text-format label-value escaping (exposition format
    spec): backslash, double-quote, and line-feed are the only three
    characters with escapes — in THAT order, or an embedded `\\` in the
    input would corrupt the escapes added after it."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def prometheus_line(name: str, labels: Dict[str, str], value: float) -> str:
    """One labeled sample line (`name{k="v",...} value`). Label VALUES
    are escaped; names are the caller's contract (the ledger uses fixed
    keys). Shared by the labeled exposers (lib/transfer.py ledger) so
    the escaping lives — and is tested — in exactly one place."""
    if labels:
        body = ",".join(f'{k}="{escape_label_value(v)}"'
                        for k, v in sorted(labels.items()))
        return f"{name}{{{body}}} {value:g}"
    return f"{name} {value:g}"


def flatten(tree: Dict, prefix: str = "nomad") -> Dict[str, float]:
    out: Dict[str, float] = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key))
        elif isinstance(v, bool):
            out[key] = 1.0 if v else 0.0
        elif isinstance(v, (int, float)):
            out[key] = float(v)
    return out


# ---- instruments ----


class Counter:
    """Monotonic counter (go-metrics IncrCounter)."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins gauge (go-metrics SetGauge)."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Sliding-window sample distribution (go-metrics AddSample).

    Keeps the most recent `window` samples in a ring plus lifetime
    count/sum/min/max; quantiles are computed over the current window
    (nearest-rank on a sorted copy — the window is small enough that a
    sort per query beats maintaining a digest)."""

    __slots__ = ("_lock", "_ring", "_idx", "_full", "count", "sum",
                 "min", "max")

    def __init__(self, window: int = 1024) -> None:
        self._lock = threading.Lock()
        self._ring: List[float] = [0.0] * max(int(window), 1)
        self._idx = 0
        self._full = False
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def add(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._ring[self._idx] = v
            self._idx += 1
            if self._idx >= len(self._ring):
                self._idx = 0
                self._full = True
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    # go-metrics spelling, so call sites read like the reference
    add_sample = add

    def _window(self) -> List[float]:
        if self._full:
            return list(self._ring)
        return self._ring[: self._idx]

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile over the current window (0 when empty)."""
        with self._lock:
            win = self._window()
        if not win:
            return 0.0
        win.sort()
        rank = min(len(win) - 1, max(0, math.ceil(q * len(win)) - 1))
        return win[rank]

    def summary(self) -> Dict[str, float]:
        with self._lock:
            win = self._window()
            count, total = self.count, self.sum
            mn = self.min if self.count else 0.0
            mx = self.max if self.count else 0.0
        win.sort()

        def rank(q: float) -> float:
            if not win:
                return 0.0
            return win[min(len(win) - 1, max(0, math.ceil(q * len(win)) - 1))]

        return {
            "count": count,
            "sum": round(total, 6),
            "mean": round(total / count, 6) if count else 0.0,
            "min": mn,
            "max": mx,
            "p50": rank(0.50),
            "p95": rank(0.95),
            "p99": rank(0.99),
        }


class MetricsRegistry:
    """Named instruments behind one lookup lock; every instrument is
    itself thread-safe, so hot paths hold no shared lock while
    recording. Names are dotted paths (`broker.acked`,
    `eval.phase.kernel_ms`)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    # -- lookup (auto-vivifying) --

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            return g

    def histogram(self, name: str, window: int = 1024) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(window)
            return h

    # -- convenience recorders (go-metrics verbs) --

    def inc(self, name: str, n: float = 1.0) -> None:
        self.counter(name).inc(n)

    def set_gauge(self, name: str, v: float) -> None:
        self.gauge(name).set(v)

    def add_sample(self, name: str, v: float) -> None:
        self.histogram(name).add(v)

    def counters(self, prefix: str = "") -> Dict[str, float]:
        """{name: value} for counters under `prefix` (name relative to
        it) — the compatibility surface for legacy `stats` dicts."""
        with self._lock:
            items = list(self._counters.items())
        out: Dict[str, float] = {}
        for name, c in items:
            if prefix and not name.startswith(prefix):
                continue
            v = c.value
            out[name[len(prefix):]] = int(v) if v == int(v) else v
        return out

    # -- export --

    def snapshot(self) -> Dict[str, object]:
        """Nested export for `/v1/metrics` (and statsd flatten())."""
        with self._lock:
            counters = list(self._counters.items())
            gauges = list(self._gauges.items())
            hists = list(self._histograms.items())
        out: Dict[str, object] = {}
        for name, c in counters:
            v = c.value
            out.setdefault("counters", {})[name] = \
                int(v) if v == int(v) else v
        for name, g in gauges:
            out.setdefault("gauges", {})[name] = g.value
        for name, h in hists:
            out.setdefault("histograms", {})[name] = h.summary()
        return out

    def prometheus(self, prefix: str = "nomad") -> str:
        """Prometheus text exposition (the reference's `telemetry {
        prometheus_metrics = true }` endpoint shape): counters as
        `counter`, gauges as `gauge`, histograms as `summary` with
        quantile labels + `_sum`/`_count`."""

        def mangle(name: str) -> str:
            safe = "".join(ch if (ch.isalnum() or ch == "_") else "_"
                           for ch in name)
            return f"{prefix}_{safe}" if prefix else safe

        lines: List[str] = []
        snap = self.snapshot()
        for name, v in sorted(snap.get("counters", {}).items()):
            m = mangle(name)
            lines.append(f"# TYPE {m} counter")
            lines.append(f"{m} {float(v):g}")
        for name, v in sorted(snap.get("gauges", {}).items()):
            m = mangle(name)
            lines.append(f"# TYPE {m} gauge")
            lines.append(f"{m} {float(v):g}")
        for name, s in sorted(snap.get("histograms", {}).items()):
            m = mangle(name)
            lines.append(f"# TYPE {m} summary")
            for q in ("0.5", "0.95", "0.99"):
                key = "p" + str(int(float(q) * 100))
                lines.append(f'{m}{{quantile="{q}"}} {s[key]:g}')
            lines.append(f"{m}_sum {s['sum']:g}")
            lines.append(f"{m}_count {s['count']}")
        return "\n".join(lines) + ("\n" if lines else "")


_default_registry = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """Process-global registry (go-metrics' global sink): the home for
    telemetry from components with no owning Server — RPC transport,
    client-side manager loops. Server-owned subsystems use the server's
    own registry so multi-server tests don't cross-count."""
    return _default_registry


class ErrorStreak:
    """Registry error counter + first-of-streak WARNING log for thread
    loops that must survive failures (the task_runner watcher pattern).

    `record()` in the `except`; `ok()` on any success to re-arm the
    WARNING for the next streak."""

    def __init__(self, name: str, registry: Optional[MetricsRegistry] = None,
                 logger: Optional[logging.Logger] = None) -> None:
        self.name = name
        self._counter = (registry or default_registry()).counter(
            f"loop_errors.{name}")
        self._log = logger or logging.getLogger("nomad_tpu.loops")
        self._lock = threading.Lock()
        self._streak = 0

    def record(self, exc: BaseException, what: str = "") -> None:
        self._counter.inc()
        with self._lock:
            self._streak += 1
            first = self._streak == 1
        (self._log.warning if first else self._log.debug)(
            "%s: %s failed: %s: %s", self.name, what or "loop pass",
            type(exc).__name__, exc)
        if first:
            # first-of-streak → flight event: a wedged loop becomes part
            # of the operator-debug narrative, not just a counter.
            # Lazy import — flight.py imports this module for its
            # registry mirror.
            from .flight import default_flight

            try:
                default_flight().record(
                    "error.streak", key=self.name, severity="warn",
                    detail={"what": what or "loop pass",
                            "error": f"{type(exc).__name__}: {exc}"})
            except Exception:  # noqa: BLE001 — telemetry must not kill
                pass

    def ok(self) -> None:
        with self._lock:
            self._streak = 0

    @property
    def count(self) -> int:
        return int(self._counter.value)


class StatsdSink:
    """UDP statsd gauge emitter (go-metrics statsd sink)."""

    def __init__(self, addr: str) -> None:
        host, _, port = addr.partition(":")
        self.addr = (host, int(port or 8125))
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def emit(self, gauges: Dict[str, float]) -> None:
        lines = [f"{k}:{v:g}|g" for k, v in sorted(gauges.items())]
        payload = "\n".join(lines).encode()
        try:
            self._sock.sendto(payload, self.addr)
        except OSError:
            pass  # telemetry is best-effort

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


class TelemetryEmitter:
    """Periodic collector→sink pump (setupTelemetry's inmem fanout)."""

    def __init__(self, collect: Callable[[], Dict], sink: StatsdSink,
                 interval: float = 10.0) -> None:
        self.collect = collect
        self.sink = sink
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run,
                                        name="telemetry", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self.sink.close()

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.sink.emit(flatten(self.collect()))
            except Exception:  # noqa: BLE001 — telemetry must not kill
                pass
