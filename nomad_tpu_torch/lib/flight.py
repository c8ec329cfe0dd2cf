"""Control-plane flight recorder — a bounded ring of cluster EVENTS.

Behavioral reference: the reference ships no single event ring for
operator diagnosis, but `command/operator_debug.go` captures exactly
this class of signal (leader changes, plan rejections, wedged loops)
by scraping many surfaces after the fact. Here the signals are recorded
AS THEY HAPPEN into one process-wide ring, so a failover or a broker
backpressure episode is replayable after the fact from
`GET /v1/operator/flight` (and lands verbatim in the `operator debug`
bundle).

The ring is the proven `server/events.py` long-poll idiom: strictly
monotonic sequence numbers, `records_after(index)` never returns a
duplicate or an out-of-order event, wrap drops only the OLDEST events,
and a long-poller wakes on record instead of sleeping out its timeout
(pinned by the same no-lost/no-dup concurrency gate, tests/
test_flight.py).

Event TYPES are a closed vocabulary (`FLIGHT_TYPES`) — dashboards and
the debug-bundle reader key on them, so an unknown type is a
programming error (fail fast), not a new series leaking in silently.
Recording mirrors into the process registry (`flight.events` +
`flight.type.<type>` counters) so scrape-only consumers see event
RATES without reading the ring.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from ..analysis.vocab import FLIGHT_TYPES
from .metrics import MetricsRegistry, default_registry

#: the closed event-type vocabulary now lives in analysis/vocab.py (ONE
#: source of truth shared by this recorder, the exposition pins in
#: tests/test_metrics_names.py, and the NLV01 static vocabulary
#: ratchet). Adding a type there is a conscious taxonomy extension.
__all__ = ["FLIGHT_TYPES", "FlightRecorder", "default_flight"]


class FlightRecorder:
    """Bounded event ring + index long-poll (events.py semantics)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 capacity: int = 2048) -> None:
        self.registry = registry
        self._cv = threading.Condition()
        self._ring: "deque[dict]" = deque(maxlen=max(int(capacity), 2))
        self._seq = 0
        self._counts: Dict[str, int] = {}

    # ---- recording ----

    def record(self, type_: str, key: str = "", source: str = "",
               severity: str = "info",
               detail: Optional[dict] = None) -> int:
        """Append one event; returns its sequence number. `type_` must
        belong to FLIGHT_TYPES; `key` is the affected resource id (node,
        eval, lease token, member name), `source` the reporting server/
        site, `detail` a small JSON-able dict of context."""
        if type_ not in FLIGHT_TYPES:
            raise ValueError(f"unknown flight event type {type_!r} "
                             f"(vocabulary: {sorted(FLIGHT_TYPES)})")
        if severity not in ("info", "warn"):
            raise ValueError(f"invalid severity {severity!r}")
        with self._cv:
            self._seq += 1
            seq = self._seq
            self._ring.append({
                "seq": seq,
                "time_unix": round(time.time(), 3),
                "type": type_,
                "key": str(key),
                "source": str(source),
                "severity": severity,
                "detail": dict(detail or {}),
            })
            self._counts[type_] = self._counts.get(type_, 0) + 1
            self._cv.notify_all()
        if self.registry is not None:
            self.registry.inc("flight.events")
            self.registry.inc(f"flight.type.{type_}")
        return seq

    # ---- querying ----

    def records_after(self, index: int,
                      types: Optional[Sequence[str]] = None,
                      timeout: float = 0.0) -> Tuple[int, List[dict]]:
        """Events with seq > `index`, type-filtered; blocks up to
        `timeout` when none are ready (the /v1/event/stream long-poll
        half). Returns (last_seq, events) — events are dict COPIES, safe
        to serialize off-thread."""
        deadline = time.time() + timeout
        tset = set(types) if types else None
        while True:
            with self._cv:
                out = [dict(e) for e in self._ring
                       if e["seq"] > index
                       and (tset is None or e["type"] in tset)]
                if out or timeout <= 0:
                    return self._seq, out
                remaining = deadline - time.time()
                if remaining <= 0:
                    return self._seq, []
                self._cv.wait(min(remaining, 1.0))

    def last_index(self) -> int:
        with self._cv:
            return self._seq

    def snapshot(self, limit: int = 256) -> List[dict]:
        """The newest `limit` retained events (debug-bundle capture)."""
        with self._cv:
            recs = list(self._ring)
        return [dict(e) for e in recs[-max(int(limit), 0):]]

    def counts(self) -> Dict[str, int]:
        """Lifetime per-type event counts (survive ring eviction)."""
        with self._cv:
            return dict(self._counts)


_default_flight = FlightRecorder(registry=default_registry())


def default_flight() -> FlightRecorder:
    """Process-global recorder (the transfer/HBM-ledger convention):
    the home for events from components with no owning Server — raft
    nodes, ErrorStreak sinks, the HBM ledger. Events carry a `source`
    so co-hosted servers (in-process cluster tests) stay tellable
    apart."""
    return _default_flight
