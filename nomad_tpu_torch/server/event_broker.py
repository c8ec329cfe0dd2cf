"""ClusterEventBroker — the FSM-sourced cluster event stream.

Behavioral reference: the event broker upstream shipped right after this
snapshot (`nomad/stream/event_broker.go`, `nomad/state/events.go`
eventsFromChanges) to replace blocking-query poll storms. The
placeholder it replaced is exactly this repo's seed state:
`nomad/event/event.go:12-13` EventPublisher.Publish is a no-op.

Where events come from
----------------------
The ONE place state changes are authoritative: the state-store write
API (`fsm.ALLOWED_OPS`), which every path converges on — single-server
endpoint writes, WAL-journaled writes, and the raft FSM apply on every
replica. `StateStore` calls `publish_entry(op, args, index)` for each
TOP-LEVEL applied op that advanced the index (state.py emit hook);
`events_for_entry` below derives the typed events as a PURE function of
(op, args, post-apply index):

* no clock, no entropy, no iteration over unordered sets — the
  derivation runs inside the apply path, so NLR01–NLR04 apply to it;
  timestamps and trace ids in payloads are the leader-minted fields
  already riding the structs (eval.modify_time, alloc.trace_id, …);
* event index == the state/raft apply index after the entry applied —
  all events of one entry share it, and delivery is batch-atomic, so
  index-based resume can never split an entry;
* all replicas derive byte-identical payloads for the same log prefix
  (`events_fingerprint`, gated by TestReplicaDeterminism);
* `Node` topic events serve the secret-redacted copy — the
  `structs.Node.secret_id` bearer field is popped from the wire tree
  before it can ride the stream (NLS01 guards the publish sink).

Delivery contract
-----------------
The bounded ring (`size` events) serves index-based resume: subscribe
from index N replays every buffered event with index > N, or delivers a
`lost-gap` marker first when N has been evicted. Live subscribers get
batches pushed into bounded per-subscriber queues; a slow subscriber
overflowing its queue has its OLDEST pending events evicted (counted in
`events.subscriber_evictions`) and sees a `lost-gap` marker at the next
poll — never silent loss, never duplicates.

The flight recorder (lib/flight.py) deliberately stays a SEPARATE ring:
it records replica-LOCAL operational signals (membership churn,
leadership, error streaks) that are not raft-log-derived and differ per
server, while this broker carries only replicated state transitions —
identical on every replica. Merging them would either leak
nondeterminism into the replicated stream or strip the flight ring of
its local-liveness signals (tests/test_events.py pins the separation).
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..structs.codec import to_wire
from .events import (Event, TOPIC_ALLOC, TOPIC_DEPLOYMENT, TOPIC_EVAL,
                     TOPIC_JOB, TOPIC_NODE)

TOPIC_PLAN = "Plan"

from ..analysis.vocab import EVENT_TOPICS, EVENT_TYPES  # noqa: E402

#: the stream-control marker type — NOT a state transition, so it lives
#: outside EVENT_TYPES: it marks a range of indexes the broker can no
#: longer replay (ring eviction, snapshot restore, queue eviction)
GAP_TYPE = "lost-gap"

#: ops (⊆ fsm.ALLOWED_OPS) that source events; everything else (ACL,
#: CSI, secrets, namespaces, quotas, service regs, configs) is outside
#: the six-topic taxonomy and deliberately silent
EVENT_SOURCE_OPS = frozenset({
    "upsert_node", "delete_node",
    "upsert_job", "delete_job", "mark_job_stable",
    "upsert_eval", "delete_eval",
    "upsert_alloc", "delete_alloc", "update_alloc_from_client",
    "upsert_deployment", "delete_deployment",
    "upsert_plan_results",
})


# ---- deterministic event derivation (pure function of the entry) ----

def _node_payload(node) -> dict:
    # NLS01: Node events serve the secret-redacted copy — pop the
    # bearer field from the wire tree before anything rides the stream
    tree = to_wire(node)
    tree.pop("secret_id", None)
    return {k: tree.get(k) for k in
            ("id", "name", "status", "datacenter", "node_class",
             "scheduling_eligibility", "create_index", "modify_index")}


def _job_payload(job) -> dict:
    return {"id": job.id, "namespace": job.namespace,
            "status": getattr(job, "status", ""),
            "version": getattr(job, "version", 0),
            "stable": bool(getattr(job, "stable", False)),
            "create_index": job.create_index,
            "modify_index": job.modify_index}


def _eval_payload(e) -> dict:
    return {"id": e.id, "namespace": e.namespace, "job_id": e.job_id,
            "status": e.status, "type": getattr(e, "type", ""),
            "triggered_by": getattr(e, "triggered_by", ""),
            "trace_id": getattr(e, "trace_id", ""),
            # leader-minted timestamps riding the struct (NLR01-clean)
            "create_time": getattr(e, "create_time", 0.0),
            "modify_time": getattr(e, "modify_time", 0.0),
            "modify_index": e.modify_index}


def _alloc_payload(a) -> dict:
    return {"id": a.id, "namespace": a.namespace, "job_id": a.job_id,
            "node_id": a.node_id,
            "desired_status": getattr(a, "desired_status", ""),
            "client_status": getattr(a, "client_status", ""),
            "trace_id": getattr(a, "trace_id", "")}


def _deployment_payload(d) -> dict:
    return {"id": d.id, "namespace": d.namespace, "job_id": d.job_id,
            "status": d.status, "modify_index": d.modify_index}


def _fresh(obj) -> bool:
    return obj.create_index == obj.modify_index


def events_for_entry(op: str, args: Sequence, index: int) -> List[Event]:
    """Typed events for one applied log entry. PURE function of
    (op, decoded args, post-apply index): replicas applying the same
    entry derive byte-identical events (events_fingerprint gate)."""
    ev: List[Event] = []

    def add(topic, type_, key, namespace="", payload=None):
        ev.append(Event(topic=topic, type=type_, key=key,
                        namespace=namespace, index=index,
                        payload=payload or {}))

    if op == "upsert_node":
        node = args[0]
        add(TOPIC_NODE,
            "NodeRegistered" if _fresh(node) else "NodeUpdated",
            node.id, payload=_node_payload(node))
    elif op == "delete_node":
        add(TOPIC_NODE, "NodeDeregistered", args[0],
            payload={"id": args[0]})
    elif op == "upsert_job":
        job = args[0]
        add(TOPIC_JOB,
            "JobRegistered" if _fresh(job) else "JobUpdated",
            job.id, job.namespace, _job_payload(job))
    elif op == "delete_job":
        ns, job_id = args[0], args[1]
        add(TOPIC_JOB, "JobDeregistered", job_id, ns,
            {"id": job_id, "namespace": ns})
    elif op == "mark_job_stable":
        ns, job_id, version = args[0], args[1], args[2]
        add(TOPIC_JOB, "JobStable", job_id, ns,
            {"id": job_id, "namespace": ns, "version": version})
    elif op == "upsert_eval":
        e = args[0]
        add(TOPIC_EVAL, "EvalUpdated", e.id, e.namespace,
            _eval_payload(e))
    elif op == "delete_eval":
        add(TOPIC_EVAL, "EvalDeleted", args[0], payload={"id": args[0]})
    elif op in ("upsert_alloc", "update_alloc_from_client"):
        a = args[0]
        add(TOPIC_ALLOC, "AllocUpdated", a.id, a.namespace,
            _alloc_payload(a))
    elif op == "delete_alloc":
        add(TOPIC_ALLOC, "AllocDeleted", args[0],
            payload={"id": args[0]})
    elif op == "upsert_deployment":
        d = args[0]
        add(TOPIC_DEPLOYMENT, "DeploymentUpserted", d.id, d.namespace,
            _deployment_payload(d))
    elif op == "delete_deployment":
        add(TOPIC_DEPLOYMENT, "DeploymentDeleted", args[0],
            payload={"id": args[0]})
    elif op == "upsert_plan_results":
        result = args[1]
        # derive ONLY from `result`: the wire encoding drops the plan
        # half of the entry (wal._encode_args), so a payload read from
        # it would differ between the in-process and replicated paths.
        # The committed allocs carry the leader-minted eval/trace
        # bindings; the first one (wire order) names the plan.
        stops = sum(len(v) for v in result.node_update.values())
        preempts = sum(len(v) for v in result.node_preemptions.values())
        places = sum(len(v) for v in result.node_allocation.values())
        first = next((a for allocs in result.node_allocation.values()
                      for a in allocs), None)
        add(TOPIC_PLAN, "PlanApplied",
            first.eval_id if first else "",
            first.namespace if first else "",
            {"eval_id": first.eval_id if first else "",
             "job_id": first.job_id if first else "",
             "trace_id": getattr(first, "trace_id", "") if first else "",
             "placements": places, "stops": stops,
             "preemptions": preempts})
        # per-alloc events for the allocs this plan touched, in the
        # entry's own (wire-deterministic) order — the nested
        # upsert_alloc calls are depth-suppressed in the store
        for _node, allocs in result.node_update.items():
            for a in allocs:
                add(TOPIC_ALLOC, "AllocUpdated", a.id, a.namespace,
                    _alloc_payload(a))
        for _node, allocs in result.node_preemptions.items():
            for a in allocs:
                add(TOPIC_ALLOC, "AllocUpdated", a.id, a.namespace,
                    _alloc_payload(a))
        for _node, allocs in result.node_allocation.items():
            for a in allocs:
                add(TOPIC_ALLOC, "AllocUpdated", a.id, a.namespace,
                    _alloc_payload(a))
        if result.deployment is not None:
            d = result.deployment
            add(TOPIC_DEPLOYMENT, "DeploymentUpserted", d.id,
                d.namespace, _deployment_payload(d))
    return ev


def events_fingerprint(events: Iterable[Event]) -> str:
    """sha256 over the canonical byte serialization of an event
    sequence — the cross-replica equality gate (the event analog of
    fsm.state_fingerprint). Order is PRESERVED: replicas must agree on
    the stream order, not just the set."""
    import hashlib
    import json

    from .fsm import _canon

    trees = [_canon({"topic": e.topic, "type": e.type, "key": e.key,
                     "namespace": e.namespace, "index": e.index,
                     "payload": e.payload}) for e in events]
    blob = json.dumps(trees, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


# ---- topic filters (the Topic / Topic:key / Topic:* query grammar) ----

def parse_topic_filter(specs: Optional[Iterable[str]]
                       ) -> Optional[Dict[str, set]]:
    """`["Eval:*", "Job:web"]` → {"Eval": {"*"}, "Job": {"web"}};
    None/empty/`*` → None (match everything). Raises ValueError on a
    topic outside the closed vocabulary (the CLI/HTTP 400 path)."""
    if not specs:
        return None
    out: Dict[str, set] = {}
    for spec in specs:
        spec = spec.strip()
        if not spec:
            continue
        topic, _, key = spec.partition(":")
        if topic == "*":
            return None
        if topic not in EVENT_TOPICS:
            raise ValueError(f"unknown event topic {topic!r} "
                             f"(topics: {', '.join(sorted(EVENT_TOPICS))})")
        out.setdefault(topic, set()).add(key or "*")
    return out or None


def _matches(filt: Optional[Dict[str, set]], e: Event) -> bool:
    if filt is None:
        return True
    keys = filt.get(e.topic)
    return keys is not None and ("*" in keys or e.key in keys)


def _gap_event(lost_through: int, requested: int) -> Event:
    return Event(topic="", type=GAP_TYPE, key="", namespace="",
                 index=lost_through,
                 payload={"requested_index": requested,
                          "lost_through": lost_through,
                          "resume_from": lost_through})


# ---- subscriptions -------------------------------------------------------

class Subscription:
    """One consumer's bounded queue. Created via
    ClusterEventBroker.subscribe; all state is guarded by the broker's
    condition variable (fan-out holds it already, and sharing it lets
    poll() wake directly on publish)."""

    def __init__(self, broker: "ClusterEventBroker",
                 filt: Optional[Dict[str, set]],
                 max_pending: int, from_index: int) -> None:
        self._broker = broker
        self._filt = filt
        self._max = max_pending
        self._pending: List[Event] = []
        #: highest index this subscriber can no longer receive
        #: (ring/queue eviction); > _delivered ⇒ emit a gap marker
        self._lost_through = 0
        self._delivered = from_index
        self._evicted = 0
        self.closed = False

    # broker lock held
    def _offer(self, events: List[Event]) -> int:
        mine = [e for e in events if _matches(self._filt, e)]
        if not mine:
            return 0
        self._pending.extend(mine)
        dropped = 0
        if len(self._pending) > self._max:
            dropped = len(self._pending) - self._max
            lost = self._pending[:dropped]
            del self._pending[:dropped]
            self._lost_through = max(self._lost_through,
                                     lost[-1].index)
            self._evicted += dropped
        return dropped

    def poll(self, timeout: float = 0.0) -> List[Event]:
        """Next batch (gap marker first when events were lost). Blocks
        up to `timeout` when nothing is pending; [] on timeout."""
        import time

        deadline = time.time() + timeout
        with self._broker._cv:
            while True:
                if self._lost_through > self._delivered:
                    gap = _gap_event(self._lost_through,
                                     self._delivered)
                    self._delivered = self._lost_through
                    if self._pending:
                        out = [gap] + self._pending
                        self._pending = []
                        self._delivered = max(self._delivered,
                                              out[-1].index)
                        return out
                    return [gap]
                if self._pending:
                    out = self._pending
                    self._pending = []
                    self._delivered = max(self._delivered,
                                          out[-1].index)
                    return out
                if self.closed:
                    return []
                remaining = deadline - time.time()
                if remaining <= 0:
                    return []
                self._broker._cv.wait(min(remaining, 1.0))

    @property
    def last_delivered(self) -> int:
        with self._broker._cv:
            return self._delivered

    @property
    def evictions(self) -> int:
        with self._broker._cv:
            return self._evicted

    def close(self) -> None:
        self._broker.unsubscribe(self)


class ClusterEventBroker:
    """Bounded, per-server broker over FSM-derived events (module
    docstring has the full contract)."""

    #: per-subscriber queue bound — a slow consumer this far behind a
    #: loaded scheduling window is evicted into a gap, never blocks
    #: the apply path
    MAX_PENDING = 2048

    def __init__(self, size: int = 4096,
                 max_pending: int = MAX_PENDING) -> None:
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._size = size
        self._max_pending = max_pending
        self._ring: List[Event] = []
        self._last_index = 0
        #: highest index evicted from the ring (or folded into a
        #: snapshot restore) — resume below it gets a lost-gap marker
        self._evicted_through = 0
        self._subs: List[Subscription] = []
        self._metrics = None
        self._ctr_published = None
        self._ctr_evictions = None
        self._topic_ctrs: Dict[str, object] = {}

    # -- instrumentation (re-bound on leadership-gated Server rebuild,
    #    the fsm.bind_metrics pattern) --

    def bind_metrics(self, metrics) -> None:
        """Eagerly registers every events.* series (closed-vocabulary
        contract: families exist at 0 from startup)."""
        self._metrics = metrics
        self._ctr_published = metrics.counter("events.published")
        self._ctr_evictions = metrics.counter(
            "events.subscriber_evictions")
        self._topic_ctrs = {
            t: metrics.counter(f"events.topic.{t.lower()}")
            for t in sorted(EVENT_TOPICS)}
        metrics.gauge("events.subscribers").set(len(self._subs))
        metrics.gauge("events.oldest_index").set(
            self._ring[0].index if self._ring else 0)
        metrics.gauge("events.last_index").set(self._last_index)

    def _gauges(self) -> None:
        if self._metrics is None:
            return
        self._metrics.gauge("events.subscribers").set(len(self._subs))
        self._metrics.gauge("events.oldest_index").set(
            self._ring[0].index if self._ring else 0)
        self._metrics.gauge("events.last_index").set(self._last_index)

    # -- publish (called from the state-store apply hook; the path must
    #    stay clock- and entropy-free — NLR01/NLR02 scope) --

    def publish_entry(self, op: str, args: Sequence, index: int) -> None:
        events = events_for_entry(op, args, index)
        if events:
            self.publish(events)

    def publish(self, events: List[Event]) -> None:
        """Append a batch atomically and fan out. Never blocks on slow
        subscribers (their queues evict instead). Like
        FlightRecorder.record, rejects names outside the closed
        vocabulary — a new topic/type is a conscious taxonomy act
        (analysis/vocab.py)."""
        for e in events:
            if e.topic not in EVENT_TOPICS:
                raise ValueError(f"unknown event topic {e.topic!r}")
            if e.type not in EVENT_TYPES:
                raise ValueError(f"unknown event type {e.type!r}")
        with self._cv:
            self._ring.extend(events)
            if len(self._ring) > self._size:
                drop = len(self._ring) - self._size
                self._evicted_through = max(self._evicted_through,
                                            self._ring[drop - 1].index)
                del self._ring[:drop]
            self._last_index = max(self._last_index, events[-1].index)
            dropped = 0
            for sub in self._subs:
                dropped += sub._offer(events)
            if self._ctr_published is not None:
                self._ctr_published.inc(len(events))
                for e in events:
                    ctr = self._topic_ctrs.get(e.topic)
                    if ctr is not None:
                        ctr.inc()
                if dropped:
                    self._ctr_evictions.inc(dropped)
            self._gauges()
            self._cv.notify_all()

    # -- subscribe / resume --

    def subscribe(self, topics: Optional[Iterable[str]] = None,
                  from_index: Optional[int] = None,
                  max_pending: Optional[int] = None) -> Subscription:
        """Register a push consumer. `from_index=N` replays buffered
        events with index > N first (a lost-gap marker leads when N has
        been evicted); None subscribes from "now" (live only).
        `topics` uses the Topic / Topic:key / Topic:* grammar."""
        filt = parse_topic_filter(topics)
        with self._cv:
            start = self._last_index if from_index is None \
                else from_index
            sub = Subscription(self, filt,
                               max_pending or self._max_pending, start)
            if from_index is not None \
                    and from_index < self._evicted_through:
                sub._lost_through = self._evicted_through
            backlog = [e for e in self._ring
                       if e.index > start and _matches(filt, e)]
            sub._pending.extend(backlog)
            self._subs.append(sub)
            self._gauges()
            self._cv.notify_all()
            return sub

    def unsubscribe(self, sub: Subscription) -> None:
        with self._cv:
            sub.closed = True
            try:
                self._subs.remove(sub)
            except ValueError:
                pass
            self._gauges()
            self._cv.notify_all()

    def mark_restored(self, index: int) -> None:
        """After a snapshot restore the broker cannot replay anything
        at or below the restored index — resumes below it must see a
        deterministic lost-gap, not silence."""
        with self._cv:
            self._ring = [e for e in self._ring if e.index > index]
            self._evicted_through = max(self._evicted_through, index)
            self._last_index = max(self._last_index, index)
            self._gauges()
            self._cv.notify_all()

    # -- long-poll compat (the server/events.py events_after contract,
    #    extended with the lost-gap marker) --

    def events_after(self, index: int,
                     topics: Optional[Iterable[str]] = None,
                     timeout: float = 0.0) -> Tuple[int, List[Event]]:
        """Events with index > `index`, topic-filtered, gap-marked;
        blocks up to `timeout` when none are ready."""
        import time

        filt = parse_topic_filter(topics)
        deadline = time.time() + timeout
        while True:
            with self._cv:
                out: List[Event] = []
                if 0 <= index < self._evicted_through:
                    out.append(_gap_event(self._evicted_through, index))
                out.extend(e for e in self._ring
                           if e.index > index and _matches(filt, e))
                if out or timeout <= 0:
                    return self._last_index, out
                remaining = deadline - time.time()
                if remaining <= 0:
                    return self._last_index, []
                self._cv.wait(min(remaining, 1.0))

    # -- introspection (operator debug bundle / control section) --

    def last_index(self) -> int:
        with self._cv:
            return self._last_index

    def stats(self) -> dict:
        with self._cv:
            per_topic: Dict[str, int] = {t: 0 for t in
                                         sorted(EVENT_TOPICS)}
            for e in self._ring:
                per_topic[e.topic] = per_topic.get(e.topic, 0) + 1
            return {
                "last_index": self._last_index,
                "oldest_index": (self._ring[0].index
                                 if self._ring else 0),
                "evicted_through": self._evicted_through,
                "buffered": len(self._ring),
                "size": self._size,
                "subscribers": len(self._subs),
                "buffered_by_topic": per_topic,
            }

    def buffered(self, limit: int = 0) -> List[Event]:
        with self._cv:
            return self._ring[-limit:] if limit else list(self._ring)
