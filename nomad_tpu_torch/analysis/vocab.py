"""The closed observability vocabularies the port's copied modules read.

A copy of the name sets that `lib/flight.py`, `lib/tracectx.py` and
`server/event_broker.py` import from the reference package's
`analysis/vocab.py` (flight-event types, event-stream topics and types,
span names), so those modules stay byte-identical copies. The lint rule
engine that pins these sets is not ported.
"""
from __future__ import annotations

#: the closed flight-event vocabulary. Dashboards and the debug-bundle
#: reader key on these; FlightRecorder.record raises on anything else.
FLIGHT_TYPES = frozenset({
    # raft / leadership (raft/raft.py)
    "leadership.gained",   # this node won an election
    "leadership.lost",     # this node stepped down from leader
    "raft.term",           # this node started an election (term bump)
    # leader plan pipeline (server/plan_apply.py)
    "plan.partial",        # optimistic verification rejected node(s)
    # broker (server/broker.py)
    "broker.eval_failed",  # delivery limit exhausted → failed queue
    # liveness (server/server.py, lib/metrics.py, lib/hbm.py,
    # server/select_batch.py, server/cluster.py)
    "heartbeat.expired",   # node TTL missed → marked down
    "error.streak",        # an ErrorStreak sink started a failure streak
    "hbm.stuck_lease",     # view lease older than the age watermark
    "wave.collisions",     # cross-lane row collision in a wave dispatch
    "membership.change",   # gossip member status transition
    # speculative dispatch (server/select_batch.py)
    "spec.rollback",       # certification rolled back speculative
                           # program slices (conflicting commit)
    # scheduling SLOs (lib/tracectx.py SloTracker)
    "slo.burn",            # error-budget burn rate crossed a fast- or
                           # slow-window alerting threshold
})


#: the closed event-topic vocabulary — the tenth telemetry layer's
#: taxonomy (README table). Topic filters (`Topic`, `Topic:key`,
#: `Topic:*`) and the NLV01 literal check key on these; the broker
#: rejects a published event whose topic is not listed.
EVENT_TOPICS = frozenset({
    "Job", "Eval", "Alloc", "Deployment", "Node", "Plan",
})


#: the closed event-type vocabulary (one state-transition verb per
#: FSM-op shape; `lost-gap` is a stream-control marker, NOT a type).
EVENT_TYPES = frozenset({
    "JobRegistered", "JobUpdated", "JobDeregistered", "JobStable",
    "EvalUpdated", "EvalDeleted",
    "AllocUpdated", "AllocDeleted",
    "DeploymentUpserted", "DeploymentDeleted",
    "NodeRegistered", "NodeUpdated", "NodeDeregistered",
    "PlanApplied",
})


#: the closed span-name vocabulary for the ninth telemetry layer
#:. `nomad trace` waterfalls and the debug-bundle stitcher
#: key on these names; SpanStore.record raises on anything else, so a
#: new span name is a conscious taxonomy act exactly like a new flight
#: type. Parentage rules (enforced by the zero-orphan gate in
#: tests/test_trace_distributed.py, documented in the README table):
#:
#:   http.submit   root (or child of the SDK's inbound `traceparent`)
#:   rpc.forward   child of the caller's current span (submit hop:
#:                 http.submit on the follower)
#:   eval          child of the span current at broker enqueue
#:                 (rpc.forward when forwarded, http.submit when local)
#:   eval.<phase>  child of `eval` — one per lib/trace.py PHASES entry,
#:                 mirrored off the EvalTracer's monotonic spans
#:   plan.apply    child of `eval` — span id LEADER-MINTED in
#:                 plan_apply.apply (like `now=`) and stamped onto the
#:                 plan's allocs before the raft entry is journaled
#:   alloc.start   child of `plan.apply` via the alloc's riding
#:                 trace_span_id (client-side)
#:   alloc.health  child of `alloc.start` (client-side health verdict)
SPAN_NAMES = frozenset({
    "http.submit",
    "rpc.forward",
    "eval",
    "eval.queue_wait", "eval.claim", "eval.snapshot", "eval.schedule",
    "eval.pack", "eval.delta_apply", "eval.kernel", "eval.plan_apply",
    "eval.ack",
    "plan.apply",
    "alloc.start",
    "alloc.health",
})
