"""The repo's closed observability vocabularies — ONE source of truth.

Three independently test-pinned vocabularies grew up in three places:
the Prometheus series pins (tests/test_metrics_names.py), the flight
recorder's closed event-type set (lib/flight.py), and the transfer/HBM
ledger site taxonomy (README tables + the same test). A rename had to
miss all three to ship, and a NEW series only failed once the
exposition tests ran a loaded agent (~20s). This module is now the
single home: `lib/flight.py` and `tests/test_metrics_names.py` import
these sets, and the NLV01 lint rule (`analysis/vocab_rules.py`) diffs
every literal call-site name against them statically — a rename or an
unpinned new series fails `python -m nomad_tpu.analysis --fail-on-new`
in seconds, before any agent boots.

Pure data, stdlib-only: the analysis package must import neither jax
nor the analyzed modules, and lib/flight.py must stay cheap to import.

Extending a vocabulary is a conscious taxonomy act: add the name HERE,
in the same PR as the code that emits it, and say why in the PR.
"""
from __future__ import annotations

# ---- flight recorder event types (lib/flight.py) ---------------------------

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
    # speculative dispatch (ISSUE 15, server/select_batch.py)
    "spec.rollback",       # certification rolled back speculative
                           # program slices (conflicting commit)
    # scheduling SLOs (ISSUE 17, lib/tracectx.py SloTracker)
    "slo.burn",            # error-budget burn rate crossed a fast- or
                           # slow-window alerting threshold
})

# ---- cluster event stream (server/event_broker.py) -------------------------

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

# ---- Prometheus series names (tests/test_metrics_names.py) -----------------

#: every series name the repo PROMISES (post-mangle, nomad_ prefix).
#: Renaming any of these must be a deliberate, reviewed act.
PROM_REQUIRED = frozenset({
    # broker (eval_broker.go stats)
    "nomad_broker_enqueued", "nomad_broker_dequeued", "nomad_broker_acked",
    "nomad_broker_nacked", "nomad_broker_failed", "nomad_broker_requeued",
    # plan applier
    "nomad_plan_apply_applied", "nomad_plan_apply_partial",
    "nomad_plan_apply_rejected_nodes", "nomad_plan_apply_stale_token",
    "nomad_plan_apply_inline", "nomad_plan_apply_apply_ms",
    # eval-lifecycle phase histograms (lib/trace.py taxonomy)
    "nomad_eval_phase_schedule_ms", "nomad_eval_phase_plan_apply_ms",
    # device-view delta refresh (scheduler/stack.py)
    "nomad_view_upload_bytes", "nomad_view_full_uploads",
    "nomad_view_hot_log_len", "nomad_view_ports_log_len",
    # device-to-device plan deltas (ISSUE 10: dispatch-carry adoption)
    "nomad_view_carry_adopts", "nomad_view_carry_rows",
    # certified chain-carry adoption (ISSUE 20): a speculation chain's
    # HEAD carry adopted at refresh, per-row skip/reject counts, the
    # resync bytes it avoided — the r08 zero-resync read steers on these
    "nomad_view_chain_adopts", "nomad_view_chain_rows",
    "nomad_view_chain_rejects", "nomad_spec_resync_bytes_saved",
    # delta-log ring wrap mid-chain: certification evidence lost, every
    # speculative result rolled back (size via NOMAD_TPU_DELTA_LOG)
    "nomad_spec_chain_unprovable_wrap",
    # transfer ledger mirrors + labeled per-site exposition
    "nomad_transfer_bytes", "nomad_transfer_count", "nomad_transfer_ms",
    "nomad_transfer_bytes_total", "nomad_transfer_count_total",
    "nomad_transfer_ms_total",
    # dispatch pipeline (lib/transfer.DispatchTimeline)
    "nomad_pipeline_dispatches", "nomad_pipeline_programs",
    "nomad_pipeline_transfer_bytes", "nomad_pipeline_transfer_count",
    # pipeline phase + overlap/bubble histograms — the r06 acceptance
    # read (overlap_pct) aggregates from these; renames break it
    "nomad_pipeline_pack_ms", "nomad_pipeline_upload_ms",
    "nomad_pipeline_view_ms", "nomad_pipeline_host_ms",
    "nomad_pipeline_kernel_ms", "nomad_pipeline_overlap_ms",
    "nomad_pipeline_bubble_ms",
    # scheduler explainability counters (ISSUE 8)
    "nomad_scheduler_filter_constraint",
    "nomad_scheduler_exhausted_cpu",
    "nomad_scheduler_blocked_cpu",
    # HBM residency ledger (ISSUE 11): labeled per-(site, shard) gauges
    # plus the registry mirror totals + lease instruments
    "nomad_hbm_live_bytes", "nomad_hbm_buffers", "nomad_hbm_peak_bytes",
    "nomad_hbm_live_bytes_total", "nomad_hbm_buffers_total",
    "nomad_hbm_peak_bytes_total", "nomad_hbm_leases",
    "nomad_hbm_allocs", "nomad_hbm_releases",
    # drain cadence (ISSUE 12): mega-batch width/grouping/hold window —
    # the BENCH_r07 e2e_drain tail aggregates from these
    "nomad_drain_drains", "nomad_drain_batch_width",
    "nomad_drain_groups", "nomad_drain_hold_ms", "nomad_drain_window_ms",
    # wave dispatch (ISSUE 12): lane structure of fused mega-batches
    "nomad_wave_dispatches", "nomad_wave_programs", "nomad_wave_lanes",
    # speculative wave dispatch (ISSUE 15): launch/certify/rollback
    # outcomes, exact re-dispatch counts, wasted device time — the
    # BENCH_r08 e2e_spec tail and the adaptive gate read these
    "nomad_spec_launches", "nomad_spec_certified",
    "nomad_spec_rolled_back", "nomad_spec_redispatch_programs",
    "nomad_spec_wasted_kernel_ms",
    # control-plane queue state (ISSUE 13): broker depths/ages + plan
    # pipeline depth/rejection rate — the soak-backpressure dashboards
    "nomad_broker_ready_depth", "nomad_broker_unacked_depth",
    "nomad_broker_pending_depth", "nomad_broker_delayed_depth",
    "nomad_broker_oldest_eval_age_s", "nomad_broker_blocked_depth",
    "nomad_plan_apply_queue_depth", "nomad_plan_apply_partial_rate",
    # heartbeat TTL misses (ISSUE 13 satellite)
    "nomad_heartbeat_expired",
    # WAL durability (ISSUE 13; present: the fixture agent is durable)
    "nomad_wal_appends", "nomad_wal_snapshots", "nomad_wal_append_ms",
    "nomad_wal_fsync_ms", "nomad_wal_snapshot_ms", "nomad_wal_log_bytes",
    "nomad_wal_snapshot_bytes",
    # mesh-CA issuance outcomes (ISSUE 14 + 16): total denials plus a
    # distinct series per deny reason — identity (unknown node / secret
    # mismatch) vs missing allocation binding (verified node, but no
    # live alloc of the named service)
    "nomad_connect_issue_denied",
    "nomad_connect_issue_denied_identity",
    "nomad_connect_issue_denied_no_alloc",
    # distributed tracing (ISSUE 17): SpanStore recording mirror on the
    # process registry — span RATES without reading the ring
    "nomad_trace_spans",
    # per-priority scheduling SLOs (ISSUE 17): attainment + error-budget
    # gauges and submit→alloc-start latency summaries per band, all
    # pre-created at SloTracker construction so the pins hold on an
    # agent that never placed an alloc
    "nomad_slo_observations",
    "nomad_slo_attainment_high", "nomad_slo_attainment_normal",
    "nomad_slo_attainment_low",
    "nomad_slo_budget_remaining_high", "nomad_slo_budget_remaining_normal",
    "nomad_slo_budget_remaining_low",
    "nomad_slo_latency_high_ms", "nomad_slo_latency_normal_ms",
    "nomad_slo_latency_low_ms",
    # FSM-sourced cluster event stream (ISSUE 18): publish volume,
    # per-topic counters, live subscriber gauge, resume-window bounds,
    # slow-subscriber evictions — the bench e2e_events tail and the
    # lost-gap runbook read these
    "nomad_events_published", "nomad_events_subscribers",
    "nomad_events_subscriber_evictions",
    "nomad_events_oldest_index", "nomad_events_last_index",
    "nomad_events_topic_job", "nomad_events_topic_eval",
    "nomad_events_topic_alloc", "nomad_events_topic_deployment",
    "nomad_events_topic_node", "nomad_events_topic_plan",
})

#: the raft node's promised series (ISSUE 13) — exposed from the NODE's
#: own registry (it outlives the leadership-gated Server)
RAFT_REQUIRED = frozenset({
    "nomad_raft_term", "nomad_raft_state", "nomad_raft_commit_index",
    "nomad_raft_last_applied", "nomad_raft_log_last_index",
    "nomad_raft_log_base_index", "nomad_raft_log_bytes",
    "nomad_raft_peers", "nomad_raft_elections",
    "nomad_raft_leadership_gained", "nomad_raft_leadership_lost",
    "nomad_raft_snapshots", "nomad_raft_snapshot_installs",
    "nomad_raft_commit_ms", "nomad_raft_apply_ms", "nomad_raft_append_ms",
})

#: the FSM's promised series (ISSUE 16) — registered on the raft node's
#: registry (cluster.py binds them right after the RaftNode boots), so
#: they ride the same scrape surface as RAFT_REQUIRED
FSM_REQUIRED = frozenset({
    "nomad_fsm_applied",        # entries applied to the state store
    "nomad_fsm_apply_skipped",  # bad entries skipped by apply_resilient
})

#: every family a series may legally belong to; a new prefix here is a
#: conscious taxonomy extension
ALLOWED_PREFIXES = (
    "nomad_broker_",
    "nomad_plan_apply_",
    "nomad_eval_phase_",
    "nomad_worker_",          # worker.<id>.batch.* coordinator stats
    "nomad_pipeline_",
    "nomad_view_",
    "nomad_transfer_",
    "nomad_scheduler_filter_",
    "nomad_scheduler_exhausted_",
    "nomad_scheduler_blocked_",
    "nomad_rpc_",             # rpc.client.* transport latencies
    "nomad_loop_errors_",     # ErrorStreak sinks
    "nomad_hbm_",             # residency ledger (labeled + mirrors)
    "nomad_drain_",           # drain-cadence mega-batching (ISSUE 12)
    "nomad_wave_",            # wave-dispatch lane structure (ISSUE 12)
    "nomad_spec_",            # speculative dispatch outcomes (ISSUE 15)
    "nomad_wal_",             # WAL durability (ISSUE 13)
    "nomad_heartbeat_",       # node TTL misses (ISSUE 13)
    "nomad_flight_",          # flight-recorder event counters (ISSUE 13)
    "nomad_raft_",            # raft registries (cluster agents; pinned
                              # non-vacuously in TestControlPlaneSeries)
    "nomad_fsm_",             # FSM apply outcomes (ISSUE 16; bound to
                              # the raft registry by server/cluster.py)
    "nomad_connect_",         # mesh-CA issuance outcomes (ISSUE 14:
                              # connect.issue_denied identity rejections)
    "nomad_node_",            # node-identity registration outcomes
                              # (ISSUE 14: node.register_denied —
                              # write-once secret mismatch rejections)
    "nomad_trace_",           # distributed-tracing SpanStore mirrors
                              # (ISSUE 17)
    "nomad_slo_",             # per-priority scheduling SLOs (ISSUE 17)
    "nomad_events_",          # FSM-sourced cluster event stream
                              # (ISSUE 18, server/event_broker.py)
)

#: the only label names any exposed series may carry
ALLOWED_LABELS = frozenset({"site", "quantile", "shard"})

# ---- transfer + HBM-residency call-site taxonomy ---------------------------

#: the transfer ledger's site vocabulary (the `site` label values) —
#: renames here break `top_sites` dashboards exactly like metric renames
TRANSFER_SITES = frozenset({
    "stack.static_full", "stack.hot_full", "stack.hot_delta",
    "stack.ports_full", "stack.ports_delta", "stack.ports_word_delta",
    "select_batch.pack_buffers", "select_batch.fetch",
    "select_batch.table_insert", "select_batch.dyn_rows",
    "mesh.shard_cluster",
})

#: HBM residency sites (lib/hbm.py; README residency-site table) — the
#: `site` label is shared with the transfer families.
RESIDENCY_SITES = frozenset({
    "stack.view_static", "stack.view_hot", "stack.view_ports",
    "select_batch.batch_out", "select_batch.carry",
    "program_table.i32", "program_table.f32", "program_table.u8",
    "mesh.cluster",
})

#: booking PREFIXES (lib/hbm.py `track_cluster`/`lease` call sites):
#: track_cluster expands a prefix to the per-tensor `<prefix>_{static,
#: hot,ports}` sites above before anything reaches an exposition, and
#: lease sites never ride a labeled series at all — so these are a
#: LINT-side vocabulary only. ALLOWED_SITES deliberately excludes
#: them: a bare prefix leaking into a `site` label is a bug the
#: exposition tests must keep catching.
BOOKING_PREFIXES = frozenset({"stack.view"})

#: union the `site` label may carry in any exposition
ALLOWED_SITES = frozenset(TRANSFER_SITES | RESIDENCY_SITES)

# ---- distributed-trace span taxonomy (lib/tracectx.py SpanStore) -----------

#: the closed span-name vocabulary for the ninth telemetry layer
#: (ISSUE 17). `nomad trace` waterfalls and the debug-bundle stitcher
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
