"""Server — the single-process control plane wiring every leader subsystem.

Behavioral reference: `nomad/server.go` (NewServer :289, setupWorkers :1419)
and `nomad/leader.go` (establishLeadership :222 — broker/plan-queue/blocked
enablement, restoreEvals :352). Raft replication is out of scope for the
single-process build (the StateStore write path stands in for the FSM; its
index is the Raft-index analog) — multi-server durability rides behind the
same `apply_*` seams.

The port's Server places on `device` (`Server(config, device=None)`:
None means the card, and a missing card raises; `device="cpu"` runs the
plain versions). Methods whose lazy imports reach modules not ported yet
(`acl`, `wal`, `lib/tlsutil`, raft; ROADMAP A8) stay, and raise when
called.

Endpoint behaviors implemented as methods (HTTP layer calls these):
- Job.Register/Deregister (`nomad/job_endpoint.go:79,772`)
- Node.Register/UpdateStatus/UpdateDrain/Heartbeat (`nomad/node_endpoint.go`)
- Node.UpdateAlloc — client status pushes creating reschedule evals
  (`node_endpoint.go:1105`)
- Eval.Ack/Nack/Dequeue pass-through (`nomad/eval_endpoint.go`)
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..device import DeviceLike, resolve_device
from ..utils import fast_uuid
from ..structs import Allocation, Evaluation, Job, Node
from ..structs.evaluation import (
    EVAL_STATUS_BLOCKED,
    EVAL_STATUS_CANCELLED,
    EVAL_STATUS_PENDING,
    TRIGGER_ALLOC_STOP,
    TRIGGER_JOB_DEREGISTER,
    TRIGGER_JOB_REGISTER,
    TRIGGER_NODE_UPDATE,
    TRIGGER_RETRY_FAILED_ALLOC,
)
from ..structs.node import NODE_STATUS_DOWN, NODE_STATUS_READY
from .blocked import BlockedEvals
from .broker import EvalBroker
from .heartbeat import HeartbeatTracker
from .plan_apply import PlanApplier, PlanQueue
from .state import StateStore
from .worker import Worker


class ServerConfig:
    def __init__(self, num_schedulers: int = 1, heartbeat_ttl: float = 10.0,
                 nack_timeout: float = 60.0, gc_interval: float = 60.0,
                 gc=None, data_dir: Optional[str] = None,
                 fsync: bool = False, snapshot_threshold: int = 8192,
                 acl_enabled: bool = False, eval_batch: int = 32,
                 mesh=None):
        self.num_schedulers = num_schedulers
        self.heartbeat_ttl = heartbeat_ttl
        self.nack_timeout = nack_timeout
        self.gc_interval = gc_interval
        self.gc = gc  # GCConfig | None (core_sched.py defaults)
        self.data_dir = data_dir  # None → in-memory only (dev agent mode)
        self.fsync = fsync
        self.snapshot_threshold = snapshot_threshold
        self.acl_enabled = acl_enabled
        #: max evals one worker drains into a fused-select batch
        #: (worker.py process_batch); 1 disables batching. 32 measured
        #: best on the 2000-node e2e (369/s vs 251/s @16 — fewer chain
        #: dispatches amortize the fixed per-dispatch cost; ≥64 pays a
        #: longer serial scan for no further dispatch saving)
        self.eval_batch = eval_batch
        #: control-plane device mesh (parallel/mesh.py Mesh), "env"
        #: (NOMAD_TPU_MESH, `mesh_from_env`) or None: the Server installs
        #: it process-wide and its view cache shards the cluster over it;
        #: its lead device must be the server's device
        self.mesh = mesh


#: constraint operands the footprint estimator can evaluate statically
#: per distinct vocab value (cheap, no regex/version parsing per node)
_FOOTPRINT_OPS = frozenset({
    "=", "==", "is", "!=", "not", "set_contains", "set_contains_all",
    "set_contains_any", "is_set", "is_not_set",
})


def _constraint_mask(cl, attrs, constraints, n):
    """Superset row mask for a list of constraints: every row a program
    compiled from `constraints` could ever select passes the mask
    (`Server._eval_footprint`'s widened narrowing step). Evaluates each
    simple constraint per DISTINCT vocab value with the scalar oracle
    the LUT compile itself uses (`check_constraint`) — so `!=`
    missing-ness, `set_contains` over comma-lists, and `is_set` all
    match LUT semantics instead of re-deriving them — then gathers the
    verdicts through the tokenized attrs column. Rows whose token
    post-dates the vocab snapshot (concurrent growth) always pass:
    a footprint may only ever be too wide, never too narrow."""
    import numpy as np

    from ..tensor.constraints import check_constraint
    from ..tensor.vocab import MISSING, target_to_key

    mask = np.ones(n, dtype=bool)
    for c in constraints:
        if c.operand not in _FOOTPRINT_OPS:
            continue
        r = str(c.rtarget) if c.rtarget is not None else ""
        if "${" in r:
            continue  # interpolated target: not statically evaluable
        key = target_to_key(c.ltarget)
        if key is None or key == "__unresolvable__":
            continue
        k = cl.vocab.lookup_key(key)
        if k < 0 or k >= attrs.shape[1]:
            # key never tokenized: every node reads as missing
            if not check_constraint(c.operand, None, r, False, True):
                mask &= False
            continue
        vals = list(cl.vocab.key_vocabs[k].values)
        ok_toks = np.fromiter(
            (check_constraint(c.operand, v, r, True, True)
             for v in vals), dtype=bool, count=len(vals))
        missing_ok = check_constraint(c.operand, None, r, False, True)
        col = attrs[:, k]
        cm = np.zeros(n, dtype=bool)
        known = (col >= 0) & (col < len(vals))
        cm[known] = ok_toks[col[known]]
        cm |= col >= len(vals)          # token newer than the snapshot
        if missing_ok:
            cm |= col == MISSING
        mask &= cm
    return mask


class Server:
    def __init__(self, config: Optional[ServerConfig] = None,
                 state: Optional[StateStore] = None,
                 device: DeviceLike = None) -> None:
        #: where the workers' schedulers place (the card unless the
        #: caller asks for the CPU)
        self.device = resolve_device(device)
        self.config = config or ServerConfig()
        # Control-plane device mesh: sharded cluster views on the live
        # worker path (the dry run proves this same path). Installed
        # process-wide — the kernel dispatch layer (TorchStack) is below
        # the Server and sees it via get_active_mesh().
        mesh = self.config.mesh
        if mesh == "env":
            from ..parallel.mesh import mesh_from_env

            mesh = mesh_from_env()
        if mesh is not None:
            # the view cache keys the sharded view by its lead device
            from ..scheduler.stack import _dev_key

            lead = mesh.grid()[0][0]
            if _dev_key(lead) != _dev_key(self.device):
                raise ValueError(f"the mesh leads on {lead}, the server "
                                 f"places on {self.device}")
        self._installed_mesh = mesh
        if mesh is not None:
            from ..parallel.mesh import set_active_mesh

            set_active_mesh(mesh)
        # Serializes quota admission (check-then-act) against the job
        # upsert: the HTTP layer is a ThreadingHTTPServer, so two
        # concurrent registers could otherwise both pass _enforce_quota
        # under the limit and both commit (ent reference serializes via
        # the raft apply path).
        self._admission_lock = threading.RLock()
        # serializes lazy connect-CA creation (connect_issue)
        self._connect_ca_lock = threading.Lock()
        # Serializes node_register's write-once identity check against
        # its upsert PER NODE ID: node_by_id and upsert_node lock the
        # store SEPARATELY, so two concurrent first registrations for
        # one node id could otherwise both see no bound secret and
        # last-writer-wins would hand the TOFU binding to the loser.
        # Striped by id — on a clustered server upsert_node blocks on
        # a raft quorum commit, and one global mutex would serialize
        # every registration in the region behind it.
        self._node_identity_locks: Dict[str, threading.Lock] = {}
        self._node_identity_locks_mu = threading.Lock()
        #: node id → latest heartbeat-carried device stats (off-raft;
        #: devicemanager stats stream — see node_heartbeat)
        self._node_device_stats: Dict[str, dict] = {}
        # Telemetry: one registry + eval-span tracer per server, threaded
        # through broker / workers / plan applier / WAL (go-metrics setup
        # in the reference; per-server so multi-server tests don't
        # cross-count). Served on /v1/metrics + /v1/evaluation/:id/trace.
        # Created BEFORE the state store so the WAL appends are
        # registry-instrumented from the very first restore-time write.
        from ..lib.flight import default_flight
        from ..lib.metrics import MetricsRegistry
        from ..lib.trace import EvalTracer
        from ..lib.tracectx import SloTracker, default_spans
        from ..lib.transfer import DispatchTimeline

        self.metrics = MetricsRegistry()
        # eval phase spans mirror into the process-global SpanStore
        #: distributed traces are stitched ACROSS servers, so
        # the ring is per process like the flight recorder, with spans
        # carrying a per-server `source` (set by the cluster agent)
        self.tracer = EvalTracer(self.metrics, spans=default_spans(),
                                 source="self")
        # per-priority scheduling SLOs: submit→alloc-start
        # attainment/budget/burn, observed leader-side on the first
        # client_status=running report (node_update_allocs)
        self.slo = SloTracker(self.metrics, flight=default_flight(),
                              source="self")
        if state is not None:
            # Injected store (the cluster agent passes a RaftStateStore)
            self.state = state
        elif self.config.data_dir:
            from .wal import DurableStateStore, Wal

            self.state = DurableStateStore(
                Wal(self.config.data_dir, fsync=self.config.fsync,
                    metrics=self.metrics),
                snapshot_threshold=self.config.snapshot_threshold,
            )
            self.state.restore()
        else:
            self.state = StateStore()
        # dispatch-pipeline timeline (pack/view/kernel overlap per fused
        # dispatch): fed by the workers' SelectCoordinators, served on
        # /v1/scheduler/timeline + `operator timeline` + bench's
        # e2e_pipeline tail
        self.timeline = DispatchTimeline(self.metrics)
        self.broker = EvalBroker(nack_timeout=self.config.nack_timeout,
                                 metrics=self.metrics, tracer=self.tracer,
                                 footprint_fn=self._eval_footprint)
        self.blocked = BlockedEvals(self.broker, registry=self.metrics)
        self.plan_queue = PlanQueue(metrics=self.metrics)
        self.planner = PlanApplier(self.state, self.plan_queue,
                                   broker=self.broker,
                                   metrics=self.metrics)
        #: heartbeat TTL misses: silently-lost
        #: clients were only a log line before — eagerly created so the
        #: series is always exposed
        self._ctr_hb_expired = self.metrics.counter("heartbeat.expired")
        self.workers: List[Worker] = [
            Worker(self, i) for i in range(self.config.num_schedulers)
        ]
        self.heartbeater = HeartbeatTracker(
            ttl=self.config.heartbeat_ttl, on_expire=self._heartbeat_expired
        )
        from ..lib import TimeTable
        from .deployments import DeploymentsWatcher
        from .drainer import NodeDrainer
        from .event_broker import ClusterEventBroker
        from .periodic import PeriodicDispatch
        from .volumewatcher import VolumeWatcher

        self.deployments_watcher = DeploymentsWatcher(self)
        self.drainer = NodeDrainer(self)
        self.periodic = PeriodicDispatch(self)
        self.volume_watcher = VolumeWatcher(self)
        # FSM-sourced cluster event stream (server/event_broker.py):
        # the broker belongs to the STATE STORE (it must survive the
        # leadership-gated Server rebuild and receive follower-side FSM
        # applies), so reuse an already-attached one and only re-bind
        # its instruments to this Server's registry. NOMAD_TPU_EVENTS=0
        # detaches the store hook entirely (the bench A/B arm).
        broker = getattr(self.state, "event_broker", None)
        if broker is None:
            broker = ClusterEventBroker()
            if os.environ.get("NOMAD_TPU_EVENTS", "1") != "0":
                self.state.event_broker = broker
        broker.bind_metrics(self.metrics)
        self.events = broker
        self.timetable = TimeTable()
        self._gc_thread: Optional[threading.Thread] = None
        self._stop_event = threading.Event()
        self._running = False
        # (ns, job_id) → group → bounded scale-event history
        # (structs.JobScalingEvents, state_store.go UpsertJob scaling
        # events). Advisory + in-memory only: not WAL-journaled, cleared on
        # restart and on job deregister; the scaled COUNT itself is durable
        # via the job table.
        self._scaling_events: Dict[Tuple[str, str], Dict[str, List[Dict]]] = {}

    @property
    def acl(self):
        # the token store lives in the state store: WAL-journaled,
        # snapshot-included, Raft-replicated like every other table
        return self.state.acl

    def resolve_token(self, secret: Optional[str]):
        """secret → compiled ACL (reference Server.ResolveToken,
        nomad/acl.go:38). With ACLs disabled everything is permitted."""
        from ..acl import management_acl

        if not self.config.acl_enabled:
            return management_acl()
        return self.acl.resolve(secret)

    # ---- lifecycle (leader.go:222 establishLeadership) ----

    def start(self) -> None:
        self.broker.set_enabled(True)
        self.blocked.set_enabled(True)
        self.plan_queue.set_enabled(True)
        self._restore_evals()
        self.planner.start()
        for w in self.workers:
            w.start()
        self.heartbeater.start()
        self.deployments_watcher.start()
        self.drainer.start()
        self.periodic.start()
        self.volume_watcher.start()
        self.timetable.witness(self.state.index.value)
        self._stop_event.clear()
        self._gc_thread = threading.Thread(target=self._run_gc_ticker,
                                           name="core-gc", daemon=True)
        self._gc_thread.start()
        # Arm TTL timers for nodes already in state (reference
        # initializeHeartbeatTimers on establishLeadership, heartbeat.go:24)
        for node in self.state.nodes():
            if not node.terminal_status():
                self.heartbeater.reset(node.id)
        self._running = True

    def _eval_footprint(self, ev: Evaluation):
        """Cheap host-side node-footprint estimate for a ready eval (the
        broker's `dequeue_batch` conflict-partition input):
        a bool[n_cap] row mask over every node the eval's scheduling
        could READ (candidate selection) or WRITE (placements, stops,
        preemptions, plan-relative deltas). Returns None when nothing
        cheap bounds it — None conflicts with everything, which is
        always safe (the eval rides the sequential chain).

        The mask is deliberately a SUPERSET built from pre-compile
        facts only (no LUT build, no snapshot):

          - datacenter pre-filter: rows whose `node.datacenter` token
            is one of the job's datacenters (the first feasibility gate
            `compile_constraints` bakes into the LUT — every selectable
            node passes it);
          - simple value constraints on already-tokenized keys narrow
            it further — `=`/`!=`/`set_contains[_any|_all]`/`is_set`
            over static targets (`${node.class} = x` and friends),
            evaluated per DISTINCT vocab value with the same scalar
            oracle the LUT compile uses, so multi-valued attrs and
            missing-ness semantics match exactly. Both job-level and
            task-group/task-level constraints take part: the eval's
            read set is the UNION over its task groups of each group's
            narrowed mask (a node only one group could select is still
            in the eval's footprint — a node no group could select is
            not). A job with no datacenter list but a narrowing
            node-class (or any simple) constraint now gets a real
            footprint instead of conflicting with everything;
          - ∪ rows of the job's CURRENT allocs — stops/preemptions/
            migrations and their resource/port deltas land there;
          - ∪ the eval's own node row (node-update/drain triggers).

        Reads of the live cluster tensors are lock-free and racy by
        design: a node added between estimate and dispatch can make two
        "disjoint" evals collide — the wave kernel counts cross-lane
        row collisions (carry rejected) and plan-apply verification
        resolves the race; stale estimates cost a retry, never a wrong
        placement."""
        import numpy as np

        if not ev.job_id:
            return None
        cl = self.state.cluster
        attrs = cl.attrs  # one reference; concurrent growth swaps arrays
        n = attrs.shape[0]
        job = self.state.job_by_id(ev.namespace, ev.job_id)
        if job is not None:
            if job.datacenters:
                k_dc = cl.vocab.lookup_key("node.datacenter")
                if k_dc < 0 or k_dc >= attrs.shape[1]:
                    return None
                kv = cl.vocab.key_vocabs[k_dc]
                toks = [t for t in (kv.lookup(dc)
                                    for dc in job.datacenters)
                        if t >= 0]
                col = attrs[:, k_dc]
                mask = (np.isin(col, toks) if toks
                        else np.zeros(n, dtype=bool))
            else:
                mask = np.ones(n, dtype=bool)
            mask &= _constraint_mask(cl, attrs, job.constraints, n)
            tg_union = None
            for tg in job.task_groups:
                cons = list(tg.constraints)
                for t in tg.tasks:
                    cons.extend(t.constraints)
                m = _constraint_mask(cl, attrs, cons, n)
                tg_union = m if tg_union is None else (tg_union | m)
            if tg_union is not None:
                mask &= tg_union
            if not job.datacenters and bool(mask.all()):
                # no datacenter list and nothing narrowed = every node
                # is a candidate; nothing cheap bounds the read set
                return None
        else:
            # job gone (deregister/stop evals): only the current alloc
            # rows can be touched
            mask = np.zeros(n, dtype=bool)
        for row, _tg in cl.job_allocs.get(ev.job_id, {}).values():
            if 0 <= row < n:
                mask[row] = True
        if ev.node_id:
            row = cl.row_of.get(ev.node_id)
            if row is not None and row < n:
                mask[row] = True
        return mask

    def _restore_evals(self) -> None:
        """Re-enqueue non-terminal evals from state into the broker/blocked
        tracker (reference restoreEvals, leader.go:352 — eval state must
        survive restart/leader failover)."""
        for e in self.state.evals():
            if e.should_enqueue():
                self.broker.enqueue(e)
            elif e.should_block():
                self.blocked.block(e)

    def snapshot_save(self) -> None:
        """`operator snapshot save` (helper/snapshot) — durable mode only."""
        save = getattr(self.state, "snapshot_save", None)
        if save is not None:
            save()

    def control_plane_stats(self) -> Dict[str, object]:
        """Control-plane health rollup + gauge refresh: the
        broker's queue depths/ages, the plan pipeline's queue depth /
        latency / optimistic-rejection rate, and heartbeat losses — the
        section the metrics scrape, `operator debug`, and the bench
        `e2e_control` tail all read, so they can never disagree."""
        qs = self.broker.queue_stats()
        blocked = self.blocked.blocked_count()
        self.metrics.set_gauge("broker.blocked_depth", blocked)
        qs["blocked"] = blocked
        snap = self.metrics.snapshot()
        hists = snap.get("histograms") or {}
        apply_ms = hists.get("plan_apply.apply_ms") or {}
        gauges = snap.get("gauges") or {}
        plan = {
            "queue_depth": int(gauges.get("plan_apply.queue_depth", 0)),
            "partial_rate": gauges.get("plan_apply.partial_rate", 0.0),
            "apply_ms": {k: apply_ms.get(k, 0)
                         for k in ("count", "mean", "p50", "p95",
                                   "p99", "max")},
        }
        plan.update(self.planner.stats)
        wal = getattr(self.state, "wal", None)
        out: Dict[str, object] = {
            "broker": qs,
            "plan_apply": plan,
            "heartbeat_expired": int(self._ctr_hb_expired.value),
        }
        if wal is not None:
            out["wal"] = wal.status()
        return out

    def shutdown(self) -> None:
        self._running = False
        self._stop_event.set()
        self.periodic.shutdown()
        self.drainer.shutdown()
        self.volume_watcher.shutdown()
        self.deployments_watcher.shutdown()
        self.heartbeater.shutdown()
        for w in self.workers:
            w.shutdown()
        self.planner.shutdown()
        self.broker.shutdown()
        for w in self.workers:
            w.join()
        wal = getattr(self.state, "wal", None)
        if wal is not None:
            wal.close()
        if self._installed_mesh is not None:
            # uninstall the process-global mesh this server set up —
            # but only if a newer server hasn't replaced it meanwhile
            from ..parallel.mesh import get_active_mesh, set_active_mesh

            if get_active_mesh() is self._installed_mesh:
                set_active_mesh(None)
            self._installed_mesh = None

    # ---- core GC (leader.go schedulePeriodic + core_sched.go) ----

    def _run_gc_ticker(self) -> None:
        from .core_sched import (CORE_JOB_DEPLOYMENT_GC, CORE_JOB_EVAL_GC,
                                 CORE_JOB_JOB_GC, CORE_JOB_NODE_GC)

        # last-GC stamp is confined to this thread (NLT01: it used to be
        # a worker-visible attribute written from start()); the first GC
        # still lands a full interval after the ticker starts
        last_gc = time.time()
        while not self._stop_event.wait(min(self.config.gc_interval, 1.0)):
            self.timetable.witness(self.state.index.value)
            now = time.time()
            if now - last_gc < self.config.gc_interval:
                continue
            last_gc = now
            for kind in (CORE_JOB_EVAL_GC, CORE_JOB_JOB_GC, CORE_JOB_NODE_GC,
                         CORE_JOB_DEPLOYMENT_GC):
                self.enqueue_core_eval(kind)

    def enqueue_core_eval(self, kind: str) -> Evaluation:
        """Create a `_core` eval routed to CoreScheduler (leader.go
        coreJobEval)."""
        from ..structs.job import JOB_TYPE_CORE

        return self._create_eval(
            namespace="-",
            priority=100,  # JobMaxPriority (core_sched.go coreJobEval)
            type=JOB_TYPE_CORE,
            triggered_by="scheduled",
            job_id=f"{kind}:{fast_uuid()}",
            status=EVAL_STATUS_PENDING,
        )

    def run_gc(self, kind: str = "force-gc") -> None:
        """Synchronous GC (the `System.GarbageCollect` RPC path)."""
        from .core_sched import CoreScheduler

        ev = Evaluation(job_id=f"{kind}:{fast_uuid()}")
        CoreScheduler(self).process(ev)

    # ---- eval application (FSM upsertEvals analog, fsm.go:692) ----

    def apply_eval_update(self, eval: Evaluation, reblock: bool = False) -> None:
        # leader-minted modify stamp, BEFORE the journaled upsert: it
        # rides the `upsert_eval` log entry (like `now=` in
        # `_create_eval`), so replay stays deterministic while
        # submit→complete latency is readable from the struct (the
        # bench `e2e_slo` tail reads modify_time − create_time)
        eval.modify_time = time.time()
        self.state.upsert_eval(eval)
        if reblock or eval.should_block():
            self.blocked.block(eval)
            for dup in self.blocked.duplicates():
                dup.status = EVAL_STATUS_CANCELLED
                dup.status_description = "cancelled due to duplicate blocked eval"
                self.state.upsert_eval(dup)
        elif eval.should_enqueue():
            self.broker.enqueue(eval)

    def _create_eval(self, **kwargs) -> Evaluation:
        eval = Evaluation(**kwargs)
        eval.create_time = eval.modify_time = time.time()
        # distributed-trace binding: when this eval is being
        # created under an ingress trace (HTTP submit / forwarded RPC —
        # the transport restored the context onto this thread), mint the
        # eval's OWN span as a child and stamp it on the struct BEFORE
        # the raft write — leader-minted like the timestamps above, so
        # apply stays a pure function of the log (NLR01).
        from ..lib import tracectx

        caller = tracectx.current()
        if caller is not None and tracectx.trace_enabled():
            child = caller.child()
            eval.trace_id = child.trace_id
            eval.trace_span_id = child.span_id
            eval.trace_parent_span_id = child.parent_span_id
        self.apply_eval_update(eval)
        return eval

    def job_evaluate(self, namespace: str, job_id: str) -> Evaluation:
        """Force a fresh evaluation for an unchanged job — `nomad job
        eval` (job_endpoint.go:710 Evaluate): re-runs the scheduler,
        e.g. after manual node repairs, without a re-register."""
        job = self.state.job_by_id(namespace, job_id)
        if job is None:
            raise ValueError(f"job {job_id!r} not found")
        if job.is_periodic():
            raise ValueError("can't evaluate a periodic job "
                             "(force it instead)")
        if job.is_parameterized():
            # a parameterized template only runs via dispatch children;
            # register never evaluates it and neither may a forced eval
            raise ValueError("can't evaluate a parameterized job "
                             "(dispatch it instead)")
        return self._create_eval(
            namespace=namespace, job_id=job_id, type=job.type,
            priority=job.priority, job_modify_index=job.modify_index,
            triggered_by=TRIGGER_JOB_REGISTER,
            status=EVAL_STATUS_PENDING)

    # ---- Job endpoint (job_endpoint.go:79) ----

    def job_register(self, job: Job) -> Optional[Evaluation]:
        # Held across _enforce_quota → upsert_job so concurrent registers
        # cannot both pass the quota check under the limit (the reference
        # serializes admission through the leader's raft apply).
        with self._admission_lock:
            return self._job_register(job)

    def _job_register(self, job: Job) -> Optional[Evaluation]:
        # connect admission hook (job_endpoint_hook_connect.go Mutate
        # :90): inject the native-mesh sidecar proxy task/port/
        # registration BEFORE validation and upsert so schedulers and
        # clients see the full group
        from ..structs.connect import inject_sidecars, validate_connect

        cerr = validate_connect(job)
        if cerr:
            raise ValueError(cerr)
        inject_sidecars(job)
        err = job.validate() if hasattr(job, "validate") else None
        if err:
            raise ValueError(err)
        if self.state.namespace_by_name(job.namespace) is None:
            # the reference rejects registration into a namespace that
            # does not exist (job_endpoint.go Register → ns lookup)
            raise ValueError(
                f"namespace {job.namespace!r} does not exist")
        self._enforce_quota(job)
        if job.is_periodic() and job.periodic.spec_type == "cron":
            # Reject a bad cron spec BEFORE the job reaches state
            # (job_endpoint.go Register → Job.Validate → PeriodicConfig).
            from .periodic import CronExpr

            CronExpr.parse(job.periodic.spec)
        existing = self.state.job_by_id(job.namespace, job.id)
        prior_policies = {
            sp.target.get("Group", ""): sp.id
            for sp in (existing.scaling_policies if existing else ())}
        for sp in job.scaling_policies:
            # Policy IDs are server-assigned and STABLE across re-registers
            # (job_endpoint.go Register → ScalingPolicy canonicalization,
            # state/schema.go:793 table keyed by ID): carry the existing
            # ID over by target group so an identical resubmit stays
            # spec-unchanged (idempotent register path below).
            if not sp.id:
                sp.id = (prior_policies.get(sp.target.get("Group", ""))
                         or fast_uuid())
            sp.target.setdefault("Namespace", job.namespace)
            sp.target.setdefault("Job", job.id)
        if existing is not None and existing.job_modify_index:
            if not job.spec_changed(existing):
                # Idempotent re-register: keep the version AND the version's
                # bookkeeping (stable flag feeds auto-revert) so the
                # reconciler doesn't treat every alloc as a destructive
                # update (reference job_endpoint.go Register + SpecChanged).
                job.version = existing.version
                job.stable = existing.stable
                job.status = existing.status
            else:
                job.version = existing.version + 1
        self.state.upsert_job(job)
        if job.is_periodic() or job.is_parameterized():
            # Periodic/parameterized jobs produce no eval at register time:
            # the dispatcher (or Job.Dispatch) creates child jobs later
            # (job_endpoint.go:79 Register → periodicDispatcher.Add).
            if job.is_periodic():
                self.periodic.add(job)
            return None
        return self._create_eval(
            namespace=job.namespace,
            priority=job.priority,
            type=job.type,
            triggered_by=TRIGGER_JOB_REGISTER,
            job_id=job.id,
            job_modify_index=job.modify_index,
            status=EVAL_STATUS_PENDING,
        )

    def job_deregister(self, namespace: str, job_id: str) -> Optional[Evaluation]:
        import copy

        job = self.state.job_by_id(namespace, job_id)
        if job is None:
            return None
        job = copy.copy(job)  # snapshots keep the pre-stop view
        job.stop = True
        self.state.upsert_job(job)
        self._scaling_events.pop((namespace, job_id), None)
        if job.is_periodic():
            self.periodic.remove(namespace, job_id)
        return self._create_eval(
            namespace=namespace,
            priority=job.priority,
            type=job.type,
            triggered_by=TRIGGER_JOB_DEREGISTER,
            job_id=job_id,
            job_modify_index=job.modify_index,
            status=EVAL_STATUS_PENDING,
        )

    # ---- Node endpoint (node_endpoint.go) ----

    def node_register(self, node: Node) -> None:
        if not node.computed_class:
            node.compute_class()
        # the identity secret is WRITE-ONCE (reference
        # node_endpoint.go:TOFU — Register rejects a SecretID change):
        # registration is itself an unauthenticated forwarded RPC, so a
        # mutable secret would let any peer overwrite a live node's
        # credential (hijack the connect_issue identity, or deny the
        # real node its next issuance). First registration binds it;
        # re-registering must present the bound secret. Check and
        # upsert are ONE atom under this id's identity lock — otherwise
        # two racing first registrations both pass the check and the
        # binding goes to whichever loses the upsert race.
        import hmac

        with self._node_identity_locks_mu:
            id_lock = self._node_identity_locks.setdefault(
                node.id, threading.Lock())
        with id_lock:
            was = self.state.node_by_id(node.id)
            if was is not None and was.secret_id:
                # bytes, not str: compare_digest on str raises on
                # non-ASCII — a deny must never become a 500
                if not hmac.compare_digest(
                        was.secret_id.encode(),
                        (node.secret_id or "").encode()):
                    self.metrics.inc("node.register_denied")
                    raise PermissionError(
                        f"node_register denied for {node.id!r}: identity "
                        f"secret does not match the registered one")
            self.state.upsert_node(node)
        self.heartbeater.reset(node.id)
        if node.status == NODE_STATUS_READY:
            # capacity may have appeared (node_endpoint.go:270)
            self.blocked.unblock(node.computed_class, self.state.index.value)
            if was is None or not was.ready():
                self._create_node_evals_for_system_jobs(node)

    def node_heartbeat(self, node_id: str,
                       device_stats: Optional[dict] = None) -> dict:
        """Heartbeat ack + the live server set (node_endpoint.go
        UpdateStatus responses carry NodeServerInfo so clients keep
        their failover list current; client/servers/manager.go).
        Device stats ride the heartbeat and live OFF-raft — they are
        ephemeral telemetry (the devicemanager stats stream), surfaced
        on /v1/node/<id>, never worth a replicated write per tick."""
        servers = []
        fn = getattr(self, "server_addrs_fn", None)
        if fn is not None:
            try:
                servers = [list(a) for a in fn()]
            except Exception:  # noqa: BLE001 — advisory payload only
                pass
        node = self.state.node_by_id(node_id)
        if node is None:
            return {"ok": False, "servers": servers}
        self.heartbeater.reset(node_id)
        if device_stats:
            self._node_device_stats[node_id] = {
                "stats": device_stats, "collected_at": time.time()}
        return {"ok": True, "servers": servers}

    def node_device_stats(self, node_id: str) -> Optional[dict]:
        """Latest heartbeat-carried device stats for a node (or None)."""
        return self._node_device_stats.get(node_id)

    def _drop_node_device_stats(self, node_id: str) -> None:
        """Evict telemetry when a node leaves (purge/GC/down) — the map
        would otherwise grow forever under node churn."""
        self._node_device_stats.pop(node_id, None)

    def _heartbeat_expired(self, node_id: str) -> None:
        """TTL missed → mark down + create evals (heartbeat.go:135).
        Counted + flight-recorded: a soak losing
        clients silently is exactly what the recorder exists to show."""
        self._ctr_hb_expired.inc()
        from ..lib.flight import default_flight

        try:
            default_flight().record(
                "heartbeat.expired", key=node_id, severity="warn",
                detail={"ttl_s": self.config.heartbeat_ttl})
        except Exception:  # noqa: BLE001 — telemetry only
            pass
        self.node_update_status(node_id, NODE_STATUS_DOWN,
                                "heartbeat missed")

    def node_update_status(self, node_id: str, status: str,
                           description: str = "") -> List[Evaluation]:
        import copy

        node = self.state.node_by_id(node_id)
        if node is None:
            return []
        node = copy.copy(node)
        node.status = status
        node.status_description = description
        self.state.upsert_node(node)
        evals = []
        if status == NODE_STATUS_DOWN:
            self.heartbeater.remove(node_id)
            evals = self._create_node_evals(node_id)
        elif status == NODE_STATUS_READY:
            self.heartbeater.reset(node_id)
            self.blocked.unblock(node.computed_class, self.state.index.value)
            self.blocked.unblock_node(node_id, self.state.index.value)
        return evals

    def node_purge(self, node_id: str) -> List[Evaluation]:
        """Remove a node from state entirely (Node.Deregister,
        nomad/node_endpoint.go:388 — the API's PUT /v1/node/:id/purge):
        its allocs get node-update evals so the scheduler replaces them,
        then the row is gone."""
        node = self.state.node_by_id(node_id)
        if node is None:
            raise ValueError(f"node {node_id!r} not found")
        self.heartbeater.remove(node_id)
        self._drop_node_device_stats(node_id)
        # delete FIRST: a worker that dequeues the eval must already see
        # the node gone (missing ⇒ tainted/lost), or it no-ops while the
        # node still looks ready and the allocs are stranded forever
        self.state.delete_node(node_id)
        self._drop_node_identity_lock(node_id)
        evals = self._create_node_evals(node_id)
        return evals

    def _drop_node_identity_lock(self, node_id: str) -> None:
        """Release a deleted node's registration-identity stripe — the
        stripe dict otherwise grows with every lifetime-distinct node
        id (ephemeral clients mint fresh uuids)."""
        with self._node_identity_locks_mu:
            self._node_identity_locks.pop(node_id, None)

    def node_update_drain(self, node_id: str, drain) -> List[Evaluation]:
        import copy

        node = self.state.node_by_id(node_id)
        if node is None:
            return []
        node = copy.copy(node)
        node.drain = drain
        # Draining nodes are never placement targets; a cancelled drain
        # restores eligibility (node_endpoint.go:505 UpdateDrain).
        node.scheduling_eligibility = (
            "ineligible" if drain is not None else "eligible"
        )
        self.state.upsert_node(node)
        self.drainer.update(node)
        return self._create_node_evals(node_id)

    def node_update_eligibility(self, node_id: str, eligibility: str) -> None:
        import copy

        node = self.state.node_by_id(node_id)
        if node is None:
            return
        node = copy.copy(node)
        node.scheduling_eligibility = eligibility
        self.state.upsert_node(node)
        if eligibility == "eligible":
            self.blocked.unblock(node.computed_class, self.state.index.value)

    def _create_node_evals(self, node_id: str) -> List[Evaluation]:
        """One eval per job with allocs on the node (node_endpoint.go:178)."""
        jobs = {}
        for a in self.state.allocs_by_node(node_id):
            if a.job is not None:
                jobs[(a.namespace, a.job_id)] = a.job
        evals = []
        for (ns, job_id), job in jobs.items():
            evals.append(self._create_eval(
                namespace=ns,
                priority=job.priority,
                type=job.type,
                triggered_by=TRIGGER_NODE_UPDATE,
                job_id=job_id,
                node_id=node_id,
                node_modify_index=self.state.index.value,
                status=EVAL_STATUS_PENDING,
            ))
        return evals

    def _create_node_evals_for_system_jobs(self, node: Node) -> None:
        """New ready node → evaluate system jobs (node_endpoint.go:178 path)."""
        for job in self.state.jobs():
            if job.type == "system" and node.datacenter in job.datacenters:
                self._create_eval(
                    namespace=job.namespace,
                    priority=job.priority,
                    type=job.type,
                    triggered_by=TRIGGER_NODE_UPDATE,
                    job_id=job.id,
                    node_id=node.id,
                    status=EVAL_STATUS_PENDING,
                )

    def node_get_client_allocs(self, node_id: str, min_index: int = 0,
                               timeout: float = 30.0
                               ) -> Tuple[int, Dict[str, int]]:
        """Blocking query for a client's alloc set (node_endpoint.go:926
        GetClientAllocs): returns (index, {alloc_id: alloc_modify_index}).
        Unblocks when any alloc on the node changes."""

        def fetch(snap):
            allocs = snap.allocs_by_node(node_id)
            idx = max([a.modify_index for a in allocs], default=0)
            return idx, {a.id: a.modify_index for a in allocs}

        return self.state.blocking_query(fetch, min_index=min_index,
                                         timeout=timeout)

    def alloc_get(self, alloc_id: str) -> Optional[Allocation]:
        """Alloc fetch for the client pull loop (alloc_endpoint.go GetAlloc)."""
        return self.state.alloc_by_id(alloc_id)

    # ---- service registrations (built-in service discovery; the
    # reference's Consul service sync — nomad/consul.go — replaced by
    # state-store-native registrations pushed over the RPC fabric) ----

    def update_service_registrations(self, regs) -> None:
        self.state.upsert_service_registrations(regs)

    def remove_service_registrations(self, alloc_id: str) -> None:
        self.state.delete_service_registrations_by_alloc(alloc_id)

    # ---- namespaces (structs/operator.py Namespace; the reference's
    # nomad/namespace_endpoint.go, OSS since 1.0) ----

    def namespace_upsert(self, ns) -> None:
        import re

        if not re.fullmatch(r"[a-zA-Z0-9][a-zA-Z0-9_-]{0,127}", ns.name):
            raise ValueError(f"invalid namespace name {ns.name!r}")
        if getattr(ns, "quota", "") \
                and self.state.quota_by_name(ns.quota) is None:
            raise ValueError(f"quota {ns.quota!r} does not exist")
        self.state.upsert_namespace(ns)

    def namespace_delete(self, name: str) -> None:
        if name == "default":
            raise ValueError("default namespace cannot be deleted")
        if self.state.namespace_by_name(name) is None:
            raise ValueError(f"namespace {name!r} not found")
        in_use = [j.id for j in self.state.jobs()
                  if j.namespace == name and not j.stop]
        if in_use:
            raise ValueError(
                f"namespace {name!r} has non-terminal jobs: "
                f"{in_use[:5]}")
        vols = [v.id for v in self.state.csi_volumes()
                if v.namespace == name]
        if vols:
            raise ValueError(
                f"namespace {name!r} has CSI volumes: {vols[:5]}")
        # KV secrets cascade with the delete (state mutator) — they must
        # not survive to re-attach to a future namespace of this name
        self.state.delete_namespace(name)

    # ---- quotas (the reference's enterprise QuotaSpec, enforced at job
    # admission with spec-based accounting) ----

    def quota_upsert(self, q) -> None:
        import re

        if not re.fullmatch(r"[a-zA-Z0-9][a-zA-Z0-9_-]{0,127}", q.name):
            raise ValueError(f"invalid quota name {q.name!r}")
        if q.cpu < 0 or q.memory_mb < 0:
            raise ValueError("quota limits must be >= 0")
        self.state.upsert_quota(q)

    def quota_delete(self, name: str) -> None:
        if self.state.quota_by_name(name) is None:
            raise ValueError(f"quota {name!r} not found")
        attached = [n.name for n in self.state.namespaces()
                    if n.quota == name]
        if attached:
            raise ValueError(
                f"quota {name!r} attached to namespaces: {attached}")
        self.state.delete_quota(name)

    @staticmethod
    def _job_requested(job: Job) -> Tuple[float, float]:
        """Spec-requested (cpu, memory_mb) for a whole job: Σ group count
        × the group's combined task resources."""
        cpu = mem = 0.0
        for tg in job.task_groups:
            res = job.combined_task_resources(tg)
            cpu += tg.count * res.cpu
            mem += tg.count * res.memory_mb
        return cpu, mem

    def _quota_totals(self, quota_name: str,
                      exclude: Optional[Tuple[str, str]] = None
                      ) -> Tuple[float, float, set]:
        """(cpu, memory) requested across the quota's attached
        namespaces: non-stopped, non-template jobs, optionally excluding
        one (namespace, job_id) — the single accounting rule shared by
        enforcement and the usage report so they can never diverge."""
        ns_names = {n.name for n in self.state.namespaces()
                    if n.quota == quota_name}
        cpu = mem = 0.0
        for job in self.state.jobs():
            if job.namespace not in ns_names or job.stop \
                    or job.is_parameterized() or job.is_periodic():
                continue
            if exclude is not None \
                    and (job.namespace, job.id) == exclude:
                continue
            c, m = self._job_requested(job)
            cpu += c
            mem += m
        return cpu, mem, ns_names

    def quota_usage(self, name: str) -> dict:
        """Spec-based usage across every namespace attached to the
        quota."""
        cpu, mem, ns_names = self._quota_totals(name)
        q = self.state.quota_by_name(name)
        return {"quota": name, "cpu_used": cpu, "memory_mb_used": mem,
                "cpu_limit": q.cpu if q else 0,
                "memory_mb_limit": q.memory_mb if q else 0,
                "namespaces": sorted(ns_names)}

    def _enforce_quota(self, job: Job) -> None:
        """Admission check (the ent reference rejects Register when the
        namespace's quota would be exceeded). Spec-based: deterministic
        and plan-independent. Periodic/parameterized parents are
        templates — their children are charged when dispatched."""
        ns = self.state.namespace_by_name(job.namespace)
        if ns is None or not getattr(ns, "quota", ""):
            return
        q = self.state.quota_by_name(ns.quota)
        if q is None or (not q.cpu and not q.memory_mb):
            return
        if job.is_parameterized() or job.is_periodic() or job.stop:
            return
        req_cpu, req_mem = self._job_requested(job)
        used_cpu, used_mem, _ = self._quota_totals(
            ns.quota, exclude=(job.namespace, job.id))
        if q.cpu and used_cpu + req_cpu > q.cpu:
            raise ValueError(
                f"quota {q.name!r} exceeded: cpu "
                f"{used_cpu + req_cpu:.0f} > limit {q.cpu}")
        if q.memory_mb and used_mem + req_mem > q.memory_mb:
            raise ValueError(
                f"quota {q.name!r} exceeded: memory "
                f"{used_mem + req_mem:.0f} MB > limit {q.memory_mb} MB")

    # ---- secrets KV (the Vault-analog engine; nomad/vault.go's role
    # collapsed into replicated state — see structs/secrets.py) ----

    @staticmethod
    def _check_secret_ns(namespace: str) -> None:
        """The `nomad/` namespace prefix is reserved for framework
        internals (the mesh CA key lives at nomad/connect:ca) — the
        public secrets surface must not read, overwrite, or delete it:
        a readable CA key lets anyone mint mesh leaf certs, and a
        delete silently splits the mesh onto a fresh CA."""
        if namespace.startswith("nomad/"):
            raise PermissionError(f"namespace {namespace!r} is reserved")

    def secret_upsert(self, entry) -> None:
        self._check_secret_ns(entry.namespace)
        if not entry.path or entry.path.startswith("/") \
                or ".." in entry.path.split("/"):
            raise ValueError(f"invalid secret path {entry.path!r}")
        self.state.upsert_secret(entry)

    def secret_delete(self, namespace: str, path: str) -> None:
        self._check_secret_ns(namespace)
        self.state.delete_secret(namespace, path)

    def secret_get(self, namespace: str, path: str):
        self._check_secret_ns(namespace)
        return self.state.secret_get(namespace, path)

    def node_get(self, node_id: str):
        """Node lookup for clients (remote ephemeral-disk migration
        resolves the previous node's advertised HTTP address; the
        reference ships Node info to clients the same way for
        allocwatcher migration).

        The returned view REDACTS the node identity secret: node_get is
        a forwarded fabric RPC (cluster.FORWARDED), and serving
        `secret_id` here would hand any peer exactly the credential
        `connect_issue` verifies — the HTTP node surface redacts it for
        the same reason (agent/http.py node_wire)."""
        import dataclasses

        node = self.state.node_by_id(node_id)
        if node is None:
            return None
        return dataclasses.replace(node, secret_id="")

    def services_lookup(self, namespace: str, name: str):
        """Catalog lookup for client-side template rendering (the
        consul-template `service` function's data source; this build
        reads the native catalog instead of a Consul agent)."""
        return self.state.services_by_name(namespace, name)

    # ---- mesh intentions (Consul Connect intentions analog) ----
    #
    # Source→destination allow/deny rules enforced by the DESTINATION
    # sidecar against the dialing peer's leaf-cert CN (its service
    # name). Stored in the reserved secrets namespace — raft-replicated
    # with everything else, invisible to the public secrets surface.
    # Reference: Consul intentions consumed by the reference's Connect
    # integration (nomad/consul.go SI-token/ACL flow).

    @staticmethod
    def _check_intention(source: str, destination: str) -> None:
        import re

        for v in (source, destination):
            if not re.fullmatch(r"[A-Za-z0-9_.-]+|\*", v or ""):
                raise ValueError(f"invalid intention name {v!r}")

    def connect_intention_upsert(self, source: str, destination: str,
                                 action: str) -> None:
        from ..structs.secrets import SecretEntry

        self._check_intention(source, destination)
        if action not in ("allow", "deny"):
            raise ValueError(f"invalid intention action {action!r}")
        self.state.upsert_secret(SecretEntry(
            namespace=self.CONNECT_NS,
            path=f"intention/{destination}/{source}",
            data={"action": action}))

    def connect_intention_delete(self, source: str,
                                 destination: str) -> None:
        self._check_intention(source, destination)
        self.state.delete_secret(
            self.CONNECT_NS, f"intention/{destination}/{source}")

    def connect_intentions_list(self) -> list:
        out = []
        for e in self.state.secrets_list(self.CONNECT_NS):
            parts = e.path.split("/")
            if len(parts) == 3 and parts[0] == "intention":
                out.append({"source": parts[2], "destination": parts[1],
                            "action": e.data.get("action", "allow")})
        return sorted(out, key=lambda r: (r["destination"], r["source"]))

    def connect_intentions_for(self, destination: str) -> list:
        """Rules whose destination is `destination` or the wildcard —
        what that service's sidecar enforces inbound."""
        return [r for r in self.connect_intentions_list()
                if r["destination"] in (destination, "*")]

    # ---- native mesh CA (the Consul Connect CA analog) ----

    #: reserved secrets namespace holding the mesh CA — raft-replicated
    #: with everything else, invisible to task secret paths (those are
    #: read from the TASK's namespace)
    CONNECT_NS = "nomad/connect"

    def _node_runs_service(self, node_id: str, service_name: str) -> bool:
        """True iff `node_id` has a live (non-terminal) SERVER-PLACED
        allocation whose job spec declares `service_name`. Deliberately
        reads the job spec embedded in/behind the alloc — NOT the
        client-pushed service-registration rows, which any node agent
        can write for any name (unauthenticated fabric)."""
        for a in self.state.allocs_by_node(node_id):
            if a.terminal_status():
                continue
            job = a.job or self.state.job_by_id(a.namespace, a.job_id)
            if job is None:
                continue
            for tg in job.task_groups:
                if a.task_group and tg.name != a.task_group:
                    continue
                if any(s.name == service_name for s in tg.services):
                    return True
                for task in tg.tasks:
                    if any(s.name == service_name
                           for s in task.services):
                        return True
        return False

    def connect_issue(self, service_name: str, node_id: str = "",
                      secret_id: str = "") -> dict:
        """Issue a leaf certificate for one sidecar proxy, signed by the
        cluster's connect CA (lazily created, stored in the replicated
        secrets table so every server signs with the same root —
        Consul's Connect CA model). Returns PEM strings.

        Issuance verifies the REQUESTING NODE'S identity first (ADVICE
        r5: this used to be an unauthenticated forwarded RPC — any
        fabric peer could mint a leaf for an arbitrary service CN and
        walk through intention deny rules). The caller presents its
        node id + identity secret (structs.Node.secret_id, generated
        client-side, registered with the node); an unknown node or a
        secret mismatch rejects with PermissionError and counts
        `connect.issue_denied` — the reference ties issuance to the
        allocation via SI tokens/ACLs, this is the node-identity half.

        Reference analog: Envoy sidecars receive leaf certs from
        Consul's CA (`plugins`/SI-token flow); here the server IS the
        CA and the client writes the PEMs into the proxy task's secrets
        dir (client/task_runner.py connect hook)."""
        import os
        import tempfile

        import hmac

        node = self.state.node_by_id(node_id) if node_id else None
        # a node with NO registered secret must deny (an empty==empty
        # match would let any peer mint from a public node id, e.g. a
        # row restored from pre-upgrade state); constant-time compare
        if node is None or not node.secret_id \
                or not hmac.compare_digest(
                    node.secret_id.encode(),
                    (secret_id or "").encode()):
            self.metrics.inc("connect.issue_denied")
            self.metrics.inc("connect.issue_denied_identity")
            raise PermissionError(
                f"connect_issue denied for service {service_name!r}: "
                f"node identity not verified (unknown node or secret "
                f"mismatch for {node_id!r})")

        # Allocation binding (the SI-token half of the reference model):
        # a verified node may only mint leaves for services its OWN live,
        # server-placed allocations declare. Without this, any registered
        # client could mint a cert for an arbitrary service CN and walk
        # through intention deny rules from a foothold on one node.
        if not self._node_runs_service(node_id, service_name):
            self.metrics.inc("connect.issue_denied")
            self.metrics.inc("connect.issue_denied_no_alloc")
            raise PermissionError(
                f"connect_issue denied for service {service_name!r}: "
                f"node {node_id!r} runs no live allocation whose job "
                f"declares that service")

        from ..lib import tlsutil
        from ..structs.secrets import SecretEntry

        with self._connect_ca_lock:
            entry = self.state.secret_get(self.CONNECT_NS, "ca")
            if entry is None:
                with tempfile.TemporaryDirectory() as d:
                    cert_p, key_p = tlsutil.generate_ca(
                        d, cn="nomad-tpu-connect-ca")
                    with open(cert_p) as f:
                        ca_pem = f.read()
                    with open(key_p) as f:
                        ca_key_pem = f.read()
                self.state.upsert_secret(SecretEntry(
                    namespace=self.CONNECT_NS, path="ca",
                    data={"cert": ca_pem, "key": ca_key_pem}))
            else:
                ca_pem = entry.data["cert"]
                ca_key_pem = entry.data["key"]
        with tempfile.TemporaryDirectory() as d:
            ca_cert_p = os.path.join(d, "ca.pem")
            ca_key_p = os.path.join(d, "ca-key.pem")
            with open(ca_cert_p, "w") as f:
                f.write(ca_pem)
            with open(ca_key_p, "w") as f:
                f.write(ca_key_pem)
            cert_p, key_p = tlsutil.issue_cert(
                d, ca_cert_p, ca_key_p, cn=service_name,
                sans=[service_name, "localhost"], name="leaf")
            with open(cert_p) as f:
                cert_pem = f.read()
            with open(key_p) as f:
                key_pem = f.read()
        return {"ca": ca_pem, "cert": cert_pem, "key": key_pem}

    def secrets_list(self, namespace: str):
        self._check_secret_ns(namespace)
        return self.state.secrets_list(namespace)

    def node_update_allocs(self, updates: List[Allocation]) -> None:
        """Client pushes alloc status (node_endpoint.go:1013 UpdateAlloc):
        merge; terminal allocs free capacity (unblock) and failed allocs
        trigger reschedule evals."""
        jobs_to_eval: Dict[Tuple[str, str], Job] = {}
        for up in updates:
            # SLO observe point: the FIRST transition to
            # client_status=running closes the submit→alloc-start
            # latency window. Read the pre-merge status here, leader-
            # side — never inside update_alloc_from_client, which is an
            # apply-path ALLOWED_OPS method (NLR01).
            prev = self.state.alloc_by_id(up.id)
            merged = self.state.update_alloc_from_client(up)
            if merged is None:
                continue
            if merged.client_status == "running" and (
                    prev is None or prev.client_status != "running"):
                self._observe_slo_start(merged)
            if merged.terminal_status():
                node = self.state.node_by_id(merged.node_id)
                if node is not None:
                    self.blocked.unblock(
                        node.computed_class, self.state.index.value
                    )
                    self.blocked.unblock_node(node.id, self.state.index.value)
                if merged.client_status == "failed" and merged.job is not None:
                    jobs_to_eval[(merged.namespace, merged.job_id)] = merged.job
        for (ns, job_id), job in jobs_to_eval.items():
            self._create_eval(
                namespace=ns,
                priority=job.priority,
                type=job.type,
                triggered_by=TRIGGER_RETRY_FAILED_ALLOC,
                job_id=job_id,
                status=EVAL_STATUS_PENDING,
            )

    def _observe_slo_start(self, alloc: Allocation) -> None:
        """Feed one alloc's submit→start latency into the SLO tracker:
        latency is now − the creating eval's create_time (the ingress
        stamp), band from the eval's priority. Telemetry only — any
        miss (evicted eval, restored state) is a silent skip."""
        try:
            ev = self.state.eval_by_id(alloc.eval_id)
            if ev is None or not ev.create_time:
                return
            latency_ms = max(time.time() - ev.create_time, 0.0) * 1e3
            self.slo.observe(ev.priority, latency_ms)
        except Exception:  # noqa: BLE001 — telemetry only
            pass

    # ---- Deployment endpoint (nomad/deployment_endpoint.go) ----

    def deployment_promote(self, deployment_id: str, groups=None):
        return self.deployments_watcher.promote(deployment_id, groups)

    def deployment_fail(self, deployment_id: str):
        return self.deployments_watcher.fail(deployment_id)

    def deployment_pause(self, deployment_id: str, pause: bool) -> None:
        self.deployments_watcher.pause(deployment_id, pause)

    def update_alloc_health(self, alloc_id: str, healthy: bool) -> None:
        """Client (alloc health watcher) reports deployment health
        (reference Deployment.SetAllocHealth / client allochealth push)."""
        import copy as _copy

        from ..structs import AllocDeploymentStatus

        existing = self.state.alloc_by_id(alloc_id)
        if existing is None:
            return
        merged = _copy.copy(existing)
        ds = merged.deployment_status or AllocDeploymentStatus()
        ds = _copy.copy(ds)
        ds.healthy = healthy
        ds.timestamp = time.time()
        merged.deployment_status = ds
        self.state.upsert_alloc(merged)
        self.deployments_watcher.notify()

    # ---- test/ops helpers ----

    # ---- CSI volume endpoints (nomad/csi_endpoint.go) ----

    def csi_volume_register(self, vol) -> None:
        if not vol.id or not vol.plugin_id:
            raise ValueError("CSI volume requires id and plugin_id")
        self.state.upsert_csi_volume(vol)

    def csi_volume_deregister(self, namespace: str, vol_id: str,
                              force: bool = False) -> None:
        vol = self.state.csi_volume(namespace, vol_id)
        if vol is None:
            return
        if vol.in_use() and not force:
            raise ValueError(f"volume {vol_id!r} has active claims")
        self.state.delete_csi_volume(namespace, vol_id)

    def csi_volume_claim(self, namespace: str, vol_id: str, alloc_id: str,
                         mode: str) -> bool:
        """Client claims a volume for an alloc (CSIVolume.Claim RPC).

        Controller-required volumes additionally get a ControllerPublish
        queued for the alloc's node (csi_endpoint.go:458
        controllerPublishVolume) — a controller host drains it via
        csi_controller_poll and the claiming client waits for the node's
        publish context before staging."""
        ok = self.state.csi_volume_claim(namespace, vol_id, alloc_id, mode)
        if not ok:
            return False
        vol = self.state.csi_volume(namespace, vol_id)
        if vol is not None and vol.controller_required:
            alloc = self.state.alloc_by_id(alloc_id)
            node_id = alloc.node_id if alloc is not None else ""
            if node_id:
                # requested unconditionally: the state op is what knows
                # whether the node is attached, queued, or has a pending
                # DETACH that this claim must cancel
                # positional: the durable/raft store wrappers journal
                # positional args only
                self.state.csi_controller_request(
                    namespace, vol_id, node_id, "publish", mode == "read")
        return True

    def csi_volume_get(self, namespace: str, vol_id: str):
        """Client fetches a volume for the mount path (CSIVolume.Get)."""
        return self.state.csi_volume(namespace, vol_id)

    def csi_controller_poll(self, node_id: str):
        """Queued controller ops for the controller plugins this node
        hosts (the pull analog of ClientCSI.ControllerAttachVolume —
        clients poll for work instead of the server dialing them)."""
        node = self.state.node_by_id(node_id)
        pids = list((node.csi_controller_plugins or {}).keys()) \
            if node is not None else []
        if not pids:
            return []
        return self.state.csi_controller_pending(pids, lessee=node_id)

    def csi_controller_done(self, namespace: str, vol_id: str,
                            node_id: str, op: str, context=None,
                            error: str = "", reporter: str = "",
                            gen: int = 0) -> None:
        """A controller host reports a publish/unpublish result.

        The superseded-lessee guard runs HERE, before the state op is
        journaled: the state mutation is raft-replayed on followers whose
        lease tables are empty, so any lease-dependent decision inside it
        would diverge between leader and replica. Dropping the report at
        ingress keeps the journal itself deterministic."""
        lease = None
        lease_fn = getattr(self.state, "csi_controller_lease", None)
        if lease_fn is not None:
            lease = lease_fn(namespace, vol_id, node_id)
        if lease is not None and reporter and lease[0] != reporter:
            return  # superseded host reporting late: discard
        self.state.csi_controller_done(namespace, vol_id, node_id, op,
                                       context, error, reporter, gen)

    # ---- scaling (nomad/job_endpoint.go:969 Scale + scaling policies) ----

    #: Job.Dispatch payload ceiling (nomad/job_endpoint.go:1616
    #: DispatchPayloadSizeLimit = 16 KiB)
    DISPATCH_PAYLOAD_SIZE_LIMIT = 16 * 1024

    def job_dispatch(self, namespace: str, job_id: str,
                     payload: bytes = b"",
                     meta: Optional[Dict[str, str]] = None
                     ) -> Tuple[Job, Optional[Evaluation]]:
        """Instantiate a parameterized job (Job.Dispatch,
        nomad/job_endpoint.go:1634): validate payload presence/size and
        meta keys against the parameterized stanza, then register a
        dispatched child job carrying the payload."""
        import copy

        parent = self.state.job_by_id(namespace, job_id)
        if parent is None:
            raise ValueError(f"job {job_id!r} not found")
        if not parent.is_parameterized():
            raise ValueError(f"job {job_id!r} is not parameterized")
        if parent.stop:
            raise ValueError(f"job {job_id!r} is stopped")
        cfg = parent.parameterized
        payload = bytes(payload or b"")
        meta = dict(meta or {})
        if cfg.payload == "required" and not payload:
            raise ValueError("dispatch payload is required")
        if cfg.payload == "forbidden" and payload:
            raise ValueError("dispatch payload is forbidden")
        if len(payload) > self.DISPATCH_PAYLOAD_SIZE_LIMIT:
            raise ValueError(
                f"dispatch payload exceeds maximum size of "
                f"{self.DISPATCH_PAYLOAD_SIZE_LIMIT} bytes")
        missing = sorted(k for k in cfg.meta_required if k not in meta)
        if missing:
            raise ValueError(f"missing required dispatch meta: {missing}")
        allowed = set(cfg.meta_required) | set(cfg.meta_optional)
        extra = sorted(k for k in meta if k not in allowed)
        if extra:
            raise ValueError(f"dispatch meta not allowed: {extra}")
        child = copy.deepcopy(parent)
        # DispatchedID form (structs.go:3995)
        child.id = (f"{parent.id}/dispatch-{int(time.time())}-"
                    f"{fast_uuid()[:8]}")
        child.parent_id = parent.id
        child.dispatched = True
        child.payload = payload
        child.meta.update(meta)
        child.version = 0
        child.stable = False
        child.periodic = None
        for sp in child.scaling_policies:
            sp.id = ""  # fresh policy rows keyed to the child job
            sp.target = dict(sp.target, Job=child.id)
        ev = self.job_register(child)
        return child, ev

    def job_versions(self, namespace: str, job_id: str) -> List[Job]:
        """All stored versions, newest first (powers `job history`)."""
        return self.state.job_versions_by_id(namespace, job_id)

    def job_revert(self, namespace: str, job_id: str,
                   version: int) -> Optional[Evaluation]:
        """Re-register a prior version's spec as a NEW version
        (nomad/job_endpoint.go:1069 Revert — revert is roll-forward)."""
        import copy

        cur = self.state.job_by_id(namespace, job_id)
        if cur is None:
            raise ValueError(f"job {job_id!r} not found")
        if version == cur.version:
            raise ValueError(
                f"already at version {version} — nothing to revert")
        target = self.state.job_by_id_and_version(namespace, job_id,
                                                  version)
        if target is None:
            raise ValueError(f"job {job_id!r} has no version {version}")
        j = copy.deepcopy(target)
        j.stop = False
        j.stable = False
        return self.job_register(j)

    def alloc_stop(self, alloc_id: str) -> Optional[Evaluation]:
        """Stop one allocation and let the scheduler replace it
        (nomad/alloc_endpoint.go:220 Stop — desired stop + an eval with
        trigger alloc-stop)."""
        import copy

        alloc = self.state.alloc_by_id(alloc_id)
        if alloc is None:
            raise ValueError(f"alloc {alloc_id!r} not found")
        upd = copy.copy(alloc)
        upd.desired_status = "stop"
        upd.desired_description = "alloc was manually stopped by user"
        self.state.upsert_alloc(upd)
        job = self.state.job_by_id(alloc.namespace, alloc.job_id)
        if job is None or job.stop:
            return None
        return self._create_eval(
            namespace=job.namespace,
            priority=job.priority,
            type=job.type,
            triggered_by=TRIGGER_ALLOC_STOP,
            job_id=job.id,
            job_modify_index=job.modify_index,
            status=EVAL_STATUS_PENDING,
        )

    def job_scale(self, namespace: str, job_id: str, group: str,
                  count: int, message: str = "") -> Optional[Evaluation]:
        with self._admission_lock:  # see job_register
            return self._job_scale(namespace, job_id, group, count,
                                   message)

    def _job_scale(self, namespace: str, job_id: str, group: str,
                   count: int, message: str = "") -> Optional[Evaluation]:
        import copy

        job = self.state.job_by_id(namespace, job_id)
        if job is None:
            raise ValueError(f"job {job_id!r} not found")
        tg = job.lookup_task_group(group)
        if tg is None:
            raise ValueError(f"group {group!r} not found in {job_id!r}")
        for sp in job.scaling_policies:
            if sp.target.get("Group") == group and sp.enabled:
                if not (sp.min <= count <= sp.max):
                    raise ValueError(
                        f"count {count} outside scaling policy bounds "
                        f"[{sp.min}, {sp.max}]")
        previous = tg.count
        job = copy.deepcopy(job)
        job.lookup_task_group(group).count = count
        self._enforce_quota(job)  # scale bypasses job_register
        job.version += 1
        self.state.upsert_job(job)
        ev = self._create_eval(
            namespace=namespace, priority=job.priority, type=job.type,
            triggered_by="job-scaling", job_id=job_id,
            job_modify_index=job.modify_index, status=EVAL_STATUS_PENDING,
        )
        events = self._scaling_events.setdefault((namespace, job_id), {})
        events.setdefault(group, []).append({
            "Time": int(time.time() * 1e9),
            "Count": count,
            "PreviousCount": previous,
            "Message": message,
            "EvalID": ev.id if ev else "",
        })
        del events[group][:-10]  # bounded history (structs.JobScalingEvents)
        return ev

    def job_scale_status(self, namespace: str, job_id: str) -> Dict:
        """Reference `Job.ScaleStatus` (job_endpoint.go:1125) — per-group
        desired/placed/running/healthy counts plus recorded scale events."""
        job = self.state.job_by_id(namespace, job_id)
        if job is None:
            raise ValueError(f"job {job_id!r} not found")
        allocs = self.state.allocs_by_job(namespace, job_id)
        groups: Dict[str, Dict] = {}
        for tg in job.task_groups:
            groups[tg.name] = {
                "Desired": tg.count, "Placed": 0, "Running": 0,
                "Healthy": 0, "Unhealthy": 0,
                "Events": list(self._scaling_events
                               .get((namespace, job_id), {})
                               .get(tg.name, [])),
            }
        for a in allocs:
            g = groups.get(a.task_group)
            if g is None or a.terminal_status():
                continue
            g["Placed"] += 1
            if a.client_status == "running":
                g["Running"] += 1
            ds = getattr(a, "deployment_status", None)
            if ds is not None and getattr(ds, "healthy", None) is not None:
                g["Healthy" if ds.healthy else "Unhealthy"] += 1
        return {"JobID": job_id, "Namespace": namespace,
                "JobStopped": job.stop, "TaskGroups": groups}

    def scaling_policies(self, namespace: Optional[str] = None) -> List:
        out = []
        for job in self.state.jobs():
            if namespace is not None and job.namespace != namespace:
                continue
            for sp in job.scaling_policies:
                out.append(sp)
        return out

    def scaling_policy(self, policy_id: str):
        for sp in self.scaling_policies():
            if sp.id == policy_id:
                return sp
        return None

    # ---- search (nomad/search_endpoint.go fuzzy/prefix search) ----

    SEARCH_CONTEXTS = ("jobs", "nodes", "allocs", "evals", "deployments",
                      "volumes")

    def search(self, prefix: str, context: str = "all",
               namespace: str = "default") -> Dict[str, List[str]]:
        state = self.state
        contexts = (self.SEARCH_CONTEXTS if context in ("", "all")
                    else (context,))
        out: Dict[str, List[str]] = {}

        def matches(ids):
            return sorted(i for i in ids if i.startswith(prefix))[:20]

        for ctx in contexts:
            if ctx == "jobs":
                out[ctx] = matches(j.id for j in state.jobs()
                                   if j.namespace == namespace)
            elif ctx == "nodes":
                out[ctx] = matches(n.id for n in state.nodes())
            elif ctx == "allocs":
                out[ctx] = matches(
                    a.id for a in state.snapshot()._allocs.values()
                    if a.namespace == namespace)
            elif ctx == "evals":
                out[ctx] = matches(e.id for e in state.evals()
                                   if e.namespace == namespace)
            elif ctx == "deployments":
                out[ctx] = matches(d.id for d in state.deployments()
                                   if d.namespace == namespace)
            elif ctx == "volumes":
                out[ctx] = matches(v.id for v in state.csi_volumes()
                                   if v.namespace == namespace)
        return out

    def wait_for_eval(self, eval_id: str, statuses=("complete", "failed"),
                      timeout: float = 10.0) -> Optional[Evaluation]:
        deadline = time.time() + timeout
        while time.time() < deadline:
            ev = self.state.eval_by_id(eval_id)
            if ev is not None and ev.status in statuses:
                return ev
            time.sleep(0.02)
        return None

    def wait_for_allocs(self, namespace: str, job_id: str, n: int,
                        timeout: float = 10.0) -> List[Allocation]:
        deadline = time.time() + timeout
        while time.time() < deadline:
            allocs = [
                a for a in self.state.allocs_by_job(namespace, job_id)
                if not a.terminal_status()
            ]
            if len(allocs) >= n:
                return allocs
            time.sleep(0.02)
        return [
            a for a in self.state.allocs_by_job(namespace, job_id)
            if not a.terminal_status()
        ]
