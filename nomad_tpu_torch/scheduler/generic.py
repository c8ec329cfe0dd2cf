"""GenericScheduler — service & batch scheduling.

Behavioral reference: `scheduler/generic_sched.go` (GenericScheduler :58,
Process :125, process :216, computeJobAllocs :332, computePlacements :468,
findPreferredNode :637, selectOptions/penalty nodes :622).

Placements are grouped per task group and run as ONE kernel call per group
(the kernel's step loop places every missing alloc of the group); the
reference's per-alloc stack.Select loop disappears. Plan-relative state
(stops, earlier groups' placements) rides into the kernel as sparse deltas
(PlanContext).

On the server's batched path the worker sets `select_coordinator` and
`select_order`, and the stack parks each program at the coordinator
(`server/select_batch.py`). A placement that fails with preemption
enabled is retried with eviction: `preemption.find_preemption_placement`
ranks every node on the scheduler's device (K3).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils import fast_uuid
from ..structs import (
    ALLOC_CLIENT_PENDING,
    ALLOC_DESIRED_RUN,
    AllocatedResources,
    AllocatedSharedResources,
    AllocatedTaskResources,
    AllocDeploymentStatus,
    AllocMetric,
    Allocation,
    EVAL_STATUS_BLOCKED,
    EVAL_STATUS_COMPLETE,
    EVAL_STATUS_FAILED,
    Evaluation,
    Job,
    NetworkIndex,
    Plan,
    PlanResult,
    TaskGroup,
)
from ..structs.evaluation import (
    TRIGGER_MAX_PLANS,
)
from ..device import DeviceLike, resolve_device
from ..tensor.cluster import ClusterTensors
from .reconcile import (
    AllocDestructiveResult,
    AllocPlaceResult,
    AllocReconciler,
    ReconcileResults,
    ALLOC_UPDATING,
)
from .stack import PlanContext, TorchStack
from .util import (
    Planner,
    SetStatusError,
    State,
    adjust_queued_allocations,
    fail_network_exhausted,
    generic_alloc_update_fn,
    progress_made,
    proposed_allocs,
    ready_counts_in_dcs,
    resolve_volume_asks,
    retry_max,
    tainted_nodes,
    update_non_terminal_allocs_to_lost,
    update_reschedule_tracker,
)

MAX_SERVICE_ATTEMPTS = 5   # reference generic_sched.go:18
MAX_BATCH_ATTEMPTS = 2     # reference generic_sched.go:22

BLOCKED_EVAL_MAX_PLAN_DESC = (
    "created due to placement conflicts"  # reference generic_sched.go:44
)
BLOCKED_EVAL_FAILED_PLACEMENTS = (
    "created to place remaining allocations"  # reference generic_sched.go:48
)


class GenericScheduler:
    """Reference GenericScheduler (generic_sched.go:58)."""

    def __init__(self, state: State, planner: Planner, cluster: ClusterTensors,
                 is_batch: bool = False, device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        self.state = state
        self.planner = planner
        self.cluster = cluster
        self.batch = is_batch
        self.eval: Optional[Evaluation] = None
        self.job: Optional[Job] = None
        self.plan: Optional[Plan] = None
        self.plan_result: Optional[PlanResult] = None
        self.deployment = None
        self.blocked: Optional[Evaluation] = None
        self.failed_tg_allocs: Dict[str, AllocMetric] = {}
        self.queued_allocs: Dict[str, int] = {}
        self.follow_up_evals: List[Evaluation] = []
        #: set by the worker's batch path (server/select_batch.py) to
        #: fuse this eval's placement runs with its batch-mates'
        self.select_coordinator = None
        #: this eval's position in the drained batch (the chain order)
        self.select_order = 0

    # ---- entry point ----

    def process(self, eval: Evaluation) -> None:
        """Reference Process (generic_sched.go:125)."""
        self.eval = eval
        limit = MAX_BATCH_ATTEMPTS if self.batch else MAX_SERVICE_ATTEMPTS
        err = retry_max(
            limit, self._process, lambda: progress_made(self.plan_result)
        )
        if err is not None:
            if isinstance(err, SetStatusError):
                self._create_blocked_eval(plan_failure=True)
                self._set_status(EVAL_STATUS_FAILED, str(err))
                return
            raise err

        if eval.status == EVAL_STATUS_BLOCKED and self.failed_tg_allocs:
            new_eval = Evaluation(**{**eval.__dict__})
            self.planner.reblock_eval(new_eval)
            return
        self._set_status(EVAL_STATUS_COMPLETE, "")

    def _set_status(self, status: str, desc: str) -> None:
        """Reference setStatus (util.go:730)."""
        ev = self.eval
        updated = Evaluation(**{**ev.__dict__})
        updated.status = status
        updated.status_description = desc
        updated.failed_tg_allocs = dict(self.failed_tg_allocs)
        if self.blocked is not None:
            updated.blocked_eval = self.blocked.id
        updated.queued_allocations = dict(self.queued_allocs)
        if self.deployment is not None:
            updated.deployment_id = self.deployment.id
        self.planner.update_eval(updated)

    def _create_blocked_eval(self, plan_failure: bool = False) -> None:
        """Reference createBlockedEval (generic_sched.go:192).

        The timestamp is minted HERE — scheduler workers run leader-side
        only — and rides into the replicated eval, so FSM apply stays a
        pure function of the entry (the NLR01 invariant)."""
        self.blocked = self.eval.create_blocked_eval({}, True, "",
                                                     now=time.time())
        if plan_failure:
            self.blocked.triggered_by = TRIGGER_MAX_PLANS
            self.blocked.status_description = BLOCKED_EVAL_MAX_PLAN_DESC
        else:
            self.blocked.status_description = BLOCKED_EVAL_FAILED_PLACEMENTS
            # carry the failure attribution (dimension_exhausted,
            # constraint_filtered) onto the blocked eval itself: the
            # blocked tracker's diagnostics and "why is this stuck"
            # reads key off it (server/blocked.py dimension_stats)
            self.blocked.failed_tg_allocs = dict(self.failed_tg_allocs)
        self.planner.create_eval(self.blocked)

    # ---- one attempt ----

    def _process(self) -> Tuple[bool, Optional[Exception]]:
        """Reference process (generic_sched.go:216)."""
        ev = self.eval
        self.job = self.state.job_by_id(ev.namespace, ev.job_id)
        self.queued_allocs = {}
        self.follow_up_evals = []
        self.plan = ev.make_plan(self.job)
        # optimistic carry-exact certification (device-resident plan
        # deltas): only fused-coordinator dispatches produce a device
        # carry, and any post-kernel divergence below revokes it
        self.plan.carry_exact = self.select_coordinator is not None
        self.failed_tg_allocs = {}
        if not self.batch:
            self.deployment = self.state.latest_deployment_by_job(
                ev.namespace, ev.job_id
            )

        config = self.state.scheduler_config()
        self.stack = TorchStack(self.cluster,
                                algorithm=config.scheduler_algorithm,
                                device=self.device)
        self.stack.coordinator = self.select_coordinator
        self.stack.coordinator_order = self.select_order
        self.preemption_enabled = (
            config.preemption_batch_enabled if self.batch
            else config.preemption_service_enabled
        )

        err = self._compute_job_allocs()
        if err is not None:
            return False, err

        delay_instead = bool(self.follow_up_evals) and not ev.wait_until

        if (
            ev.status != EVAL_STATUS_BLOCKED
            and self.failed_tg_allocs
            and self.blocked is None
            and not delay_instead
        ):
            self._create_blocked_eval(plan_failure=False)

        if self.plan.is_no_op() and not ev.annotate_plan:
            return True, None

        if delay_instead:
            for fe in self.follow_up_evals:
                fe.previous_eval = ev.id
                self.planner.create_eval(fe)

        result, new_state = self.planner.submit_plan(self.plan)
        self.plan_result = result

        adjust_queued_allocations(result, self.queued_allocs)

        if new_state is not None:
            self.state = new_state
            return False, None

        full, expected, actual = result.full_commit(self.plan)
        if not full:
            return False, Exception(
                f"plan not fully committed and no refresh ({actual}/{expected})"
            )
        return True, None

    # ---- reconcile + place ----

    def _compute_job_allocs(self) -> Optional[Exception]:
        """Reference computeJobAllocs (generic_sched.go:332)."""
        ev = self.eval
        allocs = self.state.allocs_by_job(ev.namespace, ev.job_id)
        tainted = tainted_nodes(self.state, allocs)
        update_non_terminal_allocs_to_lost(self.plan, tainted, allocs)

        reconciler = AllocReconciler(
            job=self.job,
            job_id=ev.job_id,
            is_batch=self.batch,
            existing_allocs=allocs,
            tainted_nodes=tainted,
            eval_id=ev.id,
            deployment=self.deployment,
            alloc_update_fn=generic_alloc_update_fn,
        )
        results = reconciler.compute()

        if ev.annotate_plan:
            from ..structs import PlanAnnotations

            self.plan.annotations = PlanAnnotations(
                desired_tg_updates=results.desired_tg_updates
            )

        self.plan.deployment = results.deployment
        self.plan.deployment_updates = results.deployment_updates

        for evs in results.desired_followup_evals.values():
            self.follow_up_evals.extend(evs)
        if results.deployment is not None:
            self.deployment = results.deployment

        for stop in results.stop:
            self.plan.append_stopped_alloc(
                stop.alloc, stop.status_description, stop.client_status
            )

        dep_id = self.deployment.id if self.deployment is not None else ""
        if results.inplace_update or results.attribute_updates:
            # in-place/attribute updates replace a live alloc's usage at
            # commit — host mutations on rows the kernel carry cannot
            # model (it only chains placements + plan-relative stops)
            self.plan.carry_exact = False
        for update in results.inplace_update:
            if update.deployment_id != dep_id:
                update.deployment_id = dep_id
                update.deployment_status = None
            self.plan.append_alloc(update)

        for update in results.attribute_updates.values():
            self.plan.append_alloc(update)

        if not results.place and not results.destructive_update:
            if self.job is not None:
                for tg in self.job.task_groups:
                    self.queued_allocs[tg.name] = 0
            return None

        for p in results.place:
            self.queued_allocs[p.task_group.name] = (
                self.queued_allocs.get(p.task_group.name, 0) + 1
            )
        for d in results.destructive_update:
            self.queued_allocs[d.place_task_group.name] = (
                self.queued_allocs.get(d.place_task_group.name, 0) + 1
            )

        return self._compute_placements(
            results.destructive_update, results.place
        )

    def _registry(self):
        """Metrics registry for scheduler.* counters: the owning server's
        when scheduling for a real server (EvalContext planner), else the
        process-global one (harness / tests / bare stacks)."""
        srv = getattr(self.planner, "server", None)
        reg = getattr(srv, "metrics", None)
        if reg is None:
            from ..lib.metrics import default_registry

            reg = default_registry()
        return reg

    def _record_explain_metrics(self, ex: dict) -> None:
        """Fold one select's attribution into the `scheduler.filter.*` /
        `scheduler.exhausted.*` counter families (go-metrics
        `nomad.nomad.blocked_evals`-style rollups; Prometheus exposition
        rides the registry). Dimension keys keep their display names —
        the exposition layer mangles to [a-z0-9_]."""
        reg = self._registry()
        if ex.get("filtered_constraint"):
            reg.inc("scheduler.filter.constraint", ex["filtered_constraint"])
        if ex.get("filtered_device_plugin"):
            reg.inc("scheduler.filter.device_plugin",
                    ex["filtered_device_plugin"])
        dh = sum(s["filtered_distinct_hosts"] for s in ex["steps"])
        dp = sum(s["filtered_distinct_property"] for s in ex["steps"])
        if dh:
            reg.inc("scheduler.filter.distinct_hosts", dh)
        if dp:
            reg.inc("scheduler.filter.distinct_property", dp)
        dims: Dict[str, int] = {}
        for s in ex["steps"]:
            for dim, n in s["dimension_exhausted"].items():
                dims[dim] = dims.get(dim, 0) + n
        for dim, n in dims.items():
            reg.inc(f"scheduler.exhausted.{dim}", n)

    @staticmethod
    def _apply_explain(metrics: AllocMetric, ex: dict, step: int) -> None:
        """Fill one placement's AllocMetric from the kernel attribution
        (reference: the iterator chain fills these as it walks,
        feasible.go filter_node / rank.go exhausted_node / kheap score
        meta — here the fused kernel already counted, so this is a
        host-side copy, not a recount)."""
        # the kernel count supersedes the host's per-DC ready count: it
        # respects sampled-candidate restriction, and the
        # evaluated−filtered−exhausted arithmetic only closes against
        # the same taxonomy (DC membership is a counted LUT row here)
        metrics.nodes_evaluated = ex["nodes_evaluated"]
        metrics.nodes_filtered = ex["nodes_filtered"]
        for label, n in ex["constraint_filtered"].items():
            metrics.constraint_filtered[label] = (
                metrics.constraint_filtered.get(label, 0) + n)
        if ex["filtered_device_plugin"]:
            metrics.constraint_filtered["device-plugin/host checks"] = \
                ex["filtered_device_plugin"]
        if step < len(ex["steps"]):
            s = ex["steps"][step]
            if s["filtered_distinct_hosts"]:
                metrics.nodes_filtered += s["filtered_distinct_hosts"]
                metrics.constraint_filtered["distinct_hosts"] = \
                    s["filtered_distinct_hosts"]
            if s["filtered_distinct_property"]:
                metrics.nodes_filtered += s["filtered_distinct_property"]
                metrics.constraint_filtered["distinct_property"] = \
                    s["filtered_distinct_property"]
            metrics.nodes_exhausted = s["nodes_exhausted"]
            for dim, n in s["dimension_exhausted"].items():
                metrics.dimension_exhausted[dim] = (
                    metrics.dimension_exhausted.get(dim, 0) + n)
            for entry in s["top_nodes"]:
                for name, v in entry["scores"].items():
                    if v != 0.0:
                        metrics.score_node(entry["node_id"], name, v)
                metrics.score_node(entry["node_id"], "normalized-score",
                                   entry["norm_score"])

    def _compute_placements(
        self,
        destructive: List[AllocDestructiveResult],
        place: List[AllocPlaceResult],
    ) -> Optional[Exception]:
        """Reference computePlacements (generic_sched.go:468), restructured:
        one kernel dispatch per task group covering all its missing allocs."""
        by_dc = ready_counts_in_dcs(self.state, self.job.datacenters)
        n_ready = sum(by_dc.values())  # AllocMetric nodes_evaluated
        dep_id = ""
        if self.deployment is not None and self.deployment.active():
            dep_id = self.deployment.id
        now = time.time()

        # Destructive updates stop their previous alloc first (frees resources)
        missing: List[Tuple[TaskGroup, AllocPlaceResult, Optional[Allocation], bool]] = []
        for d in destructive:
            self.plan.append_stopped_alloc(d.stop_alloc, ALLOC_UPDATING)
            missing.append(
                (
                    d.place_task_group,
                    AllocPlaceResult(
                        name=d.place_name,
                        task_group=d.place_task_group,
                        previous_alloc=d.stop_alloc,
                    ),
                    d.stop_alloc,
                    True,
                )
            )
        for p in place:
            missing.append((p.task_group, p, p.previous_alloc, False))

        # Group by task group, preserving order (destructive first)
        groups: Dict[str, List[Tuple[AllocPlaceResult, Optional[Allocation], bool]]] = {}
        tg_by_name: Dict[str, TaskGroup] = {}
        for tg, p, prev, _dest in missing:
            groups.setdefault(tg.name, []).append((p, prev, _dest))
            tg_by_name[tg.name] = tg

        for tg_name, entries in groups.items():
            tg = tg_by_name[tg_name]
            plan_ctx = self._plan_context_for(tg, entries)
            volumes = resolve_volume_asks(self.state, self.job.namespace, tg)
            result = self.stack.select(self.job, tg, len(entries), plan_ctx,
                                       volumes=volumes)
            # bind the plan to the dispatch whose carry contains these
            # placements (multi-group plans: the LAST dispatch's carry
            # is the one a later refresh can adopt — earlier groups ride
            # it as plan-relative deltas, which always overlay)
            self.plan.carry_token = result.carry_token
            if result.explain is not None:
                self._record_explain_metrics(result.explain)

            for i, (p, prev, _dest) in enumerate(entries):
                node_id = result.node_ids[i]
                score = result.scores[i]
                victims: List[Allocation] = []
                metrics = AllocMetric()
                metrics.nodes_evaluated = n_ready
                metrics.nodes_available = dict(by_dc)
                if result.explain is not None:
                    # kernel-native attribution (same fused dispatch):
                    # filtered stages, exhausted dimensions, top-K score
                    # breakdown — for successes AND failures
                    self._apply_explain(metrics, result.explain, i)
                if node_id is None and self.preemption_enabled:
                    # Second pass with eviction enabled (reference
                    # selectNextOption, generic_sched.go:720-738)
                    from .preemption import find_preemption_placement

                    params, _m = self.stack.compile_tg(
                        self.job, tg, 1, self._plan_context_for(tg, [(p, prev, _dest)])
                    )
                    found = find_preemption_placement(
                        self.state, self.cluster, self.job, tg, params,
                        self.plan, device=self.device,
                    )
                    if found is not None:
                        node_id, victims, score = found
                        # preemption places where the fused dispatch did
                        # NOT — the carry knows nothing of this row
                        self.plan.carry_exact = False
                if node_id is None:
                    # Failed placement (generic_sched.go:620 failedTGAllocs)
                    existing = self.failed_tg_allocs.get(tg.name)
                    if existing is not None:
                        existing.coalesced_failures += 1
                    else:
                        if result.explain is None:
                            # coarse counts when the run emitted no
                            # attribution (explain off)
                            metrics.nodes_filtered = (
                                n_ready - result.nodes_feasible
                            )
                            metrics.nodes_exhausted = (
                                result.nodes_feasible - result.nodes_fit[i]
                                if i < len(result.nodes_fit) else 0
                            )
                        metrics.populate_score_meta()
                        self.failed_tg_allocs[tg.name] = metrics
                    continue

                node = self.state.node_by_id(node_id)
                alloc_id = fast_uuid()
                if victims:
                    # Victims must enter the plan BEFORE allocated_resources
                    # builds the NetworkIndex, so the new alloc can claim the
                    # ports/bandwidth they release (handlePreemptions,
                    # generic_sched.go:742).
                    for v in victims:
                        self.plan.append_preempted_alloc(v, alloc_id)
                alloc_res, net_err = self._allocated_resources(tg, node)
                if net_err is not None:
                    # Offer-time assignment (ports/devices) failed on the
                    # selected node: the reference would have ranked it out
                    # (rank.go:256-267) and moved to the next candidate —
                    # retry selection with the node excluded, then fail.
                    # Either way the kernel's predicted placement row
                    # never commits — the dispatch carry is no longer a
                    # faithful post-commit view of this plan.
                    self.plan.carry_exact = False
                    if victims:
                        pres = self.plan.node_preemptions.get(node_id, [])
                        vset = {v.id for v in victims}
                        self.plan.node_preemptions[node_id] = [
                            a for a in pres if a.id not in vset]
                        victims = []
                    node_id, node, score, alloc_res, net_err = \
                        self._reselect_excluding(
                            tg, (p, prev, _dest), {node_id}, net_err)
                    if net_err is not None:
                        fail_network_exhausted(
                            self.plan, node_id, node, victims, metrics,
                            self.failed_tg_allocs, tg.name, net_err)
                        continue
                alloc = Allocation(
                    id=alloc_id,
                    namespace=self.job.namespace,
                    eval_id=self.eval.id,
                    name=p.name,
                    job_id=self.job.id,
                    job=self.job,
                    task_group=tg.name,
                    metrics=metrics,
                    node_id=node_id,
                    node_name=node.name if node else "",
                    deployment_id=dep_id,
                    allocated_resources=alloc_res,
                    desired_status=ALLOC_DESIRED_RUN,
                    client_status=ALLOC_CLIENT_PENDING,
                    job_version=self.job.version,
                )
                alloc.metrics.score_node(node_id, "normalized-score", score)
                alloc.metrics.populate_score_meta()
                if victims:
                    alloc.preempted_allocations = [v.id for v in victims]
                if prev is not None:
                    alloc.previous_allocation = prev.id
                    if p.reschedule:
                        update_reschedule_tracker(alloc, prev, now)
                if p.canary and self.deployment is not None:
                    alloc.deployment_status = AllocDeploymentStatus(canary=True)
                    ds = self.deployment.task_groups.get(tg.name)
                    if ds is not None:
                        ds.placed_canaries.append(alloc.id)
                if self.plan.carry_exact:
                    self._certify_carry_exact(alloc, result.ask)
                self.plan.append_alloc(alloc)
        return None

    def _certify_carry_exact(self, alloc, ask) -> None:
        """Device-resident plan deltas: a placement may ride the
        dispatch's on-device carry only if what commits is EXACTLY what
        the kernel added — usage row bit-equal (as f32) to the compiled
        ask vector, and integral below the f32-exact bound so the
        chain's f32 accumulation cannot round differently from the host
        store's f64. Any mismatch revokes the whole plan's
        certification; the view then re-uploads its rows from host
        (slower, never wrong)."""
        if ask is None:
            self.plan.carry_exact = False
            return
        try:
            usage = self.cluster.usage_row(alloc)
        except Exception:  # noqa: BLE001 — odd shape: host path decides
            self.plan.carry_exact = False
            return
        if (usage.shape != ask.shape
                or not np.array_equal(usage.astype(np.float32), ask)
                or not np.all(usage == np.floor(usage))
                or np.any(np.abs(usage) >= 2 ** 24)):
            self.plan.carry_exact = False

    def _plan_context_for(
        self, tg: TaskGroup,
        entries: List[Tuple[AllocPlaceResult, Optional[Allocation], bool]],
    ) -> PlanContext:
        """Assemble plan-relative deltas for the kernel: in-plan stops release
        resources; per-step penalty/preferred nodes mirror getSelectOptions +
        findPreferredNode (generic_sched.go:622,637)."""
        ctx = PlanContext()
        for node_id, stops in self.plan.node_update.items():
            ctx.stopped_allocs.extend(stops)
        for node_id, pres in self.plan.node_preemptions.items():
            ctx.preempted_allocs.extend(pres)
        # in-plan placements from earlier groups of this eval
        for node_id, placements in self.plan.node_allocation.items():
            for a in placements:
                if a.create_index:
                    continue  # in-place updates already counted in state
                usage = self.cluster.usage_row(a)
                ctx.placed.append((node_id, a.task_group, usage))
                ctx.placed_allocs.append(a)

        sticky = tg.ephemeral_disk.sticky
        for p, prev, _dest in entries:
            penalties = set()
            preferred = None
            if prev is not None and p.reschedule:
                penalties.add(prev.node_id)
                if prev.reschedule_tracker is not None:
                    for ev in prev.reschedule_tracker.events:
                        if ev.prev_node_id:
                            penalties.add(ev.prev_node_id)
            if prev is not None and sticky and not p.reschedule:
                preferred = prev.node_id
            ctx.penalty_node_ids.append(frozenset(penalties))
            ctx.preferred_node_ids.append(preferred)
        return ctx

    def _allocated_resources(self, tg: TaskGroup, node):
        return allocated_resources(self.state, self.plan, tg, node)

    def _reselect_excluding(self, tg: TaskGroup, entry, excluded: set,
                            first_err: str):
        """Offer-time failure recovery: re-run selection with the failed
        nodes masked out (via the candidate-restriction mode) and re-offer,
        up to 3 nodes deep. The reference's BinPackIterator simply continues
        to the next candidate (rank.go:256-267); the batched kernel can't
        see precise offer-time state, so disagreements re-enter selection
        here instead of failing the placement outright."""
        err = first_err
        volumes = resolve_volume_asks(self.state, self.job.namespace, tg)
        for _ in range(3):
            rows = [row for nid, row in self.cluster.row_of.items()
                    if nid not in excluded]
            if not rows:
                break
            plan_ctx = self._plan_context_for(tg, [entry])
            # no attribution on the retry dispatch: only node/score are
            # consumed here, and the group's main select already
            # recorded this placement's metrics
            sel = self.stack.select(self.job, tg, 1, plan_ctx,
                                    volumes=volumes, sampled_rows=rows,
                                    explain=False)
            node_id = sel.node_ids[0]
            if node_id is None:
                break
            node = self.state.node_by_id(node_id)
            alloc_res, err = self._allocated_resources(tg, node)
            if err is None:
                return node_id, node, sel.scores[0], alloc_res, None
            excluded.add(node_id)
        return None, None, 0.0, None, err


def allocated_resources(state: State, plan: Plan, tg: TaskGroup, node):
    """Grant resources + assign ports for a placement (reference:
    BinPackIterator's per-task network/port assignment, rank.go:231-320).
    Port assignment happens host-side against the node's NetworkIndex built
    from plan-relative proposed allocs — otherwise two allocs of one eval on
    one node double-book dynamic ports and the plan applier rejects it.

    Returns (resources, error): a non-None error means the node cannot
    satisfy the group's port asks and the placement MUST fail (the reference
    ranks such nodes out, rank.go:256-267 — an alloc is never placed with
    its ports silently dropped)."""
    from .device import DeviceAllocator, assign_task_devices

    tasks: Dict[str, AllocatedTaskResources] = {}
    shared = AllocatedSharedResources(disk_mb=tg.ephemeral_disk.size_mb)

    net_idx: Optional[NetworkIndex] = None
    dev_offers: Dict[str, list] = {}
    if node is not None:
        proposed = proposed_allocs(state, plan, node.id)
        net_idx = NetworkIndex()
        net_idx.set_node(node)
        net_idx.add_allocs(proposed)
        offers, derr = assign_task_devices(DeviceAllocator(node, proposed), tg)
        if offers is None:
            return None, derr
        dev_offers = offers

    for t in tg.tasks:
        tr = AllocatedTaskResources(
            cpu=t.resources.cpu, memory_mb=t.resources.memory_mb,
            devices=list(dev_offers.get(t.name, ())),
        )
        for ask in t.resources.networks:
            if net_idx is not None:
                offer, err = net_idx.assign_network(ask)
                if offer is None:
                    return None, err or f"task {t.name}: no network offer"
                net_idx.add_reserved(offer)
                tr.networks.append(offer)
        tasks[t.name] = tr

    for ask in tg.networks:
        if net_idx is not None:
            offer, err = net_idx.assign_network(ask)
            if offer is None:
                return None, err or "group network: no offer"
            net_idx.add_reserved(offer)
            shared.networks.append(offer)
    return AllocatedResources(tasks=tasks, shared=shared), None
