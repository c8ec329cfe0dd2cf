"""SystemScheduler — one alloc per eligible node.

Behavioral reference: `scheduler/system_sched.go` (:45 NewSystemScheduler,
:54 Process, :183 computeJobAllocs, :268 computePlacements) and
`scheduler/util.go` diffSystemAllocsForNode (:70) / diffSystemAllocs (:201).

Where the reference runs the feasibility stack once per node (SystemStack
with a single-node source), ONE kernel call here computes the [N]-wide
feasibility and fit masks per task group (`kernels/placement.py`
`system_feasibility`, K2, on the scheduler's device); the per-node diff is
host set arithmetic. Preemption on a full node is the host Preemptor on
that one node (`preemption.preempt_on_node`).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..device import DeviceLike, resolve_device
from ..utils import fast_uuid
from ..structs import (
    ALLOC_CLIENT_LOST,
    ALLOC_CLIENT_PENDING,
    ALLOC_DESIRED_RUN,
    AllocMetric,
    Allocation,
    EVAL_STATUS_COMPLETE,
    EVAL_STATUS_FAILED,
    Evaluation,
    Job,
    Plan,
    PlanResult,
    TaskGroup,
    filter_terminal_allocs,
)
from ..tensor.cluster import ClusterTensors
from .generic import allocated_resources
from .reconcile import ALLOC_LOST, ALLOC_NOT_NEEDED, ALLOC_UPDATING
from .stack import PlanContext, TorchStack
from .util import (
    Planner,
    SetStatusError,
    State,
    fail_network_exhausted,
    progress_made,
    ready_nodes_in_dcs,
    retry_max,
    tainted_nodes,
    update_non_terminal_allocs_to_lost,
)

MAX_SYSTEM_ATTEMPTS = 5  # reference system_sched.go:17
ALLOC_NODE_TAINTED = "alloc not needed as node is tainted"


def materialize_system_groups(job: Job) -> Dict[str, TaskGroup]:
    """System jobs want one alloc per (node, tg); names use index 0
    (reference materializeTaskGroups, util.go:37, with system semantics)."""
    return {f"{job.id}.{tg.name}[0]": tg for tg in job.task_groups}


class SystemScheduler:
    """Reference SystemScheduler (system_sched.go:23)."""

    def __init__(self, state: State, planner: Planner, cluster: ClusterTensors,
                 device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        self.state = state
        self.planner = planner
        self.cluster = cluster
        self.eval: Optional[Evaluation] = None
        self.job: Optional[Job] = None
        self.plan: Optional[Plan] = None
        self.plan_result: Optional[PlanResult] = None
        self.failed_tg_allocs: Dict[str, AllocMetric] = {}
        self.queued_allocs: Dict[str, int] = {}
        self.nodes = []
        self.nodes_by_dc: Dict[str, int] = {}

    def process(self, eval: Evaluation) -> None:
        self.eval = eval
        err = retry_max(
            MAX_SYSTEM_ATTEMPTS, self._process,
            lambda: progress_made(self.plan_result),
        )
        if err is not None:
            if isinstance(err, SetStatusError):
                self._set_status(EVAL_STATUS_FAILED, str(err))
                return
            raise err
        self._set_status(EVAL_STATUS_COMPLETE, "")

    def _set_status(self, status: str, desc: str) -> None:
        updated = Evaluation(**{**self.eval.__dict__})
        updated.status = status
        updated.status_description = desc
        updated.failed_tg_allocs = dict(self.failed_tg_allocs)
        updated.queued_allocations = dict(self.queued_allocs)
        self.planner.update_eval(updated)

    def _process(self) -> Tuple[bool, Optional[Exception]]:
        ev = self.eval
        self.job = self.state.job_by_id(ev.namespace, ev.job_id)
        self.queued_allocs = {}
        self.failed_tg_allocs = {}
        if self.job is not None and not self.job.stopped():
            self.nodes, self.nodes_by_dc = ready_nodes_in_dcs(
                self.state, self.job.datacenters
            )
        else:
            self.nodes = []
        self.plan = ev.make_plan(self.job)
        config = self.state.scheduler_config()
        self.stack = TorchStack(self.cluster,
                                algorithm=config.scheduler_algorithm,
                                device=self.device)
        self.preemption_enabled = config.preemption_system_enabled

        err = self._compute_job_allocs()
        if err is not None:
            return False, err

        if self.plan.is_no_op() and not ev.annotate_plan:
            return True, None

        result, new_state = self.planner.submit_plan(self.plan)
        self.plan_result = result
        if new_state is not None:
            self.state = new_state
            return False, None
        full, expected, actual = result.full_commit(self.plan)
        if not full:
            return False, Exception(
                f"plan not fully committed and no refresh ({actual}/{expected})"
            )
        return True, None

    def _compute_job_allocs(self) -> Optional[Exception]:
        """Reference computeJobAllocs (system_sched.go:183)."""
        ev = self.eval
        allocs = self.state.allocs_by_job(ev.namespace, ev.job_id)
        tainted = tainted_nodes(self.state, allocs)
        update_non_terminal_allocs_to_lost(self.plan, tainted, allocs)
        live, terminal = filter_terminal_allocs(allocs)

        stopped = self.job is None or self.job.stopped()
        required = {} if stopped else materialize_system_groups(self.job)
        eligible = {n.id: n for n in self.nodes}

        place: List[Tuple[str, TaskGroup, Optional[Allocation]]] = []
        update: List[Allocation] = []

        allocs_by_node: Dict[str, List[Allocation]] = {}
        for a in live:
            allocs_by_node.setdefault(a.node_id, []).append(a)

        # Per-node diff (reference diffSystemAllocsForNode, util.go:70)
        node_ids = set(eligible) | set(allocs_by_node)
        for node_id in node_ids:
            existing_names = set()
            for a in allocs_by_node.get(node_id, []):
                existing_names.add(a.name)
                tg = required.get(a.name)
                if tg is None:
                    self.plan.append_stopped_alloc(a, ALLOC_NOT_NEEDED)
                    continue
                if not a.terminal_status() and a.desired_transition.should_migrate():
                    self.plan.append_stopped_alloc(a, ALLOC_NODE_TAINTED)
                    continue
                if a.node_id in tainted:
                    node = tainted[a.node_id]
                    if not a.terminal_status() and (
                        node is None or node.terminal_status()
                    ):
                        self.plan.append_stopped_alloc(
                            a, ALLOC_LOST, ALLOC_CLIENT_LOST
                        )
                    continue
                if node_id not in eligible:
                    continue
                if (
                    a.job is not None
                    and self.job.job_modify_index != a.job.job_modify_index
                ):
                    update.append(a)
                    continue
            if node_id not in eligible or node_id in tainted:
                continue
            for name, tg in required.items():
                if name not in existing_names:
                    prev = terminal.get(name)
                    if prev is not None and prev.node_id != node_id:
                        prev = None
                    place.append((node_id, tg, prev))

        # In-place vs destructive for updates: system jobs treat job changes as
        # destructive (evict + replace) up to the rolling-update limit
        # (system_sched.go:240-247 evictAndPlace)
        limit = len(update)
        if self.job is not None and self.job.update is not None and self.job.update.rolling():
            limit = self.job.update.max_parallel
        for a in update[:limit]:
            self.plan.append_stopped_alloc(a, ALLOC_UPDATING)
            tg = self.job.lookup_task_group(a.task_group)
            if tg is not None:
                place.append((a.node_id, tg, a))

        if not place:
            if self.job is not None and not self.job.stopped():
                for tg in self.job.task_groups:
                    self.queued_allocs[tg.name] = 0
            return None

        for _nid, tg, _prev in place:
            self.queued_allocs[tg.name] = self.queued_allocs.get(tg.name, 0) + 1

        return self._compute_placements(place)

    def _compute_placements(
        self, place: List[Tuple[str, TaskGroup, Optional[Allocation]]]
    ) -> Optional[Exception]:
        """One mask-kernel dispatch per task group; per-node decode
        (replaces the reference's per-node SystemStack.Select loop,
        system_sched.go:268)."""
        from ..kernels.placement import system_feasibility
        from .stack import _DISPATCH_TOKENS, release_view

        by_tg: Dict[str, List[Tuple[str, Optional[Allocation]]]] = {}
        tg_map: Dict[str, TaskGroup] = {}
        for node_id, tg, prev in place:
            by_tg.setdefault(tg.name, []).append((node_id, prev))
            tg_map[tg.name] = tg

        for tg_name, entries in by_tg.items():
            tg = tg_map[tg_name]
            plan_ctx = PlanContext()
            for stops in self.plan.node_update.values():
                plan_ctx.stopped_allocs.extend(stops)
            params, _m = self.stack.compile_tg(self.job, tg, len(entries), plan_ctx)
            # the launch leases the view it reads until both masks are on
            # the host: a concurrent refresh writes copies meanwhile, never
            # these tensors (PyTorch has no buffer donation to catch it).
            # The numpy program goes to the card in the kernel's one staged
            # copy; the [2, N] masks come back in one copy.
            token = next(_DISPATCH_TOKENS)
            try:
                arrays = self.stack.device_arrays(lease_token=token)
                feas_mask, mask = system_feasibility(arrays,
                                                     params).cpu().numpy()
            finally:
                release_view(self.cluster, token)

            # distinct_property tracking (SystemStack includes the
            # DistinctPropertyIterator too, stack.go:248): counts update
            # as this loop places, host-side since placement here is
            # per-node scalar
            from ..tensor.vocab import MISSING

            dp_active = np.asarray(params.dp_active)
            dp_keys = np.asarray(params.dp_key_idx)
            dp_allowed = np.asarray(params.dp_allowed)
            dcounts = np.array(params.dp_counts0)
            has_dp = bool(dp_active.any())
            budget = int(params.n_place)  # < len(entries) iff constant-
            #                               LTarget dp caps total placements

            for node_id, prev in entries:
                row = self.cluster.row_of.get(node_id)
                ok = row is not None and bool(mask[row])
                # distinct_property gates BOTH normal and preemption
                # placements; check before deciding to preempt, so a
                # dp-infeasible node never evicts victims
                dp_ok = True
                dp_toks: List[Tuple[int, int]] = []
                if row is not None and has_dp:
                    for i in range(len(dp_keys)):
                        if not dp_active[i]:
                            continue
                        tok = int(self.cluster.attrs[row, dp_keys[i]])
                        if tok == MISSING or tok >= dcounts.shape[1] \
                                or dcounts[i, tok] >= dp_allowed[i]:
                            dp_ok = False
                            break
                        dp_toks.append((i, tok))
                dp_ok = dp_ok and budget > 0
                ok = ok and dp_ok
                victims: List[Allocation] = []
                if (
                    not ok
                    and dp_ok
                    and row is not None
                    and bool(feas_mask[row])
                    and self.preemption_enabled
                ):
                    # Feasible but exhausted → evict lower-priority allocs
                    # (system jobs preempt by default, stack.go:256-263)
                    from .preemption import preempt_on_node

                    victims = preempt_on_node(
                        self.state, self.job, tg, node_id, self.plan
                    )
                    ok = bool(victims)
                metrics = AllocMetric()
                metrics.nodes_evaluated = 1
                metrics.nodes_available = dict(self.nodes_by_dc)
                if not ok:
                    existing = self.failed_tg_allocs.get(tg.name)
                    if existing is not None:
                        existing.coalesced_failures += 1
                    else:
                        metrics.nodes_filtered = 1
                        self.failed_tg_allocs[tg.name] = metrics
                    continue
                node = self.state.node_by_id(node_id)
                alloc_id = fast_uuid()
                if victims:
                    # Same ordering contract as the generic scheduler: plan
                    # preemptions precede the NetworkIndex build.
                    for v in victims:
                        self.plan.append_preempted_alloc(v, alloc_id)
                alloc_res, net_err = allocated_resources(
                    self.state, self.plan, tg, node
                )
                if net_err is not None:
                    # Port-exhausted node: fail the per-node placement
                    # rather than placing without ports (rank.go:256-267)
                    fail_network_exhausted(
                        self.plan, node_id, node, victims, metrics,
                        self.failed_tg_allocs, tg.name, net_err)
                    continue
                alloc = Allocation(
                    id=alloc_id,
                    namespace=self.job.namespace,
                    eval_id=self.eval.id,
                    name=f"{self.job.id}.{tg.name}[0]",
                    job_id=self.job.id,
                    job=self.job,
                    task_group=tg.name,
                    metrics=metrics,
                    node_id=node_id,
                    node_name=node.name if node else "",
                    allocated_resources=alloc_res,
                    desired_status=ALLOC_DESIRED_RUN,
                    client_status=ALLOC_CLIENT_PENDING,
                    job_version=self.job.version,
                )
                if victims:
                    alloc.preempted_allocations = [v.id for v in victims]
                if prev is not None:
                    alloc.previous_allocation = prev.id
                self.plan.append_alloc(alloc)
                budget -= 1
                for i, tok in dp_toks:
                    dcounts[i, tok] += 1
        return None
