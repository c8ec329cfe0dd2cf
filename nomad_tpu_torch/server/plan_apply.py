"""PlanQueue + plan applier — serialized optimistic verification of plans.

Behavioral reference: `nomad/plan_queue.go` (:29, Enqueue :95, Dequeue :126)
and `nomad/plan_apply.go` (planApply :71, applyPlan :204, evaluatePlan :400,
evaluatePlanPlacements :437, evaluateNodePlan :629):

- workers enqueue plans with a future; a single applier thread dequeues by
  priority and verifies each touched node against the LATEST state (the
  commit point of the optimistic concurrency scheme)
- a node fails verification if its proposed alloc set (state allocs − plan
  stops/preemptions + plan placements) does not fit → that node's placements
  (and dependent preemptions) are dropped and the result is a partial commit
  with `refresh_index` set, telling the worker to retry on fresher state
- committed results are applied to the store in one indexed write
  (`UpsertPlanResults`, the FSM `ApplyPlanResultsRequest` analog)
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..lib.metrics import MetricsRegistry
from ..scheduler.util import proposed_allocs
from ..structs import Allocation, Node, Plan, PlanResult, allocs_fit
from .state import StateStore


class _Future:
    def __init__(self) -> None:
        self._ev = threading.Event()
        self.result: Optional[PlanResult] = None
        self.error: Optional[Exception] = None

    def set(self, result: Optional[PlanResult], error: Optional[Exception] = None
            ) -> None:
        self.result = result
        self.error = error
        self._ev.set()

    def wait(self, timeout: Optional[float] = None) -> PlanResult:
        if not self._ev.wait(timeout):
            raise TimeoutError("plan apply timed out")
        if self.error is not None:
            raise self.error
        return self.result


class PlanQueue:
    """Priority queue of pending plans (reference plan_queue.go:29)."""

    def __init__(self, metrics: Optional[MetricsRegistry] = None) -> None:
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._heap: List[Tuple[int, int, Plan, _Future]] = []
        self._seq = itertools.count()
        self._enabled = False
        self._shutdown = False
        # plans popped by dequeue() but not yet committed (the applier
        # thread pops BEFORE taking the apply mutex) — idle() must count
        # them or the inline fast path could commit ahead of an
        # already-dequeued higher-priority plan
        self._in_flight = 0
        #: queued + in-flight plans awaiting the serialized leader apply
        #:: the contention read on the commit-point mutex —
        #: eagerly created so the series is always exposed
        self._g_depth = (metrics.gauge("plan_apply.queue_depth")
                         if metrics is not None else None)

    def _gauge_locked(self) -> None:
        if self._g_depth is not None:
            self._g_depth.set(len(self._heap) + self._in_flight)

    def set_enabled(self, enabled: bool) -> None:
        with self._cv:
            self._enabled = enabled
            if not enabled:
                for _, _, _, fut in self._heap:
                    fut.set(None, RuntimeError("plan queue disabled"))
                self._heap.clear()
            self._gauge_locked()
            self._cv.notify_all()

    def enqueue(self, plan: Plan) -> _Future:
        fut = _Future()
        with self._cv:
            if not self._enabled:
                fut.set(None, RuntimeError("plan queue disabled"))
                return fut
            heapq.heappush(
                self._heap, (-plan.priority, next(self._seq), plan, fut)
            )
            self._gauge_locked()
            self._cv.notify_all()
        return fut

    def dequeue(self, timeout: Optional[float] = None
                ) -> Optional[Tuple[Plan, _Future]]:
        import time

        deadline = time.time() + timeout if timeout is not None else None
        with self._cv:
            while True:
                if self._shutdown:
                    return None
                if self._heap:
                    _, _, plan, fut = heapq.heappop(self._heap)
                    self._in_flight += 1
                    self._gauge_locked()
                    return plan, fut
                remaining = 1.0
                if deadline is not None:
                    remaining = deadline - time.time()
                    if remaining <= 0:
                        return None
                self._cv.wait(min(remaining, 1.0))

    def task_done(self) -> None:
        """Applier thread: the plan returned by dequeue() is committed."""
        with self._cv:
            self._in_flight -= 1
            self._gauge_locked()

    def idle(self) -> bool:
        """Enabled with nothing pending or in flight — the inline fast
        path's gate."""
        with self._cv:
            return (self._enabled and not self._heap
                    and self._in_flight == 0 and not self._shutdown)

    def shutdown(self) -> None:
        with self._cv:
            self._shutdown = True
            for _, _, _, fut in self._heap:
                fut.set(None, RuntimeError("plan queue shutdown"))
            self._heap.clear()
            self._gauge_locked()
            self._cv.notify_all()


_DIM_NAMES = {0: "cpu", 1: "memory", 2: "disk", 3: "network"}


def _tensor_node_verify(cl, row: int, plan: Plan, node_id: str):
    """Vectorized per-node verification against the LIVE cluster tensors
    (the reference parallelizes exactly this check, plan_apply_pool.go:18;
    here the incrementally-maintained used/capacity rows make it O(plan
    allocs) instead of rebuilding the node's whole proposed set).
    Returns (fit, reason) or None to fall back to the object path."""
    import numpy as np

    from ..tensor.cluster import R_TOTAL

    freed = np.zeros(R_TOTAL, dtype=np.float32)
    freed_ports: Dict[int, int] = {}

    def release(alloc_id: str) -> None:
        u = cl.alloc_usage.get(alloc_id)
        if u is not None and u[0] == row:
            np.add(freed, u[1], out=freed)
        ap = cl.alloc_ports.get(alloc_id)
        if ap is not None and ap[0] == row:
            for p in ap[1]:
                freed_ports[p] = freed_ports.get(p, 0) + 1

    for a in plan.node_update.get(node_id, ()):
        release(a.id)
    for a in plan.node_preemptions.get(node_id, ()):
        release(a.id)

    placed = None
    placed_ports: List[int] = []
    for a in plan.node_allocation.get(node_id, ()):
        release(a.id)  # in-place update: the plan's copy replaces it
        if a.terminal_status():
            continue
        try:
            v = cl.usage_row(a)
            ports = cl._alloc_port_list(a)
        except Exception:  # noqa: BLE001 — odd shape: object path decides
            return None
        placed = v if placed is None else placed + v
        placed_ports.extend(ports)

    if placed is None:
        return True, ""
    total = cl.used[row] - freed + placed
    # float32 incremental accounting: tolerate epsilon at the boundary
    over = total > cl.capacity[row] + 1e-3
    if over.any():
        col = int(np.argmax(over))
        return False, _DIM_NAMES.get(col, "devices")
    seen: set = set()
    for p in placed_ports:
        if p in seen:
            return False, f"port {p} collision in plan"
        seen.add(p)
        refs = cl.port_refs[row].get(p, 0) - freed_ports.get(p, 0)
        if refs > 0 or (p in cl.base_ports[row]
                        and p not in freed_ports):
            return False, f"port {p} already in use"
    return True, ""


def evaluate_node_plan(state, plan: Plan, node_id: str) -> Tuple[bool, str]:
    """Can this node accommodate the plan? (reference plan_apply.go:629)."""
    has_update = bool(plan.node_update.get(node_id)) or bool(
        plan.node_preemptions.get(node_id)
    )
    node = state.node_by_id(node_id)
    if node is None:
        return has_update and not plan.node_allocation.get(node_id), "node missing"
    if has_update and not plan.node_allocation.get(node_id):
        return True, ""  # evictions always apply
    if node.terminal_status():
        return False, "node is down"
    if node.drain is not None or node.scheduling_eligibility != "eligible":
        return False, "node is not eligible"

    cl = getattr(state, "cluster", None)
    row = cl.row_of.get(node_id) if cl is not None else None
    if row is not None:
        verdict = _tensor_node_verify(cl, row, plan, node_id)
        if verdict is not None:
            return verdict

    proposed = proposed_allocs(state, plan, node_id)
    fit, dim, _util = allocs_fit(node, proposed)
    return fit, dim


class PlanApplier:
    """Single-threaded plan verification + commit loop (plan_apply.go:71)."""

    #: counter names mirrored by the legacy `stats` view
    STAT_KEYS = ("applied", "partial", "rejected_nodes", "stale_token",
                 "inline")

    def __init__(self, state: StateStore, queue: PlanQueue,
                 broker=None,
                 metrics: Optional[MetricsRegistry] = None) -> None:
        self.state = state
        self.queue = queue
        self.broker = broker
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # THE commit-point mutex: verification+commit is serialized
        # whether a plan arrives via the queue thread or a worker's
        # inline fast path
        self._apply_lock = threading.Lock()
        # registry-backed outcome counters + apply-latency histogram:
        # the applier thread AND inline-path workers record here, so the
        # old plain dict was the NLT01 textbook case
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._ctr = {k: self.metrics.counter(f"plan_apply.{k}")
                     for k in self.STAT_KEYS}
        self._apply_ms = self.metrics.histogram("plan_apply.apply_ms")
        #: partial / applied — the server-side twin of the bench tail's
        #: `e2e_plan_partial_rate` (optimistic-concurrency cost), always
        #: exposed
        self._g_partial_rate = self.metrics.gauge(
            "plan_apply.partial_rate")

    @property
    def stats(self) -> Dict[str, int]:
        """Legacy counter view (now registry-backed, lock-free reads)."""
        return {k: int(c.value) for k, c in self._ctr.items()}

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def shutdown(self) -> None:
        self._stop.set()
        self.queue.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def _run(self) -> None:
        while not self._stop.is_set():
            item = self.queue.dequeue(timeout=0.5)
            if item is None:
                continue
            plan, fut = item
            try:
                with self._apply_lock:
                    result = self.apply(plan)
                fut.set(result)
            except Exception as e:  # noqa: BLE001 — fail the waiting worker
                fut.set(None, e)
            finally:
                self.queue.task_done()

    def try_apply_inline(self, plan: Plan) -> Optional[PlanResult]:
        """Submitting-worker fast path: when nothing is queued and the
        applier mutex is free, verify+commit on THIS thread — identical
        serialization through _apply_lock, none of the two thread hops
        of the queue round trip (the reference gets the same effect by
        pipelining Raft apply with next-plan evaluation,
        plan_apply.go:71). Returns None when the queue must be used
        (busy applier or pending higher-priority plans)."""
        if not self._apply_lock.acquire(blocking=False):
            return None
        try:
            # idle() is checked UNDER the lock: checking first and locking
            # second would let a plan enqueued between the two commit after
            # us despite higher priority; idle() also counts plans the
            # applier thread has dequeued but not yet committed.
            if not self.queue.idle():
                return None
            result = self.apply(plan)
        finally:
            self._apply_lock.release()
        self._ctr["inline"].inc()
        return result

    def apply(self, plan: Plan) -> PlanResult:
        """Verify against latest state, commit what fits (plan_apply.go:400)."""
        # Token check (reference: the leader validates the worker still owns
        # the eval before accepting its plan — Plan.Submit → evalBroker token
        # validation, nomad/plan_endpoint.go:31). A nack-timeout redelivery
        # must not let two workers commit plans for the same eval.
        t0 = time.perf_counter()
        wall0 = time.time()
        if self.broker is not None and plan.eval_token:
            if not self.broker.outstanding(plan.eval_id, plan.eval_token):
                self._ctr["stale_token"].inc()
                raise ValueError(
                    f"plan for eval {plan.eval_id} has a stale token"
                )
        result = PlanResult(
            node_update={k: list(v) for k, v in plan.node_update.items()},
            node_allocation={},
            node_preemptions={},
            deployment=plan.deployment,
            deployment_updates=list(plan.deployment_updates),
        )
        partial = False
        rejected: List[str] = []
        touched = set(plan.node_allocation) | set(plan.node_preemptions)
        # verification holds the store's mutation lock: the tensor path
        # reads live used/alloc_usage counters, and a concurrent client
        # upsert flipping a plan-stopped alloc terminal mid-verify would
        # otherwise double-free its resources (released from `used` AND
        # counted again as plan-freed). Released BEFORE the commit below
        # — upsert_plan_results may block on a raft apply.
        import contextlib

        lock = (self.state.mutation_lock()
                if hasattr(self.state, "mutation_lock")
                else contextlib.nullcontext())
        with lock:
            # verify against the LIVE store (not a snapshot): the mutation
            # lock already guarantees internal consistency, and a full
            # StateSnapshot copy per plan (~0.6 ms at 10K allocs) was the
            # single biggest apply cost
            for node_id in touched:
                fit, reason = evaluate_node_plan(self.state, plan, node_id)
                if fit:
                    if node_id in plan.node_allocation:
                        result.node_allocation[node_id] = list(
                            plan.node_allocation[node_id]
                        )
                    if node_id in plan.node_preemptions:
                        result.node_preemptions[node_id] = list(
                            plan.node_preemptions[node_id]
                        )
                else:
                    partial = True
                    rejected.append(node_id)
                    self._ctr["rejected_nodes"].inc()
        if partial and plan.all_at_once:
            # all-at-once plans commit nothing on any failure — including the
            # stops, or destructive updates would halt services with no
            # replacement (plan_apply.go:486)
            result.node_update.clear()
            result.node_allocation.clear()
            result.node_preemptions.clear()
            result.deployment = None
            result.deployment_updates = []

        # Plan-commit window (device-resident plan deltas):
        # bracket the commit's cluster-version range and tag it with the
        # eval + the clean/exact verdicts, so the device-view refresh
        # can adopt the dispatch's on-device carry for exactly these
        # rows instead of re-uploading them. The mark MUST share the
        # commit's mutation lock — a foreign upsert interleaving into
        # the window would be mis-attributed to the kernel. Raft-routed
        # stores commit on the FSM applier thread where this bracketing
        # is meaningless; their mutations stay on the host re-upload
        # path (the windows simply never cover them).
        # Alloc create/modify times are minted HERE, on the leader,
        # before the commit enters the store: the raft path journals the
        # already-stamped allocs, so every follower's FSM applies
        # identical values (the NLR01 invariant — apply is a pure
        # function of the entry; reference structs.Allocation
        # CreateTime/ModifyTime are also set plan-side).
        now = time.time()
        # The plan-apply SPAN ID is minted here too, leader-side like
        # `now`: stamped onto the committed allocs so the
        # raft entry carries it — every replica applies identical trace
        # ids (replica-determinism gate in test_trace_distributed.py) —
        # and the client's alloc.start span parents under it for free.
        from ..lib.tracectx import new_span_id, trace_enabled

        plan_span_id = ""
        if plan.trace_id and trace_enabled():
            plan_span_id = new_span_id()
        for allocs in result.node_allocation.values():
            for a in allocs:
                a.create_time = a.create_time or now
                a.modify_time = now
                if plan_span_id:
                    a.trace_id = plan.trace_id
                    a.trace_span_id = plan_span_id
        cl = getattr(self.state, "cluster", None)
        if (cl is not None and getattr(self.state, "raft", None) is None
                and hasattr(self.state, "mutation_lock")):
            # rejected node ids → rows: the certification observer
            # (speculative dispatch) attributes a rollback to
            # the rows whose placements verification dropped
            rej_rows = [r for r in (cl.row_of.get(nid) for nid in rejected)
                        if r is not None] if rejected else None
            with self.state.mutation_lock():
                v_lo = cl.version
                self.state.upsert_plan_results(plan, result)
                cl.mark_plan_window(
                    plan.eval_id, v_lo, cl.version, clean=not partial,
                    exact=bool(getattr(plan, "carry_exact", False)),
                    token=getattr(plan, "carry_token", None),
                    rejected_rows=rej_rows)
        else:
            self.state.upsert_plan_results(plan, result)
        result.alloc_index = self.state.index.value
        if partial:
            result.refresh_index = self.state.index.value
            self._ctr["partial"].inc()
        self._ctr["applied"].inc()
        self._g_partial_rate.set(
            round(self._ctr["partial"].value
                  / max(self._ctr["applied"].value, 1), 4))
        self._apply_ms.add_sample((time.perf_counter() - t0) * 1e3)
        if plan_span_id:
            # the leader's view of verify+commit, parented under the
            # eval span the plan inherited from its evaluation
            from ..lib.tracectx import default_spans

            try:
                n_placed = sum(len(v) for v in
                               result.node_allocation.values())
                default_spans().record(
                    "plan.apply", trace_id=plan.trace_id,
                    span_id=plan_span_id,
                    parent_span_id=plan.trace_span_id,
                    start_unix=wall0, end_unix=time.time(),
                    detail={"eval_id": plan.eval_id,
                            "placed": n_placed, "partial": bool(partial)})
            except Exception:  # noqa: BLE001 — telemetry only
                pass
        if partial:
            # optimistic rejection → flight event: a failover or a
            # wave-collision storm shows up as a plan.partial burst in
            # the ring, keyed by eval for the trace join
            from ..lib.flight import default_flight

            try:
                default_flight().record(
                    "plan.partial", key=plan.eval_id, severity="warn",
                    detail={"rejected_nodes": rejected[:8],
                            "n_rejected": len(rejected),
                            "all_at_once": bool(plan.all_at_once)})
            except Exception:  # noqa: BLE001 — telemetry only
                pass
        return result
