"""StateStore — the server's authoritative state with MVCC-style snapshots
and blocking queries.

Behavioral reference: `nomad/state/state_store.go` (StateStore :57,
SnapshotMinIndex :127, BlockingQuery :201, UpsertPlanResults :240). The
reference uses go-memdb immutable-radix trees for O(1) snapshots; here
snapshots shallow-copy the table maps under the store lock (alloc inner maps
are copy-on-write in the mutators so a snapshot's views never see in-place
mutation). The cluster tensor view (`ClusterTensors`) is intentionally shared
live: kernels may read slightly-stale rows, and the plan applier re-verifies
every touched node (`evaluateNodePlan`) exactly as the reference's optimistic
concurrency does (`nomad/plan_apply.go:629`).
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

from ..scheduler.harness import InMemState
from ..structs import Allocation, Node


class _IndexCounter:
    """next()-able Raft-index analog that remembers the last value."""

    def __init__(self) -> None:
        self.value = 0

    def __next__(self) -> int:
        self.value += 1
        return self.value


class StateSnapshot(InMemState):
    """A point-in-time read view implementing the scheduler `State` protocol.
    Never mutate a snapshot."""

    def __init__(self, store: "StateStore") -> None:  # noqa: D401
        # Deliberately no super().__init__: share/copy the store's tables.
        self._nodes = dict(store._nodes)
        self._jobs = dict(store._jobs)
        self._job_versions = dict(store._job_versions)
        self._allocs = dict(store._allocs)
        self._allocs_by_job = dict(store._allocs_by_job)
        self._allocs_by_node = dict(store._allocs_by_node)
        self._deployments = dict(store._deployments)
        self._evals = dict(store._evals)
        self._config = store._config
        self._csi_volumes = dict(store._csi)
        self._namespace_rows = dict(store._namespaces)
        self._quota_rows = dict(store._quotas)
        self._service_regs = dict(store._services)
        self._secret_entries = dict(store._secrets)
        self._acl_store = store.acl  # shared: snapshots read live tokens
        self.index = store.index
        self.cluster = store.cluster
        self.index_at = store.index.value

    def detach_for_writes(self) -> "StateSnapshot":
        """Make this snapshot safe to MUTATE (dry-run scheduling): the
        shallow-copied tables share inner per-job/per-node maps and the
        live index counter with the store — writes through the InMemState
        mutators would leak into live state. Copies the inner maps, gives
        the snapshot a private index counter, and deep-copies the cluster
        tensors. (Job.Plan is the consumer, agent/http.py _job_plan.)"""
        import copy

        self._allocs_by_job = {k: dict(v)
                               for k, v in self._allocs_by_job.items()}
        self._allocs_by_node = {k: dict(v)
                                for k, v in self._allocs_by_node.items()}
        self._deployments = {k: copy.copy(v)
                             for k, v in self._deployments.items()}
        counter = _IndexCounter()
        counter.value = self.index_at
        self.index = counter
        self.cluster = copy.deepcopy(self.cluster)
        # mutable from here on: read-side memos must not engage
        # (scheduler/util.py _node_live_allocs)
        self._detached = True
        self.__dict__.pop("_live_allocs_memo", None)
        return self


class _EventSuspension:
    """`with store.suspend_events():` — restores (WAL replay finished
    elsewhere, raft InstallSnapshot) rebuild state through the normal
    mutators without re-announcing history on the event stream."""

    def __init__(self, store: "StateStore") -> None:
        self._store = store

    def __enter__(self):
        self._prev = self._store._events_suspended
        self._store._events_suspended = True
        return self

    def __exit__(self, *exc):
        self._store._events_suspended = self._prev
        return False


class StateStore(InMemState):
    """Thread-safe store with index watching (blocking queries)."""

    def __init__(self) -> None:
        super().__init__()
        self.index = _IndexCounter()
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        #: cluster event stream (server/event_broker.py): attached by
        #: the owning Server (None ⇒ no events, e.g. NOMAD_TPU_EVENTS=0)
        self.event_broker = None
        self._emit_local = threading.local()
        #: restores replay history through the normal mutators — they
        #: must rebuild state, not re-announce it as fresh events
        self._events_suspended = False

    # -- event emission (the FSM-sourced stream's ONE hook) --
    #
    # Every top-level applied op in EVENT_SOURCE_OPS that advanced the
    # index publishes its derived events, inside the store lock, so the
    # stream order IS the apply order on every path (endpoint write,
    # WAL replay, raft FSM apply on each replica). Nested mutations
    # (upsert_plan_results → upsert_alloc) are depth-suppressed: the
    # outermost entry derives the whole batch (event_broker.py).

    def _emit_enter(self) -> int:
        depth = getattr(self._emit_local, "depth", 0)
        self._emit_local.depth = depth + 1
        return depth

    def _emit_exit(self, depth: int) -> None:
        self._emit_local.depth = depth

    def _emit_entry(self, op: str, args, before_index: int) -> None:
        broker = self.event_broker
        if broker is None or self._events_suspended:
            return
        if self.index.value == before_index:
            return  # no state write → no event (indexes stay unique
            # per entry, so index-based resume never splits one)
        broker.publish_entry(op, args, self.index.value)

    def suspend_events(self) -> "_EventSuspension":
        return _EventSuspension(self)

    # -- copy-on-write alloc indexes so snapshots are iteration-safe --

    def upsert_alloc(self, alloc: Allocation) -> None:
        with self._cv:
            depth = self._emit_enter()
            before = self.index.value
            try:
                jk = (alloc.namespace, alloc.job_id)
                prev = self._allocs.get(alloc.id)
                if prev is not None and prev.node_id != alloc.node_id:
                    old = dict(self._allocs_by_node.get(prev.node_id, {}))
                    old.pop(alloc.id, None)
                    self._allocs_by_node[prev.node_id] = old
                self._allocs[alloc.id] = alloc
                alloc.modify_index = next(self.index)
                if not alloc.create_index:
                    alloc.create_index = alloc.modify_index
                by_job = dict(self._allocs_by_job.get(jk, {}))
                by_job[alloc.id] = alloc
                self._allocs_by_job[jk] = by_job
                by_node = dict(self._allocs_by_node.get(alloc.node_id, {}))
                by_node[alloc.id] = alloc
                self._allocs_by_node[alloc.node_id] = by_node
                self.cluster.upsert_alloc(alloc)
            finally:
                self._emit_exit(depth)
            if depth == 0:
                self._emit_entry("upsert_alloc", (alloc,), before)
            self._cv.notify_all()

    # -- locked mutators --

    def _locked(name):  # noqa: N805 — decorator factory over parent methods
        from .event_broker import EVENT_SOURCE_OPS

        parent = getattr(InMemState, name)
        emits = name in EVENT_SOURCE_OPS

        def method(self, *args, **kwargs):
            with self._cv:
                depth = self._emit_enter()
                before = self.index.value
                try:
                    out = parent(self, *args, **kwargs)
                finally:
                    self._emit_exit(depth)
                if emits and depth == 0:
                    self._emit_entry(name, args, before)
                self._cv.notify_all()
                return out

        method.__name__ = name
        return method

    upsert_node = _locked("upsert_node")
    delete_node = _locked("delete_node")
    upsert_job = _locked("upsert_job")
    delete_job = _locked("delete_job")
    upsert_deployment = _locked("upsert_deployment")
    delete_deployment = _locked("delete_deployment")
    upsert_eval = _locked("upsert_eval")
    delete_eval = _locked("delete_eval")
    upsert_plan_results = _locked("upsert_plan_results")
    upsert_csi_volume = _locked("upsert_csi_volume")
    delete_csi_volume = _locked("delete_csi_volume")
    csi_volume_claim = _locked("csi_volume_claim")
    csi_volume_release = _locked("csi_volume_release")
    csi_volumes = _locked("csi_volumes")
    csi_plugins = _locked("csi_plugins")
    csi_controller_request = _locked("csi_controller_request")
    csi_controller_pending = _locked("csi_controller_pending")
    csi_controller_done = _locked("csi_controller_done")
    # Iterating reads must hold the lock too — the table dicts mutate in place.
    nodes = _locked("nodes")
    jobs = _locked("jobs")
    evals = _locked("evals")
    evals_by_job = _locked("evals_by_job")
    deployments = _locked("deployments")
    latest_stable_job = _locked("latest_stable_job")
    mark_job_stable = _locked("mark_job_stable")
    upsert_service_registrations = _locked("upsert_service_registrations")
    delete_service_registrations_by_alloc = _locked(
        "delete_service_registrations_by_alloc")
    service_registrations = _locked("service_registrations")
    services_by_name = _locked("services_by_name")
    upsert_secret = _locked("upsert_secret")
    delete_secret = _locked("delete_secret")
    secret_get = _locked("secret_get")
    secrets_list = _locked("secrets_list")
    secret_entries = _locked("secret_entries")
    upsert_namespace = _locked("upsert_namespace")
    delete_namespace = _locked("delete_namespace")
    namespaces = _locked("namespaces")
    namespace_by_name = _locked("namespace_by_name")
    job_versions_by_id = _locked("job_versions_by_id")
    upsert_quota = _locked("upsert_quota")
    delete_quota = _locked("delete_quota")
    quotas = _locked("quotas")
    quota_by_name = _locked("quota_by_name")
    del _locked

    def delete_alloc(self, alloc_id: str) -> None:
        # Copy-on-write variant of InMemState.delete_alloc: snapshots hold
        # references to the inner per-job/per-node maps.
        with self._cv:
            depth = self._emit_enter()
            before = self.index.value
            try:
                a = self._allocs.pop(alloc_id, None)
                if a is None:
                    # still sweep the catalog: registrations must never
                    # outlive their alloc, even across delete races
                    InMemState.delete_service_registrations_by_alloc(
                        self, alloc_id)
                    self._cv.notify_all()
                    return
                next(self.index)
                jk = (a.namespace, a.job_id)
                by_job = dict(self._allocs_by_job.get(jk, {}))
                by_job.pop(alloc_id, None)
                self._allocs_by_job[jk] = by_job
                by_node = dict(self._allocs_by_node.get(a.node_id, {}))
                by_node.pop(alloc_id, None)
                self._allocs_by_node[a.node_id] = by_node
                self.cluster.remove_alloc(alloc_id, a.job_id)
                # a GC'd alloc takes its service registrations with it (the
                # safety net behind the client's own deregistration)
                InMemState.delete_service_registrations_by_alloc(
                    self, alloc_id)
            finally:
                self._emit_exit(depth)
            if depth == 0:
                self._emit_entry("delete_alloc", (alloc_id,), before)
            self._cv.notify_all()

    def update_alloc_from_client(self, update: Allocation) -> Optional[Allocation]:
        """Client status push (reference `Node.UpdateAlloc` →
        `state.UpdateAllocsFromClient`, state_store.go:2380): merge client
        fields onto the server's copy."""
        import copy

        with self._cv:
            depth = self._emit_enter()
            before = self.index.value
            try:
                existing = self._allocs.get(update.id)
                if existing is None:
                    return None
                merged = copy.copy(existing)
                merged.client_status = update.client_status
                merged.client_description = getattr(update, "client_description", "")
                merged.task_states = dict(update.task_states)
                merged.deployment_status = update.deployment_status or merged.deployment_status
                self.upsert_alloc(merged)
            finally:
                self._emit_exit(depth)
            if depth == 0:
                self._emit_entry("update_alloc_from_client", (update,),
                                 before)
            self._cv.notify_all()
            return merged

    def transact(self):
        """Hold the store lock across a read-modify-write (the RLock makes
        nested mutators from inside the scope safe)."""
        return self._cv

    def mutation_lock(self):
        """THE lock every mutator holds (also on RaftStateStore, whose
        transact() is a different, weaker lock). Holders get reads that
        are internally consistent with concurrent writers — e.g. the
        plan applier's tensor verification must not observe an alloc
        both released from `used` and still claimable via alloc_usage.
        NEVER hold it across a blocking raft apply (deadlock — see
        RaftStateStore.transact)."""
        return self._cv

    def reset_for_restore(self) -> None:
        """Drop every data table (keep locks, watch plumbing, and the
        index counter OBJECT — its value is pinned by restore_state) so a
        raft InstallSnapshot can rebuild the FSM from the leader's
        snapshot (fsm.go Restore :1256 wipes memdb the same way)."""
        keep = {"index", "_lock", "_cv", "raft", "_intent_lock", "_local",
                "event_broker", "_emit_local", "_events_suspended"}
        kept = {k: v for k, v in self.__dict__.items() if k in keep}
        with self._cv:
            self.__dict__.clear()
            InMemState.__init__(self)
            self.__dict__.update(kept)  # restore the real counter + locks
            self.index.value = 0
            self._cv.notify_all()

    # -- snapshots & blocking --

    def snapshot(self) -> StateSnapshot:
        with self._lock:
            return StateSnapshot(self)

    def snapshot_min_index(self, index: int, timeout: float = 5.0
                           ) -> Optional[StateSnapshot]:
        """Reference SnapshotMinIndex (state_store.go:127): wait until the
        store has applied at least `index`, then snapshot."""
        deadline = None
        with self._cv:
            import time

            deadline = time.time() + timeout
            while self.index.value < index:
                remaining = deadline - time.time()
                if remaining <= 0:
                    return None
                self._cv.wait(remaining)
            return StateSnapshot(self)

    def blocking_query(self, fetch: Callable[[StateSnapshot], Tuple[int, object]],
                       min_index: int = 0, timeout: float = 30.0):
        """Reference blocking query (state_store.go:201 / http helpers): run
        `fetch` on a snapshot; if its reported index ≤ min_index, wait for a
        write and re-run until timeout."""
        import time

        deadline = time.time() + timeout
        while True:
            snap = self.snapshot()
            idx, result = fetch(snap)
            if idx > min_index:
                return idx, result
            with self._cv:
                remaining = deadline - time.time()
                if remaining <= 0:
                    return idx, result
                if self.index.value == snap.index_at:
                    self._cv.wait(min(remaining, 1.0))
