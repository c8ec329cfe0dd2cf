"""Scheduler test harness.

Behavioral reference: `scheduler/testing.go:43` — a fake Planner capturing
Plans/CreateEvals/ReblockEvals against a real in-memory state, applying plans
directly via UpsertPlanResults (:173). This is the keystone of the reference's
scheduler test strategy (SURVEY.md §4.2) and doubles as the state backend
of `chip_smoke.py`.

`InMemState` carries every table of the reference's store: the server's
`StateStore` (server/state.py) builds on it.
"""
from __future__ import annotations

import copy
import itertools
import threading
import uuid
from typing import Dict, List, Optional, Tuple

from ..structs import (
    ALLOC_DESIRED_STOP,
    Allocation,
    Deployment,
    Evaluation,
    Job,
    Node,
    Plan,
    PlanResult,
)
from ..device import DeviceLike, resolve_device
from ..tensor.cluster import ClusterTensors
from .generic import GenericScheduler
from .util import SchedulerConfiguration, State


class InMemState:
    """In-memory state store with the read API schedulers need (mirrors the
    reference's `state.StateStore` usage from the scheduler package)."""

    def __init__(self) -> None:
        self._nodes: Dict[str, Node] = {}
        self._jobs: Dict[Tuple[str, str], Job] = {}
        self._job_versions: Dict[Tuple[str, str, int], Job] = {}
        self._allocs: Dict[str, Allocation] = {}
        self._allocs_by_job: Dict[Tuple[str, str], Dict[str, Allocation]] = {}
        self._allocs_by_node: Dict[str, Dict[str, Allocation]] = {}
        self._deployments: Dict[str, Deployment] = {}
        self._evals: Dict[str, Evaluation] = {}
        self._config = SchedulerConfiguration()
        self.index = itertools.count(1)
        self.cluster = ClusterTensors()

    # ---- write API ----

    def upsert_node(self, node: Node) -> None:
        node.modify_index = next(self.index)
        if not node.create_index:
            node.create_index = node.modify_index
        self._nodes[node.id] = node
        self.cluster.upsert_node(node)

    def delete_node(self, node_id: str) -> None:
        # Deletes advance the index like every other table write (the
        # reference bumps the raft index on deletion too) — blocking
        # queries wake and the event stream gets a unique per-entry
        # index; a no-op delete stays index-silent.
        if self._nodes.pop(node_id, None) is None:
            return
        next(self.index)
        self.cluster.remove_node(node_id)

    def upsert_job(self, job: Job) -> None:
        job.modify_index = next(self.index)
        if not job.create_index:
            job.create_index = job.modify_index
            job.job_modify_index = job.modify_index
        self._jobs[(job.namespace, job.id)] = job
        self._job_versions[(job.namespace, job.id, job.version)] = job

    def upsert_alloc(self, alloc: Allocation) -> None:
        alloc.modify_index = next(self.index)
        if not alloc.create_index:
            alloc.create_index = alloc.modify_index
        prev = self._allocs.get(alloc.id)
        if prev is not None and prev.node_id != alloc.node_id:
            self._allocs_by_node.get(prev.node_id, {}).pop(alloc.id, None)
        self._allocs[alloc.id] = alloc
        self._allocs_by_job.setdefault(
            (alloc.namespace, alloc.job_id), {}
        )[alloc.id] = alloc
        self._allocs_by_node.setdefault(alloc.node_id, {})[alloc.id] = alloc
        self.cluster.upsert_alloc(alloc)

    def upsert_deployment(self, d: Deployment) -> None:
        d.modify_index = next(self.index)
        if not d.create_index:
            d.create_index = d.modify_index
        self._deployments[d.id] = d

    def upsert_eval(self, e: Evaluation) -> None:
        e.modify_index = next(self.index)
        if not e.create_index:
            e.create_index = e.modify_index
        self._evals[e.id] = e

    def upsert_plan_results(self, plan: Plan, result: PlanResult) -> None:
        """Apply a committed plan (reference state.UpsertPlanResults,
        state_store.go:240): stops, preemptions, then placements."""
        for allocs in result.node_update.values():
            for a in allocs:
                existing = self._allocs.get(a.id)
                if existing is not None:
                    merged = copy.copy(existing)
                    merged.desired_status = a.desired_status
                    merged.desired_description = a.desired_description
                    if a.client_status:
                        merged.client_status = a.client_status
                    self.upsert_alloc(merged)
        for allocs in result.node_preemptions.values():
            for a in allocs:
                existing = self._allocs.get(a.id)
                if existing is not None:
                    merged = copy.copy(existing)
                    merged.desired_status = a.desired_status
                    merged.desired_description = a.desired_description
                    merged.preempted_by_allocation = a.preempted_by_allocation
                    self.upsert_alloc(merged)
        for allocs in result.node_allocation.values():
            for a in allocs:
                existing = self._allocs.get(a.id)
                if existing is not None:
                    # Re-upserting a live alloc (in-place update): keep the
                    # client-owned fields — the plan's copy is a stale
                    # scheduler snapshot (reference upsertAllocsImpl,
                    # state_store.go: ClientStatus/TaskStates carried over).
                    a = copy.copy(a)
                    a.client_status = existing.client_status
                    a.client_description = existing.client_description
                    a.task_states = existing.task_states
                if a.job is None:
                    # WAL replay strips the embedded job; reattach the
                    # VERSION the alloc was placed with, not the current
                    # table head — the reconciler's in-place/destructive
                    # classification compares alloc.job.version.
                    a.job = (self._job_versions.get(
                        (a.namespace, a.job_id, a.job_version))
                        or self._jobs.get((a.namespace, a.job_id)))
                self.upsert_alloc(a)
        if result.deployment is not None:
            self.upsert_deployment(result.deployment)
        for du in result.deployment_updates:
            d = self._deployments.get(du.deployment_id)
            if d is not None:
                d.status = du.status
                d.status_description = du.status_description

    # ---- read API (scheduler State protocol) ----

    def nodes(self) -> List[Node]:
        return list(self._nodes.values())

    def node_by_id(self, node_id: str) -> Optional[Node]:
        return self._nodes.get(node_id)

    def job_by_id(self, namespace: str, job_id: str) -> Optional[Job]:
        return self._jobs.get((namespace, job_id))

    def jobs(self) -> List[Job]:
        return list(self._jobs.values())

    def transact(self):
        """Atomic read-modify-write scope. The plain in-memory state is
        single-threaded (scheduler tests); the server StateStore overrides
        this with its lock."""
        import contextlib

        return contextlib.nullcontext()

    def job_by_id_and_version(self, namespace: str, job_id: str, version: int
                              ) -> Optional[Job]:
        return self._job_versions.get((namespace, job_id, version))

    def job_versions_by_id(self, namespace: str, job_id: str) -> List[Job]:
        """All stored versions, newest first (state JobVersionsByID)."""
        return sorted((job for (ns, jid, _v), job
                       in self._job_versions.items()
                       if (ns, jid) == (namespace, job_id)),
                      key=lambda j: j.version, reverse=True)

    def allocs_by_job(self, namespace: str, job_id: str,
                      any_create_index: bool = True) -> List[Allocation]:
        return list(self._allocs_by_job.get((namespace, job_id), {}).values())

    def allocs_by_node(self, node_id: str) -> List[Allocation]:
        return list(self._allocs_by_node.get(node_id, {}).values())

    def alloc_by_id(self, alloc_id: str) -> Optional[Allocation]:
        return self._allocs.get(alloc_id)

    def deployments(self) -> List[Deployment]:
        return list(self._deployments.values())

    def deployment_by_id(self, deployment_id: str) -> Optional[Deployment]:
        return self._deployments.get(deployment_id)

    def latest_stable_job(self, namespace: str, job_id: str,
                          below_version: Optional[int] = None
                          ) -> Optional[Job]:
        """Latest job version marked stable (reference
        state.JobVersionsByID + deployment_watcher latestStableJob)."""
        best = None
        for (ns, jid, ver), job in self._job_versions.items():
            if (ns, jid) != (namespace, job_id) or not job.stable:
                continue
            if below_version is not None and ver >= below_version:
                continue
            if best is None or ver > best.version:
                best = job
        return best

    def mark_job_stable(self, namespace: str, job_id: str, version: int
                        ) -> None:
        job = self._job_versions.get((namespace, job_id, version))
        if job is not None:
            job.stable = True
        cur = self._jobs.get((namespace, job_id))
        if cur is not None and cur.version == version:
            cur.stable = True
        if job is not None or cur is not None:
            next(self.index)

    def latest_deployment_by_job(self, namespace: str, job_id: str
                                 ) -> Optional[Deployment]:
        best = None
        for d in self._deployments.values():
            if d.namespace == namespace and d.job_id == job_id:
                if best is None or d.create_index > best.create_index:
                    best = d
        return best

    def eval_by_id(self, eval_id: str) -> Optional[Evaluation]:
        return self._evals.get(eval_id)

    def evals(self) -> List[Evaluation]:
        return list(self._evals.values())

    def evals_by_job(self, namespace: str, job_id: str) -> List[Evaluation]:
        return [e for e in self._evals.values()
                if e.namespace == namespace and e.job_id == job_id]

    # ---- deletion (GC write API; reference state_store.go DeleteEval,
    # DeleteJob, DeleteNode, DeleteDeployment) ----

    def delete_eval(self, eval_id: str) -> None:
        if self._evals.pop(eval_id, None) is not None:
            next(self.index)

    def delete_alloc(self, alloc_id: str) -> None:
        a = self._allocs.pop(alloc_id, None)
        if a is None:
            return
        next(self.index)
        self._allocs_by_job.get((a.namespace, a.job_id), {}).pop(alloc_id, None)
        self._allocs_by_node.get(a.node_id, {}).pop(alloc_id, None)
        self.cluster.remove_alloc(alloc_id, a.job_id)

    def delete_job(self, namespace: str, job_id: str) -> None:
        if self._jobs.pop((namespace, job_id), None) is not None:
            next(self.index)
        for key in [k for k in self._job_versions
                    if k[0] == namespace and k[1] == job_id]:
            del self._job_versions[key]

    def delete_deployment(self, deployment_id: str) -> None:
        if self._deployments.pop(deployment_id, None) is not None:
            next(self.index)

    def scheduler_config(self) -> SchedulerConfiguration:
        return self._config

    def set_scheduler_config(self, config: SchedulerConfiguration) -> None:
        self._config = config

    # ---- service registrations (built-in service discovery; the
    # reference's Consul catalog analog — structs/service.py) ----

    @property
    def _services(self):
        tbl = getattr(self, "_service_regs", None)
        if tbl is None:
            tbl = self._service_regs = {}
        return tbl

    def upsert_service_registrations(self, regs) -> None:
        import dataclasses as _dc

        for reg in regs:
            # store a copy: in-proc callers keep mutating their object
            # (the check runner flips status in place) — shared storage
            # would change state without an index bump
            reg = _dc.replace(reg, tags=list(reg.tags))
            prev = self._services.get(reg.id)
            if prev is not None and (
                    prev.service_name, prev.namespace, prev.node_id,
                    prev.job_id, prev.alloc_id, prev.task_name, prev.tags,
                    prev.address, prev.port, prev.status) == (
                    reg.service_name, reg.namespace, reg.node_id,
                    reg.job_id, reg.alloc_id, reg.task_name, reg.tags,
                    reg.address, reg.port, reg.status):
                continue  # anti-entropy re-assert: unchanged, no index
            reg.modify_index = next(self.index)
            reg.create_index = (prev.create_index if prev
                                else reg.modify_index)
            self._services[reg.id] = reg

    def delete_service_registrations_by_alloc(self, alloc_id: str) -> None:
        gone = [rid for rid, r in self._services.items()
                if r.alloc_id == alloc_id]
        for rid in gone:
            del self._services[rid]
        if gone:
            next(self.index)

    def service_registrations(self, namespace=None) -> List[object]:
        return [r for r in self._services.values()
                if namespace is None or r.namespace == namespace]

    def services_by_name(self, namespace: str, name: str) -> List[object]:
        return [r for r in self._services.values()
                if r.namespace == namespace and r.service_name == name]

    # ---- secrets KV (built-in Vault analog; structs/secrets.py) ----

    @property
    def _secrets(self):
        tbl = getattr(self, "_secret_entries", None)
        if tbl is None:
            tbl = self._secret_entries = {}
        return tbl

    def upsert_secret(self, entry) -> None:
        key = (entry.namespace, entry.path)
        prev = self._secrets.get(key)
        entry.modify_index = next(self.index)
        entry.create_index = (prev.create_index if prev
                              else entry.modify_index)
        entry.version = (prev.version + 1) if prev else 1
        self._secrets[key] = entry

    def delete_secret(self, namespace: str, path: str) -> None:
        if self._secrets.pop((namespace, path), None) is not None:
            next(self.index)

    def secret_get(self, namespace: str, path: str):
        return self._secrets.get((namespace, path))

    def secrets_list(self, namespace: str) -> List[object]:
        return sorted((e for e in self._secrets.values()
                       if e.namespace == namespace),
                      key=lambda e: e.path)

    def secret_entries(self) -> List[object]:
        """All entries, every namespace (snapshot encode)."""
        return list(self._secrets.values())

    # ---- namespaces (structs/operator.py Namespace) ----

    @property
    def _namespaces(self):
        tbl = getattr(self, "_namespace_rows", None)
        if tbl is None:
            from ..structs.operator import Namespace

            tbl = self._namespace_rows = {
                "default": Namespace(name="default",
                                     description="Default shared namespace")}
        return tbl

    def upsert_namespace(self, ns) -> None:
        prev = self._namespaces.get(ns.name)
        ns.modify_index = next(self.index)
        ns.create_index = prev.create_index if prev else ns.modify_index
        self._namespaces[ns.name] = ns

    def delete_namespace(self, name: str) -> None:
        if self._namespaces.pop(name, None) is None:
            return
        # cascade EVERY namespace-scoped row in the SAME log entry:
        # leftovers (secrets, stopped jobs + their version history,
        # terminal allocs/evals) would silently re-attach to a future
        # namespace of the same name — a cross-tenant leak. The server
        # endpoint refuses the delete while non-terminal jobs or CSI
        # volumes exist, so everything swept here is already dead.
        for key in [k for k in self._secrets if k[0] == name]:
            del self._secrets[key]
        for a in [a for a in list(self._allocs.values())
                  if a.namespace == name]:
            self.delete_alloc(a.id)
        for e in [e for e in list(self._evals.values())
                  if e.namespace == name]:
            self.delete_eval(e.id)
        for j in [j for j in list(self._jobs.values())
                  if j.namespace == name]:
            self.delete_job(name, j.id)
        for key in [k for k in self._job_versions if k[0] == name]:
            del self._job_versions[key]
        for d in [d for d in list(self._deployments.values())
                  if d.namespace == name]:
            self.delete_deployment(d.id)
        next(self.index)

    def namespaces(self) -> List[object]:
        return sorted(self._namespaces.values(), key=lambda n: n.name)

    def namespace_by_name(self, name: str):
        return self._namespaces.get(name)

    # ---- quotas (structs/operator.py QuotaSpec) ----

    @property
    def _quotas(self):
        tbl = getattr(self, "_quota_rows", None)
        if tbl is None:
            tbl = self._quota_rows = {}
        return tbl

    def upsert_quota(self, q) -> None:
        prev = self._quotas.get(q.name)
        q.modify_index = next(self.index)
        q.create_index = prev.create_index if prev else q.modify_index
        self._quotas[q.name] = q

    def delete_quota(self, name: str) -> None:
        if self._quotas.pop(name, None) is not None:
            next(self.index)

    def quotas(self) -> List[object]:
        return sorted(self._quotas.values(), key=lambda q: q.name)

    def quota_by_name(self, name: str):
        return self._quotas.get(name)

    def autopilot_config(self):
        cfg = getattr(self, "_autopilot_cfg", None)
        if cfg is None:
            from ..structs.operator import AutopilotConfig

            cfg = self._autopilot_cfg = AutopilotConfig()
        return cfg

    def set_autopilot_config(self, config) -> None:
        self._autopilot_cfg = config

    # ---- CSI volumes (reference state/schema.go :687/:719, csi state
    # methods in state_store.go) ----

    @property
    def _csi(self):
        tbl = getattr(self, "_csi_volumes", None)
        if tbl is None:
            tbl = self._csi_volumes = {}
        return tbl

    @property
    def _ctrl_leases(self):
        """(namespace, vol_id, node_id) → (lessee_node, ts). Ephemeral
        coordination state kept OUTSIDE the CSIVolume structs so it is
        never serialized into snapshots/journals — a restored server
        simply hands ops out afresh (leases are wall-clock; persisting
        them would stall attach on any clock skew)."""
        tbl = getattr(self, "_ctrl_lease_tbl", None)
        if tbl is None:
            tbl = self._ctrl_lease_tbl = {}
        return tbl

    def upsert_csi_volume(self, vol) -> None:
        vol.modify_index = next(self.index)
        if not vol.create_index:
            vol.create_index = vol.modify_index
        self._csi[(vol.namespace, vol.id)] = vol

    def delete_csi_volume(self, namespace: str, vol_id: str) -> None:
        self._csi.pop((namespace, vol_id), None)

    def csi_volume(self, namespace: str, vol_id: str):
        return self._csi.get((namespace, vol_id))

    def csi_volumes(self) -> List[object]:
        return list(self._csi.values())

    def csi_volume_claim(self, namespace: str, vol_id: str, alloc_id: str,
                         mode: str) -> bool:
        vol = self._csi.get((namespace, vol_id))
        if vol is None or not vol.claim(alloc_id, mode):
            return False
        vol.modify_index = next(self.index)
        return True

    def csi_volume_release(self, namespace: str, vol_id: str,
                           alloc_id: str) -> None:
        vol = self._csi.get((namespace, vol_id))
        if vol is not None and vol.release(alloc_id):
            vol.modify_index = next(self.index)

    # -- controller orchestration (nomad/csi_endpoint.go:458
    # controllerPublishVolume; volume_watcher.go unpublish path). The
    # server queues ops on the volume; clients hosting the controller
    # plugin drain them via csi_controller_pending + report through
    # csi_controller_done. --

    def csi_controller_request(self, namespace: str, vol_id: str,
                               node_id: str, op: str,
                               readonly: bool = False) -> None:
        vol = self._csi.get((namespace, vol_id))
        if vol is None:
            return
        pending = vol.controller_pending.get(node_id)
        if op == "publish":
            if pending is not None and pending.get("op") == "unpublish":
                # node re-claimed before the detach ran: convert the
                # pending op to a (re-)publish — deleting it would race
                # an already-executing unpublish and strand the node
                # detached with a stale context. Any lease survives in
                # _ctrl_leases: the client executing the unpublish must
                # report done before the publish is handed out, keeping
                # controller ops serial per (volume, node).
                vol.controller_errors.pop(node_id, None)
                vol.modify_index = next(self.index)
                vol.controller_pending[node_id] = {
                    "op": "publish", "readonly": readonly,
                    "gen": vol.modify_index}
                return
            if node_id in vol.publish_contexts:
                return  # already attached, nothing queued against it
        if pending is not None and pending.get("op") == op:
            return  # already queued
        # on overwrite (publish→unpublish when the claim vanished) the
        # _ctrl_leases entry is left intact: an executing host finishes
        # and reports before the successor op is handed out
        vol.controller_errors.pop(node_id, None)
        vol.modify_index = next(self.index)
        # gen: deterministic op generation (the raft-journaled index
        # bump) echoed through poll → execute → done, so a STALE result
        # from a superseded host can never resolve a newer op of the
        # same kind queued after its lease expired
        vol.controller_pending[node_id] = {"op": op, "readonly": readonly,
                                           "gen": vol.modify_index}

    #: how long one controller host owns a handed-out op before another
    #: poller may retry it (the host crashed or wedged mid-op)
    CONTROLLER_LEASE_S = 15.0

    def csi_controller_pending(self, plugin_ids,
                               lessee: Optional[str] = None) -> List[dict]:
        """Queued controller ops for the given plugin ids (a controller
        host's poll). Ops are LEASED to the polling node: with several
        clients hosting the same controller plugin, exactly one executes
        a given op at a time — a second host only inherits it after the
        lease expires (crash recovery). Leases are ephemeral coordination
        state (not replicated/persisted): after a server restart ops are
        simply handed out afresh."""
        import time as _time

        pids = set(plugin_ids)
        now = _time.time()
        leases = self._ctrl_leases
        out = []
        for vol in self._csi.values():
            if vol.plugin_id not in pids:
                continue
            for node_id, ent in vol.controller_pending.items():
                key = (vol.namespace, vol.id, node_id)
                lease = leases.get(key)
                if (lessee is not None and lease is not None
                        and lease[0] != lessee
                        and lease[1] + self.CONTROLLER_LEASE_S > now):
                    continue  # another host is executing this op
                if lessee is not None:
                    leases[key] = (lessee, now)
                out.append({"namespace": vol.namespace, "volume_id": vol.id,
                            "plugin_id": vol.plugin_id,
                            "node_id": node_id, "op": ent["op"],
                            "readonly": bool(ent.get("readonly")),
                            "gen": int(ent.get("gen", 0))})
        return out

    def csi_controller_lease(self, namespace: str, vol_id: str,
                             node_id: str):
        """Read-only: the live (lessee, ts) for a pending controller op,
        for the LEADER's pre-journal reporter guard
        (server.csi_controller_done)."""
        return self._ctrl_leases.get((namespace, vol_id, node_id))

    def csi_controller_done(self, namespace: str, vol_id: str,
                            node_id: str, op: str,
                            context: Optional[dict] = None,
                            error: str = "", reporter: str = "",
                            gen: int = 0) -> None:
        """Apply a controller-op result. RAFT-REPLAYED: must be a pure
        function of journaled args + replicated state. The superseded-
        lessee guard therefore lives at the leader's RPC ingress
        (server.csi_controller_done drops reports whose reporter no
        longer holds the lease BEFORE journaling); `reporter` is
        accepted here only for journal-format compatibility. `gen` is
        the deterministic generation stamped on the pending op at
        request time — a result only resolves the op it was handed out
        for, so a stale host's late report can never delete a NEWER op
        of the same kind queued after its lease expired."""
        vol = self._csi.get((namespace, vol_id))
        if vol is None:
            return
        # op resolved or converted-then-reported: either way the lease is
        # released so the successor op can be handed out (empty table on
        # replay/followers — popping is a deterministic no-op there)
        self._ctrl_leases.pop((namespace, vol_id, node_id), None)
        pending = vol.controller_pending.get(node_id)
        still_wanted = (pending is not None and pending.get("op") == op
                        and (not gen or pending.get("gen", 0) == gen))
        if still_wanted:
            del vol.controller_pending[node_id]
        if error:
            if still_wanted:
                vol.controller_errors[node_id] = error
        elif op == "publish" and (
                still_wanted or (pending is not None
                                 and pending.get("op") == "unpublish")):
            # a stale/genless result must not (re)install a context: when
            # pending is None the op was superseded and resolved (the
            # node may be detached); when a NEWER publish is pending its
            # own completion will install the fresh context. A pending
            # unpublish is fine: the attach ran, the detach will pop it.
            vol.publish_contexts[node_id] = dict(context or {})
        elif op == "unpublish" and (still_wanted or pending is not None):
            # the detach DID run: drop the context so a converted
            # re-publish repopulates it before any waiter mounts from it.
            # When pending is None the op was superseded by an already-
            # COMPLETED publish (lease-expiry corner) — keep that fresh
            # context.
            vol.publish_contexts.pop(node_id, None)
        vol.modify_index = next(self.index)

    def csi_plugins(self) -> List[object]:
        """Aggregate plugin health from node fingerprints (csi.go
        CSIPlugin counts)."""
        from ..structs.csi import CSIPlugin

        plugins: Dict[str, CSIPlugin] = {}
        for node in self._nodes.values():
            for pid, info in (node.csi_node_plugins or {}).items():
                p = plugins.setdefault(pid, CSIPlugin(id=pid))
                p.nodes_expected += 1
                if getattr(info, "healthy", True):
                    p.nodes_healthy += 1
            for pid, info in (node.csi_controller_plugins or {}).items():
                p = plugins.setdefault(pid, CSIPlugin(id=pid))
                p.controllers_expected += 1
                if getattr(info, "healthy", True):
                    p.controllers_healthy += 1
        return list(plugins.values())

    # ---- ACL tables (reference state_store.go ACL sections; the token
    # store rides inside the state so WAL/Raft replicate it like any
    # other table — restart and peers keep issued tokens valid) ----

    @property
    def acl(self):
        store = getattr(self, "_acl_store", None)
        if store is None:
            from ..acl import TokenStore

            store = self._acl_store = TokenStore()
        return store

    def upsert_acl_policy(self, policy) -> None:
        self.acl.upsert_policy(policy)

    def delete_acl_policy(self, name: str) -> None:
        self.acl.delete_policy(name)

    def upsert_acl_token(self, token) -> None:
        # callers pre-fill accessor/secret ids so replay is deterministic
        self.acl.upsert_token(token)

    def delete_acl_token(self, accessor_id: str) -> None:
        self.acl.delete_token(accessor_id)

    def acl_bootstrap(self, token) -> None:
        self.acl.bootstrap(token)


class Harness:
    """Reference Harness (scheduler/testing.go:43): captures submitted plans
    and eval updates; optionally applies plans to state. `device` is where
    placement runs: None means the card, and a missing card raises."""

    def __init__(self, state: Optional[InMemState] = None,
                 device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        self.state = state or InMemState()
        self.plans: List[Plan] = []
        self.evals: List[Evaluation] = []
        self.create_evals: List[Evaluation] = []
        self.reblock_evals: List[Evaluation] = []
        self.reject_plan = False
        self._lock = threading.Lock()

    # ---- Planner protocol ----

    def submit_plan(self, plan: Plan) -> Tuple[PlanResult, Optional[State]]:
        """Reference SubmitPlan (testing.go:130): reject or apply fully."""
        with self._lock:
            self.plans.append(plan)
            if self.reject_plan:
                # Rejection returns a refreshed state (testing.go:18 RejectPlan)
                return PlanResult(), self.state
            result = PlanResult(
                node_update=plan.node_update,
                node_allocation=plan.node_allocation,
                node_preemptions=plan.node_preemptions,
                deployment=plan.deployment,
                deployment_updates=plan.deployment_updates,
                alloc_index=next(self.state.index),
            )
            self.state.upsert_plan_results(plan, result)
            return result, None

    def update_eval(self, e: Evaluation) -> None:
        with self._lock:
            self.evals.append(e)

    def create_eval(self, e: Evaluation) -> None:
        with self._lock:
            self.create_evals.append(e)
            self.state.upsert_eval(e)

    def reblock_eval(self, e: Evaluation) -> None:
        with self._lock:
            self.reblock_evals.append(e)

    # ---- convenience ----

    def scheduler_for(self, eval: Evaluation):
        """Reference scheduler factory (scheduler.go:34 NewScheduler)."""
        if eval.type == "system":
            raise NotImplementedError(
                "the system scheduler is not ported yet (ROADMAP A7)")
        return GenericScheduler(
            self.state, self, self.state.cluster,
            is_batch=(eval.type == "batch"), device=self.device)

    def process(self, eval: Evaluation) -> None:
        self.scheduler_for(eval).process(eval)
