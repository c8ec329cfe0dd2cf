"""DeploymentsWatcher — drives rolling updates, canaries, promotion,
auto-revert.

Behavioral reference: `nomad/deploymentwatcher/` (deployments_watcher.go:26
Watcher, deployment_watcher.go per-deployment logic, batcher.go 250ms eval
batching). The reference runs one goroutine per active deployment over
blocking queries; here one thread watches the store's condition variable and
re-evaluates every active deployment on each state change — same transitions,
single-process form:

- unhealthy alloc → deployment failed (+ auto-revert to latest stable job)
- progress deadline passed without a newly-healthy alloc → failed
- auto_promote + all canaries healthy → promote
- every group promoted (or canary-free) with healthy ≥ desired_total →
  successful, job version marked stable
- health transitions create follow-up evals so the scheduler places the next
  rolling batch (reference createBatchedUpdate → Eval)
"""
from __future__ import annotations

import copy
import threading
import time
from typing import Dict, List, Optional

from ..structs import Allocation, Evaluation, Job
from ..structs.deployment import (
    DEPLOYMENT_DESC_FAILED_ALLOCS,
    DEPLOYMENT_DESC_PROGRESS_DEADLINE,
    DEPLOYMENT_DESC_SUCCESSFUL,
    DEPLOYMENT_STATUS_FAILED,
    DEPLOYMENT_STATUS_PAUSED,
    DEPLOYMENT_STATUS_RUNNING,
    DEPLOYMENT_STATUS_SUCCESSFUL,
    Deployment,
)
from ..structs.evaluation import (
    EVAL_STATUS_PENDING,
    TRIGGER_DEPLOYMENT_WATCHER,
    TRIGGER_ROLLING_UPDATE,
)

DESC_PROMOTED = "Deployment promoted"
DESC_PAUSED = "Deployment paused"
DESC_RESUMED = "Deployment resumed"
DESC_MANUAL_FAIL = "Deployment marked as failed"


class DeploymentsWatcher:
    def __init__(self, server) -> None:
        self.server = server
        self.state = server.state
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # deployment id → last healthy count (progress tracking), guarded
        # by _lock: the watcher thread advances it while operator RPCs
        # (fail) clear entries from API threads (NLT01)
        self._lock = threading.Lock()
        self._progress: Dict[str, int] = {}
        self._enabled = False

    # ---- lifecycle ----

    def start(self) -> None:
        self._enabled = True
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="deployments-watcher")
        self._thread.start()

    def shutdown(self) -> None:
        self._enabled = False
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def notify(self) -> None:
        """State changed — re-evaluate (replaces per-watcher blocking query)."""
        self._wake.set()

    def _run(self) -> None:
        import logging

        log = logging.getLogger("nomad_tpu.deployments")
        while not self._stop.is_set():
            self._wake.wait(timeout=0.25)  # timeout drives deadline checks
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self.check_deployments()
            except Exception:  # watcher must never die with the server up
                log.exception("deployments watcher check failed")

    # ---- core evaluation ----

    def check_deployments(self) -> None:
        for d in self.state.deployments():
            if d.active():
                with self.state.transact():
                    # Re-read under the lock: a plan apply may have updated
                    # the deployment (placed canaries) since the scan.
                    cur = self.state.deployment_by_id(d.id)
                    if cur is not None and cur.active():
                        self._check(cur)

    def _deployment_allocs(self, d: Deployment) -> List[Allocation]:
        return [
            a for a in self.state.allocs_by_job(d.namespace, d.job_id)
            if a.deployment_id == d.id
        ]

    def _check(self, d: Deployment) -> None:
        allocs = self._deployment_allocs(d)
        now = time.time()
        updated = copy.deepcopy(d)
        changed = False
        unhealthy_seen = False

        by_group: Dict[str, List[Allocation]] = {}
        for a in allocs:
            by_group.setdefault(a.task_group, []).append(a)

        healthy_total = 0
        for tg_name, ds in updated.task_groups.items():
            group = by_group.get(tg_name, [])
            placed = len(group)
            healthy = sum(
                1 for a in group
                if a.deployment_status is not None
                and a.deployment_status.is_healthy()
            )
            unhealthy = sum(
                1 for a in group
                if a.deployment_status is not None
                and a.deployment_status.is_unhealthy()
            )
            if (placed, healthy, unhealthy) != (
                ds.placed_allocs, ds.healthy_allocs, ds.unhealthy_allocs
            ):
                ds.placed_allocs = placed
                ds.healthy_allocs = healthy
                ds.unhealthy_allocs = unhealthy
                changed = True
            if unhealthy:
                unhealthy_seen = True
            healthy_total += healthy
            # Arm / extend the progress deadline (deployment_watcher.go
            # getDeploymentProgressCutoff semantics).
            if ds.progress_deadline_s > 0:
                if ds.require_progress_by == 0.0:
                    ds.require_progress_by = now + ds.progress_deadline_s
                    changed = True

        # Progress made since last check extends every group's deadline.
        with self._lock:
            prev_healthy = self._progress.get(d.id, -1)
            if healthy_total > prev_healthy:
                self._progress[d.id] = healthy_total
        if healthy_total > prev_healthy:
            if prev_healthy >= 0:
                for ds in updated.task_groups.values():
                    if ds.progress_deadline_s > 0:
                        ds.require_progress_by = now + ds.progress_deadline_s
                        changed = True

        # A paused deployment only tracks counts — no automatic transitions
        # until the operator resumes it (deployment_watcher.go gates rollout
        # on !paused).
        if updated.status != DEPLOYMENT_STATUS_RUNNING:
            if changed:
                self.state.upsert_deployment(updated)
            return

        # -- failure: unhealthy alloc (deployment_watcher.go FailDeployment) --
        if unhealthy_seen:
            self._fail(updated, DEPLOYMENT_DESC_FAILED_ALLOCS)
            return

        # -- failure: progress deadline --
        for ds in updated.task_groups.values():
            if (
                ds.progress_deadline_s > 0
                and ds.require_progress_by > 0
                and now > ds.require_progress_by
                and ds.healthy_allocs < ds.desired_total
            ):
                self._fail(updated, DEPLOYMENT_DESC_PROGRESS_DEADLINE)
                return

        # -- auto promote --
        if updated.requires_promotion() and self._auto_promotable(updated):
            if self._canaries_healthy(updated, by_group):
                self.promote(updated.id)
                return

        # -- success --
        done = all(
            ds.healthy_allocs >= ds.desired_total
            and (ds.desired_canaries == 0 or ds.promoted)
            for ds in updated.task_groups.values()
        ) and updated.task_groups
        if done:
            updated.status = DEPLOYMENT_STATUS_SUCCESSFUL
            updated.status_description = DEPLOYMENT_DESC_SUCCESSFUL
            self.state.upsert_deployment(updated)
            self._mark_job_stable(updated)
            with self._lock:
                self._progress.pop(updated.id, None)
            return

        if changed:
            self.state.upsert_deployment(updated)
            self._create_eval(updated, TRIGGER_DEPLOYMENT_WATCHER)

    @staticmethod
    def _auto_promotable(d: Deployment) -> bool:
        groups = [ds for ds in d.task_groups.values()
                  if ds.desired_canaries > 0]
        return bool(groups) and all(ds.auto_promote for ds in groups)

    @staticmethod
    def _canaries_healthy(d: Deployment,
                          by_group: Dict[str, List[Allocation]]) -> bool:
        for tg_name, ds in d.task_groups.items():
            if ds.desired_canaries == 0:
                continue
            canary_ids = set(ds.placed_canaries)
            healthy = sum(
                1 for a in by_group.get(tg_name, [])
                if a.id in canary_ids
                and a.deployment_status is not None
                and a.deployment_status.is_healthy()
            )
            if healthy < ds.desired_canaries:
                return False
        return True

    # ---- operations (Deployment.Promote/Fail/Pause RPCs) ----

    def promote(self, deployment_id: str,
                groups: Optional[List[str]] = None) -> Optional[Evaluation]:
        """Reference `Deployment.Promote` → fsm.applyDeploymentPromotion
        (fsm.go:985): mark groups promoted; non-promoted canaries of other
        groups stay."""
        with self.state.transact():
            d = self.state.deployment_by_id(deployment_id)
            if d is None or not d.active():
                return None
            updated = copy.deepcopy(d)
            allocs = {a.id: a for a in self._deployment_allocs(updated)}
            unhealthy_err = None
            for tg_name, ds in updated.task_groups.items():
                if groups is not None and tg_name not in groups:
                    continue
                if ds.desired_canaries > 0 and not ds.promoted:
                    healthy = sum(
                        1 for cid in ds.placed_canaries
                        if cid in allocs
                        and allocs[cid].deployment_status is not None
                        and allocs[cid].deployment_status.is_healthy()
                    )
                    if healthy < ds.desired_canaries:
                        unhealthy_err = (
                            f"task group {tg_name} has {healthy}/"
                            f"{ds.desired_canaries} healthy canaries"
                        )
                        continue
                    ds.promoted = True
            if unhealthy_err is not None:
                raise ValueError(unhealthy_err)
            updated.status_description = DESC_PROMOTED
            self.state.upsert_deployment(updated)
            return self._create_eval(updated, TRIGGER_DEPLOYMENT_WATCHER)

    def fail(self, deployment_id: str) -> Optional[Evaluation]:
        with self.state.transact():
            d = self.state.deployment_by_id(deployment_id)
            if d is None or not d.active():
                return None
            updated = copy.deepcopy(d)
            return self._fail(updated, DESC_MANUAL_FAIL)

    def pause(self, deployment_id: str, pause: bool) -> None:
        with self.state.transact():
            d = self.state.deployment_by_id(deployment_id)
            if d is None or not d.active():
                return
            updated = copy.deepcopy(d)
            if pause:
                updated.status = DEPLOYMENT_STATUS_PAUSED
                updated.status_description = DESC_PAUSED
            else:
                updated.status = DEPLOYMENT_STATUS_RUNNING
                updated.status_description = DESC_RESUMED
            self.state.upsert_deployment(updated)
        if not pause:
            self._create_eval(updated, TRIGGER_DEPLOYMENT_WATCHER)

    # ---- transitions ----

    def _fail(self, d: Deployment, desc: str) -> Optional[Evaluation]:
        d.status = DEPLOYMENT_STATUS_FAILED
        d.status_description = desc
        self.state.upsert_deployment(d)
        with self._lock:
            self._progress.pop(d.id, None)
        reverted = self._auto_revert(d)
        if reverted:
            d.status_description = (
                f"{desc} - rolling back to job version {reverted.version}"
            )
            self.state.upsert_deployment(d)
        return self._create_eval(d, TRIGGER_DEPLOYMENT_WATCHER)

    def _auto_revert(self, d: Deployment) -> Optional[Job]:
        """Revert to the latest stable version below the deployment's
        (reference deployment_watcher.go latestStableJob + auto_revert)."""
        if not any(ds.auto_revert for ds in d.task_groups.values()):
            return None
        stable = self.state.latest_stable_job(d.namespace, d.job_id,
                                              below_version=d.job_version)
        if stable is None:
            return None
        reverted = copy.copy(stable)
        reverted.version = 0  # job_register re-versions it
        reverted.create_index = 0
        reverted.modify_index = 0
        reverted.job_modify_index = 0
        reverted.stable = False
        self.server.job_register(reverted)
        return self.state.job_by_id(d.namespace, d.job_id)

    def _mark_job_stable(self, d: Deployment) -> None:
        """Successful deployment marks the job version stable
        (reference fsm applyDeploymentStatusUpdate → UpdateJobStability)."""
        self.state.mark_job_stable(d.namespace, d.job_id, d.job_version)

    def _create_eval(self, d: Deployment, trigger: str
                     ) -> Optional[Evaluation]:
        job = self.state.job_by_id(d.namespace, d.job_id)
        if job is None:
            return None
        return self.server._create_eval(
            namespace=d.namespace,
            priority=job.priority,
            type=job.type,
            triggered_by=trigger,
            job_id=d.job_id,
            deployment_id=d.id,
            status=EVAL_STATUS_PENDING,
        )
