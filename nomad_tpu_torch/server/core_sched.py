"""CoreScheduler — internal `_core` evaluations: garbage collection.

Behavioral reference: `nomad/core_sched.go` (dispatch :47-57 on the eval's
JobID; evalGC, jobGC, nodeGC, deploymentGC; `forceGC` runs all). Thresholds
are wall-clock ages converted to state-index cutoffs through the TimeTable
(`nomad/timetable.go`), exactly as the reference's `getThreshold` does.

GC rules (each mirrors the corresponding core_sched.go collector):
- eval-gc: terminal evals past threshold whose allocs are all terminal →
  delete eval + allocs. Evals of batch jobs whose job still exists are kept
  (they hold reschedule history for `nomad job status`).
- job-gc: dead/stopped non-periodic-parent jobs where every eval and alloc
  is terminal and past threshold → delete job (+ its evals/allocs/versions).
- node-gc: down/disconnected nodes past threshold with no allocs → delete.
- deployment-gc: terminal deployments past threshold not referenced by a
  non-terminal alloc → delete.
"""
from __future__ import annotations

import time
from typing import List

from ..structs.deployment import (
    DEPLOYMENT_STATUS_CANCELLED,
    DEPLOYMENT_STATUS_FAILED,
    DEPLOYMENT_STATUS_SUCCESSFUL,
)
from ..structs.evaluation import (
    EVAL_STATUS_CANCELLED,
    EVAL_STATUS_COMPLETE,
    EVAL_STATUS_FAILED,
)
from ..structs.job import JOB_TYPE_BATCH
from ..structs.node import NODE_STATUS_DOWN

CORE_JOB_EVAL_GC = "eval-gc"
CORE_JOB_JOB_GC = "job-gc"
CORE_JOB_NODE_GC = "node-gc"
CORE_JOB_DEPLOYMENT_GC = "deployment-gc"
CORE_JOB_FORCE_GC = "force-gc"

TERMINAL_EVAL = {EVAL_STATUS_COMPLETE, EVAL_STATUS_FAILED,
                 EVAL_STATUS_CANCELLED}
TERMINAL_DEPLOYMENT = {DEPLOYMENT_STATUS_SUCCESSFUL, DEPLOYMENT_STATUS_FAILED,
                       DEPLOYMENT_STATUS_CANCELLED}


class GCConfig:
    """Threshold ages in seconds (reference config defaults are 1-4h;
    command/agent/config.go server block)."""

    def __init__(self, eval_gc_threshold: float = 3600.0,
                 job_gc_threshold: float = 4 * 3600.0,
                 node_gc_threshold: float = 24 * 3600.0,
                 deployment_gc_threshold: float = 3600.0,
                 batch_eval_gc_threshold: float = 24 * 3600.0) -> None:
        self.eval_gc_threshold = eval_gc_threshold
        self.job_gc_threshold = job_gc_threshold
        self.node_gc_threshold = node_gc_threshold
        self.deployment_gc_threshold = deployment_gc_threshold
        self.batch_eval_gc_threshold = batch_eval_gc_threshold


class CoreScheduler:
    """Processes `_core` evaluations (scheduler iface, core_sched.go:47)."""

    def __init__(self, server, snapshot=None) -> None:
        # GC mutates live state (delete_*), so collectors read server.state
        # directly; the Planner-protocol snapshot argument is accepted for
        # the worker factory's uniform call shape and unused.
        self.server = server
        self.config: GCConfig = getattr(server.config, "gc", None) or GCConfig()

    def process(self, eval) -> None:
        kind = eval.job_id.split(":", 1)[0]
        if kind == CORE_JOB_EVAL_GC:
            self.eval_gc()
        elif kind == CORE_JOB_JOB_GC:
            self.job_gc()
        elif kind == CORE_JOB_NODE_GC:
            self.node_gc()
        elif kind == CORE_JOB_DEPLOYMENT_GC:
            self.deployment_gc()
        elif kind == CORE_JOB_FORCE_GC:
            self.eval_gc(force=True)
            self.job_gc(force=True)
            self.node_gc(force=True)
            self.deployment_gc(force=True)
        else:
            raise ValueError(f"unknown core job {eval.job_id!r}")

    # ---- threshold helper (core_sched.go getThreshold) ----

    def _cutoff(self, age_s: float, force: bool) -> int:
        if force:
            return self.server.state.index.value + 1
        return self.server.timetable.nearest_index(time.time() - age_s)

    # ---- collectors ----

    def eval_gc(self, force: bool = False) -> int:
        cutoff = self._cutoff(self.config.eval_gc_threshold, force)
        batch_cutoff = self._cutoff(self.config.batch_eval_gc_threshold, force)
        state = self.server.state
        n = 0
        for e in state.evals():
            if e.status not in TERMINAL_EVAL:
                continue
            limit = batch_cutoff if e.type == JOB_TYPE_BATCH else cutoff
            if e.modify_index > limit:
                continue
            allocs = [a for a in state.allocs_by_job(e.namespace, e.job_id)
                      if a.eval_id == e.id]
            if any(not a.terminal_status() or a.modify_index > limit
                   for a in allocs):
                continue
            if e.type == JOB_TYPE_BATCH and not force \
                    and state.job_by_id(e.namespace, e.job_id) is not None:
                continue  # keep reschedule history while the job lives
            for a in allocs:
                state.delete_alloc(a.id)
            state.delete_eval(e.id)
            n += 1
        return n

    def job_gc(self, force: bool = False) -> int:
        cutoff = self._cutoff(self.config.job_gc_threshold, force)
        state = self.server.state
        n = 0
        for job in state.jobs():
            if not job.stopped() and job.status != "dead":
                continue
            if job.is_periodic() and not job.stopped():
                continue
            if job.modify_index > cutoff:
                continue
            evals = state.evals_by_job(job.namespace, job.id)
            allocs = state.allocs_by_job(job.namespace, job.id)
            if any(e.status not in TERMINAL_EVAL for e in evals):
                continue
            if any(not a.terminal_status() for a in allocs):
                continue
            for a in allocs:
                state.delete_alloc(a.id)
            for e in evals:
                state.delete_eval(e.id)
            state.delete_job(job.namespace, job.id)
            n += 1
        return n

    def node_gc(self, force: bool = False) -> int:
        cutoff = self._cutoff(self.config.node_gc_threshold, force)
        state = self.server.state
        n = 0
        for node in state.nodes():
            if node.status != NODE_STATUS_DOWN or node.modify_index > cutoff:
                continue
            if state.allocs_by_node(node.id):
                continue
            state.delete_node(node.id)
            self.server._drop_node_device_stats(node.id)
            self.server._drop_node_identity_lock(node.id)
            n += 1
        return n

    def deployment_gc(self, force: bool = False) -> int:
        cutoff = self._cutoff(self.config.deployment_gc_threshold, force)
        state = self.server.state
        n = 0
        for d in state.deployments():
            if d.status not in TERMINAL_DEPLOYMENT or d.modify_index > cutoff:
                continue
            if any(not a.terminal_status() for a in
                   state.allocs_by_job(d.namespace, d.job_id)
                   if a.deployment_id == d.id):
                continue
            state.delete_deployment(d.id)
            n += 1
        return n
