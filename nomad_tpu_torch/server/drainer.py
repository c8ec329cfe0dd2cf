"""NodeDrainer — orchestrates `node drain`: migrate allocs off draining
nodes batch-wise, honor deadlines, mark drains complete.

Behavioral reference: `nomad/drainer/` —
- `drainer.go:29-60` (NodeDrainer wiring: node watcher, job watcher,
  deadline notifier, raft applier shims);
- `watch_nodes.go` (a node is done when no more allocs need migrating →
  clear DrainStrategy, keep SchedulingEligibility=ineligible);
- `watch_jobs.go` (per-job migration batching: at most
  `migrate.max_parallel` allocs of a job in flight across draining nodes;
  batch jobs are left to complete until the deadline; system jobs drain
  only at the deadline and never when `ignore_system_jobs`);
- `drain_heap.go` (deadline coalescing via the delay heap).

Mechanism: allocs are marked `DesiredTransition{Migrate: true}` and a
node-drain eval is created per job; the reconciler turns the migrate set
into stop+place (reconcile_util.go:211 filterByTainted), exactly as the
reference does. This watcher is a poll loop over the state store rather
than a per-node goroutine fan-out — the store is process-local here, and
the TPU build batches migrate marking across all draining nodes per tick.
"""
from __future__ import annotations

import copy
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from ..lib import DelayHeap
from ..structs import Allocation, Evaluation, Node
from ..structs.evaluation import EVAL_STATUS_PENDING, TRIGGER_NODE_DRAIN
from ..structs.job import JOB_TYPE_BATCH, JOB_TYPE_SERVICE, JOB_TYPE_SYSTEM

DEFAULT_POLL_INTERVAL = 0.1
# migrate{} stanza default (reference structs.DefaultMigrateStrategy,
# structs.go:5098): max_parallel = 1.
DEFAULT_MAX_PARALLEL = 1


class NodeDrainer:
    def __init__(self, server, poll_interval: float = DEFAULT_POLL_INTERVAL):
        self.server = server
        self.poll_interval = poll_interval
        # guards _deadlines: update() mutates it from API threads while
        # the watcher loop pops expired entries (NLT01)
        self._lock = threading.Lock()
        self._deadlines = DelayHeap()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._wake = threading.Event()

    # ---- lifecycle ----

    def start(self) -> None:
        self._stop.clear()
        # Restore draining nodes after restart/leader transition
        # (reference drainer.go SetEnabled → watcher re-registration).
        for node in self.server.state.nodes():
            if node.drain is not None:
                self._track(node)
        self._thread = threading.Thread(target=self._run, name="drainer",
                                        daemon=True)
        self._thread.start()

    def shutdown(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    # ---- API (called by Node.UpdateDrain endpoint) ----

    def update(self, node: Node) -> None:
        """Node began or ended draining (reference NodeDrainer.Update)."""
        if node.drain is None:
            with self._lock:
                self._deadlines.remove(node.id)
        else:
            self._track(node)
        self._wake.set()

    def _track(self, node: Node) -> None:
        d = node.drain
        if d.deadline_s > 0 and not d.force_deadline_unix:
            d.force_deadline_unix = time.time() + d.deadline_s
        if d.force_deadline_unix:
            with self._lock:
                if not self._deadlines.push(node.id, d.force_deadline_unix):
                    self._deadlines.update(node.id, d.force_deadline_unix)

    # ---- watcher loop ----

    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.poll_interval)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self.tick()
            except Exception:  # never kill the watcher; next tick retries
                import traceback

                traceback.print_exc()

    def tick(self, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        state = self.server.state
        with self._lock:
            forced: Set[str] = {
                i.key for i in self._deadlines.pop_expired(now)}
        draining = [n for n in state.nodes() if n.drain is not None]
        if not draining:
            return

        # Per-job in-flight migration counts across ALL draining nodes
        # (watch_jobs.go handleJob: batching is a job-level property). A
        # migration stays in flight until the CLIENT has actually stopped the
        # workload — desired_status=stop alone means the reconciler reacted,
        # not that the task exited — so the max_parallel slot is held until
        # the client acks (watch_jobs.go waits on client-terminal status).
        in_flight: Dict[Tuple[str, str], int] = {}
        for node in draining:
            for a in state.allocs_by_node(node.id):
                if a.desired_transition.should_migrate() \
                        and not a.client_terminal_status():
                    key = (a.namespace, a.job_id)
                    in_flight[key] = in_flight.get(key, 0) + 1

        for node in draining:
            force = (node.id in forced
                     or (node.drain.deadline_s < 0)
                     or (node.drain.force_deadline_unix
                         and node.drain.force_deadline_unix <= now))
            self._drain_node(node, bool(force), in_flight)

    def _drain_node(self, node: Node, force: bool,
                    in_flight: Dict[Tuple[str, str], int]) -> None:
        state = self.server.state
        ignore_system = node.drain.ignore_system_jobs
        remaining: List[Allocation] = []
        to_mark: List[Allocation] = []
        touched_jobs: Dict[Tuple[str, str], object] = {}

        for a in state.allocs_by_node(node.id):
            if a.client_terminal_status():
                continue
            if a.terminal_status() and a.client_status == "pending":
                # Stopped before the client ever started it — nothing runs.
                continue
            job = a.job or state.job_by_id(a.namespace, a.job_id)
            jtype = job.type if job is not None else JOB_TYPE_SERVICE
            if jtype == JOB_TYPE_SYSTEM:
                # System allocs go last: only at the deadline, and never
                # when ignore_system_jobs (watch_nodes.go).
                if ignore_system:
                    continue
                remaining.append(a)
                if force and not a.desired_transition.should_migrate():
                    to_mark.append(a)
                    touched_jobs[(a.namespace, a.job_id)] = job
                continue
            remaining.append(a)
            if a.desired_transition.should_migrate():
                continue
            if jtype == JOB_TYPE_BATCH and not force:
                # Batch allocs run to completion until the deadline
                # (watch_jobs.go handleTaskGroup: batch is deadline-only).
                continue
            key = (a.namespace, a.job_id)
            limit = self._max_parallel(job, a.task_group)
            if not force and in_flight.get(key, 0) >= limit:
                continue
            in_flight[key] = in_flight.get(key, 0) + 1
            to_mark.append(a)
            touched_jobs[key] = job

        for a in to_mark:
            updated = copy.copy(a)
            updated.desired_transition = copy.copy(a.desired_transition)
            updated.desired_transition.migrate = True
            state.upsert_alloc(updated)
        for (ns, job_id), job in touched_jobs.items():
            if job is None:
                continue
            self.server._create_eval(
                namespace=ns,
                priority=job.priority,
                type=job.type,
                triggered_by=TRIGGER_NODE_DRAIN,
                job_id=job_id,
                node_id=node.id,
                status=EVAL_STATUS_PENDING,
            )

        if not remaining:
            self._complete(node)

    @staticmethod
    def _max_parallel(job, tg_name: str) -> int:
        if job is None:
            return DEFAULT_MAX_PARALLEL
        tg = job.lookup_task_group(tg_name)
        ms = tg.migrate_strategy if tg is not None else None
        if ms is None or ms.max_parallel <= 0:
            return DEFAULT_MAX_PARALLEL
        return ms.max_parallel

    def _complete(self, node: Node) -> None:
        """All allocs drained → clear the strategy, stay ineligible
        (watch_nodes.go handleDoneNode)."""
        state = self.server.state
        updated = copy.copy(state.node_by_id(node.id))
        updated.drain = None
        updated.scheduling_eligibility = "ineligible"
        state.upsert_node(updated)
        with self._lock:
            self._deadlines.remove(node.id)
