"""BlockedEvals — evals that failed placement, waiting for capacity.

Behavioral reference: `nomad/blocked_evals.go` (:33, Block :166, Unblock
:418, UnblockNode :501, missedUnblock :316) and the system-scheduler variant
(`blocked_evals_system.go`):

- one blocked eval per job (duplicates are surfaced for cancellation)
- unblock keyed by computed node class: an eval is re-enqueued when capacity
  changes on a class it was (or might be) eligible for; evals that escaped
  computed-class tracking unblock on any change
- system evals block per node and unblock only on that node's updates
- `missed_unblock`: capacity events between snapshot and Block are not lost
  (the unblock index is tracked per class)
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from ..structs import Evaluation
from ..structs.evaluation import EVAL_STATUS_PENDING

from .broker import EvalBroker


class BlockedEvals:
    def __init__(self, broker: EvalBroker, registry=None) -> None:
        self.broker = broker
        #: optional MetricsRegistry: blocked-by-dimension counters land
        #: in `scheduler.blocked.<dim>` (the monotonic companions to the
        #: live dimension_stats() view)
        self.registry = registry
        self._lock = threading.Lock()
        self._enabled = False
        # eval id -> eval (with class_eligibility captured)
        self._captured: Dict[str, Evaluation] = {}
        self._escaped: Dict[str, Evaluation] = {}
        # (namespace, job) -> blocked eval id (dedup)
        self._jobs: Dict[Tuple[str, str], str] = {}
        # node id -> {eval id} for system evals
        self._system_by_node: Dict[str, Dict[str, Evaluation]] = {}
        # computed class -> last unblock index (missedUnblock support)
        self._unblock_indexes: Dict[str, int] = {}
        # node id -> last unblock index (system-eval missedUnblock)
        self._node_unblock_indexes: Dict[str, int] = {}
        self._duplicates: List[Evaluation] = []
        self.stats = {"blocked": 0, "escaped": 0, "unblocked": 0}

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            self._enabled = enabled
            if not enabled:
                self._captured.clear()
                self._escaped.clear()
                self._jobs.clear()
                self._system_by_node.clear()
                self._duplicates.clear()

    # ---- block ----

    def block(self, eval: Evaluation) -> None:
        with self._lock:
            if not self._enabled:
                return
            # count the blocked ATTEMPT's exhausted dimensions up front:
            # every later path (missed-unblock requeue, system evals,
            # capture) represents an eval that DID block on these
            # dimensions, and the monotonic counters must not depend on
            # which branch returns first (dimension_stats() stays the
            # live currently-blocked view)
            if self.registry is not None:
                for dim, n in _eval_dimensions(eval).items():
                    self.registry.inc(f"scheduler.blocked.{dim}", n)
            jk = (eval.namespace, eval.job_id)
            existing = self._jobs.get(jk)
            if existing is not None and existing != eval.id:
                # Duplicate blocked eval for the job: keep the newer, surface
                # the older for cancellation (blocked_evals.go:203).
                old = self._captured.pop(existing, None) or self._escaped.pop(
                    existing, None
                )
                if old is not None:
                    if old.node_id and old.node_id in self._system_by_node:
                        self._system_by_node[old.node_id].pop(existing, None)
                        if not self._system_by_node[old.node_id]:
                            del self._system_by_node[old.node_id]
                    self._duplicates.append(old)
            self._jobs[jk] = eval.id

            if eval.type == "system" and eval.node_id:
                # missedUnblock for system evals: a capacity event on this
                # node between the eval's snapshot and now must requeue
                # immediately (blocked_evals_system.go semantics).
                if self._node_unblock_indexes.get(eval.node_id, 0) > \
                        eval.snapshot_index:
                    self._requeue_locked([eval])
                    return
                self._system_by_node.setdefault(eval.node_id, {})[eval.id] = eval
                self._captured[eval.id] = eval
                self.stats["blocked"] += 1
                return

            # missedUnblock (blocked_evals.go:316): if any class this eval is
            # eligible for (or unknown) saw an unblock after the eval's
            # snapshot, requeue immediately instead of blocking.
            if self._missed_unblock_locked(eval):
                self._requeue_locked([eval])
                return

            if eval.escaped_computed_class:
                self._escaped[eval.id] = eval
                self.stats["escaped"] += 1
            else:
                self._captured[eval.id] = eval
            self.stats["blocked"] += 1

    def _missed_unblock_locked(self, eval: Evaluation) -> bool:
        for cls, idx in self._unblock_indexes.items():
            if idx <= eval.snapshot_index:
                continue
            elig = eval.class_eligibility.get(cls)
            if elig is None or elig:
                return True
        return False

    # ---- unblock ----

    def unblock(self, computed_class: str, index: int) -> None:
        """Capacity changed on a node of `computed_class` (blocked_evals.go:418)."""
        with self._lock:
            if not self._enabled:
                return
            self._unblock_indexes[computed_class] = index
            unblock: List[Evaluation] = list(self._escaped.values())
            self._escaped.clear()
            keep: Dict[str, Evaluation] = {}
            for eid, ev in self._captured.items():
                if ev.type == "system":
                    keep[eid] = ev
                    continue
                elig = ev.class_eligibility.get(computed_class)
                if elig is None or elig:
                    unblock.append(ev)
                else:
                    keep[eid] = ev
            self._captured = keep
            self._requeue_locked(unblock)

    def unblock_node(self, node_id: str, index: int) -> None:
        """System evals blocked on a node (blocked_evals_system.go)."""
        with self._lock:
            if not self._enabled:
                return
            self._node_unblock_indexes[node_id] = index
            evals = self._system_by_node.pop(node_id, None)
            if not evals:
                return
            for eid in evals:
                self._captured.pop(eid, None)
            self._requeue_locked(list(evals.values()))

    def unblock_failed(self) -> None:
        """Periodic retry of quota-failed evals — not yet tracked separately."""

    def _requeue_locked(self, evals: List[Evaluation]) -> None:
        for ev in evals:
            # Only clear the per-job dedup slot if it still points at this
            # eval — a newer blocked eval may own the key now.
            jk = (ev.namespace, ev.job_id)
            if self._jobs.get(jk) == ev.id:
                del self._jobs[jk]
            requeued = Evaluation(**{**ev.__dict__})
            requeued.status = EVAL_STATUS_PENDING
            requeued.status_description = ""
            requeued.modify_time = time.time()
            self.broker.enqueue(requeued)
            self.stats["unblocked"] += 1

    # ---- introspection ----

    def duplicates(self) -> List[Evaluation]:
        """Drain evals superseded by newer blocked evals (for cancellation)."""
        with self._lock:
            out, self._duplicates = self._duplicates, []
            return out

    def blocked_count(self) -> int:
        with self._lock:
            return len(self._captured) + len(self._escaped)

    def dimension_stats(self) -> Dict[str, int]:
        """LIVE exhausted-dimension view over currently-blocked evals
        (kernel-native attribution carried on the blocked eval's
        failed_tg_allocs — scheduler/generic.py _create_blocked_eval):
        'what is the cluster short of right now'. Unblocked evals drop
        out automatically because this recomputes from the live maps."""
        with self._lock:
            evals = list(self._captured.values()) \
                + list(self._escaped.values())
        out: Dict[str, int] = {}
        for ev in evals:
            for dim, n in _eval_dimensions(ev).items():
                out[dim] = out.get(dim, 0) + n
        return out


def _eval_dimensions(eval: Evaluation) -> Dict[str, int]:
    """Exhausted-dimension counts across an eval's failed task groups."""
    out: Dict[str, int] = {}
    for m in (eval.failed_tg_allocs or {}).values():
        for dim, n in getattr(m, "dimension_exhausted", {}).items():
            out[dim] = out.get(dim, 0) + int(n)
    return out
