"""The closed loop that drives a started server, read from a workload file.

One generator for every cell: it keeps `backlog` evals pending, and each
time one reaches a terminal status it submits more, so the scheduler's
worker never runs dry. Occupancy is held level by the workload's
`occupancy` rule, `complete_oldest`: whenever the running allocs exceed
the configuration's `running_allocs`, because a new job's allocs have
landed, the allocs of the oldest job whose registration completed are
reported `complete` through `Server.node_update_allocs`, the client's
path.

Every action is recorded, so the reference can work out what the state
must hold from the inputs alone.
"""
from __future__ import annotations

import copy
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from . import synth
from .spec import JobSpec, Spec

TERMINAL = ("complete", "failed", "cancelled", "blocked")
#: how often the loop looks for evals that reached a terminal status
POLL_S = 0.004


class ClosedLoop:
    def __init__(self, server, spec: Spec,
                 on_done: Optional[Callable[[str, Dict], None]] = None):
        self.s = server
        self.spec = spec
        w = spec.workload
        if w["occupancy"] != "complete_oldest":
            raise ValueError(f"unknown occupancy rule {w['occupancy']!r}")
        self.backlog = int(w["backlog"])
        self.level = int(spec.config["running_allocs"])
        self.on_done = on_done
        self.next_job = 0
        #: eval id -> {"kind", "job"}
        self.pending: Dict[str, Dict] = {}
        #: jobs whose registration completed and that still run, oldest
        #: first
        self.running: deque = deque()
        #: (kind, job index) in the order the loop took them
        self.actions: List[tuple] = []
        #: eval id -> {"kind", "job", "status", "create", "modify"}
        self.done: Dict[str, Dict] = {}
        self.submitting = True

    # ---- submission ----

    def _register(self, js: JobSpec) -> None:
        ev = self.s.job_register(synth.job(js))
        self.actions.append(("register", js.index))
        self.pending[ev.id] = {"kind": "register", "job": js.index}

    def _complete_oldest(self) -> None:
        k = self.running.popleft()
        allocs = self.s.state.allocs_by_job("default", self.spec.job(k).id)
        updates = []
        for a in allocs:
            if not a.terminal_status():
                up = copy.copy(a)
                up.client_status = "complete"
                updates.append(up)
        self.actions.append(("complete", k))
        self.s.node_update_allocs(updates)

    def top_up(self) -> None:
        while self.submitting and len(self.pending) < self.backlog:
            js = self.spec.job(self.next_job)
            self.next_job += 1
            self._register(js)

    def level_off(self) -> None:
        """Complete the oldest running jobs while the running allocs are
        over the level."""
        while self.running and self.live_allocs() > self.level:
            self._complete_oldest()

    # ---- completion ----

    def poll(self) -> int:
        """Move evals that reached a terminal status to `done` and hold
        the level; returns how many evals did."""
        state = self.s.state
        n = 0
        for eid in list(self.pending):
            ev = state.eval_by_id(eid)
            if ev is None or ev.status not in TERMINAL:
                continue
            rec = self.pending.pop(eid)
            rec.update(status=ev.status, create=ev.create_time,
                       modify=ev.modify_time)
            self.done[eid] = rec
            n += 1
            self.running.append(rec["job"])
            if self.on_done is not None:
                self.on_done(eid, rec)
        self.level_off()
        return n

    def run_until(self, stop: Callable[[], bool]) -> None:
        """Keep the backlog full until `stop()` holds."""
        self.top_up()
        while not stop():
            if self.poll():
                self.top_up()
            else:
                time.sleep(POLL_S)

    def drain(self, timeout: float) -> None:
        """Submit nothing more and wait for every pending eval; the
        occupancy rule still holds, so the state ends at its level."""
        self.submitting = False
        deadline = time.monotonic() + timeout
        while self.pending and time.monotonic() < deadline:
            if not self.poll():
                time.sleep(POLL_S)

    def live_allocs(self) -> int:
        """Running allocs in the state: the cluster's occupancy."""
        return len(self.s.state.cluster.alloc_usage)
