"""PeriodicDispatch — cron-style launcher for periodic jobs (leader-only).

Behavioral reference: `nomad/periodic.go` (PeriodicDispatch :22, Add :208,
run :335, dispatch :360) with `gorhill/cronexpr` for schedule evaluation.
Child jobs are named `<parent>/periodic-<launch-unix>` (reference
`structs.PeriodicLaunchSuffix`); `prohibit_overlap` skips a launch while a
previous child is still non-terminal (periodic.go:373 shouldRun check).

The cron evaluator here is a self-contained 5-field implementation
(minute hour day-of-month month day-of-week; `*`, `*/step`, ranges, lists)
— day-level scanning with O(1) in-day resolution, no minute-by-minute walk.
"""
from __future__ import annotations

import calendar
import copy
import threading
import time
from datetime import datetime, timedelta, timezone
from typing import Dict, List, Optional, Set, Tuple

from ..lib import DelayHeap
from ..structs import Evaluation, Job
from ..structs.evaluation import EVAL_STATUS_PENDING, TRIGGER_PERIODIC_JOB

PERIODIC_LAUNCH_SUFFIX = "/periodic-"


class CronExpr:
    """A parsed 5-field cron expression."""

    # dow admits 7 as the Sunday alias (normalized to 0 after parse),
    # matching standard cron and gorhill/cronexpr.
    FIELD_RANGES = ((0, 59), (0, 23), (1, 31), (1, 12), (0, 7))

    def __init__(self, minutes: Set[int], hours: Set[int], doms: Set[int],
                 months: Set[int], dows: Set[int],
                 dom_star: bool, dow_star: bool) -> None:
        self.minutes = sorted(minutes)
        self.hours = sorted(hours)
        self.doms = doms
        self.months = months
        self.dows = dows
        self.dom_star = dom_star
        self.dow_star = dow_star

    @classmethod
    def parse(cls, spec: str) -> "CronExpr":
        fields = spec.split()
        if len(fields) != 5:
            raise ValueError(f"cron spec needs 5 fields, got {spec!r}")
        sets, stars = [], []
        for raw, (lo, hi) in zip(fields, cls.FIELD_RANGES):
            vals: Set[int] = set()
            star = raw == "*"
            for part in raw.split(","):
                step = 1
                if "/" in part:
                    part, step_s = part.split("/", 1)
                    step = int(step_s)
                    if step < 1:
                        raise ValueError(f"bad step in {spec!r}")
                if part in ("*", ""):
                    a, b = lo, hi
                else:
                    if "-" in part:
                        a_s, b_s = part.split("-", 1)
                        a, b = int(a_s), int(b_s)
                    else:
                        a = b = int(part)
                    if a < lo or b > hi or a > b:
                        raise ValueError(f"field {part!r} out of range in {spec!r}")
                vals.update(range(a, b + 1, step))
            sets.append(vals)
            stars.append(star)
        if 7 in sets[4]:
            sets[4].discard(7)
            sets[4].add(0)
        return cls(sets[0], sets[1], sets[2], sets[3], sets[4],
                   dom_star=stars[2], dow_star=stars[4])

    def _day_matches(self, d: datetime) -> bool:
        if d.month not in self.months:
            return False
        dom_ok = d.day in self.doms
        # Python weekday(): Mon=0..Sun=6; cron: Sun=0..Sat=6
        cron_dow = (d.weekday() + 1) % 7
        dow_ok = cron_dow in self.dows
        # Standard cron OR-rule when both dom and dow are restricted
        if not self.dom_star and not self.dow_star:
            return dom_ok or dow_ok
        return dom_ok and dow_ok

    def next_after(self, ts: float, tz=timezone.utc) -> Optional[float]:
        """Earliest firing strictly after `ts` (None if none within ~5y)."""
        dt = datetime.fromtimestamp(ts, tz)
        # advance to the next whole minute
        dt = (dt + timedelta(minutes=1)).replace(second=0, microsecond=0)
        day = dt.date()
        for _ in range(366 * 5):
            d0 = datetime(day.year, day.month, day.day, tzinfo=tz)
            if self._day_matches(d0):
                start_h = dt.hour if day == dt.date() else 0
                for h in self.hours:
                    if h < start_h:
                        continue
                    start_m = dt.minute if (day == dt.date() and h == dt.hour) else 0
                    for m in self.minutes:
                        if h == start_h and day == dt.date() and m < start_m:
                            continue
                        return d0.replace(hour=h, minute=m).timestamp()
            day = day + timedelta(days=1)
        return None


def _tzinfo(name: str):
    if name in ("", "UTC", "utc"):
        return timezone.utc
    try:
        from zoneinfo import ZoneInfo

        return ZoneInfo(name)
    except Exception:
        return timezone.utc


class PeriodicDispatch:
    """Tracks periodic jobs and creates child jobs + evals at fire time."""

    def __init__(self, server) -> None:
        self.server = server
        self._lock = threading.Lock()
        self._tracked: Dict[Tuple[str, str], Job] = {}
        self._heap = DelayHeap()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._wake = threading.Event()

    # ---- lifecycle ----

    def start(self) -> None:
        self._stop.clear()
        # Restore tracked jobs from state (reference leader.go
        # restorePeriodicDispatcher :395).
        for job in self.server.state.jobs():
            if job.is_periodic() and not job.stopped():
                self.add(job)
        self._thread = threading.Thread(target=self._run, name="periodic",
                                        daemon=True)
        self._thread.start()

    def shutdown(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    # ---- tracking API (periodic.go Add :208 / Remove :282) ----

    def add(self, job: Job) -> None:
        key = (job.namespace, job.id)
        with self._lock:
            if not job.is_periodic() or job.stopped() \
                    or not job.periodic.enabled:
                self._tracked.pop(key, None)
                self._heap.remove(self._hkey(key))
                return
            self._tracked[key] = job
            nxt = self.next_launch(job)
            if nxt is None:
                self._heap.remove(self._hkey(key))
            elif not self._heap.push(self._hkey(key), nxt, key):
                self._heap.update(self._hkey(key), nxt, key)
        self._wake.set()

    def remove(self, namespace: str, job_id: str) -> None:
        key = (namespace, job_id)
        with self._lock:
            self._tracked.pop(key, None)
            self._heap.remove(self._hkey(key))

    @staticmethod
    def _hkey(key: Tuple[str, str]) -> str:
        return f"{key[0]}\x00{key[1]}"

    def tracked(self) -> List[Job]:
        with self._lock:
            return list(self._tracked.values())

    def next_launch(self, job: Job, after: Optional[float] = None) -> Optional[float]:
        p = job.periodic
        if p.spec_type != "cron":
            return None
        expr = CronExpr.parse(p.spec)
        return expr.next_after(time.time() if after is None else after,
                               tz=_tzinfo(p.time_zone))

    # ---- firing ----

    def _run(self) -> None:
        while not self._stop.is_set():
            # every _heap touch holds _lock: add()/remove() mutate it
            # from API threads (NLT01 — one-sided locking is still a
            # race); expired items are drained under the lock, then
            # dispatched outside it (dispatch_time re-acquires)
            with self._lock:
                head = self._heap.peek()
            wait = 0.5 if head is None else \
                max(min(head.wait_until - time.time(), 0.5), 0.01)
            self._wake.wait(wait)
            self._wake.clear()
            if self._stop.is_set():
                return
            with self._lock:
                expired = list(self._heap.pop_expired(time.time()))
            for item in expired:
                key = item.data
                try:
                    self.dispatch_time(key, item.wait_until)
                except Exception:
                    import traceback

                    traceback.print_exc()
                with self._lock:
                    job = self._tracked.get(key)
                    if job is not None:
                        nxt = self.next_launch(job, after=item.wait_until)
                        if nxt is not None:
                            self._heap.push(self._hkey(key), nxt, key)

    def dispatch_time(self, key: Tuple[str, str], launch: float
                      ) -> Optional[Evaluation]:
        """Create the child job + eval (periodic.go dispatch :360)."""
        with self._lock:
            job = self._tracked.get(key)
        if job is None:
            return None
        if job.periodic.prohibit_overlap and self._child_running(job):
            return None
        child = self.derive_child(job, launch)
        return self.server.job_register(child)

    def force(self, namespace: str, job_id: str) -> Optional[Evaluation]:
        """`nomad job periodic force` (Periodic.Force RPC)."""
        return self.dispatch_time((namespace, job_id), time.time())

    def derive_child(self, job: Job, launch: float) -> Job:
        child = copy.deepcopy(job)
        child.id = f"{job.id}{PERIODIC_LAUNCH_SUFFIX}{int(launch)}"
        child.name = child.id
        child.parent_id = job.id
        child.periodic = None
        child.status = ""
        child.version = 0
        child.create_index = child.modify_index = child.job_modify_index = 0
        return child

    def _child_running(self, job: Job) -> bool:
        prefix = f"{job.id}{PERIODIC_LAUNCH_SUFFIX}"
        state = self.server.state
        for child in state.jobs():
            if child.namespace != job.namespace \
                    or not child.id.startswith(prefix) or child.stopped():
                continue
            for a in state.allocs_by_job(child.namespace, child.id):
                if not a.terminal_status():
                    return True
            for e in state.evals_by_job(child.namespace, child.id):
                if e.status in ("pending", "blocked"):
                    return True
        return False
