"""Wall-clock ↔ state-index mapping used for GC thresholds.

Behavioral reference: `nomad/timetable.go:14` — a bounded witness list of
(index, time) pairs appended at a granularity; `NearestIndex(t)` returns the
largest index recorded at or before `t`, `NearestTime(i)` the inverse. The
core GC scheduler uses it to turn "older than N hours" into an index cutoff.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Tuple


class TimeTable:
    def __init__(self, granularity: float = 300.0, limit: float = 72 * 3600.0):
        # Reference defaults (nomad/server.go): 5-minute granularity,
        # 72h retention → ~864 witnesses; linear scans stay cheap.
        self.granularity = granularity
        self.limit = limit
        self._lock = threading.Lock()
        self._witnesses: deque = deque()  # (index, time), ascending index

    def witness(self, index: int, when: float = None) -> None:
        when = time.time() if when is None else when
        with self._lock:
            if (self._witnesses
                    and when - self._witnesses[-1][1] < self.granularity):
                return
            self._witnesses.append((index, when))
            cutoff = when - self.limit
            while len(self._witnesses) > 1 and self._witnesses[0][1] < cutoff:
                self._witnesses.popleft()

    def nearest_index(self, when: float) -> int:
        """Largest witnessed index at or before `when` (0 if none)."""
        with self._lock:
            best = 0
            for idx, t in self._witnesses:
                if t <= when:
                    best = idx
                else:
                    break
            return best

    def nearest_time(self, index: int) -> float:
        """Time of the largest witnessed index at or before `index`
        (0.0 if none) — the inverse of `nearest_index`, matching the
        reference's NearestTime."""
        with self._lock:
            best = 0.0
            for idx, t in self._witnesses:
                if idx <= index:
                    best = t
                else:
                    break
            return best
