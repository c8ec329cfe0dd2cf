"""Time-ordered heap of uniquely-named waiters.

Behavioral reference: `lib/delayheap/delay_heap.go` — a heap keyed by
`WaitUntil` with O(1) containment by (id, namespace) and in-place update.
The eval broker's delayed-eval watcher (`nomad/eval_broker.go:751`) and the
drainer's deadline notifier (`nomad/drainer/drain_heap.go`) both consume it.
"""
from __future__ import annotations

import heapq
import threading
from typing import Any, Dict, List, Optional, Tuple


class WaitItem:
    __slots__ = ("key", "wait_until", "data")

    def __init__(self, key: str, wait_until: float, data: Any = None) -> None:
        self.key = key
        self.wait_until = wait_until
        self.data = data


class DelayHeap:
    """Min-heap on wait_until with keyed update/remove (lazy deletion).

    Thread-safe. `pop_expired(now)` returns every item due at or before
    `now`; `peek()` returns the earliest live item without removing it.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._heap: List[Tuple[float, int, WaitItem]] = []
        self._live: Dict[str, WaitItem] = {}
        self._seq = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._live)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._live

    def push(self, key: str, wait_until: float, data: Any = None) -> bool:
        """Insert; returns False if the key is already present (ref
        delay_heap.go Push returns an error on duplicates)."""
        with self._lock:
            if key in self._live:
                return False
            item = WaitItem(key, wait_until, data)
            self._live[key] = item
            self._seq += 1
            heapq.heappush(self._heap, (wait_until, self._seq, item))
            return True

    def update(self, key: str, wait_until: float, data: Any = None) -> bool:
        """Re-schedule an existing key (ref delay_heap.go Update)."""
        with self._lock:
            if key not in self._live:
                return False
            item = WaitItem(key, wait_until,
                            self._live[key].data if data is None else data)
            self._live[key] = item
            self._seq += 1
            heapq.heappush(self._heap, (wait_until, self._seq, item))
            return True

    def remove(self, key: str) -> bool:
        with self._lock:
            return self._live.pop(key, None) is not None

    def peek(self) -> Optional[WaitItem]:
        with self._lock:
            return self._peek_locked()

    def _peek_locked(self) -> Optional[WaitItem]:
        while self._heap:
            _, _, item = self._heap[0]
            if self._live.get(item.key) is item:
                return item
            heapq.heappop(self._heap)  # stale (removed or updated) entry
        return None

    def pop_expired(self, now: float) -> List[WaitItem]:
        out: List[WaitItem] = []
        with self._lock:
            while True:
                item = self._peek_locked()
                if item is None or item.wait_until > now:
                    break
                heapq.heappop(self._heap)
                del self._live[item.key]
                out.append(item)
        return out
