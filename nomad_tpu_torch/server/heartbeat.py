"""Server-side node TTL heartbeats.

Behavioral reference: `nomad/heartbeat.go` (nodeHeartbeater :34,
resetHeartbeatTimer :90, invalidateHeartbeat :135): one TTL timer per node;
a missed heartbeat marks the node down and triggers node evals (wired by the
server's `on_expire`).

Every node's timer lives in one deadline heap (`lib/delayheap.py`) served
by one thread, where the reference starts a `threading.Timer` thread a
node: a server that starts over a restored state arms a timer for every
node, and a process on the card's machine is killed past about 4,000
threads, so a Server restoring 10,000 nodes could not start there.
"""
from __future__ import annotations

import threading
import time
import traceback
from typing import Callable, Optional

from ..lib.delayheap import DelayHeap


class HeartbeatTracker:
    def __init__(self, ttl: float, on_expire: Callable[[str], None]) -> None:
        self.ttl = ttl
        self.on_expire = on_expire
        self._cv = threading.Condition()
        self._deadlines = DelayHeap()
        self._enabled = False
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        with self._cv:
            self._enabled = True
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="heartbeat-ttl", daemon=True)
                self._thread.start()

    def shutdown(self) -> None:
        with self._cv:
            self._enabled = False
            self._deadlines = DelayHeap()
            thread, self._thread = self._thread, None
            self._cv.notify_all()
        if thread is not None and thread is not threading.current_thread():
            thread.join()

    def reset(self, node_id: str) -> None:
        """(Re)arm the TTL timer for a node (heartbeat.go:90)."""
        with self._cv:
            if not self._enabled:
                return
            deadline = time.monotonic() + self.ttl
            if not self._deadlines.update(node_id, deadline):
                self._deadlines.push(node_id, deadline)
            # the thread sleeps until the earliest deadline: wake it when
            # this one is earlier
            if self._deadlines.peek().key == node_id:
                self._cv.notify_all()

    def remove(self, node_id: str) -> None:
        with self._cv:
            self._deadlines.remove(node_id)

    def _run(self) -> None:
        while True:
            with self._cv:
                while True:
                    if not self._enabled:
                        return
                    first = self._deadlines.peek()
                    now = time.monotonic()
                    if first is not None and first.wait_until <= now:
                        break
                    self._cv.wait(None if first is None
                                  else first.wait_until - now)
                # popped under the lock: a reset racing an expiry either
                # re-armed the node first (not due) or finds it gone and
                # arms it afresh, as the reference's identity check does
                due = self._deadlines.pop_expired(now)
            for item in due:
                try:
                    self.on_expire(item.key)
                except Exception:  # noqa: BLE001 — one node's expiry
                    # must not stop the others' timers
                    traceback.print_exc()
