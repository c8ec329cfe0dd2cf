"""Server-side node TTL heartbeats.

Behavioral reference: `nomad/heartbeat.go` (nodeHeartbeater :34,
resetHeartbeatTimer :90, invalidateHeartbeat :135): one TTL timer per node;
a missed heartbeat marks the node down and triggers node evals (wired by the
server's `on_expire`)."""
from __future__ import annotations

import threading
from typing import Callable, Dict, Optional


class HeartbeatTracker:
    def __init__(self, ttl: float, on_expire: Callable[[str], None]) -> None:
        self.ttl = ttl
        self.on_expire = on_expire
        self._lock = threading.Lock()
        self._timers: Dict[str, threading.Timer] = {}
        self._enabled = False

    def start(self) -> None:
        with self._lock:
            self._enabled = True

    def shutdown(self) -> None:
        with self._lock:
            self._enabled = False
            for t in self._timers.values():
                t.cancel()
            self._timers.clear()

    def reset(self, node_id: str) -> None:
        """(Re)arm the TTL timer for a node (heartbeat.go:90)."""
        with self._lock:
            if not self._enabled:
                return
            old = self._timers.pop(node_id, None)
            if old is not None:
                old.cancel()
            t = threading.Timer(self.ttl, lambda: self._expire(node_id, t))
            t.daemon = True
            self._timers[node_id] = t
            t.start()

    def remove(self, node_id: str) -> None:
        with self._lock:
            old = self._timers.pop(node_id, None)
            if old is not None:
                old.cancel()

    def _expire(self, node_id: str, timer: threading.Timer) -> None:
        with self._lock:
            # Identity check: a reset racing this expiry may have installed a
            # fresh timer under the same node — only the timer that is still
            # registered may declare the node down.
            if not self._enabled or self._timers.get(node_id) is not timer:
                return
            del self._timers[node_id]
        self.on_expire(node_id)
