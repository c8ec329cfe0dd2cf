"""Event broker — real pub/sub over state transitions.

Behavioral reference: `nomad/event/event.go` is a STUB in the reference
snapshot (`EventPublisher.Publish` is a no-op, event.go:12-13; the full
event stream landed in later versions). This build implements the real
thing the stub reserved space for: topic-filtered events with a bounded
ring buffer and index-based long-polling (the /v1/event/stream shape).

Topics: Job, Eval, Alloc, Node, Deployment. Every event carries the
state index that produced it, the topic, an event type, and the payload
key (id) — payload bodies are fetched by key to keep the ring small.
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

TOPIC_JOB = "Job"
TOPIC_EVAL = "Eval"
TOPIC_ALLOC = "Alloc"
TOPIC_NODE = "Node"
TOPIC_DEPLOYMENT = "Deployment"
ALL_TOPICS = (TOPIC_JOB, TOPIC_EVAL, TOPIC_ALLOC, TOPIC_NODE,
              TOPIC_DEPLOYMENT)


@dataclass
class Event:
    topic: str = ""
    type: str = ""       # e.g. "JobRegistered", "NodeDown", "AllocUpdated"
    key: str = ""        # resource id
    namespace: str = ""
    index: int = 0
    payload: dict = field(default_factory=dict)


class EventBroker:
    def __init__(self, size: int = 4096) -> None:
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._ring: deque = deque(maxlen=size)
        self._last_index = 0

    def publish(self, event: Event) -> None:
        with self._cv:
            if event.index <= 0:
                event.index = self._last_index + 1
            self._last_index = max(self._last_index, event.index)
            self._ring.append(event)
            self._cv.notify_all()

    def events_after(self, index: int, topics: Optional[List[str]] = None,
                     timeout: float = 0.0) -> Tuple[int, List[Event]]:
        """Events with index > `index`, topic-filtered; blocks up to
        `timeout` when none are ready (the long-poll half of
        /v1/event/stream)."""
        import time

        deadline = time.time() + timeout
        tset = set(topics) if topics else None
        while True:
            with self._cv:
                out = [e for e in self._ring
                       if e.index > index
                       and (tset is None or e.topic in tset)]
                if out or timeout <= 0:
                    return self._last_index, out
                remaining = deadline - time.time()
                if remaining <= 0:
                    return self._last_index, []
                self._cv.wait(min(remaining, 1.0))

    def last_index(self) -> int:
        with self._lock:
            return self._last_index
