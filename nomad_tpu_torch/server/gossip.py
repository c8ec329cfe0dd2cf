"""Server membership — the Serf/memberlist analog.

Behavioral reference: `nomad/serf.go` + hashicorp/memberlist (gossip on
port 4648, `nomad/server.go:1363 setupSerf`): servers learn each other
and detect failures without static config. This build rides the existing
msgpack-RPC fabric instead of a UDP gossip port: each member runs an
anti-entropy push-pull (`Gossip.exchange`) against random peers at an
interval, merging member tables by incarnation number; a member that
stops refreshing is marked suspect then failed (memberlist's
suspicion/probe states), and callbacks fire on join/leave — the seam the
reference uses to drive `nodeJoin`/`nodeFailed` peer tracking."""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

STATUS_ALIVE = "alive"
STATUS_SUSPECT = "suspect"
STATUS_FAILED = "failed"
STATUS_LEFT = "left"

#: equal-incarnation conflict order (memberlist: worse news wins)
_PRECEDENCE = {STATUS_ALIVE: 0, STATUS_SUSPECT: 1, STATUS_FAILED: 2,
               STATUS_LEFT: 3}


@dataclass
class Member:
    name: str
    addr: Tuple[str, int]
    status: str = STATUS_ALIVE
    incarnation: int = 0
    last_seen: float = field(default_factory=time.time)
    #: serf-style tags (the reference advertises region/dc/rpc_addr/etc.
    #: through serf member tags; nomad/server.go:1380 setupSerf). The
    #: build uses "region" for WAN federation and "http_addr" for
    #: cross-region HTTP forwarding.
    tags: Dict[str, str] = field(default_factory=dict)

    def wire(self) -> dict:
        return {"name": self.name, "addr": list(self.addr),
                "status": self.status, "incarnation": self.incarnation,
                "tags": dict(self.tags)}

    @property
    def region(self) -> str:
        return self.tags.get("region", "global")


class Membership:
    """Push-pull anti-entropy membership over the RPC fabric."""

    def __init__(self, name: str, addr: Tuple[str, int], pool,
                 interval: float = 1.0, suspect_after: float = 3.0,
                 failed_after: float = 6.0,
                 on_change: Optional[Callable[[Member], None]] = None,
                 tags: Optional[Dict[str, str]] = None) -> None:
        self.name = name
        self.pool = pool
        self.interval = interval
        self.suspect_after = suspect_after
        self.failed_after = failed_after
        self.on_change = on_change
        self._lock = threading.Lock()
        self._members: Dict[str, Member] = {
            name: Member(name, tuple(addr), tags=dict(tags or {}))}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: per-TARGET probe-failure sinks (one shared counter name →
        #: one registry counter, but per-peer first-of-streak state: a
        #: healthy peer's success must not re-arm a dead peer's WARNING)
        self._errs: Dict[str, "ErrorStreak"] = {}

    # ---- RPC surface (registered as "Gossip.exchange") ----

    def exchange(self, from_name: str, remote_table: List[dict]
                 ) -> List[dict]:
        """Merge the caller's member table, return ours (push-pull). The
        caller's own entry is direct liveness evidence — inbound pushes
        refresh it, so an unlucky probe-sample run can't mark an actively
        gossiping peer suspect (memberlist treats any message from a node
        as proof of life)."""
        self._merge(remote_table)
        with self._lock:
            cur = self._members.get(from_name)
            if cur is not None and cur.status != STATUS_LEFT:
                cur.last_seen = time.time()
                cur.status = STATUS_ALIVE
            return [m.wire() for m in self._members.values()]

    def _merge(self, table: List[dict]) -> None:
        changed: List[Member] = []
        now = time.time()
        with self._lock:
            for w in table:
                name = w["name"]
                if name == self.name:
                    # alive-rebuttal (memberlist): a peer claiming we are
                    # suspect/failed is refuted by bumping incarnation
                    me = self._members[self.name]
                    if w.get("status") != STATUS_ALIVE and \
                            w.get("incarnation", 0) >= me.incarnation:
                        me.incarnation = w.get("incarnation", 0) + 1
                    continue
                cur = self._members.get(name)
                inc = int(w.get("incarnation", 0))
                status = w.get("status", STATUS_ALIVE)
                if cur is None:
                    cur = Member(name, tuple(w["addr"]), status, inc, now,
                                 tags=dict(w.get("tags", {}) or {}))
                    self._members[name] = cur
                    if cur.status == STATUS_ALIVE:
                        changed.append(cur)
                    continue
                # memberlist ordering: a higher incarnation wins outright
                # (and is fresh evidence); at EQUAL incarnation only worse
                # news (suspect/failed/left) overrides — relayed "alive"
                # entries must NOT refresh last_seen, or a dead member
                # would be kept alive by peers echoing stale tables
                worse = (_PRECEDENCE[status]
                         > _PRECEDENCE[cur.status])
                if inc > cur.incarnation or (inc == cur.incarnation
                                             and worse):
                    newer = inc > cur.incarnation
                    was = cur.status
                    cur.incarnation = inc
                    cur.status = status
                    cur.addr = tuple(w["addr"])
                    if newer and "tags" in w:
                        # a member that legitimately CLEARS a tag must
                        # propagate: "tags present but empty" is real
                        # news at a newer incarnation, only absence isn't
                        cur.tags = dict(w["tags"] or {})
                    elif w.get("tags"):
                        cur.tags = dict(w["tags"])
                    if status == STATUS_ALIVE and inc > 0:
                        cur.last_seen = now  # rebuttal: direct evidence
                    if cur.status != was:
                        changed.append(cur)
        for m in changed:
            if self.on_change is not None:
                self.on_change(m)

    # ---- probe loop ----

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, name="gossip",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=3.0)

    def leave(self) -> None:
        """Graceful departure (serf Leave): broadcast LEFT before stop.
        Broadcasts fan out in parallel under a short budget so shutdown
        never blocks on unreachable peers."""
        with self._lock:
            me = self._members[self.name]
            me.status = STATUS_LEFT
            me.incarnation += 1
            peers = [m for m in self._members.values()
                     if m.name != self.name and m.status == STATUS_ALIVE]
            table = [m.wire() for m in self._members.values()]

        def notify(addr):
            try:
                self.pool.call(addr, "Gossip.exchange", self.name, table,
                               timeout=1.0)
            except Exception:  # noqa: BLE001 — best-effort broadcast
                pass

        threads = [threading.Thread(target=notify, args=(p.addr,),
                                    daemon=True) for p in peers]
        for t in threads:
            t.start()
        deadline = time.time() + 1.5
        for t in threads:
            t.join(timeout=max(deadline - time.time(), 0.05))
        self.stop()

    def join(self, seeds: List[Tuple[str, int]]) -> bool:
        """Initial join through any live seed (serf retry_join)."""
        for addr in seeds:
            try:
                with self._lock:
                    table = [m.wire() for m in self._members.values()]
                self._merge(self.pool.call(tuple(addr), "Gossip.exchange",
                                           self.name, table, timeout=3.0))
                return True
            except Exception:  # noqa: BLE001 — seed down: try the next
                continue
        return False

    def join_async(self, seeds: List[Tuple[str, int]]) -> None:
        """Background retry-join (serf retry_join is async for the same
        reason: seeds being down must not block server startup)."""
        def run():
            while not self._stop.is_set():
                if self.join(seeds):
                    return
                if self._stop.wait(2.0):
                    return

        threading.Thread(target=run, name="gossip-join",
                         daemon=True).start()

    def _err_for(self, target: str) -> "ErrorStreak":
        """Lazy per-peer streak (only the gossip thread touches the
        map); all instances share one counter name, so the registry
        count stays a single `loop_errors.server.gossip.<me>` total."""
        from ..lib.metrics import ErrorStreak

        es = self._errs.get(target)
        if es is None:
            es = self._errs[target] = ErrorStreak(
                f"server.gossip.{self.name}")
        return es

    def _run(self) -> None:
        round_ = 0
        while not self._stop.wait(self.interval):
            round_ += 1
            with self._lock:
                me = self._members[self.name]
                me.last_seen = time.time()
                peers = [m for m in self._members.values()
                         if m.name != self.name
                         and m.status in (STATUS_ALIVE, STATUS_SUSPECT)]
                failed = [m for m in self._members.values()
                          if m.status == STATUS_FAILED]
                table = [m.wire() for m in self._members.values()]
            targets = random.sample(peers, min(2, len(peers)))
            if failed and round_ % 5 == 0:
                # partition healing: periodically re-probe a failed member
                # so both sides reconnect when the network comes back
                # (memberlist's dead-node gossip + push/pull sync)
                targets.append(random.choice(failed))
            for target in targets:
                try:
                    self._merge(self.pool.call(
                        target.addr, "Gossip.exchange", self.name, table,
                        timeout=2.0))
                    with self._lock:
                        t = self._members.get(target.name)
                        if t is not None and t.status != STATUS_LEFT:
                            t.last_seen = time.time()
                            if t.status != STATUS_ALIVE:
                                t.status = STATUS_ALIVE
                    self._err_for(target.name).ok()
                except Exception as e:  # noqa: BLE001 — probe failure
                    # IS the failure-detector signal (the sweep marks
                    # the peer suspect); counted so a partitioned node
                    # is visible in telemetry, not just by its absence
                    self._err_for(target.name).record(
                        e, f"probe {target.name}")
            if self._stop.is_set():
                return
            self._sweep()

    def _sweep(self) -> None:
        now = time.time()
        changed: List[Member] = []
        with self._lock:
            for m in self._members.values():
                if m.name == self.name or m.status == STATUS_LEFT:
                    continue
                silent = now - m.last_seen
                if m.status == STATUS_ALIVE and silent > self.suspect_after:
                    m.status = STATUS_SUSPECT
                    changed.append(m)
                elif m.status == STATUS_SUSPECT \
                        and silent > self.failed_after:
                    m.status = STATUS_FAILED
                    changed.append(m)
        for m in changed:
            if self.on_change is not None:
                self.on_change(m)

    def members(self) -> List[Member]:
        with self._lock:
            return [Member(m.name, m.addr, m.status, m.incarnation,
                           m.last_seen, dict(m.tags))
                    for m in self._members.values()]

    def force_leave(self, name: str) -> None:
        """Operator override (serf RemoveFailedNode / `server
        force-leave`): mark a FAILED/SUSPECT member LEFT so reaping
        doesn't wait out the failure detector.

        Raises KeyError for an unknown member, ValueError for self or a
        member still ALIVE (serf's RemoveFailedNode likewise applies to
        failed nodes only — an operator typo must not evict a healthy
        voter). The incarnation jumps by a margin so a stale higher
        ALIVE entry held by some peer can't silently revert the LEFT
        mark mid-propagation; a genuinely live node still wins by
        refuting above the jump."""
        with self._lock:
            m = self._members.get(name)
            if m is None:
                raise KeyError(name)
            if m.name == self.name:
                raise ValueError(
                    "cannot force-leave self; shut this server down "
                    "gracefully instead")
            if m.status == STATUS_ALIVE:
                raise ValueError(
                    f"member {name!r} is alive — force-leave applies "
                    "to failed members")
            m.status = STATUS_LEFT
            m.incarnation += 64
            snap = Member(m.name, m.addr, m.status, m.incarnation,
                          m.last_seen, dict(m.tags))
        if self.on_change is not None:
            self.on_change(snap)

    def set_tag(self, key: str, value: str) -> None:
        """Update a local tag and bump incarnation so it propagates
        (serf SetTags re-broadcasts the member with fresh tags)."""
        with self._lock:
            me = self._members[self.name]
            me.tags[key] = value
            me.incarnation += 1
