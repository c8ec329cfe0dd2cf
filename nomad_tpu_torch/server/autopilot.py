"""Autopilot — automatic raft-cluster hygiene on the leader.

Behavioral reference: `nomad/autopilot.go` (promoteNonVoters, the
embedded consul autopilot loop: `vendor/.../autopilot/autopilot.go`
pruneDeadServers) and `nomad/operator_endpoint.go` (ServerHealth,
AutopilotGetConfiguration/SetConfiguration). The reference reacts to serf
member events; here the gossip membership's on_change callback is the
same seam.

Dead-server cleanup: when a same-region server is marked failed/left by
gossip and `cleanup_dead_servers` is on, the leader removes it from the
raft voter set — provided the survivors still form a quorum of the
post-removal configuration (autopilot refuses removals that would lose
quorum; autopilot.go pruneDeadServers' canRemoveServers check).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List

from .gossip import STATUS_ALIVE, STATUS_FAILED, STATUS_LEFT, Member


class Autopilot:
    #: leader reconcile cadence (autopilot.go runs its loop each
    #: ServerHealthInterval)
    RECONCILE_INTERVAL = 2.0

    def __init__(self, cluster) -> None:
        self.cluster = cluster
        #: per-server first-seen-healthy stamps (stabilization window)
        self._healthy_since: Dict[str, float] = {}
        self._stop = threading.Event()
        self._thread = None

    # ---- leader reconcile loop (autopilot.go promote/prune loop) ----
    # Event-driven cleanup alone misses the crashed EX-LEADER: the
    # survivors see the gossip failure while no one is leader yet, drop
    # the event, and gossip never re-fires for an already-failed member.
    # The new leader's periodic sweep is what prunes it.

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="autopilot", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        while not self._stop.wait(self.RECONCILE_INTERVAL):
            if not self.cluster.is_leader():
                continue
            self.reconcile()

    def reconcile(self) -> None:
        for m in self.cluster.membership.members():
            if m.status in (STATUS_FAILED, STATUS_LEFT):
                self._maybe_prune(m)

    # ---- gossip event hook ----

    def member_change(self, member: Member) -> None:
        if member.status not in (STATUS_FAILED, STATUS_LEFT):
            return
        self._maybe_prune(member)

    def _maybe_prune(self, member: Member) -> None:
        cl = self.cluster
        if not cl.is_leader():
            return
        if member.region != cl.config.region:
            return  # WAN members are not in this region's raft
        try:
            if not cl.state.autopilot_config().cleanup_dead_servers:
                return
        except Exception:  # noqa: BLE001 — config read must not throw here
            return
        node_id = member.name.rsplit(".", 1)[0]  # serf name node.region
        peer_map = cl.raft.peers_snapshot()
        if node_id == cl.config.node_id or node_id not in peer_map:
            return
        # quorum guard: voters remaining after removal must have an alive
        # majority among themselves
        remaining = [p for p in peer_map if p != node_id]
        alive = {m.name.rsplit(".", 1)[0]
                 for m in cl.membership.members()
                 if m.status == STATUS_ALIVE
                 and m.region == cl.config.region}
        alive.add(cl.config.node_id)
        alive_remaining = sum(1 for p in remaining if p in alive)
        if alive_remaining < len(remaining) // 2 + 1:
            return
        try:
            cl.raft.remove_peer(node_id)
        except Exception:  # noqa: BLE001 — lost leadership mid-removal etc.
            pass

    # ---- health report (operator_endpoint.go ServerHealth) ----

    def server_health(self) -> dict:
        cl = self.cluster
        cfg = cl.state.autopilot_config()
        now = time.time()
        members = {m.name.rsplit(".", 1)[0]: m
                   for m in cl.membership.members()
                   if m.region == cl.config.region}
        last_index = cl.raft.log.last_index()
        servers: List[dict] = []
        healthy_votes = 0
        peer_map, match_index = cl.raft.peers_snapshot(with_match=True)
        for pid, addr in sorted(peer_map.items()):
            m = members.get(pid)
            if pid == cl.config.node_id:
                alive, last_contact = True, 0.0
            elif m is None:
                alive, last_contact = False, float("inf")
            else:
                alive = m.status == STATUS_ALIVE
                last_contact = now - m.last_seen
            trailing = (last_index - match_index.get(pid, 0)
                        if cl.is_leader() and pid != cl.config.node_id
                        else 0)
            healthy = (alive
                       and last_contact <= cfg.last_contact_threshold_s
                       and trailing <= cfg.max_trailing_logs)
            if healthy:
                self._healthy_since.setdefault(pid, now)
                healthy_votes += 1
            else:
                self._healthy_since.pop(pid, None)
            since = self._healthy_since.get(pid, now)
            servers.append({
                "id": pid,
                "address": f"{addr[0]}:{addr[1]}",
                "leader": pid == (cl.raft.leader() or ""),
                "voter": True,
                "healthy": healthy,
                "stable_since": since,
                # continuously healthy through the stabilization window
                # (the reference promotes non-voters on this signal;
                # surfaced here so operators see which servers would
                # qualify)
                "stable": healthy and (now - since)
                >= cfg.server_stabilization_time_s,
                "last_contact_s": (None if last_contact == float("inf")
                                   else round(last_contact, 3)),
            })
        quorum = len(peer_map) // 2 + 1
        return {
            "healthy": healthy_votes >= quorum,
            "failure_tolerance": max(0, healthy_votes - quorum),
            "servers": servers,
        }
