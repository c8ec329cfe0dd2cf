"""Multi-server control plane: Raft-replicated state + leader forwarding.

Behavioral reference: `nomad/server.go` (setupRaft :1198, setupRPC :1068),
`nomad/leader.go` (monitorLeadership/establishLeadership :222 —
broker/plan-queue/watchers enabled on the leader only, revoked on loss),
`nomad/rpc.go` forward() — follower endpoints forward writes to the leader.

Pieces:
- `RaftStateStore` — the StateStore whose write API routes every mutation
  through `RaftNode.apply`; the committed entry fires the FSM on EVERY
  server (leader included), which performs the actual mutation through the
  direct (non-routing) mutators. A leader write blocks until the entry is
  committed and locally applied, so read-your-writes holds on the leader
  exactly as the reference's raftApply does.
- `ClusterServer` — one agent: RpcServer (one port for Raft + forwarded
  endpoint RPCs, like the reference's multiplexed 4647), ConnPool, Server
  wired on a RaftStateStore, RaftNode, and leadership-gated subsystems.

Reads are local and may be stale on followers (the reference's default
consistency for scheduling snapshots); writes on non-leaders raise and the
endpoint wrapper forwards them.

The port's ClusterServer places on `device` (`ClusterServer(config,
peers=None, device=None)`: None means the card, and a missing card raises
before any socket opens; `device="cpu"` runs the plain versions). Every
Server it builds, at start and on leadership regain, places there.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..device import DeviceLike, resolve_device
from ..raft import NotLeaderError, RaftNode
from ..rpc import ConnPool, RpcError, RpcServer
from ..structs.codec import from_wire, to_wire
from .fsm import ALLOWED_OPS, FSM
from .server import Server, ServerConfig
from .state import StateStore
from .wal import _encode_args


class NoRegionPathError(Exception):
    """No known alive server in the requested region (the reference's
    structs.ErrNoRegionPath, nomad/rpc.go:282 forwardRegion)."""

    def __init__(self, region: str) -> None:
        super().__init__(f"no path to region {region!r}")
        self.region = region


class _DirectView:
    """Unrouted mutator access for the FSM applier (the fsm.go Apply path
    writes straight to memdb, never back through raftApply). Marks the
    calling thread as in-FSM-apply so NESTED mutator calls made by the
    store itself (upsert_plan_results → self.upsert_alloc) also go direct
    instead of re-entering raft — which would self-deadlock the applier."""

    def __init__(self, store: "RaftStateStore") -> None:
        self._store = store

    def __getattr__(self, name: str):
        fn = getattr(StateStore, name, None)
        if fn is None:
            raise AttributeError(name)
        store = self._store

        def call(*args):
            prev = getattr(store._local, "direct", False)
            store._local.direct = True
            try:
                return fn(store, *args)
            finally:
                store._local.direct = prev

        call.__name__ = name
        return call


class RaftStateStore(StateStore):
    """StateStore whose mutations are Raft-replicated before being applied."""

    def __init__(self) -> None:
        super().__init__()
        self.raft: Optional[RaftNode] = None  # attached by ClusterServer
        self._intent_lock = threading.RLock()
        self._local = threading.local()

    def direct(self) -> _DirectView:
        return _DirectView(self)

    # ---- raft FSM snapshot hooks (fsm.go Snapshot :1242 / Restore
    # :1256; consumed by RaftNode log compaction + InstallSnapshot) ----

    def fsm_snapshot(self):
        from .fsm import snapshot_state

        return snapshot_state(self)

    def fsm_restore(self, blob) -> None:
        from .fsm import restore_state

        self.reset_for_restore()
        # restore runs through the normal mutators — they must write
        # DIRECT, not re-enter raft.apply (self-deadlock on the applier),
        # and must NOT re-announce the snapshot's history on the event
        # stream (subscribers resume by index; the broker marks the
        # folded range as a lost-gap instead)
        prev = getattr(self._local, "direct", False)
        self._local.direct = True
        try:
            with self.suspend_events():
                restore_state(self, blob)
        finally:
            self._local.direct = prev
        if self.event_broker is not None:
            self.event_broker.mark_restored(self.index.value)

    def transact(self):
        """Serializes watcher read-modify-write sections against each other
        only. Raft-committed mutations land from the applier thread under
        the store lock — holding that lock across a blocking apply would
        deadlock, and the reference has the same relaxed contract (watcher
        RMWs race the plan applier through Raft; ModifyIndex checks and
        plan re-verification absorb it)."""
        return self._intent_lock

    # After a routed upsert the FSM mutated a DECODED COPY, not the caller's
    # object; callers read bookkeeping off their local object (e.g.
    # job_register stamps the eval with job.modify_index), so the stored
    # copy's indexes are synced back onto the argument post-commit.
    _LOOKUP = {
        "upsert_node": lambda s, a: s.node_by_id(a.id),
        "upsert_job": lambda s, a: s.job_by_id(a.namespace, a.id),
        "upsert_eval": lambda s, a: s.eval_by_id(a.id),
        "upsert_alloc": lambda s, a: s.alloc_by_id(a.id),
        "upsert_deployment": lambda s, a: s.deployment_by_id(a.id),
        "update_alloc_from_client": lambda s, a: s.alloc_by_id(a.id),
    }

    def _route(name):  # noqa: N805
        def method(self, *args):
            if self.raft is None or getattr(self._local, "direct", False):
                # bootstrap (pre-raft attach) or nested call under an
                # FSM apply: mutate directly
                return getattr(StateStore, name)(self, *args)
            from .fsm import validate_op

            # reject before replication — a committed entry that raises in
            # the FSM would be skipped on every peer, but should never be
            # paid for (fsm.validate_op)
            validate_op(self, name, args)
            self.raft.apply({"op": name, "args": _encode_args(name, args)})
            # The committed entry has been applied locally (apply blocks
            # until last_applied covers it); reads now see the write.
            if name == "csi_volume_claim":
                # the op's bool result can't ride the raft apply — read it
                # back: a rejected claim leaves the alloc out of the
                # volume's claim maps (CSIVolume.claim)
                ns, vol_id, alloc_id, mode = args[:4]
                vol = self.csi_volume(ns, vol_id)
                if vol is None:
                    return False
                claims = (vol.read_claims if mode == "read"
                          else vol.write_claims)
                return alloc_id in claims
            look = self._LOOKUP.get(name)
            if look is None:
                return None
            stored = look(self, args[0])
            if stored is None:
                return None
            if name == "update_alloc_from_client":
                return stored
            for f in ("create_index", "modify_index", "job_modify_index",
                      "alloc_modify_index"):
                if hasattr(stored, f):
                    setattr(args[0], f, getattr(stored, f))
            return None

        method.__name__ = name
        return method

    for _name in sorted(ALLOWED_OPS):
        locals()[_name] = _route(_name)
    del _name, _route


class ClusterServerConfig(ServerConfig):
    def __init__(self, node_id: str = "node", host: str = "127.0.0.1",
                 port: int = 0, tls=None, region: str = "global", **kw):
        super().__init__(**kw)
        self.node_id = node_id
        self.host = host
        self.port = port
        self.tls = tls  # lib.tlsutil.TLSConfig | None (RPC fabric mTLS)
        self.region = region  # WAN federation (nomad/server.go Region)


#: endpoint methods a follower forwards to the leader (write RPCs plus the
#: client pull loop; the reference forwards in each endpoint via rpc.go
#: forward()). node_update_allocs — not the raw state merge — is the
#: status-push route so reschedule evals and unblocking fire.
FORWARDED = (
    "job_register", "job_deregister", "job_evaluate",
    "node_register", "node_update_status",
    "node_update_drain", "node_update_eligibility", "node_heartbeat",
    "node_update_allocs", "node_get_client_allocs", "alloc_get",
    "node_get", "run_gc",
    "update_alloc_health", "node_device_stats",
    "csi_volume_claim", "csi_volume_get",
    "csi_controller_poll", "csi_controller_done",
    "update_service_registrations", "remove_service_registrations",
    "services_lookup", "connect_issue", "connect_intentions_for",
    "secret_upsert", "secret_delete", "secret_get",
)


class ClusterServer:
    """One server agent of a Raft-replicated region."""

    def __init__(self, config: ClusterServerConfig,
                 peers: Optional[Dict[str, Tuple[str, int]]] = None,
                 device: DeviceLike = None) -> None:
        #: where the leader's schedulers place (the card unless the
        #: caller asks for the CPU)
        self.device = resolve_device(device)
        self.config = config
        # mTLS on the server fabric when configured (nomad/rpc.go:225-260)
        self.rpc = RpcServer(config.host, config.port,
                             tls=getattr(config, "tls", None))
        self.pool = ConnPool(tls=getattr(config, "tls", None))
        self.addr = self.rpc.addr
        self.peers = dict(peers) if peers else {config.node_id: self.addr}
        # guards self.peers: the raft applier thread mutates it on
        # committed conf changes while HTTP workers iterate it
        self._peers_lock = threading.Lock()

        state = RaftStateStore()
        srv_cfg = ServerConfig(
            num_schedulers=config.num_schedulers,
            heartbeat_ttl=config.heartbeat_ttl,
            nack_timeout=config.nack_timeout,
            gc_interval=config.gc_interval, gc=config.gc,
            mesh="env",
        )
        self.state = state
        self.server = self._new_server(srv_cfg, state)

        fsm = FSM(state.direct())
        raft_dir = None
        if config.data_dir:
            raft_dir = config.data_dir
        self.raft = RaftNode(
            config.node_id, self.peers, self.rpc, self.pool,
            apply_fn=fsm.apply_resilient, data_dir=raft_dir,
            on_leadership_change=self._on_leadership_change,
            fsync=config.fsync,
            # log compaction: fold applied entries into FSM snapshots so
            # the log (memory + disk) stays bounded and lagging/fresh
            # followers catch up via InstallSnapshot, not full replay
            snapshot_fn=state.fsm_snapshot,
            restore_fn=state.fsm_restore,
            snapshot_threshold=config.snapshot_threshold,
        )
        # FSM apply counters live in the raft registry (one scrape
        # surface per server; tests/test_metrics_names.py pins the
        # names): fsm.applied ticks per committed entry,
        # fsm.apply_skipped per entry apply_resilient dropped
        fsm.bind_metrics(self.raft.metrics)
        state.raft = self.raft
        self._srv_cfg = srv_cfg
        self._register_endpoints()
        self._leader_enabled = False
        self._server_used = False
        self._leader_lock = threading.Lock()
        self._closing = threading.Event()
        #: wall ms of the last leadership gain's barrier, None before one
        self.last_barrier_ms: Optional[float] = None
        # serf analog: anti-entropy membership + failure detection over
        # the RPC fabric (nomad/serf.go setupSerf; server.go:1363)
        from .autopilot import Autopilot
        from .gossip import Membership

        self.autopilot = Autopilot(self)
        # serf-style member name "<node>.<region>" (nomad/server.go:1374:
        # serf names are node.region) — bare node ids may collide across
        # federated regions, which would make the gossip table clobber or
        # drop the remote region's servers
        self.membership = Membership(
            f"{config.node_id}.{config.region}", self.addr, self.pool,
            tags={"region": config.region},
            on_change=self._member_change)
        self.rpc.register("Gossip.exchange", self.membership.exchange)
        # committed raft config changes shrink/grow the endpoint peer map
        # too (the reference's serf/raft reconciliation)
        self.raft.on_conf_change = self._on_raft_conf_change

    # ---- lifecycle ----

    def start(self) -> None:
        self.rpc.start()
        self.raft.start()
        seeds = [a for pid, a in self.peers.items()
                 if pid != self.config.node_id]
        if seeds:
            # async retry-join: down seeds must not block startup
            self.membership.join_async(seeds)
        self.membership.start()

    def shutdown(self) -> None:
        self._closing.set()
        self.membership.leave()
        self.autopilot.stop()
        with self._leader_lock:
            if self._leader_enabled:
                self._leader_enabled = False
                self.server.shutdown()
        self.raft.shutdown()
        self.rpc.shutdown()
        self.pool.close()

    def _new_server(self, cfg: ServerConfig, state) -> Server:
        """Server wiring shared by startup and leadership regain."""
        srv = Server(cfg, state=state, device=self.device)
        # heartbeat responses advertise this region's alive servers so
        # clients keep their failover list current (NodeServerInfo)
        srv.server_addrs_fn = \
            lambda: self.region_servers(self.config.region)
        # spans land in the PROCESS-global store; the serf-style member
        # name keeps co-hosted servers tellable apart in a stitched
        # trace (in-process cluster tests, `nomad trace` rendering)
        member = f"{self.config.node_id}.{self.config.region}"
        srv.tracer.source = member
        srv.slo.source = member
        return srv

    def _member_change(self, member) -> None:
        """Gossip status transition → flight event (membership churn is
        a first-class failover signal), then autopilot health."""
        from ..lib.flight import default_flight
        from .gossip import STATUS_ALIVE

        try:
            default_flight().record(
                "membership.change", key=member.name,
                source=self.config.node_id,
                severity=("info" if member.status == STATUS_ALIVE
                          else "warn"),
                detail={"status": member.status,
                        "incarnation": member.incarnation})
        except Exception:  # noqa: BLE001 — telemetry only
            pass
        self.autopilot.member_change(member)

    def _on_raft_conf_change(self, action: str, peer_id: str,
                             addr) -> None:
        with self._peers_lock:
            if action == "remove":
                self.peers.pop(peer_id, None)
            elif action == "add" and addr:
                self.peers[peer_id] = tuple(addr)

    def peers_snapshot(self) -> dict:
        """Copy of the peer address map, safe to iterate off-thread."""
        with self._peers_lock:
            return dict(self.peers)

    # ---- leadership (leader.go monitorLeadership) ----

    def _on_leadership_change(self, is_leader: bool) -> None:
        if is_leader:
            self._establish_leadership()
            return
        with self._leader_lock:
            if self._leader_enabled:
                self._leader_enabled = False
                self.autopilot.stop()
                self.server.shutdown()

    def _establish_leadership(self) -> None:
        """leader.go leaderLoop: commit a barrier, so the FSM holds every
        entry that earlier terms committed, before the subsystems start
        over it (establishLeadership: restored evals, heartbeat timers,
        the periodic dispatcher). The barrier runs outside _leader_lock,
        so a shutdown never waits on it."""
        while (self.raft.is_leader() and not self._closing.is_set()
               and not self.raft._stop.is_set()):
            t0 = time.perf_counter()
            try:
                self.raft.barrier()
            except NotLeaderError:
                return  # lost it; the loss is queued behind this call
            except TimeoutError:
                continue  # still leader: barrier again (leaderLoop WAIT)
            self.last_barrier_ms = (time.perf_counter() - t0) * 1e3
            with self._leader_lock:
                if (self._leader_enabled or self._closing.is_set()
                        or not self.raft.is_leader()):
                    return
                if self._server_used:
                    # Subsystem threads/brokers are single-shot; regaining
                    # leadership rebuilds them over the same replicated
                    # state (reference re-runs establishLeadership).
                    self.server = self._new_server(self._srv_cfg,
                                                   self.state)
                self._server_used = True
                self.server.start()
                self._leader_enabled = True
                self.autopilot.start()
            return

    def is_leader(self) -> bool:
        return self.raft.is_leader()

    # ---- endpoint RPC surface (Server.* methods, forwarded) ----

    def _register_endpoints(self) -> None:
        for m in FORWARDED:
            self.rpc.register(f"Server.{m}", self._make_handler(m))

    def _make_handler(self, method: str):
        def handler(*wire_args):
            # an inbound endpoint RPC may land on a follower (a client's
            # failover list, or a cross-region entry server); the handler
            # leader-forwards within its own region exactly as every
            # reference endpoint does via forward() (nomad/rpc.go)
            return to_wire(self._call_wire(method, wire_args))

        handler.__name__ = method
        return handler

    def _invoke_local(self, method: str, wire_args):
        args = [from_wire(a) for a in wire_args]
        return getattr(self.server, method)(*args)

    # ---- client-facing call (forwarding; rpc.go forward()) ----

    def _call_wire(self, method: str, wire_args, timeout: float = 10.0):
        """Leader-forwarded invoke with already-wire-encoded args.

        Retries while the leader is unknown or moves mid-call, like the
        reference's forward() loop (nomad/rpc.go:225-260) which backs off
        up to rpcHoldTimeout on ErrNoLeader instead of failing the first
        RPC after an election."""
        deadline = time.time() + timeout
        leader = None
        while True:
            try:
                if self.is_leader():
                    if self._leader_enabled:
                        return self._invoke_local(method, wire_args)
                    # won the term, subsystems not up yet (the barrier):
                    # no leader to serve this, as while one is unknown
                    leader_addr = None
                else:
                    leader = self.raft.leader()
                    leader_addr = (self.peers_snapshot().get(leader)
                                   if leader is not None
                                   and leader != self.config.node_id
                                   else None)
                if leader_addr is not None:
                    res = self.pool.call(
                        leader_addr, f"Server.{method}", *wire_args,
                        timeout=max(0.1, deadline - time.time()))
                    return from_wire(res)
            except NotLeaderError:
                pass  # lost leadership between check and invoke; re-resolve
            except RpcError as e:
                # remote believed-leader had already stepped down
                if "NotLeaderError" not in str(e):
                    raise
            if time.time() >= deadline:
                raise NotLeaderError(leader)
            time.sleep(0.05)

    def call(self, method: str, *args, timeout: float = 10.0,
             region: Optional[str] = None):
        """Invoke an endpoint, forwarding to the leader — or, when
        `region` names a different federated region, to any alive server
        of that region (forwardRegion, nomad/rpc.go:282; the remote entry
        server leader-forwards within its own region)."""
        if method not in FORWARDED:
            raise ValueError(f"unknown endpoint {method!r}")
        wire_args = [to_wire(a) for a in args]
        if region is not None and region != self.config.region:
            from .gossip import STATUS_ALIVE

            remote = [m for m in self.membership.members()
                      if m.region == region and m.status == STATUS_ALIVE
                      and m.name != self.membership.name]
            if not remote:
                raise NoRegionPathError(region)
            import random as _random

            target = _random.choice(remote)
            res = self.pool.call(target.addr, f"Server.{method}",
                                 *wire_args, timeout=timeout)
            return from_wire(res)
        return self._call_wire(method, wire_args, timeout=timeout)

    # ---- WAN federation (server.go:1363 serf WAN; regions_endpoint.go) --

    def join_wan(self, addr) -> bool:
        """Federate with another region through any of its servers (the
        reference's `server join` over the WAN serf pool). Gossip then
        spreads both regions' member tables everywhere."""
        return self.membership.join([tuple(addr)])

    def regions(self) -> List[str]:
        """Sorted federated region names (regions_endpoint.go List)."""
        from .gossip import STATUS_LEFT

        return sorted({m.region for m in self.membership.members()
                       if m.status != STATUS_LEFT}
                      | {self.config.region})

    def region_servers(self, region: str) -> List[Tuple[str, int]]:
        from .gossip import STATUS_ALIVE

        return [m.addr for m in self.membership.members()
                if m.region == region and m.status == STATUS_ALIVE]
