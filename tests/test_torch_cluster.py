"""The port's Raft region: `nomad_tpu_torch/server/cluster.py`,
`gossip.py` and `autopilot.py`, every `ClusterServer` with device="cpu".

Twins of the reference's `TestCluster` (`tests/test_cluster.py`, its two
client cases with a port `Client` over `RpcConn`), `TestClusterCsiClaim`,
`TestClusterEventStream` (`tests/test_control_plane.py`; its agents'
HTTP APIs, which that case never calls, wait for the agent's port) and
the autopilot cases of `tests/test_autopilot.py` that need no HTTP API,
run on the port. Then the region gate: a port region and a reference
region fed the same writes through their leaders commit equal state and
event fingerprints on all six servers, and a follower's forwarded job is
placed by the port's leader on its device.
"""
import copy
import time

import pytest
import torch

from nomad_tpu_torch import mock
from nomad_tpu_torch.lib.flight import default_flight
from nomad_tpu_torch.server.cluster import ClusterServer, ClusterServerConfig


def _wait(cond, timeout=45.0, every=0.05):
    # raft election, replication and gossip are in-process timing; a
    # loaded test host stretches them, so every wait is on a condition
    dl = time.time() + timeout
    while time.time() < dl:
        if cond():
            return True
        time.sleep(every)
    return cond()


def make_cluster(n=3, server_cls=ClusterServer, config_cls=ClusterServerConfig,
                 **kw):
    configs = [config_cls(node_id=f"s{i}", num_schedulers=1,
                          heartbeat_ttl=60.0, gc_interval=3600.0)
               for i in range(n)]
    # two-phase: allocate ports first, then share the peer map
    agents = []
    peers = {}
    for cfg in configs:
        a = server_cls(cfg, **kw)
        peers[cfg.node_id] = a.addr
        agents.append(a)
    for a in agents:
        a.peers.clear()
        a.peers.update(peers)
        a.raft.peers = dict(peers)
    for a in agents:
        a.start()
    return agents


def _shutdown(agents):
    for a in agents:
        try:
            a.shutdown()
        except OSError:
            pass   # a victim whose sockets a test already closed


@pytest.fixture()
def cluster():
    agents = make_cluster(3, device="cpu")
    yield agents
    _shutdown(agents)


def leader_of(agents):
    for a in agents:
        if a.is_leader():
            return a
    return None


class TestClusterSnapshotCompaction:
    """The Raft log compacts through the port's FSM and the state
    survives intact (the reference's `slow` mark kept)."""

    @pytest.mark.slow
    def test_log_compacts_and_state_survives(self):
        configs = [ClusterServerConfig(node_id=f"s{i}", num_schedulers=1,
                                       heartbeat_ttl=60.0,
                                       gc_interval=3600.0,
                                       snapshot_threshold=40)
                   for i in range(3)]
        agents, peers = [], {}
        for cfg in configs:
            a = ClusterServer(cfg, device="cpu")
            peers[cfg.node_id] = a.addr
            agents.append(a)
        for a in agents:
            a.peers.clear()
            a.peers.update(peers)
            a.raft.peers = dict(peers)
        for a in agents:
            a.start()
        try:
            assert _wait(lambda: leader_of(agents) is not None)
            leader = leader_of(agents)
            nodes = [mock.node() for _ in range(60)]
            for n in nodes:
                leader.server.node_register(n)
            assert _wait(lambda: leader.raft.log.base_index > 0), \
                leader.raft.log.last_index()
            for a in agents:
                assert _wait(lambda a=a: len(a.state.nodes()) >= 60), \
                    (a.config.node_id, len(a.state.nodes()))
            # rows written before the snapshot keep their indexes
            assert leader.state.node_by_id(nodes[0].id).create_index > 0
        finally:
            _shutdown(agents)


class TestCluster:
    def test_leader_elected_and_subsystems_enabled(self, cluster):
        assert _wait(lambda: leader_of(cluster) is not None)
        leader = leader_of(cluster)
        # the leadership callback enables subsystems asynchronously after
        # the raft term is won — wait for it rather than racing it
        assert _wait(lambda: leader.server._running)
        followers = [a for a in cluster if a is not leader]
        assert all(not f.server._running for f in followers)
        assert all(a.server.device.type == "cpu" for a in cluster)

    def test_write_replicates_to_all(self, cluster):
        assert _wait(lambda: leader_of(cluster) is not None)
        leader = leader_of(cluster)
        node = mock.node()
        leader.call("node_register", node)
        for a in cluster:
            assert _wait(lambda a=a: a.state.node_by_id(node.id) is not None)
            got = a.state.node_by_id(node.id)
            assert got.name == node.name

    def test_follower_forwards_job_and_scheduler_places(self, cluster):
        assert _wait(lambda: leader_of(cluster) is not None)
        leader = leader_of(cluster)
        follower = next(a for a in cluster if a is not leader)
        for _ in range(2):
            follower.call("node_register", mock.node())
        job = mock.job()
        job.task_groups[0].count = 3
        ev = follower.call("job_register", job)
        assert ev is not None
        done = leader.server.wait_for_eval(ev.id, timeout=15.0)
        assert done is not None and done.status == "complete"
        # placements replicated everywhere
        for a in cluster:
            assert _wait(lambda a=a: len(
                a.state.allocs_by_job("default", job.id)) == 3), \
                f"{a.config.node_id} missing allocs"

    def test_leader_failover_new_leader_schedules(self, cluster):
        assert _wait(lambda: leader_of(cluster) is not None)
        leader = leader_of(cluster)
        survivors = [a for a in cluster if a is not leader]
        survivors[0].call("node_register", mock.node())
        leader.shutdown()

        assert _wait(lambda: leader_of(survivors) is not None), \
            "no new leader"
        new_leader = leader_of(survivors)
        assert _wait(lambda: new_leader.server._running)
        job = mock.job()
        job.task_groups[0].count = 2
        ev = new_leader.call("job_register", job)
        done = new_leader.server.wait_for_eval(ev.id, timeout=15.0)
        assert done is not None and done.status == "complete"
        allocs = new_leader.state.allocs_by_job("default", job.id)
        assert len(allocs) == job.task_groups[0].count

    def test_client_status_update_via_follower(self, cluster):
        assert _wait(lambda: leader_of(cluster) is not None)
        leader = leader_of(cluster)
        follower = next(a for a in cluster if a is not leader)
        follower.call("node_register", mock.node())
        job = mock.job()
        job.task_groups[0].count = 1
        ev = follower.call("job_register", job)
        leader.server.wait_for_eval(ev.id, timeout=15.0)
        assert _wait(lambda: follower.state.allocs_by_job(
            "default", job.id) != [])
        a0 = follower.state.allocs_by_job("default", job.id)[0]
        upd = copy.copy(a0)
        upd.client_status = "running"
        follower.call("node_update_allocs", [upd])
        for a in cluster:
            assert _wait(lambda a=a: a.state.alloc_by_id(
                a0.id).client_status == "running")

    def test_client_learns_server_set_from_heartbeats(self, cluster,
                                                      tmp_path):
        """A client configured with ONE server address learns the full
        region server set from heartbeat responses
        (client/servers/manager.go SetServers)."""
        from nomad_tpu_torch.client import Client, ClientConfig, RpcConn

        assert _wait(lambda: leader_of(cluster) is not None)
        assert _wait(lambda: all(
            len(a.membership.members()) == 3 for a in cluster))
        leader = leader_of(cluster)
        conn = RpcConn([leader.addr])
        client = Client(conn, ClientConfig(
            data_dir=str(tmp_path / "c"), heartbeat_interval=0.5,
            watch_timeout=2.0))
        client.start()
        try:
            assert _wait(lambda: len(conn.addrs) == 3), \
                f"failover list never grew: {conn.addrs}"
            assert set(conn.addrs) == {a.addr for a in cluster}
        finally:
            client.shutdown()

    def test_rpc_client_agent_against_cluster(self, cluster, tmp_path):
        """A real Client over the RPC fabric: watch loop, task execution,
        status sync, reschedule side effects — through any server."""
        from nomad_tpu_torch.client import Client, ClientConfig, RpcConn

        assert _wait(lambda: leader_of(cluster) is not None)
        leader = leader_of(cluster)
        follower = next(a for a in cluster if a is not leader)
        conn = RpcConn([follower.addr, leader.addr])
        client = Client(conn, ClientConfig(
            data_dir=str(tmp_path / "c"), heartbeat_interval=1.0,
            watch_timeout=2.0))
        client.start()
        try:
            assert _wait(lambda: leader.state.node_by_id(
                client.node.id) is not None)
            job = mock.job()
            tg = job.task_groups[0]
            tg.count = 2
            t = tg.tasks[0]
            t.driver = "mock_driver"
            t.config = {"run_for": 0.1}
            ev = follower.call("job_register", job)
            done = leader.server.wait_for_eval(ev.id, timeout=15.0)
            assert done is not None and done.status == "complete"
            assert _wait(lambda: leader.state.allocs_by_job(
                "default", job.id) != [] and all(
                a.client_status == "complete"
                for a in leader.state.allocs_by_job("default", job.id)))
            a0 = leader.state.allocs_by_job("default", job.id)[0]
            assert a0.task_states["web"].state == "dead"
        finally:
            client.shutdown()

class TestClusterCsiClaim:
    def test_claim_result_survives_raft_routing(self, cluster):
        """csi_volume_claim's boolean must come back through the Raft
        route (the op itself rides the log; the result is a post-apply
        read-back)."""
        from nomad_tpu_torch.structs.csi import CSIVolume

        assert _wait(lambda: leader_of(cluster) is not None)
        leader = leader_of(cluster)
        srv = leader.server
        srv.csi_volume_register(CSIVolume(
            id="cv", name="cv", plugin_id="hostpath"))
        assert srv.csi_volume_claim("default", "cv", "alloc-1", "write") \
            is True
        # single-writer: a second writer must see False, not None
        assert srv.csi_volume_claim("default", "cv", "alloc-2", "write") \
            is False
        vol = srv.csi_volume_get("default", "cv")
        assert "alloc-1" in vol.write_claims


class TestClusterEventStream:
    """On a live 3-server cluster: replicas derive
    identical event streams from the replicated log, a consumer's
    index cursor survives leader failover, eviction shows up as an
    explicit gap marker, and the broker/flight separation holds."""

    def test_failover_resume_by_index_gap_marked_no_dups(
            self, cluster):
        from nomad_tpu_torch.server.event_broker import (
            GAP_TYPE, events_fingerprint)

        agents = cluster
        assert _wait(lambda: leader_of(agents) is not None)
        old = leader_of(agents)
        assert _wait(lambda: old.server._running)
        # replicated traffic the stream must announce
        old.call("node_register", mock.node())
        job = mock.job()
        ev = old.call("job_register", job)
        assert old.server.wait_for_eval(ev.id, timeout=20.0) is not None
        # consume a first page from the OLD leader; remember the cursor
        idx, first = old.server.events.events_after(0, timeout=10.0)
        assert first, "no events announced on the leader"
        cursor = max(e.index for e in first)
        topics0 = {e.topic for e in first}
        assert {"Node", "Job", "Eval"} <= topics0

        # leadership transition (the debug-bundle e2e's nudge)
        def transitioned():
            cur = leader_of(agents)
            return (cur is not None and cur is not old
                    and cur.server._running)

        for _ in range(10):
            followers = [a for a in agents
                         if a is not old
                         and a.raft.log.last_index()
                         == old.raft.log.last_index()]
            if not followers:
                time.sleep(0.2)
                continue
            followers[0].raft._run_election()
            if _wait(transitioned, timeout=5.0):
                break
        assert transitioned(), "no leadership transition happened"
        new = leader_of(agents)

        # the NEW leader applied the same log, so its broker can serve
        # the same cursor: resume-by-index continues without overlap
        assert _wait(
            lambda: new.server.events.last_index() >= cursor)
        new.call("node_register", mock.node())
        _, more = new.server.events.events_after(cursor, timeout=10.0)
        live = [e for e in more if e.type != GAP_TYPE]
        idxs = [e.index for e in first] + [e.index for e in live]
        assert idxs == sorted(idxs), "resume went backwards"
        # all events of ONE entry share its apply index (batch-atomic
        # delivery) — dedup on the full event identity
        keys = [(e.index, e.topic, e.type, e.key)
                for e in first + live]
        assert len(set(keys)) == len(keys), \
            "duplicate event across failover"
        assert any(e.index > cursor for e in more), \
            "post-failover traffic not announced"

        # a slow subscriber on the new leader: flooding past its queue
        # bound must surface as ONE explicit gap marker, zero dups
        sub = new.server.events.subscribe(
            topics=["Node"], from_index=cursor, max_pending=4)
        for _ in range(12):
            new.call("node_register", mock.node())
        seen, gaps = [], []

        def drained():
            for e in sub.poll(timeout=0.2):
                (gaps if e.type == GAP_TYPE else seen).append(e)
            return gaps and seen \
                and seen[-1].index >= new.server.events.last_index()

        assert _wait(drained, timeout=20.0), \
            "slow subscriber never saw the gap + tail"
        sub.close()
        assert len(gaps) >= 1
        got = [e.index for e in seen]
        assert got == sorted(got) and len(set(got)) == len(got)
        covered = set(got)
        for g in gaps:
            covered.update(range(g.payload["requested_index"] + 1,
                                 g.payload["lost_through"] + 1))
        expect = {e.index for e in
                  new.server.events.buffered() if e.topic == "Node"
                  and e.index > cursor}
        assert expect <= covered, "silent loss past the gap marker"

        # replica determinism at cluster level: identical fingerprints
        # over the common applied prefix
        low = min(a.server.events.last_index() for a in agents)
        fps = {events_fingerprint(
            [e for e in a.server.events.buffered() if e.index <= low])
            for a in agents}
        assert len(fps) == 1, "replicas derived different events"

        # separation: leadership/membership stay flight-recorder-only
        # signals — the broker's topic set is the closed taxonomy, and
        # the flight recorder still owns the operational stream
        for a in agents:
            assert {e.topic for e in a.server.events.buffered()} <= {
                "Job", "Eval", "Alloc", "Deployment", "Node", "Plan"}
        _, fevs = default_flight().records_after(0)
        assert any(e["type"].startswith("leadership.")
                   for e in fevs), "flight lost the leadership stream"


def _crash(agent):
    """Hard crash: no graceful LEFT broadcast."""
    agent.raft.shutdown()
    agent.rpc.shutdown()
    agent.membership.stop()


class TestAutopilot:
    def test_health_report(self, cluster):
        assert _wait(lambda: leader_of(cluster) is not None)
        leader = leader_of(cluster)
        assert _wait(lambda: all(
            len(a.membership.members()) == 3 for a in cluster))
        h = leader.autopilot.server_health()
        assert h["healthy"] is True
        assert len(h["servers"]) == 3
        assert all(s["healthy"] for s in h["servers"])
        assert h["failure_tolerance"] == 1

    def test_dead_server_cleanup(self, cluster):
        """A crashed server is removed from the raft voter set once
        gossip marks it failed (pruneDeadServers)."""
        assert _wait(lambda: leader_of(cluster) is not None)
        assert _wait(lambda: all(
            len(a.membership.members()) == 3 for a in cluster))
        leader = leader_of(cluster)
        victim = next(a for a in cluster if a is not leader)
        _crash(victim)
        assert _wait(lambda: victim.config.node_id
                     not in leader.raft.peers, timeout=30.0), \
            "victim not pruned from raft config"
        # the survivors still schedule writes (quorum of 2/2 remains)
        node = mock.node()
        leader.call("node_register", node)
        assert leader.state.node_by_id(node.id) is not None

    def test_dead_leader_pruned_by_new_leader(self, cluster):
        """When the LEADER crashes, the failure event fires while no one
        is leader — the new leader's periodic reconcile must prune the
        ex-leader (event-driven cleanup alone would drop it forever)."""
        assert _wait(lambda: leader_of(cluster) is not None)
        assert _wait(lambda: all(
            len(a.membership.members()) == 3 for a in cluster))
        old = leader_of(cluster)
        survivors = [a for a in cluster if a is not old]
        _crash(old)
        assert _wait(lambda: leader_of(survivors) is not None,
                     timeout=30.0), "no new leader"
        new_leader = leader_of(survivors)
        assert _wait(lambda: old.config.node_id
                     not in new_leader.raft.peers, timeout=30.0), \
            "ex-leader not pruned"

    def test_cleanup_disabled_keeps_peer(self, cluster):
        """With cleanup off, a member gossip has marked failed stays a
        voter through the event and through a reconcile pass (the
        reference sleeps out the detector; here both are waited on)."""
        from nomad_tpu_torch.server.gossip import STATUS_ALIVE
        from nomad_tpu_torch.structs.operator import AutopilotConfig

        assert _wait(lambda: leader_of(cluster) is not None)
        assert _wait(lambda: all(
            len(a.membership.members()) == 3 for a in cluster))
        leader = leader_of(cluster)
        leader.state.set_autopilot_config(
            AutopilotConfig(cleanup_dead_servers=False))
        victim = next(a for a in cluster if a is not leader)
        _crash(victim)
        assert _wait(lambda: next(
            m.status for m in leader.membership.members()
            if m.name == victim.membership.name) != STATUS_ALIVE,
            timeout=30.0), "victim never marked failed"
        leader.autopilot.reconcile()
        assert victim.config.node_id in leader.raft.peers


# ---- the region gate: the port's region against the reference's ----

#: ops fed to both regions: tables no leader subsystem acts on
#: by itself (no eval, deployment or CSI claim to pick up)
GATE_OPS = ("upsert_node", "upsert_job", "upsert_plan_results",
            "upsert_alloc", "update_alloc_from_client", "delete_alloc",
            "upsert_acl_policy", "delete_acl_policy", "upsert_acl_token",
            "delete_acl_token", "acl_bootstrap", "upsert_secret",
            "delete_secret", "upsert_namespace", "delete_namespace",
            "upsert_quota", "delete_quota", "set_scheduler_config")


def _region(pkg):
    """Three servers of `pkg` with its codec and fingerprint functions."""
    import importlib

    cluster = importlib.import_module(f"{pkg}.server.cluster")
    fsm = importlib.import_module(f"{pkg}.server.fsm")
    eb = importlib.import_module(f"{pkg}.server.event_broker")
    codec = importlib.import_module(f"{pkg}.structs.codec")
    kw = {"device": "cpu"} if pkg == "nomad_tpu_torch" else {}
    agents = make_cluster(3, cluster.ClusterServer,
                          cluster.ClusterServerConfig, **kw)

    def prints(a):
        return (fsm.state_fingerprint(a.state),
                eb.events_fingerprint(a.state.event_broker.buffered()))

    return agents, codec.from_wire, prints


def test_port_region_commits_what_the_reference_region_commits(tmp_path):
    from torch_wire_cases import op_log

    log = [e for e in op_log(str(tmp_path / "log")) if e["op"] in GATE_OPS]
    assert {e["op"] for e in log} == set(GATE_OPS)
    regions = {}
    try:
        for pkg in ("nomad_tpu_torch", "nomad_tpu"):
            agents, from_wire, prints = _region(pkg)
            regions[pkg] = agents
            assert _wait(lambda: leader_of(agents) is not None)
            leader = leader_of(agents)
            for e in log:
                getattr(leader.state, e["op"])(
                    *[from_wire(a) for a in e["args"]])
            index = leader.state.index.value
            assert _wait(lambda: all(a.state.index.value == index
                                     for a in agents))
            assert _wait(lambda: len({prints(a) for a in agents}) == 1)
            regions[pkg] = (agents, prints(leader))
        port, ref = regions["nomad_tpu_torch"][1], regions["nomad_tpu"][1]
        assert port == ref
    finally:
        for v in regions.values():
            _shutdown(v[0] if isinstance(v, tuple) else v)


def test_forwarded_job_places_on_the_leaders_device(cluster):
    """A follower forwards the job; the leader's workers place it through
    the port's path on the device the region was built with, and every
    server commits the same state."""
    from nomad_tpu_torch.server.fsm import state_fingerprint

    assert _wait(lambda: leader_of(cluster) is not None)
    leader = leader_of(cluster)
    assert _wait(lambda: leader.server._running)
    follower = next(a for a in cluster if a is not leader)
    for _ in range(4):
        follower.call("node_register", mock.node())
    job = mock.job()
    job.task_groups[0].count = 4
    ev = follower.call("job_register", job)
    done = leader.server.wait_for_eval(ev.id, timeout=15.0)
    assert done is not None and done.status == "complete"
    assert leader.device == leader.server.device == torch.device("cpu")
    index = leader.state.index.value
    assert _wait(lambda: all(a.state.index.value >= index for a in cluster))
    assert _wait(lambda: len({state_fingerprint(a.state)
                              for a in cluster}) == 1)
