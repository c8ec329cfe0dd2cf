"""Twins of the reference's `tests/test_control_plane.py`
`TestOperatorFlightEndpoint`, `TestOperatorDebugEndpoint` and
`TestOperatorDebugCluster` (the flight recorder's route and the
`operator debug` bundle), run on the port: every agent, server and
harness is the port's with `device="cpu"`, its HTTP port ephemeral and
its data under `tmp_path`; the reference's `slow` marks are kept.

And the instruments: `TestBrokerQueueStats` and `TestPlanApplyInstruments`
run the same evals and plans (the reference's mocks, carried into the
port over the wire) through both packages' broker, plan queue and
applier and compare the depths, gauges, stats and flight events; the
CLI's robustness cases run both packages' CLIs on the same arguments;
the unwritable bundle and the follower's own debug report run on the
port's dev agent and region. (`TestHeartbeatExpiry`'s twin is in
`tests/test_torch_heartbeat.py`.)
"""
import json
import tarfile
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.api import DEBUG_SECTIONS, NomadClient
from nomad_tpu_torch.lib.flight import default_flight
from nomad_tpu_torch.lib.metrics import MetricsRegistry
from torch_chain_cases import one_torch_thread  # noqa: F401


def _wait(cond, timeout=45.0, every=0.05):
    dl = time.time() + timeout
    while time.time() < dl:
        if cond():
            return True
        time.sleep(every)
    return cond()


class _StubRpc:
    """RaftNode only registers handlers on it (single-voter node)."""

    def register(self, name, fn):
        pass


# ---- instrument units, both packages on the same objects ----


def _pkgs():
    """(name, package root, flight module, metrics module, to-package)."""
    import nomad_tpu
    from nomad_tpu.lib import flight as ref_flight
    from nomad_tpu.lib import metrics as ref_metrics
    from nomad_tpu.structs.codec import to_wire

    import nomad_tpu_torch
    from nomad_tpu_torch.lib import flight as port_flight
    from nomad_tpu_torch.lib import metrics as port_metrics
    from nomad_tpu_torch.structs.codec import from_wire

    return (("ref", nomad_tpu, ref_flight, ref_metrics, lambda o: o),
            ("port", nomad_tpu_torch, port_flight, port_metrics,
             lambda o: from_wire(to_wire(o))))


def _broker(pkg, metrics, **kw):
    import importlib

    broker = importlib.import_module(f"{pkg.__name__}.server.broker")
    b = broker.EvalBroker(metrics=metrics.MetricsRegistry(), **kw)
    b.set_enabled(True)
    return b


class TestBrokerQueueStats:
    def test_depths_and_ages_per_scheduler(self):
        from nomad_tpu import mock as ref_mock

        evals = [ref_mock.eval_(type="service"),
                 ref_mock.eval_(type="service"),
                 ref_mock.eval_(type="batch")]
        got = {}
        for name, pkg, _fl, metrics, conv in _pkgs():
            b = _broker(pkg, metrics)
            for ev in evals:
                b.enqueue(conv(ev))
            time.sleep(0.05)
            qs = b.queue_stats()
            assert qs["oldest_eval_age_s"] >= 0.05, name
            assert set(qs["oldest_by_queue"]) == {"batch", "service"}
            g = b.metrics.snapshot()["gauges"]
            assert g["broker.oldest_eval_age_s"] >= 0.05, name
            steps = [{k: v for k, v in qs.items()
                      if k not in ("oldest_eval_age_s", "oldest_by_queue")},
                     {k: v for k, v in g.items() if "age" not in k}]
            ev, tok = b.dequeue(["service"], timeout=1.0)
            steps.append(b.queue_stats()["unacked"])
            steps.append(b.queue_stats()["ready_total"])
            b.ack(ev.id, tok)
            steps.append(b.queue_stats()["unacked"])
            ev2, tok2 = b.dequeue(["service"], timeout=1.0)
            b.ack(ev2.id, tok2)
            b.queue_stats()
            # a drained queue's gauge is zeroed, not left stale
            steps.append(b.metrics.snapshot()["gauges"][
                "broker.ready.service"])
            b.shutdown()
            got[name] = steps
        assert got["port"] == got["ref"]
        qs, gauges, unacked, ready, acked, drained = got["port"]
        assert qs["ready"] == {"batch": 1, "service": 2}
        assert qs["ready_total"] == 3 and qs["unacked"] == 0
        assert gauges["broker.ready_depth"] == 3
        assert gauges["broker.ready.service"] == 2
        assert (unacked, ready, acked, drained) == (1, 2, 0, 0)

    def test_delivery_limit_flight_event(self):
        from nomad_tpu import mock as ref_mock

        ev = ref_mock.eval_(type="service")
        got = {}
        for name, pkg, flight, metrics, conv in _pkgs():
            b = _broker(pkg, metrics, nack_timeout=0, delivery_limit=1)
            idx0 = flight.default_flight().last_index()
            b.enqueue(conv(ev))
            out, tok = b.dequeue(["service"], timeout=1.0)
            b.nack(out.id, tok)
            _, evs = flight.default_flight().records_after(
                idx0, types=["broker.eval_failed"])
            mine = [(e["type"], e["key"], e["severity"]) for e in evs
                    if e["key"] == ev.id]
            got[name] = (b.stats["failed"], mine)
            b.shutdown()
        assert got["port"] == got["ref"]
        assert got["port"][0] == 1 and got["port"][1]


class TestPlanApplyInstruments:
    def test_partial_plan_rate_gauge_and_flight(self):
        import importlib

        from nomad_tpu import mock as ref_mock
        from nomad_tpu.structs import Plan as RefPlan

        node = ref_mock.node()
        bad = ref_mock.alloc(node_id="no-such-node")
        got = {}
        for name, pkg, flight, metrics, conv in _pkgs():
            pa = importlib.import_module(f"{pkg.__name__}.server.plan_apply")
            st = importlib.import_module(f"{pkg.__name__}.server.state")
            reg = metrics.MetricsRegistry()
            state = st.StateStore()
            state.upsert_node(conv(node))
            q = pa.PlanQueue(metrics=reg)
            q.set_enabled(True)
            applier = pa.PlanApplier(state, q, metrics=reg)
            idx0 = flight.default_flight().last_index()
            # a placement on a node that is not in the state fails its
            # verification: a partial commit
            plan = conv(RefPlan(eval_id="ev-partial",
                                node_allocation={"no-such-node": [bad]}))
            res = applier.apply(plan)
            assert res.refresh_index > 0, name
            snap = reg.snapshot()
            _, evs = flight.default_flight().records_after(
                idx0, types=["plan.partial"])
            partial = [e["detail"]["n_rejected"] for e in evs
                       if e["key"] == "ev-partial"]
            applier.apply(conv(RefPlan(eval_id="ev-ok",
                                       node_update={node.id: []})))
            got[name] = (snap["gauges"]["plan_apply.partial_rate"],
                         snap["histograms"]["plan_apply.apply_ms"]["count"],
                         partial,
                         reg.snapshot()["gauges"]["plan_apply.partial_rate"])
        assert got["port"] == got["ref"] == (1.0, 1, [1], 0.5)

    def test_queue_depth_gauge(self):
        import importlib

        got = {}
        for name, pkg, _fl, metrics, _conv in _pkgs():
            pa = importlib.import_module(f"{pkg.__name__}.server.plan_apply")
            structs = importlib.import_module(f"{pkg.__name__}.structs")
            reg = metrics.MetricsRegistry()
            q = pa.PlanQueue(metrics=reg)
            q.set_enabled(True)

            def depth():
                return reg.snapshot()["gauges"]["plan_apply.queue_depth"]

            q.enqueue(structs.Plan(eval_id="a"))
            q.enqueue(structs.Plan(eval_id="b"))
            steps = [depth()]
            assert q.dequeue(timeout=1.0) is not None
            steps.append(depth())   # popped but uncommitted: in flight
            q.task_done()
            steps.append(depth())
            q.shutdown()
            steps.append(depth())
            got[name] = steps
        assert got["port"] == got["ref"] == [2, 2, 1, 0]


# ---- replica determinism: apply is a pure function ----


# ---- operator surfaces on a dev agent ----


@pytest.fixture()
def dev_agent(tmp_path):
    from nomad_tpu_torch.agent import Agent, AgentConfig

    a = Agent(AgentConfig(data_dir=str(tmp_path / "data"),
                          heartbeat_ttl=60.0), device="cpu")
    a.start()
    api = NomadClient(a.http_addr[0], a.http_addr[1])
    yield a, api
    a.shutdown()


class TestOperatorFlightEndpoint:
    def test_shape_filter_and_counts(self, dev_agent):
        a, api = dev_agent
        idx0 = default_flight().last_index()
        default_flight().record("plan.partial", key="ep1")
        default_flight().record("heartbeat.expired", key="ep2")
        out = api.operator_flight(index=idx0)
        keys = {e["key"] for e in out["events"]}
        assert {"ep1", "ep2"} <= keys
        assert out["index"] >= idx0 + 2
        assert out["counts"].get("plan.partial", 0) >= 1
        only = api.operator_flight(index=idx0, types=["plan.partial"])
        assert all(e["type"] == "plan.partial" for e in only["events"])

    def test_malformed_args_400(self, dev_agent):
        from nomad_tpu_torch.api import ApiError

        a, api = dev_agent
        with pytest.raises(ApiError) as e:
            api._request("GET", "/v1/operator/flight",
                         params={"index": "nan"})
        assert e.value.code == 400


class TestOperatorDebugEndpoint:
    def test_every_section_present(self, dev_agent):
        a, api = dev_agent
        # give the tracer something to retain
        job = mock.job()
        job.task_groups[0].tasks[0].driver = "mock_driver"
        job.task_groups[0].tasks[0].config = {"run_for": 0.05}
        eid = api.register_job(job)
        assert api.wait_for_eval(eid, timeout=30.0).status == "complete"
        dbg = api.operator_debug()
        missing = [s for s in DEBUG_SECTIONS if s not in dbg]
        assert not missing, missing
        assert dbg["raft"] == {"mode": "single-server"}
        assert dbg["wal"]["appends"] >= 1  # durable dev agent
        assert dbg["eval_traces"], "no eval traces captured"
        assert "nomad_broker_ready_depth" in dbg["prometheus"]
        assert dbg["control"]["plan_apply"]["applied"] >= 1
        # the events section is live, not a stub: the job lifecycle
        # above emitted FSM-sourced events into the broker ring
        assert dbg["events"]["stats"]["last_index"] >= 1
        assert dbg["events"]["recent"], "no events captured"
        topics = {e["topic"] for e in dbg["events"]["recent"]}
        assert topics <= {"Job", "Eval", "Alloc", "Deployment",
                          "Node", "Plan"}


# ---- the acceptance e2e: 3-server cluster + operator debug bundle ----


class _Facade:
    """HTTPApi agent shim over a bare ClusterServer (the multiregion
    test idiom, with `server` live so leadership regain is visible)."""

    def __init__(self, cluster):
        self.cluster = cluster
        self.client = None

    @property
    def server(self):
        return self.cluster.server

    def self_info(self):
        return {"version": "test", "server": True, "client": False,
                "node_id": self.cluster.config.node_id}


def _make_cluster(n=3):
    from nomad_tpu_torch.agent.http import HTTPApi
    from nomad_tpu_torch.server.cluster import (ClusterServer,
                                          ClusterServerConfig)

    configs = [ClusterServerConfig(node_id=f"s{i}", num_schedulers=1,
                                   heartbeat_ttl=60.0, gc_interval=3600.0)
               for i in range(n)]
    agents, peers = [], {}
    for cfg in configs:
        a = ClusterServer(cfg, device="cpu")
        peers[cfg.node_id] = a.addr
        agents.append(a)
    for a in agents:
        a.peers.clear()
        a.peers.update(peers)
        a.raft.peers = dict(peers)
    apis = []
    for a in agents:
        a.start()
    for a in agents:
        api = HTTPApi(_Facade(a), "127.0.0.1", 0)
        api.start()  # advertises http_addr through gossip
        apis.append(api)
    return agents, apis


def _leader_of(agents):
    for a in agents:
        if a.is_leader():
            return a
    return None


@pytest.fixture()
def cluster3():
    agents, apis = _make_cluster(3)
    yield agents, apis
    for api in apis:
        api.shutdown()
    for a in agents:
        a.shutdown()


def _cli(main, *argv):
    """(rc, stdout, stderr) of one CLI call in this process."""
    import io
    import sys as _sys

    out, err = io.StringIO(), io.StringIO()
    old = _sys.stdout, _sys.stderr
    _sys.stdout, _sys.stderr = out, err
    try:
        rc = main(list(argv))
    finally:
        _sys.stdout, _sys.stderr = old
    return rc, out.getvalue(), err.getvalue()


class TestOperatorDebugCluster:
    def test_bundle_captures_all_servers_and_failover(self, cluster3,
                                                      tmp_path):
        from nomad_tpu_torch.cli import main as cli_main

        agents, apis = cluster3
        assert _wait(lambda: _leader_of(agents) is not None)
        old = _leader_of(agents)
        assert _wait(lambda: old.server._running)
        idx0 = default_flight().last_index()
        # replicated traffic so raft commit/apply histograms populate
        old.call("node_register", mock.node())
        job = mock.job()
        job.task_groups[0].count = 2
        ev = old.call("job_register", job)
        assert old.server.wait_for_eval(ev.id, timeout=20.0) is not None

        # force a leadership TRANSITION with all three servers alive:
        # nudge a caught-up follower into an early election (the
        # protocol's own path, just without waiting out the timeout) —
        # its higher term makes the old leader step down
        def transitioned():
            cur = _leader_of(agents)
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
        new = _leader_of(agents)

        # the transition is visible live: flight stream...
        _, evs = default_flight().records_after(idx0)
        types_by_source = {}
        for e in evs:
            types_by_source.setdefault(e["type"], set()).add(e["source"])
        assert new.config.node_id \
            in types_by_source.get("leadership.gained", set())
        assert old.config.node_id \
            in types_by_source.get("leadership.lost", set())
        # ...and raft metrics
        assert new.raft.metrics.counter(
            "raft.leadership_gained").value >= 1
        assert old.raft.metrics.counter(
            "raft.leadership_lost").value >= 1
        assert new.raft.metrics.gauge("raft.term").value >= 2

        # `operator debug` against ONE agent captures ALL THREE servers
        # — discovered through gossip, so wait until the addressed
        # agent's member table carries every server's http_addr tag
        # (tag propagation rides the periodic gossip exchange)
        host, port = apis[0].addr[0], apis[0].addr[1]
        api0 = NomadClient(host, port)

        def members_converged():
            ms = api0._request("GET", "/v1/agent/members") \
                .get("members", [])
            tagged = [m for m in ms
                      if (m.get("tags") or {}).get("http_addr")
                      and m.get("status") == "alive"]
            return len(tagged) >= 3

        assert _wait(members_converged, timeout=45.0), \
            "gossip never propagated all http_addr tags"
        out_path = str(tmp_path / "bundle.tar.gz")
        rc = cli_main(["-address", f"{host}:{port}",
                       "operator", "debug", "-output", out_path])
        assert rc == 0
        with tarfile.open(out_path) as tar:
            names = set(tar.getnames())
            payload = {}
            # bundle dirs carry the FULL member name (<node>.<region>)
            # so federated same-node-id servers can never collide
            for sid in ("s0", "s1", "s2"):
                member = f"{sid}.global"
                for section in DEBUG_SECTIONS:
                    fname = (f"server-{member}/prometheus.prom"
                             if section == "prometheus"
                             else f"server-{member}/{section}.json")
                    assert fname in names, f"missing {fname}"
                raft_blob = tar.extractfile(
                    f"server-{member}/raft.json").read()
                flight_blob = tar.extractfile(
                    f"server-{member}/flight.json").read()
                payload[sid] = (json.loads(raft_blob),
                                json.loads(flight_blob))
        # leadership transition visible IN THE BUNDLE: raft metrics...
        new_raft, _ = payload[new.config.node_id]
        old_raft, old_flight = payload[old.config.node_id]
        assert new_raft["status"]["state"] == "leader"
        assert new_raft["metrics"]["counters"][
            "raft.leadership_gained"] >= 1
        assert old_raft["status"]["state"] == "follower"
        assert old_raft["metrics"]["counters"][
            "raft.leadership_lost"] >= 1
        leaders = [sid for sid, (r, _f) in payload.items()
                   if r["status"]["state"] == "leader"]
        assert leaders == [new.config.node_id]
        # ...and the flight stream captured in the bundle
        ftypes = {e["type"]: e for e in old_flight["events"]}
        assert "leadership.gained" in ftypes
        assert "leadership.lost" in ftypes

    def test_cli_robustness_exit_one(self, tmp_path):
        """`operator debug` / `operator flight` against an unreachable
        agent or with malformed arguments: exit 1 with a one-line error,
        never a traceback — the same lines from both packages' CLIs."""
        from nomad_tpu.cli import main as ref_main

        from nomad_tpu_torch.cli import main as port_main

        for argv in (("operator", "flight"),
                     ("operator", "debug", "-output",
                      str(tmp_path / "b.tar.gz")),
                     ("operator", "flight", "-wait", "-1"),
                     ("operator", "flight", "-index", "-5")):
            got = {name: _cli(main, "-address", "127.0.0.1:1", *argv)
                   for name, main in (("ref", ref_main),
                                      ("port", port_main))}
            rc, out, err = got["port"]
            assert rc == 1, argv
            assert err.startswith("Error:"), (argv, err)
            assert "Traceback" not in err, argv
            assert got["port"] == got["ref"], argv

    def test_cli_debug_unwritable_output_exit_one(self, dev_agent,
                                                  tmp_path):
        from nomad_tpu_torch.cli import main as cli_main

        a, api = dev_agent
        addr = f"{a.http_addr[0]}:{a.http_addr[1]}"
        rc, _out, err = _cli(cli_main, "-address", addr, "operator",
                             "debug", "-output",
                             str(tmp_path / "no-such-dir" / "b.tar.gz"))
        assert rc == 1
        assert err.startswith("Error:")
        assert "Traceback" not in err

    def test_follower_debug_endpoint_reports_itself(self, cluster3):
        agents, apis = cluster3
        assert _wait(lambda: _leader_of(agents) is not None)
        leader = _leader_of(agents)
        fidx = next(i for i, a in enumerate(agents) if a is not leader)
        api = NomadClient(apis[fidx].addr[0], apis[fidx].addr[1])
        dbg = api.operator_debug()
        assert dbg["server"]["node_id"] == agents[fidx].config.node_id
        assert dbg["server"]["leader"] is False
        assert dbg["raft"]["status"]["state"] in ("follower", "candidate")
        assert dbg["wal"]["mode"] == "raft-journal"
        missing = [s for s in DEBUG_SECTIONS if s not in dbg]
        assert not missing, missing
