"""The port's agent, HTTP API and CLI held against the JAX package on
the CPU.

- State carried across. A reference agent takes jobs, a namespace, an ACL
  policy and token, a secret and a node drain through its HTTP API (the
  tables the port's codec repair touched among them), and the reference
  CLI's `operator snapshot save` writes its state. The port's agent
  (`device="cpu"`) restores it twice: through the port CLI's `operator
  snapshot restore`, and by starting on a copy of the reference agent's
  data directory. Both give the reference's `state_fingerprint` and the
  same `GET /v1/jobs`, `/v1/allocations` and `/v1/nodes` answers, ids
  included.
- The slice against the reference. One synthetic cluster, made from one
  seed by each package's `synth.py`, goes into a reference agent's and a
  port agent's server before their clients start; the same HCL jobs then
  go through each package's own `cli.main`: `job plan`, `job run`,
  `eval placement` and `job status`. Both give the same placements (each
  alloc name on the same node id), the same failed groups and plan
  diffs, and explain's top-K with the same node ids and scores within
  1e-6. The agents' own client nodes sit in a datacenter no job names,
  so no placement depends on their server-minted node ids.
"""
import json
import random
import re
import shutil
import time
import urllib.request

import pytest

from torch_chain_cases import one_torch_thread  # noqa: F401

ATOL = 1e-6


def _wait(cond, timeout=30.0, every=0.05):
    dl = time.time() + timeout
    while time.time() < dl:
        if cond():
            return True
        time.sleep(every)
    return cond()


def _address(agent):
    return f"http://{agent.http_addr[0]}:{agent.http_addr[1]}"


def _get(agent, path, token=None):
    req = urllib.request.Request(_address(agent) + path)
    if token:
        req.add_header("X-Nomad-Token", token)
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _cli(main, agent, capsys, *argv):
    """One in-process CLI call: (exit code, stdout, stderr)."""
    capsys.readouterr()
    rc = main(["-address", _address(agent), *argv])
    out = capsys.readouterr()
    return rc, out.out, out.err


# ---- state carried across ---------------------------------------------------


#: every namespace's jobs and allocs, and the nodes
_CARRIED = ("/v1/jobs?namespace=*", "/v1/allocations?namespace=*",
            "/v1/nodes")


def _reference_state(tmp_path, capsys, monkeypatch):
    """Drive a reference agent, save its snapshot through the reference
    CLI, shut it down. Returns (snapshot path, data dir, management
    token, fingerprint, GET answers)."""
    from nomad_tpu import cli as ref_cli
    from nomad_tpu import mock
    from nomad_tpu.agent import Agent, AgentConfig
    from nomad_tpu.api import NomadClient
    from nomad_tpu.server.fsm import state_fingerprint
    from nomad_tpu.structs.node import DrainStrategy

    data = tmp_path / "ref"
    ref = Agent(AgentConfig(client=False, acl_enabled=True,
                            data_dir=str(data), heartbeat_ttl=3600.0))
    ref.start()
    try:
        api = NomadClient(ref.http_addr[0], ref.http_addr[1])
        token = api.acl_bootstrap().secret_id
        api = NomadClient(ref.http_addr[0], ref.http_addr[1], token=token)
        nodes = [mock.node() for _ in range(4)]
        for n in nodes:
            ref.server.node_register(n)
        api.namespace_apply("team-a", description="carried across")
        api.acl_upsert_policy("readonly",
                              'namespace "default" { policy = "read" }')
        api.acl_create_token(name="ro", policies=["readonly"])
        api.secret_put("db/creds", {"user": "app", "pass": "x"})
        # the drained node holds no alloc, so its drain ends at once
        api.drain_node(nodes[3].id, DrainStrategy(deadline_s=60.0))
        assert _wait(lambda: api.node(nodes[3].id).drain is None)
        for ns, count in (("default", 3), ("team-a", 2)):
            job = mock.job()
            job.namespace = ns
            tg = job.task_groups[0]
            tg.count = count
            tg.tasks[0].driver = "mock_driver"
            tg.tasks[0].config = {"run_for": 300}
            ev = api.wait_for_eval(api.register_job(job), timeout=30.0)
            assert ev is not None and ev.status == "complete", ev
        snap = tmp_path / "ref.snap"
        monkeypatch.setenv("NOMAD_TOKEN", token)
        rc, out, err = _cli(ref_cli.main, ref, capsys, "operator",
                            "snapshot", "save", str(snap))
        assert rc == 0, err
        fingerprint = state_fingerprint(ref.server.state)
        answers = {p: _get(ref, p, token) for p in _CARRIED}
    finally:
        ref.shutdown()
    assert len(answers[_CARRIED[1]]["data"]) == 5, answers[_CARRIED[1]]
    assert len(answers[_CARRIED[2]]["data"]) == 4
    return snap, data, token, fingerprint, answers


def test_port_agent_restores_a_reference_agents_state(tmp_path, capsys,
                                                      monkeypatch):
    from nomad_tpu_torch import cli as port_cli
    from nomad_tpu_torch.agent import Agent, AgentConfig
    from nomad_tpu_torch.server.fsm import state_fingerprint

    snap, data, token, fingerprint, answers = _reference_state(
        tmp_path, capsys, monkeypatch)
    copy = tmp_path / "copy"
    shutil.copytree(data, copy)

    # through the port CLI's snapshot restore, into a fresh agent. A
    # restore adds to what the store holds, as the reference's does, so
    # the fresh agent enforces no ACLs: a bootstrap token of its own
    # would stay beside the restored ones
    fresh = Agent(AgentConfig(client=False, data_dir=str(tmp_path / "fresh"),
                              heartbeat_ttl=3600.0), device="cpu")
    fresh.start()
    try:
        rc, out, err = _cli(port_cli.main, fresh, capsys, "operator",
                            "snapshot", "restore", str(snap))
        assert rc == 0, err
        assert state_fingerprint(fresh.server.state) == fingerprint
        for path in _CARRIED:
            assert _get(fresh, path, token) == answers[path], path
    finally:
        fresh.shutdown()

    # by starting on a copy of the reference agent's data directory, with
    # ACLs on: the reference's management token is the port's now
    started = Agent(AgentConfig(client=False, acl_enabled=True,
                                data_dir=str(copy), heartbeat_ttl=3600.0),
                    device="cpu")
    started.start()
    try:
        assert state_fingerprint(started.server.state) == fingerprint
        for path in _CARRIED:
            assert _get(started, path, token) == answers[path], path
        # without a token the job list is not the reference's answer
        assert _get(started, _CARRIED[0]) != answers[_CARRIED[0]]
    finally:
        started.shutdown()


# ---- the slice against the reference ----------------------------------------


N_NODES, N_ALLOCS, SEED = 24, 48, 16

#: service jobs over the synthetic datacenters, and one that cannot fit;
#: the synthetic nodes run exec, and no client runs their allocs
_JOBS = {
    "web": """
job "web" {
  datacenters = ["dc1", "dc2", "dc3"]
  group "app" {
    count = 5
    task "t" {
      driver = "exec"
      config { command = "/bin/true" }
      resources {
        cpu    = 700
        memory = 512
      }
    }
  }
}
""",
    # one alloc on every dc2 node: the cluster, not a server-minted
    # value, decides the set of nodes
    "spread": """
job "spread" {
  datacenters = ["dc2"]
  constraint { operator = "distinct_hosts" }
  group "app" {
    count = %d
    task "t" {
      driver = "exec"
      config { command = "/bin/true" }
      resources {
        cpu    = 100
        memory = 64
      }
    }
  }
}
""" % (N_NODES // 3),
    "huge": """
job "huge" {
  datacenters = ["dc1"]
  group "app" {
    count = 2
    task "t" {
      driver = "exec"
      config { command = "/bin/true" }
      resources {
        cpu    = 9000000
        memory = 64
      }
    }
  }
}
""",
}

#: a second version of "web" for `job plan`
_WEB_V2 = _JOBS["web"].replace("count = 5", "count = 7").replace(
    "cpu    = 700", "cpu    = 900")

_IDS = re.compile(r"\b[0-9a-f]{8}(?:-[0-9a-f]{4}){3}-[0-9a-f]{12}\b"
                  r"|\b[0-9a-f]{8}\b")


class _Side:
    """One package's agent with the synthetic cluster, and its CLI."""

    def __init__(self, pkg, tmp_path):
        import importlib

        mod = lambda m: importlib.import_module(f"{pkg}.{m}")  # noqa: E731
        agent_mod, synth = mod("agent"), mod("synth")
        self.cli = mod("cli").main
        self.NomadClient = mod("api").NomadClient
        kw = {"device": "cpu"} if pkg == "nomad_tpu_torch" else {}
        self.agent = agent_mod.Agent(agent_mod.AgentConfig(
            data_dir=str(tmp_path / pkg), heartbeat_ttl=3600.0,
            datacenter="agent-dc"), **kw)
        state = self.agent.server.state
        rng = random.Random(SEED)
        nodes = [synth.synth_node(rng, i) for i in range(N_NODES)]
        for n in nodes:
            state.upsert_node(n)
        filler = synth.synth_service_job(rng, count=4)
        state.upsert_job(filler)
        for _ in range(N_ALLOCS):
            state.upsert_alloc(synth.synth_alloc(
                rng, nodes[rng.randrange(N_NODES)], filler))
        self.node_ids = {n.id for n in nodes}
        self.agent.start()
        self.api = self.NomadClient(self.agent.http_addr[0],
                                    self.agent.http_addr[1])
        assert _wait(lambda: len(self.api.nodes()) == N_NODES + 1)

    def run(self, capsys, *argv):
        return _cli(self.cli, self.agent, capsys, *argv)

    def placements(self, job_id):
        return {a.name: a.node_id for a in self.api.job_allocations(job_id)}

    def last_eval(self, job_id):
        evs = [e for e in self.api.job_evaluations(job_id)
               if e.triggered_by == "job-register"]
        assert len(evs) == 1, evs
        return evs[0]


def _metric(m):
    return {"evaluated": m.nodes_evaluated, "filtered": m.nodes_filtered,
            "exhausted": m.nodes_exhausted,
            "classes_filtered": dict(m.class_filtered or {}),
            "constraint_filtered": dict(m.constraint_filtered or {}),
            "classes_exhausted": dict(m.class_exhausted or {}),
            "dimension_exhausted": dict(m.dimension_exhausted or {}),
            "nodes_available": dict(m.nodes_available or {}),
            "quota_exhausted": list(m.quota_exhausted or [])}


def _top_k(m):
    return [(s.node_id, s.norm_score, dict(s.scores)) for s in m.score_meta]


def _assert_top_k_equal(ref, got, what):
    assert [n for n, _, _ in ref] == [n for n, _, _ in got], what
    for (_, rs, rparts), (_, gs, gparts) in zip(ref, got):
        assert abs(rs - gs) <= ATOL, (what, rs, gs)
        assert set(rparts) == set(gparts), what
        for k in rparts:
            assert abs(rparts[k] - gparts[k]) <= ATOL, (what, k)


@pytest.fixture()
def both(tmp_path):
    sides = {}
    try:
        for pkg in ("nomad_tpu", "nomad_tpu_torch"):
            sides[pkg] = _Side(pkg, tmp_path)
        yield sides["nomad_tpu"], sides["nomad_tpu_torch"]
    finally:
        for s in sides.values():
            s.agent.shutdown()


def test_cli_drives_both_packages_to_equal_placements(both, tmp_path,
                                                      capsys):
    ref, port = both
    specs = {}
    for name, text in {**_JOBS, "web-v2": _WEB_V2}.items():
        specs[name] = tmp_path / f"{name}.nomad"
        specs[name].write_text(text)

    for name in ("web", "spread", "huge"):
        # job plan before the job exists: every placement is new
        outs = [s.run(capsys, "job", "plan", str(specs[name]))
                for s in (ref, port)]
        assert outs[0][0] == outs[1][0] == 0, outs
        assert outs[0][1] == outs[1][1], name
        outs = [s.run(capsys, "job", "run", str(specs[name]))
                for s in (ref, port)]
        assert outs[0][0] == outs[1][0], outs
        assert _IDS.sub("<id>", outs[0][1]) == _IDS.sub("<id>", outs[1][1])

    for name in ("web", "spread", "huge"):
        placed = ref.placements(name)
        assert placed == port.placements(name), name
        assert set(placed.values()) <= ref.node_ids
    assert len(ref.placements("web")) == 5
    assert sorted(ref.placements("spread").values()) == sorted(
        n.id for n in ref.api.nodes() if n.datacenter == "dc2")
    assert ref.placements("huge") == {}

    # failed groups, through the API and explain
    evs = {name: (ref.last_eval(name), port.last_eval(name))
           for name in _JOBS}
    for name, (r, p) in evs.items():
        assert set(r.failed_tg_allocs or {}) == set(p.failed_tg_allocs or {})
        for tg, m in (r.failed_tg_allocs or {}).items():
            assert _metric(m) == _metric(p.failed_tg_allocs[tg]), (name, tg)
    assert set(evs["huge"][0].failed_tg_allocs) == {"app"}

    # explain: top-K node ids equal, scores within 1e-6, per alloc name
    for name, (r, p) in evs.items():
        rx, px = (s.api.evaluation_placement(e.id)
                  for s, e in ((ref, r), (port, p)))
        names = [{a.id: a.name for a in s.api.job_allocations(name)}
                 for s in (ref, port)]
        rp = {names[0][x["alloc_id"]]: x for x in rx.get("placements") or []}
        pp = {names[1][x["alloc_id"]]: x for x in px.get("placements") or []}
        assert set(rp) == set(pp) == set(ref.placements(name)), name
        for alloc_name in rp:
            assert rp[alloc_name]["node_id"] == pp[alloc_name]["node_id"]
            rm, pm = rp[alloc_name]["metrics"], pp[alloc_name]["metrics"]
            assert _metric(rm) == _metric(pm), alloc_name
            assert rm.score_meta, alloc_name
            _assert_top_k_equal(_top_k(rm), _top_k(pm), alloc_name)
        outs = [s.run(capsys, "eval", "placement", e.id, "-verbose")
                for s, e in ((ref, r), (port, p))]
        assert outs[0][0] == outs[1][0] == 0, outs
        assert _IDS.sub("<id>", outs[0][1]) == _IDS.sub("<id>", outs[1][1])

    # job plan of a changed job: the same diff and the same counts
    outs = [s.run(capsys, "job", "plan", str(specs["web-v2"]))
            for s in (ref, port)]
    assert outs[0][0] == outs[1][0] == 0, outs
    assert outs[0][1] == outs[1][1]
    assert "~ count: 5 => 7" in outs[0][1]
    from nomad_tpu.jobspec import parse_file as ref_parse
    from nomad_tpu_torch.jobspec import parse_file as port_parse

    rplan = ref.api.plan_job(ref_parse(str(specs["web-v2"])))
    pplan = port.api.plan_job(port_parse(str(specs["web-v2"])))
    assert rplan == pplan

    # job status: the same table, alloc ids aside
    for name in _JOBS:
        outs = [s.run(capsys, "job", "status", name) for s in (ref, port)]
        assert outs[0][0] == outs[1][0] == 0, outs
        assert _IDS.sub("<id>", outs[0][1]) == _IDS.sub("<id>", outs[1][1])
