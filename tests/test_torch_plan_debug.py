"""Twins of the reference's `tests/test_plan_debug.py` (job plan diffs and
the debug surfaces), run on the port: every agent, server and harness is
the port's with `device="cpu"`, its HTTP port ephemeral and its data
under `tmp_path`; the reference's `slow` marks are kept.
"""
import tarfile
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.agent import Agent, AgentConfig
from nomad_tpu_torch.api import NomadClient
from torch_chain_cases import one_torch_thread  # noqa: F401


def _wait(cond, timeout=15.0, every=0.05):
    dl = time.time() + timeout
    while time.time() < dl:
        if cond():
            return True
        time.sleep(every)
    return cond()


@pytest.fixture()
def agent():
    a = Agent(AgentConfig(client=False, heartbeat_ttl=60.0), device="cpu")
    a.start()
    yield a, NomadClient(*a.http_addr)
    a.shutdown()


class TestPlanDiff:
    def test_new_job_diff_is_added(self, agent):
        a, api = agent
        out = api.plan_job(mock.job())
        assert out["diff"]["type"] == "Added"
        assert out["diff"]["groups"][0]["type"] == "Added"

    def test_edited_job_diff_shows_fields(self, agent):
        import copy

        a, api = agent
        job = mock.job()
        a.server.job_register(job)
        mod = copy.deepcopy(job)
        mod.priority = 80
        mod.task_groups[0].count = 3
        mod.task_groups[0].tasks[0].resources.memory_mb += 64
        out = api.plan_job(mod)
        d = out["diff"]
        assert d["type"] == "Edited"
        assert any(f["name"] == "priority" and f["new"] == 80
                   for f in d["fields"])
        g = next(g for g in d["groups"] if g["name"] == "web")
        assert any(f["name"] == "count" and f["new"] == 3
                   for f in g["fields"])
        t = g["tasks"][0]
        assert any(f["name"] == "resources.memory_mb"
                   for f in t["fields"])

    def test_identical_spec_diff_none(self, agent):
        import copy

        a, api = agent
        job = mock.job()
        a.server.job_register(job)
        out = api.plan_job(copy.deepcopy(job))
        assert out["diff"]["type"] == "None"


class TestPprofDebug:
    def test_pprof_thread_dump(self, agent):
        a, api = agent
        out = api._request("GET", "/v1/agent/pprof")
        assert out["count"] >= 1
        names = [t["thread"] for t in out["threads"]]
        assert any("MainThread" in n or "http" in n for n in names)
        assert all(t["stack"] for t in out["threads"])

    def test_operator_debug_bundle(self, agent, tmp_path, monkeypatch,
                                   capsys):
        import os

        from nomad_tpu_torch.cli import main

        a, api = agent
        a.server.node_register(mock.node())
        out_file = str(tmp_path / "bundle.tar.gz")
        host, port = a.http_addr
        monkeypatch.setenv("NOMAD_ADDR", f"http://{host}:{port}")
        rc = main(["operator", "debug", "-output", out_file])
        assert rc == 0
        with tarfile.open(out_file) as tar:
            names = tar.getnames()
            assert "nodes.json" in names
            assert "pprof-threads.json" in names
            assert "agent-self.json" in names
            nodes = tar.extractfile("nodes.json").read()
            assert b"data" in nodes
