"""Twins of the reference's `tests/test_scaling.py` (job scaling over the
HTTP API and the CLI), run on the port: every agent, server and harness
is the port's with `device="cpu"`, its HTTP port ephemeral and its data
under `tmp_path`; the reference's `slow` marks are kept.
"""
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.agent import Agent, AgentConfig
from nomad_tpu_torch.api import ApiError, NomadClient
from nomad_tpu_torch.structs.job import ScalingPolicy
from torch_chain_cases import one_torch_thread  # noqa: F401


def _wait(cond, timeout=40.0, every=0.05):
    dl = time.time() + timeout
    while time.time() < dl:
        if cond():
            return True
        time.sleep(every)
    return cond()


@pytest.fixture()
def agent(tmp_path):
    a = Agent(AgentConfig(data_dir=str(tmp_path / "data"),
                          heartbeat_ttl=60.0), device="cpu")
    a.start()
    api = NomadClient(a.http_addr[0], a.http_addr[1])
    assert _wait(lambda: len(api.nodes()) == 1)
    yield a, api
    a.shutdown()


def _scalable_job(count=1, minimum=1, maximum=5):
    job = mock.job()
    tg = job.task_groups[0]
    tg.count = count
    t = tg.tasks[0]
    t.driver = "mock_driver"
    t.config = {"run_for": 30.0}
    job.scaling_policies = [ScalingPolicy(
        target={"Group": tg.name}, min=minimum, max=maximum, enabled=True)]
    return job


class TestJobScale:
    def test_scale_up_creates_eval_and_allocs(self, agent):
        a, api = agent
        job = _scalable_job(count=1)
        api.wait_for_eval(api.register_job(job))
        eval_id = api.job_scale(job.id, job.task_groups[0].name, 3)
        assert eval_id
        ev = api.wait_for_eval(eval_id)
        assert ev.status == "complete"
        assert ev.triggered_by == "job-scaling"
        got = api.job(job.id)
        assert got.task_groups[0].count == 3
        assert _wait(lambda: len([al for al in api.job_allocations(job.id)
                                  if al.client_status == "running"]) == 3)

    def test_scale_outside_policy_bounds_rejected(self, agent):
        a, api = agent
        job = _scalable_job(count=1, minimum=1, maximum=3)
        api.wait_for_eval(api.register_job(job))
        with pytest.raises(ApiError) as ei:
            api.job_scale(job.id, job.task_groups[0].name, 10)
        assert ei.value.code == 400
        assert api.job(job.id).task_groups[0].count == 1

    def test_scale_unknown_group_rejected(self, agent):
        a, api = agent
        job = _scalable_job()
        api.wait_for_eval(api.register_job(job))
        with pytest.raises(ApiError) as ei:
            api.job_scale(job.id, "nope", 2)
        assert ei.value.code == 400

    def test_scale_status_counts_and_events(self, agent):
        a, api = agent
        job = _scalable_job(count=2)
        api.wait_for_eval(api.register_job(job))
        api.wait_for_eval(api.job_scale(
            job.id, job.task_groups[0].name, 3, message="more"))
        st = api.job_scale_status(job.id)
        g = st["TaskGroups"][job.task_groups[0].name]
        assert g["Desired"] == 3
        assert _wait(lambda: api.job_scale_status(job.id)["TaskGroups"][
            job.task_groups[0].name]["Placed"] == 3)
        assert g["Events"] and g["Events"][-1]["Count"] == 3
        assert g["Events"][-1]["PreviousCount"] == 2
        assert g["Events"][-1]["Message"] == "more"

    def test_scaling_policies_listing(self, agent):
        a, api = agent
        job = _scalable_job(minimum=1, maximum=7)
        api.wait_for_eval(api.register_job(job))
        pols = api.scaling_policies()
        assert len(pols) == 1
        sp = pols[0]
        assert sp.id  # server-assigned
        assert sp.max == 7
        assert sp.target["Job"] == job.id
        got = api.scaling_policy(sp.id)
        assert got.id == sp.id
        with pytest.raises(ApiError):
            api.scaling_policy("nope")


class TestScalingHcl:
    def test_scaling_stanza_parses(self):
        from nomad_tpu_torch.jobspec import parse as parse_hcl_job

        spec = """
        job "web" {
          group "api" {
            count = 2
            scaling {
              min = 1
              max = 10
              enabled = true
              policy {
                cooldown = "1m"
              }
            }
            task "t" { driver = "mock_driver" }
          }
        }
        """
        job = parse_hcl_job(spec)
        assert len(job.scaling_policies) == 1
        sp = job.scaling_policies[0]
        assert sp.min == 1 and sp.max == 10 and sp.enabled
        assert sp.target["Group"] == "api"
        assert sp.policy.get("cooldown") == "1m"


class TestScaleCli:
    def test_cli_job_scale(self, agent, capsys):
        from nomad_tpu_torch.cli import main

        a, api = agent
        job = _scalable_job(count=1)
        api.wait_for_eval(api.register_job(job))
        addr = a.http_addr
        rc = main(["-address", f"http://{addr[0]}:{addr[1]}",
                   "job", "scale", job.id, "2", "-detach"])
        out = capsys.readouterr().out
        assert rc == 0, out
        assert "Scaled group" in out
        assert api.job(job.id).task_groups[0].count == 2
