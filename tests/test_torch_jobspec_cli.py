"""Twins of the reference's `tests/test_jobspec_cli.py` (the jobspec parser
and the CLI), run on the port: every agent, server and harness is the
port's with `device="cpu"`, its HTTP port ephemeral and its data under
`tmp_path`; the reference's `slow` marks are kept.
"""
import io
import sys
import time

import pytest

from nomad_tpu_torch.jobspec import HclError, parse, parse_hcl
from torch_chain_cases import one_torch_thread  # noqa: F401

SPEC = '''
job "example" {
  datacenters = ["dc1"]
  type = "service"
  priority = 60

  constraint {
    attribute = "${attr.kernel.name}"
    value     = "linux"
  }

  update {
    max_parallel = 2
    canary       = 1
    auto_revert  = true
  }

  group "cache" {
    count = 2

    restart {
      attempts = 2
      interval = "30m"
      delay    = "15s"
      mode     = "fail"
    }

    network {
      port "db" {}
      port "admin" { static = 8080 }
    }

    task "redis" {
      driver = "mock_driver"
      config {
        run_for = 0.1
      }
      env {
        CACHE_SIZE = "128"
      }
      resources {
        cpu    = 200
        memory = 128
      }
    }
  }
}
'''


class TestHcl:
    def test_scalars_and_types(self):
        tree = parse_hcl('a = 1\nb = "x"\nc = true\nd = 1.5\ne = [1, 2]\n')
        assert tree == {"a": 1, "b": "x", "c": True, "d": 1.5, "e": [1, 2]}

    def test_nested_blocks_accumulate(self):
        tree = parse_hcl('blk "x" { v = 1 }\nblk "y" { v = 2 }')
        assert tree["blk"] == [{"x": {"v": 1}}, {"y": {"v": 2}}]

    def test_comments(self):
        tree = parse_hcl('# c1\n// c2\n/* c3\nmultiline */\na = 1')
        assert tree == {"a": 1}

    def test_heredoc(self):
        tree = parse_hcl('data = <<EOF\nline1\nline2\nEOF\nafter = 1')
        assert tree["data"] == "line1\nline2\n"
        assert tree["after"] == 1

    def test_heredoc_tag_prefix_line_not_terminator(self):
        # a body line STARTING with the tag must not end the heredoc
        tree = parse_hcl('cmd = <<SH\nexport SHELL=1\nSHOW=2\nSH\nx = 1')
        assert tree["cmd"] == "export SHELL=1\nSHOW=2\n"
        assert tree["x"] == 1

    def test_string_escapes(self):
        tree = parse_hcl(r'a = "quote \" and \\ and \n"')
        assert tree["a"] == 'quote " and \\ and \n'

    def test_errors(self):
        with pytest.raises(HclError):
            parse_hcl('a = ')
        with pytest.raises(HclError):
            parse_hcl('blk { a = 1 ')


class TestJobspec:
    def test_full_spec(self):
        job = parse(SPEC)
        assert job.id == "example" and job.priority == 60
        assert job.constraints[0].ltarget == "${attr.kernel.name}"
        assert job.update.canary == 1 and job.update.auto_revert
        tg = job.task_groups[0]
        assert tg.name == "cache" and tg.count == 2
        assert tg.restart_policy.interval_s == 1800.0
        net = tg.networks[0]
        assert [p.label for p in net.dynamic_ports] == ["db"]
        assert net.reserved_ports[0].value == 8080
        task = tg.tasks[0]
        assert task.driver == "mock_driver"
        assert task.config["run_for"] == 0.1
        assert task.env["CACHE_SIZE"] == "128"
        assert task.resources.cpu == 200

    def test_missing_job_block(self):
        with pytest.raises(HclError):
            parse("group \"g\" { }")

    def test_spec_runs_through_scheduler(self):
        """Parsed spec → registered → placed (jobspec→structs fidelity)."""
        from nomad_tpu_torch import mock
        from nomad_tpu_torch.server import Server, ServerConfig

        s = Server(ServerConfig(num_schedulers=1, heartbeat_ttl=60.0), device="cpu")
        s.start()
        try:
            # Two nodes: the group asks static port 8080, so its two allocs
            # cannot share one host (rank.go:231-320 port feasibility).
            s.node_register(mock.node())
            s.node_register(mock.node())
            job = parse(SPEC)
            ev = s.job_register(job)
            done = s.wait_for_eval(ev.id)
            assert done.status == "complete"
            allocs = s.state.allocs_by_job("default", "example")
            assert len(allocs) == 2
            assert len({a.node_id for a in allocs}) == 2
        finally:
            s.shutdown()


@pytest.fixture()
def cli_agent(tmp_path):
    from nomad_tpu_torch.agent import Agent, AgentConfig

    a = Agent(AgentConfig(data_dir=str(tmp_path / "d"), heartbeat_ttl=60.0), device="cpu")
    a.start()
    host, port = a.http_addr
    yield a, f"{host}:{port}"
    a.shutdown()


def _run_cli(addr, *argv):
    from nomad_tpu_torch.cli import main

    buf = io.StringIO()
    old = sys.stdout
    sys.stdout = buf
    try:
        rc = main(["-address", addr, *argv])
    finally:
        sys.stdout = old
    return rc, buf.getvalue()


class TestCli:
    def test_job_run_and_status(self, cli_agent, tmp_path):
        a, addr = cli_agent
        spec = tmp_path / "example.nomad"
        spec.write_text(SPEC)
        rc, out = _run_cli(addr, "job", "run", str(spec))
        assert rc == 0, out
        assert "registered" in out and "complete" in out
        rc, out = _run_cli(addr, "job", "status", "example")
        assert rc == 0
        assert "example" in out and "cache" in out
        rc, out = _run_cli(addr, "job", "status")
        assert "example" in out

    @pytest.mark.slow  # >10s on a cold host; tier-1 budget
    def test_node_and_eval_and_alloc_status(self, cli_agent, tmp_path):
        a, addr = cli_agent
        spec = tmp_path / "example.nomad"
        spec.write_text(SPEC)
        _run_cli(addr, "job", "run", str(spec))
        rc, out = _run_cli(addr, "node", "status")
        assert rc == 0 and "ready" in out
        node_id = a.client.node.id
        rc, out = _run_cli(addr, "node", "status", node_id[:8])
        assert rc == 0 and node_id in out
        from nomad_tpu_torch.api import NomadClient

        api = NomadClient(*a.http_addr)
        alloc = api.job_allocations("example")[0]
        rc, out = _run_cli(addr, "alloc", "status", alloc.id[:8])
        assert rc == 0 and alloc.id in out
        ev = api.job_evaluations("example")[0]
        rc, out = _run_cli(addr, "eval", "status", ev.id)
        assert rc == 0 and ev.id in out

    @pytest.mark.slow  # sibling-covered; tier-1 budget
    def test_job_plan_and_stop(self, cli_agent, tmp_path):
        a, addr = cli_agent
        spec = tmp_path / "example.nomad"
        # all-dynamic ports: the dev agent has ONE node and count=2 with a
        # static port cannot share a host (rank.go:231-320)
        spec.write_text(SPEC.replace('port "admin" { static = 8080 }',
                                     'port "admin" {}'))
        rc, out = _run_cli(addr, "job", "plan", str(spec))
        assert rc == 0 and "Placements: 2" in out
        _run_cli(addr, "job", "run", str(spec))
        rc, out = _run_cli(addr, "job", "stop", "-detach", "example")
        assert rc == 0 and "deregistered" in out

    def test_operator_and_misc(self, cli_agent):
        a, addr = cli_agent
        rc, out = _run_cli(addr, "operator", "scheduler-get-config")
        assert rc == 0 and "binpack" in out
        rc, out = _run_cli(addr, "operator", "scheduler-set-config",
                           "-algorithm", "spread")
        assert rc == 0
        rc, out = _run_cli(addr, "operator", "scheduler-get-config")
        assert "spread" in out
        rc, out = _run_cli(addr, "status")
        assert rc == 0 and "Version" in out
        rc, out = _run_cli(addr, "system", "gc")
        assert rc == 0
        rc, out = _run_cli(addr, "version")
        assert rc == 0 and "nomad-tpu" in out


class TestJobInitEval:
    def test_job_init_writes_runnable_spec(self, cli_agent, tmp_path):
        a, addr = cli_agent
        dest = tmp_path / "generated.nomad"
        rc, out = _run_cli(addr, "job", "init", str(dest))
        assert rc == 0 and dest.exists()
        # refuses to overwrite
        rc, out = _run_cli(addr, "job", "init", str(dest))
        assert rc == 1  # refuses; the reason goes to stderr
        # the generated spec actually runs
        rc, out = _run_cli(addr, "job", "run", str(dest))
        assert rc == 0, out
        assert "complete" in out

    def test_job_eval_forces_new_evaluation(self, cli_agent, tmp_path):
        a, addr = cli_agent
        spec = tmp_path / "example.nomad"
        spec.write_text(SPEC)
        _run_cli(addr, "job", "run", str(spec))
        from nomad_tpu_torch.api import NomadClient

        api = NomadClient(*a.http_addr)
        before = {e.id for e in api.job_evaluations("example")}
        rc, out = _run_cli(addr, "job", "eval", "example")
        assert rc == 0, out
        assert "complete" in out
        new = [e for e in api.job_evaluations("example")
               if e.id not in before]
        assert new, "no new evaluation was created"
        # unknown job 400s
        rc, out = _run_cli(addr, "job", "eval", "nosuch")
        assert rc == 1
