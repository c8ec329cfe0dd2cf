"""Twins of the reference's `tests/test_dispatch.py` (parameterized jobs
and dispatch), run on the port: every agent, server and harness is the
port's with `device="cpu"`, its HTTP port ephemeral and its data under
`tmp_path`; the reference's `slow` marks are kept.
"""
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.agent.http import HTTPApi, HttpError
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.structs.job import ParameterizedJobConfig
from torch_chain_cases import one_torch_thread  # noqa: F401


def _wait(cond, timeout=15.0, every=0.05):
    dl = time.time() + timeout
    while time.time() < dl:
        if cond():
            return True
        time.sleep(every)
    return cond()


@pytest.fixture()
def server():
    s = Server(ServerConfig(num_schedulers=1, heartbeat_ttl=60.0,
                            gc_interval=3600.0), device="cpu")
    s.start()
    yield s
    s.shutdown()


def _param_job(**cfg):
    job = mock.job()
    job.type = "batch"
    job.task_groups[0].count = 1
    job.task_groups[0].tasks[0].driver = "mock_driver"
    job.task_groups[0].tasks[0].config = {"run_for": 0.1}
    job.parameterized = ParameterizedJobConfig(**cfg)
    return job


class TestDispatch:
    def test_register_parameterized_creates_no_eval(self, server):
        job = _param_job()
        assert server.job_register(job) is None
        assert server.state.job_by_id("default", job.id) is not None

    def test_dispatch_creates_child_with_payload_and_eval(self, server):
        server.node_register(mock.node())
        job = _param_job(payload="required", meta_required=["env"],
                         meta_optional=["team"])
        server.job_register(job)
        child, ev = server.job_dispatch(
            "default", job.id, b"hello-payload",
            {"env": "prod", "team": "infra"})
        assert child.id.startswith(f"{job.id}/dispatch-")
        assert child.parent_id == job.id
        assert child.dispatched is True
        assert child.payload == b"hello-payload"
        assert child.meta["env"] == "prod"
        assert ev is not None
        stored = server.state.job_by_id("default", child.id)
        assert stored is not None and stored.dispatched

    def test_dispatch_validation(self, server):
        job = _param_job(payload="required", meta_required=["env"])
        server.job_register(job)
        with pytest.raises(ValueError, match="payload is required"):
            server.job_dispatch("default", job.id, b"", {"env": "x"})
        with pytest.raises(ValueError, match="missing required"):
            server.job_dispatch("default", job.id, b"p", {})
        with pytest.raises(ValueError, match="not allowed"):
            server.job_dispatch("default", job.id, b"p",
                                {"env": "x", "oops": "y"})
        forbidden = _param_job(payload="forbidden")
        server.job_register(forbidden)
        with pytest.raises(ValueError, match="forbidden"):
            server.job_dispatch("default", forbidden.id, b"p", {})
        with pytest.raises(ValueError, match="not parameterized"):
            plain = mock.job()
            server.job_register(plain)
            server.job_dispatch("default", plain.id, b"", {})
        with pytest.raises(ValueError, match="exceeds maximum size"):
            big = _param_job()
            server.job_register(big)
            server.job_dispatch("default", big.id, b"x" * (16 * 1024 + 1),
                                {})

    def test_dispatch_http_route(self, server):
        import base64

        class _Facade:
            client = None
            cluster = None

        f = _Facade()
        f.server = server
        api = HTTPApi(f, "127.0.0.1", 0)
        try:
            job = _param_job(meta_optional=["k"])
            server.job_register(job)
            out = api.route(
                "PUT", f"/v1/job/{job.id}/dispatch", {},
                {"Payload": base64.b64encode(b"data").decode(),
                 "Meta": {"k": "v"}})
            assert out["dispatched_job_id"].startswith(job.id)
            child = server.state.job_by_id("default",
                                           out["dispatched_job_id"])
            assert child.payload == b"data"
            with pytest.raises(HttpError) as ei:
                api.route("PUT", f"/v1/job/{job.id}/dispatch", {},
                          {"Meta": {"nope": "x"}})
            assert ei.value.code == 400
        finally:
            api.httpd.server_close()

    def test_child_job_reachable_over_http(self, server):
        """Dispatched ids contain '/' — every /v1/job/<id> sub-route must
        parse the id from the path tail (JobSpecificRequest)."""
        class _Facade:
            client = None
            cluster = None

        f = _Facade()
        f.server = server
        api = HTTPApi(f, "127.0.0.1", 0)
        try:
            job = _param_job()
            server.job_register(job)
            child, _ = server.job_dispatch("default", job.id, b"p", {})
            assert "/" in child.id
            got = api.route("GET", f"/v1/job/{child.id}", {}, None)
            assert got["id"] == child.id
            assert api.route(
                "GET", f"/v1/job/{child.id}/summary", {}, None)
            assert api.route(
                "GET", f"/v1/job/{child.id}/allocations", {}, None) \
                is not None
            out = api.route("DELETE", f"/v1/job/{child.id}", {}, None)
            assert server.state.job_by_id("default", child.id).stop
        finally:
            api.httpd.server_close()

    def test_jobspec_dispatch_payload_stanza(self):
        from nomad_tpu_torch.jobspec import parse

        job = parse("""
        job "param" {
          datacenters = ["dc1"]
          type = "batch"
          parameterized {
            payload = "required"
            meta_required = ["env"]
          }
          group "g" {
            task "t" {
              driver = "raw_exec"
              config { command = "/bin/cat" }
              dispatch_payload { file = "input.json" }
            }
          }
        }
        """)
        assert job.parameterized.payload == "required"
        assert job.task_groups[0].tasks[0].dispatch_payload.file \
            == "input.json"


class TestDispatchE2E:
    @pytest.mark.slow  # >10s on a cold host; tier-1 budget
    def test_payload_lands_in_task_local_dir(self, tmp_path):
        """Dispatched child runs on a real client; the payload appears at
        local/<file> (taskrunner/dispatch_hook.go)."""
        from nomad_tpu_torch.client import Client, ClientConfig, InProcConn
        from nomad_tpu_torch.structs.job import DispatchPayloadConfig

        server = Server(ServerConfig(num_schedulers=1, heartbeat_ttl=60.0,
                                     gc_interval=3600.0), device="cpu")
        server.start()
        client = Client(InProcConn(server),
                        ClientConfig(data_dir=str(tmp_path / "c"),
                                     heartbeat_interval=1.0))
        client.start()
        try:
            assert _wait(lambda: server.state.node_by_id(
                client.node.id) is not None)
            job = _param_job(payload="required")
            t = job.task_groups[0].tasks[0]
            t.driver = "raw_exec"
            t.config = {"command": "/bin/sh",
                        "args": ["-c", "cat local/in.json"]}
            t.dispatch_payload = DispatchPayloadConfig(file="in.json")
            server.job_register(job)
            child, ev = server.job_dispatch("default", job.id,
                                            b'{"x": 1}', {})
            assert ev is not None
            assert _wait(lambda: all(
                a.client_status == "complete"
                for a in server.state.allocs_by_job("default", child.id))
                and server.state.allocs_by_job("default", child.id) != [])
            alloc = server.state.allocs_by_job("default", child.id)[0]
            payload_file = (tmp_path / "c" / "allocs" / alloc.id / t.name
                           / "local" / "in.json")
            assert payload_file.read_bytes() == b'{"x": 1}'
        finally:
            client.shutdown()
            server.shutdown()
