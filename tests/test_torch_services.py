"""Twins of the reference's `tests/test_services.py` (the native service
catalog and checks), run on the port: every agent, server and harness is
the port's with `device="cpu"`, its HTTP port ephemeral and its data
under `tmp_path`; the reference's `slow` marks are kept.
"""
import socket
import threading
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.client import Client, ClientConfig, InProcConn
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.structs.job import Service
from torch_chain_cases import one_torch_thread  # noqa: F401


def _wait(cond, timeout=15.0, every=0.05):
    dl = time.time() + timeout
    while time.time() < dl:
        if cond():
            return True
        time.sleep(every)
    return cond()


@pytest.fixture()
def agent(tmp_path):
    server = Server(ServerConfig(num_schedulers=1, heartbeat_ttl=60.0,
                                 gc_interval=3600.0), device="cpu")
    server.start()
    client = Client(InProcConn(server),
                    ClientConfig(data_dir=str(tmp_path / "c"),
                                 heartbeat_interval=1.0))
    client.start()
    assert _wait(lambda: server.state.node_by_id(client.node.id)
                 is not None)
    yield server, client
    client.shutdown()
    server.shutdown()


def _service_job(checks=None, run_for=5.0):
    job = mock.job()
    tg = job.task_groups[0]
    tg.count = 1
    t = tg.tasks[0]
    t.driver = "mock_driver"
    t.config = {"run_for": run_for}
    t.services = [Service(name="web-svc", tags=["v1", "http"],
                          checks=checks or [])]
    tg.services = [Service(name="group-svc")]
    return job


class TestServiceRegistration:
    def test_running_task_registers_and_stop_deregisters(self, agent):
        server, client = agent
        job = _service_job()
        server.job_register(job)
        assert _wait(lambda: len(
            server.state.services_by_name("default", "web-svc")) == 1)
        regs = server.state.services_by_name("default", "web-svc")
        assert regs[0].job_id == job.id
        assert regs[0].status == "passing"
        assert regs[0].tags == ["v1", "http"]
        assert server.state.services_by_name("default", "group-svc")
        # task completes → alloc terminal → rows vanish
        assert _wait(lambda: server.state.services_by_name(
            "default", "web-svc") == [], timeout=30.0)
        assert _wait(lambda: server.state.services_by_name(
            "default", "group-svc") == [])

    def test_http_catalog_and_cli(self, agent):
        server, client = agent
        from nomad_tpu_torch.agent.http import HTTPApi

        job = _service_job()
        server.job_register(job)
        assert _wait(lambda: server.state.services_by_name(
            "default", "web-svc") != [])

        class _Facade:
            client = None
            cluster = None

        f = _Facade()
        f.server = server
        api = HTTPApi(f, "127.0.0.1", 0)
        try:
            out = api.route("GET", "/v1/services", {}, None)
            names = {s["service_name"] for s in out["data"]}
            assert {"web-svc", "group-svc"} <= names
            web = next(s for s in out["data"]
                       if s["service_name"] == "web-svc")
            assert web["count"] == 1 and web["passing"] == 1
            insts = api.route("GET", "/v1/service/web-svc", {}, None)
            assert len(insts["data"]) == 1
            assert insts["data"][0]["service_name"] == "web-svc"
        finally:
            api.httpd.server_close()

    def test_tcp_check_flips_status(self, agent):
        """A TCP check against a live listener is passing; killing the
        listener turns the registration critical."""
        server, client = agent
        lsock = socket.socket()
        # all interfaces: the check dials the node's fingerprinted IP,
        # not loopback
        lsock.bind(("", 0))
        lsock.listen(8)
        port = lsock.getsockname()[1]
        accepting = threading.Event()

        def accept_loop():
            accepting.set()
            try:
                while True:
                    c, _ = lsock.accept()
                    c.close()
            except OSError:
                pass

        threading.Thread(target=accept_loop, daemon=True).start()
        accepting.wait(2.0)
        job = _service_job(checks=[{
            "name": "alive", "type": "tcp", "port": str(port),
            "interval_s": 0.3, "timeout_s": 1.0}], run_for=30.0)
        server.job_register(job)
        try:
            assert _wait(lambda: any(
                r.status == "passing" for r in
                server.state.services_by_name("default", "web-svc")))
            lsock.close()
            assert _wait(lambda: any(
                r.status == "critical" for r in
                server.state.services_by_name("default", "web-svc")),
                timeout=20.0), "check never went critical"
        finally:
            server.job_deregister("default", job.id)

    def test_gc_reaps_orphan_registrations(self, agent):
        server, _ = agent
        from nomad_tpu_torch.structs.service import ServiceRegistration

        server.state.upsert_service_registrations([ServiceRegistration(
            id="orphan", service_name="ghost", alloc_id="gone-alloc")])
        # delete_alloc is a no-op for an unknown alloc, but the catalog
        # sweep keyed on the alloc id must still remove the rows
        server.state.delete_alloc("gone-alloc")
        assert server.state.services_by_name("default", "ghost") == []


class TestServiceJobspec:
    def test_service_checks_parse(self):
        from nomad_tpu_torch.jobspec import parse

        job = parse("""
        job "svc" {
          datacenters = ["dc1"]
          group "g" {
            service { name = "g-svc" }
            task "t" {
              driver = "raw_exec"
              config { command = "/bin/true" }
              service {
                name = "t-svc"
                port = "http"
                tags = ["a", "b"]
                check {
                  type = "http"
                  path = "/health"
                  interval = "5s"
                  timeout = "2s"
                }
              }
            }
          }
        }
        """)
        tg = job.task_groups[0]
        assert tg.services[0].name == "g-svc"
        svc = tg.tasks[0].services[0]
        assert svc.name == "t-svc"
        assert svc.port_label == "http"
        assert svc.checks[0]["type"] == "http"
        assert svc.checks[0]["path"] == "/health"
        assert svc.checks[0]["interval_s"] == 5.0


class TestScriptChecks:
    """`check { type = "script" }` runs inside the task via driver exec
    (reference taskrunner/script_check_hook.go:60; Consul exit-code
    semantics: 0 = passing)."""

    def test_script_check_flips_on_task_state(self, agent):
        server, client = agent
        job = mock.job()
        tg = job.task_groups[0]
        tg.count = 1
        t = tg.tasks[0]
        t.driver = "raw_exec"
        t.config = {"command": "/bin/sh",
                    "args": ["-c", "sleep 2; touch local/ok; sleep 60"]}
        t.services = [Service(name="script-svc", checks=[{
            "type": "script", "command": "/bin/sh",
            "args": ["-c", "test -f local/ok"],
            "interval_s": 0.5, "timeout_s": 5,
        }])]
        server.job_register(job)
        regs = lambda: server.state.services_by_name(  # noqa: E731
            "default", "script-svc")
        assert _wait(lambda: len(regs()) == 1)
        # critical until the task creates the probed file...
        assert regs()[0].status == "critical"
        # ...then passing once the in-task exec sees it
        assert _wait(lambda: regs()[0].status == "passing", timeout=30)

    def test_group_service_script_check_names_task(self, agent):
        server, client = agent
        job = mock.job()
        tg = job.task_groups[0]
        tg.count = 1
        t = tg.tasks[0]
        t.driver = "raw_exec"
        t.config = {"command": "/bin/sh", "args": ["-c", "sleep 60"]}
        tg.services = [Service(name="group-script-svc", checks=[{
            "type": "script", "command": "/bin/true", "args": [],
            "task": t.name, "interval_s": 0.5, "timeout_s": 5,
        }])]
        server.job_register(job)
        regs = lambda: server.state.services_by_name(  # noqa: E731
            "default", "group-script-svc")
        assert _wait(lambda: len(regs()) == 1)
        assert _wait(lambda: regs()[0].status == "passing", timeout=30)
