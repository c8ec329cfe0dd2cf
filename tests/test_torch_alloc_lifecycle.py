"""Twins of the reference's `tests/test_alloc_lifecycle.py` (alloc stop,
restart and signal through the HTTP API), run on the port: every agent,
server and harness is the port's with `device="cpu"`, its HTTP port
ephemeral and its data under `tmp_path`; the reference's `slow` marks
are kept.
"""
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.agent.http import HTTPApi, HttpError
from nomad_tpu_torch.client import Client, ClientConfig, InProcConn
from nomad_tpu_torch.server import Server, ServerConfig
from torch_chain_cases import one_torch_thread  # noqa: F401


def _wait(cond, timeout=20.0, every=0.05):
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
    yield server, client, tmp_path
    client.shutdown()
    server.shutdown()


def _long_job(tmp_path, script=None):
    job = mock.job()
    tg = job.task_groups[0]
    tg.count = 1
    t = tg.tasks[0]
    t.driver = "raw_exec"
    t.config = {"command": "/bin/sh",
                "args": ["-c", script or "echo $$ > "
                         f"{tmp_path}/pid.$NOMAD_ALLOC_ID; sleep 60"]}
    return job


def _runner(client, server, job):
    alloc = server.state.allocs_by_job("default", job.id)[0]
    return client.alloc_runner(alloc.id), alloc


class TestAllocRestart:
    @pytest.mark.slow  # sibling-covered; tier-1 budget
    def test_restart_relaunches_without_policy_budget(self, agent):
        server, client, tmp_path = agent
        job = _long_job(tmp_path)
        job.task_groups[0].restart_policy.attempts = 0  # no budget at all
        server.job_register(job)
        assert _wait(lambda: server.state.allocs_by_job(
            "default", job.id) != [] and any(
            a.client_status == "running"
            for a in server.state.allocs_by_job("default", job.id)))
        runner, alloc = _runner(client, server, job)
        tr = runner.task_runners["web"]
        pid1 = tr.handle.driver_state.get("task_pid")
        assert runner.restart_tasks() == 1
        assert _wait(lambda: tr.state.restarts == 1
                     and tr.state.state == "running"), \
            f"state={tr.state.state} restarts={tr.state.restarts}"
        pid2 = tr.handle.driver_state.get("task_pid")
        assert pid2 != pid1
        # restart did NOT mark the task failed
        assert not tr.state.failed
        assert any(e.type == "Restart Signaled" for e in tr.state.events)

    def test_restart_unknown_task_errors(self, agent):
        server, client, tmp_path = agent
        job = _long_job(tmp_path)
        server.job_register(job)
        assert _wait(lambda: any(
            a.client_status == "running"
            for a in server.state.allocs_by_job("default", job.id)))
        runner, _ = _runner(client, server, job)
        with pytest.raises(ValueError):
            runner.restart_tasks("nope")


class TestAllocSignal:
    @pytest.mark.slow  # >20s on a cold host; tier-1 budget
    def test_signal_delivered_to_task(self, agent):
        server, client, tmp_path = agent
        marker = tmp_path / "sig.txt"
        job = _long_job(
            tmp_path,
            script=f"trap 'echo got >> {marker}' USR1; "
                   "while true; do sleep 0.1; done")
        server.job_register(job)
        assert _wait(lambda: any(
            a.client_status == "running"
            for a in server.state.allocs_by_job("default", job.id)))
        runner, _ = _runner(client, server, job)
        time.sleep(0.3)  # let the trap install
        assert runner.signal_tasks("SIGUSR1") == 1
        assert _wait(lambda: marker.exists()), "signal never delivered"
        # still running: a plain signal is not a stop
        assert runner.task_runners["web"].state.state == "running"

    def test_http_routes(self, agent):
        server, client, tmp_path = agent

        class _Facade:
            cluster = None

        f = _Facade()
        f.server = server
        f.client = client
        api = HTTPApi(f, "127.0.0.1", 0)
        try:
            job = _long_job(tmp_path)
            server.job_register(job)
            assert _wait(lambda: any(
                a.client_status == "running"
                for a in server.state.allocs_by_job("default", job.id)))
            alloc = server.state.allocs_by_job("default", job.id)[0]
            out = api.route(
                "PUT", f"/v1/client/allocation/{alloc.id}/signal", {},
                {"Signal": "SIGHUP", "TaskName": ""})
            # sh without a trap dies on SIGHUP → restart policy kicks in;
            # the route just reports delivery
            assert out["signaled"] == 1
            with pytest.raises(HttpError):
                api.route("PUT",
                          f"/v1/client/allocation/{alloc.id}/restart",
                          {}, {"TaskName": "nope"})
        finally:
            api.httpd.server_close()
