"""Twins of the reference's `tests/test_job_history.py` (job versions,
history and revert), run on the port: every agent, server and harness is
the port's with `device="cpu"`, its HTTP port ephemeral and its data
under `tmp_path`; the reference's `slow` marks are kept.
"""
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.agent.http import HTTPApi, HttpError
from nomad_tpu_torch.server import Server, ServerConfig
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


def _api(server):
    class _Facade:
        client = None
        cluster = None

    f = _Facade()
    f.server = server
    return HTTPApi(f, "127.0.0.1", 0)


class TestHistoryRevert:
    def test_versions_accumulate_and_revert_rolls_forward(self, server):
        import copy

        server.node_register(mock.node())
        job = mock.job()
        job.task_groups[0].count = 1
        server.job_register(job)
        v1 = copy.deepcopy(job)
        v1.task_groups[0].count = 3
        server.job_register(v1)
        versions = server.job_versions("default", job.id)
        assert [j.version for j in versions] == [1, 0]
        ev = server.job_revert("default", job.id, 0)
        assert ev is not None
        cur = server.state.job_by_id("default", job.id)
        # revert is roll-forward: a NEW version with the old spec
        assert cur.version == 2
        assert cur.task_groups[0].count == 1

    def test_revert_validation(self, server):
        job = mock.job()
        server.job_register(job)
        with pytest.raises(ValueError, match="already at version"):
            server.job_revert("default", job.id, 0)
        with pytest.raises(ValueError, match="no version"):
            server.job_revert("default", job.id, 7)
        with pytest.raises(ValueError, match="not found"):
            server.job_revert("default", "ghost", 0)

    def test_http_routes(self, server):
        import copy

        api = _api(server)
        try:
            job = mock.job()
            server.job_register(job)
            v1 = copy.deepcopy(job)
            v1.priority = 70
            server.job_register(v1)
            out = api.route("GET", f"/v1/job/{job.id}/versions", {}, None)
            assert [j["version"] for j in out["data"]] == [1, 0]
            res = api.route("PUT", f"/v1/job/{job.id}/revert", {},
                            {"JobVersion": 0})
            assert server.state.job_by_id(
                "default", job.id).priority == job.priority
            with pytest.raises(HttpError):
                api.route("PUT", f"/v1/job/{job.id}/revert", {}, {})
        finally:
            api.httpd.server_close()


class TestAllocStop:
    def test_stop_marks_desired_and_reschedules(self, server):
        server.node_register(mock.node())
        job = mock.job()
        job.task_groups[0].count = 2
        ev = server.job_register(job)
        assert server.wait_for_eval(ev.id, timeout=15.0).status \
            == "complete"
        allocs = server.state.allocs_by_job("default", job.id)
        a0 = next(a for a in allocs if a.desired_status == "run")
        ev2 = server.alloc_stop(a0.id)
        assert ev2 is not None and ev2.triggered_by == "alloc-stop"
        assert server.state.alloc_by_id(a0.id).desired_status == "stop"
        assert server.wait_for_eval(ev2.id, timeout=15.0).status \
            == "complete"
        # scheduler replaced the stopped alloc
        running = [a for a in server.state.allocs_by_job(
            "default", job.id) if a.desired_status == "run"]
        assert len(running) == 2

    def test_stop_http_route(self, server):
        server.node_register(mock.node())
        job = mock.job()
        job.task_groups[0].count = 1
        ev = server.job_register(job)
        server.wait_for_eval(ev.id, timeout=15.0)
        a0 = server.state.allocs_by_job("default", job.id)[0]
        api = _api(server)
        try:
            out = api.route("PUT", f"/v1/allocation/{a0.id}/stop", {},
                            None)
            assert out["eval_id"]
            assert server.state.alloc_by_id(a0.id).desired_status \
                == "stop"
        finally:
            api.httpd.server_close()
