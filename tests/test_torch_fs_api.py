"""Twins of the reference's `tests/test_fs_api.py` (the alloc filesystem
and logs API), run on the port: every agent, server and harness is the
port's with `device="cpu"`, its HTTP port ephemeral and its data under
`tmp_path`; the reference's `slow` marks are kept.
"""
import hashlib
import os
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.agent import Agent, AgentConfig
from nomad_tpu_torch.api import ApiError, NomadClient
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


def _echo_job(script="echo hello-from-task; echo oops >&2"):
    job = mock.job()
    tg = job.task_groups[0]
    tg.count = 1
    t = tg.tasks[0]
    t.driver = "raw_exec"
    t.config = {"command": "/bin/sh", "args": ["-c", script]}
    return job


class TestAllocFsApi:
    def _run_to_complete(self, api, job):
        api.wait_for_eval(api.register_job(job))
        assert _wait(lambda: any(
            al.client_status == "complete"
            for al in api.job_allocations(job.id)))
        return api.job_allocations(job.id)[0]

    @pytest.mark.slow  # >10s on a cold host; tier-1 budget
    def test_logs_stdout_and_stderr(self, agent):
        a, api = agent
        alloc = self._run_to_complete(api, _echo_job())
        task = alloc.task_group and "web"
        out = api.alloc_logs(alloc.id, task)
        assert b"hello-from-task" in out
        err = api.alloc_logs(alloc.id, task, type="stderr")
        assert b"oops" in err
        # offset continuation (the CLI -f poll pattern)
        rest = api.alloc_logs(alloc.id, task, offset=len(out))
        assert rest == b""

    @pytest.mark.slow  # >10s on a cold host; tier-1 budget
    def test_fs_ls_stat_cat(self, agent):
        a, api = agent
        alloc = self._run_to_complete(api, _echo_job(
            "echo data > local/out.txt"))
        entries = api.alloc_fs_list(alloc.id, "/")
        names = {e["Name"] for e in entries}
        assert "alloc" in names and "web" in names
        st = api.alloc_fs_stat(alloc.id, "web/local/out.txt")
        assert not st["IsDir"] and st["Size"] > 0
        assert api.alloc_fs_cat(alloc.id, "web/local/out.txt") == b"data\n"
        assert api.alloc_fs_read_at(
            alloc.id, "web/local/out.txt", offset=1, limit=2) == b"at"

    def test_path_escape_rejected(self, agent):
        a, api = agent
        alloc = self._run_to_complete(api, _echo_job())
        with pytest.raises(ApiError) as ei:
            api.alloc_fs_cat(alloc.id, "../../../etc/passwd")
        assert ei.value.code == 403

    def test_unknown_alloc_404(self, agent):
        a, api = agent
        with pytest.raises(ApiError) as ei:
            api.alloc_fs_list("nope", "/")
        assert ei.value.code == 404

    @pytest.mark.slow  # >10s on a cold host; tier-1 budget
    def test_cli_alloc_logs_and_fs(self, agent, capsys):
        from nomad_tpu_torch.cli import main

        a, api = agent
        alloc = self._run_to_complete(api, _echo_job())
        addr = f"http://{a.http_addr[0]}:{a.http_addr[1]}"
        rc = main(["-address", addr, "alloc", "logs", alloc.id[:8]])
        out = capsys.readouterr().out
        assert rc == 0 and "hello-from-task" in out
        rc = main(["-address", addr, "alloc", "fs", alloc.id[:8]])
        out = capsys.readouterr().out
        assert rc == 0 and "alloc" in out


class TestArtifactsHook:
    @pytest.mark.slow  # sibling-covered; tier-1 budget
    def test_file_artifact_with_checksum(self, agent, tmp_path):
        a, api = agent
        payload = b"#!/bin/sh\necho artifact-ran\n"
        src = tmp_path / "tool.sh"
        src.write_bytes(payload)
        digest = hashlib.sha256(payload).hexdigest()

        from nomad_tpu_torch.structs.job import TaskArtifact

        job = _echo_job("cat local/tool.sh")
        job.task_groups[0].tasks[0].artifacts = [TaskArtifact(
            getter_source=str(src),
            getter_options={"checksum": f"sha256:{digest}",
                            "mode": "755"},
        )]
        api.wait_for_eval(api.register_job(job))
        assert _wait(lambda: any(
            al.client_status == "complete"
            for al in api.job_allocations(job.id)))
        alloc = api.job_allocations(job.id)[0]
        assert b"artifact-ran" in api.alloc_logs(alloc.id, "web")
        st = api.alloc_fs_stat(alloc.id, "web/local/tool.sh")
        assert st["FileMode"].endswith("755")

    def test_bad_checksum_fails_task(self, agent, tmp_path):
        a, api = agent
        src = tmp_path / "bad.bin"
        src.write_bytes(b"contents")

        from nomad_tpu_torch.structs.job import TaskArtifact

        job = _echo_job()
        job.task_groups[0].tasks[0].artifacts = [TaskArtifact(
            getter_source=str(src),
            getter_options={"checksum": "sha256:" + "0" * 64},
        )]
        api.wait_for_eval(api.register_job(job))
        assert _wait(lambda: any(
            al.client_status == "failed"
            for al in api.job_allocations(job.id)))

    def test_http_artifact(self, agent, tmp_path):
        import http.server
        import threading

        (tmp_path / "served.txt").write_bytes(b"over-http")
        handler = lambda *args, **kw: http.server.SimpleHTTPRequestHandler(
            *args, directory=str(tmp_path), **kw)
        httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            a, api = agent
            from nomad_tpu_torch.structs.job import TaskArtifact

            job = _echo_job("cat local/served.txt")
            job.task_groups[0].tasks[0].artifacts = [TaskArtifact(
                getter_source=(f"http://127.0.0.1:"
                               f"{httpd.server_address[1]}/served.txt"),
            )]
            api.wait_for_eval(api.register_job(job))
            assert _wait(lambda: any(
                al.client_status == "complete"
                for al in api.job_allocations(job.id)))
            alloc = api.job_allocations(job.id)[0]
            assert b"over-http" in api.alloc_logs(alloc.id, "web")
        finally:
            httpd.shutdown()


class TestFsHardening:
    def test_alloc_id_traversal_rejected(self, agent):
        a, api = agent
        with pytest.raises(ApiError) as ei:
            api.alloc_fs_list("..", "/")
        assert ei.value.code == 400
        with pytest.raises(ApiError) as ei:
            api.alloc_fs_cat("../server", "raft.db")
        assert ei.value.code == 400

    def test_log_cursor_survives_rotation(self, tmp_path):
        from nomad_tpu_torch.client.fs import logs_read_from
        from nomad_tpu_torch.client.logmon import LogMon

        lm = LogMon(str(tmp_path), "t", max_files=2, max_file_size_mb=1)
        # tiny frames: force rotation every 8 bytes; write through the
        # rotator directly (the CircBufWriter flushes asynchronously)
        lm.stdout.max_file_size = 8
        lm.stdout.write(b"AAAAAAAA")
        data, frame, pos = logs_read_from(str(tmp_path), "t")
        assert data == b"AAAAAAAA"
        lm.stdout.write(b"BBBBBBBB")  # rotates to .1
        lm.stdout.write(b"CCCCCCCC")  # rotates to .2, frame .0 reaped
        data2, frame2, pos2 = logs_read_from(str(tmp_path), "t",
                                             frame=frame, pos=pos)
        assert data2 == b"BBBBBBBBCCCCCCCC"  # nothing skipped or repeated
        data3, _f, _p = logs_read_from(str(tmp_path), "t",
                                       frame=frame2, pos=pos2)
        assert data3 == b""
        lm.close()
