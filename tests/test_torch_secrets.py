"""Twins of the reference's `tests/test_secrets.py` (the built-in secrets
store), run on the port: every agent, server and harness is the port's
with `device="cpu"`, its HTTP port ephemeral and its data under
`tmp_path`; the reference's `slow` marks are kept.
"""
import json
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.agent.http import HTTPApi, HttpError
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.structs.secrets import SecretEntry
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


def _api(server, acl_enabled=False):
    class _Facade:
        client = None
        cluster = None

    f = _Facade()
    f.server = server
    return HTTPApi(f, "127.0.0.1", 0)


class TestSecretsKV:
    def test_crud_roundtrip(self, server):
        api = _api(server)
        try:
            api.route("PUT", "/v1/secret/db/creds", {},
                      {"Data": {"user": "app", "pass": "hunter2"}})
            got = api.route("GET", "/v1/secret/db/creds", {}, None)
            assert got["data"] == {"user": "app", "pass": "hunter2"}
            assert got["version"] == 1
            api.route("PUT", "/v1/secret/db/creds", {},
                      {"Data": {"user": "app", "pass": "rotated"}})
            got = api.route("GET", "/v1/secret/db/creds", {}, None)
            assert got["version"] == 2 and got["data"]["pass"] == "rotated"
            lst = api.route("GET", "/v1/secrets", {}, None)
            assert lst["data"][0]["path"] == "db/creds"
            assert lst["data"][0]["keys"] == ["pass", "user"]
            api.route("DELETE", "/v1/secret/db/creds", {}, None)
            with pytest.raises(HttpError):
                api.route("GET", "/v1/secret/db/creds", {}, None)
        finally:
            api.httpd.server_close()

    def test_path_validation(self, server):
        with pytest.raises(ValueError):
            server.secret_upsert(SecretEntry(path="/abs"))
        with pytest.raises(ValueError):
            server.secret_upsert(SecretEntry(path="a/../b"))
        with pytest.raises(ValueError):
            server.secret_upsert(SecretEntry(path=""))

    def test_wildcard_namespace_rejected(self, server):
        """?namespace=* would skip the per-namespace ACL gate (no
        per-item filter exists for secret values) — it must 400."""
        api = _api(server)
        try:
            for method, path, body in [
                    ("GET", "/v1/secrets", None),
                    ("GET", "/v1/secret/x", None),
                    ("PUT", "/v1/secret/x", {"Data": {"k": "v"}}),
                    ("DELETE", "/v1/secret/x", None)]:
                with pytest.raises(HttpError) as ei:
                    api.route(method, path, {"namespace": "*"}, body)
                assert ei.value.code == 400
        finally:
            api.httpd.server_close()

    def test_acl_gates_secrets(self):
        """read-only tokens must NOT see secret values (secrets caps live
        in the write policy only)."""
        from nomad_tpu_torch.agent import Agent, AgentConfig
        from nomad_tpu_torch.api import ApiError, NomadClient

        a = Agent(AgentConfig(client=False, acl_enabled=True,
                              heartbeat_ttl=60.0), device="cpu")
        a.start()
        try:
            host, port = a.http_addr
            boot = NomadClient(host, port).acl_bootstrap()
            mgmt = NomadClient(host, port, token=boot.secret_id)
            mgmt.secret_put("top", {"k": "v"})
            mgmt.acl_upsert_policy(
                "reader", 'namespace "default" { policy = "read" }')
            rt = mgmt.acl_create_token(name="r", policies=["reader"])
            reader = NomadClient(host, port, token=rt.secret_id)
            with pytest.raises(ApiError):
                reader.secret_get("top")
            mgmt.acl_upsert_policy(
                "writer", 'namespace "default" { policy = "write" }')
            wt = mgmt.acl_create_token(name="w", policies=["writer"])
            writer = NomadClient(host, port, token=wt.secret_id)
            assert writer.secret_get("top").data == {"k": "v"}
        finally:
            a.shutdown()


class TestSecretsTaskHook:
    def test_task_gets_secret_file_and_env(self, tmp_path):
        from nomad_tpu_torch.client import Client, ClientConfig, InProcConn

        server = Server(ServerConfig(num_schedulers=1, heartbeat_ttl=60.0,
                                     gc_interval=3600.0), device="cpu")
        server.start()
        from nomad_tpu_torch.client import Client as _C  # noqa: F401
        client = Client(InProcConn(server),
                        ClientConfig(data_dir=str(tmp_path / "c"),
                                     heartbeat_interval=1.0))
        client.start()
        try:
            assert _wait(lambda: server.state.node_by_id(
                client.node.id) is not None)
            server.secret_upsert(SecretEntry(
                path="db/creds", data={"pass": "hunter2"}))
            job = mock.job()
            tg = job.task_groups[0]
            tg.count = 1
            t = tg.tasks[0]
            t.driver = "raw_exec"
            t.secrets = ["db/creds"]
            t.config = {
                "command": "/bin/sh",
                "args": ["-c",
                         "echo env=${NOMAD_SECRET_DB_CREDS_PASS}"]}
            server.job_register(job)
            assert _wait(lambda: server.state.allocs_by_job(
                "default", job.id) != [] and all(
                a.client_status == "complete"
                for a in server.state.allocs_by_job("default", job.id)),
                timeout=30.0)
            alloc = server.state.allocs_by_job("default", job.id)[0]
            tdir = tmp_path / "c" / "allocs" / alloc.id / t.name
            sf = tdir / "secrets" / "db_creds.json"
            assert json.loads(sf.read_text()) == {"pass": "hunter2"}
            import os

            assert (os.stat(sf).st_mode & 0o777) == 0o600
            logs = list((tmp_path / "c" / "allocs" / alloc.id / "alloc"
                         / "logs").glob("*.stdout.0"))
            assert logs and "env=hunter2" in logs[0].read_text()
        finally:
            client.shutdown()
            server.shutdown()

    def test_missing_secret_fails_task(self, tmp_path):
        from nomad_tpu_torch.client import Client, ClientConfig, InProcConn

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
            job = mock.job()
            tg = job.task_groups[0]
            tg.count = 1
            tg.restart_policy.attempts = 0
            t = tg.tasks[0]
            t.driver = "raw_exec"
            t.secrets = ["does/not/exist"]
            t.config = {"command": "/bin/true"}
            server.job_register(job)
            assert _wait(lambda: server.state.allocs_by_job(
                "default", job.id) != [] and any(
                a.client_status == "failed"
                for a in server.state.allocs_by_job("default", job.id)),
                timeout=30.0)
        finally:
            client.shutdown()
            server.shutdown()
