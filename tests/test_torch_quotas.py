"""Twins of the reference's `tests/test_quotas.py` (resource quotas over
the HTTP API and the CLI), run on the port: every agent, server and
harness is the port's with `device="cpu"`, its HTTP port ephemeral and
its data under `tmp_path`; the reference's `slow` marks are kept.
"""
import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.agent.http import HTTPApi, HttpError
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.structs.operator import Namespace, QuotaSpec
from torch_chain_cases import one_torch_thread  # noqa: F401


@pytest.fixture()
def server():
    s = Server(ServerConfig(num_schedulers=1, heartbeat_ttl=60.0,
                            gc_interval=3600.0), device="cpu")
    s.start()
    yield s
    s.shutdown()


def _job(ns="team-a", count=2, cpu=500, mem=256):
    job = mock.job(namespace=ns)
    tg = job.task_groups[0]
    tg.count = count
    t = tg.tasks[0]
    t.resources.cpu = cpu
    t.resources.memory_mb = mem
    return job


def _setup(server, cpu=2000, mem=1024):
    server.quota_upsert(QuotaSpec(name="small", cpu=cpu, memory_mb=mem))
    server.namespace_upsert(Namespace(name="team-a", quota="small"))


class TestQuotaEnforcement:
    def test_register_within_quota_ok(self, server):
        _setup(server)
        server.job_register(_job(count=2, cpu=500, mem=256))  # 1000/512

    def test_register_over_quota_rejected(self, server):
        _setup(server)
        with pytest.raises(ValueError, match="quota 'small' exceeded"):
            server.job_register(_job(count=5, cpu=500))  # 2500 > 2000

    def test_accumulates_across_jobs(self, server):
        _setup(server)
        server.job_register(_job(count=3, cpu=500, mem=100))  # 1500
        with pytest.raises(ValueError, match="cpu"):
            server.job_register(_job(count=2, cpu=500, mem=100))  # 2500
        # resubmitting the SAME job at a new size replaces its own usage
        j = _job(count=4, cpu=500, mem=100)  # exactly 2000: fits alone
        first = _job(count=3, cpu=500, mem=100)
        server.job_deregister("team-a", first.id)  # noop (different id)
        with pytest.raises(ValueError):
            server.job_register(j)  # 1500 + 2000 > 2000

    def test_resubmit_own_job_excluded_from_usage(self, server):
        _setup(server)
        j = _job(count=3, cpu=500, mem=100)
        server.job_register(j)
        import copy

        j2 = copy.deepcopy(j)
        j2.task_groups[0].count = 4  # 2000 exactly — replaces itself
        server.job_register(j2)

    def test_scale_enforced(self, server):
        _setup(server)
        j = _job(count=2, cpu=500, mem=100)
        server.job_register(j)
        with pytest.raises(ValueError, match="quota"):
            server.job_scale("team-a", j.id, "web", 5)
        server.job_scale("team-a", j.id, "web", 4)  # 2000 exactly

    def test_unquotad_namespace_unlimited(self, server):
        server.namespace_upsert(Namespace(name="team-a"))
        server.job_register(_job(count=50, cpu=500))

    def test_attach_missing_quota_rejected(self, server):
        with pytest.raises(ValueError, match="does not exist"):
            server.namespace_upsert(Namespace(name="x", quota="ghost"))

    def test_delete_blocked_while_attached(self, server):
        _setup(server)
        with pytest.raises(ValueError, match="attached"):
            server.quota_delete("small")
        server.namespace_upsert(Namespace(name="team-a"))  # detach
        server.quota_delete("small")


class TestQuotaApi:
    def test_http_crud_and_usage(self, server):
        class _Facade:
            client = None
            cluster = None

        f = _Facade()
        f.server = server
        api = HTTPApi(f, "127.0.0.1", 0)
        try:
            api.route("PUT", "/v1/quota", {},
                      {"Name": "small", "Cpu": 2000, "MemoryMB": 1024})
            api.route("PUT", "/v1/namespace", {},
                      {"Name": "team-a", "Quota": "small"})
            server.job_register(_job(count=2, cpu=500, mem=256))
            lst = api.route("GET", "/v1/quotas", {}, None)
            assert [q["name"] for q in lst["data"]] == ["small"]
            u = api.route("GET", "/v1/quota/usage/small", {}, None)
            assert u["cpu_used"] == 1000
            assert u["memory_mb_used"] == 512
            assert u["namespaces"] == ["team-a"]
            with pytest.raises(HttpError) as ei:
                api.route("DELETE", "/v1/quota/small", {}, None)
            assert ei.value.code == 400  # still attached
        finally:
            api.httpd.server_close()
