"""Twins of the reference's `tests/test_namespaces.py` (namespaces over the
HTTP API and the CLI), run on the port: every agent, server and harness
is the port's with `device="cpu"`, its HTTP port ephemeral and its data
under `tmp_path`; the reference's `slow` marks are kept.
"""
import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.agent.http import HTTPApi, HttpError
from nomad_tpu_torch.server import Server, ServerConfig
from torch_chain_cases import one_torch_thread  # noqa: F401


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


class TestNamespaces:
    def test_default_exists(self, server):
        names = [n.name for n in server.state.namespaces()]
        assert names == ["default"]

    def test_crud_over_http(self, server):
        api = _api(server)
        try:
            api.route("PUT", "/v1/namespace", {},
                      {"Name": "prod", "Description": "production"})
            lst = api.route("GET", "/v1/namespaces", {}, None)
            assert [n["name"] for n in lst["data"]] == ["default", "prod"]
            got = api.route("GET", "/v1/namespace/prod", {}, None)
            assert got["description"] == "production"
            api.route("DELETE", "/v1/namespace/prod", {}, None)
            with pytest.raises(HttpError):
                api.route("GET", "/v1/namespace/prod", {}, None)
        finally:
            api.httpd.server_close()

    def test_validation(self, server):
        from nomad_tpu_torch.structs.operator import Namespace

        with pytest.raises(ValueError):
            server.namespace_upsert(Namespace(name="bad name!"))
        with pytest.raises(ValueError):
            server.namespace_delete("default")
        with pytest.raises(ValueError):
            server.namespace_delete("ghost")

    def test_delete_blocked_while_jobs_live(self, server):
        from nomad_tpu_torch.structs.operator import Namespace

        server.namespace_upsert(Namespace(name="apps"))
        job = mock.job(namespace="apps")
        server.job_register(job)
        with pytest.raises(ValueError, match="non-terminal jobs"):
            server.namespace_delete("apps")
        server.job_deregister("apps", job.id)
        server.namespace_delete("apps")
        assert server.state.namespace_by_name("apps") is None

    def test_register_into_unknown_namespace_rejected(self, server):
        job = mock.job(namespace="nope")
        with pytest.raises(ValueError, match="does not exist"):
            server.job_register(job)

    def test_delete_cascades_secrets(self, server):
        """KV secrets must not survive namespace deletion and re-attach
        to a future namespace of the same name."""
        from nomad_tpu_torch.structs.operator import Namespace
        from nomad_tpu_torch.structs.secrets import SecretEntry

        server.namespace_upsert(Namespace(name="team-a"))
        server.secret_upsert(SecretEntry(namespace="team-a", path="kv",
                                         data={"s": "1"}))
        server.namespace_delete("team-a")
        server.namespace_upsert(Namespace(name="team-a"))
        assert server.state.secret_get("team-a", "kv") is None

    def test_delete_cascades_stopped_jobs_and_history(self, server):
        """Stopped jobs + their version history + evals must not leak
        into a recreated namespace of the same name."""
        from nomad_tpu_torch.structs.operator import Namespace

        server.namespace_upsert(Namespace(name="team-a"))
        job = mock.job(namespace="team-a")
        server.job_register(job)
        server.job_deregister("team-a", job.id)
        server.namespace_delete("team-a")
        server.namespace_upsert(Namespace(name="team-a"))
        assert server.state.job_by_id("team-a", job.id) is None
        assert server.state.job_versions_by_id("team-a", job.id) == []
        assert [e for e in server.state.evals()
                if e.namespace == "team-a"] == []

    def test_register_into_unknown_namespace_is_400(self, server):
        from nomad_tpu_torch.structs.codec import to_wire

        api = _api(server)
        try:
            job = mock.job(namespace="ghost")
            with pytest.raises(HttpError) as ei:
                api.route("PUT", "/v1/jobs", {}, {"job": to_wire(job)})
            assert ei.value.code == 400
        finally:
            api.httpd.server_close()

    def test_delete_blocked_by_csi_volumes(self, server):
        from nomad_tpu_torch.structs.csi import CSIVolume
        from nomad_tpu_torch.structs.operator import Namespace

        server.namespace_upsert(Namespace(name="vols"))
        server.csi_volume_register(CSIVolume(
            id="v1", name="v1", namespace="vols", plugin_id="hostpath"))
        with pytest.raises(ValueError, match="CSI volumes"):
            server.namespace_delete("vols")

    def test_job_spec_validation_rejects_bad_specs(self, server):
        """structs.Job.Validate analog: bad specs never reach state."""
        for mutate, msg in [
                (lambda j: setattr(j.task_groups[0], "count", -1),
                 "negative"),
                (lambda j: setattr(j, "type", "wat"), "invalid job type"),
                (lambda j: setattr(j, "priority", 0), "not in"),
                (lambda j: setattr(j, "datacenters", []), "datacenter"),
                (lambda j: setattr(j.task_groups[0], "tasks", []),
                 "at least one task"),
                (lambda j: setattr(j.task_groups[0].tasks[0], "driver",
                                   ""), "missing driver")]:
            job = mock.job()
            mutate(job)
            with pytest.raises(ValueError, match=msg):
                server.job_register(job)
            assert server.state.job_by_id("default", job.id) is None

    def test_validate_route(self, server):
        from nomad_tpu_torch.structs.codec import to_wire

        api = _api(server)
        try:
            good = mock.job()
            out = api.route("PUT", "/v1/validate/job", {},
                            {"job": to_wire(good)})
            assert out["valid"] is True
            bad = mock.job()
            bad.task_groups[0].count = -2
            out = api.route("PUT", "/v1/validate/job", {},
                            {"job": to_wire(bad)})
            assert out["valid"] is False and "negative" in out["error"]
            ghost = mock.job(namespace="ghost-ns")
            out = api.route("PUT", "/v1/validate/job", {},
                            {"job": to_wire(ghost)})
            assert out["valid"] is True  # warning, not error
            assert any("ghost-ns" in w for w in out["warnings"])
        finally:
            api.httpd.server_close()

    def test_write_needs_management_token(self):
        from nomad_tpu_torch.agent import Agent, AgentConfig
        from nomad_tpu_torch.api import ApiError, NomadClient

        a = Agent(AgentConfig(client=False, acl_enabled=True,
                              heartbeat_ttl=60.0), device="cpu")
        a.start()
        try:
            host, port = a.http_addr
            boot = NomadClient(host, port).acl_bootstrap()
            mgmt = NomadClient(host, port, token=boot.secret_id)
            mgmt.namespace_apply("team-a")
            mgmt.acl_upsert_policy(
                "w", 'namespace "team-a" { policy = "write" }')
            tok = mgmt.acl_create_token(name="w", policies=["w"])
            writer = NomadClient(host, port, token=tok.secret_id)
            # namespace-scoped tokens can read their namespace row…
            assert writer.namespace("team-a").name == "team-a"
            assert [n.name for n in writer.namespaces()] == ["team-a"]
            # …but cannot create/delete namespaces
            with pytest.raises(ApiError):
                writer.namespace_apply("team-b")
            with pytest.raises(ApiError):
                writer.namespace_delete("team-a")
        finally:
            a.shutdown()
