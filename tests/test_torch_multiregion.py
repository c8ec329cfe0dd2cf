"""Twins of the reference's `tests/test_multiregion.py` (federated regions
and multiregion jobs), run on the port: every agent, server and harness
is the port's with `device="cpu"`, its HTTP port ephemeral and its data
under `tmp_path`; the reference's `slow` marks are kept.
"""
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.agent.http import HTTPApi, HttpError
from nomad_tpu_torch.server.cluster import ClusterServer, ClusterServerConfig
from torch_chain_cases import one_torch_thread  # noqa: F401


def _wait(cond, timeout=15.0, every=0.05):
    dl = time.time() + timeout
    while time.time() < dl:
        if cond():
            return True
        time.sleep(every)
    return cond()


def make_region(region, node_id):
    cfg = ClusterServerConfig(node_id=node_id, region=region,
                              num_schedulers=1, heartbeat_ttl=60.0,
                              gc_interval=3600.0)
    s = ClusterServer(cfg, device="cpu")
    s.start()
    return s


class _Facade:
    def __init__(self, cluster):
        self.server = cluster.server
        self.client = None
        self.cluster = cluster


@pytest.fixture()
def federation():
    east = make_region("east", "e0")
    west = make_region("west", "w0")
    assert _wait(lambda: east.is_leader())
    assert _wait(lambda: west.is_leader())
    assert east.join_wan(west.addr)
    apis = []
    for s in (east, west):
        api = HTTPApi(_Facade(s), "127.0.0.1", 0)
        api.start()
        apis.append(api)
    yield east, west, apis[0], apis[1]
    for api in apis:
        api.shutdown()
    east.shutdown()
    west.shutdown()


class TestFederation:
    def test_regions_listed_on_both_sides(self, federation):
        east, west, _, _ = federation
        assert _wait(lambda: east.regions() == ["east", "west"])
        assert _wait(lambda: west.regions() == ["east", "west"])

    def test_cross_region_rpc_forward(self, federation):
        east, west, _, _ = federation
        node = mock.node()
        east.call("node_register", node, region="west")
        assert west.state.node_by_id(node.id) is not None
        assert east.state.node_by_id(node.id) is None

    def test_http_regions_and_forward(self, federation):
        east, west, api_e, _ = federation
        assert api_e.route("GET", "/v1/regions", {}, None) \
            == ["east", "west"]
        # register a plain job in west THROUGH the east agent
        job = mock.job()
        # wait until east has learned west's http_addr tag
        assert _wait(lambda: any(
            m.region == "west" and m.tags.get("http_addr")
            for m in east.membership.members()))
        from nomad_tpu_torch.structs.codec import to_wire

        out = api_e.route("PUT", "/v1/jobs", {"region": "west"},
                          {"job": to_wire(job)})
        assert out["eval_id"]
        assert west.state.job_by_id("default", job.id) is not None
        assert east.state.job_by_id("default", job.id) is None
        # reads forward too
        got = api_e.route("GET", f"/v1/job/{job.id}", {"region": "west"},
                          None)
        assert got["id"] == job.id

    def test_http_agent_join_federates(self):
        """`server join` over HTTP (agent_endpoint.go Join) wires the
        WAN the same way join_wan does."""
        east = make_region("east2", "e0")
        west = make_region("west2", "w0")
        api = HTTPApi(_Facade(east), "127.0.0.1", 0)
        try:
            assert _wait(lambda: east.is_leader())
            assert _wait(lambda: west.is_leader())
            out = api.route(
                "PUT", "/v1/agent/join",
                {"address": f"{west.addr[0]}:{west.addr[1]}"}, None)
            assert out["num_joined"] == 1
            assert _wait(lambda: east.regions() == ["east2", "west2"])
            with pytest.raises(HttpError):
                api.route("PUT", "/v1/agent/join",
                          {"address": "not-an-addr"}, None)
        finally:
            api.httpd.server_close()
            east.shutdown()
            west.shutdown()

    def test_unknown_region_errors(self, federation):
        east, _, api_e, _ = federation
        with pytest.raises(HttpError):
            api_e.route("GET", "/v1/nodes", {"region": "mars"}, None)

    def test_multiregion_job_fans_out(self, federation):
        east, west, api_e, _ = federation
        assert _wait(lambda: any(
            m.region == "west" and m.tags.get("http_addr")
            for m in east.membership.members()))
        from nomad_tpu_torch.jobspec import parse
        from nomad_tpu_torch.structs.codec import to_wire

        hcl = """
        job "mr" {
          datacenters = ["dc1"]
          multiregion {
            strategy { max_parallel = 1 }
            region "east" { count = 2  datacenters = ["dc-east"] }
            region "west" { count = 3  datacenters = ["dc-west"] }
          }
          group "web" {
            count = 1
            task "t" { driver = "mock_driver" }
          }
        }
        """
        job = parse(hcl)
        assert job.multiregion is not None
        assert job.multiregion.strategy["max_parallel"] == 1
        out = api_e.route("PUT", "/v1/jobs", {}, {"job": to_wire(job)})
        assert set(out["regions"]) == {"east", "west"}
        je = east.state.job_by_id("default", "mr")
        jw = west.state.job_by_id("default", "mr")
        assert je is not None and jw is not None
        assert je.region == "east" and jw.region == "west"
        assert je.task_groups[0].count == 2
        assert jw.task_groups[0].count == 3
        assert je.datacenters == ["dc-east"]
        assert jw.datacenters == ["dc-west"]

    def test_multiregion_with_region_set_rejected(self, federation):
        east, _, api_e, _ = federation
        from nomad_tpu_torch.structs.codec import to_wire
        from nomad_tpu_torch.structs.job import Multiregion

        job = mock.job()
        job.region = "somewhere-else"
        job.multiregion = Multiregion(regions=[
            {"name": "east"}, {"name": "west"}])
        with pytest.raises(HttpError) as ei:
            api_e.route("PUT", "/v1/jobs", {}, {"job": to_wire(job)})
        assert ei.value.code == 400

    def test_multiregion_partial_failure_reports_errors(self, federation):
        """A dead region must not abort the regions that committed
        (best-effort fan-out; the response says what landed where)."""
        east, west, api_e, _ = federation
        from nomad_tpu_torch.structs.codec import to_wire
        from nomad_tpu_torch.structs.job import Multiregion

        job = mock.job()
        job.multiregion = Multiregion(regions=[
            {"name": "mars"}, {"name": "east"}])
        out = api_e.route("PUT", "/v1/jobs", {}, {"job": to_wire(job)})
        assert out["regions"].get("east")
        assert "mars" in out.get("errors", {})
        assert east.state.job_by_id("default", job.id) is not None

    def test_register_by_id_route_fans_out_too(self, federation):
        east, west, api_e, _ = federation
        assert _wait(lambda: any(
            m.region == "west" and m.tags.get("http_addr")
            for m in east.membership.members()))
        from nomad_tpu_torch.structs.codec import to_wire
        from nomad_tpu_torch.structs.job import Multiregion

        job = mock.job()
        job.multiregion = Multiregion(regions=[
            {"name": "east"}, {"name": "west"}])
        out = api_e.route("PUT", f"/v1/job/{job.id}", {},
                          {"job": to_wire(job)})
        assert set(out["regions"]) == {"east", "west"}
        assert west.state.job_by_id("default", job.id) is not None
