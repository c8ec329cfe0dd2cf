"""Twins of the reference's `tests/test_autopilot.py` `TestOperatorRaft`
(the operator raft routes) and the two HTTP cases of `TestAutopilot`
(`test_config_roundtrip`, `test_force_leave_prunes_without_waiting`; its
other cases are in `tests/test_torch_cluster.py`), run on the port's
region (`tests/test_torch_cluster.py` `make_cluster`, every
`ClusterServer` with `device="cpu"`) through the port's HTTP API.
"""
import time

import pytest

from nomad_tpu_torch.agent.http import HTTPApi, HttpError
from tests.test_torch_cluster import leader_of, make_cluster
from torch_chain_cases import one_torch_thread  # noqa: F401


def _wait(cond, timeout=20.0, every=0.05):
    dl = time.time() + timeout
    while time.time() < dl:
        if cond():
            return True
        time.sleep(every)
    return cond()


class _Facade:
    def __init__(self, cluster):
        self.server = cluster.server
        self.client = None
        self.cluster = cluster


@pytest.fixture()
def cluster():
    agents = make_cluster(3, device="cpu")
    yield agents
    for a in agents:
        try:
            a.shutdown()
        except Exception:
            pass


class TestOperatorRaft:
    def test_raft_configuration_route(self, cluster):
        assert _wait(lambda: leader_of(cluster) is not None)
        leader = leader_of(cluster)
        api = HTTPApi(_Facade(leader), "127.0.0.1", 0)
        try:
            out = api.route("GET", "/v1/operator/raft/configuration",
                            {}, None)
            assert len(out["servers"]) == 3
            assert sum(1 for s in out["servers"] if s["leader"]) == 1
        finally:
            api.httpd.server_close()

    def test_remove_peer_shrinks_config_everywhere(self, cluster):
        assert _wait(lambda: leader_of(cluster) is not None)
        leader = leader_of(cluster)
        victim = next(a for a in cluster if a is not leader)
        api = HTTPApi(_Facade(leader), "127.0.0.1", 0)
        try:
            out = api.route("DELETE", "/v1/operator/raft/peer",
                            {"id": victim.config.node_id}, None)
            assert out["removed"] == victim.config.node_id
            # committed config change applies on every live server
            for a in cluster:
                if a is victim:
                    continue
                assert _wait(lambda a=a: victim.config.node_id
                             not in a.raft.peers)
                assert _wait(lambda a=a: victim.config.node_id
                             not in a.peers)
            # removing the leader itself is refused
            with pytest.raises(HttpError):
                api.route("DELETE", "/v1/operator/raft/peer",
                          {"id": leader.config.node_id}, None)
        finally:
            api.httpd.server_close()




class TestAutopilot:
    def test_config_roundtrip(self, cluster):
        from nomad_tpu_torch.structs.codec import from_wire

        assert _wait(lambda: leader_of(cluster) is not None)
        leader = leader_of(cluster)
        api = HTTPApi(_Facade(leader), "127.0.0.1", 0)
        try:
            cfg = api.route("GET", "/v1/operator/autopilot/configuration",
                            {}, None)
            assert cfg["cleanup_dead_servers"] is True
            cfg["max_trailing_logs"] = 500
            api.route("PUT", "/v1/operator/autopilot/configuration", {},
                      from_wire(cfg))
            got = api.route("GET", "/v1/operator/autopilot/configuration",
                            {}, None)
            assert got["max_trailing_logs"] == 500
        finally:
            api.httpd.server_close()

    def test_force_leave_prunes_without_waiting(self, cluster):
        """`server force-leave` marks a crashed member LEFT at once;
        autopilot prunes it without waiting for the failure detector."""
        from nomad_tpu_torch.server.gossip import STATUS_ALIVE, STATUS_LEFT

        assert _wait(lambda: leader_of(cluster) is not None)
        assert _wait(lambda: all(
            len(a.membership.members()) == 3 for a in cluster))
        leader = leader_of(cluster)
        victim = next(a for a in cluster if a is not leader)
        api = HTTPApi(_Facade(leader), "127.0.0.1", 0)
        try:
            # refusals: healthy members and self are protected
            with pytest.raises(HttpError) as ei:
                api.route("PUT", "/v1/agent/force-leave",
                          {"node": victim.membership.name}, None)
            assert ei.value.code == 400 and "alive" in str(ei.value)
            with pytest.raises(HttpError) as ei:
                api.route("PUT", "/v1/agent/force-leave",
                          {"node": leader.membership.name}, None)
            assert ei.value.code == 400
            victim.raft.shutdown()
            victim.rpc.shutdown()
            victim.membership.stop()
            # the detector marks it suspect or failed first
            assert _wait(lambda: next(
                m.status for m in leader.membership.members()
                if m.name == victim.membership.name) != STATUS_ALIVE,
                timeout=20.0)
            out = api.route("PUT", "/v1/agent/force-leave",
                            {"node": victim.membership.name}, None)
            assert out["left"] == victim.membership.name
            assert next(m.status for m in leader.membership.members()
                        if m.name == victim.membership.name) \
                == STATUS_LEFT
            assert _wait(lambda: victim.config.node_id
                         not in leader.raft.peers, timeout=20.0)
            with pytest.raises(HttpError):
                api.route("PUT", "/v1/agent/force-leave",
                          {"node": "ghost"}, None)
        finally:
            api.httpd.server_close()
