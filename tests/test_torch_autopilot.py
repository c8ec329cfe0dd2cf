"""Twins of the reference's `tests/test_autopilot.py` `TestOperatorRaft`
(the operator raft routes), run on the port: every agent, server and
harness is the port's with `device="cpu"`, its HTTP port ephemeral and
its data under `tmp_path`; the reference's `slow` marks are kept.
"""
import time

import pytest

from nomad_tpu_torch.agent.http import HTTPApi, HttpError
from tests.test_cluster import leader_of, make_cluster
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
    agents = make_cluster(3)
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


