"""Twins of the reference's `tests/test_remote_migration.py` (ephemeral-
disk migration through the agents' FS API), run on the port: every
agent, server and harness is the port's with `device="cpu"`, its HTTP
port ephemeral and its data under `tmp_path`; the reference's `slow`
marks are kept.
"""
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.agent import Agent, AgentConfig
from nomad_tpu_torch.agent.http import HTTPApi
from nomad_tpu_torch.api import NomadClient
from nomad_tpu_torch.server.cluster import ClusterServer, ClusterServerConfig
from torch_chain_cases import one_torch_thread  # noqa: F401


def _wait(cond, timeout=60.0, step=0.2):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(step)
    return cond()


class _Facade:
    def __init__(self, cluster):
        self.server = cluster.server
        self.client = None
        self.cluster = cluster


@pytest.fixture()
def two_node_cluster(tmp_path):
    cs = ClusterServer(ClusterServerConfig(
        node_id="s1", num_schedulers=1, heartbeat_ttl=60.0,
        gc_interval=3600.0), device="cpu")
    cs.start()
    assert _wait(lambda: cs.is_leader())
    http = HTTPApi(_Facade(cs), "127.0.0.1", 0)
    http.start()
    api = NomadClient(http.addr[0], http.addr[1])
    agents = []
    for name in ("n1", "n2"):
        a = Agent(AgentConfig(
            server=False, client=True, node_name=name,
            data_dir=str(tmp_path / name), server_addrs=[cs.addr],
            heartbeat_ttl=60.0), device="cpu")
        a.start()
        agents.append(a)
    assert _wait(lambda: len([n for n in api.nodes()
                              if n.status == "ready"]) == 2)
    yield cs, api, agents
    try:
        for j in api.jobs():
            api.deregister_job(j.id)
        time.sleep(1.0)
    except Exception:
        pass
    for a in agents:
        a.shutdown()
    http.shutdown()
    cs.shutdown()


def _logs(api, alloc_id, task):
    try:
        return api.alloc_logs(alloc_id, task)
    except Exception:
        return b""


class TestRemoteMigration:
    def test_drain_carries_data_across_nodes(self, two_node_cluster):
        cs, api, agents = two_node_cluster
        job = mock.job()
        tg = job.task_groups[0]
        tg.count = 1
        tg.ephemeral_disk.sticky = True
        tg.ephemeral_disk.migrate = True
        tg.restart_policy.delay_s = 1.0
        t = tg.tasks[0]
        t.driver = "raw_exec"
        t.config = {
            "command": "/bin/sh",
            "args": ["-c",
                     "if [ -f alloc/data/state.txt ]; then "
                     'echo "carried=$(cat alloc/data/state.txt)"; fi; '
                     "echo from-first-node > alloc/data/state.txt; "
                     "sleep 120"],
        }
        api.wait_for_eval(api.register_job(job))

        first = None

        def running():
            nonlocal first
            first = next((al for al in api.job_allocations(job.id)
                          if al.client_status == "running"), None)
            return first is not None
        assert _wait(running)
        src_node = first.node_id
        # "running" is reported before the task's shell has written its
        # file (0.4-0.5 s on a loaded host): drain only once the data to
        # carry is on the source node, read through its agent's FS API
        src_agent = next(a for a in agents if a.client.node.id == src_node)
        src_api = NomadClient(src_agent.http_addr[0], src_agent.http_addr[1])
        assert _wait(lambda: any(
            e.get("Name") == "state.txt"
            for e in src_api.alloc_fs_list(first.id, "alloc/data")))

        # drain the node it landed on → the replacement must go to the
        # OTHER node with previous_allocation linkage
        from nomad_tpu_torch.structs.node import DrainStrategy

        api.drain_node(src_node, DrainStrategy(deadline_s=60.0))

        repl = None

        def replaced():
            nonlocal repl
            repl = next(
                (al for al in api.job_allocations(job.id)
                 if al.client_status == "running"
                 and al.node_id != src_node), None)
            return repl is not None
        assert _wait(replaced, timeout=90), [
            (al.id[:8], al.node_id[:8], al.client_status,
             al.desired_status)
            for al in api.job_allocations(job.id)]
        assert repl.previous_allocation, \
            "replacement lost its previous_allocation lineage"

        # the new node's task saw the OLD node's data (logs served by
        # the agent HOSTING the alloc — the control-plane facade has no
        # client)
        dst_agent = next(a for a in agents
                         if a.client.node.id == repl.node_id)
        dst_api = NomadClient(dst_agent.http_addr[0],
                              dst_agent.http_addr[1])
        assert _wait(
            lambda: b"carried=from-first-node"
            in _logs(dst_api, repl.id, t.name), timeout=60), \
            _logs(dst_api, repl.id, t.name)
