"""Twins of the reference's `tests/test_deployments.py` (the deployment
watcher; reference `nomad/deploymentwatcher/deployments_watcher_test.go`),
run on the port: the hand-fed cases on `Server(device="cpu")`, the
tracker-driven cases on the port's `Agent(config, device="cpu")` whose
client runs the tasks with raw_exec and whose HealthTracker produces
every health signal. The reference's `slow` marks are kept.

`TestAgainstReference` feeds the same nodes and job versions (built by
the reference's mocks, wired to the port) to the reference's server and
the port's, drives health by hand as a client would, and compares the
deployments (status, version, group counts), the stable version and the
allocs each leaves: a plain rollout, a canary promoted, and a bad
version that fails and auto-reverts.
"""
import copy
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.structs.deployment import (
    DEPLOYMENT_STATUS_FAILED,
    DEPLOYMENT_STATUS_RUNNING,
    DEPLOYMENT_STATUS_SUCCESSFUL,
)
from nomad_tpu_torch.structs.job import UpdateStrategy

from torch_chain_cases import one_torch_thread  # noqa: F401
from torch_ops_cases import REF, as_pkg, mod, run_both, wait_for
from torch_ops_cases import server as make_server


@pytest.fixture()
def server():
    s = Server(ServerConfig(num_schedulers=1, heartbeat_ttl=60.0),
               device="cpu")
    s.start()
    yield s
    s.shutdown()


@pytest.fixture()
def agent(tmp_path):
    """The port's agent (server + real client): allocs actually run
    (raw_exec) and the client HealthTracker generates every health
    signal."""
    from nomad_tpu_torch.agent import Agent, AgentConfig

    a = Agent(AgentConfig(data_dir=str(tmp_path / "c"), heartbeat_ttl=60.0),
              device="cpu")
    a.start()
    server, client = a.server, a.client
    assert _wait(lambda: server.state.node_by_id(client.node.id)
                 is not None)
    yield server, client
    # stop every job first: an agent's shutdown detaches running tasks
    # (and their executors) for a later restart to recover
    jobs = [(j.namespace, j.id) for j in server.state.jobs()]
    for ns, job_id in jobs:
        server.job_deregister(ns, job_id)
    _wait(lambda: all(a.client_terminal_status() for ns, job_id in jobs
                      for a in server.state.allocs_by_job(ns, job_id)),
          timeout=15.0)
    a.shutdown()


def _cluster(server, n=3):
    return [server.node_register(mock.node()) or None for _ in range(n)]


def _update_job(count=3, **update_kw):
    job = mock.job()
    job.task_groups[0].count = count
    job.task_groups[0].update = UpdateStrategy(
        max_parallel=count, min_healthy_time_s=0.0, **update_kw
    )
    job.update = job.task_groups[0].update
    return job


def _wait(cond, timeout=8.0, every=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        v = cond()
        if v:
            return v
        time.sleep(every)
    return cond()


def _register_v0_running(server, job):
    """Register v0 and mark all its allocs healthy/running."""
    ev = server.job_register(job)
    assert server.wait_for_eval(ev.id) is not None
    allocs = server.wait_for_allocs(job.namespace, job.id, job.task_groups[0].count)
    for a in allocs:
        a2 = type(a)(**{**a.__dict__})
        a2.client_status = "running"
        server.state.update_alloc_from_client(a2)
    return allocs


def test_new_version_creates_deployment(server):
    _cluster(server)
    job = _update_job()
    _register_v0_running(server, job)

    job2 = _update_job()
    job2.id = job.id
    job2.task_groups[0].tasks[0].env = {"v": "2"}
    ev = server.job_register(job2)
    assert server.wait_for_eval(ev.id) is not None

    d = _wait(lambda: server.state.latest_deployment_by_job("default", job.id))
    assert d is not None
    assert d.job_version == 1
    assert d.status == DEPLOYMENT_STATUS_RUNNING


def test_healthy_rollout_succeeds_and_marks_stable(server):
    _cluster(server)
    job = _update_job()
    _register_v0_running(server, job)

    job2 = _update_job()
    job2.id = job.id
    job2.task_groups[0].tasks[0].env = {"v": "2"}
    ev = server.job_register(job2)
    assert server.wait_for_eval(ev.id) is not None
    d = _wait(lambda: server.state.latest_deployment_by_job("default", job.id))
    assert d is not None

    # Mark every v1 alloc healthy as the client health watcher would.
    def new_allocs():
        return [
            a for a in server.state.allocs_by_job("default", job.id)
            if a.deployment_id == d.id and not a.terminal_status()
        ]

    allocs = _wait(lambda: new_allocs() if len(new_allocs()) >= 3 else None)
    for a in allocs:
        server.update_alloc_health(a.id, True)

    final = _wait(
        lambda: (
            server.state.deployment_by_id(d.id)
            if server.state.deployment_by_id(d.id).status
            == DEPLOYMENT_STATUS_SUCCESSFUL else None
        )
    )
    assert final.status == DEPLOYMENT_STATUS_SUCCESSFUL
    # job version marked stable
    stable = server.state.latest_stable_job("default", job.id)
    assert stable is not None and stable.version == 1


def test_promote_rejects_unhealthy_canaries(server):
    _cluster(server)
    job = _update_job()
    _register_v0_running(server, job)
    job2 = _update_job(canary=1)
    job2.id = job.id
    job2.task_groups[0].tasks[0].env = {"v": "2"}
    ev = server.job_register(job2)
    assert server.wait_for_eval(ev.id) is not None
    d = _wait(lambda: server.state.latest_deployment_by_job("default", job.id))
    _wait(lambda: [
        a for a in server.state.allocs_by_job("default", job.id)
        if a.deployment_id == d.id
    ])
    with pytest.raises(ValueError):
        server.deployment_promote(d.id)


# ---- tracker-driven scenarios: real alloc runners,
# real HealthTracker, NO update_alloc_health anywhere below ----


def _tracked_job(script="sleep 120", tag="0", count=2, **update_kw):
    job = mock.job()
    tg = job.task_groups[0]
    tg.count = count
    tg.networks = []  # no ports needed; keeps placement trivial
    kw = dict(max_parallel=count, min_healthy_time_s=0.2,
              healthy_deadline_s=10.0)
    kw.update(update_kw)
    tg.update = UpdateStrategy(**kw)
    job.update = tg.update
    t = tg.tasks[0]
    t.driver = "raw_exec"
    t.config = {"command": "/bin/sh", "args": ["-c", script]}
    t.env = {"v": tag}
    tg.restart_policy.attempts = 0  # broken versions fail fast
    return job


def _deploy_status(server, dep_id):
    return server.state.deployment_by_id(dep_id).status


class TestTrackerDriven:
    @pytest.mark.slow  # >10s on a cold host; tier-1 budget
    def test_canary_promotion_through_health_tracker(self, agent):
        server, _client = agent
        v0 = _tracked_job(tag="0")
        server.job_register(v0)
        d0 = _wait(lambda: server.state.latest_deployment_by_job(
            "default", v0.id))
        assert _wait(lambda: _deploy_status(server, d0.id)
                     == DEPLOYMENT_STATUS_SUCCESSFUL)

        v1 = _tracked_job(tag="1", canary=1)
        v1.id = v0.id
        server.job_register(v1)
        d1 = _wait(lambda: (
            lambda d: d if d is not None and d.id != d0.id else None
        )(server.state.latest_deployment_by_job("default", v0.id)))
        assert d1.task_groups["web"].desired_canaries == 1

        # exactly one canary runs, and the TRACKER marks it healthy
        def canaries():
            return [a for a in server.state.allocs_by_job("default", v0.id)
                    if a.deployment_id == d1.id and not a.terminal_status()]

        def one_healthy_canary():
            cs = canaries()  # capture once: re-querying per clause races
            return (len(cs) == 1 and cs[0].deployment_status is not None
                    and cs[0].deployment_status.is_healthy())

        assert _wait(one_healthy_canary)
        # healthy canary alone must NOT complete the deployment
        time.sleep(0.6)
        assert _deploy_status(server, d1.id) == DEPLOYMENT_STATUS_RUNNING

        server.deployment_promote(d1.id)
        # promotion rolls the remaining count; their trackers finish it
        assert _wait(lambda: _deploy_status(server, d1.id)
                     == DEPLOYMENT_STATUS_SUCCESSFUL, timeout=40.0), \
            server.state.deployment_by_id(d1.id).status_description
        stable = server.state.latest_stable_job("default", v0.id)
        assert stable is not None and stable.version == 1

    @pytest.mark.slow  # sibling-covered; tier-1 budget
    def test_auto_promote_through_health_tracker(self, agent):
        server, _client = agent
        v0 = _tracked_job(tag="0")
        server.job_register(v0)
        d0 = _wait(lambda: server.state.latest_deployment_by_job(
            "default", v0.id))
        assert _wait(lambda: _deploy_status(server, d0.id)
                     == DEPLOYMENT_STATUS_SUCCESSFUL)

        v1 = _tracked_job(tag="1", canary=1, auto_promote=True)
        v1.id = v0.id
        server.job_register(v1)
        d1 = _wait(lambda: (
            lambda d: d if d is not None and d.id != d0.id else None
        )(server.state.latest_deployment_by_job("default", v0.id)))
        # the tracker's healthy canary report triggers auto-promote and
        # the rollout runs to completion with no injected signal
        assert _wait(lambda: server.state.deployment_by_id(d1.id)
                     .task_groups["web"].promoted, timeout=40.0)
        assert _wait(lambda: _deploy_status(server, d1.id)
                     == DEPLOYMENT_STATUS_SUCCESSFUL, timeout=40.0)

    @pytest.mark.slow  # >20s on a cold host; tier-1 budget
    def test_auto_revert_chain_through_health_tracker(self, agent):
        """The full chain: v0 stable → broken v1 fails via tracker →
        auto-revert registers v2 (v0's spec) → v2's OWN deployment also
        completes via tracker and is marked stable."""
        server, _client = agent
        v0 = _tracked_job(tag="0", count=1, auto_revert=True)
        server.job_register(v0)
        d0 = _wait(lambda: server.state.latest_deployment_by_job(
            "default", v0.id))
        assert _wait(lambda: _deploy_status(server, d0.id)
                     == DEPLOYMENT_STATUS_SUCCESSFUL)
        assert server.state.latest_stable_job("default", v0.id).version == 0

        v1 = _tracked_job("exit 1", tag="1", count=1, auto_revert=True)
        v1.id = v0.id
        server.job_register(v1)
        d1 = _wait(lambda: (
            lambda d: d if d is not None and d.id != d0.id else None
        )(server.state.latest_deployment_by_job("default", v0.id)))
        assert _wait(lambda: _deploy_status(server, d1.id)
                     == DEPLOYMENT_STATUS_FAILED, timeout=40.0)

        # revert registered v0's spec as v2...
        v2 = _wait(lambda: (
            lambda j: j if j is not None and j.version > 1 else None
        )(server.state.job_by_id("default", v0.id)))
        assert not v2.spec_changed(v0) and v2.spec_changed(v1)
        # ...and the REVERT deployment itself converges + stabilizes v2
        d2 = _wait(lambda: (
            lambda d: d if d is not None and d.id not in (d0.id, d1.id)
            else None
        )(server.state.latest_deployment_by_job("default", v0.id)))
        assert _wait(lambda: _deploy_status(server, d2.id)
                     == DEPLOYMENT_STATUS_SUCCESSFUL, timeout=40.0)
        assert _wait(lambda: server.state.latest_stable_job(
            "default", v0.id).version == v2.version)

    def test_multi_group_rollout_through_health_tracker(self, agent):
        """A two-group job: the deployment completes only when BOTH
        groups' allocs report healthy through their trackers."""
        import copy

        server, _client = agent
        v0 = _tracked_job(tag="0", count=1)
        g2 = copy.deepcopy(v0.task_groups[0])
        g2.name = "api"
        g2.tasks[0].name = "api"
        v0.task_groups.append(g2)
        server.job_register(v0)
        d0 = _wait(lambda: server.state.latest_deployment_by_job(
            "default", v0.id))
        assert set(d0.task_groups) == {"web", "api"}
        assert _wait(lambda: _deploy_status(server, d0.id)
                     == DEPLOYMENT_STATUS_SUCCESSFUL, timeout=40.0), \
            server.state.deployment_by_id(d0.id).status_description
        healthy = [a for a in server.state.allocs_by_job("default", v0.id)
                   if a.deployment_status is not None
                   and a.deployment_status.is_healthy()]
        assert len(healthy) == 2  # one per group, both tracker-reported


# ---- the same rollouts through the reference's server and the port's ----


def _versions(tag, count=3, **update_kw):
    """A reference job and a version of it with env v=`tag`."""
    rm = mod(REF, "mock")
    us = mod(REF, "structs.job").UpdateStrategy
    job = rm.job()
    job.task_groups[0].count = count
    job.task_groups[0].update = us(max_parallel=count,
                                   min_healthy_time_s=0.0, **update_kw)
    job.update = job.task_groups[0].update
    job.task_groups[0].tasks[0].env = {"v": tag}
    return job


def _as_version(base, tag, **update_kw):
    v = _versions(tag, base.task_groups[0].count, **update_kw)
    v.id = base.id
    return v


def _dep_view(d):
    return (d.job_version, d.status, d.status_description,
            sorted((name, ds.desired_total, ds.desired_canaries,
                    ds.placed_allocs, ds.healthy_allocs,
                    ds.unhealthy_allocs, ds.promoted)
                   for name, ds in d.task_groups.items()))


def _rollout_scenario(pkg, nodes, versions, bad=None):
    """Register `versions` in turn, each driven to the end of its
    deployment by marking its allocs healthy (promoting canaries once
    healthy); then `bad`, whose first new alloc is marked unhealthy.
    Returns every deployment's end view, the stable and the last job
    version, and the live allocs' versions."""
    s = make_server(pkg, num_schedulers=1, heartbeat_ttl=60.0,
                    gc_interval=3600.0)
    s.start()
    try:
        for n in nodes:
            s.node_register(as_pkg(pkg, n))
        job_id = versions[0].id
        seen = []

        def allocs():
            return s.state.allocs_by_job("default", job_id)

        def running():
            for a in allocs():
                if a.desired_status == "run" and a.client_status == "pending":
                    upd = copy.copy(a)
                    upd.client_status = "running"
                    s.state.update_alloc_from_client(upd)

        def new_deployment():
            d = s.state.latest_deployment_by_job("default", job_id)
            return d if d is not None and d.id not in seen else None

        for i, v in enumerate(versions):
            ev = s.job_register(as_pkg(pkg, v))
            assert s.wait_for_eval(ev.id) is not None
            if i == 0 and v.task_groups[0].update is None:
                running()
                continue
            d = wait_for(new_deployment)
            assert d is not None, f"version {i}: no deployment"
            seen.append(d.id)

            def step():
                running()
                cur = s.state.deployment_by_id(d.id)
                for a in allocs():
                    if (a.deployment_id == d.id and not a.terminal_status()
                            and (a.deployment_status is None
                                 or a.deployment_status.healthy is None)):
                        s.update_alloc_health(a.id, True)
                if cur.requires_promotion() and all(
                        len(ds.placed_canaries) >= ds.desired_canaries
                        for ds in cur.task_groups.values()):
                    try:
                        s.deployment_promote(d.id)
                    except ValueError:
                        pass    # a canary not yet healthy: next poll
                return not s.state.deployment_by_id(d.id).active()

            assert wait_for(step), f"version {i}: deployment never ended"
        if bad is not None:
            s.job_register(as_pkg(pkg, bad))
            d = wait_for(new_deployment)
            seen.append(d.id)
            first = wait_for(lambda: [
                a for a in allocs()
                if a.deployment_id == d.id and not a.terminal_status()])
            s.update_alloc_health(first[0].id, False)
            assert wait_for(lambda: not s.state.deployment_by_id(
                d.id).active())
            assert wait_for(lambda: s.state.job_by_id(
                "default", job_id).version > d.job_version)

            def reverted():
                running()
                for dep in s.state.deployments():
                    if dep.job_id != job_id or not dep.active():
                        continue
                    for a in allocs():
                        if (a.deployment_id == dep.id
                                and not a.terminal_status()
                                and a.deployment_status is None):
                            s.update_alloc_health(a.id, True)
                version = s.state.job_by_id("default", job_id).version
                return all(a.job_version == version for a in allocs()
                           if a.desired_status == "run") and not any(
                    dep.active() for dep in s.state.deployments()
                    if dep.job_id == job_id)

            assert wait_for(reverted), "the revert never settled"
        stable = s.state.latest_stable_job("default", job_id)
        job = s.state.job_by_id("default", job_id)
        live = sorted(a.job_version for a in allocs()
                      if a.desired_status == "run")
        return dict(deployments=[_dep_view(s.state.deployment_by_id(d))
                                 for d in seen],
                    stable=stable and stable.version, version=job.version,
                    env=job.task_groups[0].tasks[0].env, live=live)
    finally:
        s.shutdown()


def _nodes(n=3):
    rm = mod(REF, "mock")
    return [rm.node() for _ in range(n)]


class TestAgainstReference:
    def test_rolling_update_equals_reference(self):
        v0 = _versions("0")
        v0.task_groups[0].update = v0.update = None
        v1 = _as_version(v0, "1")
        ref, got = run_both(_rollout_scenario, _nodes(), [v0, v1])
        assert got == ref
        (d1,) = got["deployments"]
        assert d1[:2] == (1, DEPLOYMENT_STATUS_SUCCESSFUL)
        assert got["stable"] == 1 and got["live"] == [1, 1, 1]

    def test_canary_promotion_equals_reference(self):
        v0 = _versions("0")
        v1 = _as_version(v0, "1", canary=1)
        ref, got = run_both(_rollout_scenario, _nodes(), [v0, v1])
        assert got == ref
        d0, d1 = got["deployments"]
        assert d1[1] == DEPLOYMENT_STATUS_SUCCESSFUL
        assert d1[3][0][2] == 1 and d1[3][0][6] is True   # canary, promoted
        assert got["stable"] == 1

    def test_auto_revert_equals_reference(self):
        v0 = _versions("0")
        v1 = _as_version(v0, "1", auto_revert=True)
        bad = _as_version(v0, "2", auto_revert=True)
        ref, got = run_both(_rollout_scenario, _nodes(), [v0, v1], bad)
        assert got == ref
        assert got["deployments"][-1][1] == DEPLOYMENT_STATUS_FAILED
        assert "rolling back to job version" in got["deployments"][-1][2]
        # the revert (v1's spec as a new version) rolled out and is stable
        assert got["version"] > 2 and got["stable"] == got["version"]
        assert got["env"] == {"v": "1"}
        assert set(got["live"]) == {got["version"]}
