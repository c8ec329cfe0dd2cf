"""Twins of the reference's `tests/test_templates_dynamic.py` (dynamic
templates), run on the port: every agent, server and harness is the
port's with `device="cpu"`, its HTTP port ephemeral and its data under
`tmp_path`; the reference's `slow` marks are kept.
"""
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.agent import Agent, AgentConfig
from nomad_tpu_torch.api import NomadClient
from nomad_tpu_torch.client.task_runner import TaskRunner
from nomad_tpu_torch.structs.job import Template
from nomad_tpu_torch.structs.secrets import SecretEntry
from nomad_tpu_torch.structs.service import ServiceRegistration
from torch_chain_cases import one_torch_thread  # noqa: F401


def _wait(cond, timeout=30.0, step=0.1):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(step)
    return cond()


@pytest.fixture()
def agent(tmp_path, monkeypatch):
    monkeypatch.setattr(TaskRunner, "TEMPLATE_POLL_S", 0.25)
    a = Agent(AgentConfig(data_dir=str(tmp_path / "data"),
                          heartbeat_ttl=60.0), device="cpu")
    a.start()
    api = NomadClient(a.http_addr[0], a.http_addr[1])
    assert _wait(lambda: len(api.nodes()) == 1)
    yield a, api
    # stop jobs BEFORE shutdown — shutdown detaches executor tasks for
    # recovery, and this file's long sleeps would outlive the test
    try:
        alloc_ids = [al.id for j in api.jobs()
                     for al in api.job_allocations(j.id)]
        for j in api.jobs():
            api.deregister_job(j.id)
        _wait(lambda: all(
            api.allocation(aid).client_status
            in ("complete", "failed", "lost") for aid in alloc_ids),
            timeout=15)
    except Exception:
        pass
    a.shutdown()


def _running_alloc(api, job_id):
    return next((al for al in api.job_allocations(job_id)
                 if al.client_status == "running"), None)


def _logs(api, alloc_id, task):
    """Task stdout so far; b"" while the log file does not exist yet."""
    try:
        return api.alloc_logs(alloc_id, task)
    except Exception:
        return b""


class TestServiceTemplates:
    @pytest.mark.slow  # >20s on a cold host; tier-1 budget
    def test_catalog_change_rerenders_and_signals(self, agent):
        """A `${service.backend}` template re-renders when the catalog
        gains a passing instance; change_mode=signal HUPs the task,
        which cats the fresh file to its log."""
        a, api = agent
        job = mock.job()
        tg = job.task_groups[0]
        tg.count = 1
        t = tg.tasks[0]
        t.driver = "raw_exec"
        t.config = {
            "command": "/bin/sh",
            "args": ["-c",
                     "trap 'cat local/upstreams.conf' HUP; "
                     "echo started; "
                     "while :; do sleep 0.2; done"],
        }
        t.templates = [Template(
            embedded_tmpl="backend=${service.backend}\n",
            dest_path="local/upstreams.conf",
            change_mode="signal")]
        api.wait_for_eval(api.register_job(job))
        assert _wait(lambda: _running_alloc(api, job.id) is not None)
        alloc = _running_alloc(api, job.id)

        # initial render: empty catalog → empty value
        runner = a.client.alloc_runner(alloc.id)
        dest = None
        for tr in runner.task_runners.values():
            if tr.task.name == t.name:
                dest = tr._template_dest(t.templates[0])
        assert dest is not None
        assert _wait(lambda: open(dest).read() == "backend=\n",
                     timeout=30)

        reg = ServiceRegistration(
            id="_manual-backend-1", service_name="backend",
            namespace="default", address="10.0.0.7", port=9090,
            alloc_id="ext", status="passing")
        a.server.update_service_registrations([reg])

        # watcher re-renders and fires SIGHUP → task logs the new file
        # generous: on a 1-CPU host under the full suite, executor
        # start + first log flush alone can eat tens of seconds
        assert _wait(
            lambda: b"backend=10.0.0.7:9090"
            in _logs(api, alloc.id, t.name), timeout=60), \
            _logs(api, alloc.id, t.name)
        assert open(dest).read() == "backend=10.0.0.7:9090\n"

    def test_scope_filters_and_orders_instances(self, agent):
        """Only passing instances resolve, deterministically ordered;
        .addr/.port expose the first instance."""
        a, api = agent
        regs = [
            ServiceRegistration(id="b", service_name="db",
                                namespace="default", address="10.0.0.2",
                                port=5432, alloc_id="x", status="passing"),
            ServiceRegistration(id="a", service_name="db",
                                namespace="default", address="10.0.0.1",
                                port=5432, alloc_id="x", status="passing"),
            ServiceRegistration(id="c", service_name="db",
                                namespace="default", address="10.0.0.9",
                                port=5432, alloc_id="x", status="critical"),
        ]
        a.server.update_service_registrations(regs)

        job = mock.job()
        tg = job.task_groups[0]
        tg.count = 1
        t = tg.tasks[0]
        t.driver = "raw_exec"
        t.config = {"command": "/bin/sh",
                    "args": ["-c", "cat local/db.conf"]}
        t.templates = [Template(
            embedded_tmpl=("all=${service.db}\n"
                           "addr=${service.db.addr}\n"
                           "port=${service.db.port}\n"),
            dest_path="local/db.conf")]
        api.wait_for_eval(api.register_job(job))
        assert _wait(lambda: any(
            al.client_status == "complete"
            for al in api.job_allocations(job.id)))
        alloc = next(al for al in api.job_allocations(job.id)
                     if al.client_status == "complete")
        out = api.alloc_logs(alloc.id, t.name)
        assert b"all=10.0.0.1:5432,10.0.0.2:5432\n" in out
        assert b"addr=10.0.0.1\n" in out
        assert b"port=5432\n" in out


class TestSecretTemplates:
    def test_kv_write_rerenders_and_restarts(self, agent):
        """A template over NOMAD_SECRET_* re-renders when the KV path is
        rewritten; change_mode=restart relaunches the task, which sees
        both the new file and the new env."""
        a, api = agent
        a.server.secret_upsert(SecretEntry(
            namespace="default", path="db/creds",
            data={"pass": "v1"}))

        job = mock.job()
        tg = job.task_groups[0]
        tg.count = 1
        t = tg.tasks[0]
        t.driver = "raw_exec"
        t.secrets = ["db/creds"]
        t.config = {
            "command": "/bin/sh",
            "args": ["-c",
                     "cat local/db.conf; "
                     'echo "env=$NOMAD_SECRET_DB_CREDS_PASS"; '
                     "sleep 60"],
        }
        t.templates = [Template(
            embedded_tmpl="pass=${NOMAD_SECRET_DB_CREDS_PASS}\n",
            dest_path="local/db.conf",
            change_mode="restart")]
        api.wait_for_eval(api.register_job(job))
        assert _wait(lambda: _running_alloc(api, job.id) is not None)
        alloc = _running_alloc(api, job.id)
        assert _wait(lambda: b"pass=v1" in _logs(api, alloc.id, t.name),
                     timeout=60)

        a.server.secret_upsert(SecretEntry(
            namespace="default", path="db/creds",
            data={"pass": "v2"}))

        # watcher re-fetches the secret, re-renders, restarts: the new
        # run logs the new file AND the refreshed env
        assert _wait(
            lambda: b"pass=v2" in _logs(api, alloc.id, t.name)
            and b"env=v2" in _logs(api, alloc.id, t.name),
            timeout=30), _logs(api, alloc.id, t.name)
        states = _running_alloc(api, job.id).task_states[t.name]
        assert states.restarts >= 1

    def test_watcher_stops_when_task_completes(self, agent):
        """A naturally-completed task's watcher exits — no perpetual
        polling or change_mode events on a dead task."""
        a, api = agent
        job = mock.job()
        tg = job.task_groups[0]
        tg.count = 1
        t = tg.tasks[0]
        t.driver = "raw_exec"
        t.config = {"command": "/bin/sh",
                    "args": ["-c", "cat local/up.conf"]}
        t.templates = [Template(
            embedded_tmpl="up=${service.nothere}\n",
            dest_path="local/up.conf")]
        api.wait_for_eval(api.register_job(job))
        assert _wait(lambda: any(
            al.client_status == "complete"
            for al in api.job_allocations(job.id)))
        alloc = next(al for al in api.job_allocations(job.id)
                     if al.client_status == "complete")
        runner = a.client.alloc_runner(alloc.id)
        tr = next(x for x in runner.task_runners.values()
                  if x.task.name == t.name)
        assert tr._tmpl_stop.is_set()
        assert _wait(lambda: tr._tmpl_thread is None
                     or not tr._tmpl_thread.is_alive(), timeout=5)

    def test_static_template_spawns_no_watcher(self, agent):
        """Templates with no dynamic source never start a watch thread."""
        a, api = agent
        job = mock.job()
        tg = job.task_groups[0]
        tg.count = 1
        t = tg.tasks[0]
        t.driver = "raw_exec"
        t.config = {"command": "/bin/sh",
                    "args": ["-c", "cat local/static.conf; sleep 30"]}
        t.templates = [Template(
            embedded_tmpl="dc=${node.datacenter}\n",
            dest_path="local/static.conf")]
        api.wait_for_eval(api.register_job(job))
        assert _wait(lambda: _running_alloc(api, job.id) is not None)
        alloc = _running_alloc(api, job.id)
        runner = a.client.alloc_runner(alloc.id)
        for tr in runner.task_runners.values():
            assert tr._tmpl_thread is None
