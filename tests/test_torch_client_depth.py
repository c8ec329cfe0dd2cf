"""Twins of the reference's `tests/test_client_depth.py` (the client's
depth features behind an agent), run on the port: every agent, server
and harness is the port's with `device="cpu"`, its HTTP port ephemeral
and its data under `tmp_path`; the reference's `slow` marks are kept.
"""
import os
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.agent import Agent, AgentConfig
from nomad_tpu_torch.api import NomadClient
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


class TestHostStats:
    def test_client_stats_endpoint(self, agent):
        a, api = agent
        stats = api.client_stats()
        assert stats["Memory"]["Total"] > 0
        assert stats["Uptime"] > 0
        assert stats["DiskStats"] and stats["DiskStats"][0]["Size"] > 0


class TestHeartbeatStop:
    def test_disconnect_stops_marked_groups(self, agent):
        a, api = agent
        job = mock.job()
        tg = job.task_groups[0]
        tg.count = 1
        tg.stop_after_client_disconnect_s = 1.0
        t = tg.tasks[0]
        t.driver = "mock_driver"
        t.config = {"run_for": 60.0}
        api.wait_for_eval(api.register_job(job))
        assert _wait(lambda: any(
            al.client_status == "running"
            for al in api.job_allocations(job.id)))
        # simulate heartbeat silence past the group's limit
        a.client._last_heartbeat_ok = time.time() - 5.0
        a.client._heartbeat_stop_check()
        assert _wait(lambda: all(
            al.client_status in ("complete", "failed")
            for al in api.job_allocations(job.id)))


class TestTemplateHook:
    def test_embedded_template_rendered(self, agent):
        from nomad_tpu_torch.structs.job import Template

        a, api = agent
        job = mock.job()
        tg = job.task_groups[0]
        tg.count = 1
        t = tg.tasks[0]
        t.driver = "raw_exec"
        t.config = {"command": "/bin/sh",
                    "args": ["-c", "cat local/conf.ini"]}
        t.env = {"PORT_HINT": "8080"}
        t.templates = [Template(
            embedded_tmpl=("listen=${PORT_HINT}\n"
                           "dc=${node.datacenter}\n"),
            dest_path="local/conf.ini")]
        api.wait_for_eval(api.register_job(job))
        assert _wait(lambda: any(
            al.client_status == "complete"
            for al in api.job_allocations(job.id)))
        alloc = next(al for al in api.job_allocations(job.id)
                     if al.client_status == "complete")
        out = api.alloc_logs(alloc.id, "web")
        assert b"listen=8080" in out
        assert b"dc=dc1" in out


class TestStickyDiskMigration:
    @pytest.mark.slow  # >10s on a cold host; tier-1 budget
    def test_destructive_update_carries_shared_data(self, agent):
        a, api = agent
        job = mock.job()
        tg = job.task_groups[0]
        tg.count = 1
        tg.ephemeral_disk.sticky = True
        tg.ephemeral_disk.migrate = True
        t = tg.tasks[0]
        t.driver = "raw_exec"
        # keep v0 running so the update is destructive (stop + replace
        # with previous_allocation linkage)
        t.config = {"command": "/bin/sh",
                    "args": ["-c",
                             "echo v0-state > alloc/data/state.txt; "
                             "sleep 60"]}
        # transient start failures (executor handshake under full-suite
        # load) must retry fast — the default restart delay alone would
        # eat the test budget
        tg.restart_policy.delay_s = 1.0
        api.wait_for_eval(api.register_job(job))
        assert _wait(lambda: any(
            al.client_status == "running"
            for al in api.job_allocations(job.id)))
        v0 = next(al for al in api.job_allocations(job.id)
                  if al.client_status == "running")

        # "running" means the executor LAUNCHED the task, not that its
        # first shell line ran — on a slow host the destructive update
        # can kill v0 before echo ever executed, and migrating an empty
        # data dir is then correct behavior ("carried 0 entries").
        # Wait for the FILE before updating.
        def wrote():
            try:
                return b"v0-state" in api.alloc_fs_cat(
                    v0.id, "alloc/data/state.txt")
            except Exception:
                return False
        assert _wait(wrote, timeout=60), "v0 never wrote its state file"

        import copy

        job2 = copy.deepcopy(job)
        job2.version = 1
        job2.task_groups[0].tasks[0].config = {
            "command": "/bin/sh",
            "args": ["-c", "cat alloc/data/state.txt"]}
        api.wait_for_eval(api.register_job(job2))
        # generous: the destructive path serializes v0-stop → prev-alloc
        # terminal wait (itself bounded at 30s) → data copy → v1 run +
        # fast-retry restarts; under full-suite CPU contention the 90s
        # budget still flaked (round-5), so it carries real headroom now
        ok = _wait(lambda: any(
            al.client_status == "complete" and al.job_version == 1
            for al in api.job_allocations(job.id)), timeout=240.0)
        if not ok:
            import json as _json
            diag = {
                "allocs": [
                    {"id": al.id[:8], "client": al.client_status,
                     "desired": al.desired_status,
                     "job_version": al.job_version,
                     "alloc_job_ver": getattr(al.job, "version", None)
                     if al.job else None,
                     "task_cfg": (al.job.task_groups[0].tasks[0].config
                                  if al.job else None),
                     "events": {
                         t: [(e.type, e.message) for e in ts.events]
                         for t, ts in al.task_states.items()}}
                    for al in api.job_allocations(job.id)],
                "evals": [
                    {"id": e.id[:8], "status": e.status,
                     "triggered_by": e.triggered_by,
                     "failed": {tg: vars(m) for tg, m in
                                (e.failed_tg_allocs or {}).items()}}
                    for e in api.job_evaluations(job.id)],
            }
            raise AssertionError(
                "v1 never completed:\n" + _json.dumps(diag, indent=1,
                                                      default=str))
        alloc = next(al for al in api.job_allocations(job.id)
                     if al.client_status == "complete"
                     and al.job_version == 1)
        assert alloc.previous_allocation
        assert b"v0-state" in api.alloc_logs(alloc.id, "web")


class TestAgentConfigFile:
    def test_hcl_config_round_trip(self, tmp_path):
        from nomad_tpu_torch.agent import AgentConfig

        cfg = AgentConfig.from_hcl('''
        data_dir = "/var/lib/nomad-tpu"
        datacenter = "dc2"
        name = "edge-1"
        bind_addr = "0.0.0.0"
        server {
          enabled = true
          num_schedulers = 3
        }
        client {
          enabled = true
          meta { rack = "r9" }
          host_volume "certs" {
            path = "/etc/certs"
            read_only = true
          }
        }
        ports { http = 14646 }
        acl { enabled = true }
        plugin "docker" {
          config {
            volumes { enabled = true }
          }
        }
        plugin "raw_exec" { enabled = true }
        ''')
        assert cfg.data_dir == "/var/lib/nomad-tpu"
        assert cfg.datacenter == "dc2" and cfg.node_name == "edge-1"
        assert cfg.server and cfg.num_schedulers == 3
        assert cfg.client and cfg.node_meta == {"rack": "r9"}
        assert cfg.host_volumes["certs"]["read_only"] is True
        assert cfg.http_port == 14646 and cfg.acl_enabled
        # plugin stanzas reach the driver config (docker volumes gate)
        from nomad_tpu_torch.client.drivers.docker import DockerDriver

        assert DockerDriver(
            cfg.plugin_config["docker"])._volumes_enabled() is True
        assert cfg.plugin_config["raw_exec"]["enabled"] is True
        # mode blocks are opt-in
        cfg2 = AgentConfig.from_hcl('client { enabled = true }')
        assert cfg2.client and not cfg2.server


class TestOperatorSnapshot:
    def test_save_restore_round_trip(self, agent, tmp_path):
        a, api = agent
        job = mock.job()
        tg = job.task_groups[0]
        tg.count = 1
        tg.tasks[0].driver = "mock_driver"
        tg.tasks[0].config = {"run_for": 0.1}
        api.wait_for_eval(api.register_job(job))
        data = api.operator_snapshot_save()
        assert len(data) > 100

        # wipe the job, then restore the archive
        api.deregister_job(job.id)
        api.operator_snapshot_restore(data)
        got = api.job(job.id)
        assert got.id == job.id and not got.stop


class TestAgentMonitor:
    def test_monitor_returns_recent_logs(self, agent):
        import logging

        a, api = agent
        logging.getLogger("nomad_tpu_torch.test").info("hello-monitor")
        recs = api.agent_monitor()
        assert any("agent starting" in r["Message"] or
                   "hello-monitor" in r["Message"] for r in recs)
        # level filter + since pagination
        t = max(r["Time"] for r in recs)
        assert api.agent_monitor(since=t) == []


class TestAllocExecAndStats:
    @pytest.mark.slow  # >10s on a cold host; tier-1 budget
    def test_exec_into_running_task(self, agent):
        a, api = agent
        job = mock.job()
        tg = job.task_groups[0]
        tg.count = 1
        t = tg.tasks[0]
        t.driver = "raw_exec"
        t.config = {"command": "/bin/sh", "args": ["-c", "sleep 30"]}
        api.wait_for_eval(api.register_job(job))
        assert _wait(lambda: any(
            al.client_status == "running"
            for al in api.job_allocations(job.id)))
        alloc = api.job_allocations(job.id)[0]
        out = api.alloc_exec(alloc.id, ["/bin/sh", "-c", "echo in-task"])
        assert out["exit_code"] == 0
        assert "in-task" in out["stdout"]
        # exit codes propagate
        out = api.alloc_exec(alloc.id, ["/bin/sh", "-c", "exit 3"])
        assert out["exit_code"] == 3

        stats = api.alloc_stats(alloc.id)
        assert "web" in stats["Tasks"]

    @pytest.mark.slow  # >10s on a cold host; tier-1 budget
    def test_cli_alloc_exec(self, agent, capsys):
        from nomad_tpu_torch.cli import main

        a, api = agent
        job = mock.job()
        tg = job.task_groups[0]
        tg.count = 1
        t = tg.tasks[0]
        t.driver = "raw_exec"
        t.config = {"command": "/bin/sh", "args": ["-c", "sleep 30"]}
        api.wait_for_eval(api.register_job(job))
        assert _wait(lambda: any(
            al.client_status == "running"
            for al in api.job_allocations(job.id)))
        alloc = api.job_allocations(job.id)[0]
        addr = f"http://{a.http_addr[0]}:{a.http_addr[1]}"
        rc = main(["-address", addr, "alloc", "exec", alloc.id[:8],
                   "/bin/echo", "via-cli"])
        out = capsys.readouterr().out
        assert rc == 0 and "via-cli" in out


class TestMigrationHold:
    """The replacement alloc holds its predecessor as a migration
    source; destroy() of the predecessor waits the hold out so the
    copy can never read a half-deleted tree (reference
    prevAllocWatcher/GC coordination)."""

    def test_hold_refcounts_and_releases(self):
        from nomad_tpu_torch.client import alloc_runner as ar

        with ar._migration_hold("p1") as usable:
            assert usable
            assert ar._MIGRATION_SOURCES["p1"] == 1
            with ar._migration_hold("p1") as usable2:
                assert usable2
                assert ar._MIGRATION_SOURCES["p1"] == 2
            assert ar._MIGRATION_SOURCES["p1"] == 1
        assert "p1" not in ar._MIGRATION_SOURCES

    def test_hold_after_destroy_starts_is_unusable(self):
        """A hold acquired once destroy passed its zero-count check
        must refuse the source (fresh disk, never a half-deleted
        copy)."""
        from nomad_tpu_torch.client import alloc_runner as ar

        with ar._MIGRATION_CV:
            ar._MIGRATION_DESTROYING.add("p3")
        try:
            with ar._migration_hold("p3") as usable:
                assert not usable
        finally:
            with ar._MIGRATION_CV:
                ar._MIGRATION_DESTROYING.discard("p3")

    def test_waiter_unblocks_on_release(self):
        import threading

        from nomad_tpu_torch.client import alloc_runner as ar

        release = threading.Event()
        done = threading.Event()

        def holder():
            with ar._migration_hold("p2"):
                release.wait(10)
            done.set()

        t = threading.Thread(target=holder, daemon=True)
        t.start()
        assert _wait(lambda: ar._MIGRATION_SOURCES.get("p2") == 1,
                     timeout=5)
        # a destroy-side waiter parks until the hold drops
        waited = []

        def waiter():
            with ar._MIGRATION_CV:
                while ar._MIGRATION_SOURCES.get("p2", 0) > 0:
                    ar._MIGRATION_CV.wait(5)
            waited.append(True)

        w = threading.Thread(target=waiter, daemon=True)
        w.start()
        time.sleep(0.3)
        assert not waited  # still held
        release.set()
        assert _wait(lambda: bool(waited), timeout=5)
        t.join(5)
        w.join(5)
