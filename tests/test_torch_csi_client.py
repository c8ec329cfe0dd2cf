"""Twins of the reference's `tests/test_csi_client.py` (the CSI client and
its agent routes), run on the port: every agent, server and harness is
the port's with `device="cpu"`, its HTTP port ephemeral and its data
under `tmp_path`; the reference's `slow` marks are kept.
"""
import os
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.agent import Agent, AgentConfig
from nomad_tpu_torch.api import NomadClient
from nomad_tpu_torch.structs.csi import CSIVolume
from nomad_tpu_torch.structs.job import VolumeMount, VolumeRequest
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


def csi_job(script, vol_source="vol0", read_only=False):
    job = mock.job()
    tg = job.task_groups[0]
    tg.count = 1
    tg.volumes = {"data": VolumeRequest(
        name="data", type="csi", source=vol_source, read_only=read_only)}
    t = tg.tasks[0]
    t.driver = "raw_exec"
    t.config = {"command": "/bin/sh", "args": ["-c", script]}
    t.volume_mounts = [VolumeMount(volume="data", destination="/data")]
    return job


class TestCsiMountPath:
    def test_unit_manager_stage_publish(self, tmp_path):
        from nomad_tpu_torch.client.csi import CsiManager, HostPathCsiPlugin

        mgr = CsiManager(str(tmp_path / "csi"))
        mgr.register(HostPathCsiPlugin("hp", str(tmp_path / "backing")))
        p1 = mgr.mount_volume("hp", "v1", "alloc-a")
        p2 = mgr.mount_volume("hp", "v1", "alloc-b")
        assert os.path.islink(p1) and os.path.islink(p2)
        with open(os.path.join(p1, "f"), "w") as f:
            f.write("shared")
        assert open(os.path.join(p2, "f")).read() == "shared"
        mgr.unmount_volume("hp", "v1", "alloc-a")
        assert not os.path.lexists(p1)
        assert os.path.islink(p2)  # still staged for alloc-b
        mgr.unmount_volume("hp", "v1", "alloc-b")
        assert mgr._usage == {}
        with pytest.raises(Exception):
            mgr.mount_volume("nope", "v1", "a")

    def test_task_sees_mount_and_data_persists(self, agent):
        a, api = agent
        vol = CSIVolume(id="vol0", name="vol0", plugin_id="hostpath")
        api.csi_volume_register(vol)

        writer = csi_job("echo persisted > data/out.txt")
        api.wait_for_eval(api.register_job(writer))
        assert _wait(lambda: any(
            al.client_status == "complete"
            for al in api.job_allocations(writer.id)))

        # a second job over the same volume sees the first job's data
        reader = csi_job("cat data/out.txt")
        api.wait_for_eval(api.register_job(reader))
        assert _wait(lambda: any(
            al.client_status == "complete"
            for al in api.job_allocations(reader.id)))
        alloc = next(al for al in api.job_allocations(reader.id)
                     if al.client_status == "complete")
        assert b"persisted" in api.alloc_logs(alloc.id, "web")

        # the volume carries the claims of both allocs until reaped
        got = api.csi_volume("vol0")
        assert got.plugin_id == "hostpath"

    def test_missing_volume_fails_placement_or_alloc(self, agent):
        a, api = agent
        job = csi_job("true", vol_source="missing-vol")
        ev_id = api.register_job(job)
        ev = api.wait_for_eval(ev_id)
        # scheduler-side: unknown CSI volume poisons feasibility → blocked
        assert ev.status in ("complete", "blocked")
        assert not any(al.client_status == "complete"
                       for al in api.job_allocations(job.id))

    def test_host_volume_mount(self, agent, tmp_path):
        from nomad_tpu_torch.structs.node import ClientHostVolumeConfig

        a, api = agent
        hv = tmp_path / "hostvol"
        hv.mkdir()
        (hv / "seed.txt").write_text("from-host")
        # fingerprint the host volume onto the node and re-register
        a.client.node.host_volumes = {
            "shared": ClientHostVolumeConfig(name="shared", path=str(hv))}
        a.client.conn.node_register(a.client.node)

        job = csi_job("cat data/seed.txt")
        job.task_groups[0].volumes = {"data": VolumeRequest(
            name="data", type="host", source="shared")}
        api.wait_for_eval(api.register_job(job))
        assert _wait(lambda: any(
            al.client_status == "complete"
            for al in api.job_allocations(job.id)))
        alloc = api.job_allocations(job.id)[0]
        assert b"from-host" in api.alloc_logs(alloc.id, "web")


class TestCsiControllerPath:
    """The controller attach/publish leg
    (nomad/csi_endpoint.go:458 ControllerAttachVolume,
    plugins/csi/plugin.go:38 ControllerPublishVolume; here a
    client-polled controller work queue — server/server.py
    csi_controller_poll)."""

    def test_unit_controller_publish_context(self, tmp_path):
        from nomad_tpu_torch.client.csi import (CsiManager,
                                          HostPathCsiControllerPlugin,
                                          HostPathCsiPlugin)

        root = str(tmp_path / "backing")
        ctrl = HostPathCsiControllerPlugin("hp", root)
        ctx = ctrl.controller_publish_volume("v1", "node-a")
        assert os.path.isdir(ctx["device_path"])
        assert ctrl.attached_nodes("v1") == {"node-a"}
        mgr = CsiManager(str(tmp_path / "csi"))
        mgr.register(HostPathCsiPlugin("hp", root))
        p = mgr.mount_volume("hp", "v1", "alloc-a", publish_context=ctx)
        # the node mount is backed by the controller-surfaced device
        assert os.path.realpath(p) == os.path.realpath(ctx["device_path"])
        ctrl.controller_unpublish_volume("v1", "node-a")
        assert ctrl.attached_nodes("v1") == set()

    def test_e2e_controller_volume_attach_detach(self, agent):
        """register (controller_required) → schedule → controller
        publishes for the alloc's node → node stages from the publish
        context → task writes through the mount → claims released →
        controller unpublishes the node."""
        a, api = agent
        vol = CSIVolume(id="cvol", name="cvol", plugin_id="hostpath",
                        controller_required=True)
        api.csi_volume_register(vol)

        job = csi_job("echo via-controller > data/out.txt",
                      vol_source="cvol")
        api.wait_for_eval(api.register_job(job))
        assert _wait(lambda: any(
            al.client_status == "complete"
            for al in api.job_allocations(job.id)))

        node_id = a.client.node.id
        got = a.server.state.csi_volume("default", "cvol")
        # the controller attached THIS node and the context was recorded
        assert node_id in got.publish_contexts, got.publish_contexts
        ctrl = a.client.csi.controllers["hostpath"]
        assert node_id in ctrl.attached_nodes("cvol")
        # the write went through the controller-surfaced device
        device = got.publish_contexts[node_id]["device_path"]
        assert open(os.path.join(device, "out.txt")).read().strip() \
            == "via-controller"

        # volumewatcher: terminal alloc -> claims released -> unpublish
        assert _wait(lambda: not a.server.state.csi_volume(
            "default", "cvol").in_use())
        assert _wait(lambda: node_id not in a.server.state.csi_volume(
            "default", "cvol").publish_contexts)
        assert _wait(lambda: ctrl.attached_nodes("cvol") == set())

    def test_controller_error_fails_alloc(self, agent, monkeypatch):
        """A failing controller publish surfaces as an alloc failure,
        not a silent unattached mount."""
        from nomad_tpu_torch.client.csi import HostPathCsiControllerPlugin

        a, api = agent

        def boom(self, volume_id, node_id, readonly=False):
            raise RuntimeError("backend rejected attach")

        monkeypatch.setattr(HostPathCsiControllerPlugin,
                            "controller_publish_volume", boom)
        vol = CSIVolume(id="badvol", name="badvol", plugin_id="hostpath",
                        controller_required=True)
        api.csi_volume_register(vol)
        job = csi_job("true", vol_source="badvol")
        api.wait_for_eval(api.register_job(job))
        assert _wait(lambda: any(
            al.client_status == "failed"
            for al in api.job_allocations(job.id)))
        got = a.server.state.csi_volume("default", "badvol")
        assert "backend rejected attach" in str(
            got.controller_errors.values())


class TestControllerRaces:
    """State-level controller-queue edge cases (round-5 advisor)."""

    def _server_with_vol(self, tmp_path):
        from nomad_tpu_torch.server import Server, ServerConfig

        s = Server(ServerConfig(num_schedulers=0, heartbeat_ttl=3600.0), device="cpu")
        n = mock.node()
        n.csi_controller_plugins = {"hostpath": {"healthy": True}}
        s.state.upsert_node(n)
        vol = CSIVolume(id="v", plugin_id="hostpath",
                        controller_required=True,
                        access_mode="multi-node-multi-writer")
        s.state.upsert_csi_volume(vol)
        return s, n, vol

    def test_reclaim_cancels_pending_unpublish(self, tmp_path):
        s, n, vol = self._server_with_vol(tmp_path)
        alloc = mock.alloc()
        alloc.node_id = n.id
        s.state.upsert_alloc(alloc)
        # attached, then the watcher queued a detach
        vol.publish_contexts[n.id] = {"device_path": "/dev/x"}
        s.state.csi_controller_request("default", "v", n.id, "unpublish")
        # a replacement alloc claims before the detach runs: the pending
        # op must flip to publish, not be left to wipe the context
        assert s.csi_volume_claim("default", "v", alloc.id, "write")
        got = s.state.csi_volume("default", "v")
        assert got.controller_pending[n.id]["op"] == "publish"
        # the in-flight unpublish result lands late: the detach DID run,
        # so the now-stale context is dropped — a waiter must block until
        # the re-publish lands rather than mount from a detached device
        s.state.csi_controller_done("default", "v", n.id, "unpublish")
        assert n.id not in got.publish_contexts
        # ...and the converted publish op is still queued to renew it
        assert got.controller_pending[n.id]["op"] == "publish"
        s.state.csi_controller_done("default", "v", n.id, "publish",
                                    {"device_path": "/dev/y"})
        assert got.publish_contexts[n.id]["device_path"] == "/dev/y"
        assert n.id not in got.controller_pending

    def test_controller_op_leased_to_one_host(self, tmp_path):
        """Two clients hosting the same controller plugin must not both
        execute one op: the first poll leases it, the second host only
        inherits after lease expiry (crash recovery)."""
        s, n, vol = self._server_with_vol(tmp_path)
        n2 = mock.node()
        n2.csi_controller_plugins = {"hostpath": {"healthy": True}}
        s.state.upsert_node(n2)
        alloc = mock.alloc()
        alloc.node_id = n.id
        s.state.upsert_alloc(alloc)
        assert s.csi_volume_claim("default", "v", alloc.id, "write")
        ops1 = s.csi_controller_poll(n.id)
        assert len(ops1) == 1 and ops1[0]["op"] == "publish"
        # second host polls while the lease is live: nothing handed out
        assert s.csi_controller_poll(n2.id) == []
        # the lessee itself may re-poll (retry after transient failure)
        assert len(s.csi_controller_poll(n.id)) == 1
        # lease expiry hands the op to the second host
        got = s.state.csi_volume("default", "v")
        key = ("default", "v", n.id)
        lessee, ts = s.state._ctrl_leases[key]
        assert lessee == n.id
        s.state._ctrl_leases[key] = (lessee, ts - 60.0)
        ops2 = s.csi_controller_poll(n2.id)
        assert len(ops2) == 1 and ops2[0]["op"] == "publish"
        # ...after which the first host is locked out until THAT expires
        assert s.csi_controller_poll(n.id) == []
        # the superseded host's late report (success or error) is
        # DISCARDED — it must not delete the live lessee's op or poison
        # the attach with its error
        s.csi_controller_done("default", "v", n.id, "publish",
                              None, "timed out", reporter=n.id)
        assert got.controller_pending[n.id]["op"] == "publish"
        assert n.id not in got.controller_errors
        # the live lessee's result lands
        s.csi_controller_done("default", "v", n.id, "publish",
                              {"device_path": "/dev/x"}, "",
                              reporter=n2.id)
        assert n.id not in got.controller_pending
        assert got.publish_contexts[n.id]["device_path"] == "/dev/x"
        assert key not in s.state._ctrl_leases
        # leases never leak into the serialized volume (snapshot purity)
        from nomad_tpu_torch.structs.codec import to_wire

        wire = to_wire(got)
        assert "lease" not in str(wire)

    def test_readonly_claim_rides_to_controller(self, tmp_path):
        s, n, vol = self._server_with_vol(tmp_path)
        alloc = mock.alloc()
        alloc.node_id = n.id
        s.state.upsert_alloc(alloc)
        assert s.csi_volume_claim("default", "v", alloc.id, "read")
        ops = s.csi_controller_poll(n.id)
        assert ops and ops[0]["op"] == "publish"
        assert ops[0]["readonly"] is True

    def test_down_controller_host_poisons_feasibility(self, tmp_path):
        from nomad_tpu_torch.scheduler.util import resolve_volume_asks
        from nomad_tpu_torch.structs.job import VolumeRequest
        from nomad_tpu_torch.structs.node import NODE_STATUS_DOWN

        s, n, vol = self._server_with_vol(tmp_path)
        tg = mock.job().task_groups[0]
        tg.volumes = {"data": VolumeRequest(name="data", type="csi",
                                            source="v")}
        asks = resolve_volume_asks(s.state, "default", tg)
        assert asks == [("csi", "hostpath", False)]
        n.status = NODE_STATUS_DOWN
        s.state.upsert_node(n)
        asks = resolve_volume_asks(s.state, "default", tg)
        assert asks == [("missing", "v", False)]
