"""Device asks in the port (BASELINE config 5): twins of the Harness-based
classes of `tests/test_devices.py`.

`TestDeviceAllocator` runs on the port's allocator and mocks.
`TestDeviceKernelOracleParity` selects through the port's
`TorchStack(device="cpu")` (the placement kernel's plain version) and
holds it to the scalar oracle, as the reference test holds `TPUStack`.
`TestDeviceE2E` and `TestMultiGroupNodes` run through both packages'
Harnesses fed the same objects (`torch_sched_cases.Twins`): the
reference test's assertions hold on the port, and the port's plans equal
the reference's by content (placements, metric counts, scores within
1e-6).
"""
from nomad_tpu import mock as ref_mock
from nomad_tpu.structs import RequestedDevice as RefRequestedDevice
from nomad_tpu.structs.job import Constraint as RefConstraint
from torch_sched_cases import Twins, placed

from nomad_tpu_torch import mock
from nomad_tpu_torch.scheduler.device import (DeviceAllocator,
                                              node_device_feasible)
from nomad_tpu_torch.scheduler.oracle import OracleContext, select_option
from nomad_tpu_torch.scheduler.stack import TorchStack
from nomad_tpu_torch.structs import Constraint, RequestedDevice
from nomad_tpu_torch.structs.job import Affinity
from nomad_tpu_torch.tensor.cluster import ClusterTensors


def gpu_job(count=1, ask="nvidia/gpu", dev_count=1, constraints=None,
            affinities=None, mk=mock, requested=RequestedDevice):
    job = mk.job()
    tg = job.task_groups[0]
    tg.count = count
    tg.tasks[0].resources.devices = [requested(
        name=ask, count=dev_count, constraints=constraints or [],
        affinities=affinities or [])]
    return job


def ref_gpu_job(**kw):
    return gpu_job(mk=ref_mock, requested=RefRequestedDevice, **kw)


class TestDeviceAllocator:
    def test_assign_returns_instance_ids(self):
        da = DeviceAllocator(mock.nvidia_node(), [])
        offer, err = da.assign(RequestedDevice(name="nvidia/gpu", count=2))
        assert err == ""
        assert offer.vendor == "nvidia" and offer.type == "gpu"
        assert len(offer.device_ids) == 2 == len(set(offer.device_ids))

    def test_assign_consumes_instances(self):
        da = DeviceAllocator(mock.nvidia_node(), [])
        ids = set()
        for _ in range(2):
            offer, _ = da.assign(RequestedDevice(name="nvidia/gpu", count=2))
            assert offer is not None
            ids.update(offer.device_ids)
        assert len(ids) == 4
        offer, err = da.assign(RequestedDevice(name="nvidia/gpu", count=1))
        assert offer is None and "no devices" in err

    def test_proposed_allocs_count(self):
        node = mock.nvidia_node()
        first = DeviceAllocator(node, []).assign(
            RequestedDevice(name="nvidia/gpu", count=3))[0]
        holder = mock.alloc()
        holder.node_id = node.id
        holder.client_status = "running"
        next(iter(holder.allocated_resources.tasks.values())).devices = [first]
        da = DeviceAllocator(node, [holder])
        offer, _err = da.assign(RequestedDevice(name="nvidia/gpu", count=2))
        assert offer is None
        offer, _err = da.assign(RequestedDevice(name="nvidia/gpu", count=1))
        assert offer is not None
        assert offer.device_ids[0] not in first.device_ids

    def test_constraints_on_device_attributes(self):
        node = mock.nvidia_node()
        ok = RequestedDevice(name="nvidia/gpu", count=1, constraints=[
            Constraint("${device.attr.cuda_cores}", "3584", "=")])
        bad = RequestedDevice(name="nvidia/gpu", count=1, constraints=[
            Constraint("${device.attr.cuda_cores}", "9999", "=")])
        da = DeviceAllocator(node, [])
        assert da.assign(ok)[0] is not None
        assert da.assign(bad)[0] is None
        assert node_device_feasible(node, gpu_job(
            constraints=[Constraint("${device.model}", "1080ti", "=")]
        ).task_groups[0])
        assert not node_device_feasible(node, gpu_job(
            constraints=[Constraint("${device.model}", "2080ti", "=")]
        ).task_groups[0])

    def test_affinity_prefers_matching_group(self):
        from nomad_tpu_torch.structs.resources import (NodeDeviceInstance,
                                                       NodeDeviceResource)

        node = mock.nvidia_node()
        node.node_resources.devices.append(NodeDeviceResource(
            vendor="nvidia", type="gpu", name="2080ti",
            instances=[NodeDeviceInstance(id=f"b-{k}", healthy=True)
                       for k in range(4)]))
        offer, _ = DeviceAllocator(node, []).assign(RequestedDevice(
            name="nvidia/gpu", count=1,
            affinities=[Affinity("${device.model}", "2080ti", "=", 100)]))
        assert offer is not None and offer.name == "2080ti"


class TestDeviceKernelOracleParity:
    def _cluster(self, n=6):
        cl = ClusterTensors()
        nodes = []
        for i in range(n):
            node = mock.nvidia_node() if i % 2 == 0 else mock.node()
            cl.upsert_node(node)
            nodes.append(node)
        return cl, nodes

    def test_only_gpu_nodes_selected(self):
        cl, nodes = self._cluster()
        job = gpu_job(count=3)
        tg = job.task_groups[0]
        result = TorchStack(cl, device="cpu").select(job, tg, 3)
        gpu_ids = {n.id for i, n in enumerate(nodes) if i % 2 == 0}
        assert all(nid in gpu_ids for nid in result.node_ids)
        opt = select_option(OracleContext(nodes=nodes, allocs_by_node={}),
                            job, tg)
        assert opt is not None and opt.node.id in gpu_ids
        assert abs(result.scores[0] - opt.final_score) < 1e-4

    def test_device_capacity_exhaustion_blocks(self):
        cl, nodes = self._cluster(2)
        job = gpu_job(dev_count=4)
        r1 = TorchStack(cl, device="cpu").select(job, job.task_groups[0], 2)
        assert r1.node_ids[0] == nodes[0].id
        assert r1.node_ids[1] is None

    def test_unmatched_ask_infeasible_everywhere(self):
        cl, nodes = self._cluster(2)
        job = gpu_job(ask="amd/gpu")
        tg = job.task_groups[0]
        assert TorchStack(cl, device="cpu").select(job, tg, 1).node_ids[0] \
            is None
        assert select_option(OracleContext(nodes=nodes, allocs_by_node={}),
                             job, tg) is None


def _run(t, job):
    t.upsert_job(job)
    t.process(ref_mock.eval_(job_id=job.id, type=job.type))
    t.assert_same()
    return placed(t.port)


def _devices(alloc):
    return [d for tr in alloc.allocated_resources.tasks.values()
            for d in tr.devices]


class TestDeviceE2E:
    def test_placed_alloc_carries_instance_ids(self):
        t = Twins()
        t.upsert_node(ref_mock.nvidia_node())
        got = _run(t, ref_gpu_job(count=2, dev_count=2))
        assert len(got) == 2
        seen = set()
        for a in got:
            devs = _devices(a)
            assert len(devs) == 1 and len(devs[0].device_ids) == 2
            seen.update(devs[0].device_ids)
        assert len(seen) == 4

    def test_exhausted_devices_block_eval(self):
        t = Twins()
        t.upsert_node(ref_mock.nvidia_node())
        assert len(_run(t, ref_gpu_job(count=3, dev_count=2))) == 2
        assert any(e.status == "blocked" for e in t.port.create_evals)


class TestMultiGroupNodes:
    def _two_group_node(self):
        from nomad_tpu.structs.resources import (NodeDeviceInstance,
                                                 NodeDeviceResource)

        node = ref_mock.nvidia_node()
        node.node_resources.devices.append(NodeDeviceResource(
            vendor="nvidia", type="gpu", name="2080ti",
            instances=[NodeDeviceInstance(id=f"b-{k}", healthy=True)
                       for k in range(4)]))
        return node

    def _holder(self, node):
        """A running alloc holding every 1080ti instance of `node`."""
        from nomad_tpu.scheduler.device import (
            DeviceAllocator as RefDeviceAllocator)

        holder = ref_mock.alloc()
        holder.node_id = node.id
        holder.client_status = "running"
        first = RefDeviceAllocator(node, []).assign(RefRequestedDevice(
            name="nvidia/gpu/1080ti", count=4))[0]
        next(iter(holder.allocated_resources.tasks.values())).devices = [
            first]
        return holder

    def test_pool_ask_uses_free_group_when_one_exhausted(self):
        t = Twins()
        node = self._two_group_node()
        t.upsert_node(node)
        t.upsert_alloc(self._holder(node))
        got = _run(t, ref_gpu_job(dev_count=2))
        assert len(got) == 1 and _devices(got[0])[0].name == "2080ti"

    def test_constrained_ask_retries_to_next_node(self):
        t = Twins()
        n1 = self._two_group_node()
        t.upsert_node(n1)
        n2 = ref_mock.nvidia_node()
        t.upsert_node(n2)
        t.upsert_alloc(self._holder(n1))
        got = _run(t, ref_gpu_job(dev_count=1, constraints=[
            RefConstraint("${device.model}", "1080ti", "=")]))
        assert len(got) == 1 and got[0].node_id == n2.id


class TestDeviceStatsHeartbeat:
    """The reference's `test_heartbeat_carries_stats_to_node_endpoint` on
    the port: a port client with a declared device group heartbeats its
    stats to a port server (`device="cpu"`), and the node endpoint of the
    port's HTTP API shows them."""

    def test_heartbeat_carries_stats_to_node_endpoint(self, tmp_path,
                                                      monkeypatch):
        import json
        import time
        import urllib.request

        from nomad_tpu_torch.agent.http import HTTPApi
        from nomad_tpu_torch.client import Client, ClientConfig, InProcConn
        from nomad_tpu_torch.server import Server, ServerConfig

        monkeypatch.setenv("NOMAD_TPU_FAKE_DEVICES", "acme/fpga/x1:2")
        server = Server(ServerConfig(num_schedulers=1, heartbeat_ttl=60.0,
                                     gc_interval=3600.0), device="cpu")
        server.start()
        client = Client(InProcConn(server),
                        ClientConfig(data_dir=str(tmp_path / "c"),
                                     heartbeat_interval=0.2))
        client.device_manager.stats_interval = 0.1

        class _Agent:   # the HTTP layer's minimal agent
            pass

        shim = _Agent()
        shim.server, shim.client = server, client
        api = HTTPApi(shim)
        api.start()
        client.start()
        try:
            deadline = time.time() + 10.0
            ds = None
            while time.time() < deadline and not ds:
                ds = server.node_device_stats(client.node.id)
                time.sleep(0.05)
            assert ds, "no device stats arrived on the heartbeat"
            assert "acme/fpga/x1" in ds["stats"]
            host, port = api.addr
            with urllib.request.urlopen(
                    f"http://{host}:{port}/v1/node/{client.node.id}") as r:
                tree = json.loads(r.read())
            assert "acme/fpga/x1" in tree["device_stats"]["stats"]
        finally:
            client.shutdown()
            api.shutdown()
            server.shutdown()
