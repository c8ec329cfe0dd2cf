"""The port's host fingerprint and device plugins:
`nomad_tpu_torch/client/fingerprint.py` and `client/devicemanager.py`.

Twins of the reference's cloud and CNI fingerprint cases
(`tests/test_fingerprint_cloud.py`) and of `TestDeviceFingerprint` and
`TestDeviceManager` (`tests/test_devices.py`; the heartbeat's stats are
read from the server, then through the port's HTTP API on the node
endpoint), run on the port. Then what replaces the TPU probe: the
`nvidia-smi` GPU fingerprint, bounded as the reference's probe is, on
canned, wedged, failing and missing probes; `GpuDevicePlugin`'s health
and reservation. Across the packages: the fingerprinters both share give
one host equal attributes, and a job asking for the canned card is placed
by the port's server on the node that carries it, whose device pool
column equals the reference's.
"""
import json
import os
import subprocess
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.client import fingerprint as fp
from nomad_tpu_torch.client.fingerprint import (cni_fingerprint,
                                                env_aws_fingerprint,
                                                env_gce_fingerprint)
from nomad_tpu_torch.structs import Node

#: two cards as `nvidia-smi --query-gpu=... --format=csv,noheader,nounits`
#: prints them on one H100 host
H100_ROWS = ("0, GPU-0a1b2c3d-0000-1111-2222-333344445555, "
             "NVIDIA H100 80GB HBM3, 81559, 700.00, 580.159.03, 9.0\n"
             "1, GPU-0a1b2c3d-6666-7777-8888-999900001111, "
             "NVIDIA H100 80GB HBM3, 81559, 700.00, 580.159.03, 9.0\n")
H100 = "nvidia-h100-80gb-hbm3"
UUIDS = ["GPU-0a1b2c3d-0000-1111-2222-333344445555",
         "GPU-0a1b2c3d-6666-7777-8888-999900001111"]


@pytest.fixture()
def fake_smi(tmp_path, monkeypatch):
    """An `nvidia-smi` on PATH that prints what the test puts in
    `<tmp>/smi.out` and exits with `<tmp>/smi.rc`."""
    out, rc = tmp_path / "smi.out", tmp_path / "smi.rc"
    out.write_text(H100_ROWS)
    rc.write_text("0")
    smi = tmp_path / "bin" / "nvidia-smi"
    smi.parent.mkdir()
    smi.write_text(f"#!/bin/sh\ncat {out}\nexit $(cat {rc})\n")
    smi.chmod(0o755)
    monkeypatch.setenv("PATH", f"{smi.parent}{os.pathsep}"
                               f"{os.environ['PATH']}")
    monkeypatch.delenv("NOMAD_TPU_SKIP_GPU_FINGERPRINT", raising=False)
    return out, rc


@pytest.fixture()
def metadata_server():
    routes = {}

    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            body = routes.get(self.path)
            if body is None:
                self.send_response(404)
                self.end_headers()
                return
            data = body.encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield routes, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()


class TestCloudFingerprints:
    def test_gce(self, metadata_server, monkeypatch):
        routes, base = metadata_server
        routes.update({
            "/instance/machine-type":
                "projects/1/machineTypes/n2-standard-8",
            "/instance/zone": "projects/1/zones/us-central1-a",
            "/instance/hostname": "vm1.c.proj.internal",
            "/instance/id": "12345",
        })
        monkeypatch.setenv("NOMAD_TPU_GCE_METADATA_URL", base)
        node = Node()
        env_gce_fingerprint(node)
        assert node.attributes["platform.gce.machine-type"] \
            == "n2-standard-8"
        assert node.attributes["platform.gce.zone"] == "us-central1-a"
        assert node.attributes["unique.platform.gce.id"] == "12345"

    def test_gce_not_on_cloud_is_silent(self, metadata_server,
                                        monkeypatch):
        routes, base = metadata_server  # no routes → 404s
        monkeypatch.setenv("NOMAD_TPU_GCE_METADATA_URL", base)
        node = Node()
        env_gce_fingerprint(node)
        assert not any(k.startswith("platform.gce")
                       for k in node.attributes)

    def test_aws(self, metadata_server, monkeypatch):
        routes, base = metadata_server
        routes.update({
            "/instance-type": "m5.large",
            "/placement/availability-zone": "us-east-1b",
            "/instance-id": "i-abc123",
            "/local-ipv4": "10.0.0.7",
        })
        monkeypatch.setenv("NOMAD_TPU_AWS_METADATA_URL", base)
        node = Node()
        env_aws_fingerprint(node)
        assert node.attributes["platform.aws.instance-type"] == "m5.large"
        assert node.attributes["unique.platform.aws.local-ipv4"] \
            == "10.0.0.7"

    def test_aws_imdsv2_token_flow(self, monkeypatch):
        """HttpTokens=required hosts 401 plain GETs; the fingerprinter
        must fetch a session token first."""
        TOKEN = "tok-123"
        routes = {"/latest/meta-data/instance-type": "c6i.large",
                  "/latest/meta-data/placement/availability-zone": "eu-1a",
                  "/latest/meta-data/instance-id": "i-v2",
                  "/latest/meta-data/local-ipv4": "10.1.1.1"}

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_PUT(self):
                if self.path == "/latest/api/token":
                    data = TOKEN.encode()
                    self.send_response(200)
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    return
                self.send_response(404)
                self.end_headers()

            def do_GET(self):
                if self.headers.get("X-aws-ec2-metadata-token") != TOKEN:
                    self.send_response(401)
                    self.end_headers()
                    return
                body = routes.get(self.path)
                if body is None:
                    self.send_response(404)
                    self.end_headers()
                    return
                data = body.encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            base = f"http://127.0.0.1:{httpd.server_address[1]}" \
                   "/latest/meta-data"
            monkeypatch.setenv("NOMAD_TPU_AWS_METADATA_URL", base)
            node = Node()
            env_aws_fingerprint(node)
            assert node.attributes["platform.aws.instance-type"] \
                == "c6i.large"
            assert node.attributes["unique.platform.aws.instance-id"] \
                == "i-v2"
        finally:
            httpd.shutdown()
            httpd.server_close()

    def test_unreachable_metadata_is_silent(self, monkeypatch):
        """A dead endpoint must leave no attrs (CI may itself run on a
        cloud VM, so pin the URL instead of relying on DMI markers)."""
        monkeypatch.setenv("NOMAD_TPU_GCE_METADATA_URL",
                           "http://127.0.0.1:9")  # discard port: refused
        monkeypatch.setenv("NOMAD_TPU_AWS_METADATA_URL",
                           "http://127.0.0.1:9")
        node = Node()
        env_gce_fingerprint(node)
        env_aws_fingerprint(node)
        assert not any(k.startswith("platform.")
                       for k in node.attributes)


class TestCniFingerprint:
    def test_conflist_discovered(self, tmp_path, monkeypatch):
        (tmp_path / "mynet.conflist").write_text(json.dumps(
            {"name": "mynet", "cniVersion": "0.4.0", "plugins": []}))
        (tmp_path / "junk.txt").write_text("ignored")
        monkeypatch.setenv("NOMAD_TPU_CNI_CONFIG_DIR", str(tmp_path))
        node = Node()
        cni_fingerprint(node)
        assert node.attributes["plugins.cni.config.mynet"] \
            == str(tmp_path / "mynet.conflist")
        assert len([k for k in node.attributes
                    if k.startswith("plugins.cni.config.")]) == 1


class TestGpuFingerprintBounded:
    def test_wedged_probe_leaves_node_unannotated(self, fake_smi,
                                                  monkeypatch):
        """A hanging driver must not block fingerprinting: the probe's
        child is killed at its budget and the agent moves on."""
        seen = {}

        def fake_run(argv, **kw):
            seen.update(kw)
            raise subprocess.TimeoutExpired(cmd=argv, timeout=kw["timeout"])

        monkeypatch.setenv("NOMAD_TPU_FINGERPRINT_TIMEOUT", "2.5")
        monkeypatch.setattr(subprocess, "run", fake_run)
        node = Node()
        t0 = time.time()
        fp.gpu_fingerprint(node)  # must return promptly, not raise
        assert time.time() - t0 < 1.0
        assert seen["timeout"] == 2.5
        assert "gpu.count" not in node.attributes
        assert not node.node_resources.devices

    def test_a_real_hang_is_cut_at_the_budget(self, fake_smi, monkeypatch):
        out, _ = fake_smi
        smi = out.parent / "bin" / "nvidia-smi"
        smi.write_text("#!/bin/sh\nexec sleep 30\n")
        monkeypatch.setenv("NOMAD_TPU_FINGERPRINT_TIMEOUT", "0.5")
        node = Node()
        t0 = time.time()
        fp.gpu_fingerprint(node)
        assert time.time() - t0 < 10.0
        assert "gpu.count" not in node.attributes

    def test_missing_nvidia_smi_leaves_node_unannotated(self, tmp_path,
                                                        monkeypatch):
        def boom(*a, **k):
            raise AssertionError("no nvidia-smi: nothing may run")

        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.delenv("NOMAD_TPU_SKIP_GPU_FINGERPRINT", raising=False)
        monkeypatch.setattr(subprocess, "run", boom)
        node = Node()
        fp.gpu_fingerprint(node)
        assert "gpu.count" not in node.attributes
        assert "driver.nvidia" not in node.attributes

    def test_failing_probe_leaves_node_unannotated(self, fake_smi):
        out, rc = fake_smi
        out.write_text("NVIDIA-SMI has failed because it couldn't "
                       "communicate with the NVIDIA driver.\n")
        rc.write_text("9")
        node = Node()
        fp.gpu_fingerprint(node)
        assert "gpu.count" not in node.attributes

    def test_skip_setting_skips_the_probe(self, fake_smi, monkeypatch):
        def boom(*a, **k):
            raise AssertionError("probe must not run when skipped")

        monkeypatch.setenv("NOMAD_TPU_SKIP_GPU_FINGERPRINT", "1")
        monkeypatch.setattr(subprocess, "run", boom)
        node = Node()
        fp.gpu_fingerprint(node)
        assert "gpu.count" not in node.attributes

    def test_probe_rows_annotate_devices(self, fake_smi):
        node = Node()
        fp.gpu_fingerprint(node)
        assert node.attributes["gpu.count"] == "2"
        assert node.attributes["gpu.type"] == "NVIDIA H100 80GB HBM3"
        assert node.attributes["driver.nvidia"] == "1"
        (g,) = node.node_resources.devices
        assert (g.vendor, g.type, g.name) == ("nvidia", "gpu", H100)
        assert [i.id for i in g.instances] == UUIDS
        assert all(i.healthy for i in g.instances)
        assert g.attributes == {"model": "NVIDIA H100 80GB HBM3",
                                "memory": 81559, "power_limit": 700,
                                "driver_version": "580.159.03",
                                "compute_cap": "9.0"}

    def test_probe_asks_for_the_nvml_fields(self, fake_smi, monkeypatch):
        seen = []
        real = subprocess.run

        def spy(argv, **kw):
            seen.append(argv)
            return real(argv, **kw)

        monkeypatch.setattr(subprocess, "run", spy)
        fp.gpu_fingerprint(Node())
        (argv,) = seen
        assert argv[1:] == [
            "--query-gpu=index,uuid,name,memory.total,power.limit,"
            "driver_version,compute_cap", "--format=csv,noheader,nounits"]

    def test_one_group_a_model_and_rerun_replaces(self, fake_smi):
        out, _ = fake_smi
        out.write_text(H100_ROWS + "2, GPU-ffff, NVIDIA A100-SXM4-40GB, "
                       "40960, [N/A], 580.159.03, 8.0\n")
        node = Node()
        fp.gpu_fingerprint(node)
        fp.gpu_fingerprint(node)
        groups = {g.id(): g for g in node.node_resources.devices}
        assert set(groups) == {f"nvidia/gpu/{H100}",
                               "nvidia/gpu/nvidia-a100-sxm4-40gb"}
        a100 = groups["nvidia/gpu/nvidia-a100-sxm4-40gb"]
        assert a100.attributes["power_limit"] == "[N/A]"
        assert node.attributes["gpu.count"] == "3"

    def test_default_fingerprinters_run_the_gpu_probe(self):
        assert fp.gpu_fingerprint in fp.FINGERPRINTERS
        assert not hasattr(fp, "tpu_fingerprint")


class TestDeviceFingerprint:
    def test_fake_devices_env(self, monkeypatch):
        from nomad_tpu_torch.client.fingerprint import device_env_fingerprint

        monkeypatch.setenv("NOMAD_TPU_FAKE_DEVICES", "nvidia/gpu/1080ti:4")
        node = mock.node()
        node.node_resources.devices = []
        device_env_fingerprint(node)
        assert len(node.node_resources.devices) == 1
        dev = node.node_resources.devices[0]
        assert dev.id() == "nvidia/gpu/1080ti"
        assert len(dev.instances) == 4


class TestDeviceManager:
    """client/devicemanager.py — the devicemanager/manager.go analog:
    fingerprint change detection, the stats stream, and the heartbeat
    carrying the stats to the server."""

    def test_env_plugin_fingerprint(self, monkeypatch):
        from nomad_tpu_torch.client.devicemanager import EnvDevicePlugin

        monkeypatch.setenv("NOMAD_TPU_FAKE_DEVICES",
                           "nvidia/gpu/1080ti:2,acme/fpga/x1:1")
        groups = EnvDevicePlugin().fingerprint()
        assert {g.id() for g in groups} == {"nvidia/gpu/1080ti",
                                            "acme/fpga/x1"}
        assert len(groups[0].instances) == 2

    def test_change_detection_and_seed(self, monkeypatch):
        from nomad_tpu_torch.client.devicemanager import (
            DeviceManager, EnvDevicePlugin)

        monkeypatch.setenv("NOMAD_TPU_FAKE_DEVICES", "acme/fpga/x1:2")
        m = DeviceManager(plugins=[EnvDevicePlugin()])
        first = m.fingerprint_once()
        assert first is not None and len(first) == 1  # baseline = change
        assert m.fingerprint_once() is None  # steady state
        monkeypatch.setenv("NOMAD_TPU_FAKE_DEVICES", "acme/fpga/x1:3")
        third = m.fingerprint_once()
        assert third is not None and len(third[0].instances) == 3
        # seed() adopts an external baseline
        m2 = DeviceManager(plugins=[EnvDevicePlugin()])
        m2.seed(third)
        assert m2.fingerprint_once() is None

    def test_stats_stream(self, monkeypatch):
        from nomad_tpu_torch.client.devicemanager import (
            DeviceManager, EnvDevicePlugin)

        monkeypatch.setenv("NOMAD_TPU_FAKE_DEVICES", "acme/fpga/x1:2")
        m = DeviceManager(plugins=[EnvDevicePlugin()])
        stats = m.collect_stats()
        assert set(stats) == {"acme/fpga/x1"}
        # instance ids match the registration-time fingerprint format
        assert set(stats["acme/fpga/x1"]) == {"acme/fpga/x1-0",
                                              "acme/fpga/x1-1"}
        assert m.latest_stats() == stats

    def test_gpu_plugin_marks_vanished_devices_unhealthy(self,
                                                         monkeypatch):
        from nomad_tpu_torch.client.devicemanager import GpuDevicePlugin
        from nomad_tpu_torch.structs.resources import (NodeDeviceInstance,
                                                       NodeDeviceResource)

        p = GpuDevicePlugin()
        p._seen = [NodeDeviceResource(
            vendor="nvidia", type="gpu", name=H100,
            instances=[NodeDeviceInstance(id=UUIDS[0], healthy=True)])]
        # probe disabled → fingerprint fails → instances flip unhealthy
        monkeypatch.setenv("NOMAD_TPU_SKIP_GPU_FINGERPRINT", "1")
        groups = p.fingerprint()
        assert len(groups) == 1
        assert groups[0].instances[0].healthy is False
        assert groups[0].attributes.get("health_description")

    def test_heartbeat_carries_stats_to_the_server(self, tmp_path,
                                                   monkeypatch):
        import urllib.request

        from nomad_tpu_torch.agent.http import HTTPApi
        from nomad_tpu_torch.client import Client, ClientConfig, InProcConn
        from nomad_tpu_torch.server import Server, ServerConfig

        monkeypatch.setenv("NOMAD_TPU_FAKE_DEVICES", "acme/fpga/x1:2")
        server = Server(ServerConfig(num_schedulers=1,
                                     heartbeat_ttl=60.0,
                                     gc_interval=3600.0), device="cpu")
        server.start()
        client = Client(InProcConn(server),
                        ClientConfig(data_dir=str(tmp_path / "c"),
                                     heartbeat_interval=0.2))
        client.device_manager.stats_interval = 0.1

        class _A:  # minimal agent shim for the HTTP layer
            pass

        shim = _A()
        shim.server = server
        shim.client = client
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
            # surfaced live on the node endpoint
            host, port = api.addr
            with urllib.request.urlopen(
                    f"http://{host}:{port}/v1/node/{client.node.id}",
                    timeout=10) as r:
                tree = json.loads(r.read())
            assert "acme/fpga/x1" in tree["device_stats"]["stats"]
        finally:
            client.shutdown()
            server.shutdown()
            api.shutdown()

    def test_taskenv_device_visibility(self):
        from nomad_tpu_torch.client.taskenv import build_env
        from nomad_tpu_torch.structs.resources import (
            AllocatedDeviceResource, AllocatedResources,
            AllocatedTaskResources)

        alloc = mock.alloc()
        task = alloc.job.task_groups[0].tasks[0]
        alloc.allocated_resources = AllocatedResources(tasks={
            task.name: AllocatedTaskResources(devices=[
                AllocatedDeviceResource(vendor="nvidia", type="gpu",
                                        name=H100, device_ids=UUIDS)])})
        env = build_env(alloc, task, None)
        assert env["NOMAD_DEVICE_GPU"] == ",".join(UUIDS)
        assert env["CUDA_VISIBLE_DEVICES"] == ",".join(UUIDS)
        assert env["NVIDIA_VISIBLE_DEVICES"] == ",".join(UUIDS)


class TestGpuDevicePlugin:
    def test_healthy_then_unhealthy_not_vanished(self, fake_smi):
        from nomad_tpu_torch.client.devicemanager import GpuDevicePlugin

        out, rc = fake_smi
        p = GpuDevicePlugin()
        (g,) = p.fingerprint()
        assert g.id() == f"nvidia/gpu/{H100}"
        assert [(i.id, i.healthy) for i in g.instances] == \
            [(u, True) for u in UUIDS]
        stats = p.stats()
        assert set(stats[g.id()]) == set(UUIDS)
        assert all(s["healthy"] for s in stats[g.id()].values())
        rc.write_text("9")  # the driver stops answering
        (sick,) = p.fingerprint()
        assert sick.id() == g.id()
        assert [(i.id, i.healthy) for i in sick.instances] == \
            [(u, False) for u in UUIDS]
        assert sick.attributes["health_description"] == "probe failed"
        assert sick.attributes["model"] == "NVIDIA H100 80GB HBM3"
        assert not any(s["healthy"] for s in p.stats()[g.id()].values())
        rc.write_text("0")
        (back,) = p.fingerprint()
        assert all(i.healthy for i in back.instances)

    def test_nothing_found_is_nothing_reported(self, tmp_path, monkeypatch):
        from nomad_tpu_torch.client.devicemanager import GpuDevicePlugin

        monkeypatch.setenv("PATH", str(tmp_path))
        p = GpuDevicePlugin()
        assert p.fingerprint() == [] and p.stats() == {}

    def test_reserve_sets_both_visibility_variables(self):
        from nomad_tpu_torch.client.devicemanager import (GpuDevicePlugin,
                                                          reservation_env)

        want = {"CUDA_VISIBLE_DEVICES": ",".join(UUIDS),
                "NVIDIA_VISIBLE_DEVICES": ",".join(UUIDS)}
        assert GpuDevicePlugin().reserve(UUIDS) == want
        assert reservation_env("nvidia", "gpu", UUIDS) == want
        assert reservation_env("google", "tpu", ["0"]) == {}
        assert reservation_env("acme", "fpga", ["x"]) == {}

    @pytest.mark.parametrize("skip", [False, True])
    def test_builtin_plugins(self, monkeypatch, skip):
        from nomad_tpu_torch.client.devicemanager import DeviceManager

        if skip:
            monkeypatch.setenv("NOMAD_TPU_SKIP_GPU_FINGERPRINT", "1")
        else:
            monkeypatch.delenv("NOMAD_TPU_SKIP_GPU_FINGERPRINT",
                               raising=False)
        names = [p.name for p in DeviceManager().plugins]
        assert names == (["env"] if skip else ["env", "gpu"])

    def test_device_host_builds_the_gpu_plugin(self):
        from nomad_tpu_torch.client.devicemanager import GpuDevicePlugin
        from nomad_tpu_torch.plugins.device_host import make_device_plugin

        assert isinstance(make_device_plugin("gpu"), GpuDevicePlugin)
        with pytest.raises(ValueError):
            make_device_plugin("tpu")


#: fingerprinters both packages have; the accelerator probes differ
SHARED = ("arch_fingerprint", "os_fingerprint", "cpu_fingerprint",
          "memory_fingerprint", "storage_fingerprint",
          "network_fingerprint", "host_fingerprint", "nomad_fingerprint",
          "signal_fingerprint", "device_env_fingerprint",
          "cgroup_fingerprint", "bridge_fingerprint", "cni_fingerprint",
          "env_gce_fingerprint", "env_aws_fingerprint",
          "driver_fingerprints")


def _one_host(monkeypatch):
    """Pin what a host's readings may change between two calls: the free
    disk and the first `cpu MHz` line."""
    import builtins
    import io
    import shutil
    from collections import namedtuple

    usage = namedtuple("usage", "total used free")(1 << 40, 1 << 39, 1 << 39)
    monkeypatch.setattr(shutil, "disk_usage", lambda p: usage)
    real_open = builtins.open
    with real_open("/proc/cpuinfo") as f:
        cpuinfo = f.read()

    def pinned_open(path, *a, **k):
        if path == "/proc/cpuinfo":
            return io.StringIO(cpuinfo)
        return real_open(path, *a, **k)

    monkeypatch.setattr(builtins, "open", pinned_open)


class TestAcrossPackages:
    def test_shared_fingerprinters_agree_on_one_host(self, monkeypatch,
                                                     tmp_path):
        from nomad_tpu.client import fingerprint as ref_fp
        from nomad_tpu.structs import Node as RefNode

        monkeypatch.setenv("NOMAD_TPU_FAKE_DEVICES", "acme/fpga/x1:2")
        monkeypatch.setenv("NOMAD_TPU_CNI_CONFIG_DIR", str(tmp_path))
        (tmp_path / "mynet.conflist").write_text(json.dumps(
            {"name": "mynet", "cniVersion": "0.4.0", "plugins": []}))
        _one_host(monkeypatch)
        assert set(SHARED) < {f.__name__ for f in fp.FINGERPRINTERS}
        assert set(SHARED) < {f.__name__ for f in ref_fp.FINGERPRINTERS}
        ref_node, port_node = RefNode(), Node()
        for name in SHARED:
            getattr(ref_fp, name)(ref_node)
            getattr(fp, name)(port_node)
        assert port_node.attributes == ref_node.attributes
        assert len(port_node.attributes) > 15
        assert [g.id() for g in port_node.node_resources.devices] == \
            [g.id() for g in ref_node.node_resources.devices]
        for key in ("cpu", "memory_mb", "disk_mb"):
            assert getattr(port_node.node_resources, key) == \
                getattr(ref_node.node_resources, key)

    def test_default_managers_agree_but_for_the_accelerator(
            self, monkeypatch, fake_smi):
        """Each package's default fingerprinters over one host: the
        reference's TPU probe is skipped by its own setting, the port's
        GPU probe reads the canned card; everything else is equal."""
        from nomad_tpu.client.fingerprint import \
            FingerprintManager as RefManager
        from nomad_tpu.structs import Node as RefNode

        monkeypatch.setenv("NOMAD_TPU_SKIP_TPU_FINGERPRINT", "1")
        _one_host(monkeypatch)
        ref = RefManager().run(RefNode())
        port = fp.FingerprintManager().run(Node())

        def aside(attrs):
            return {k: v for k, v in attrs.items()
                    if not k.startswith(("tpu.", "gpu."))
                    and k not in ("driver.tpu", "driver.nvidia")}

        assert aside(port.attributes) == aside(ref.attributes)
        assert port.attributes["gpu.count"] == "2"
        assert [g.id() for g in port.node_resources.devices] == \
            [f"nvidia/gpu/{H100}"]


class TestDeviceAskOnTheKernelPath:
    def test_the_canned_card_is_placed_and_its_pool_matches(
            self, fake_smi):
        import random

        from nomad_tpu.structs.codec import from_wire as ref_from_wire
        from nomad_tpu.tensor.cluster import ClusterTensors as RefTensors
        from nomad_tpu_torch import synth
        from nomad_tpu_torch.scheduler.harness import Harness
        from nomad_tpu_torch.structs import Constraint, RequestedDevice
        from nomad_tpu_torch.structs.codec import to_wire

        rng = random.Random(7)
        nodes = [synth.synth_node(rng, i) for i in range(8)]
        gpu_node = synth.synth_node(rng, 9)
        gpu_node.node_resources.devices = []
        fp.gpu_fingerprint(gpu_node)
        gpu_node.compute_class()
        h = Harness(device="cpu")
        for n in nodes + [gpu_node]:
            h.state.upsert_node(n)
        job = mock.job()
        tg = job.task_groups[0]
        tg.count = 1
        tg.networks = []
        tg.tasks[0].resources.networks = []
        tg.tasks[0].resources.devices = [RequestedDevice(
            name=f"nvidia/gpu/{H100}", count=1, constraints=[Constraint(
                "${device.attr.memory}", "40000", ">=")])]
        h.state.upsert_job(job)
        h.process(mock.eval_(job_id=job.id, type=job.type))
        placed = [a for p in h.plans for allocs in p.node_allocation.values()
                  for a in allocs]
        assert len(placed) == 1 and placed[0].node_id == gpu_node.id
        (dev,) = [d for tr in placed[0].allocated_resources.tasks.values()
                  for d in tr.devices]
        assert (dev.vendor, dev.type, dev.name) == ("nvidia", "gpu", H100)
        assert len(dev.device_ids) == 1 and dev.device_ids[0] in UUIDS

        port_cl = h.state.cluster
        ref_cl = RefTensors()
        for n in nodes + [gpu_node]:
            ref_cl.upsert_node(ref_from_wire(to_wire(n)))
        assert ref_cl.device_cols == port_cl.device_cols
        col = port_cl.device_cols["nvidia/gpu"]
        for n in nodes + [gpu_node]:
            assert port_cl.capacity[port_cl.row_of[n.id], col] == \
                ref_cl.capacity[ref_cl.row_of[n.id], col]
        assert port_cl.capacity[port_cl.row_of[gpu_node.id], col] == 2
