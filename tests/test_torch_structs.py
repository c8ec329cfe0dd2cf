"""Twins of the reference's `tests/test_structs.py` (data-model and
scheduling-math tests; vectors transcribed from reference behavior in
`nomad/structs/funcs_test.go` TestAllocsFit*, TestScoreFitBinPack and
`structs_test.go`), run on the port.

`TestAgainstReference` feeds seeded nodes, allocs and asks (built by the
reference's mocks, wired to the port) to both packages' `allocs_fit`,
`score_fit_*`, `NetworkIndex`, `filter_terminal_allocs` and
`Node.compute_class`, and compares the results.
"""
import math
import random

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.structs import (
    Allocation,
    ComparableResources,
    NetworkIndex,
    NetworkResource,
    Port,
    allocs_fit,
    filter_terminal_allocs,
    score_fit_binpack,
    score_fit_spread,
)

from torch_ops_cases import PORT, REF, as_pkg, mod


def _node_2000():
    """A node with 2000 MHz / 2048 MiB usable (mirrors funcs_test.go fixtures)."""
    n = mock.node()
    n.node_resources.cpu = 2000
    n.node_resources.memory_mb = 2048
    n.node_resources.disk_mb = 10000
    n.reserved_resources.cpu = 0
    n.reserved_resources.memory_mb = 0
    n.reserved_resources.disk_mb = 0
    n.reserved_resources.reserved_ports = ""
    return n


def _alloc(cpu, mem, disk=0):
    a = mock.alloc()
    a.allocated_resources = mock.alloc_resources(
        cpu=cpu, memory_mb=mem, disk_mb=disk, networks=[]
    )
    return a


class TestTerminalStatus:
    def test_desired_stop_is_terminal(self):
        a = Allocation(desired_status="stop", client_status="running")
        assert a.terminal_status()

    def test_client_failed_is_terminal(self):
        a = Allocation(desired_status="run", client_status="failed")
        assert a.terminal_status()

    def test_running_not_terminal(self):
        a = Allocation(desired_status="run", client_status="running")
        assert not a.terminal_status()


class TestFilterTerminal:
    def test_keeps_highest_create_index(self):
        a1 = Allocation(name="x[0]", desired_status="stop", create_index=5)
        a2 = Allocation(name="x[0]", desired_status="stop", create_index=10)
        live = Allocation(name="x[1]", desired_status="run", client_status="running")
        out, terminal = filter_terminal_allocs([a1, a2, live])
        assert out == [live]
        assert terminal["x[0]"] is a2


class TestAllocsFit:
    def test_fits_exactly(self):
        n = _node_2000()
        ok, dim, used = allocs_fit(n, [_alloc(2000, 2048)])
        assert ok, dim
        assert used.cpu == 2000

    def test_cpu_exhausted(self):
        n = _node_2000()
        ok, dim, _ = allocs_fit(n, [_alloc(2001, 10)])
        assert not ok
        assert dim == "cpu"

    def test_memory_exhausted(self):
        n = _node_2000()
        ok, dim, _ = allocs_fit(n, [_alloc(10, 4096)])
        assert not ok
        assert dim == "memory"

    def test_terminal_allocs_ignored(self):
        n = _node_2000()
        dead = _alloc(2000, 2048)
        dead.desired_status = "stop"
        ok, _, used = allocs_fit(n, [dead, _alloc(1000, 1024)])
        assert ok
        assert used.cpu == 1000

    def test_reserved_resources_subtracted(self):
        n = _node_2000()
        n.reserved_resources.cpu = 1000
        ok, dim, _ = allocs_fit(n, [_alloc(1500, 100)])
        assert not ok and dim == "cpu"

    def test_port_collision(self):
        n = _node_2000()
        net = [
            NetworkResource(
                device="eth0", ip="192.168.0.100", mbits=10,
                reserved_ports=[Port(label="main", value=8000)],
            )
        ]
        a1 = _alloc(100, 100)
        a1.allocated_resources.tasks["web"].networks = net
        a2 = _alloc(100, 100)
        a2.allocated_resources.tasks["web"].networks = [n2.copy() for n2 in net]
        ok, dim, _ = allocs_fit(n, [a1, a2])
        assert not ok
        assert dim == "reserved port collision"


class TestScoreFit:
    """Vectors from reference funcs_test.go TestScoreFitBinPack: a node with
    4096 usable cpu/mem. util=4096/4096 → 18.0; util=0 → 0.0; half → 16.675."""

    def _node4096(self):
        n = _node_2000()
        n.node_resources.cpu = 4096
        n.node_resources.memory_mb = 8192
        n.reserved_resources.cpu = 2048
        n.reserved_resources.memory_mb = 4096
        return n

    def test_perfect_fit(self):
        n = self._node4096()
        util = ComparableResources(cpu=2048, memory_mb=4096)
        assert score_fit_binpack(n, util) == 18.0
        assert score_fit_spread(n, util) == 0.0

    def test_zero_util(self):
        n = self._node4096()
        util = ComparableResources(cpu=0, memory_mb=0)
        assert score_fit_binpack(n, util) == 0.0
        assert score_fit_spread(n, util) == 18.0

    def test_half_util(self):
        n = self._node4096()
        util = ComparableResources(cpu=1024, memory_mb=2048)
        expected = 20.0 - 2 * math.pow(10, 0.5)
        assert abs(score_fit_binpack(n, util) - expected) < 1e-9
        assert abs(score_fit_spread(n, util) - (2 * math.pow(10, 0.5) - 2)) < 1e-9


class TestNetworkIndex:
    def test_assign_network_dynamic(self):
        n = _node_2000()
        idx = NetworkIndex()
        assert not idx.set_node(n)
        ask = NetworkResource(mbits=50, dynamic_ports=[Port(label="http")])
        offer, err = idx.assign_network(ask)
        assert err == ""
        assert offer is not None
        assert 20000 <= offer.dynamic_ports[0].value < 32000

    def test_reserved_collision(self):
        n = _node_2000()
        n.reserved_resources.reserved_ports = "22"
        idx = NetworkIndex()
        idx.set_node(n)
        ask = NetworkResource(mbits=1, reserved_ports=[Port(label="ssh", value=22)])
        offer, err = idx.assign_network(ask)
        assert offer is None
        assert "collision" in err

    def test_bandwidth_exceeded(self):
        n = _node_2000()
        idx = NetworkIndex()
        idx.set_node(n)
        ask = NetworkResource(mbits=2000)
        offer, err = idx.assign_network(ask)
        assert offer is None
        assert err == "bandwidth exceeded"

    def test_overcommitted(self):
        n = _node_2000()
        idx = NetworkIndex()
        idx.set_node(n)
        idx.add_reserved(NetworkResource(device="eth0", mbits=2000))
        assert idx.overcommitted()


class TestNodeClass:
    def test_compute_class_stable(self):
        n1 = mock.node()
        n2 = mock.node()
        # Same attrs modulo unique.* → same computed class
        n2.attributes = dict(n1.attributes)
        n1.compute_class()
        n2.compute_class()
        assert n1.computed_class == n2.computed_class

    def test_compute_class_differs(self):
        n1 = mock.node()
        n2 = mock.node()
        n2.attributes = dict(n1.attributes, **{"arch": "arm64"})
        n1.compute_class()
        n2.compute_class()
        assert n1.computed_class != n2.computed_class


# ---- seeded vectors through the reference and the port --------------------


def _rnode(rng):
    n = mod(REF, "mock").node()
    n.node_resources.cpu = rng.choice([1000, 2000, 4096, 8000])
    n.node_resources.memory_mb = rng.choice([1024, 2048, 8192])
    n.node_resources.disk_mb = rng.choice([0, 5000, 10000])
    n.reserved_resources.cpu = rng.choice([0, 100, 500])
    n.reserved_resources.memory_mb = rng.choice([0, 256])
    n.reserved_resources.disk_mb = 0
    n.reserved_resources.reserved_ports = rng.choice(["", "22", "8000-8010"])
    return n


def _ralloc(rng, node):
    structs = mod(REF, "structs")
    a = mod(REF, "mock").alloc()
    nets = []
    if rng.random() < 0.4:
        nets = [structs.NetworkResource(
            device="eth0", ip=node.node_resources.networks[0].ip,
            mbits=rng.choice([1, 10, 600]),
            reserved_ports=[structs.Port(label="p", value=rng.choice(
                [22, 8000, 8005, 9000]))])]
    a.allocated_resources = mod(REF, "mock").alloc_resources(
        cpu=rng.randrange(0, 2500), memory_mb=rng.randrange(0, 3000),
        disk_mb=rng.randrange(0, 6000), networks=nets)
    a.desired_status = rng.choice(["run", "run", "stop"])
    a.client_status = rng.choice(["running", "pending", "complete"])
    return a


def _fit(pkg, node, allocs):
    f = mod(pkg, "structs")
    ok, dim, used = f.allocs_fit(as_pkg(pkg, node),
                                 [as_pkg(pkg, a) for a in allocs])
    return ok, dim, (used.cpu, used.memory_mb, used.disk_mb)


class TestAgainstReference:
    def test_allocs_fit_equals_reference(self):
        rng = random.Random(19)
        for _ in range(60):
            node = _rnode(rng)
            allocs = [_ralloc(rng, node) for _ in range(rng.randrange(0, 5))]
            assert _fit(PORT, node, allocs) == _fit(REF, node, allocs)

    def test_score_fit_equals_reference(self):
        rng = random.Random(23)
        for _ in range(60):
            node = _rnode(rng)
            cpu, mem = rng.randrange(0, 9000), rng.randrange(0, 9000)
            got = {}
            for pkg in (REF, PORT):
                s = mod(pkg, "structs")
                util = s.ComparableResources(cpu=cpu, memory_mb=mem)
                n = as_pkg(pkg, node)
                got[pkg] = (s.score_fit_binpack(n, util),
                            s.score_fit_spread(n, util))
            assert got[PORT] == got[REF]

    def test_network_index_equals_reference(self):
        rng = random.Random(29)
        for _ in range(40):
            node = _rnode(rng)
            held = [_ralloc(rng, node) for _ in range(rng.randrange(0, 3))]
            rs = mod(REF, "structs")
            ask = rs.NetworkResource(
                mbits=rng.choice([1, 50, 2000]),
                reserved_ports=[rs.Port(label="r", value=rng.choice(
                    [22, 8000, 8080]))] if rng.random() < 0.5 else [])
            got = {}
            for pkg in (REF, PORT):
                idx = mod(pkg, "structs").NetworkIndex()
                collide = idx.set_node(as_pkg(pkg, node))
                for a in held:
                    if not a.terminal_status():
                        for tr in as_pkg(pkg, a).allocated_resources \
                                .tasks.values():
                            for nw in tr.networks:
                                idx.add_reserved(nw)
                offer, err = idx.assign_network(as_pkg(pkg, ask))
                got[pkg] = (collide, err, idx.overcommitted(),
                            None if offer is None else (
                                offer.ip, offer.mbits,
                                [(p.label, p.value)
                                 for p in offer.reserved_ports]))
            assert got[PORT] == got[REF]

    def test_filter_terminal_equals_reference(self):
        rng = random.Random(31)
        rs = mod(REF, "structs")
        allocs = [rs.Allocation(
            id=f"a{i}", name=f"x[{rng.randrange(4)}]",
            desired_status=rng.choice(["run", "stop"]),
            client_status=rng.choice(["running", "failed", "complete"]),
            create_index=rng.randrange(100)) for i in range(30)]
        got = {}
        for pkg in (REF, PORT):
            live, terminal = mod(pkg, "structs").filter_terminal_allocs(
                [as_pkg(pkg, a) for a in allocs])
            got[pkg] = ([a.id for a in live],
                        {k: a.id for k, a in terminal.items()})
        assert got[PORT] == got[REF]

    def test_compute_class_equals_reference(self):
        rng = random.Random(37)
        for _ in range(20):
            node = _rnode(rng)
            node.attributes = dict(node.attributes,
                                   arch=rng.choice(["x86", "arm64"]),
                                   rack=f"r{rng.randrange(3)}")
            node.node_class = rng.choice(["", "c1"])
            node.meta = {"zone": rng.choice(["a", "b"])}
            got = {}
            for pkg in (REF, PORT):
                n = as_pkg(pkg, node)
                n.compute_class()
                got[pkg] = n.computed_class
            assert got[PORT] == got[REF]


class TestCodecRegistryBuild:
    """The codec's registry is built whole before a reader sees it: a
    decode made while the first build is midway waits for it, where it
    once read a partial dict and raised `unknown struct type`."""

    def test_decode_during_a_cold_build_does_not_raise(self, monkeypatch):
        import threading
        import types

        from nomad_tpu_torch.structs import NodeResources, codec

        tree = codec.to_wire(NodeResources(cpu=1000, memory_mb=512))
        saved = codec._REGISTRY
        real = codec.importlib.import_module
        held, release = threading.Event(), threading.Event()
        imports = []

        def import_module(name):
            if threading.current_thread().name == "codec-build":
                imports.append(name)
                if len(imports) == 2:   # the first struct module is in
                    held.set()
                    release.wait(10.0)
            return real(name)

        monkeypatch.setattr(codec, "importlib", types.SimpleNamespace(
            import_module=import_module))
        errors, got = [], []

        def run(fn):
            try:
                got.append(fn())
            except Exception as e:  # noqa: BLE001 — asserted below
                errors.append(e)

        builder = threading.Thread(target=run, args=(codec.registry,),
                                   name="codec-build", daemon=True)
        reader = threading.Thread(target=run,
                                  args=(lambda: codec.from_wire(tree),),
                                  daemon=True)
        try:
            codec._REGISTRY = {}
            builder.start()
            assert held.wait(10.0)
            reader.start()
            reader.join(0.5)
            release.set()
            builder.join(10.0)
            reader.join(10.0)
            assert not builder.is_alive() and not reader.is_alive()
            assert errors == []
            decoded = [g for g in got if isinstance(g, NodeResources)]
            assert decoded == [NodeResources(cpu=1000, memory_mb=512)]
        finally:
            release.set()
            builder.join(10.0)
            codec._REGISTRY = saved
