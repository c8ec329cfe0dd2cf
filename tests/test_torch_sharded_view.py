"""The port's node-sharded view cache (B13) against the reference's.

Under an active mesh the reference's `TPUStack.device_arrays` uploads
node-sharded buffers and applies its row deltas "on the already-sharded
buffers" (`nomad_tpu/scheduler/stack.py:801-802`). The port keeps a
`ShardedCluster` and runs K7 per shard: each changed row or port word goes
to the shard that owns it, rebased, once for every distinct copy of that
shard.

The port's mesh here is (2, 2) over `cpu`, `cpu`, `cpu:0`, `cpu:0`: two
distinct device names, so batch row 1 holds copies of its own (on one card
every column has one copy and that case never arises). The reference's
mesh is (2, 2) over its virtual devices. After churn — allocs placed and
stopped, ports taken and released, a node re-registered and one removed —
every copy of every shard equals the reference's sharded view (gathered)
bitwise, and a cold `shard_cluster` of the port's unsharded view; the
`view.*` counters move alike in both packages. Also: a mesh flip is a full
upload; a leased sharded view is never written, on any copy; a change on
one shard's rows launches K7 on that shard's copies only.
"""
import numpy as np
import pytest
import torch

from nomad_tpu import mock
from nomad_tpu.parallel import make_mesh as jax_make_mesh
from nomad_tpu.parallel import set_active_mesh as jax_set_mesh
from nomad_tpu.structs.resources import NetworkResource, Port
from torch_chain_cases import one_torch_thread  # noqa: F401
from torch_view_cases import BOTH, PORT, REF, assert_views_equal

from nomad_tpu_torch.kernels import rows as kr
from nomad_tpu_torch.kernels.shard import ShardedCluster
from nomad_tpu_torch.parallel import (get_active_mesh, make_mesh,
                                      set_active_mesh, shard_cluster)
from nomad_tpu_torch.parallel.mesh import shard_copies

#: the view counters both packages keep (upload_bytes differs by the
#: reference's chunk padding)
COUNTERS = ("full_uploads", "ports_full_uploads", "delta_uploads",
            "delta_rows", "ports_words", "copy_slots", "carry_rejects")
DEVICES = ["cpu", "cpu", "cpu:0", "cpu:0"]


@pytest.fixture
def meshes():
    """Both packages' (2, 2) meshes installed; uninstalled after."""
    jmesh = jax_make_mesh(4, batch=2)
    mesh = make_mesh(4, batch=2, devices=DEVICES)
    jax_set_mesh(jmesh)
    set_active_mesh(mesh)
    try:
        yield jmesh, mesh
    finally:
        jax_set_mesh(None)
        set_active_mesh(None)


def _node(i):
    n = mock.node()
    n.id = f"node-{i}"
    return n


def _alloc(node_id, cpu=100, ports=()):
    nets = []
    if ports:
        nets = [NetworkResource(reserved_ports=[
            Port(label=f"p{p}", value=p) for p in ports])]
    return REF.alloc(node_id, cpu=cpu, networks=nets)


class Twin:
    """One cluster and stack per package, fed the same objects."""

    def __init__(self, nodes):
        self.cl = {p.name: p.cluster(nodes) for p in BOTH}
        self.stack = {p.name: p.make_stack(self.cl[p.name]) for p in BOTH}

    def each(self, fn):
        for p in BOTH:
            fn(p, self.cl[p.name])

    def upsert_alloc(self, a):
        self.each(lambda p, cl: cl.upsert_alloc(p.conv(a)))

    def remove_alloc(self, a):
        self.each(lambda p, cl: cl.remove_alloc(a.id, a.job_id))

    def upsert_node(self, n):
        self.each(lambda p, cl: cl.upsert_node(p.conv(n)))

    def remove_node(self, node_id):
        self.each(lambda p, cl: cl.remove_node(node_id))

    def counters(self):
        return {p.name: p.counters("view.") for p in BOTH}

    def refresh(self, mesh, what):
        """Refresh both views; every copy of the port's equals the
        reference's gathered view and a cold shard_cluster of the port's
        unsharded view, bitwise; the counters move alike. Returns the
        port's sharded view."""
        before = self.counters()
        ref = REF.view_np(self.stack["ref"].device_arrays())
        sc = self.stack["port"].device_arrays()
        after = self.counters()
        moved = {name: {k: after[name].get(k, 0) - before[name].get(k, 0)
                        for k in COUNTERS} for name in after}
        assert moved["ref"] == moved["port"], (what, moved)
        assert isinstance(sc, ShardedCluster), what
        _assert_copies(sc, ref, what)
        _assert_copies(sc, _gathered(shard_cluster(_cold(self.cl["port"]),
                                                   mesh)), f"{what} cold")
        return sc


def _cold(cl):
    """A cold unsharded upload of `cl`, leaving its cache entry as it
    was."""
    cache = PORT.stack_mod._DEV_CACHE
    saved = cache.pop(cl, None)
    mesh = get_active_mesh()
    set_active_mesh(None)
    try:
        return PORT.make_stack(cl).device_arrays()
    finally:
        set_active_mesh(mesh)
        cache.pop(cl, None)
        if saved is not None:
            cache[cl] = saved


def _gathered(sc):
    return PORT.view_np(sc.full())


def _assert_copies(sc, want, what):
    """Every distinct copy of every shard equals rows of `want`."""
    rows = sc.n // len(sc.row0)
    copies = shard_copies(sc)
    assert len(copies) == 2 * len(sc.row0), what   # two copies a column
    for (dev, j), shard in copies.items():
        got = PORT.view_np(shard)
        part = {f: a[j * rows:(j + 1) * rows] for f, a in want.items()}
        assert_views_equal(part, got, f"{what} copy ({dev}, {j})")


def test_sharded_view_under_churn_matches_reference(meshes):
    """Allocs placed and stopped, port flips, a node re-registered and one
    removed: the delta-refreshed sharded view equals the reference's and
    a cold upload on every copy, after every round."""
    _jmesh, mesh = meshes
    nodes = [_node(i) for i in range(40)]
    tw = Twin(nodes)
    sc = tw.refresh(mesh, "warm")
    assert sc.devices == mesh.grid()
    live = []
    rng = np.random.default_rng(5)
    for rnd in range(4):
        for k in range(6):
            node = nodes[int(rng.integers(len(nodes)))]
            ports = (8000 + rnd * 10 + k,) if k % 2 else ()
            a = _alloc(node.id, cpu=50 + k, ports=ports)
            tw.upsert_alloc(a)
            live.append(a)
        for a in live[:2]:
            tw.remove_alloc(a)
        live = live[2:]
        if rnd == 1:
            n = _node(7)
            n.attributes["rack"] = "r-new"
            tw.upsert_node(n)
        if rnd == 2:
            tw.remove_node(nodes[33].id)
        tw.refresh(mesh, f"round {rnd}")
    assert PORT.counter("delta_uploads") > 0


def test_mesh_flip_is_a_full_upload(meshes):
    """Installing or removing the mesh re-uploads the whole view (the mesh
    rides the static and ports keys and delta eligibility)."""
    _jmesh, mesh = meshes
    tw = Twin([_node(i) for i in range(12)])
    tw.refresh(mesh, "warm")
    st = tw.stack["port"]
    full0 = PORT.counter("full_uploads")
    ports0 = PORT.counter("ports_full_uploads")
    set_active_mesh(None)
    try:
        flat = st.device_arrays()
        assert not isinstance(flat, ShardedCluster)
    finally:
        set_active_mesh(mesh)
    sc = st.device_arrays()
    assert isinstance(sc, ShardedCluster)
    assert PORT.counter("full_uploads") == full0 + 2
    assert PORT.counter("ports_full_uploads") == ports0 + 2
    _assert_copies(sc, PORT.view_np(flat), "after the flip")


def test_leased_sharded_view_is_never_written(meshes):
    """A refresh under a lease writes copies: every shard and copy of the
    leased view keeps its values; the new view equals a cold upload."""
    _jmesh, mesh = meshes
    nodes = [_node(i) for i in range(24)]
    tw = Twin(nodes)
    tw.refresh(mesh, "warm")
    tw.stack["ref"].device_arrays(lease_token="lease-1")
    leased = tw.stack["port"].device_arrays(lease_token="lease-1")
    before = {k: PORT.view_np(v) for k, v in shard_copies(leased).items()}
    try:
        for node in nodes[::5]:
            tw.upsert_alloc(_alloc(node.id, cpu=321, ports=(9001,)))
        copies0 = PORT.counter("copy_slots")
        sc = tw.refresh(mesh, "under a lease")
        assert PORT.counter("copy_slots") > copies0
        for k, v in shard_copies(leased).items():
            assert_views_equal(before[k], PORT.view_np(v), f"leased {k}")
        assert sc is not leased
    finally:
        for p in BOTH:
            p.stack_mod.release_view(tw.cl[p.name], "lease-1")


def test_a_change_launches_k7_on_its_shard_only(meshes, monkeypatch):
    """A refresh whose changed rows all lie in node shard 1 flushes K7
    once on each of that shard's two copies and on no other tensor."""
    _jmesh, mesh = meshes
    nodes = [_node(i) for i in range(40)]
    tw = Twin(nodes)
    sc = tw.refresh(mesh, "warm")
    rows = sc.n // len(sc.row0)
    cl = tw.cl["port"]
    target = [n for n in nodes if rows <= cl.row_of[n.id] < 2 * rows][:3]
    assert target
    calls = []
    real = kr.view_delta

    def recording(bufs, *rest):
        calls.append(bufs[0])
        return real(bufs, *rest)

    monkeypatch.setattr(kr, "view_delta", recording)
    for node in target:
        tw.upsert_alloc(_alloc(node.id, cpu=77))
    sc = tw.refresh(mesh, "one shard")
    copies = shard_copies(sc)
    assert len(calls) == 2
    assert {id(t) for t in calls} == {id(copies[(torch.device(d), 1)].used)
                                      for d in ("cpu", "cpu:0")}


def test_no_mesh_leaves_the_view_unsharded():
    """Without a mesh the view is the single-device ClusterArrays."""
    assert get_active_mesh() is None
    tw = Twin([_node(i) for i in range(8)])
    assert not isinstance(tw.stack["port"].device_arrays(), ShardedCluster)
