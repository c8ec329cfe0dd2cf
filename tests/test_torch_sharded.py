"""The port's sharded routes of the view's readers against the reference.

Under an active mesh the reference's server reads a node-sharded view and
GSPMD partitions the same jitted kernels over it. The port keeps the
sharded view as a `ShardedCluster` and runs hand-written routes
(`kernels/shard.py`): the packed chain (B10), the single program with
explain (B11) and the system masks (B12). Here the port's plain versions
on CPU shards run against the reference on a cluster sharded over
`conftest.py`'s eight virtual devices, on the same numpy inputs, at the
mesh shapes (1, 2), (2, 2), (1, 8) and (2, 4). `sel_idx`, the counts and
the explain counts and `topk_idx` must be equal, the masks too; scores,
carries and top-K parts within 1e-6 (values in [-2, 1]; one f32 ulp is at
most 2.4e-7 and XLA's exp and torch's differ by an ulp or two).

The explain reduction across shards is held on its hard cases: scores
that tie across a shard border (identical nodes, the rows below the border
masked out, so the top-K straddles it and must keep the lowest global
rows), and a program no node can take (every row at the −1e30 floor: the
top-K is rows 0..4 with zeroed parts).
"""
import random

import numpy as np
import pytest

import jax

from nomad_tpu import mock
from nomad_tpu.kernels.placement import pack_params as jax_pack
from nomad_tpu.kernels.placement import place_packed_chain as jax_packed
from nomad_tpu.kernels.placement import place_task_group as jax_place
from nomad_tpu.kernels.placement import (
    place_task_group_chain as jax_chain,
)
from nomad_tpu.kernels.placement import (
    system_feasibility as jax_system,
)
from nomad_tpu.parallel import make_mesh as jax_make_mesh
from nomad_tpu.parallel import shard_cluster as jax_shard_cluster
from nomad_tpu.parallel import stack_params as jax_stack_params
from nomad_tpu.parallel.mesh import pad_params as jax_pad
from nomad_tpu.scheduler.stack import TPUStack
from nomad_tpu.structs import Constraint
from nomad_tpu.synth import synth_service_job
from nomad_tpu.tensor import ClusterTensors
from torch_chain_cases import (  # noqa: F401
    ATOL,
    assert_outputs,
    mixed_programs,
    one_torch_thread,
    port_bufs,
    port_cluster,
    synth_cluster,
)

from nomad_tpu_torch.convert import params_from_numpy
from nomad_tpu_torch.kernels import placement as tp
from nomad_tpu_torch.kernels import shard as ks
from nomad_tpu_torch.parallel import make_mesh, shard_cluster

SHAPES = [(1, 2), (2, 2), (1, 8), (2, 4)]


def _meshes(shape):
    """(the reference's mesh over its virtual devices, the port's over
    `cpu` shards) of one (batch, nodes) shape."""
    n = shape[0] * shape[1]
    jmesh = jax_make_mesh(n, batch=shape[0])
    mesh = make_mesh(n, batch=shape[0], devices=["cpu"] * n)
    assert mesh.devices.shape == jmesh.devices.shape == shape
    return jmesh, mesh


@pytest.fixture(scope="module")
def mixed():
    """48 nodes in a 64-row bucket (the last shards hold padding rows),
    96 running allocs, four programs of mixed stanzas (affinity, spread,
    distinct_hosts, distinct_property; one with plan deltas and
    penalties)."""
    cl, nodes, rng, allocs = synth_cluster(48, 96)
    stack, progs = mixed_programs(cl, nodes, rng, allocs, n_prog=4,
                                  n_place=3)
    return stack.device_arrays(), progs


def _assert_result(ref, got, what):
    """PlacementResult of the reference against the port's: indices and
    counts equal, floats within ATOL, explain likewise."""
    for f in ("sel_idx", "nodes_feasible", "nodes_fit"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                      getattr(got, f).numpy(),
                                      err_msg=f"{what} {f}")
    for f in ("sel_score", "new_used", "final_scores0"):
        np.testing.assert_allclose(np.asarray(getattr(ref, f)),
                                   getattr(got, f).numpy(), rtol=0,
                                   atol=ATOL, err_msg=f"{what} {f}")
    assert (ref.explain is None) == (got.explain is None), what
    if ref.explain is not None:
        for f in ref.explain._fields:
            a = np.asarray(getattr(ref.explain, f))
            b = getattr(got.explain, f).numpy()
            assert a.shape == b.shape, (what, f, a.shape, b.shape)
            if f in ("topk_score", "topk_parts"):
                np.testing.assert_allclose(a, b, rtol=0, atol=ATOL,
                                           err_msg=f"{what} {f}")
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"{what} {f}")


# ---- B10: the packed chain on a sharded view ---------------------------------


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_packed_chain_matches_reference(mixed, shape):
    """The coordinator's route under a mesh: `place_packed_chain` on the
    sharded view, explain on, against the reference's on its sharded
    view; the outputs land on the lead device shaped as the unsharded
    route's."""
    arrays, progs = mixed
    batched, m = jax_stack_params(progs)
    ib, fb, ub, spec = jax_pack(batched)
    jmesh, mesh = _meshes(shape)
    ref = jax_packed(jax_shard_cluster(arrays, jmesh), ib, fb, ub, spec, m,
                     explain=True)
    sc = shard_cluster(port_cluster(arrays), mesh)
    got = tp.place_packed_chain(sc, *port_bufs(ib, fb, ub), spec, m,
                                explain=True)
    assert_outputs(ref, got, explain=True, what=f"B10 {shape}")
    assert (got[0] >= 0).any()


@pytest.mark.parametrize("shape", [(1, 2), (2, 4), (1, 8)])
def test_sharded_task_group_chain_carries_like_reference(mixed, shape):
    """`place_task_group_chain` on a sharded view: each program's new_used
    is the carry after it, equal to the reference's on its sharded view;
    the plain version's final per-shard carry is the unsharded chain's
    (used, dyn_free) split by shard. (1, 8) is the widest cluster the
    CUDA chain kernel forms, so the plain version, its yardstick on the
    card, is held here at that width too."""
    arrays, progs = mixed
    batched, m = jax_stack_params(progs)
    jmesh, mesh = _meshes(shape)
    ref = jax_chain(jax_shard_cluster(arrays, jmesh), batched, m)
    sc = shard_cluster(port_cluster(arrays), mesh)
    got = tp.place_task_group_chain(sc, params_from_numpy(batched, "cpu"),
                                    m)
    _assert_result(ref, got, f"B10 chain {shape}")
    _res, carry = ks.sharded_chain_plain(sc, batched, m)
    whole, (used, dyn) = tp._chain_with_carry(
        port_cluster(arrays), params_from_numpy(batched, "cpu"), m)
    rows = sc.n // len(sc.row0)
    for (u, d), r0 in zip(carry, sc.row0):
        np.testing.assert_array_equal(u.numpy(), used[r0:r0 + rows].numpy())
        np.testing.assert_array_equal(d.numpy(), dyn[r0:r0 + rows].numpy())


# ---- B11: the single program with explain ------------------------------------


@pytest.fixture(scope="module")
def identical():
    """40 identical nodes (every score ties) in a 64-row bucket, and one
    program of count 6 compiled by the reference."""
    cl = ClusterTensors()
    for i in range(40):
        nd = mock.node()
        nd.id = nd.name = f"node-{i:03d}"
        cl.upsert_node(nd)
    stack = TPUStack(cl)
    rng = random.Random(31)
    job = synth_service_job(rng, count=6)
    p, m = stack.compile_tg(job, job.task_groups[0], 6)
    (p,), m = jax_pad([p])
    nowhere = synth_service_job(rng, count=3)
    nowhere.constraints.append(Constraint("${attr.kernel.name}", "windows",
                                          "="))
    q, mq = stack.compile_tg(nowhere, nowhere.task_groups[0], 3)
    (q,), mq = jax_pad([q])
    return stack.device_arrays(), p, m, q, mq


def _below_border(p, n, border):
    """Program `p` with the rows below `border - 2` masked out by a
    node-width extra_mask: the top-K of tied rows straddles `border`."""
    mask = np.ones(n, dtype=bool)
    mask[:border - 2] = False
    return p._replace(extra_mask=mask)


def _single(arrays, p, m, shape):
    jmesh, mesh = _meshes(shape)
    ref = jax_place(jax_shard_cluster(arrays, jmesh), p, m, explain=True)
    sc = shard_cluster(port_cluster(arrays), mesh)
    got = tp.place_task_group(sc, params_from_numpy(p, "cpu"), m,
                              explain=True)
    return ref, got, sc


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", [0, 1, 3])
def test_sharded_task_group_matches_reference(mixed, shape, case):
    """`place_task_group` with explain on a sharded view (B11), against
    the reference on its sharded view: the mixed programs, one with plan
    deltas and penalties."""
    arrays, progs = mixed
    (p,), m = jax_pad([progs[case]])
    ref, got, _sc = _single(arrays, p, m, shape)
    _assert_result(ref, got, f"B11 {shape} program {case}")


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_topk_ties_across_a_border(identical, shape):
    """Identical nodes: the top-K of tied scores straddles the first
    shard border and keeps the lowest global rows, as lax.top_k does."""
    arrays, p, m, _q, _mq = identical
    n = int(np.asarray(arrays.capacity).shape[0])
    border = n // shape[1]
    p = _below_border(p, n, border)
    ref, got, _sc = _single(arrays, p, m, shape)
    _assert_result(ref, got, f"B11 ties {shape}")
    top = got.explain.topk_idx.numpy()[0]
    assert list(top) == list(range(border - 2, border + 3))


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_topk_of_floor_entries(identical, shape):
    """A program no node can take: every row sits at the −1e30 floor, the
    top-K is global rows 0..4 with zeroed parts, nothing is placed."""
    arrays, _p, _m, q, mq = identical
    ref, got, _sc = _single(arrays, q, mq, shape)
    _assert_result(ref, got, f"B11 floor {shape}")
    assert (got.sel_idx.numpy() == -1).all()
    for step in got.explain.topk_idx.numpy():
        assert list(step) == [0, 1, 2, 3, 4]
    assert not got.explain.topk_parts.numpy().any()


# ---- B12: the system masks ---------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_system_feasibility_matches_reference(mixed, shape):
    """Both masks of K2 per shard, joined in global row order, equal the
    reference's on its sharded view, for every program (plan deltas
    included)."""
    arrays, progs = mixed
    jmesh, mesh = _meshes(shape)
    jc = jax_shard_cluster(arrays, jmesh)
    sc = shard_cluster(port_cluster(arrays), mesh)
    for i, p in enumerate(progs):
        (p,), _m = jax_pad([p])
        want = jax_system(jc, p)
        got = tp.system_feasibility(sc, params_from_numpy(p, "cpu"))
        for w, g, name in zip(want, got, ("feasible", "fits")):
            np.testing.assert_array_equal(np.asarray(w), g.numpy(),
                                          err_msg=f"B12 {shape} {i} {name}")
    assert got[0].shape == (sc.n,)


def test_sharded_routes_refuse_mixed_devices(mixed):
    """A view whose shards lie on two device types has no route."""
    arrays, progs = mixed
    mesh = make_mesh(2, batch=1, devices=["cpu", "meta"])
    with pytest.raises(ValueError, match="no sharded placement"):
        tp.place_task_group(shard_cluster(port_cluster(arrays), mesh),
                            params_from_numpy(jax_pad([progs[0]])[0][0],
                                              "cpu"), 3)


def test_jax_mesh_is_the_virtual_cpu_mesh():
    """The reference side runs on conftest's eight virtual devices."""
    assert len(jax.devices()) >= 8
