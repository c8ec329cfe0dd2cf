"""The port's device mesh and node-sharded step (K9) against the reference.

The twins of `tests/test_parallel.py`: the port's `place_batch_sharded`
and `scheduler_step` over a mesh of eight `cpu` shards (their plain
versions) against the reference's over the eight virtual CPU devices of
`tests/conftest.py`, on the same numpy programs. `sel_idx` must be equal;
scores and folded used within rtol 1e-5, the reference test's own
tolerance (XLA's summation order of the fold-in is unspecified).

Then the port against itself: the sharded step equals the port's
unsharded K6 at every mesh shape — indices, counts and carries exactly,
scores within 1e-6 (an ulp; see the test) — with ties across shard borders,
a preferred node on another shard, a program no node can take, spread and
distinct_property at k = 2, 4 and 8, and a last shard that is all padding;
the fold-in is bitwise the ascending sum of the K6 carries. Plus the
`make_mesh` shape rule against the reference's, and the refusal of a batch
the batch axis does not divide.
"""
import random

import numpy as np
import pytest
import torch

import jax

from torch_chain_cases import one_torch_thread  # noqa: F401
from nomad_tpu.kernels.placement import place_task_group_batch
from nomad_tpu.parallel import make_mesh as jax_make_mesh
from nomad_tpu.parallel import params_sharding as jax_params_sharding
from nomad_tpu.parallel import place_batch_sharded as jax_place_sharded
from nomad_tpu.parallel import scheduler_step as jax_scheduler_step
from nomad_tpu.parallel import shard_cluster as jax_shard_cluster
from nomad_tpu.parallel import stack_params as jax_stack_params
from nomad_tpu.scheduler.stack import TPUStack
from nomad_tpu.synth import build_synthetic_state, synth_service_job

from nomad_tpu_torch import mock as tmock
from nomad_tpu_torch.convert import cluster_from_numpy, params_from_numpy
from nomad_tpu_torch.kernels import placement as tp
from nomad_tpu_torch.kernels import shard as ks
from nomad_tpu_torch.parallel import (
    make_mesh,
    place_batch_sharded,
    scheduler_step,
    shard_cluster,
    stack_params,
)
from nomad_tpu_torch.scheduler.stack import PlanContext, TorchStack
from nomad_tpu_torch.structs import Constraint
from nomad_tpu_torch.synth import build_synthetic_state as t_build_state
from nomad_tpu_torch.synth import synth_service_job as t_service_job
from nomad_tpu_torch.tensor import ClusterTensors

SHAPES = [(1, 1), (1, 2), (2, 2), (1, 8), (2, 4)]
#: score tolerance of the port against itself on the CPU (see below)
ATOL = 1e-6


def _port_view(arrays):
    return cluster_from_numpy({k: np.asarray(v) for k, v in
                               arrays._asdict().items()}, "cpu")


def _cpu_mesh(n, batch=None):
    return make_mesh(n, batch=batch, devices=["cpu"] * n)


@pytest.fixture(scope="module")
def problem():
    """`tests/test_parallel.py`'s fixture: 48 nodes in a 64-row bucket (the
    last of four or eight node shards is all padding), four programs."""
    state, _nodes = build_synthetic_state(48, 96, seed=3)
    rng = random.Random(4)
    stack = TPUStack(state.cluster)
    params = []
    for i in range(4):
        job = synth_service_job(
            rng, count=4, with_affinity=(i % 2 == 0), with_spread=(i % 3 == 0)
        )
        state.upsert_job(job)
        p, _m = stack.compile_tg(job, job.task_groups[0], 4)
        params.append(p)
    return state, stack, params


def _jax_sharded(stack, params):
    mesh = jax_make_mesh(8)
    arrays = stack.device_arrays()
    batched, m = jax_stack_params(params)
    cluster = jax_shard_cluster(arrays, mesh)
    sharded = jax.tree_util.tree_map(
        jax.device_put, batched, jax_params_sharding(mesh, batched=True))
    return mesh, arrays, batched, m, cluster, sharded


def test_sharded_matches_single_device(problem):
    """The port's sharded batch over eight shards == the reference's
    single-device vmap and its GSPMD-sharded dispatch."""
    _state, stack, params = problem
    jmesh, arrays, batched, m, jcluster, jparams = _jax_sharded(stack, params)
    single = place_task_group_batch(arrays, batched, m)
    jsharded = jax_place_sharded(jmesh, m)(jcluster, jparams)

    mesh = _cpu_mesh(8)
    assert mesh.devices.size == 8 and mesh.shape == jmesh.shape
    got = place_batch_sharded(mesh, m)(
        shard_cluster(_port_view(arrays), mesh), batched)
    for ref in (single, jsharded):
        np.testing.assert_array_equal(np.asarray(ref.sel_idx),
                                      got.sel_idx.numpy())
        np.testing.assert_allclose(np.asarray(ref.sel_score),
                                   got.sel_score.numpy(), rtol=1e-5)
        np.testing.assert_allclose(np.asarray(ref.new_used),
                                   got.new_used.numpy(), rtol=1e-5)
    assert (got.sel_idx >= 0).any()


def test_padding_is_inert(problem):
    """Padded programs select the same nodes as unpadded ones on the
    port, and the same as the reference's unpadded selection."""
    from nomad_tpu.kernels.placement import place_task_group as jax_place

    _state, stack, params = problem
    arrays = stack.device_arrays()
    view = _port_view(arrays)
    padded, m = stack_params(params)
    for i, p in enumerate(params):
        base = tp.place_task_group(view, params_from_numpy(p, "cpu"),
                                   p.penalty_idx.shape[0])
        one = type(padded)(*(np.asarray(x)[i] for x in padded))
        pad = tp.place_task_group(view, params_from_numpy(one, "cpu"), m)
        ref = jax_place(arrays, p, p.penalty_idx.shape[0])
        n = min(4, m)
        np.testing.assert_array_equal(base.sel_idx.numpy()[:n],
                                      pad.sel_idx.numpy()[:n])
        np.testing.assert_allclose(base.sel_score.numpy()[:n],
                                   pad.sel_score.numpy()[:n], rtol=1e-6)
        np.testing.assert_array_equal(np.asarray(ref.sel_idx)[:n],
                                      base.sel_idx.numpy()[:n])
        np.testing.assert_allclose(base.sel_score.numpy()[:n],
                                   np.asarray(ref.sel_score)[:n], rtol=0,
                                   atol=1e-6)


def test_scheduler_step_advances_state(problem):
    """The port's step folds placements into the sharded snapshot as the
    reference's does."""
    _state, stack, params = problem
    jmesh, arrays, batched, m, jcluster, jparams = _jax_sharded(stack, params)
    jnew, jres = jax_scheduler_step(jmesh, max_allocs=m)(jcluster, jparams)

    mesh = _cpu_mesh(8)
    new_cluster, result = scheduler_step(mesh, max_allocs=m)(
        shard_cluster(_port_view(arrays), mesh), batched)
    sel = result.sel_idx.numpy()
    np.testing.assert_array_equal(np.asarray(jres.sel_idx), sel)
    placed = int((sel >= 0).sum())
    assert placed > 0
    new_used = new_cluster.full().used.numpy()
    np.testing.assert_allclose(np.asarray(jnew.used), new_used, rtol=1e-5)
    used_delta = new_used - np.asarray(arrays.used)
    assert used_delta.sum() > 0  # capacity consumed
    # each placed alloc consumed its ask exactly once in the folded state
    total_ask = sum(
        float(np.asarray(batched.ask)[b].sum()) * int((sel[b] >= 0).sum())
        for b in range(len(params)))
    np.testing.assert_allclose(used_delta.sum(), total_ask, rtol=1e-5)


@pytest.mark.parametrize("batch", [None, 1, 2])
@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_shape_rule_matches_reference(n, batch):
    """The same (batch, nodes) shape, or a refusal where the reference
    refuses (an indivisible batch, a node axis not a power of two)."""
    try:
        want = jax_make_mesh(n, batch=batch).devices.shape
    except AssertionError:
        with pytest.raises(ValueError):
            _cpu_mesh(n, batch=batch)
        return
    assert _cpu_mesh(n, batch=batch).devices.shape == want


def test_make_mesh_refuses_a_node_axis_that_is_not_a_power_of_two():
    with pytest.raises(ValueError, match="power of two"):
        _cpu_mesh(6, batch=1)
    with pytest.raises(ValueError, match="need 3 devices"):
        make_mesh(3, devices=["cpu"] * 2)


# ---- the port's K9 against its own K6 ----------------------------------------


def _identical_cluster(n_nodes):
    """`n_nodes` identical nodes: every score ties."""
    cl = ClusterTensors()
    nodes = []
    for i in range(n_nodes):
        nd = tmock.node()
        nd.id = f"node-{i:03d}"
        nd.name = nd.id
        cl.upsert_node(nd)
        nodes.append(nd)
    return cl, nodes


def _programs(case):
    """(cluster view, numpy programs) of one case, from the port's own
    compile."""
    if case in ("ties", "preferred_elsewhere"):
        cl, nodes = _identical_cluster(40)
        stack = TorchStack(cl, device="cpu")
        rng = random.Random(11)
        progs = []
        for i in range(4):
            job = t_service_job(rng, count=12, distinct_hosts=i % 2 == 0)
            plan = None
            if case == "preferred_elsewhere":
                plan = PlanContext(preferred_node_ids=[
                    nodes[37 - i].id, None, nodes[21 + i].id])
            progs.append(stack.compile_tg(job, job.task_groups[0], 12,
                                          plan)[0])
        return stack.device_arrays(), progs
    state, _nodes = t_build_state(100, 400, seed=13)
    stack = TorchStack(state.cluster, device="cpu")
    rng = random.Random(14)
    progs = []
    if case == "all_masked":
        job = t_service_job(rng, count=4)
        job.constraints.append(Constraint("${attr.kernel.name}", "windows",
                                          "="))
        progs.append(stack.compile_tg(job, job.task_groups[0], 4)[0])
        job = t_service_job(rng, count=4)
        progs.append(stack.compile_tg(job, job.task_groups[0], 4)[0])
    else:   # spread and distinct_property at k allocs
        k = int(case.split("_")[1])
        for i in range(4):
            job = t_service_job(rng, count=k, with_spread=i % 2 == 0,
                                distinct_property=i % 2 == 1,
                                with_affinity=i == 2)
            state.upsert_job(job)
            progs.append(stack.compile_tg(job, job.task_groups[0], k)[0])
    return stack.device_arrays(), progs


K9_CASES = ("ties", "preferred_elsewhere", "all_masked", "k_2", "k_4",
            "k_8")


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", K9_CASES)
def test_sharded_step_equals_unsharded_batch(case, shape):
    arrays, progs = _programs(case)
    batched, m = stack_params(progs)
    want = tp.place_task_group_batch(arrays,
                                     params_from_numpy(batched, "cpu"), m)
    mesh = _cpu_mesh(shape[0] * shape[1], batch=shape[0])
    sc = shard_cluster(arrays, mesh)
    assert len(sc.row0) == shape[1] and sc.n == arrays.used.shape[0]
    new_cluster, got = scheduler_step(mesh, m)(sc, batched)
    for f in ("sel_idx", "new_used", "nodes_feasible", "nodes_fit"):
        assert torch.equal(getattr(want, f), getattr(got, f)), f
    # torch's CPU exp2 runs its vectorized form on long tensors and the
    # scalar one on the remainder, so a shard's rows may score an ulp
    # away from the same rows in the whole view (on the card both
    # versions compute every row alike and compare bitwise)
    for f in ("sel_score", "final_scores0"):
        torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                   rtol=0, atol=ATOL, msg=f)
    acc = torch.zeros_like(arrays.used)
    for b in range(len(progs)):
        acc = acc + (want.new_used[b] - arrays.used)
    assert torch.equal(new_cluster.full().used, arrays.used + acc)
    for row in new_cluster.shards:   # every replica holds the fold
        for j, shard in enumerate(row):
            assert torch.equal(shard.used, new_cluster.shards[0][j].used)
    sel = got.sel_idx.numpy()
    if case == "ties":
        # distinct_hosts over identical nodes: the lowest rows, in order,
        # across every shard border
        assert list(sel[0]) == list(range(12)) + [-1] * (m - 12)
    if case == "preferred_elsewhere":
        assert sel[0][0] == 37 and sel[0][2] == 21
    if case == "all_masked":
        assert (sel[0] == -1).all() and int(got.nodes_feasible[0]) == 0
        assert (sel[1] >= 0).all()


def test_indivisible_batch_is_refused():
    arrays, progs = _programs("all_masked")
    batched, m = stack_params(progs + progs[:1])
    mesh = _cpu_mesh(4)
    assert mesh.devices.shape == (2, 2)
    with pytest.raises(ValueError, match="do not split"):
        place_batch_sharded(mesh, m)(shard_cluster(arrays, mesh), batched)


def test_cluster_from_another_mesh_is_refused():
    arrays, progs = _programs("all_masked")
    batched, m = stack_params(progs)
    sc = shard_cluster(arrays, _cpu_mesh(2))
    with pytest.raises(ValueError, match="another mesh"):
        place_batch_sharded(_cpu_mesh(4), m)(sc, batched)


def test_cpu_shards_never_launch_the_shard_kernel():
    arrays, progs = _programs("k_2")
    batched, m = stack_params(progs)
    before = ks.launch_count()
    mesh = _cpu_mesh(2)
    place_batch_sharded(mesh, m)(shard_cluster(arrays, mesh), batched)
    assert ks.launch_count() == before


@pytest.mark.slow  # the reference's twin is slow too (test_parallel.py:139)
def test_sharded_matches_single_device_at_bench_scale():
    """10,000 nodes (a 16384-row axis split over the node shards), the
    bench's eval mix: the port's sharded batch == the reference's
    single-device vmap, everything placed."""
    state, _nodes = build_synthetic_state(10_000, 2_000, seed=9)
    rng = random.Random(10)
    stack = TPUStack(state.cluster)
    params = []
    for i in range(8):
        job = synth_service_job(
            rng, count=4,
            with_affinity=(i % 2 == 0), with_spread=(i % 3 == 0),
            distinct_hosts=(i % 5 == 0), with_devices=(i % 4 == 0),
            distinct_property=(i % 7 == 0))
        state.upsert_job(job)
        params.append(stack.compile_tg(job, job.task_groups[0], 4)[0])
    arrays = stack.device_arrays()
    assert arrays.capacity.shape[0] >= 16384
    batched, m = jax_stack_params(params)
    single = place_task_group_batch(arrays, batched, m)
    mesh = _cpu_mesh(8)
    got = place_batch_sharded(mesh, m)(
        shard_cluster(_port_view(arrays), mesh), batched)
    np.testing.assert_array_equal(np.asarray(single.sel_idx),
                                  got.sel_idx.numpy())
    np.testing.assert_allclose(np.asarray(single.sel_score),
                               got.sel_score.numpy(), rtol=1e-5)
    assert int((got.sel_idx >= 0).sum()) == len(params) * 4
