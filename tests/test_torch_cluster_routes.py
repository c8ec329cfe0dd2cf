"""The single program (K1) and the sharded step (K9) on the lane route of
`csrc/lanes.cu`, decomposed on the CPU, and their routes by shape.

K1 on the card is one lane of one program: C = `lane_route(n, 1, ...)`
blocks (8 at 16,384 rows), block j keeping rows [j·rows, (j + 1)·rows) in
shared memory, one record a block a step and their combine; the kernel
writes the program's step-0 scores (final_scores0) and its carry
(new_used) once. The model is `tests/torch_onchip_model.py`'s
`single_model` at C = 1, 2 and 8: it must be bitwise the plain
`place_task_group_plain` — outputs, explain leaves, new_used and
final_scores0 — and equal the JAX package's `place_task_group`: indices
and counts exactly, floats within 1e-6 (values in [-2, 1]; XLA's exp2 and
torch.exp2 may differ by an ulp).

K9's cluster route runs each program as one lane of S blocks, block j
node shard j, then folds every program's carry into every node shard in
one launch. Its model is the same `single_model` with the node shards as
the slices, each shard's fit taken over its own rows (`sliced_fit`, as
the plain sharded version takes it), and the fold in ascending b: bitwise
`sharded_place_plain` (sel_idx, sel_score, nodes_feasible, nodes_fit,
final_scores0, new_used, the folded view), and equal to the JAX
`scheduler_step` on the same numpy programs: indices and counts exactly,
floats within 1e-6, the fold within rtol 1e-5 (the reference test's own
tolerance: XLA's summation order of the fold-in is unspecified).

Also: the routes by shape (`lane_route` at one lane, `step_route` from
the devices and the layout), K9's argument blocks (`cluster_args`)
against the shards they point at, and the layouts' sizes against
`csrc/lanes.cu`. Every card is decided inside the tests; nothing here
needs one.
"""
import random
import re
from functools import lru_cache
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_cases as tc
from torch_chain_cases import one_torch_thread  # noqa: F401
from torch_onchip_model import single_model, sliced_fit
from nomad_tpu.kernels.placement import place_task_group_jit
from nomad_tpu.parallel import make_mesh as jax_make_mesh
from nomad_tpu.parallel import params_sharding as jax_params_sharding
from nomad_tpu.parallel import scheduler_step as jax_scheduler_step
from nomad_tpu.parallel import shard_cluster as jax_shard_cluster
from nomad_tpu.parallel import stack_params as jax_stack_params
from nomad_tpu.parallel.mesh import pad_params
from nomad_tpu.scheduler.stack import PlanContext, TPUStack
from nomad_tpu.structs import Constraint
from nomad_tpu.synth import build_synthetic_state, synth_service_job

from nomad_tpu_torch.convert import cluster_from_numpy, params_from_numpy
from nomad_tpu_torch.kernels import placement as tp
from nomad_tpu_torch.kernels import shard as ks
from nomad_tpu_torch.parallel import make_mesh, shard_cluster

ATOL = 1e-6
SIZES = (1, 2, 8)


def _port_view(arrays):
    return cluster_from_numpy({k: np.asarray(v) for k, v in
                               arrays._asdict().items()}, "cpu")


def _bits(t):
    t = t.detach().cpu().contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_bitwise(want, got, what):
    assert len(want) == len(got), what
    for i, (a, b) in enumerate(zip(want, got)):
        assert a.shape == b.shape and a.dtype == b.dtype, (what, i)
        assert torch.equal(_bits(a), _bits(b)), (what, i)


# ---- K1: one lane of one program ------------------------------------------------

#: the K1 cases of `tests/torch_cases.py` the model runs: plan deltas and
#: released ports, penalties, a preferred node, sampled candidates,
#: spread, distinct_property, port exhaustion, the spread algorithm, a
#: view no node passes
K1_CASES = ("plan_delta_ports", "plan_penalty", "plan_preferred", "sampled",
            "spread_targets", "dp_job_level", "port_conflict",
            "algorithm_spread", "affinity", "all_infeasible")

_K1_FIELDS = ("sel_idx", "sel_score", "nodes_feasible", "nodes_fit")


@lru_cache(maxsize=None)
def _k1_inputs(name, explain):
    """(port view, port program, m, the port's plain result, the
    reference's), computed once a case."""
    case = tc.build(name)
    stack = TPUStack(case.cluster, algorithm=case.algorithm)
    params, m = stack.compile_tg(case.job, case.job.task_groups[0],
                                 case.n_place, case.plan,
                                 sampled_rows=case.sampled_rows)
    (padded,), _ = pad_params([params])
    arrays = stack.device_arrays()
    ref = place_task_group_jit(arrays, padded, m, explain=explain)
    cluster = _port_view(arrays)
    p = params_from_numpy(padded, "cpu")
    plain = tp.place_task_group_plain(cluster, p, m, explain)
    return cluster, p, m, plain, ref


def _flat(r, explain):
    out = tuple(getattr(r, f) for f in _K1_FIELDS)
    return out + tuple(r.explain) if explain else out


@pytest.mark.parametrize("clusters", SIZES, ids=lambda c: f"C{c}")
@pytest.mark.parametrize("explain", [False, True], ids=["plain", "explain"])
@pytest.mark.parametrize("name", K1_CASES)
def test_single_lane_model_matches_plain_and_reference(name, explain,
                                                       clusters):
    cluster, p, m, plain, ref = _k1_inputs(name, explain)
    n = cluster.capacity.shape[0]
    rows = tp.lane_rows(n, clusters)
    slices = [(min(n, j * rows), min(n, (j + 1) * rows))
              for j in range(clusters)]
    flat, final0, new_used = single_model(cluster, p, m, slices, explain)
    _assert_bitwise(_flat(plain, explain), flat, f"{name} C={clusters}")
    _assert_bitwise((plain.final_scores0, plain.new_used),
                    (final0, new_used), f"{name} C={clusters} carry")
    for f in ("sel_idx", "nodes_feasible", "nodes_fit"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                      flat[_K1_FIELDS.index(f)].numpy(),
                                      err_msg=f)
    for want, got, f in ((ref.sel_score, flat[1], "sel_score"),
                         (ref.final_scores0, final0, "final_scores0"),
                         (ref.new_used, new_used, "new_used")):
        np.testing.assert_allclose(np.asarray(want), got.numpy(), rtol=0,
                                   atol=ATOL, err_msg=f)
    if explain:
        for i, f in enumerate(tp.PlacementExplain._fields):
            want = np.asarray(getattr(ref.explain, f))
            got = flat[len(_K1_FIELDS) + i].numpy()
            if f in ("topk_score", "topk_parts"):
                np.testing.assert_allclose(want, got, rtol=0, atol=ATOL,
                                           err_msg=f)
            else:
                np.testing.assert_array_equal(want, got, err_msg=f)
    if name == "all_infeasible":
        # every row at the −1e30 floor
        assert (final0 == tp.NEG_INF).all()
    elif name not in ("port_conflict",):
        assert (flat[0] >= 0).any(), "nothing placed: vacuous"


#: `_program_dims` of phase 3's mix at count 10 (M = 16), explain on
MIX_DIMS = dict(c=4, v=32, a=1, av=32, m=16, pn=1, e=1, j=1, j2=1, d=1,
                l=1, p=1, dv=32, pp=1, pc=1, ps=1, s=1, sv=32, cw=1,
                explain=1, topk=5)


def test_single_program_takes_eight_blocks_at_the_bench_view():
    """K1 is one lane: C = 8 at 16,384 rows (2,048 a block), fewer blocks
    below 2,048 rows a block, whatever the card's SM count."""
    for sms in (132, 16):
        assert tp.lane_route(16384, 1, MIX_DIMS, 8, sms) == 8
    assert tp.lane_route(8192, 1, MIX_DIMS, 8, 132) == 4
    assert tp.lane_route(2048, 1, MIX_DIMS, 8, 132) == 1
    assert tp.lane_route(64, 1, dict(MIX_DIMS, explain=0), 8, 132) == 1


def test_single_program_past_the_layout_takes_placement_cu():
    """Where no cluster of 8 holds a program's rows, a vocabulary passes
    u16 tokens, or the program has no step, K1 takes placement.cu."""
    fits = [n for n in range(16384, 1 << 20, 4096)
            if tp.lane_layout(tp.lane_rows(n, 8), MIX_DIMS, 8,
                              8)["total"] <= tp.BLOCK_SMEM]
    assert tp.lane_route(fits[-1], 1, MIX_DIMS, 8, 132) == 8
    assert tp.lane_route(fits[-1] + 4096, 1, MIX_DIMS, 8, 132) == 0
    assert tp.lane_route(256, 1, dict(MIX_DIMS, dv=65537), 8, 132) == 0
    assert tp.lane_route(256, 1, dict(MIX_DIMS, m=0), 8, 132) == 0


def test_cpu_tensors_never_launch_a_single_program_kernel():
    cluster, p, m, plain, _ref = _k1_inputs("plan_penalty", False)
    before = (tp.launch_count(), tp.single_kernel_launches(),
              tp.single_route_counts(), tp.last_single_route())
    got = tp.place_task_group(cluster, p, m)
    assert (tp.launch_count(), tp.single_kernel_launches(),
            tp.single_route_counts(), tp.last_single_route()) == before
    assert torch.equal(got.sel_idx, plain.sel_idx)
    with pytest.raises(ValueError, match="CUDA"):
        tp.place_task_group_cuda(cluster, p, m)


# ---- K9: a program a cluster, a node shard a block ------------------------------

K9_SHAPES = ((1, 2), (1, 4), (2, 2), (1, 8))
K9_CASES = ("mix", "preferred_elsewhere", "spread_dp", "masked")


def _k9_programs(case):
    """(reference stack, numpy programs) on a 48-node view (64 rows: the
    last node shards of eight are all padding)."""
    state, nodes = build_synthetic_state(48, 96, seed=3)
    rng = random.Random(4)
    stack = TPUStack(state.cluster)
    params = []
    for i in range(4):
        kw = dict(with_affinity=i % 2 == 0, with_spread=i % 3 == 0)
        if case == "spread_dp":
            kw = dict(with_spread=i % 2 == 0, distinct_property=i % 2 == 1,
                      distinct_hosts=i == 3)
        job = synth_service_job(rng, count=4, **kw)
        plan = None
        if case == "preferred_elsewhere":
            # preferred nodes in the last populated shards, and a plan
            # delta (a stopped alloc) in program 1
            plan = PlanContext(preferred_node_ids=[nodes[47 - i].id, None,
                                                   nodes[40 + i].id])
            if i == 1:
                plan.stopped_allocs = list(state._allocs.values())[:3]
        if case == "masked" and i == 0:
            job.constraints.append(Constraint("${attr.kernel.name}",
                                              "windows", "="))
        state.upsert_job(job)
        params.append(stack.compile_tg(job, job.task_groups[0], 4, plan)[0])
    return stack, params


@lru_cache(maxsize=None)
def _k9_inputs(case):
    """(port view, numpy batch, m, the JAX scheduler_step's result and
    folded used), the reference run once a case on its eight-device
    mesh."""
    stack, params = _k9_programs(case)
    arrays = stack.device_arrays()
    batched, m = jax_stack_params(params)
    mesh = jax_make_mesh(8)
    jcluster = jax_shard_cluster(arrays, mesh)
    jparams = jax.tree_util.tree_map(
        jax.device_put, batched, jax_params_sharding(mesh, batched=True))
    jnew, jres = jax_scheduler_step(mesh, max_allocs=m)(jcluster, jparams)
    ref = {f: np.asarray(getattr(jres, f)) for f in (
        "sel_idx", "sel_score", "nodes_feasible", "nodes_fit", "new_used",
        "final_scores0")}
    return _port_view(arrays), batched, m, ref, np.asarray(jnew.used)


def k9_model(sc, batch, m):
    """K9's cluster route in torch: every program of batch row i a lane of
    S blocks over row i's shards (`single_model`, the node shards as its
    slices, each shard's fit over its own rows), then the fold of every
    program's carry into each node shard, in ascending b. Returns
    (PlacementResult with a leading B, the folded view per node shard)."""
    view = sc.full()
    b_all = batch.n_place.shape[0]
    bp = b_all // len(sc.devices)
    ns = sc.n // len(sc.row0)
    slices = [(r0, r0 + ns) for r0 in sc.row0]
    fit = sliced_fit(slices)
    rows, carries = [], []
    for b in range(b_all):
        flat, final0, new_used = single_model(view, tp._program(batch, b), m,
                                              slices, False, fit)
        rows.append(flat + (final0, new_used))
        carries.append(new_used)
    sel, score, feas, fits, final0, new_used = (torch.stack(c)
                                                for c in zip(*rows))
    folded = []
    for j, r0 in enumerate(sc.row0):
        acc = torch.zeros_like(sc.shards[0][j].used)
        for i, row in enumerate(sc.shards):
            used = row[j].used
            for nu in carries[i * bp:(i + 1) * bp]:
                acc = acc + (nu[r0:r0 + ns] - used)
        folded.append(sc.shards[-1][j].used + acc)
    return tp.PlacementResult(sel, score, new_used, feas, fits, final0), \
        folded


_K9_FIELDS = ("sel_idx", "sel_score", "nodes_feasible", "nodes_fit",
              "final_scores0", "new_used")


@pytest.mark.parametrize("shape", K9_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", K9_CASES)
def test_step_model_matches_plain_and_scheduler_step(case, shape):
    view, batched, m, ref, ref_used = _k9_inputs(case)
    n_dev = shape[0] * shape[1]
    sc = shard_cluster(view, make_mesh(n_dev, batch=shape[0],
                                       devices=["cpu"] * n_dev))
    batch = params_from_numpy(batched, "cpu")
    got, folded = k9_model(sc, batch, m)
    want, want_folded = ks.sharded_place_plain(sc, batched, m, fold=True)
    for f in _K9_FIELDS:
        _assert_bitwise((getattr(want, f),), (getattr(got, f),),
                        f"{case} {shape} {f}")
    _assert_bitwise(tuple(want_folded), tuple(folded), f"{case} fold")
    for f in ("sel_idx", "nodes_feasible", "nodes_fit"):
        np.testing.assert_array_equal(ref[f], getattr(got, f).numpy(),
                                      err_msg=f)
    for f in ("sel_score", "final_scores0", "new_used"):
        np.testing.assert_allclose(ref[f], getattr(got, f).numpy(), rtol=0,
                                   atol=ATOL, err_msg=f)
    np.testing.assert_allclose(ref_used, torch.cat(folded).numpy(),
                               rtol=1e-5, err_msg="fold")
    sel = got.sel_idx.numpy()
    assert (sel >= 0).any(), "nothing placed: vacuous"
    if case == "preferred_elsewhere":
        assert sel[0][0] == 47 and sel[0][2] == 40
    if case == "masked":
        assert (sel[0] == -1).all() and int(got.nodes_feasible[0]) == 0
        assert (got.final_scores0[0] == tp.NEG_INF).all()


def _grid(rows, shards, dev="cuda:0"):
    return [[dev] * shards for _ in range(rows)]


#: `_program_dims` of K9's programs at bench's mix (M = 8, explain off)
STEP_DIMS = dict(MIX_DIMS, m=8, explain=0)


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
@pytest.mark.parametrize("rows", [1, 2])
def test_one_card_takes_the_step_cluster_route(rows, shards):
    assert ks.step_route(_grid(rows, shards), 16384, STEP_DIMS,
                         8) == "cluster"
    assert ks.step_route(_grid(rows, shards, "cuda:1"), 64, STEP_DIMS,
                         8) == "cluster"


@pytest.mark.parametrize("grid", [
    [["cuda:0", "cuda:1"]], [["cuda:0"] * 2, ["cuda:1"] * 2],
    [["cuda:0"] * 16], [["cuda:0"] * 9], _grid(9, 8)],
    ids=["2-cards", "rows-on-2-cards", "16-shards", "9-shards",
         "72-copies"])
def test_spanning_or_wide_grids_take_the_steps_route(grid):
    assert ks.step_route(grid, 16384 * 9, STEP_DIMS, 8) == "steps"


def test_step_layouts_past_a_block_take_the_steps_route():
    """The cluster route needs a node shard's rows in one block's shared
    memory, programs with a step and vocabularies within u16 tokens."""
    s = 4
    fits = [n for n in range(16384, 1 << 21, 16384)
            if tp.lane_layout(n // s, STEP_DIMS, 8, s)["total"]
            <= tp.BLOCK_SMEM]
    grid = _grid(1, s)
    assert ks.step_route(grid, fits[-1], STEP_DIMS, 8) == "cluster"
    assert ks.step_route(grid, fits[-1] + 16384, STEP_DIMS, 8) == "steps"
    assert ks.step_route(grid, 256, dict(STEP_DIMS, m=0), 8) == "steps"
    assert ks.step_route(grid, 256, dict(STEP_DIMS, sv=70000), 8) == "steps"
    assert ks.step_route(grid, 258, STEP_DIMS, 8) == "steps"   # 258 % 4


def test_step_route_on_cpu_is_plain_and_mixed_types_have_none():
    assert ks.step_route(_grid(2, 2, "cpu"), 64, STEP_DIMS, 8) == "plain"
    with pytest.raises(ValueError, match="no sharded placement"):
        ks.step_route([["cpu", "cuda:0"]], 64, STEP_DIMS, 8)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
def test_cluster_args_point_every_block_at_its_shard(shape):
    """Block (l, j) of K9's cluster route: program l's fields and output
    rows, the global row count, and batch row (l // bp)'s node shard j
    moved back j·(N / S) rows, so that global row g lies g rows past each
    cluster pointer."""
    view, batched, m, _ref, _u = _k9_inputs("mix")
    n_dev = shape[0] * shape[1]
    sc = shard_cluster(view, make_mesh(n_dev, batch=shape[0],
                                       devices=["cpu"] * n_dev))
    batch = params_from_numpy(batched, "cpu")
    b, s, n = batch.n_place.shape[0], shape[1], sc.n
    bp, ns = b // shape[0], n // s
    _b, _shapes, ptrs_of = tp._stacked_source(sc.shards[0][0], batch)
    dims = ks._step_dims(batch, m, n)
    outs = ks._step_outputs(b, n, 8, m, "cpu")
    args = ks.cluster_args(sc, dims, bp, ptrs_of, outs)
    assert args.shape == (b * s,)
    assert (args["n"] == n).all() and (args["m"] == m).all()
    assert (args["explain"] == 0).all()
    for l in range(b):
        for j in range(s):
            a = args[l * s + j]
            for f in tp.TGParams._fields:
                assert a[f] == ptrs_of(f)[l], (l, j, f)
            for f, t in outs.items():
                assert a[f] == t[l].data_ptr(), (l, j, f)
            shard = sc.shards[l // bp][j]
            for f, t in shard._asdict().items():
                row = t.stride(0) * t.element_size()
                g = j * ns + 3      # a global row of shard j
                assert int(a[f]) + g * row == t[3].data_ptr(), (l, j, f)


def _struct_fields(name):
    src = (Path(tp.__file__).parent / "csrc" / "lanes.cu").read_text()
    body = re.search(r"struct %s \{(.*?)\n\};" % name, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            names += [re.sub(r"\[.*\]", "", x).strip(" *").split()[-1]
                      for x in decl.split(",")]
    return names


@pytest.mark.parametrize("mirror,name", [(tp._LaneRun, "LaneRun"),
                                         (tp._LaneShardFold,
                                          "LaneShardFold")])
def test_mirrors_name_the_kernels_fields_in_order(mirror, name):
    """`_LaneRun` and `_LaneShardFold` list csrc/lanes.cu's members in
    its order; the library checks their sizes at load."""
    assert [f for f, _t in mirror._fields_] == _struct_fields(name)


def test_fold_mirror_holds_a_grid_of_shards():
    f = tp._LaneShardFold
    assert f.used.size == 8 * tp.MAX_FOLD_COPIES == 8 * 64
    assert f.out.size == 8 * tp.MAX_CLUSTER
    assert tp.ctypes.sizeof(f) == 24 + 8 * (64 + 8)


@pytest.mark.parametrize("rows", [16, 100, 4096])
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_step_layout_is_a_lane_block_of_a_shards_rows(rows, shards):
    """A K9 block keeps a node shard's rows, any count (no wave writes its
    overlay words): per row 4 + 1 bytes and a token a spread row and a
    property, an overlay bit a row in whole words, two sets of S record
    slots, no explain lists."""
    dims = dict(STEP_DIMS, s=2, p=1)
    lay = tp.lane_layout(rows, dims, 8, shards)
    assert lay["prefix"][1] == 4 * rows and lay["meta"][1] == rows
    assert lay["exh"][1] == 0 and lay["lists"][1] == 0
    assert lay["overlay"][1] == 4 * -(-rows // 32)
    assert lay["stok"][1] == 2 * rows and lay["dtok"][1] == rows
    words = tp.record_words(dims, 8)
    assert words == 7 + 2 * 3
    assert lay["slots"][1] == 2 * shards * 4 * (-(-words // 4) * 4)
    assert lay["total"] % 16 == 0


@pytest.fixture(scope="module")
def cpu_step():
    view, batched, m, _ref, _u = _k9_inputs("mix")
    sc = shard_cluster(view, make_mesh(4, batch=1, devices=["cpu"] * 4))
    return sc, batched, m


def test_cpu_shards_run_the_plain_step_and_say_so(cpu_step):
    sc, batched, m = cpu_step
    before = (ks.launch_count(), ks.step_kernel_launches())
    ks._SHARD.last_step_route = None
    got, _f = ks.sharded_place(sc, batched, m)
    assert ks.last_step_route() == "plain"
    assert (ks.launch_count(), ks.step_kernel_launches()) == before
    want, _f = ks.sharded_place_plain(sc, batched, m)
    assert torch.equal(got.sel_idx, want.sel_idx)


def test_cuda_step_routes_refuse_cpu_shards(cpu_step):
    sc, batched, m = cpu_step
    for route in (None, "cluster", "steps"):
        with pytest.raises(ValueError, match="expected cuda"):
            ks.sharded_place_cuda(sc, batched, m, route=route)
