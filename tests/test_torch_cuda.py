"""The CUDA kernels against their plain PyTorch versions, on the card:
K1 (its lane route bitwise placement.cu's), the chain and wave (K4, K5;
the lane route bitwise chain.cu's, at several cluster sizes, waves past
65,535 lanes), the batch (K6; its on-chip and pooled packed routes
bitwise each other), the row kernels (K7, K8), K2 (from numpy and
from tensors, bitwise its old pass), K3, the node-sharded step (K9; its
cluster route bitwise its steps route), and the sharded routes (B10-B13)
on shards of the card — B10/B11's cluster route held bitwise against
its steps route, B12's cards route against its shards route.

Marked `cuda`: it skips without an NVIDIA card (a CUDA kernel has no CPU
mode). It imports nothing of JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Programs come from the port's own compile (`TorchStack.compile_tg` +
`pad_params`) on a seeded synthetic cluster. Indices and counts must be
equal; floats within 1e-6 (exp2f and torch.exp2 may differ by an ulp).
"""
import random

import pytest
import torch

from nomad_tpu_torch.convert import params_from_numpy
from nomad_tpu_torch.kernels import placement as kp
from nomad_tpu_torch.parallel.pad import pad_params
from nomad_tpu_torch.scheduler.stack import PlanContext, TorchStack
from nomad_tpu_torch.synth import build_synthetic_state, synth_service_job

ATOL = 1e-6


@pytest.fixture(scope="module")
def cuda_device():
    """The card, or a skip: a CUDA kernel has no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _assert_same(want, got):
    for f in ("sel_idx", "nodes_feasible", "nodes_fit"):
        assert torch.equal(getattr(want, f).cpu(), getattr(got, f).cpu()), f
    for f in ("sel_score", "new_used", "final_scores0"):
        torch.testing.assert_close(getattr(got, f).cpu(),
                                   getattr(want, f).cpu(), rtol=0,
                                   atol=ATOL, msg=f)
    assert (want.explain is None) == (got.explain is None)
    if want.explain is not None:
        for f in kp.PlacementExplain._fields:
            a = getattr(want.explain, f).cpu()
            b = getattr(got.explain, f).cpu()
            if f in ("topk_score", "topk_parts"):
                torch.testing.assert_close(b, a, rtol=0, atol=ATOL, msg=f)
            else:
                assert torch.equal(a.to(b.dtype), b), f


LANE_SIZES = (1, 2, 8)

_KINDS = {
    "binpack": dict(),
    "affinity_spread": dict(with_affinity=True, with_spread=True),
    "distinct": dict(distinct_hosts=True, distinct_property=True),
    "devices": dict(with_devices=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", ["binpack", "spread"])
@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_kernel_matches_plain(kind, algorithm, cuda_device):
    state, nodes = build_synthetic_state(300, 3000, seed=1)
    rng = random.Random(2)
    job = synth_service_job(rng, count=10, **_KINDS[kind])
    stack = TorchStack(state.cluster, algorithm=algorithm,
                       device=cuda_device)
    filler = list(state._allocs.values())[:5]
    plan = PlanContext(
        stopped_allocs=filler,
        penalty_node_ids=[frozenset({nodes[i].id}) for i in range(4)],
        preferred_node_ids=[None, nodes[3].id])
    for p_ctx, rows in ((None, None), (plan, None),
                        (None, list(range(0, 300, 7)))):
        params, m = stack.compile_tg(job, job.task_groups[0], 10, p_ctx,
                                     sampled_rows=rows)
        (padded,), _ = pad_params([params])
        arrays = stack.device_arrays()
        p = params_from_numpy(padded, cuda_device)
        for explain in (False, True):
            before = kp.launch_count()
            got = kp.place_task_group(arrays, p, m, explain)
            assert kp.launch_count() == before + 1
            want = kp.place_task_group_plain(arrays, p, m, explain)
            torch.cuda.synchronize()
            _assert_same(want, got)


def _single_bits(want, got, what):
    """Two K1 results, every output and explain leaf bit for bit."""
    for f in ("sel_idx", "sel_score", "nodes_feasible", "nodes_fit",
              "new_used", "final_scores0"):
        a, b = getattr(want, f), getattr(got, f)
        assert a.shape == b.shape and torch.equal(_bits(a), _bits(b)), \
            (what, f)
    assert (want.explain is None) == (got.explain is None), what
    for f in kp.PlacementExplain._fields if want.explain else ():
        a, b = getattr(want.explain, f), getattr(got.explain, f)
        assert a.shape == b.shape and torch.equal(_bits(a), _bits(b)), \
            (what, f)


def _single_zero(want, got, what):
    """A K1 result 0.0 from plain: every leaf equal."""
    for f in ("sel_idx", "sel_score", "nodes_feasible", "nodes_fit",
              "new_used", "final_scores0"):
        a, b = getattr(want, f).cpu(), getattr(got, f).cpu()
        assert torch.equal(a.to(b.dtype), b), (what, f)
    for f in kp.PlacementExplain._fields if want.explain else ():
        a = getattr(want.explain, f).cpu()
        b = getattr(got.explain, f).cpu()
        assert torch.equal(a.to(b.dtype), b), (what, f)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_single_lane_route_equals_placement_cu_bitwise(kind, cuda_device):
    """K1 on the lane route (one launch: the program as one lane of the
    cluster size it picks, and of 1, 2 and 8 blocks) is placement.cu's
    route (two launches) bit for bit — outputs, explain leaves, new_used
    and final_scores0 — and 0.0 from plain, with plan deltas, penalties,
    a preferred node and sampled candidates, explain off and on."""
    state, nodes = build_synthetic_state(300, 3000, seed=1)
    rng = random.Random(2)
    job = synth_service_job(rng, count=10, **_KINDS[kind])
    stack = TorchStack(state.cluster, device=cuda_device)
    filler = list(state._allocs.values())[:5]
    plan = PlanContext(
        stopped_allocs=filler,
        penalty_node_ids=[frozenset({nodes[i].id}) for i in range(4)],
        preferred_node_ids=[None, nodes[3].id])
    for p_ctx, rows in ((None, None), (plan, None),
                        (None, list(range(0, 300, 7)))):
        params, m = stack.compile_tg(job, job.task_groups[0], 10, p_ctx,
                                     sampled_rows=rows)
        (padded,), _ = pad_params([params])
        arrays = stack.device_arrays()
        p = params_from_numpy(padded, cuda_device)
        for explain in (False, True):
            k0 = kp.single_kernel_launches()
            ref = kp.place_task_group_cuda(arrays, p, m, explain, clusters=0)
            assert kp.last_single_route() == ("scan", None)
            assert kp.single_kernel_launches() == k0 + 2
            want = kp.place_task_group_plain(arrays, p, m, explain)
            for c in (None,) + LANE_SIZES:
                k0, n0 = kp.single_kernel_launches(), kp.launch_count()
                got = kp.place_task_group_cuda(arrays, p, m, explain,
                                               clusters=c)
                route, size = kp.last_single_route()
                assert route == "cluster" and (c is None or size == c)
                assert kp.single_kernel_launches() == k0 + 1
                assert kp.launch_count() == n0 + 1
                torch.cuda.synchronize()
                _single_bits(ref, got, (kind, explain, c))
                _single_zero(want, got, (kind, explain, c))


# ---- the chain, wave and row-scatter kernels (K4, K5, K8) -------------------


def _assert_flat(want, got, explain):
    """Flat chain/wave outputs: integer leaves equal, float leaves (the
    scores, top-K scores and parts) within ATOL."""
    floats = {1}
    if explain:
        names = kp.PlacementExplain._fields
        floats |= {4 + names.index("topk_score"),
                   4 + names.index("topk_parts")}
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        a, b = a.cpu(), b.cpu()
        assert a.shape == b.shape, (i, a.shape, b.shape)
        if i in floats:
            torch.testing.assert_close(b, a, rtol=0, atol=ATOL, msg=str(i))
        else:
            assert torch.equal(a.to(b.dtype), b), i


def _assert_carry(want, got):
    for a, b in zip(want, got):
        torch.testing.assert_close(b.cpu(), a.cpu(), rtol=0, atol=ATOL)


def _table_dispatch(cuda_device, dcs=None, n_prog=5):
    """A seeded cluster, mixed programs (one with plan deltas, one inert
    pad) and their program-table transport on the card; the table's
    commit runs the insert kernel once."""
    from nomad_tpu_torch.convert import tensor_from_numpy
    from nomad_tpu_torch.kernels import rows as kr
    from nomad_tpu_torch.lib.transfer import default_ledger
    from nomad_tpu_torch.server.program_table import DeviceProgramTable
    from nomad_tpu_torch.server.select_batch import _inert_program

    state, nodes = build_synthetic_state(300, 3000, seed=3)
    rng = random.Random(4)
    stack = TorchStack(state.cluster, device=cuda_device)
    kinds = sorted(_KINDS)
    filler = list(state._allocs.values())[:5]
    progs = []
    for i in range(n_prog):
        kw = dict(_KINDS[kinds[i % len(kinds)]])
        if dcs is not None:
            kw["datacenter"] = dcs[i % len(dcs)]
        job = synth_service_job(rng, count=4, **kw)
        plan = PlanContext(stopped_allocs=filler) if i == 1 else None
        progs.append(stack.compile_tg(job, job.task_groups[0], 4, plan)[0])
    progs.append(_inert_program(progs[0]))
    table = DeviceProgramTable(device=cuda_device)
    prep = table.prepare(progs)
    before = kr.launch_count()
    ti, tf, tu, _nb, _count = table.commit(prep, default_ledger())
    assert kr.launch_count() == before + 1
    dyn = [tensor_from_numpy(d, cuda_device)
           for d in (prep.dyn_i, prep.dyn_f, prep.dyn_u)]
    return stack.device_arrays(), prep, (ti, tf, tu), dyn


@pytest.mark.cuda
@pytest.mark.parametrize("explain", [False, True], ids=["plain", "explain"])
def test_chain_kernel_matches_plain(explain, cuda_device):
    arrays, prep, tables, dyn = _table_dispatch(cuda_device)
    args = (arrays, *tables, prep.rows, *dyn, prep.sspec, prep.dspec,
            prep.m)
    before = kp.chain_launch_count()
    got, got_carry = kp.place_table_chain(*args, explain=explain)
    assert kp.chain_launch_count() == before + 1
    want, want_carry = kp.place_table_chain_plain(*args, explain=explain)
    torch.cuda.synchronize()
    _assert_flat(want, got, explain)
    _assert_carry(want_carry, got_carry)
    assert (got[0][-1] == -1).all(), "the inert pad placed"


@pytest.mark.cuda
@pytest.mark.parametrize("explain", [False, True], ids=["plain", "explain"])
def test_wave_kernel_matches_plain(explain, cuda_device):
    arrays, prep, tables, dyn = _table_dispatch(cuda_device, n_prog=5)
    # three lanes of two programs; lanes 0 and 1 overlap (both
    # unpinned), so the fold has collisions to count
    rows = prep.rows.reshape(3, 2)
    dyn = [d.reshape(3, 2, -1) for d in dyn]
    args = (arrays, *tables, rows, *dyn, prep.sspec, prep.dspec, prep.m)
    before = kp.wave_launch_count()
    got, got_carry = kp.place_table_wave(*args, explain=explain)
    assert kp.wave_launch_count() == before + 1
    want, want_carry = kp.place_table_wave_plain(*args, explain=explain)
    torch.cuda.synchronize()
    _assert_flat(want, got, explain)
    _assert_carry(want_carry, got_carry)
    assert got_carry[0].data_ptr() != arrays.used.data_ptr()


@pytest.mark.cuda
def test_packed_and_stacked_chains_match_plain(cuda_device):
    from nomad_tpu_torch.convert import params_from_numpy, tensor_from_numpy
    from nomad_tpu_torch.parallel.pad import stack_params

    state, _nodes = build_synthetic_state(300, 3000, seed=5)
    rng = random.Random(6)
    stack = TorchStack(state.cluster, device=cuda_device)
    progs = [stack.compile_tg(j, j.task_groups[0], 3, None)[0] for j in (
        synth_service_job(rng, count=3, **_KINDS[k]) for k in sorted(_KINDS))]
    batched, m = stack_params(progs)
    arrays = stack.device_arrays()
    ibuf, fbuf, ubuf, spec = kp.pack_params(batched)
    bufs = [tensor_from_numpy(b, cuda_device) for b in (ibuf, fbuf, ubuf)]
    got = kp.place_packed_chain(arrays, *bufs, spec, m, True)
    want = kp.place_packed_chain_plain(arrays, *bufs, spec, m, True)
    torch.cuda.synchronize()
    _assert_flat(want, got, True)
    p = params_from_numpy(batched, cuda_device)
    got = kp.place_task_group_chain(arrays, p, m)
    want = kp.place_task_group_chain_plain(arrays, p, m)
    torch.cuda.synchronize()
    _assert_same(want, got)


# ---- K4 and K5 on the lane route (csrc/lanes.cu) -----------------------------

#: cluster sizes the lane route is held at beside the one it picks
def _same_bits(want, got, what):
    """Flat outputs or carries, leaf by leaf, bit for bit."""
    assert len(want) == len(got), what
    for i, (a, b) in enumerate(zip(want, got)):
        assert a.shape == b.shape and torch.equal(_bits(a), _bits(b)), \
            (what, i)


def _zero_from_plain(want, got, what):
    """Flat outputs or carries equal to plain's: integers equal, floats
    0.0 apart."""
    for i, (a, b) in enumerate(zip(want, got)):
        a, b = a.cpu(), b.cpu()
        assert a.shape == b.shape and torch.equal(a.to(b.dtype), b), \
            (what, i)


def _lane_sizes(run, kind, what):
    """`run(clusters)` at the picked size and at LANE_SIZES, each on the
    lane route with its launches (one a chain, two a wave); returns the
    outputs by size."""
    outs = {}
    for c in (None,) + LANE_SIZES:
        k0 = kp.chain_kernel_launches()[kind]
        outs[c] = run(c)
        route, size = kp.last_chain_dispatch_route()
        assert route == "cluster" and (c is None or size == c), (what, c)
        assert kp.chain_kernel_launches()[kind] == k0 + (
            2 if kind == "wave" else 1), (what, c)
    return outs


@pytest.mark.cuda
@pytest.mark.parametrize("explain", [False, True], ids=["plain", "explain"])
def test_lane_route_equals_chain_cu_bitwise(explain, cuda_device):
    """K4 and K5 on the lane route, at the cluster size it picks and at
    C = 1, 2 and 8: the table chain (one program with plan deltas, an
    inert pad), the packed chain and a wave of three lanes whose first two
    overlap — outputs, explain leaves and carries bitwise chain.cu's
    route (`nomad_place_lanes`) and 0.0 from plain; one launch a chain,
    two a wave."""
    from nomad_tpu_torch.convert import tensor_from_numpy
    from nomad_tpu_torch.parallel.pad import stack_params

    arrays, prep, tables, dyn = _table_dispatch(cuda_device)
    args = (arrays, *tables, prep.rows, *dyn, prep.sspec, prep.dspec,
            prep.m)
    ref = kp.place_table_chain_cuda(*args, explain=explain, clusters=0)
    assert kp.last_chain_dispatch_route() == ("lanes", None)
    want = kp.place_table_chain_plain(*args, explain=explain)
    outs = _lane_sizes(lambda c: kp.place_table_chain_cuda(
        *args, explain=explain, clusters=c), "chain", "table chain")
    torch.cuda.synchronize()
    for c, got in outs.items():
        for part in range(2):
            _same_bits(ref[part], got[part], ("table chain", c, part))
            _zero_from_plain(want[part], got[part], ("table chain", c, part))
    assert (outs[None][0][0][-1] == -1).all(), "the inert pad placed"

    wrows = prep.rows.reshape(3, 2)
    wdyn = [d.reshape(3, 2, -1) for d in dyn]
    wargs = (arrays, *tables, wrows, *wdyn, prep.sspec, prep.dspec, prep.m)
    ref = kp.place_table_wave_cuda(*wargs, explain=explain, clusters=0)
    want = kp.place_table_wave_plain(*wargs, explain=explain)
    outs = _lane_sizes(lambda c: kp.place_table_wave_cuda(
        *wargs, explain=explain, clusters=c), "wave", "wave")
    torch.cuda.synchronize()
    for c, got in outs.items():
        for part in range(2):
            _same_bits(ref[part], got[part], ("wave", c, part))
            _zero_from_plain(want[part], got[part], ("wave", c, part))

    rng = random.Random(6)
    state, _nodes = build_synthetic_state(300, 3000, seed=5)
    stack = TorchStack(state.cluster, device=cuda_device)
    progs = [stack.compile_tg(j, j.task_groups[0], 3, None)[0] for j in (
        synth_service_job(rng, count=3, **_KINDS[k]) for k in sorted(_KINDS))]
    batched, m = stack_params(progs)
    parrays = stack.device_arrays()
    ibuf, fbuf, ubuf, spec = kp.pack_params(batched)
    bufs = [tensor_from_numpy(b, cuda_device) for b in (ibuf, fbuf, ubuf)]
    ref = kp.place_packed_chain_cuda(parrays, *bufs, spec, m, explain,
                                     clusters=0)
    want = kp.place_packed_chain_plain(parrays, *bufs, spec, m, explain)
    outs = _lane_sizes(lambda c: kp.place_packed_chain_cuda(
        parrays, *bufs, spec, m, explain, clusters=c), "chain",
        "packed chain")
    torch.cuda.synchronize()
    for c, got in outs.items():
        _same_bits(ref, got, ("packed chain", c))
        _zero_from_plain(want, got, ("packed chain", c))


@pytest.mark.cuda
def test_lane_route_past_the_layout_limit_takes_chain_cu(cuda_device,
                                                         monkeypatch):
    """Where no layout fits a block (here a block's shared memory taken
    as 4 KB, so that even C = 8 does not fit), the dispatch takes
    chain.cu's route by shape, and its outputs equal the lane route's."""
    arrays, prep, tables, dyn = _table_dispatch(cuda_device)
    args = (arrays, *tables, prep.rows, *dyn, prep.sspec, prep.dspec,
            prep.m)
    lane = kp.place_table_chain(*args, explain=True)
    assert kp.last_chain_dispatch_route()[0] == "cluster"
    monkeypatch.setattr(kp, "BLOCK_SMEM", 4096)
    before = kp.chain_route_counts()
    old = kp.place_table_chain(*args, explain=True)
    assert kp.last_chain_dispatch_route() == ("lanes", None)
    assert kp.chain_route_counts()["lanes"] == before["lanes"] + 1
    torch.cuda.synchronize()
    for part in range(2):
        _same_bits(old[part], lane[part], ("past the limit", part))


@pytest.mark.cuda
def test_lane_route_counts_stale_footprint_collisions_like_plain(
        cuda_device):
    """Two unpinned lanes of the same two programs (a stale footprint):
    the same rows change in both, and the lane route's collision count
    and fold equal plain's, at every size."""
    from nomad_tpu_torch.convert import tensor_from_numpy
    from nomad_tpu_torch.lib.transfer import default_ledger
    from nomad_tpu_torch.server.program_table import DeviceProgramTable

    state, _nodes = build_synthetic_state(300, 3000, seed=7)
    rng = random.Random(8)
    stack = TorchStack(state.cluster, device=cuda_device)
    progs = [stack.compile_tg(j, j.task_groups[0], 4, None)[0]
             for j in (synth_service_job(rng, count=4) for _ in range(2))]
    table = DeviceProgramTable(device=cuda_device)
    prep = table.prepare(progs + progs)
    ti, tf, tu, _nb, _count = table.commit(prep, default_ledger())
    dyn = [tensor_from_numpy(d, cuda_device).reshape(2, 2, -1)
           for d in (prep.dyn_i, prep.dyn_f, prep.dyn_u)]
    args = (stack.device_arrays(), ti, tf, tu, prep.rows.reshape(2, 2),
            *dyn, prep.sspec, prep.dspec, prep.m)
    want = kp.place_table_wave_plain(*args, explain=True)
    outs = _lane_sizes(lambda c: kp.place_table_wave_cuda(
        *args, explain=True, clusters=c), "wave", "stale wave")
    torch.cuda.synchronize()
    assert int(want[0][-1]) > 0
    for c, got in outs.items():
        for part in range(2):
            _zero_from_plain(want[part], got[part], ("stale wave", c, part))


@pytest.mark.cuda
@pytest.mark.parametrize("widths", [(37, 64, 13), (64, 64, 64), (5, 3, 1),
                                    (96, 40, 37)],
                         ids=lambda w: "i{}-f{}-u{}".format(*w))
def test_table_insert_matches_index_copy(widths, cuda_device):
    """K8, the fused insert: new i32/f32/u8 tables in one launch, bitwise
    equal to its plain version (`torch.index_copy` out of place) on the
    same packed buffer, the staged rows where idx names them, the old
    tables unwritten; u8 rows of widths no multiple of 4 or 16 too."""
    import numpy as np

    from nomad_tpu_torch.kernels import rows as kr

    li, lf, lu = widths
    rng = np.random.default_rng(sum(widths))
    t, k = 512, 8
    old = (rng.integers(-2 ** 31, 2 ** 31 - 1, (t, li), dtype=np.int32),
           rng.standard_normal((t, lf)).astype(np.float32),
           rng.integers(0, 256, (t, lu), dtype=np.uint8))
    idx = np.sort(rng.choice(t, k, replace=False)).astype(np.int32)
    rows = (rng.integers(-2 ** 31, 2 ** 31 - 1, (k, li), dtype=np.int32),
            rng.standard_normal((k, lf)).astype(np.float32),
            rng.integers(0, 256, (k, lu), dtype=np.uint8))
    tables = tuple(torch.from_numpy(a).to(cuda_device) for a in old)
    packed = kr.pack_insert(idx, *rows, cuda_device)
    before = kr.launch_count()
    got = kr.table_insert(tables, packed)
    assert kr.launch_count() == before + 1
    want = kr.table_insert_plain(tuple(torch.from_numpy(a) for a in old),
                                 kr.pack_insert(idx, *rows))
    torch.cuda.synchronize()
    for g, w, r in zip(got, want, rows):
        assert torch.equal(g.cpu(), w)
        assert np.array_equal(g.cpu().numpy()[idx], r)
    for a, t_ in zip(old, tables):
        assert np.array_equal(t_.cpu().numpy(), a)


_N_CAP, _R, _W = 16384, 8, 2048


@pytest.mark.cuda
@pytest.mark.parametrize("k", [0, 1, _N_CAP // 4], ids=["empty", "one",
                                                        "quarter"])
def test_view_delta_kernels_match_index_copy(k, cuda_device):
    """K7, the fused refresh, at the view's full shape (N = 16384, R = 8,
    W = 2048 words): k hot rows, min(k, 64) whole port rows and k port
    words on other rows in one packed buffer and one launch, bitwise equal
    to the plain version on the CPU and on the card (the same staged
    buffer): an empty delta, one row and the n_cap // 4 rows past which
    the view uploads whole."""
    import numpy as np

    from nomad_tpu_torch.kernels import rows as kr

    rng = np.random.default_rng(11 + k)
    view = (rng.standard_normal((_N_CAP, _R)).astype(np.float32) * 1000,
            rng.random(_N_CAP) < 0.5,
            rng.standard_normal(_N_CAP).astype(np.float32) * 100,
            rng.integers(-2 ** 31, 2 ** 31 - 1, (_N_CAP, _W),
                         dtype=np.int32))
    rows = rng.permutation(_N_CAP).astype(np.int32)
    n_prow = min(k, 64)
    delta = kr.ViewDelta()
    if k:
        hot = np.sort(rng.choice(_N_CAP, k, replace=False)).astype(np.int32)
        delta.add_hot(hot, rng.standard_normal((k, _R)).astype(np.float32),
                      rng.random(k) < 0.5,
                      rng.standard_normal(k).astype(np.float32))
        delta.add_port_rows(np.sort(rows[:n_prow]), rng.integers(
            -2 ** 31, 2 ** 31 - 1, (n_prow, _W), dtype=np.int32))
        delta.add_port_words(rows[n_prow:n_prow + k],
                             rng.integers(0, _W, k).astype(np.int32),
                             rng.integers(-2 ** 31, 2 ** 31 - 1, k,
                                          dtype=np.int32))
    want = kr.apply_view_delta(tuple(torch.from_numpy(a.copy())
                                     for a in view), delta)
    on = tuple(torch.from_numpy(a).to(cuda_device) for a in view)
    staged = kr.pack_view_delta([delta], [on], cuda_device).to(cuda_device)
    plain = kr.view_delta_plain(tuple(t.clone() for t in on), staged)
    n0 = kr.delta_launch_counts()
    got = kr.view_delta(on, staged)
    torch.cuda.synchronize()
    assert kr.delta_launch_counts() == n0 + (1 if k else 0)
    for w, p, g in zip(want, plain, got):
        assert torch.equal(w, g.cpu()) and torch.equal(p, g)


def _server_placements(eval_batch, cuda_device):
    """Placements {(job index, alloc index): node name} of one port
    Server run on the card over a seeded 300-node feed with half the jobs
    pinned to one datacenter (so batched drains dispatch waves)."""
    from nomad_tpu_torch.server import Server, ServerConfig
    from nomad_tpu_torch.synth import synth_node

    rng = random.Random(9)
    s = Server(ServerConfig(num_schedulers=1, heartbeat_ttl=3600.0,
                            eval_batch=eval_batch), device=cuda_device)
    try:
        for i in range(300):
            s.state.upsert_node(synth_node(rng, i))
        jobs = [synth_service_job(
            rng, count=3, with_affinity=i % 2 == 0, distinct_hosts=i % 3 == 0,
            datacenter=f"dc{1 + i % 3}" if i < 12 else None)
            for i in range(24)]
        evs = [s.job_register(j) for j in jobs]
        s.start()
        for ev in evs:
            got = s.wait_for_eval(ev.id, statuses=(
                "complete", "failed", "blocked", "cancelled"), timeout=120)
            assert got is not None and got.status == "complete", got
        names = {nid: nd.name for nid, nd in s.state._nodes.items()}
        return {(ji, a.name.rsplit("[", 1)[1]): names[a.node_id]
                for ji, j in enumerate(jobs)
                for a in s.state.allocs_by_job("default", j.id)}, \
            s.metrics.counters().get("wave.dispatches", 0)
    finally:
        s.shutdown()


@pytest.mark.cuda
def test_server_batched_equals_sequential_on_the_card(cuda_device,
                                                      monkeypatch):
    """The server path on the card: eval_batch=1 runs each select alone
    (K1), eval_batch=8 fuses them into chains and waves (K4, K5, with
    table inserts through K8). Both place every alloc on the same node."""
    monkeypatch.delenv("NOMAD_TPU_EVAL_BATCH", raising=False)
    before = (kp.chain_launch_count(), kp.wave_launch_count())
    seq, _w = _server_placements(1, cuda_device)
    bat, waves = _server_placements(8, cuda_device)
    assert len(seq) == 72 and seq == bat
    assert kp.chain_launch_count() > before[0] or waves > 0
    assert kp.wave_launch_count() > before[1] and waves > 0


def _system_programs(stack, nodes, state):
    """A system job's program, and one with plan deltas (stopped filler
    allocs) and a reserved plus a dynamic port ask with released and
    consumed ports."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import NetworkResource, Port
    from nomad_tpu_torch.synth import synth_system_job

    rng = random.Random(6)
    job = synth_system_job(rng)
    tg = job.task_groups[0]
    yield stack.compile_tg(job, tg, len(nodes))[0]
    tg.tasks[0].resources.networks = [NetworkResource(
        mbits=1, reserved_ports=[Port("http", 8080)],
        dynamic_ports=[Port("rpc", 0)])]
    holder = list(state._allocs.values())[:6]
    for k, a in enumerate(holder):
        a.allocated_resources.tasks["web"].networks = [NetworkResource(
            ip=nodes[k].node_resources.networks[0].ip, mbits=1,
            reserved_ports=[Port("http", 8080)],
            dynamic_ports=[Port("rpc", 20000 + k)])]
    plan = PlanContext(stopped_allocs=holder)
    for node in nodes[10:13]:
        pa = mock.alloc(job=job, node_id=node.id, task_group=tg.name)
        pa.allocated_resources = mock.alloc_resources(networks=[
            NetworkResource(ip=node.node_resources.networks[0].ip, mbits=1,
                            reserved_ports=[Port("http", 8080)],
                            dynamic_ports=[Port("rpc", 20003)])])
        plan.placed.append((node.id, tg.name, stack.cluster.usage_row(pa)))
        plan.placed_allocs.append(pa)
    yield stack.compile_tg(job, tg, len(nodes), plan)[0]


@pytest.mark.cuda
def test_system_kernel_matches_plain(cuda_device):
    """K2 against its plain version on the card: both masks equal."""
    state, nodes = build_synthetic_state(2000, 20000, seed=3)
    stack = TorchStack(state.cluster, device=cuda_device)
    before = kp.system_launch_count()
    for params in _system_programs(stack, nodes, state):
        arrays = stack.device_arrays()
        p = params_from_numpy(params, cuda_device)
        got = kp.system_feasibility(arrays, p)
        want = kp.system_feasibility_plain(arrays, p)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.dtype == torch.bool and torch.equal(g.cpu(), w.cpu())
        assert 0 < int(got[1].sum()) < int(got[0].sum())
    assert kp.system_launch_count() == before + 2


@pytest.mark.cuda
def test_system_kernel_from_numpy_equals_tensors_and_the_old_pass(
        cuda_device):
    """K2 fed the numpy program (`compile_tg`'s, packed into the one
    staged copy with the argument block) equals K2 fed tensors on the
    card, the old pass (`system_pass_cuda`) and plain, bit for bit; one
    launch a call either way."""
    state, nodes = build_synthetic_state(2000, 20000, seed=3)
    stack = TorchStack(state.cluster, device=cuda_device)
    for params in _system_programs(stack, nodes, state):
        arrays = stack.device_arrays()
        p = params_from_numpy(params, cuda_device)
        before = kp.system_launch_count()
        from_np = kp.system_feasibility(arrays, params)
        from_t = kp.system_feasibility(arrays, p)
        assert kp.system_launch_count() == before + 2
        old = kp.system_pass_cuda(arrays, p)
        want = kp.system_feasibility_plain(arrays, p)
        torch.cuda.synchronize()
        assert from_np.shape == (2, arrays.capacity.shape[0])
        for got in (from_np, from_t, old):
            assert got.dtype == torch.bool
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w.cpu())
        assert 0 < int(from_np[1].sum()) < int(from_np[0].sum())


@pytest.mark.cuda
def test_preempt_kernel_matches_plain(cuda_device):
    """K3 against its plain version on the card: a candidate table built
    by the retry's own host code for a priority-100 ask of a whole large
    node, and one of all-equal priorities over identical rows (bitwise
    ties: the lowest row wins)."""
    import numpy as np

    from nomad_tpu_torch.convert import candidates_from_numpy
    from nomad_tpu_torch.kernels import preemption as kpre
    from nomad_tpu_torch.scheduler.preemption import (candidate_table,
                                                      ranked_cluster)
    from nomad_tpu_torch.structs import Plan

    state, nodes = build_synthetic_state(2000, 20000, seed=4)
    job = synth_service_job(random.Random(7), count=1)
    job.priority = 100
    res = job.task_groups[0].tasks[0].resources
    res.cpu, res.memory_mb = 15800, 32000
    stack = TorchStack(state.cluster, device="cpu")
    params, _m = stack.compile_tg(job, job.task_groups[0], 1)
    prio, usage = kpre.dense_candidates(candidate_table(state, state.cluster,
                                                        job, Plan()))
    arrays = ranked_cluster(state.cluster, cuda_device)
    n, a = prio.shape
    gen = np.random.default_rng(8)
    tie_prio = np.full_like(prio, 50.0)
    tie_prio[:, a // 2:] = kpre.INF_PRIO
    tie_usage = np.broadcast_to(gen.integers(0, 900, size=(1, a, usage.shape[
        2])).astype(np.float32), usage.shape).copy()
    big = int(arrays.capacity[:, 0].argmax())   # a large node's row
    ties = arrays._replace(**{f: getattr(arrays, f)[big:big + 1].expand_as(
        getattr(arrays, f)).contiguous() for f in ("used", "capacity")})
    before = kpre.launch_count()
    for cl, tables in ((arrays, (prio, usage)), (ties, (tie_prio,
                                                        tie_usage))):
        cand = candidates_from_numpy(*tables, cuda_device)
        p = params_from_numpy(params, cuda_device)
        got = kpre.preempt_rank(cl, p, cand)
        want = kpre.preempt_rank_plain(cl, p, cand)
        torch.cuda.synchronize()
        for f in ("best_row", "best_k", "order", "feasible"):
            assert torch.equal(getattr(got, f).cpu(),
                               getattr(want, f).cpu().to(
                                   getattr(got, f).dtype)), f
        for f in ("scores", "best_score"):
            torch.testing.assert_close(getattr(got, f).cpu(),
                                       getattr(want, f).cpu(), rtol=0,
                                       atol=ATOL, msg=f)
        assert int(got.best_row) >= 0 and int(got.best_k) >= 1
    assert kpre.launch_count() == before + 2


def _k3_tables(state, cuda_device):
    """The K3 card cases: (label, cluster tensors, numpy program, dense
    prio, dense usage). Phase 8 (b)'s two tables (the retry's own from a
    priority-100 ask of a whole large node, and all-equal priorities with
    pads), pads between slots with half the rows holding no victim, A = 1,
    identical rows of all-equal priorities (bitwise ties: the lowest row
    wins), and on a small cluster A = 2048 (one row a block, past the
    default 48 KB) and A = 8192 (a row past shared memory: off chip)."""
    import numpy as np

    from nomad_tpu_torch.kernels import preemption as kpre
    from nomad_tpu_torch.scheduler.preemption import (candidate_table,
                                                      ranked_cluster)
    from nomad_tpu_torch.structs import Plan

    job = synth_service_job(random.Random(7), count=1)
    job.priority = 100
    res = job.task_groups[0].tasks[0].resources
    res.cpu, res.memory_mb = 15800, 32000
    params, _m = TorchStack(state.cluster, device="cpu").compile_tg(
        job, job.task_groups[0], 1)
    prio, usage = kpre.dense_candidates(candidate_table(
        state, state.cluster, job, Plan()))
    arrays = ranked_cluster(state.cluster, cuda_device)
    n, a = prio.shape
    r = usage.shape[2]
    gen = np.random.default_rng(8)
    equal = np.where(prio < kpre.INF_PRIO, 50.0, kpre.INF_PRIO).astype(
        np.float32)
    equal[gen.random(prio.shape) < 0.1] = kpre.INF_PRIO
    mixed = gen.choice([10.0, 20.0, 30.0, 50.0], size=(n, a)).astype(
        np.float32)
    mixed[gen.random((n, a)) < 0.25] = kpre.INF_PRIO
    mixed[gen.random(n) < 0.5] = kpre.INF_PRIO
    mixed_u = np.zeros((n, a, r), np.float32)
    mixed_u[:, :, 0] = gen.integers(0, 4000, size=(n, a))
    mixed_u[:, :, 1] = gen.integers(0, 8000, size=(n, a))
    tie_prio = np.full_like(prio, 50.0)
    tie_prio[:, a // 2:] = kpre.INF_PRIO
    tie_usage = np.broadcast_to(gen.integers(0, 900, size=(1, a, r)).astype(
        np.float32), usage.shape).copy()
    big = int(arrays.capacity[:, 0].argmax())   # a large node's row
    ties = arrays._replace(**{f: getattr(arrays, f)[big:big + 1].expand_as(
        getattr(arrays, f)).contiguous() for f in ("used", "capacity")})
    cases = [("retry table", arrays, params, prio, usage),
             ("equal priorities + pads", arrays, params, equal, usage),
             ("pads between slots, empty rows", arrays, params, mixed,
              mixed_u),
             ("A = 1", arrays, params, mixed[:, :1].copy(),
              mixed_u[:, :1].copy()),
             ("bitwise ties", ties, params, tie_prio, tie_usage)]
    small, _nodes = build_synthetic_state(100, 1000, seed=9)
    s_params, _m = TorchStack(small.cluster, device="cpu").compile_tg(
        job, job.task_groups[0], 1)
    s_arrays = ranked_cluster(small.cluster, cuda_device)
    # cpu and memory full: a row fits once its victims release the ask,
    # about a quarter of the way along the row
    s_arrays = s_arrays._replace(used=torch.cat(
        [s_arrays.capacity[:, :2], s_arrays.used[:, 2:]], 1))
    sn = s_arrays.capacity.shape[0]
    for wide in (2048, 8192):
        pr = gen.choice([10.0, 20.0, 50.0], size=(sn, wide)).astype(
            np.float32)
        pr[gen.random((sn, wide)) < 0.5] = kpre.INF_PRIO
        us = np.zeros((sn, wide, r), np.float32)
        for d, ask in enumerate((res.cpu, res.memory_mb)):
            us[:, :, d] = gen.integers(0, 2 * ask // (wide // 8),
                                       size=(sn, wide))
        cases.append((f"A = {wide}", s_arrays, s_params, pr, us))
    return cases


@pytest.mark.cuda
def test_preempt_one_launch_equals_old_route_and_plain(cuda_device):
    """K3's one-launch route — from dense tensors, from a compact table of
    tensors and from the retry's host arrays (snapshot, numpy program,
    compact table) — equals the old two-launch route bit for bit and the
    plain version (indices, order and feasible exactly, scores within
    1e-6), one kernel launch and one library call a call; a second call
    on the same inputs, which takes a fresh ticket, gives the same."""
    import numpy as np

    from nomad_tpu_torch.convert import candidates_from_numpy
    from nomad_tpu_torch.kernels import preemption as kpre

    state, _nodes = build_synthetic_state(2000, 20000, seed=4)
    routes_seen = set()
    for label, cl, params, prio, usage in _k3_tables(state, cuda_device):
        n, a = prio.shape
        p = params_from_numpy(params, cuda_device)
        cand = candidates_from_numpy(prio, usage, cuda_device)
        compact = kpre.compact_candidates(prio, usage)
        compact_t = kpre.CompactCandidates(
            *(torch.from_numpy(np.asarray(t)).to(cuda_device)
              for t in compact[:4]), compact.slots)
        host = kpre.ClusterArrays(*(None if t is None else t.cpu().numpy()
                                    for t in cl))
        lay = kpre.preempt_layout(n, a, cl.capacity.shape[1], 132)
        routes_seen.add((lay["on_chip"], lay["rows"] == 1))
        kpre.reset_launch_count()
        got = {
            "dense": kpre.preempt_rank_cuda(cl, p, cand),
            "again": kpre.preempt_rank_cuda(cl, p, cand),
            "compact": kpre.preempt_rank_cuda(cl, p, compact_t),
            "host": kpre.preempt_rank_compact(host, params, compact,
                                              device=cuda_device),
        }
        assert (kpre.launch_count(), kpre.host_calls(),
                kpre.two_pass_launch_count()) == (4, 4, 0), label
        old = kpre.preempt_rank_two_pass_cuda(cl, p, cand)
        assert kpre.two_pass_launch_count() == 2, label
        want = kpre.preempt_rank_plain(cl, p, cand)
        torch.cuda.synchronize()
        for route, g in got.items():
            for f in kpre.PreemptionResult._fields:
                x, y = getattr(g, f).cpu(), getattr(old, f).cpu()
                assert x.dtype == y.dtype and torch.equal(x, y), (
                    label, route, f)
            for f in ("best_row", "best_k", "order", "feasible"):
                assert torch.equal(getattr(g, f).cpu(), getattr(
                    want, f).cpu().to(getattr(g, f).dtype)), (label, f)
            for f in ("scores", "best_score"):
                torch.testing.assert_close(getattr(g, f).cpu(),
                                           getattr(want, f).cpu(), rtol=0,
                                           atol=ATOL, msg=(label, f))
        row, k, score = kpre.preempt_best(got["host"])
        assert (row, k, score) == (int(old.best_row), int(old.best_k),
                                   float(old.best_score)), label
        if label == "bitwise ties":
            feas = want.feasible.nonzero()
            assert feas.numel() > 1 and row == int(feas[0])
        if label in ("retry table", "bitwise ties", "A = 2048",
                     "A = 8192"):
            assert row >= 0 and k >= 1, label
    # on chip at 8 and at 1 row a block, and off chip
    assert routes_seen == {(1, False), (1, True), (0, False)}


def _batch_problem(cuda_device, n_prog=6, count=4):
    from nomad_tpu_torch.parallel.pad import stack_params

    state, _nodes = build_synthetic_state(300, 3000, seed=5)
    rng = random.Random(8)
    stack = TorchStack(state.cluster, device=cuda_device)
    progs = []
    for i in range(n_prog):
        j = synth_service_job(rng, count=count,
                              **_KINDS[sorted(_KINDS)[i % len(_KINDS)]])
        state.upsert_job(j)
        progs.append(stack.compile_tg(j, j.task_groups[0], count, None)[0])
    batched, m = stack_params(progs)
    return stack.device_arrays(), batched, m


@pytest.mark.cuda
@pytest.mark.parametrize("explain", [False, True], ids=["plain", "explain"])
def test_batch_kernel_matches_plain(explain, cuda_device):
    from nomad_tpu_torch.convert import tensor_from_numpy

    arrays, batched, m = _batch_problem(cuda_device)
    p = params_from_numpy(batched, cuda_device)
    before = kp.batch_launch_count()
    got = kp.place_task_group_batch(arrays, p, m, explain)
    assert kp.batch_launch_count() == before + 1
    want = kp.place_task_group_batch_plain(arrays, p, m, explain)
    torch.cuda.synchronize()
    _assert_same(want, got)
    ibuf, fbuf, ubuf, spec = kp.pack_params(batched)
    bufs = [tensor_from_numpy(b, cuda_device) for b in (ibuf, fbuf, ubuf)]
    sel, score = kp.place_packed_batch(arrays, *bufs, spec, m)
    torch.cuda.synchronize()
    assert torch.equal(sel, want.sel_idx)
    torch.testing.assert_close(score, want.sel_score, rtol=0, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
def test_shard_kernel_matches_plain(shape, cuda_device):
    """K9 on four shards over the visible cards (repeating when there are
    fewer) == its plain version == K6 on the whole view; the fold-in
    bitwise."""
    from nomad_tpu_torch.kernels import shard as ks
    from nomad_tpu_torch.parallel import (make_mesh, scheduler_step,
                                          shard_cluster)

    arrays, batched, m = _batch_problem(cuda_device, n_prog=8)
    count = torch.cuda.device_count()
    mesh = make_mesh(4, batch=shape[0],
                     devices=[f"cuda:{i % count}" for i in range(4)])
    sc = shard_cluster(arrays, mesh)
    before = ks.launch_count()
    new_cluster, got = scheduler_step(mesh, m)(sc, batched)
    assert ks.launch_count() == before + 1
    want, folded = ks.sharded_place_plain(sc, batched, m, fold=True)
    torch.cuda.synchronize()
    _assert_same(want, got)
    _assert_same(kp.place_task_group_batch(
        arrays, params_from_numpy(batched, cuda_device), m), got)
    for row in new_cluster.shards:
        for j, shard in enumerate(row):
            assert torch.equal(shard.used.cpu(), folded[j].cpu()), j


# ---- C1: more than 65,535 programs a dispatch --------------------------------


def _tiled_problem(cuda_device, copies=4096):
    """16 distinct programs over a 64-row view, and the same programs
    tiled `copies` times (65,536 at the default): program k is a copy of
    program k mod 16."""
    import numpy as np

    from nomad_tpu_torch.kernels.placement import TGParams
    from nomad_tpu_torch.parallel.pad import stack_params

    state, _nodes = build_synthetic_state(48, 200, seed=9)
    rng = random.Random(10)
    stack = TorchStack(state.cluster, device=cuda_device)
    progs = []
    for i in range(16):
        j = synth_service_job(rng, count=3,
                              **_KINDS[sorted(_KINDS)[i % len(_KINDS)]])
        state.upsert_job(j)
        progs.append(stack.compile_tg(j, j.task_groups[0], 3, None)[0])
    batched, m = stack_params(progs)
    tiled = TGParams(*(np.tile(np.asarray(f), (copies,) + (1,) * (
        np.asarray(f).ndim - 1)) for f in batched))
    arrays = stack.device_arrays()
    assert arrays.capacity.shape[0] == 64
    return arrays, batched, tiled, m


def _assert_tiled(want, got, fields=("sel_idx", "nodes_feasible",
                                     "nodes_fit"),
                  floats=("sel_score",)):
    """Every copy's outputs equal its original's (program k mod 16)."""
    for f in fields:
        a, b = getattr(want, f).cpu(), getattr(got, f).cpu()
        b = b.reshape((-1,) + tuple(a.shape))
        assert torch.equal(b, a.expand_as(b).to(b.dtype)), f
    for f in floats:
        a, b = getattr(want, f).cpu(), getattr(got, f).cpu()
        b = b.reshape((-1,) + tuple(a.shape))
        torch.testing.assert_close(b, a.expand_as(b), rtol=0, atol=ATOL,
                                   msg=f)


@pytest.mark.cuda
def test_batch_kernel_takes_65536_programs(cuda_device):
    """K6 at B = 65,536 (above gridDim.y's 65,535) on 64 rows: both
    routes, every copy equal to the plain result of its original; the
    packed route (C2) keeps no [B, N, R] carry."""
    from nomad_tpu_torch.convert import tensor_from_numpy

    arrays, small, tiled, m = _tiled_problem(cuda_device)
    want = kp.place_task_group_batch_plain(
        arrays, params_from_numpy(small, cuda_device), m)
    got = kp.place_task_group_batch(
        arrays, params_from_numpy(tiled, cuda_device), m)
    torch.cuda.synchronize()
    assert got.sel_idx.shape[0] == 65536
    _assert_tiled(want, got, floats=("sel_score", "new_used",
                                     "final_scores0"))
    del got
    ibuf, fbuf, ubuf, spec = kp.pack_params(tiled)
    bufs = [tensor_from_numpy(b, cuda_device) for b in (ibuf, fbuf, ubuf)]
    p = params_from_numpy(tiled, cuda_device)

    def peak_of(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    (sel, score), packed = peak_of(
        lambda: kp.place_packed_batch(arrays, *bufs, spec, m))
    _full, full = peak_of(lambda: kp.place_task_group_batch(arrays, p, m))
    # the full route's lane carries (used [B, N, R], dyn_free [B, N]) are
    # what the packed route no longer allocates
    carry = 65536 * (arrays.used.numel() + arrays.dyn_free.numel()) * 4
    assert full - packed >= carry, (full, packed, carry)
    _assert_tiled(want, kp.PlacementResult(
        sel_idx=sel, sel_score=score, new_used=None, nodes_feasible=None,
        nodes_fit=None, final_scores0=None), fields=("sel_idx",))


@pytest.mark.cuda
def test_shard_kernel_takes_65536_programs_a_batch_row(cuda_device):
    """K9 with one batch row of 65,536 programs on four shards: every copy
    equal to the plain K9 result of its original."""
    from nomad_tpu_torch.kernels import shard as ks
    from nomad_tpu_torch.parallel import make_mesh, shard_cluster

    arrays, small, tiled, m = _tiled_problem(cuda_device)
    mesh = make_mesh(4, batch=1, devices=["cuda:0"] * 4)
    sc = shard_cluster(arrays, mesh)
    want, _f = ks.sharded_place_plain(sc, small, m)
    got, _f = ks.sharded_place(sc, tiled, m)
    torch.cuda.synchronize()
    assert got.sel_idx.shape[0] == 65536
    _assert_tiled(want, got)


@pytest.mark.cuda
def test_wave_takes_65536_lanes(cuda_device):
    """C1: a wave of 65,536 one-program lanes (past gridDim.y's 65,535)
    on a 64-row view runs on the lane route, one launch and its fold's:
    bitwise chain.cu's route on the same inputs; every lane equal to the
    plain result of its original (16 distinct lanes, tiled), the folded
    carry the plain fold of the 16, and every row a lane changed counted
    as a collision (each is changed by all 4,096 copies of its lanes)."""
    import numpy as np

    from nomad_tpu_torch.convert import tensor_from_numpy
    from nomad_tpu_torch.lib.transfer import default_ledger
    from nomad_tpu_torch.server.program_table import DeviceProgramTable

    state, _nodes = build_synthetic_state(48, 200, seed=9)
    rng = random.Random(10)
    stack = TorchStack(state.cluster, device=cuda_device)
    progs = []
    for i in range(16):
        j = synth_service_job(rng, count=3,
                              **_KINDS[sorted(_KINDS)[i % len(_KINDS)]])
        state.upsert_job(j)
        progs.append(stack.compile_tg(j, j.task_groups[0], 3, None)[0])
    table = DeviceProgramTable(device=cuda_device)
    prep = table.prepare(progs)
    ti, tf, tu, _nb, _count = table.commit(prep, default_ledger())
    dyn = [tensor_from_numpy(d, cuda_device)
           for d in (prep.dyn_i, prep.dyn_f, prep.dyn_u)]
    arrays = stack.device_arrays()
    assert arrays.capacity.shape[0] == 64
    copies = 4096
    lanes = 16 * copies
    rows = np.tile(np.asarray(prep.rows).reshape(16, 1), (copies, 1))
    wdyn = [d.reshape(16, 1, -1).repeat(copies, 1, 1) for d in dyn]
    args = (arrays, ti, tf, tu, rows, *wdyn, prep.sspec, prep.dspec, prep.m)
    k0 = kp.chain_kernel_launches()["wave"]
    got = kp.place_table_wave(*args)
    assert kp.last_chain_dispatch_route()[0] == "cluster"
    assert kp.chain_kernel_launches()["wave"] == k0 + 2
    ref = kp.place_table_wave_cuda(*args, clusters=0)
    assert kp.last_chain_dispatch_route() == ("lanes", None)
    torch.cuda.synchronize()
    for part in range(2):
        _same_bits(ref[part], got[part], ("wave of 65536", part))
    small = (arrays, ti, tf, tu, np.asarray(prep.rows).reshape(16, 1),
             *[d.reshape(16, 1, -1) for d in dyn], prep.sspec, prep.dspec,
             prep.m)
    want_out, want_carry = kp.place_table_wave_plain(*small)
    out, carry = got
    assert out[0].shape[0] == lanes
    for i, (w, g) in enumerate(zip(want_out[:-1], out[:-1])):
        w, g = w.cpu(), g.cpu()
        g = g.reshape((copies,) + tuple(w.shape))
        assert torch.equal(g, w.expand_as(g).to(g.dtype)), ("lane", i)
    _zero_from_plain(want_carry, carry, "wave of 65536 fold")
    changed = ((want_carry[0] != arrays.used).any(dim=1)
               | (want_carry[1] != arrays.dyn_free))
    assert int(changed.sum()) > 0
    assert int(out[-1]) == int(changed.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (1, 8)],
                         ids=["1x4", "2x2", "1x8"])
def test_shard_step_cluster_equals_steps_bitwise(shape, cuda_device):
    """K9 on shards of one card: the cluster route (the lane kernel, one
    launch a dispatch, and the fold's; three host calls) bit for bit the
    steps route forced on the same shards — sel_idx, sel_score,
    nodes_feasible, nodes_fit, final_scores0, new_used and the folded
    view — and 0.0 from plain; the entry point takes the cluster route."""
    from nomad_tpu_torch.kernels import shard as ks
    from nomad_tpu_torch.parallel import scheduler_step, shard_cluster

    arrays, batched, m = _batch_problem(cuda_device, n_prog=8)
    mesh = _card_mesh(shape, one_card=True)
    sc = shard_cluster(arrays, mesh)
    k0, n0 = ks.step_kernel_launches(), ks.launch_count()
    got, got_f = ks.sharded_place_cuda(sc, batched, m, fold=True)
    assert ks.last_step_route() == "cluster"
    assert ks.step_kernel_launches() == k0 + 2
    assert ks.launch_count() == n0 + 1
    assert ks.host_calls() <= 5
    want, want_f = ks.sharded_place_cuda(sc, batched, m, fold=True,
                                         route="steps")
    assert ks.last_step_route() == "steps"
    torch.cuda.synchronize()
    _assert_bitwise(want, got, f"K9 {shape}")
    for j, (a, b) in enumerate(zip(want_f, got_f)):
        assert torch.equal(_bits(a), _bits(b)), (shape, "fold", j)
    plain, plain_f = ks.sharded_place_plain(sc, batched, m, fold=True)
    _single_zero(plain, got, f"K9 {shape} plain")
    for j, (a, b) in enumerate(zip(plain_f, got_f)):
        assert torch.equal(a.cpu(), b.cpu()), (shape, "plain fold", j)
    assert (got.sel_idx >= 0).any()
    new_cluster, res = scheduler_step(mesh, m)(sc, batched)
    assert ks.last_step_route() == "cluster"
    torch.cuda.synchronize()
    _assert_bitwise(got, res, f"K9 {shape} entry")
    for row in new_cluster.shards:
        for j, shard in enumerate(row):
            assert torch.equal(_bits(shard.used), _bits(got_f[j])), j


@pytest.mark.cuda
def test_shard_step_routes_take_65536_programs_bitwise(cuda_device):
    """K9 with one batch row of 65,536 programs (past gridDim.y) on four
    shards of one card: the cluster route bitwise the steps route, fold
    included, and every copy equal to the plain K9 result of its
    original."""
    from nomad_tpu_torch.kernels import shard as ks
    from nomad_tpu_torch.parallel import make_mesh, shard_cluster

    arrays, small, tiled, m = _tiled_problem(cuda_device)
    sc = shard_cluster(arrays, make_mesh(4, batch=1,
                                         devices=["cuda:0"] * 4))
    got, got_f = ks.sharded_place_cuda(sc, tiled, m, fold=True)
    assert ks.last_step_route() == "cluster"
    want, want_f = ks.sharded_place_cuda(sc, tiled, m, fold=True,
                                         route="steps")
    torch.cuda.synchronize()
    _assert_bitwise(want, got, "K9 65536")
    for j, (a, b) in enumerate(zip(want_f, got_f)):
        assert torch.equal(_bits(a), _bits(b)), ("fold", j)
    plain, _f = ks.sharded_place_plain(sc, small, m)
    _assert_tiled(plain, got, floats=("sel_score", "final_scores0",
                                      "new_used"))


# ---- C2: the packed K6 equals the full-carry route ---------------------------


@pytest.mark.cuda
def test_packed_batch_equals_the_full_carry_route_bitwise(cuda_device):
    """The pooled packed route's (sel_idx, sel_score) are bitwise those of
    `place_task_group_batch`, which keeps a carry a program."""
    from nomad_tpu_torch.convert import tensor_from_numpy

    arrays, batched, m = _batch_problem(cuda_device, n_prog=300)
    full = kp.place_task_group_batch(
        arrays, params_from_numpy(batched, cuda_device), m)
    ibuf, fbuf, ubuf, spec = kp.pack_params(batched)
    bufs = [tensor_from_numpy(b, cuda_device) for b in (ibuf, fbuf, ubuf)]
    sel, score = kp.place_packed_batch(arrays, *bufs, spec, m)
    torch.cuda.synchronize()
    assert torch.equal(sel, full.sel_idx)
    assert torch.equal(score.view(torch.int32),
                       full.sel_score.view(torch.int32))


# ---- K6's on-chip route (csrc/batch.cu) ----------------------------------------


def _onchip_problem(cuda_device, case):
    """(view, stacked numpy programs, m) of a case: bench.py's eval mix;
    identical nodes, every row tied; edge programs — plan deltas,
    penalties and preferred rows, distinct_hosts and distinct_property,
    sampled candidates, then a program no node takes and an inert pad; or
    wide tokens — a rack a node, so that the spread and distinct_property
    vocabularies pass 256 values (u16 tokens on chip)."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.parallel.pad import stack_params
    from nomad_tpu_torch.scheduler.harness import InMemState
    from nomad_tpu_torch.server.select_batch import _inert_program
    from nomad_tpu_torch.structs import Constraint
    from nomad_tpu_torch.structs.job import Spread, SpreadTarget
    from nomad_tpu_torch.synth import synth_alloc, synth_node
    from nomad_tpu_torch.tensor import ClusterTensors

    rng = random.Random(12)
    if case == "wide_tokens":
        state = InMemState()
        nodes = []
        for i in range(600):
            node = synth_node(rng, i)
            node.attributes["rack"] = f"r{i}"
            nodes.append(node)
            state.upsert_node(node)
        # racks 400-439 fuller (a bin-packer's pick); each program's own
        # allocs fill the even ones to its distinct_property limit
        filler = synth_service_job(rng)
        state.upsert_job(filler)
        for node in nodes[400:440]:
            for _ in range(3):
                state.upsert_alloc(synth_alloc(rng, node, filler))
        stack = TorchStack(state.cluster, device=cuda_device)
        progs = []
        for spread, targets, dp in ((True, False, False),
                                    (False, False, True),
                                    (True, True, True)):
            j = synth_service_job(rng, count=8, distinct_property=dp)
            if spread:
                j.spreads = [Spread(
                    attribute="${attr.rack}", weight=100,
                    spread_target=[SpreadTarget(value="r300", percent=60),
                                   SpreadTarget(value="r7", percent=20)]
                    if targets else [])]
            state.upsert_job(j)
            for node in nodes[400:440:2]:
                for _ in range(2):
                    state.upsert_alloc(synth_alloc(rng, node, j))
            progs.append(stack.compile_tg(j, j.task_groups[0], 8)[0])
        batched, m = stack_params(progs)
        return stack.device_arrays(), batched, m
    if case == "ties":
        cl = ClusterTensors()
        for i in range(40):
            node = mock.node()
            node.id = f"node-{i}"
            cl.upsert_node(node)
        job = mock.job()
        job.task_groups[0].networks = []
        stack = TorchStack(cl, device=cuda_device)
        progs = [stack.compile_tg(job, job.task_groups[0], k)[0]
                 for k in (1, 4, 8)]
        batched, m = stack_params(progs)
        return stack.device_arrays(), batched, m
    state, nodes = build_synthetic_state(300, 3000, seed=13)
    stack = TorchStack(state.cluster, device=cuda_device)
    progs = []
    if case == "bench_mix":
        for i in range(200):
            j = synth_service_job(
                rng, count=8, with_affinity=(i % 2 == 0),
                with_spread=(i % 3 == 0), distinct_hosts=(i % 5 == 0),
                with_devices=(i % 4 == 0), distinct_property=(i % 7 == 0))
            state.upsert_job(j)
            progs.append(stack.compile_tg(j, j.task_groups[0], 8)[0])
    else:
        filler = list(state._allocs.values())[:6]
        plan = PlanContext(
            stopped_allocs=filler,
            penalty_node_ids=[frozenset({nodes[i].id, nodes[i + 1].id})
                              for i in range(0, 8, 2)],
            preferred_node_ids=[nodes[5].id, None, nodes[11].id])
        for i, kw in enumerate((dict(), dict(with_spread=True),
                                dict(distinct_hosts=True),
                                dict(distinct_property=True))):
            j = synth_service_job(rng, count=6, **kw)
            state.upsert_job(j)
            progs.append(stack.compile_tg(j, j.task_groups[0], 6,
                                          plan if i < 2 else None)[0])
        j = synth_service_job(rng, count=6, with_affinity=True)
        state.upsert_job(j)
        progs.append(stack.compile_tg(j, j.task_groups[0], 6, sampled_rows=
                                      list(range(0, 300, 7)))[0])
        j = synth_service_job(rng, count=6)
        j.constraints.append(Constraint("${attr.kernel.name}", "windows",
                                        "="))
        progs.append(stack.compile_tg(j, j.task_groups[0], 6)[0])
        progs.append(_inert_program(progs[0]))
    batched, m = stack_params(progs)
    return stack.device_arrays(), batched, m


def _packed(batched, cuda_device):
    from nomad_tpu_torch.convert import tensor_from_numpy

    ibuf, fbuf, ubuf, spec = kp.pack_params(batched)
    return [tensor_from_numpy(b, cuda_device) for b in (ibuf, fbuf, ubuf)], \
        spec


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bench_mix", "ties", "edges",
                                  "wide_tokens"])
def test_onchip_batch_equals_pooled_and_full_carry_bitwise(case,
                                                           cuda_device):
    """`place_packed_batch` takes the on-chip route at these shapes, one
    launch a dispatch; its sel_idx and sel_score are bitwise those of the
    pooled route and of the full-carry route, which equal plain."""
    arrays, batched, m = _onchip_problem(cuda_device, case)
    bufs, spec = _packed(batched, cuda_device)
    if case == "wide_tokens":
        shapes = {name: tuple(shape[1:]) for name, _c, _o, shape in spec}
        dims = kp._program_dims(shapes, m, False, arrays.capacity.shape[0])
        assert min(dims["sv"], dims["dv"]) > 256, dims
    before = (kp.onchip_launch_count(), kp.batch_launch_count())
    sel, score = kp.place_packed_batch(arrays, *bufs, spec, m)
    assert kp.last_batch_route()[0] == "onchip"
    assert (kp.onchip_launch_count(), kp.batch_launch_count()) == (
        before[0] + 1, before[1])
    pooled = kp._packed_batch_on("pooled", arrays, *bufs, spec, m)
    p = params_from_numpy(batched, cuda_device)
    full = kp.place_task_group_batch(arrays, p, m)
    torch.cuda.synchronize()
    for what, (s2, sc2) in (("pooled", pooled),
                            ("full-carry", (full.sel_idx, full.sel_score))):
        assert torch.equal(sel, s2), what
        assert torch.equal(score.view(torch.int32), sc2.view(torch.int32)), \
            what
    want = kp.place_task_group_batch_plain(arrays, p, m)
    assert torch.equal(sel, want.sel_idx)
    torch.testing.assert_close(score, want.sel_score, rtol=0, atol=ATOL)
    assert bool((sel >= 0).any())
    if case == "ties":
        assert int(sel[0, 0]) == 0, "a tie goes to the lowest row"
    if case == "edges":
        assert bool((sel[-2:] == -1).all()), "infeasible or inert placed"
    if case == "wide_tokens":
        assert bool((sel > 255).all()), "every pick on a token past u8"


@pytest.mark.cuda
def test_oversized_view_takes_the_pooled_route(cuda_device):
    """Past the on-chip limit (a view padded to 65,536 rows, the pad rows
    not ok) the packed dispatch takes the pooled route; it equals plain,
    and bitwise the on-chip route on the unpadded view."""
    arrays, batched, m = _onchip_problem(cuda_device, "edges")
    bufs, spec = _packed(batched, cuda_device)
    small = kp.place_packed_batch(arrays, *bufs, spec, m)
    n0 = arrays.capacity.shape[0]
    view = kp.ClusterArrays(*(torch.cat((t, t[-1:].expand(
        (65536 - n0,) + tuple(t.shape[1:])))) for t in arrays))
    view.node_ok[n0:] = False
    before = (kp.onchip_launch_count(), kp.batch_launch_count())
    sel, score = kp.place_packed_batch(view, *bufs, spec, m)
    assert kp.last_batch_route()[0] == "pooled"
    assert (kp.onchip_launch_count(), kp.batch_launch_count()) == (
        before[0], before[1] + 1)
    want_sel, want_score = kp.place_packed_batch_plain(view, *bufs, spec, m)
    torch.cuda.synchronize()
    assert torch.equal(sel, want_sel)
    torch.testing.assert_close(score, want_score, rtol=0, atol=ATOL)
    assert torch.equal(sel, small[0])
    assert torch.equal(score.view(torch.int32), small[1].view(torch.int32))


@pytest.mark.cuda
def test_cpu_tensors_never_launch_the_onchip_kernel_on_a_card(cuda_device):
    arrays, batched, m = _onchip_problem(cuda_device, "ties")
    cpu = kp.ClusterArrays(*(t.cpu() for t in arrays))
    bufs, spec = _packed(batched, torch.device("cpu"))
    before = (kp.onchip_launch_count(), kp.batch_launch_count())
    sel, _score = kp.place_packed_batch(cpu, *bufs, spec, m)
    assert sel.device.type == "cpu"
    assert (kp.onchip_launch_count(), kp.batch_launch_count()) == before


@pytest.mark.cuda
@pytest.mark.parametrize("n,sv,dv,s,p", [(64, 32, 32, 1, 1),
                                          (16384, 32, 32, 1, 1),
                                          (30000, 300, 32, 2, 1),
                                          (1000, 32, 70000, 1, 2)])
def test_onchip_layout_matches_the_library(n, sv, dv, s, p, cuda_device):
    """The library's shared-memory reckoning (`nomad_batch_onchip_smem`)
    is `onchip_layout`'s total, u8 and u16 tokens alike."""
    lib = kp._ONCHIP.lib()
    dims = dict(m=8, pn=3, s=s, sv=sv, p=p, dv=dv)
    a = kp._PlaceArgs()
    a.n = n
    for k, v in dims.items():
        setattr(a, k, v)
    assert lib.nomad_batch_onchip_smem(kp.ctypes.byref(a)) == \
        kp.onchip_layout(n, dims)["total"]


# ---- the sharded routes (B10-B13) on four shards of the card ------------------


def _card_mesh(shape, one_card=False):
    """A mesh of shape[0] x shape[1] shards over the cards (repeating a
    card when there are fewer), or all on cuda:0 with `one_card`."""
    from nomad_tpu_torch.parallel import make_mesh

    n = shape[0] * shape[1]
    count = 1 if one_card else torch.cuda.device_count()
    return make_mesh(n, batch=shape[0],
                     devices=[f"cuda:{i % count}" for i in range(n)])


def _route_launches(ks, sc, n_prog, m):
    """Launches of one chain dispatch of `n_prog` programs on `sc`: two on
    the cluster route (the static pass of every shard, the cluster); on
    the steps route a static launch a node shard, then per program M
    steps of a launch a shard and a combine, and the last apply a
    shard."""
    s = len(sc.row0)
    if ks.chain_route(sc.devices[0]) == "cluster":
        return 2
    return s + n_prog * (m * (s + 1) + s)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
@pytest.mark.parametrize("explain", [False, True], ids=["plain", "explain"])
def test_sharded_chain_matches_plain_and_k4(shape, explain, cuda_device):
    """B10: the packed chain on a sharded view == its plain version == the
    unsharded chain (K4); the chain's carries equal the plain ones."""
    from nomad_tpu_torch.convert import tensor_from_numpy
    from nomad_tpu_torch.kernels import shard as ks
    from nomad_tpu_torch.parallel import shard_cluster

    arrays, batched, m = _batch_problem(cuda_device, n_prog=6)
    sc = shard_cluster(arrays, _card_mesh(shape))
    ibuf, fbuf, ubuf, spec = kp.pack_params(batched)
    bufs = [tensor_from_numpy(b, cuda_device) for b in (ibuf, fbuf, ubuf)]
    before = ks.route_launch_counts()["chain"]
    got = kp.place_packed_chain(sc, *bufs, spec, m, explain=explain)
    n_prog = int(batched.n_place.shape[0])
    assert ks.route_launch_counts()["chain"] == before + _route_launches(
        ks, sc, n_prog, m)
    if torch.cuda.device_count() == 1:
        # every shard on the one card: one static and one cluster launch
        assert ks.last_chain_route() == "cluster"
        assert ks.host_calls() == 2
    want = kp._flat_outputs(ks.sharded_chain_plain(
        sc, kp._unpack_params(*bufs, spec), m, explain)[0], explain)
    k4 = kp.place_packed_chain(arrays, *bufs, spec, m, explain=explain)
    torch.cuda.synchronize()
    _assert_flat(want, got, explain)
    _assert_flat(k4, got, explain)
    stacked = params_from_numpy(batched, cuda_device)
    r, carry = ks.sharded_chain_cuda(sc, stacked, m)
    r_plain, carry_plain = ks.sharded_chain_plain(sc, stacked, m)
    torch.cuda.synchronize()
    _assert_same(r_plain, r)
    for (u, d), (pu, pd) in zip(carry, carry_plain):
        assert torch.equal(u.cpu(), pu.cpu()) and torch.equal(d.cpu(),
                                                              pd.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
def test_sharded_single_matches_plain_and_k1(shape, cuda_device):
    """B11: place_task_group with explain on a sharded view == its plain
    version == K1 on the whole view."""
    from nomad_tpu_torch.kernels import shard as ks
    from nomad_tpu_torch.parallel import shard_cluster

    arrays, batched, m = _batch_problem(cuda_device, n_prog=4)
    sc = shard_cluster(arrays, _card_mesh(shape))
    stacked = params_from_numpy(batched, cuda_device)
    for b in range(4):
        p = kp._program(stacked, b)
        before = ks.route_launch_counts()["single"]
        got = kp.place_task_group(sc, p, m, explain=True)
        assert ks.route_launch_counts()["single"] == before + \
            _route_launches(ks, sc, 1, m)
        if torch.cuda.device_count() == 1:
            assert ks.last_chain_route() == "cluster"
            assert ks.host_calls() == 2
        want = kp.place_task_group(arrays, p, m, explain=True)
        plain = ks.sharded_task_group_plain(sc, p, m, explain=True)
        torch.cuda.synchronize()
        _assert_same(want, got)
        _assert_same(plain, got)


def _bits(t):
    t = t.detach().cpu().contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_bitwise(want, got, what):
    """Every leaf of two PlacementResults (explain too) bit for bit."""
    for f in ("sel_idx", "sel_score", "nodes_feasible", "nodes_fit",
              "new_used", "final_scores0"):
        a, b = getattr(want, f), getattr(got, f)
        assert a.shape == b.shape and torch.equal(_bits(a), _bits(b)), \
            (what, f)
    assert (want.explain is None) == (got.explain is None), what
    if want.explain is not None:
        for f in kp.PlacementExplain._fields:
            a, b = getattr(want.explain, f), getattr(got.explain, f)
            assert a.shape == b.shape and torch.equal(_bits(a), _bits(b)), \
                (what, f)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (1, 8)],
                         ids=["1x4", "2x2", "1x8"])
@pytest.mark.parametrize("explain", [False, True], ids=["plain", "explain"])
def test_sharded_chain_cluster_equals_steps_bitwise(shape, explain,
                                                    cuda_device):
    """B10 and B11 on shards of one card: the cluster route (two
    launches) equals the steps route, called directly on the same shards,
    bit for bit — outputs, snapshots, explain leaves and the shards'
    final (used, dyn_free) carries."""
    from nomad_tpu_torch.kernels import shard as ks
    from nomad_tpu_torch.parallel import shard_cluster

    arrays, batched, m = _batch_problem(cuda_device, n_prog=6)
    sc = shard_cluster(arrays, _card_mesh(shape, one_card=True))
    assert ks.chain_route(sc.devices[0]) == "cluster"
    stacked = params_from_numpy(batched, cuda_device)
    for what, batch in (("chain", stacked),
                        ("single", kp.TGParams(*(t[2:3] for t in stacked)))):
        before = ks.route_launch_counts()[what]
        got, carry = ks.sharded_chain_cuda(sc, batch, m, explain,
                                           route=what)
        assert ks.last_chain_route() == "cluster" and ks.host_calls() == 2
        assert ks.route_launch_counts()[what] == before + 2
        want, carry_w = ks._chain_steps(sc, batch, m, explain, route=what)
        assert ks.last_chain_route() == "steps"
        torch.cuda.synchronize()
        _assert_bitwise(want, got, f"{shape} {what}")
        for (u, d), (wu, wd) in zip(carry, carry_w):
            assert torch.equal(_bits(u), _bits(wu)), (shape, what, "used")
            assert torch.equal(_bits(d), _bits(wd)), (shape, what, "dyn")
        plain, _c = ks.sharded_chain_plain(sc, batch, m, explain)
        _assert_same(plain, got)
        packed = ks.sharded_chain_cuda(sc, batch, m, explain,
                                       snapshots=False, route=what)[0]
        assert packed.new_used is None
        assert torch.equal(packed.sel_idx, got.sel_idx)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (1, 8)],
                         ids=["1x2", "1x4", "1x8"])
def test_sharded_topk_ties_and_floor_on_both_routes(shape, cuda_device):
    """Explain's top-K across shards on its hard cases, through both CUDA
    routes against plain (which the CPU tests hold against the
    reference) and bitwise against each other: 40 identical nodes (every
    score ties) with the rows below the first border masked out, so the
    top-K straddles it and keeps the lowest global rows; and a program no
    node can take (every row at the floor: global rows 0..4, zero
    parts)."""
    import numpy as np

    from nomad_tpu_torch import mock
    from nomad_tpu_torch.kernels import shard as ks
    from nomad_tpu_torch.parallel import shard_cluster
    from nomad_tpu_torch.structs import Constraint
    from nomad_tpu_torch.tensor import ClusterTensors

    cl = ClusterTensors()
    for i in range(40):
        nd = mock.node()
        nd.id = nd.name = f"node-{i:03d}"
        cl.upsert_node(nd)
    stack = TorchStack(cl, device=cuda_device)
    rng = random.Random(31)
    job = synth_service_job(rng, count=6)
    nowhere = synth_service_job(rng, count=3)
    nowhere.constraints.append(Constraint("${attr.kernel.name}", "windows",
                                          "="))
    arrays = stack.device_arrays()
    n = int(arrays.capacity.shape[0])
    sc = shard_cluster(arrays, _card_mesh(shape, one_card=True))
    border = n // shape[1]
    mask = np.ones(n, dtype=bool)
    mask[:border - 2] = False
    for j, tied in ((job, True), (nowhere, False)):
        (p,), m = pad_params([stack.compile_tg(j, j.task_groups[0],
                                               6 if tied else 3)[0]])
        if tied:
            p = p._replace(extra_mask=mask)
        p = params_from_numpy(p, cuda_device)
        batch = kp.TGParams(*(t.unsqueeze(0) for t in p))
        want = ks.sharded_chain_plain(sc, batch, m, True)[0]
        got = {fn.__name__: fn(sc, batch, m, True, route="single")[0]
               for fn in (ks._chain_cluster, ks._chain_steps)}
        torch.cuda.synchronize()
        _assert_bitwise(got["_chain_steps"], got["_chain_cluster"],
                        f"{shape} tied={tied}")
        _assert_same(want, got["_chain_cluster"])
        top = got["_chain_cluster"].explain.topk_idx[0].cpu()
        if tied:
            assert top[0].tolist() == list(range(border - 2, border + 3))
        else:
            assert (got["_chain_cluster"].sel_idx == -1).all()
            assert all(row.tolist() == [0, 1, 2, 3, 4] for row in top)
            assert not got["_chain_cluster"].explain.topk_parts.any()


@pytest.mark.cuda
def test_sharded_chain_cluster_refuses_more_than_eight_shards(cuda_device):
    """A cluster launch with a bad argument (16 shards, past the portable
    cluster size) raises RuntimeError and launches nothing; the entry
    point takes the steps route for that layout, == plain."""
    from nomad_tpu_torch.kernels import shard as ks
    from nomad_tpu_torch.parallel import shard_cluster

    arrays, batched, m = _batch_problem(cuda_device, n_prog=2)
    sc = shard_cluster(arrays, _card_mesh((1, 16), one_card=True))
    stacked = params_from_numpy(batched, cuda_device)
    before = ks.route_launch_counts()["chain"]
    with pytest.raises(RuntimeError, match="invalid argument"):
        ks._chain_cluster(sc, stacked, m)
    assert ks.route_launch_counts()["chain"] == before
    assert ks.chain_route(sc.devices[0]) == "steps"
    got = ks.sharded_chain(sc, stacked, m)
    assert ks.last_chain_route() == "steps"
    want = ks.sharded_chain_plain(sc, stacked, m)[0]
    torch.cuda.synchronize()
    _assert_same(want, got)


@pytest.mark.cuda
def test_sharded_system_matches_k2(cuda_device):
    """B12: K2 per shard, masks joined == K2 on the whole view."""
    from nomad_tpu_torch.kernels import shard as ks
    from nomad_tpu_torch.parallel import shard_cluster

    arrays, batched, _m = _batch_problem(cuda_device, n_prog=3)
    sc = shard_cluster(arrays, _card_mesh((1, 4)))
    stacked = params_from_numpy(batched, cuda_device)
    cards = len(ks.card_groups([sh.used.device for sh in sc.shards[0]]))
    for b in range(3):
        p = kp._program(stacked, b)
        before = ks.route_launch_counts()["system"]
        got = kp.system_feasibility(sc, p)
        assert ks.route_launch_counts()["system"] == before + cards  # a card
        want = kp.system_feasibility(arrays, p)
        for w, g in zip(want, got):
            assert torch.equal(w.cpu(), g.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (1, 8), (1, 64)],
                         ids=["1x4", "2x2", "1x8", "1x64"])
def test_sharded_system_cards_equal_shards_bitwise(shape, cuda_device):
    """B12's cards route (one launch a card, no rebase) against its old
    shards route (K2's old pass a shard, rebased), plain and K2 on the
    whole view, bit for bit: programs as tensors and as numpy, shards of
    the 300-node view down to 8 rows (1 x 64)."""
    from nomad_tpu_torch.kernels import shard as ks
    from nomad_tpu_torch.parallel import shard_cluster

    state, nodes = build_synthetic_state(300, 3000, seed=3)
    stack = TorchStack(state.cluster, device=cuda_device)
    for params in _system_programs(stack, nodes, state):
        arrays = stack.device_arrays()
        sc = shard_cluster(arrays, _card_mesh(shape, one_card=True))
        p = params_from_numpy(params, cuda_device)
        before = ks.route_launch_counts()["system"]
        cards = kp.system_feasibility(sc, p)
        assert ks.route_launch_counts()["system"] == before + 1
        assert ks.host_calls() == 2     # the staged copy, the launch
        from_np = kp.system_feasibility(sc, params)
        shards = kp.system_feasibility(sc, p, route="shards")
        assert ks.route_launch_counts()["system"] == before + 2 + shape[1]
        plain = ks.sharded_system_plain(sc, p)
        whole = kp.system_feasibility(arrays, p)
        torch.cuda.synchronize()
        assert cards.shape == (2, sc.n) and cards.dtype == torch.bool
        for other in (from_np, shards, plain, whole):
            assert torch.equal(cards.cpu(), other.cpu())
        assert 0 < int(cards[1].sum()) < int(cards[0].sum())


@pytest.mark.cuda
def test_sharded_view_refresh_matches_a_cold_upload(cuda_device):
    """B13: under a (2, 2) mesh of the card the view cache's K7 per shard
    keeps every copy equal to a cold upload after churn."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.kernels import rows as kr
    from nomad_tpu_torch.parallel import set_active_mesh, shard_cluster
    from nomad_tpu_torch.parallel.mesh import shard_copies
    from nomad_tpu_torch.structs import NetworkResource, Port

    state, nodes = build_synthetic_state(300, 3000, seed=12)
    mesh = _card_mesh((2, 2))
    stack = TorchStack(state.cluster, device=cuda_device)
    set_active_mesh(mesh)
    try:
        stack.device_arrays()
        before = kr.sharded_delta_launch_count()
        job = synth_service_job(random.Random(3), count=1)
        for k, node in enumerate(nodes[::17]):
            a = mock.alloc(job=job, node_id=node.id, client_status="running")
            a.allocated_resources = mock.alloc_resources(
                cpu=100, memory_mb=64, networks=[NetworkResource(
                    ip=node.node_resources.networks[0].ip, mbits=1,
                    reserved_ports=[Port("http", 9000 + k)])])
            state.upsert_alloc(a)
        sc = stack.device_arrays()
        assert kr.sharded_delta_launch_count() > before
        set_active_mesh(None)
        cold = shard_cluster(TorchStack(state.cluster,
                                        device="cpu").device_arrays(), mesh)
    finally:
        set_active_mesh(None)
    torch.cuda.synchronize()
    for key, shard in shard_copies(sc).items():
        want = shard_copies(cold)[key]
        for f in kp.ClusterArrays._fields:
            assert torch.equal(getattr(shard, f).cpu(),
                               getattr(want, f).cpu()), (key, f)
