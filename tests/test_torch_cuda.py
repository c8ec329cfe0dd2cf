"""The CUDA kernels against their plain PyTorch versions, on the card:
K1, the chain and wave (K4, K5), the batch (K6), the row kernels (K7, K8),
K2, K3, and the node-sharded step (K9) on four shards.

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
    commit runs the row-scatter kernel."""
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
    assert kr.launch_count() == before + 3
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


@pytest.mark.cuda
def test_row_scatter_matches_index_copy(cuda_device):
    from nomad_tpu_torch.kernels import rows as kr

    gen = torch.Generator().manual_seed(7)
    for dt, width in ((torch.int32, 37), (torch.float32, 64),
                      (torch.uint8, 13), (torch.uint8, 64)):
        table = torch.randint(0, 100, (40, width), generator=gen).to(dt)
        src = torch.randint(0, 100, (6, width), generator=gen).to(dt)
        idx = torch.tensor([3, 0, 39, 17, 8, 22], dtype=torch.int32)
        want = kr.row_scatter_plain(table.clone(), idx, src)
        got = kr.row_scatter(table.to(cuda_device), idx.to(cuda_device),
                             src.to(cuda_device))
        torch.cuda.synchronize()
        assert torch.equal(want, got.cpu()), (dt, width)


_N_CAP, _R, _W = 16384, 8, 2048


def _delta_idx(gen, k, n):
    """k distinct rows of n (the view cache never passes duplicates)."""
    return torch.randperm(n, generator=gen)[:k].to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [0, 1, _N_CAP // 4], ids=["empty", "one",
                                                        "quarter"])
def test_view_delta_kernels_match_index_copy(k, cuda_device):
    """K7's three parts against their plain versions at the view's full
    shape (N = 16384, R = 8, W = 2048 words), bitwise: an empty delta,
    one row and the n_cap // 4 rows past which the view uploads whole."""
    from nomad_tpu_torch.kernels import rows as kr

    gen = torch.Generator().manual_seed(11 + k)
    used = torch.rand(_N_CAP, _R, generator=gen) * 1000
    node_ok = torch.rand(_N_CAP, generator=gen) < 0.5
    dyn = torch.rand(_N_CAP, generator=gen) * 100
    idx = _delta_idx(gen, k, _N_CAP)
    uv = torch.rand(k, _R, generator=gen) * 1000
    ov = torch.rand(k, generator=gen) < 0.5
    dv = torch.rand(k, generator=gen) * 100
    want = kr.hot_rows_update_plain(used.clone(), node_ok.clone(),
                                    dyn.clone(), idx, uv, ov, dv)
    on = [t.to(cuda_device) for t in (used, node_ok, dyn, idx, uv, ov, dv)]
    n0 = kr.delta_launch_counts()["hot_rows"]
    got = kr.hot_rows_update(*on)
    torch.cuda.synchronize()
    assert kr.delta_launch_counts()["hot_rows"] == n0 + (1 if k else 0)
    for a, b in zip(want, got):
        assert torch.equal(a, b.cpu())

    ports = torch.randint(-2 ** 31, 2 ** 31 - 1, (_N_CAP, _W),
                          generator=gen, dtype=torch.int32)
    prow = _delta_idx(gen, min(k, 64), _N_CAP)
    pvals = torch.randint(-2 ** 31, 2 ** 31 - 1, (prow.shape[0], _W),
                          generator=gen, dtype=torch.int32)
    want = kr.port_rows_update_plain(ports.clone(), prow, pvals)
    got = kr.port_rows_update(ports.to(cuda_device), prow.to(cuda_device),
                              pvals.to(cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(want, got.cpu())

    wrows = _delta_idx(gen, k, _N_CAP)       # distinct (row, word) pairs
    words = torch.randint(0, _W, (k,), generator=gen, dtype=torch.int32)
    wvals = torch.randint(-2 ** 31, 2 ** 31 - 1, (k,), generator=gen,
                          dtype=torch.int32)
    want = kr.port_words_update_plain(ports.clone(), wrows, words, wvals)
    got = kr.port_words_update(ports.to(cuda_device), wrows.to(cuda_device),
                               words.to(cuda_device), wvals.to(cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(want, got.cpu())


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
    prio, usage = candidate_table(state, state.cluster, job, Plan())
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
