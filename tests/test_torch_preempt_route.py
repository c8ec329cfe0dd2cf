"""K3's one-launch route (`csrc/preempt.cu` `rank_block`), decomposed on
the CPU.

On the card the preemption retry ranks from what its host code holds:
the snapshot's four arrays, `compile_tg`'s numpy program and the compact
victim table (only the real victims, row by row: offsets, and for each
entry its slot, priority and usage row). They go to the card in one
staged copy with the argument block, the attribute columns cut to the
ones the program references; one launch ranks every row and takes the
argmax; the best row, prefix and score come back in one copy. On the CPU
`preempt_rank_compact` expands the table and runs the plain version.

Here, against the JAX package's `preempt_rank` on the dense table:

- the compact route on every case of `test_k3_plain_matches_reference`
  (5 programs × 4 tables × A ∈ {1, 8, 32, 64}): `order`, `feasible`,
  `best_row` and `best_k` exactly, scores within `ATOL`;
- the staged copy laid out in host memory as the wrapper lays it out and
  read back through the argument block's pointers (the cluster, the
  program's `PREEMPT_FIELDS` with the remapped attribute columns, the
  table, the zeroed ticket), then ranked by the plain version: the same
  result;
- `candidate_table`'s compact form, expanded, bit for bit the dense table
  the reference's retry builds;
- the port's `find_preemption_placement` and the reference's on the same
  state, job, program and plan (`torch_sched_cases.Twins`): the same
  node, victims and score within 1e-6;
- the route by shape (`preempt_layout`) and the mirrors of `PreemptRun`
  and of the fields the kernel reads against `preempt.cu`.

Nothing here needs a card.
"""
import ctypes
import random
import re
from functools import lru_cache
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomad_tpu import mock as ref_mock
from nomad_tpu.kernels.placement import ClusterArrays as RefArrays
from nomad_tpu.kernels.preemption import PreemptionCandidates as RefCand
from nomad_tpu.kernels.preemption import preempt_rank_jit
from nomad_tpu.scheduler.preemption import \
    find_preemption_placement as ref_find
from nomad_tpu.scheduler.stack import TPUStack, _to_device
from nomad_tpu.structs import Plan as RefPlan
from test_torch_preemption import (ATOL, K3_CASES, TABLES, _k3_inputs,
                                   lowprio_job, running_alloc)
from torch_chain_cases import one_torch_thread  # noqa: F401
from torch_sched_cases import Twins

from nomad_tpu_torch.convert import params_from_numpy
from nomad_tpu_torch.kernels import placement as tp
from nomad_tpu_torch.kernels import preemption as kpre
from nomad_tpu_torch.kernels.placement import ClusterArrays
from nomad_tpu_torch.scheduler import preemption as tpre
from nomad_tpu_torch.scheduler.stack import TorchStack
from nomad_tpu_torch.structs import Plan
from nomad_tpu_torch.synth import build_synthetic_state, synth_service_job

CSRC = Path(tp.__file__).parent / "csrc"
EXACT = ("best_row", "best_k", "order", "feasible")


@lru_cache(maxsize=None)
def _case(name, table, a):
    """(numpy view as ClusterArrays, numpy program, compact table, the JAX
    reference's result as numpy)."""
    arrays, params, prio, usage = _k3_inputs(name, table, a)
    ref = preempt_rank_jit(
        RefArrays(**{k: jnp.asarray(v) for k, v in arrays.items()}),
        _to_device(params),
        RefCand(prio=jnp.asarray(prio), usage=jnp.asarray(usage)))
    want = {f: np.asarray(v) for f, v in ref._asdict().items()}
    snap = ClusterArrays(**{k: arrays[k] for k in
                            ("capacity", "used", "node_ok", "attrs")},
                         ports_used=None, dyn_free=None)
    return snap, params, kpre.compact_candidates(prio, usage), want


def _assert_like(want, got, what=""):
    for f in EXACT:
        np.testing.assert_array_equal(want[f], getattr(got, f).numpy(),
                                      err_msg=f"{what} {f}")
    for f in ("scores", "best_score"):
        np.testing.assert_allclose(want[f], getattr(got, f).numpy(), rtol=0,
                                   atol=ATOL, err_msg=f"{what} {f}")


@pytest.mark.parametrize("a", [1, 8, 32, 64])
@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("name", K3_CASES)
def test_compact_route_matches_reference(name, table, a):
    """The retry's entry point on host arrays and the compact table (pads
    dropped, each entry keeping its slot) equals the JAX kernel on the
    dense table; its three scalars read back as the retry reads them."""
    snap, params, compact, want = _case(name, table, a)
    got = kpre.preempt_rank_compact(snap, params, compact, device="cpu")
    _assert_like(want, got)
    row, k, score = kpre.preempt_best(got)
    assert (row, k) == (int(want["best_row"]), int(want["best_k"]))
    assert score == pytest.approx(float(want["best_score"]), abs=ATOL)
    if name == "infeasible_constraint":
        assert row == -1 and not got.feasible.any()


# ---- the staged copy, read back through its pointers ---------------------------


def _read(addr, shape, dtype) -> np.ndarray:
    """A copy of the `shape` elements of `dtype` at host address `addr`."""
    dtype = np.dtype(dtype)
    count = int(np.prod(shape))
    raw = ctypes.string_at(int(addr), count * dtype.itemsize) if count \
        else b""
    return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()


def _stage_on_host(snap, params, compact):
    """The wrapper's staged copy laid out in host memory, then read back
    as the kernel reads it: (ClusterArrays, program fields, table, the
    argument block, the ticket)."""
    parts, finish, (n, a, r) = kpre.preempt_stage(snap, params, compact, 0)
    offs, total = tp.stage_offsets(parts)
    host = np.zeros(total + 16, dtype=np.uint8)
    base = (host.ctypes.data + 15) & ~15
    h = host[base - host.ctypes.data:]
    args, table_ptrs = finish([base + o for o in offs])
    tp.fill_stage(h, offs, [args] + parts[1:])
    blk = np.frombuffer(h[:args.nbytes].tobytes(), dtype=tp._ARGS_DTYPE)[0]
    assert int(blk["n"]) == n and int(blk["r"]) == r
    kc = int(blk["k_cols"])
    attrs_dt = np.int32 if blk["attrs_i32"] else np.int16
    cluster = ClusterArrays(
        capacity=_read(blk["capacity"], (n, r), np.float32),
        used=_read(blk["used"], (n, r), np.float32),
        node_ok=_read(blk["node_ok"], (n,), np.bool_),
        attrs=(_read(blk["attrs"], (n, kc), attrs_dt) if kc
               else np.zeros((n, 0), attrs_dt)),
        ports_used=None, dyn_free=None)
    c, v, e, j, d, p, dv = (int(blk[k]) for k in
                            ("c", "v", "e", "j", "d", "p", "dv"))
    shapes = {"ask": ((r,), np.float32), "key_idx": ((c,), np.int32),
              "lut": ((c, v), np.bool_), "extra_mask": ((e,), np.bool_),
              "distinct_hosts": ((), np.bool_), "jc_idx": ((j,), np.int32),
              "jc_val": ((j,), np.float32), "delta_idx": ((d,), np.int32),
              "delta_res": ((d, r), np.float32),
              "dp_key_idx": ((p,), np.int32),
              "dp_allowed": ((p,), np.float32),
              "dp_counts0": ((p, dv), np.float32),
              "dp_active": ((p,), np.bool_)}
    assert set(shapes) == set(tp.PREEMPT_FIELDS)
    prog = {f: _read(blk[f], *shapes[f]) for f in tp.PREEMPT_FIELDS}
    for f in tp._PlaceArgs._fields_:
        if f[0] not in tp.PREEMPT_FIELDS and f[0] not in (
                "capacity", "used", "node_ok", "attrs") and f[1] is tp._VOID:
            assert not blk[f[0]], f"{f[0]} is not null"
    offsets_p, slot_p, prio_p, usage_p = table_ptrs
    entries = int(_read(offsets_p + 4 * n, (1,), np.int32)[0])
    table = kpre.CompactCandidates(
        _read(offsets_p, (n + 1,), np.int32),
        _read(slot_p, (entries,), np.int32),
        _read(prio_p, (entries,), np.float32),
        _read(usage_p, (entries, r), np.float32), a)
    ticket = _read(base + offs[1], (4,), np.uint32)
    return cluster, prog, table, blk, ticket


@pytest.mark.parametrize("a", [1, 32])
@pytest.mark.parametrize("table", ("mixed_pads", "no_victim_rows"))
@pytest.mark.parametrize("name", K3_CASES)
def test_staged_copy_reads_back(name, table, a):
    """What the card reads from the one staged copy ranks as the JAX
    kernel ranks the original inputs: the attribute columns cut to the
    referenced ones with key_idx and dp_key_idx remapped, every pointer
    the kernel does not read null, the ticket zero."""
    snap, params, compact, want = _case(name, table, a)
    cluster, prog, back, blk, ticket = _stage_on_host(snap, params, compact)
    assert not ticket.any()
    used_cols = np.unique(np.concatenate([params.key_idx,
                                          params.dp_key_idx]))
    assert int(blk["k_cols"]) == used_cols.size
    np.testing.assert_array_equal(cluster.attrs,
                                  np.asarray(snap.attrs)[:, used_cols])
    for f, want_t in zip(back, compact):
        np.testing.assert_array_equal(np.asarray(f), np.asarray(want_t))
    p = params_from_numpy(params._replace(**prog), "cpu")
    got = kpre.preempt_rank_compact(cluster, p, back, device="cpu")
    _assert_like(want, got, "read back")


def test_cpu_tensors_are_refused_by_the_card_route():
    """The card route points at tensors on the card and stages host
    arrays: a CPU tensor is neither, and is refused."""
    snap, params, compact, _w = _case("basic_binpack", "mixed_pads", 8)
    cl = kpre._cpu_cluster(snap)
    with pytest.raises(TypeError, match="cuda:0"):
        kpre.preempt_stage(cl, params, compact, 0)
    with pytest.raises(ValueError, match="CUDA"):
        kpre.preempt_rank_cuda(cl, params_from_numpy(params, "cpu"),
                               compact)


def test_inputs_that_do_not_fit_are_refused():
    snap, params, compact, _w = _case("plan_delta_ports", "mixed_pads", 8)
    with pytest.raises(ValueError, match="slots"):
        kpre.preempt_stage(snap, params, compact._replace(slots=1), 0)
    with pytest.raises(ValueError, match="ask"):
        kpre.preempt_stage(snap, params._replace(
            ask=np.zeros(3, np.float32)), compact, 0)
    with pytest.raises(ValueError, match="extra_mask"):
        kpre.preempt_stage(snap, params._replace(
            extra_mask=np.ones(2, bool)), compact, 0)
    with pytest.raises(ValueError, match="compact table"):
        kpre.preempt_stage(snap, params, compact._replace(
            prio=compact.prio[:-1]), 0)
    with pytest.raises(ValueError, match="A ≥ 1"):
        kpre.preempt_stage(snap, params, compact._replace(slots=0), 0)


def test_no_card_raises_and_cpu_never_launches(monkeypatch):
    snap, params, compact, want = _case("basic_binpack", "equal", 8)
    before = (kpre.launch_count(), kpre.two_pass_launch_count(),
              kpre.host_calls())
    got = kpre.preempt_rank_compact(snap, params, compact, device="cpu")
    from_t = kpre.preempt_rank(kpre._cpu_cluster(snap),
                               params_from_numpy(params, "cpu"),
                               kpre.CompactCandidates(
                                   *map(torch.from_numpy, compact[:4]),
                                   compact.slots))
    for f in kpre.PreemptionResult._fields:
        assert torch.equal(getattr(got, f), getattr(from_t, f)), f
    assert (kpre.launch_count(), kpre.two_pass_launch_count(),
            kpre.host_calls()) == before
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        kpre.preempt_rank_compact(snap, params, compact)


# ---- the compact table ------------------------------------------------------------


def _dense_table(state, cluster, job, plan):
    """The reference retry's dense table build (the loop of
    `nomad_tpu/scheduler/preemption.py:386`) on the port's objects."""
    from nomad_tpu_torch.scheduler.util import proposed_allocs
    from nomad_tpu_torch.tensor.cluster import R_TOTAL
    from nomad_tpu_torch.utils import bucket

    per_row, a_max = {}, 0
    for node_id, row in cluster.row_of.items():
        cands = tpre._eligible_victims(job, proposed_allocs(state, plan,
                                                            node_id))
        if cands:
            per_row[row] = cands
            a_max = max(a_max, len(cands))
    a_cap = bucket(a_max)
    prio = np.full((cluster.n_cap, a_cap), kpre.INF_PRIO, dtype=np.float32)
    usage = np.zeros((cluster.n_cap, a_cap, R_TOTAL), dtype=np.float32)
    for row, cands in per_row.items():
        for i, a in enumerate(cands[:a_cap]):
            prio[row, i] = tpre._alloc_priority(a)
            usage[row, i] = cluster.usage_row(a)
    return prio, usage


@pytest.mark.parametrize("seed", [4, 11])
def test_candidate_table_expands_to_the_dense_table(seed):
    state, _nodes = build_synthetic_state(300, 3000, seed=seed)
    job = synth_service_job(random.Random(seed), count=1)
    job.priority = 100
    table = tpre.candidate_table(state, state.cluster, job, Plan())
    prio, usage = _dense_table(state, state.cluster, job, Plan())
    got_p, got_u = kpre.dense_candidates(table)
    assert got_p.dtype == np.float32 and got_u.dtype == np.float32
    assert got_p.tobytes() == prio.tobytes()
    assert got_u.tobytes() == usage.tobytes()
    assert table.offsets[-1] == (prio < kpre.INF_PRIO).sum() > 0
    # and back: the dense table's compact form is this one
    again = kpre.compact_candidates(prio, usage)
    for x, y in zip(again, table):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_compact_form_keeps_pads_between_slots():
    gen = np.random.default_rng(3)
    prio = gen.choice([10.0, 20.0, kpre.INF_PRIO], size=(7, 9)).astype(
        np.float32)
    usage = gen.integers(0, 9, size=(7, 9, 4)).astype(np.float32)
    usage[prio == kpre.INF_PRIO] = 0.0
    table = kpre.compact_candidates(prio, usage)
    assert table.offsets[-1] == table.slot.size == (prio != kpre.INF_PRIO
                                                    ).sum()
    back_p, back_u = kpre.dense_candidates(table)
    assert back_p.tobytes() == prio.tobytes()
    assert back_u.tobytes() == usage.tobytes()


# ---- the retry: the port's against the reference's ---------------------------------


def _retry_state(seed, preempted):
    """Twins over six nodes, each holding one to four low-priority allocs
    of seeded sizes and priorities (some within 10 of the ask's: not
    eligible), and a priority-100 job that fits nowhere without
    eviction; with `preempted`, a plan that already evicts one alloc."""
    rng = random.Random(seed)
    t = Twins()
    for _ in range(6):
        node = ref_mock.node()
        t.upsert_node(node)
        for _k in range(rng.randint(1, 4)):
            j = lowprio_job(priority=rng.choice([5, 10, 20, 40, 60, 85, 95]),
                            mk=ref_mock)
            t.upsert_job(j)
            t.upsert_alloc(running_alloc(
                j, node, cpu=rng.randint(600, 1300),
                memory_mb=rng.randint(1000, 2500), mk=ref_mock))
    job = ref_mock.job(priority=100)
    job.task_groups[0].count = 1
    res = job.task_groups[0].tasks[0].resources
    res.cpu, res.memory_mb, res.networks = 2600, 3000, []
    job.task_groups[0].networks = []
    t.upsert_job(job)
    plans = (RefPlan(), Plan())
    if preempted:
        victim = next(a for a in t.ref.state._allocs.values()
                      if a.job.priority < 90)
        plans[0].node_preemptions[victim.node_id] = [victim]
        plans[1].node_preemptions[victim.node_id] = [
            t.port.state.alloc_by_id(victim.id)]
    return t, job, plans


@pytest.mark.parametrize("preempted", [False, True],
                         ids=["fresh_plan", "plan_preempts"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_retry_twin_matches_reference(seed, preempted):
    t, job, (ref_plan, plan) = _retry_state(seed, preempted)
    pjob = t.port.state.job_by_id(job.namespace, job.id)
    ref_params, _m = TPUStack(t.ref.state.cluster).compile_tg(
        job, job.task_groups[0], 1)
    params, _m = TorchStack(t.port.state.cluster, device="cpu").compile_tg(
        pjob, pjob.task_groups[0], 1)
    want = ref_find(t.ref.state, t.ref.state.cluster, job,
                    job.task_groups[0], ref_params, ref_plan)
    got = tpre.find_preemption_placement(
        t.port.state, t.port.state.cluster, pjob, pjob.task_groups[0],
        params, plan, device="cpu")
    assert want is not None and got is not None
    assert got[0] == want[0]
    assert sorted(v.id for v in got[1]) == sorted(v.id for v in want[1])
    assert got[2] == pytest.approx(want[2], abs=ATOL)


# ---- the route by shape, and the layout against csrc/preempt.cu --------------------


@pytest.mark.parametrize("r", [2, 8, 32])
@pytest.mark.parametrize("a", [1, 8, 32, 64, 1000, 5000, 8192])
def test_layout_by_shape(a, r):
    n, sms = 16384, 132
    lay = kpre.preempt_layout(n, a, r, sms)
    words = (a * (r + 2) + 3) & ~3
    assert 1 <= lay["rows"] <= kpre.PREEMPT_ROWS
    assert lay["smem"] <= kpre.SMEM_MAX
    if lay["on_chip"]:
        assert lay["grid"] * lay["rows"] >= n
        assert lay["smem"] == kpre.HEAD_BYTES + 4 * lay["rows"] * words
        assert lay["scratch"] == 0
        # 8 rows while they fit 48 KB; one row a block above
        assert (lay["smem"] <= kpre.SMEM_DEFAULT) == (
            kpre.HEAD_BYTES + 4 * words <= kpre.SMEM_DEFAULT)
    else:
        assert kpre.HEAD_BYTES + 4 * words > kpre.SMEM_MAX
        assert lay["grid"] == sms and lay["smem"] == kpre.HEAD_BYTES
        assert lay["scratch"] == sms * kpre.PREEMPT_ROWS * words
    if (a, r) == (32, 8):
        assert (lay["rows"], lay["grid"], lay["on_chip"]) == (8, 2048, 1)


def _struct_fields(name):
    src = (CSRC / "preempt.cu").read_text()
    body = re.search(r"struct %s \{(.*?)\n\};" % name, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            names += [x.strip(" *").split()[-1] for x in decl.split(",")]
    return names


def test_mirrors_name_the_kernels_fields_in_order():
    """`_PreemptRun` lists csrc/preempt.cu's PreemptRun member for member,
    the two sizes first; the shared-memory constants agree."""
    assert [f for f, _t in kpre._PreemptRun._fields_] == _struct_fields(
        "PreemptRun")
    assert kpre._PreemptRun._fields_[:2] == [("run_size", tp._INT),
                                             ("args_size", tp._INT)]
    assert ctypes.sizeof(kpre._PreemptRun) == 8 * 4 + 11 * 8
    assert _struct_fields("PreemptBest") == ["v", "row", "k"]
    src = (CSRC / "preempt.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", src))
    assert eval(consts["SMEM_DEFAULT"]) == kpre.SMEM_DEFAULT
    assert int(consts["SMEM_MAX"]) == kpre.SMEM_MAX
    assert int(consts["RANK_THREADS"]) == 32 * kpre.PREEMPT_ROWS
    for fn in ("size_t nomad_preempt_args_size()",
               "size_t nomad_preempt_run_size()",
               "size_t nomad_preempt_head_bytes()",
               "int nomad_preempt_stage_rank(", "int nomad_preempt_rank(",
               "const char* nomad_preempt_error_string(int err)"):
        assert fn in src, fn
    # the one-launch kernel, and the old route's two
    assert re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+"
                      r"(\w+)", src) == ["rank_block", "rank_rows",
                                         "best_row"]


def test_preempt_fields_are_what_the_kernel_reads():
    """PREEMPT_FIELDS are exactly the program pointers csrc/preempt.cu
    reads, directly or through its place_core.cuh row helpers
    (`lut_row_ok`: key_idx, lut; `used0_of`: delta_idx, delta_res)."""
    src = (CSRC / "preempt.cu").read_text()
    read = set(re.findall(r"\bA\.(\w+)", src)) | {"key_idx", "lut",
                                                  "delta_idx", "delta_res"}
    program_ptrs = {f for f, t in tp._PlaceArgs._fields_
                    if t is tp._VOID and f in tp.TGParams._fields}
    assert read & program_ptrs == set(tp.PREEMPT_FIELDS)
