"""K6's on-chip route (`csrc/batch.cu`) decomposed, on the CPU.

The kernel keeps, of each program's rows, only what its steps read: the
prefix ((fit + anti) + pen) + aff of the score sum with its term count,
the fit and distinct_hosts bits, and the spread and distinct_property
tokens. A step adds the spread boost of the row's tokens from a table
built from the counts, masks by a distinct_property table, swaps in the
entries of its penalty rows recomputed with the penalty, and after a
placement recomputes the placed row from the view and the program's
placements so far. `onchip_model` below is that decomposition in torch.
It must be bitwise equal, as int32 views, to `place_task_group_batch_plain`
(which the card holds the kernel to), and equal the JAX package's
`place_task_group_batch`: indices exactly, scores within 1e-6
(values in [-2, 1]; XLA's exp2 and torch.exp2 may differ by an ulp).

Also here: the route choice by shape (`batch_route`, `onchip_layout`)
against the kernel's layout, and the on-chip route's argument blocks.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_chain_cases as cc
from torch_chain_cases import one_torch_thread  # noqa: F401
from torch_onchip_model import carry as _carry
from torch_onchip_model import spread_table as _spread_table
from torch_onchip_model import terms as _terms
from nomad_tpu import mock
from nomad_tpu.kernels import placement as jp
from nomad_tpu.parallel.mesh import stack_params
from nomad_tpu.scheduler.stack import PlanContext, TPUStack
from nomad_tpu.structs import Constraint
from nomad_tpu.synth import synth_service_job
from nomad_tpu.tensor import ClusterTensors

from nomad_tpu_torch.convert import params_from_numpy
from nomad_tpu_torch.kernels import placement as tp

NEG_INF = tp.NEG_INF


# ---- the model -----------------------------------------------------------------


def onchip_model(cluster, p, m):
    """One program through the on-chip decomposition: (sel_idx,
    sel_score), all the kernel writes. Also returns the static prefixes,
    for the cases that need to see them."""
    n = cluster.capacity.shape[0]
    st = tp._static_plain(cluster, p, False)
    no_pen = torch.zeros(n, dtype=torch.bool)
    zero = torch.zeros(n, dtype=torch.float32)
    prefix, cnt, fit_bit, dh = _terms(cluster, p, st, st["used"],
                                      st["job_cnt"], st["tg_cnt"], zero,
                                      no_pen)
    static_prefix = prefix.clone()
    stok, dtok = st["stok"], st["dtok"]
    scounts, dcounts = p.spread_counts0.clone(), p.dp_counts0.clone()
    placed, sels, scores = [], [], []
    for step in range(m):
        sptab = _spread_table(scounts, p)
        dv = dcounts.shape[1]
        dptab = (((dcounts < p.dp_allowed[:, None])
                  & (torch.arange(dv)[None, :] != dv - 1))
                 | ~p.dp_active[:, None])
        # this step's penalty rows: entries recomputed with the penalty
        saved = {}
        for row in p.penalty_idx[step].tolist():
            if row < 0 or row >= n or row in saved:
                continue
            pen = no_pen.clone()
            pen[row] = True
            pp, pc, _f, _d = _terms(cluster, p, st,
                                    *_carry(st, p, placed, n), pen)
            saved[row] = (prefix[row].clone(), cnt[row].clone())
            prefix[row], cnt[row] = pp[row], pc[row]
        ok = fit_bit & ~dh
        for q in range(dtok.shape[1]):
            ok = ok & dptab[q][dtok[:, q]]
        sp = torch.zeros(n, dtype=torch.float32)
        for s in range(stok.shape[1]):
            sp = sp + sptab[s][stok[:, s]]
        inc = sp != 0.0
        masked = torch.where(
            ok, (prefix + torch.where(inc, sp, 0.0)) / (cnt + inc.int())
            .float(), NEG_INF)
        idx = int(torch.argmax(masked))
        pref = int(p.preferred_idx[step])
        if pref >= 0 and bool(ok[pref]):
            idx = pref
        found = bool(ok[idx]) and step < int(p.n_place)
        sels.append(idx if found else -1)
        scores.append(masked[idx] if found else torch.tensor(0.0))
        for row, (pv, cv) in saved.items():
            prefix[row], cnt[row] = pv, cv
        if found:
            placed.append(idx)
            for s in range(stok.shape[1]):
                t = int(stok[idx, s])
                if t != scounts.shape[1] - 1:
                    scounts[s, t] += 1.0
            for q in range(dtok.shape[1]):
                t = int(dtok[idx, q])
                if t != dv - 1:
                    dcounts[q, t] += 1.0
            pv, cv, fv, dv_ = _terms(cluster, p, st,
                                     *_carry(st, p, placed, n), no_pen)
            prefix[idx], cnt[idx] = pv[idx], cv[idx]
            fit_bit[idx], dh[idx] = fv[idx], dv_[idx]
    return (torch.tensor(sels, dtype=torch.int32),
            torch.stack(scores).float()), static_prefix


def model_batch(cluster, batch, m):
    outs = [onchip_model(cluster, tp._program(batch, b), m)[0]
            for b in range(batch.n_place.shape[0])]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))


# ---- the cases -----------------------------------------------------------------


def _bench_mix(cl, rng, n, count, stack=None, **force):
    """`bench.py` `build`'s eval mix; `force` fixes a stanza for all."""
    stack = stack or TPUStack(cl)
    progs = []
    for i in range(n):
        kw = dict(with_affinity=(i % 2 == 0), with_spread=(i % 3 == 0),
                  distinct_hosts=(i % 5 == 0), with_devices=(i % 4 == 0),
                  distinct_property=(i % 7 == 0))
        kw.update(force)
        job = synth_service_job(rng, count=count, **kw)
        progs.append(stack.compile_tg(job, job.task_groups[0], count)[0])
    return stack, progs


def _tied_cluster(n):
    """n identical nodes: every row scores alike until one is placed on."""
    cl = ClusterTensors()
    for i in range(n):
        node = mock.node()
        node.id = f"node-{i}"
        node.node_resources.cpu, node.node_resources.memory_mb = 4000, 8192
        cl.upsert_node(node)
    return cl


def _case(name):
    """(stack, programs) of a case; programs are the reference's, as numpy."""
    if name == "every_row_tied":
        cl = _tied_cluster(20)
        job = mock.job()
        job.task_groups[0].networks = []
        stack = TPUStack(cl)
        return stack, [stack.compile_tg(job, job.task_groups[0], 4)[0],
                       stack.compile_tg(job, job.task_groups[0], 2)[0]]
    cl, nodes, rng, allocs = cc.synth_cluster(24, n_allocs=40)
    if name == "bench_mix":
        return _bench_mix(cl, rng, 8, count=8)
    if name == "chain_mix":
        stack, progs = cc.mixed_programs(cl, nodes, rng, allocs, n_prog=5)
        job = synth_service_job(rng, count=4, with_spread=True)
        plan = PlanContext(
            stopped_allocs=allocs[3:6],
            penalty_node_ids=[frozenset({nodes[2].id}),
                              frozenset({nodes[5].id, nodes[6].id})],
            preferred_node_ids=[nodes[4].id, None, nodes[9].id])
        progs.append(stack.compile_tg(job, job.task_groups[0], 4, plan)[0])
        return stack, progs
    if name == "all_floor":
        stack, progs = _bench_mix(cl, rng, 2, count=4)
        job = synth_service_job(rng, count=4)
        job.constraints.append(Constraint("${attr.kernel.name}", "windows",
                                          "="))
        progs.insert(1, stack.compile_tg(job, job.task_groups[0], 4)[0])
        return stack, progs
    if name == "spread_on_and_off":
        stack, on = _bench_mix(cl, rng, 2, count=6, with_spread=True)
        _stack, off = _bench_mix(cl, rng, 2, count=6, stack=stack,
                                 with_spread=False)
        return stack, on + off
    if name == "distinct_property":
        return _bench_mix(cl, rng, 3, count=6, distinct_property=True)
    if name == "distinct_hosts":
        return _bench_mix(cl, rng, 3, count=6, distinct_hosts=True)
    if name == "terms_cancel_to_zero":
        return _bench_mix(cl, rng, 3, count=1, with_affinity=True,
                          with_spread=False, distinct_hosts=False)
    raise KeyError(name)


CASES = ("bench_mix", "chain_mix", "every_row_tied", "all_floor",
         "spread_on_and_off", "distinct_property", "distinct_hosts",
         "terms_cancel_to_zero")


def _before_aff(cluster, p):
    """Every row's score sum before its affinity term, (fit + anti) + 0,
    and its fit bit."""
    n = cluster.capacity.shape[0]
    st = tp._static_plain(cluster, p, False)
    x, _c, fit_bit, _d = _terms(
        cluster, p, dict(st, aff_score=torch.zeros(n)), st["used"],
        st["job_cnt"], st["tg_cnt"], torch.zeros(n),
        torch.zeros(n, dtype=torch.bool))
    return x.tolist(), fit_bit.tolist()


def _cancel_to_zero(arrays, batched):
    """Set each program's affinity LUT so that one feasible row's affinity
    term is minus the sum before it: that row's prefix, and its score,
    are exactly 0.0. Every other token's term is -1, and the row is one
    that the others of its token lie more than 1e-5 below — the best row
    of program 0 is made so by 16 more cpu used — so it is the unique
    best row, by more than the ulps in which XLA's exp2 and torch's
    differ. Returns the view, the batch and each program's zero row."""
    programs = params_from_numpy(batched, "cpu")
    x, fit_bit = _before_aff(cc.port_cluster(arrays), tp._program(programs,
                                                                  0))
    best = max((r for r in range(len(x)) if fit_bit[r]), key=lambda r: x[r])
    used = np.array(arrays.used)
    used[best, 0] += 16.0
    arrays = arrays._replace(used=used)
    cluster = cc.port_cluster(arrays)
    aff_lut = np.array(batched.aff_lut)
    zero_rows = []
    for b in range(aff_lut.shape[0]):
        p = tp._program(programs, b)
        x, fit_bit = _before_aff(cluster, p)
        tok = tp._tokens(cluster.attrs, p.aff_key_idx,
                         aff_lut.shape[2])[:, 0].tolist()
        ok = [r for r in range(len(x)) if fit_bit[r]]
        unique = [r for r in ok if all(x[q] < x[r] - 1e-5 for q in ok
                                       if q != r and tok[q] == tok[r])]
        assert unique, "no row stands alone in its token"
        row = max(unique, key=lambda r: x[r])
        aff_lut[b, 0, :] = -1.0
        aff_lut[b, 0, tok[row]] = -x[row]
        zero_rows.append(row)
    aff_inv = np.ones_like(np.asarray(batched.aff_inv_sum))
    return arrays, batched._replace(aff_lut=aff_lut,
                                    aff_inv_sum=aff_inv), zero_rows


@pytest.mark.parametrize("case", CASES)
def test_model_matches_plain_and_reference(case):
    stack, progs = _case(case)
    batched, m = stack_params(progs)
    arrays = stack.device_arrays()
    if case == "terms_cancel_to_zero":
        arrays, batched, zero_rows = _cancel_to_zero(arrays, batched)
    cluster = cc.port_cluster(arrays)
    batch = params_from_numpy(batched, "cpu")
    got = model_batch(cluster, batch, m)
    plain = tp.place_task_group_batch_plain(cluster, batch, m)
    want = (plain.sel_idx, plain.sel_score)
    for name, g, w in zip(("sel_idx", "sel_score"), got, want):
        assert g.shape == w.shape, name
        assert torch.equal(g.contiguous().view(torch.int32),
                           w.contiguous().view(torch.int32)), name
    ref = jp.place_task_group_batch(arrays, batched, m)
    np.testing.assert_array_equal(np.asarray(ref.sel_idx), got[0].numpy())
    np.testing.assert_allclose(np.asarray(ref.sel_score), got[1].numpy(),
                               rtol=0, atol=cc.ATOL)
    sel = got[0].numpy()
    assert (sel >= 0).any(), "nothing placed: vacuous"
    if case == "every_row_tied":
        assert sel[0, 0] == 0, "a tie goes to the lowest row"
    if case == "all_floor":
        assert (sel[1] == -1).all() and int(plain.nodes_feasible[1]) == 0
    if case == "spread_on_and_off":
        assert bool(batch.spread_active[:2].any())
        assert not bool(batch.spread_active[2:].any())
    if case == "distinct_property":
        assert bool(batch.dp_active.all())
    if case == "distinct_hosts":
        assert bool(batch.distinct_hosts.all())
        for b in range(sel.shape[0]):
            placed = sel[b][sel[b] >= 0]
            assert len(set(placed.tolist())) == len(placed)
    if case == "terms_cancel_to_zero":
        for b, row in enumerate(zero_rows):
            _out, prefix = onchip_model(cluster, tp._program(batch, b), m)
            assert sel[b, 0] == row
            assert float(prefix[row]) == 0.0
            assert not bool(torch.signbit(prefix[row]))
            assert got[1][b, 0].view(torch.int32) == 0   # +0.0


# ---- the route by shape --------------------------------------------------------

#: `_program_dims` of bench's mix at count 8 (`stack_params` padding)
BENCH_DIMS = dict(c=4, v=32, a=1, av=32, m=8, pn=1, e=1, j=1, j2=1, d=1,
                  l=1, p=1, dv=32, pp=1, pc=1, ps=1, s=1, sv=32, cw=1,
                  explain=0, topk=5)


def test_bench_dims_are_the_mix_the_route_is_sized_for():
    stack, progs = _case("bench_mix")
    batched, m = stack_params(progs)
    spec = jp.pack_params(batched)[3]
    shapes = {name: tuple(shape[1:]) for name, _c, _o, shape in spec}
    n = stack.device_arrays().capacity.shape[0]
    assert tp._program_dims(shapes, m, False, n) == dict(BENCH_DIMS,
                                                         topk=min(5, n))


def test_route_is_onchip_at_bench_size_and_pooled_past_the_limit():
    assert tp.batch_route(16384, BENCH_DIMS) == "onchip"
    assert tp.batch_route(65536, BENCH_DIMS) == "pooled"
    # the largest row count that fits, and the next one past it
    fits = [n for n in range(16384, 65536, 16)
            if tp.onchip_layout(n, BENCH_DIMS)["total"] <= tp.BLOCK_SMEM]
    last = fits[-1]
    assert tp.batch_route(last, BENCH_DIMS) == "onchip"
    assert tp.batch_route(last + 16, BENCH_DIMS) == "pooled"
    # vocabularies past u16 never go on chip
    assert tp.batch_route(64, dict(BENCH_DIMS, sv=70000)) == "pooled"


def _regions_in_source():
    src = (Path(tp.__file__).parent / "csrc" / "batch.cu").read_text()
    enum = re.search(r"enum OnchipRegion \{([^}]*)\}", src).group(1)
    names = [x.strip()[2:].lower() for x in enum.split(",") if x.strip()]
    assert names[-1] == "end"
    return names[:-1]


@pytest.mark.parametrize("n", [64, 16384, 30000])
@pytest.mark.parametrize("wide", [False, True], ids=["u8", "u16"])
def test_layout_matches_the_kernel(n, wide):
    """`onchip_layout` reckons the regions of `onchip_offsets`
    (csrc/batch.cu) in its order, each on a 16-byte boundary, none
    overlapping; per row 4 + 1 bytes and a token a spread row and a
    property (u8, or u16 past 256 values). The card test checks the
    library's own total against it."""
    dims = dict(BENCH_DIMS, s=2, sv=300 if wide else 32, p=1,
                dv=300 if wide else 32)
    lay = tp.onchip_layout(n, dims)
    names = [k for k in lay if k != "total"]
    assert names == _regions_in_source() == list(tp._ONCHIP_REGIONS)
    end = 0
    for name in names:
        off, size = lay[name]
        assert off % 16 == 0 and off >= end, name
        end = off + size
    assert lay["total"] == (end + 15) & ~15
    tok = 2 if wide else 1
    assert lay["prefix"][1] == 4 * n and lay["meta"][1] == n
    assert lay["stok"][1] == 2 * n * tok and lay["dtok"][1] == n * tok
    assert lay["args"][1] == tp.ctypes.sizeof(tp._PlaceArgs)


def test_cpu_tensors_never_launch_the_onchip_kernel():
    stack, progs = _case("bench_mix")
    batched, m = stack_params(progs)
    ibuf, fbuf, ubuf, spec = jp.pack_params(batched)
    before = (tp.onchip_launch_count(), tp.batch_launch_count())
    sel, _score = tp.place_packed_batch(cc.port_cluster(stack.device_arrays()),
                                        *cc.port_bufs(ibuf, fbuf, ubuf), spec,
                                        m)
    assert (tp.onchip_launch_count(), tp.batch_launch_count()) == before
    assert (sel.numpy() >= 0).any()
