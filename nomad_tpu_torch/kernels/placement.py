"""The placement kernel: one task group's feasibility → rank → select.

Re-expresses the reference's evaluation hot loop (`scheduler/stack.go:116`
Select → `rank.go:188` BinPackIterator.Next → `structs/funcs.go:175`) as a
dense pass over every node row, as `nomad_tpu/kernels/placement.py` does for
the TPU:

  feasibility = AND of LUT lookups of tokenized attrs          [N]
  score       = fused binpack/spread fit + conditional aux terms, mean of
                the included terms (rank.go semantics)
  select      = argmax over N (first index among ties), with the
                preferred-node override
  multi-alloc = M dependent steps carrying (used, counts), so successive
                allocs of one group see each other

Two implementations compute the same function:

- `place_task_group_plain`: plain PyTorch on any device. The CPU tests
  compare it with the JAX package; `chip_smoke.py` compares the kernel
  with it on the card.
- the hand-written CUDA kernel (`csrc/placement.cu`), launched by
  `place_task_group` for CUDA tensors.

`place_task_group` dispatches on the device of `cluster.used`: CPU → plain,
CUDA → the kernel (or raise). There is no fallback between the two.

The batched server path runs programs in chains and waves (K4, K5):
`place_table_chain`, `place_table_wave`, `place_task_group_chain` and
`place_packed_chain`, each with a plain version and a CUDA route. The
table and packed chains and the wave take, by shape (`lane_route`), the
lane route (`csrc/lanes.cu`: a lane one thread-block cluster with its
rows in shared memory, one launch a chain, two a wave), or past its
layout `csrc/chain.cu`, which also runs `place_task_group_chain` (it
returns the carry after every program); both share K1's device code
(`csrc/place_core.cuh`).
The system scheduler's masks (K2) are `system_feasibility`, its plain
version beside it and the kernel in `csrc/system.cu` (`system_rows`: one
launch a card over every node shard it holds — one argument block for an
unsharded view — fed by one staged copy, `system_masks_on`). The vmap
transport (K6), independent programs against one snapshot, is
`place_task_group_batch` and `place_packed_batch`, its kernel a wave of
one-program lanes in `csrc/chain.cu`. The node-sharded form of K6 (K9) is
`kernels/shard.py`.

Types at the boundary: `attrs` is int16 (int32 when a key's vocabulary
outgrows int16), `ports_used` is int32 holding the bits of the reference's
u32 bitmap (torch's uint32 lacks shifts on the CPU), and bool tensors are
read by the kernel as bytes.
"""
from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

NEG_INF = -1e30
LOG2_10 = 3.321928094887362
INV_18 = 1.0 / 18.0


class ClusterArrays(NamedTuple):
    """Device view of the cluster tensors (`tensor.ClusterTensors`)."""

    capacity: torch.Tensor    # f32[N, R]
    used: torch.Tensor        # f32[N, R]
    node_ok: torch.Tensor     # bool[N]
    attrs: torch.Tensor       # i16[N, K] (i32 for very large vocabularies)
    ports_used: torch.Tensor  # i32[N, 2048] — bits of the u32 port bitmap
    dyn_free: torch.Tensor    # f32[N] — free dynamic-range ports


class TGParams(NamedTuple):
    """One task group's compiled placement request (padded/bucketed
    shapes). Field meanings are those of the reference package's
    `TGParams`; scalars are 0-d tensors."""

    ask: torch.Tensor                 # f32[R]
    n_place: torch.Tensor             # i32 — allocs to place (≤ M)
    desired_count: torch.Tensor       # f32 — tg.Count (anti-affinity)
    algorithm: torch.Tensor           # i32 — 0 binpack | 1 spread
    key_idx: torch.Tensor             # i32[C] — constraint LUT keys
    lut: torch.Tensor                 # bool[C, V]
    aff_key_idx: torch.Tensor         # i32[A]
    aff_lut: torch.Tensor             # f32[A, V]
    aff_inv_sum: torch.Tensor         # f32
    penalty_idx: torch.Tensor         # i32[M, PN] — −1 pad
    preferred_idx: torch.Tensor       # i32[M] — −1 none
    extra_mask: torch.Tensor          # bool[N] or bool[1] (broadcast)
    distinct_hosts: torch.Tensor      # bool
    jc_idx: torch.Tensor              # i32[J] — −1 pad
    jc_val: torch.Tensor              # f32[J]
    jtc_idx: torch.Tensor             # i32[J2]
    jtc_val: torch.Tensor             # f32[J2]
    delta_idx: torch.Tensor           # i32[D]
    delta_res: torch.Tensor           # f32[D, R]
    cand_idx: torch.Tensor            # i32[L]
    use_cand: torch.Tensor            # bool
    dp_key_idx: torch.Tensor          # i32[P]
    dp_allowed: torch.Tensor          # f32[P]
    dp_counts0: torch.Tensor          # f32[P, V]
    dp_active: torch.Tensor           # bool[P]
    res_ports: torch.Tensor           # i32[PP] — −1 pad
    n_dyn: torch.Tensor               # f32
    pclr_idx: torch.Tensor            # i32[PC]
    pclr_port: torch.Tensor           # i32[PC]
    pset_idx: torch.Tensor            # i32[PS]
    pset_port: torch.Tensor           # i32[PS]
    spread_key_idx: torch.Tensor      # i32[S]
    spread_weight: torch.Tensor       # f32[S]
    spread_has_targets: torch.Tensor  # bool[S]
    spread_desired: torch.Tensor      # f32[S, V]
    spread_counts0: torch.Tensor      # f32[S, V]
    spread_active: torch.Tensor       # bool[S]


#: top-K score-breakdown width (AllocMetric keeps 5, structs.go:9370)
EXPLAIN_TOPK = 5

#: score components carried per top-K node, in order
EXPLAIN_SCORE_NAMES = ("binpack", "job-anti-affinity",
                       "node-reschedule-penalty", "node-affinity",
                       "allocation-spread")


class PlacementExplain(NamedTuple):
    """Reduced attribution outputs for one program (the device half of
    `structs.AllocMetric`); see the reference package's docstring."""

    nodes_evaluated: torch.Tensor  # i32
    filt_constraint: torch.Tensor  # i32[C]
    filt_lut: torch.Tensor         # i32
    filt_extra: torch.Tensor       # i32
    filt_distinct: torch.Tensor    # i32[M]
    filt_dp: torch.Tensor          # i32[M]
    exh_dim: torch.Tensor          # i32[M, R]
    exh_dyn_ports: torch.Tensor    # i32[M]
    exh_res_ports: torch.Tensor    # i32[M]
    topk_idx: torch.Tensor         # i32[M, K]
    topk_score: torch.Tensor       # f32[M, K]
    topk_parts: torch.Tensor       # f32[M, K, 5]


class PlacementResult(NamedTuple):
    sel_idx: torch.Tensor         # i32[M] — chosen row per alloc, −1 failed
    sel_score: torch.Tensor       # f32[M]
    new_used: torch.Tensor        # f32[N, R] — used after the placements
    nodes_feasible: torch.Tensor  # i32
    nodes_fit: torch.Tensor       # i32[M]
    final_scores0: torch.Tensor   # f32[N] — step 0's masked score vector
    explain: Optional[PlacementExplain] = None


def _sharded_routes(cluster):
    """kernels/shard.py when `cluster` is a node-sharded view
    (`ShardedCluster`, the view cache's form under an active mesh), else
    None."""
    if isinstance(cluster, ClusterArrays):
        return None
    from . import shard

    if isinstance(cluster, shard.ShardedCluster):
        return shard
    return None


# ---- plain PyTorch version ---------------------------------------------------


def fit_scores(util: torch.Tensor, cap: torch.Tensor):
    """(binpack, spread) fit scores per node in [0, 1] (reference
    funcs.go:175/:202, normalized by 18 per rank.go:11-13). The division
    by 18 is a multiply by its f32 reciprocal: XLA folds the reference's
    `/ 18.0` into exactly that, and the kernel does the same."""
    free_cpu = 1.0 - util[:, 0] / torch.clamp(cap[:, 0], min=1.0)
    free_ram = 1.0 - util[:, 1] / torch.clamp(cap[:, 1], min=1.0)
    total = torch.exp2(free_cpu * LOG2_10) + torch.exp2(free_ram * LOG2_10)
    binpack = torch.clamp(20.0 - total, 0.0, 18.0) * INV_18
    spread = torch.clamp(total - 2.0, 0.0, 18.0) * INV_18
    return binpack, spread


def _tokens(attrs: torch.Tensor, key_idx: torch.Tensor, v: int):
    """tok[n, c] = attrs[n, key_idx[c]] with missing (−1) → V−1 and values
    clamped to V−1 (padding rows read an arbitrary key)."""
    tok = attrs[:, key_idx.long()].long()
    return torch.where(tok < 0, v - 1, torch.clamp(tok, max=v - 1))


def _lookup(table: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """out[n, c] = table[c, tok[n, c]]."""
    rows = torch.arange(table.shape[0], device=tok.device)
    return table[rows[None, :], tok]


def _scatter(idx: torch.Tensor, val: torch.Tensor, n: int) -> torch.Tensor:
    """Dense f32[N] (or [N, ...]) sums of `val` rows at `idx`; −1 pads add
    nothing."""
    valid = idx >= 0
    val = val * valid.reshape((-1,) + (1,) * (val.dim() - 1))
    out = torch.zeros((n,) + tuple(val.shape[1:]), dtype=torch.float32,
                      device=idx.device)
    return out.index_add_(0, idx.clamp(min=0).long(), val.float())


def _sum_cols(x: torch.Tensor) -> torch.Tensor:
    """Row sums taken column by column, in column order (the order the
    kernel adds them in)."""
    acc = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for c in range(x.shape[1]):
        acc = acc + x[:, c]
    return acc


def _reserved_ports_free(cluster: ClusterArrays, p: TGParams):
    """bool[N]: every static host-port ask is free on the node, with the
    plan's released (pclr) ports read as free and consumed (pset) ports as
    taken (reference rank.go:231-320, the proposed-alloc NetworkIndex)."""
    n = cluster.ports_used.shape[0]
    rp_raw = p.res_ports.long()
    rp = rp_raw.clamp(min=0)
    words = cluster.ports_used[:, rp >> 5]                      # [N, PP]
    taken = ((words >> (rp & 31)[None, :]) & 1) != 0
    for idx, port, clear in ((p.pclr_idx, p.pclr_port, True),
                             (p.pset_idx, p.pset_port, False)):
        if idx.shape[0]:
            hit = (port.long()[:, None] == rp_raw[None, :]).float()
            marks = _scatter(idx, hit, n) > 0                   # [N, PP]
            taken = (taken & ~marks) if clear else (taken | marks)
    free = ~taken | (rp_raw < 0)[None, :]
    return torch.all(free, dim=1)


def _dyn_free_adjusted(cluster: ClusterArrays, p: TGParams):
    """f32[N]: free dynamic-port counts with plan-relative credit/debit."""
    n = cluster.dyn_free.shape[0]
    dyn = cluster.dyn_free
    if p.pclr_idx.shape[0]:
        in_rng = ((p.pclr_port >= 20000) & (p.pclr_port <= 32000)).float()
        dyn = dyn + _scatter(p.pclr_idx, in_rng, n)
    if p.pset_idx.shape[0]:
        in_rng = ((p.pset_port >= 20000) & (p.pset_port <= 32000)).float()
        dyn = dyn - _scatter(p.pset_idx, in_rng, n)
    return dyn


def _spread_boost(stok, counts, p: TGParams):
    """Per-node total spread boost (reference spread.go:120-174 plus
    evenSpreadScoreBoost :178), summed over the spread rows in order."""
    s_n, v = counts.shape
    n = stok.shape[0]
    total = torch.zeros(n, dtype=torch.float32, device=stok.device)
    if s_n == 0:
        return total
    miss = v - 1
    big = 3.4e38
    for s in range(s_n):
        tok = stok[:, s]
        cur = counts[s][tok]
        desired = p.spread_desired[s][tok]
        used_count = cur + 1.0
        target = torch.where(
            desired > 0.0,
            (desired - used_count) / torch.where(desired > 0, desired, 1.0)
            * p.spread_weight[s],
            -1.0)
        seen = counts[s] > 0.0
        any_seen = torch.any(seen)
        minc = torch.min(torch.where(seen, counts[s], big))
        maxc = torch.max(torch.where(seen, counts[s], -big))
        minc_safe = torch.where(minc > 0, minc, 1.0)
        delta_boost = torch.where(minc == 0.0, -1.0, (minc - cur) / minc_safe)
        even = torch.where(
            cur != minc, delta_boost,
            torch.where(minc == maxc, -1.0,
                        torch.where(minc == 0.0, 1.0,
                                    (maxc - minc) / minc_safe)))
        even = torch.where(tok == miss, -1.0, even)
        even = torch.where(any_seen, even, 0.0)
        boost = torch.where(p.spread_has_targets[s], target, even)
        boost = torch.where(p.spread_active[s], boost, 0.0)
        total = total + boost
    return total


def _static_plain(cluster: ClusterArrays, p: TGParams, explain: bool) -> dict:
    """The per-program state before the scan: the static mask and scores,
    tokens, the plan-adjusted used/dyn_free and the counts the scan
    carries (K1's static pass)."""
    cap = cluster.capacity
    n = cap.shape[0]
    dev = cap.device
    i32 = torch.int32
    st = {"rows": torch.arange(n, device=dev)}

    v = p.lut.shape[1]
    if p.lut.shape[0]:
        feas_c = _lookup(p.lut, _tokens(cluster.attrs, p.key_idx, v))
    else:
        feas_c = torch.ones((n, 0), dtype=torch.bool, device=dev)
    lut_all = torch.all(feas_c, dim=1)
    feas = cluster.node_ok & p.extra_mask & lut_all
    in_cand = None
    if p.cand_idx.shape[0]:
        in_cand = _scatter(p.cand_idx, torch.ones_like(p.cand_idx,
                                                       dtype=torch.float32),
                           n) > 0
        feas = feas & (in_cand | ~p.use_cand)
    st["feas"] = feas

    if explain:
        base = cluster.node_ok
        if in_cand is not None:
            base = base & (in_cand | ~p.use_cand)
        st["ex_static"] = dict(
            nodes_evaluated=base.sum().to(i32),
            filt_constraint=((~feas_c) & base[:, None]).sum(dim=0).to(i32),
            filt_lut=(base & ~lut_all).sum().to(i32),
            filt_extra=(base & lut_all & ~p.extra_mask).sum().to(i32))

    if p.aff_lut.shape[0]:
        aff_vals = _lookup(p.aff_lut,
                           _tokens(cluster.attrs, p.aff_key_idx,
                                   p.aff_lut.shape[1]))
    else:
        aff_vals = torch.zeros((n, 0), dtype=torch.float32, device=dev)
    st["aff_score"] = _sum_cols(aff_vals) * p.aff_inv_sum

    s_v = p.spread_desired.shape[1]
    st["stok"] = (_tokens(cluster.attrs, p.spread_key_idx, s_v)
                  if p.spread_key_idx.shape[0]
                  else torch.zeros((n, 0), dtype=torch.long, device=dev))
    d_v = p.dp_counts0.shape[1]
    st["dtok"] = (_tokens(cluster.attrs, p.dp_key_idx, d_v)
                  if p.dp_key_idx.shape[0]
                  else torch.zeros((n, 0), dtype=torch.long, device=dev))

    # plan-relative deltas: a row's deltas are summed, then subtracted once
    used = cluster.used
    if p.delta_idx.shape[0]:
        used = used - _scatter(p.delta_idx, p.delta_res, n)
    st["used"] = used.clone()

    st["nodes_feasible"] = feas.sum().to(i32)
    st["res_free"] = _reserved_ports_free(cluster, p)
    st["dyn_free"] = _dyn_free_adjusted(cluster, p)
    st["has_res_ask"] = torch.any(p.res_ports >= 0)

    st["job_cnt"] = _scatter(p.jc_idx, p.jc_val, n)
    st["tg_cnt"] = _scatter(p.jtc_idx, p.jtc_val, n)
    st["splaced"] = torch.zeros(n, dtype=torch.float32, device=dev)
    st["scounts"] = p.spread_counts0.clone()
    st["dcounts"] = p.dp_counts0.clone()
    st["ones_pen"] = torch.ones(p.penalty_idx.shape[1], dtype=torch.float32,
                                device=dev)
    return st


def _step_plain(cluster: ClusterArrays, p: TGParams, st: dict, i: int) -> dict:
    """Step i of the scan over every row of `cluster`: fit, ports,
    distinct_hosts, the distinct_property mask and the fused score; `ok`
    and `masked` (the score at the −1e30 floor where not ok), and the
    parts the explain reductions read."""
    cap = cluster.capacity
    n = cap.shape[0]
    used, splaced, job_cnt, tg_cnt = (st["used"], st["splaced"],
                                      st["job_cnt"], st["tg_cnt"])
    penalty = _scatter(p.penalty_idx[i], st["ones_pen"], n) > 0

    util = used + p.ask[None, :]
    res_over = util > cap
    any_over = torch.any(res_over, dim=1)
    dyn_ok = (st["dyn_free"] - splaced * p.n_dyn) >= p.n_dyn
    res_ok = st["res_free"] & ~(st["has_res_ask"] & (splaced > 0))
    fits = ~any_over & dyn_ok & res_ok
    ok = st["feas"] & fits
    dh_collide = p.distinct_hosts & (job_cnt > 0)
    ok = ok & ~dh_collide

    dp_mask = None
    dcounts, dtok = st["dcounts"], st["dtok"]
    if dcounts.shape[0]:
        d_v = dcounts.shape[1]
        cur_d = _lookup(dcounts, dtok)
        row_ok = (((cur_d < p.dp_allowed[None, :]) & (dtok != d_v - 1))
                  | ~p.dp_active[None, :])
        dp_mask = torch.all(row_ok, dim=1)
        ok = ok & dp_mask

    binpack, spreadfit = fit_scores(util, cap)
    fit_score = torch.where(p.algorithm == 1, spreadfit, binpack)
    ssum = fit_score
    scnt = torch.ones_like(fit_score)
    collide = tg_cnt > 0
    anti = -(tg_cnt + 1.0) / torch.clamp(p.desired_count, min=1.0)
    ssum = ssum + torch.where(collide, anti, 0.0)
    scnt = scnt + collide
    ssum = ssum + torch.where(penalty, -1.0, 0.0)
    scnt = scnt + penalty
    aff_score = st["aff_score"]
    inc_aff = aff_score != 0.0
    ssum = ssum + torch.where(inc_aff, aff_score, 0.0)
    scnt = scnt + inc_aff
    spread_score = _spread_boost(st["stok"], st["scounts"], p)
    inc_spread = spread_score != 0.0
    ssum = ssum + torch.where(inc_spread, spread_score, 0.0)
    scnt = scnt + inc_spread
    final = ssum / scnt
    return dict(
        ok=ok, fits=fits, final=final,
        masked=torch.where(ok, final, NEG_INF), res_over=res_over,
        any_over=any_over, dyn_ok=dyn_ok, res_ok=res_ok,
        dh_collide=dh_collide, dp_mask=dp_mask, fit_score=fit_score,
        collide=collide, anti=anti, penalty=penalty, inc_aff=inc_aff,
        inc_spread=inc_spread, spread_score=spread_score)


def _take_plain(st: dict, p: TGParams, idx, found, sel_tok, sel_dtok) -> None:
    """The carry update of a placement on row `idx` (a row of this
    state's cluster, or outside it: then only the counts change) when
    `found`: the ask onto used, the job/tg/placed counts, and the
    placed row's spread and distinct_property tokens (`sel_tok`,
    `sel_dtok`) onto the value counts."""
    hit = (st["rows"] == idx) & found
    st["used"] = st["used"] + torch.where(hit[:, None], p.ask[None, :], 0.0)
    st["job_cnt"] = st["job_cnt"] + hit
    st["tg_cnt"] = st["tg_cnt"] + hit
    st["splaced"] = st["splaced"] + hit.float()
    scounts, dcounts = st["scounts"], st["dcounts"]
    if scounts.shape[0]:
        valid = (sel_tok != scounts.shape[1] - 1) & found
        st["scounts"] = scounts + torch.nn.functional.one_hot(
            sel_tok, scounts.shape[1]).float() * valid[:, None]
    if dcounts.shape[0]:
        dvalid = (sel_dtok != dcounts.shape[1] - 1) & found
        st["dcounts"] = dcounts + torch.nn.functional.one_hot(
            sel_dtok, dcounts.shape[1]).float() * dvalid[:, None]


def _explain_step(st: dict, ev: dict, k: int) -> tuple:
    """One step's explain reductions over the rows of `st`/`ev`: the
    distinct_hosts, distinct_property, per-dimension, dynamic-port and
    reserved-port filter counts, and the top-`k` rows (score descending,
    the lower row first among equal scores), their scores and score
    parts (zero at the −1e30 floor)."""
    feas = st["feas"]
    r_tot = ev["res_over"].shape[1]
    dh_fail = feas & ev["dh_collide"]
    dp_mask, any_over = ev["dp_mask"], ev["any_over"]
    dp_fail = (feas & ~dh_fail & ~dp_mask if dp_mask is not None
               else torch.zeros_like(feas))
    cand_m = feas & ~dh_fail & ~dp_fail
    ff = torch.argmax(ev["res_over"].to(torch.uint8), dim=1)
    ff_hit = ((ff[:, None] == torch.arange(r_tot, device=feas.device)[None, :])
              & (cand_m & any_over)[:, None])
    tk_score, tk_idx = torch.sort(ev["masked"], descending=True, stable=True)
    tk_score, tk_idx = tk_score[:k], tk_idx[:k]
    parts = torch.stack(
        (ev["fit_score"], torch.where(ev["collide"], ev["anti"], 0.0),
         torch.where(ev["penalty"], -1.0, 0.0),
         torch.where(ev["inc_aff"], st["aff_score"], 0.0),
         torch.where(ev["inc_spread"], ev["spread_score"], 0.0)),
        dim=1)
    tk_parts = parts[tk_idx] * (tk_score > NEG_INF / 2)[:, None]
    dyn_ok, res_ok = ev["dyn_ok"], ev["res_ok"]
    return (dh_fail.sum(), dp_fail.sum(), ff_hit.sum(dim=0),
            (cand_m & ~any_over & ~dyn_ok).sum(),
            (cand_m & ~any_over & dyn_ok & ~res_ok).sum(),
            tk_idx, tk_score, tk_parts)


def _explain_of(ex_static: dict, ex_steps: list) -> PlacementExplain:
    """PlacementExplain from the static counts and the steps' tuples
    (`_explain_step`'s order)."""
    i32 = torch.int32
    cols = list(zip(*ex_steps))
    return PlacementExplain(
        **ex_static,
        filt_distinct=torch.stack(cols[0]).to(i32),
        filt_dp=torch.stack(cols[1]).to(i32),
        exh_dim=torch.stack(cols[2]).to(i32),
        exh_dyn_ports=torch.stack(cols[3]).to(i32),
        exh_res_ports=torch.stack(cols[4]).to(i32),
        topk_idx=torch.stack(cols[5]).to(i32),
        topk_score=torch.stack(cols[6]),
        topk_parts=torch.stack(cols[7]),
    )


def place_task_group_plain(cluster: ClusterArrays, p: TGParams,
                           max_allocs: int,
                           explain: bool = False) -> PlacementResult:
    """Plain PyTorch placement of up to `max_allocs` allocs of one group.

    Runs on whatever device the tensors are on. Mirrors
    `nomad_tpu/kernels/placement.py` place_task_group term by term; the
    TPU's one-hot einsums become direct indexing (each had exactly one
    non-zero term, so the values are the same) and the scan a Python
    loop."""
    n = cluster.capacity.shape[0]
    i32 = torch.int32
    st = _static_plain(cluster, p, explain)
    feas = st["feas"]

    sels, scores, n_fits, finals = [], [], [], []
    ex_steps = []
    for i in range(max_allocs):
        ev = _step_plain(cluster, p, st, i)
        ok, masked = ev["ok"], ev["masked"]
        best = torch.argmax(masked)
        pref_idx = p.preferred_idx[i]
        pref = pref_idx.clamp(min=0)
        pref_ok = (pref_idx >= 0) & ok[pref]
        idx = torch.where(pref_ok, pref, best)
        found = ok[idx] & (i < p.n_place)
        sels.append(torch.where(found, idx, -1))
        scores.append(torch.where(found, ev["final"][idx], 0.0))
        n_fits.append((feas & ev["fits"]).sum())
        finals.append(masked)
        # carry update: only row idx changes, and only when found
        _take_plain(st, p, idx, found, st["stok"][idx], st["dtok"][idx])

        if explain:
            ex_steps.append(_explain_step(st, ev, min(EXPLAIN_TOPK, n)))

    ex = _explain_of(st["ex_static"], ex_steps) if explain else None
    return PlacementResult(
        sel_idx=torch.stack(sels).to(i32),
        sel_score=torch.stack(scores),
        new_used=st["used"],
        nodes_feasible=st["nodes_feasible"],
        nodes_fit=torch.stack(n_fits).to(i32),
        final_scores0=finals[0],
        explain=ex,
    )


# ---- the CUDA kernel ---------------------------------------------------------

_VOID = ctypes.c_void_p
_INT = ctypes.c_int


class _PlaceArgs(ctypes.Structure):
    """Mirror of `PlaceArgs` in csrc/placement.cu, field for field; the
    library reports sizeof(PlaceArgs) and the wrapper checks it."""

    _fields_ = [
        # cluster
        ("capacity", _VOID), ("used", _VOID), ("node_ok", _VOID),
        ("attrs", _VOID), ("ports_used", _VOID), ("dyn_free", _VOID),
        ("n", _INT), ("r", _INT), ("k_cols", _INT), ("port_words", _INT),
        ("attrs_i32", _INT),
        # program
        ("ask", _VOID), ("n_place", _VOID), ("desired_count", _VOID),
        ("algorithm", _VOID),
        ("key_idx", _VOID), ("lut", _VOID), ("c", _INT), ("v", _INT),
        ("aff_key_idx", _VOID), ("aff_lut", _VOID), ("aff_inv_sum", _VOID),
        ("a", _INT), ("av", _INT),
        ("penalty_idx", _VOID), ("preferred_idx", _VOID), ("m", _INT),
        ("pn", _INT),
        ("extra_mask", _VOID), ("e", _INT),
        ("distinct_hosts", _VOID),
        ("jc_idx", _VOID), ("jc_val", _VOID), ("j", _INT),
        ("jtc_idx", _VOID), ("jtc_val", _VOID), ("j2", _INT),
        ("delta_idx", _VOID), ("delta_res", _VOID), ("d", _INT),
        ("cand_idx", _VOID), ("use_cand", _VOID), ("l", _INT),
        ("dp_key_idx", _VOID), ("dp_allowed", _VOID), ("dp_counts0", _VOID),
        ("dp_active", _VOID), ("p", _INT), ("dv", _INT),
        ("res_ports", _VOID), ("pp", _INT), ("n_dyn", _VOID),
        ("pclr_idx", _VOID), ("pclr_port", _VOID), ("pc", _INT),
        ("pset_idx", _VOID), ("pset_port", _VOID), ("ps", _INT),
        ("spread_key_idx", _VOID), ("spread_weight", _VOID),
        ("spread_has_targets", _VOID), ("spread_desired", _VOID),
        ("spread_counts0", _VOID), ("spread_active", _VOID),
        ("s", _INT), ("sv", _INT),
        # scratch
        ("feas", _VOID), ("flags", _VOID), ("cfail", _VOID), ("cw", _INT),
        ("aff", _VOID), ("res_free", _VOID), ("dyn", _VOID),
        ("job_cnt", _VOID), ("tg_cnt", _VOID), ("splaced", _VOID),
        ("stok", _VOID), ("dtok", _VOID), ("mbuf", _VOID), ("okbuf", _VOID),
        ("parts", _VOID),
        # outputs
        ("new_used", _VOID), ("sel_idx", _VOID), ("sel_score", _VOID),
        ("nodes_feasible", _VOID), ("nodes_fit", _VOID), ("final0", _VOID),
        ("explain", _INT), ("topk", _INT),
        ("ex_static", _VOID), ("filt_constraint", _VOID),
        ("filt_distinct", _VOID), ("filt_dp", _VOID), ("exh_dim", _VOID),
        ("exh_dyn", _VOID), ("exh_res", _VOID), ("topk_idx", _VOID),
        ("topk_score", _VOID), ("topk_parts", _VOID),
    ]


_ARG_FIELDS = frozenset(f for f, _t in _PlaceArgs._fields_)

_CLUSTER_TYPES = {"capacity": torch.float32, "used": torch.float32,
                  "node_ok": torch.bool, "ports_used": torch.int32,
                  "dyn_free": torch.float32}
PARAM_TYPES = {
    name: (torch.float32 if name in (
        "ask", "desired_count", "aff_lut", "aff_inv_sum", "jc_val",
        "jtc_val", "delta_res", "dp_allowed", "dp_counts0", "n_dyn",
        "spread_weight", "spread_desired", "spread_counts0")
        else torch.bool if name in (
        "lut", "extra_mask", "distinct_hosts", "use_cand", "dp_active",
        "spread_has_targets", "spread_active")
        else torch.int32)
    for name in TGParams._fields}


def _check_inputs(cluster: ClusterArrays, p: TGParams, max_allocs: int):
    dev = cluster.used.device
    for name, t in list(cluster._asdict().items()) + list(p._asdict().items()):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, cluster on {dev}")
    for name, dt in _CLUSTER_TYPES.items():
        if getattr(cluster, name).dtype != dt:
            raise TypeError(f"cluster.{name} must be {dt}")
    if cluster.attrs.dtype not in (torch.int16, torch.int32):
        raise TypeError("cluster.attrs must be int16 or int32")
    for name, dt in PARAM_TYPES.items():
        if getattr(p, name).dtype != dt:
            raise TypeError(f"params.{name} must be {dt}")
    n, r = cluster.capacity.shape
    if cluster.used.shape != (n, r) or p.ask.shape != (r,):
        raise ValueError("capacity, used and ask disagree on N or R")
    if p.penalty_idx.shape[0] != max_allocs \
            or p.preferred_idx.shape[0] != max_allocs:
        raise ValueError("penalty/preferred rows must equal max_allocs")
    if p.extra_mask.shape[0] not in (1, n):
        raise ValueError("extra_mask must have 1 or N entries")


class _Launcher:
    """Builds and loads the CUDA library (csrc/placement.cu) at first use,
    and keeps K1's counts: programs placed on the card (one a select on
    the main path), the kernel launches they took, the programs by route
    ("cluster", csrc/lanes.cu; "scan", placement.cu) and the last one's
    route."""

    def __init__(self):
        self.launches = 0
        self.kernels = 0
        self.routes = {"cluster": 0, "scan": 0}
        self.last_route = None
        self._lib = None

    def launch(self, a: _PlaceArgs, dev) -> None:
        """placement.cu's two launches of one program on the device's
        current stream; raises when either is refused."""
        lib = self.lib()
        err = lib.nomad_place_task_group(
            ctypes.byref(a), torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError("placement kernel launch failed: "
                               + lib.nomad_cuda_error_string(err).decode())
        self.kernels += 2
        self.dispatched("scan", None)

    def dispatched(self, route: str, clusters: Optional[int]) -> None:
        self.launches += 1
        self.routes[route] += 1
        self.last_route = (route, clusters)

    def lib(self):
        if self._lib is None:
            from ._build import load_library

            lib = load_library("placement")
            lib.nomad_place_args_size.restype = ctypes.c_size_t
            lib.nomad_place_args_size.argtypes = []
            lib.nomad_place_task_group.restype = ctypes.c_int
            lib.nomad_place_task_group.argtypes = [
                ctypes.POINTER(_PlaceArgs), ctypes.c_void_p]
            lib.nomad_cuda_error_string.restype = ctypes.c_char_p
            lib.nomad_cuda_error_string.argtypes = [ctypes.c_int]
            if lib.nomad_place_args_size() != ctypes.sizeof(_PlaceArgs):
                raise RuntimeError(
                    "placement library's PlaceArgs layout differs from "
                    "the wrapper's (rebuild csrc/placement.cu)")
            self._lib = lib
        return self._lib


_LAUNCHER = _Launcher()


def launch_count() -> int:
    """K1 programs placed on the card since the last reset (one a select,
    on either route)."""
    return _LAUNCHER.launches


def reset_launch_count() -> None:
    """Zero K1's counts (programs, kernel launches, routes)."""
    _LAUNCHER.launches = _LAUNCHER.kernels = 0
    _LAUNCHER.routes = {"cluster": 0, "scan": 0}


def single_kernel_launches() -> int:
    """Kernel launches of K1's programs since the last reset: one a
    program on the lane route, two on placement.cu's."""
    return _LAUNCHER.kernels


def single_route_counts() -> dict:
    """K1 programs since the last reset by route: {"cluster": the lane
    route (csrc/lanes.cu), "scan": placement.cu}."""
    return dict(_LAUNCHER.routes)


def last_single_route():
    """(route, cluster size or None) of the last K1 program on the card."""
    return _LAUNCHER.last_route


def build_kernel() -> None:
    """Build (or load the cached build of) the CUDA library now."""
    _LAUNCHER.lib()


def _program_dims(shapes: dict, m: int, explain: bool, n: int) -> dict:
    """PlaceArgs' integer dims of one program from its field shapes (no
    leading program axis)."""
    c, v = shapes["lut"]
    return dict(
        c=c, v=v, a=shapes["aff_lut"][0], av=shapes["aff_lut"][1], m=m,
        pn=shapes["penalty_idx"][1], e=shapes["extra_mask"][0],
        j=shapes["jc_idx"][0], j2=shapes["jtc_idx"][0],
        d=shapes["delta_idx"][0], l=shapes["cand_idx"][0],
        p=shapes["dp_key_idx"][0], dv=shapes["dp_counts0"][1],
        pp=shapes["res_ports"][0], pc=shapes["pclr_idx"][0],
        ps=shapes["pset_idx"][0], s=shapes["spread_key_idx"][0],
        sv=shapes["spread_desired"][1], cw=max((c + 31) // 32, 1),
        explain=int(explain), topk=min(EXPLAIN_TOPK, n))


def _set_cluster(a: _PlaceArgs, cluster: ClusterArrays) -> None:
    """The cluster fields; a None field (one a kernel does not read, as
    K3 reads no port bitmap) becomes a null pointer."""
    for name, t in cluster._asdict().items():
        setattr(a, name, None if t is None else t.data_ptr())
    a.n, a.r = cluster.capacity.shape
    a.k_cols = cluster.attrs.shape[1]
    a.port_words = (0 if cluster.ports_used is None
                    else cluster.ports_used.shape[1])
    a.attrs_i32 = int(cluster.attrs.dtype == torch.int32)


def _set_ptrs(a: _PlaceArgs, ptrs: dict) -> None:
    for name, ptr in ptrs.items():
        if name not in _ARG_FIELDS:
            raise KeyError(f"PlaceArgs has no field {name!r}")
        setattr(a, name, ptr)


def _scratch_shapes(dims: dict, n: int, r: int, explain: bool,
                    onchip: bool = False, flat: bool = False) -> dict:
    """Per-program scratch and outputs of the kernels: name → (shape,
    dtype). The `lane` group is per lane of a chain (the carry-dependent
    working set), the rest per program. `onchip` (K6's on-chip route,
    csrc/batch.cu): sel_idx and sel_score alone. `flat` (the chain and
    wave lane route, csrc/lanes.cu): the flat outputs alone, no scratch."""
    u8, f32, i32 = torch.uint8, torch.float32, torch.int32
    m, c, k = dims["m"], dims["c"], dims["topk"]
    sel = dict(sel_idx=(m, i32), sel_score=(m, f32))
    if onchip:
        return {"prog": sel, "lane": {}}
    out = dict(sel, nodes_feasible=((), i32), nodes_fit=(m, i32))
    ex = {}
    if explain:
        ex = dict(
            ex_static=(3, i32), filt_constraint=(max(c, 1), i32),
            filt_distinct=(m, i32), filt_dp=(m, i32), exh_dim=((m, r), i32),
            exh_dyn=(m, i32), exh_res=(m, i32), topk_idx=((m, k), i32),
            topk_score=((m, k), f32), topk_parts=((m, k, 5), f32))
    if flat:
        return {"prog": dict(out, **ex), "lane": {}}
    prog = dict(
        feas=(n, u8), flags=(n, u8), cfail=((n, dims["cw"]), i32),
        aff=(n, f32), res_free=(n, u8), job_cnt=(n, f32),
        tg_cnt=(n, f32), splaced=(n, f32),
        stok=((n, max(dims["s"], 1)), i32),
        dtok=((n, max(dims["p"], 1)), i32), **out, final0=(n, f32), **ex)
    lane = dict(dyn=(n, f32), mbuf=(n, f32), okbuf=(n, u8),
                parts=((n, 5) if explain else 1, f32))
    return {"prog": prog, "lane": lane}


def _explain_out(ex: dict, c: int) -> PlacementExplain:
    """PlacementExplain over the kernels' explain buffers (a leading
    program axis, if any, is kept)."""
    st = ex["ex_static"]
    return PlacementExplain(
        nodes_evaluated=st[..., 0], filt_constraint=ex["filt_constraint"][
            ..., :c],
        filt_lut=st[..., 1], filt_extra=st[..., 2],
        filt_distinct=ex["filt_distinct"], filt_dp=ex["filt_dp"],
        exh_dim=ex["exh_dim"], exh_dyn_ports=ex["exh_dyn"],
        exh_res_ports=ex["exh_res"], topk_idx=ex["topk_idx"],
        topk_score=ex["topk_score"], topk_parts=ex["topk_parts"])


def place_task_group_cuda(cluster: ClusterArrays, p: TGParams,
                          max_allocs: int, explain: bool = False,
                          clusters: Optional[int] = None) -> PlacementResult:
    """Run a hand-written kernel on CUDA tensors. `clusters` None: the
    route by shape — the lane route (csrc/lanes.cu, one launch: the
    program as one lane of `lane_route(n, 1, ...)` blocks, its rows in
    shared memory) where its layout fits, else placement.cu (a static
    pass over the rows, then the M-step scan in one block); 0:
    placement.cu; C > 0: the lane route at cluster size C (the card tests
    and chip_smoke.py hold the routes against each other). The two routes
    are bitwise equal. Raises when the build or the launch fails; never
    falls back."""
    if cluster.used.device.type != "cuda":
        raise ValueError("place_task_group_cuda needs CUDA tensors")
    _check_inputs(cluster, p, max_allocs)
    cluster = ClusterArrays(*(t.contiguous() for t in cluster))
    p = TGParams(*(t.contiguous() for t in p))
    dev = cluster.used.device
    n, r = cluster.capacity.shape
    dims = _program_dims({f: tuple(t.shape) for f, t in p._asdict().items()},
                         max_allocs, explain, n)
    if clusters is None:
        clusters = lane_route(n, 1, dims, r, torch.cuda.get_device_properties(
            dev).multi_processor_count)
    # the lane route's outputs alone; placement.cu's scratch besides
    shapes = _scratch_shapes(dims, n, r, explain, flat=bool(clusters))
    bufs = {name: torch.empty(shape, dtype=dt, device=dev)
            for group in shapes.values()
            for name, (shape, dt) in group.items()}
    bufs["new_used"] = torch.empty((n, r), dtype=torch.float32, device=dev)
    if clusters:
        bufs["final0"] = torch.empty(n, dtype=torch.float32, device=dev)

    a = _PlaceArgs()
    _set_cluster(a, cluster)
    _set_ptrs(a, {f: t.data_ptr() for f, t in p._asdict().items()})
    _set_ptrs(a, {f: t.data_ptr() for f, t in bufs.items()})
    for name, val in dims.items():
        setattr(a, name, val)

    if clusters:
        _launch_single_lane(a, cluster, bufs["new_used"], dims, clusters)
    else:
        _LAUNCHER.launch(a, dev)

    return PlacementResult(
        sel_idx=bufs["sel_idx"], sel_score=bufs["sel_score"],
        new_used=bufs["new_used"], nodes_feasible=bufs["nodes_feasible"],
        nodes_fit=bufs["nodes_fit"], final_scores0=bufs["final0"],
        explain=_explain_out(bufs, dims["c"]) if explain else None)


def _launch_single_lane(a: _PlaceArgs, cluster: ClusterArrays,
                        new_used: torch.Tensor, dims: dict,
                        clusters: int) -> None:
    """K1's program `a` (its outputs, final0 and new_used among them) as
    one lane of the lane route at cluster size `clusters`: its argument
    block staged to the card, one launch; the kernel writes the carry's
    used into `new_used` and keeps no dyn_free carry (K1 returns none)."""
    from ..convert import to_device_async

    dev = cluster.used.device
    n, r = cluster.capacity.shape
    rows = lane_rows(n, clusters)
    host = np.frombuffer(bytearray(a), dtype=_ARGS_DTYPE)
    _LANES.check_layout(host, rows, dims, r, clusters)
    dev_args = to_device_async(host.view(np.uint8), dev)
    run = _LaneRun(lanes=1, per_lane=1, clusters=clusters, rows=rows, n=n,
                   r=r, fold=0, used0=cluster.used.data_ptr(),
                   dyn0=cluster.dyn_free.data_ptr(),
                   carry_used=new_used.data_ptr(),
                   out_used=new_used.data_ptr())

    def count(k):
        _LAUNCHER.kernels += k

    _LANES.launch(host, dev_args.data_ptr(), run, dev, count)
    _LAUNCHER.dispatched("cluster", clusters)


def place_task_group(cluster: ClusterArrays, p: TGParams, max_allocs: int,
                     explain: bool = False) -> PlacementResult:
    """Place up to `max_allocs` allocs of one task group: the plain version
    for CPU tensors, the CUDA kernel for CUDA tensors; on a sharded view
    the sharded single program (B11, kernels/shard.py)."""
    shard = _sharded_routes(cluster)
    if shard is not None:
        return shard.sharded_task_group(cluster, p, max_allocs, explain)
    kind = cluster.used.device.type
    if kind == "cpu":
        return place_task_group_plain(cluster, p, max_allocs, explain)
    if kind == "cuda":
        return place_task_group_cuda(cluster, p, max_allocs, explain)
    raise ValueError(f"no placement implementation for device {kind!r}")


# ---- system-scheduler masks (K2) ---------------------------------------------


def constraint_mask(cluster: ClusterArrays, p: TGParams) -> torch.Tensor:
    """bool[N]: node_ok & extra_mask & every constraint LUT row (the
    static mask K2 and K3 start from; no sampled-candidate set)."""
    feas = cluster.node_ok & p.extra_mask
    if p.lut.shape[0]:
        feas = feas & torch.all(_lookup(p.lut, _tokens(
            cluster.attrs, p.key_idx, p.lut.shape[1])), dim=1)
    return feas


def system_feasibility_plain(cluster: ClusterArrays, p: TGParams):
    """(constraint-feasible, feasible-and-fits) bool[N] per node row, in
    plain PyTorch: the reference's `system_feasibility`
    (`nomad_tpu/kernels/placement.py:957`, system_sched.go:268 — per-node
    feasibility and fit, no ranking across nodes). The gap between the two
    masks is the system scheduler's preemption candidate set."""
    n = cluster.capacity.shape[0]
    feas = constraint_mask(cluster, p)
    used = cluster.used
    if p.delta_idx.shape[0]:
        used = used - _scatter(p.delta_idx, p.delta_res, n)
    util = used + p.ask[None, :]
    fits = torch.all(util <= cluster.capacity, dim=1)
    fits = fits & (_dyn_free_adjusted(cluster, p) >= p.n_dyn) \
        & _reserved_ports_free(cluster, p)
    return feas, feas & fits


def program_args(cluster: ClusterArrays, p: TGParams) -> _PlaceArgs:
    """PlaceArgs of one program over `cluster`, with no scratch or output
    pointers: what the row kernels K2 and K3 read."""
    a = _PlaceArgs()
    _set_cluster(a, cluster)
    _set_ptrs(a, {f: t.data_ptr() for f, t in p._asdict().items()})
    dims = _program_dims({f: tuple(t.shape) for f, t in p._asdict().items()},
                         p.penalty_idx.shape[0], False, a.n)
    for name, val in dims.items():
        setattr(a, name, val)
    return a


class _RowLauncher:
    """A one-entry-point library (`csrc/<name>.cu` over PlaceArgs), built
    at first use, and its launch count on the main path."""

    def __init__(self, name: str, entry: str, argtypes: list):
        self.name, self.entry, self.argtypes = name, entry, argtypes
        self.launches = 0
        self._lib = None

    def lib(self):
        if self._lib is None:
            from ._build import load_library

            lib = load_library(self.name)
            size = getattr(lib, f"nomad_{self.name}_args_size")
            size.restype, size.argtypes = ctypes.c_size_t, []
            fn = getattr(lib, self.entry)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.POINTER(_PlaceArgs), *self.argtypes, _VOID]
            err = getattr(lib, f"nomad_{self.name}_error_string")
            err.restype, err.argtypes = ctypes.c_char_p, [ctypes.c_int]
            if size() != ctypes.sizeof(_PlaceArgs):
                raise RuntimeError(
                    f"{self.name} library's PlaceArgs layout differs from "
                    f"the wrapper's (rebuild csrc/{self.name}.cu)")
            self._lib = lib
        return self._lib

    def launch(self, args: _PlaceArgs, *ptrs, device) -> None:
        """Enqueue the entry point on `device`'s current stream; raises on
        a refused launch."""
        lib = self.lib()
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, self.entry)(ctypes.byref(args), *ptrs, stream)
        if err != 0:
            raise RuntimeError(
                f"{self.name} kernel launch failed: "
                + getattr(lib, f"nomad_{self.name}_error_string")(
                    err).decode())
        self.launches += 1


class _SystemRun(ctypes.Structure):
    """Mirror of `SystemRun` in csrc/system.cu."""

    _fields_ = [("run_size", _INT), ("args_size", _INT), ("blocks", _INT),
                ("rows", _INT), ("n", _INT), ("row0", _VOID), ("out", _VOID)]


class _SystemLauncher(_RowLauncher):
    """csrc/system.cu: the masks kernel over argument blocks
    (`nomad_system_masks`, K2 and B12) beside the old one-program pass
    (`nomad_system_feasibility`); one launch count for both."""

    def lib(self):
        if self._lib is None:
            lib = super().lib()
            lib.nomad_system_run_size.restype = ctypes.c_size_t
            lib.nomad_system_run_size.argtypes = []
            if lib.nomad_system_run_size() != ctypes.sizeof(_SystemRun):
                raise RuntimeError(
                    "system library's SystemRun layout differs from the "
                    "wrapper's (rebuild csrc/system.cu)")
            lib.nomad_system_masks.restype = ctypes.c_int
            lib.nomad_system_masks.argtypes = [
                _INT, _VOID, _VOID, _VOID, ctypes.c_size_t, _VOID,
                ctypes.POINTER(_SystemRun), _VOID, _VOID]
        return self._lib

    def masks(self, index: int, args: np.ndarray, src: int, dst: int,
              nbytes: int, run: _SystemRun, done) -> None:
        """One `nomad_system_masks` call on CUDA device `index`'s current
        stream: the staged copy of `nbytes` from pinned `src` to `dst`,
        `system_rows` over the argument blocks at the start of `dst`
        (`args` their host copy), then event `done`. Raises when the
        library refuses it (the run carries the wrapper's struct sizes,
        checked at every launch)."""
        lib = self.lib()
        # the device's current stream, as torch.cuda.current_stream(dev)
        # .cuda_stream reads it, without building a Stream object
        stream = torch._C._cuda_getCurrentRawStream(index)
        err = lib.nomad_system_masks(
            index, args.ctypes.data, src, dst, nbytes, dst,
            ctypes.byref(run), stream, done.cuda_event)
        if err != 0:
            raise RuntimeError("system masks kernel launch failed: "
                               + lib.nomad_system_error_string(err).decode())
        self.launches += 1


_SYSTEM = _SystemLauncher("system", "nomad_system_feasibility",
                          [_VOID, _VOID])


def system_launch_count() -> int:
    """Launches of csrc/system.cu since the last reset: K2's and B12's
    (one a card a call) and the old pass's."""
    return _SYSTEM.launches


def reset_system_launch_count() -> None:
    _SYSTEM.launches = 0


def build_system_kernel() -> None:
    """Build (or load the cached build of) the K2 library now."""
    _SYSTEM.lib()


def _tensor_program(p, dev) -> TGParams:
    """Program `p` as tensors: as given when every field is one, else the
    numpy program (`compile_tg`'s) converted onto `dev`."""
    if all(isinstance(t, torch.Tensor) for t in p):
        return p
    from ..convert import params_from_numpy

    return params_from_numpy(p, dev)


def _check_program(shapes: dict, n: int, r: int) -> None:
    """Raises unless the shapes of the fields the masks kernel reads agree
    with each other and with a view of n rows of R resources."""
    if shapes["ask"] != (r,):
        raise ValueError(f"the program's ask has shape {shapes['ask']}, "
                         f"the view R = {r}")
    if len(shapes["extra_mask"]) != 1 or shapes["extra_mask"][0] not in (
            1, n):
        raise ValueError("extra_mask must have 1 or N entries")
    if (len(shapes["lut"]) != 2
            or shapes["key_idx"] != shapes["lut"][:1]
            or shapes["delta_res"] != shapes["delta_idx"] + (r,)
            or shapes["pclr_port"] != shapes["pclr_idx"]
            or shapes["pset_port"] != shapes["pset_idx"]):
        raise ValueError("the program's constraint, delta or port fields "
                         "disagree in shape")


#: PlaceArgs' byte offset of every member (csrc/place_core.cuh)
_ARG_OFFSETS = {name: getattr(_PlaceArgs, name).offset
                for name, _t in _PlaceArgs._fields_}
#: the program fields the masks kernel reads (csrc/system.cu with its
#: place_core.cuh row helpers): only these are checked, staged and
#: pointed at; an argument block's other program pointers stay null
SYSTEM_FIELDS = ("ask", "n_dyn", "key_idx", "lut", "extra_mask",
                 "delta_idx", "delta_res", "res_ports", "pclr_idx",
                 "pclr_port", "pset_idx", "pset_port")
#: the program fields the preemption ranking reads (csrc/preempt.cu with
#: its place_core.cuh row helpers), staged and pointed at the same way
PREEMPT_FIELDS = ("ask", "key_idx", "lut", "extra_mask", "distinct_hosts",
                  "jc_idx", "jc_val", "delta_idx", "delta_res",
                  "dp_key_idx", "dp_allowed", "dp_counts0", "dp_active")
#: 8-byte words of those pointers and of the cluster's in a block
_SYSTEM_WORDS = np.array([_ARG_OFFSETS[f] // 8 for f in SYSTEM_FIELDS])
_CLUSTER_WORDS = np.array([_ARG_OFFSETS[f] // 8
                           for f in ClusterArrays._fields])
#: the fields whose shapes give the program's dims (`_program_dims`) or
#: are checked (`_check_program`)
_DIM_FIELDS = ("lut", "aff_lut", "penalty_idx", "extra_mask", "jc_idx",
               "jtc_idx", "delta_idx", "cand_idx", "dp_key_idx",
               "dp_counts0", "res_ports", "pclr_idx", "pset_idx",
               "spread_key_idx", "spread_desired", "ask", "key_idx",
               "delta_res", "pclr_port", "pset_port")
#: each read field's kernel type, as a tensor and on the host
_SYSTEM_TYPES = tuple(PARAM_TYPES[f] for f in SYSTEM_FIELDS)
_NP_OF = {torch.float32: np.dtype(np.float32), torch.int32: np.dtype(np.int32),
          torch.bool: np.dtype(np.bool_)}
_PAD = bytes(16)
_ARG_WORDS = ctypes.sizeof(_PlaceArgs) // 8
#: the int members a launch fills: `_program_dims`' keys in its order,
#: then the cluster's
_DIM_INTS = np.array([_ARG_OFFSETS[k] // 4 for k in (
    *_program_dims({f: (1, 1) for f in TGParams._fields}, 1, False, 1),
    "n", "r", "k_cols", "port_words", "attrs_i32")])


def system_args(shards, row0s, n: int, ptrs, shapes: dict) -> np.ndarray:
    """The argument blocks of one `system_rows` launch, one a node shard,
    as uint64 words [S, sizeof(PlaceArgs) / 8] (`.view(_ARGS_DTYPE)`
    reads them as PlaceArgs records): the pointers `ptrs` of the program
    fields the kernel reads (`SYSTEM_FIELDS` order; the others null), the
    program's dims (from `shapes`, no leading axis) with n the global
    rows, and shard k's cluster pointers moved back row0s[k] rows, so that
    global row g of the shard lies g rows past each of them
    (csrc/system.cu). Filled a column at a time."""
    first = shards[0]
    words = np.zeros((len(shards), _ARG_WORDS), dtype=np.uint64)
    words[:, _SYSTEM_WORDS] = ptrs
    row = [t.stride(0) * t.element_size() for t in first]
    words[:, _CLUSTER_WORDS] = [[t.data_ptr() - r0 * b
                                 for t, b in zip(sh, row)]
                                for sh, r0 in zip(shards, row0s)]
    dims = _program_dims(shapes, shapes["penalty_idx"][0], False, n)
    words.view(np.int32)[:, _DIM_INTS] = list(dims.values()) + [
        n, first.capacity.shape[1], first.attrs.shape[1],
        first.ports_used.shape[1], int(first.attrs.dtype == torch.int32)]
    return words


def _shape(v) -> tuple:
    return tuple(v.shape) if isinstance(v, torch.Tensor) else np.shape(v)


def program_bytes(p, fields=SYSTEM_FIELDS):
    """The fields of program `p` that a row kernel reads (`fields`: the
    masks kernel's `SYSTEM_FIELDS` or the ranking's `PREEMPT_FIELDS`;
    numpy, as `compile_tg` returns them, or tensors, brought to the host)
    as one byte string for the staged copy: each in its kernel type at a
    16-byte boundary. Returns (the bytes as uint8, each field's offset)."""
    chunks, offs, at = [], [], 0
    for name in fields:
        dt = _NP_OF[PARAM_TYPES[name]]
        v = getattr(p, name)
        a = np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
        b = (a if a.dtype == dt else a.astype(dt)).tobytes()
        offs.append(at)
        pad = -len(b) % 16
        chunks += (b, _PAD[:pad])
        at += len(b) + pad
    return np.frombuffer(b"".join(chunks), dtype=np.uint8), offs


def system_stage(shards, row0s, n: int, p):
    """One `system_rows` launch's staged copy over node shards `shards`
    (first global rows `row0s`) of a view of `n` rows: (parts, blocks).
    `parts` are numpy arrays — room for the argument blocks, one a shard;
    the shards' first rows (int32); and, unless the fields the kernel
    reads are tensors on the shards' device (then read in place), those
    fields as one byte string (`program_bytes`). `blocks(addr)`, given
    each part's device address, returns the argument blocks
    (`system_args`), which point at the program. Raises when the program
    does not fit the view."""
    first = shards[0]
    index = first.used.get_device()
    tensors, ptrs = [getattr(p, f) for f in SYSTEM_FIELDS], []
    for i, (t, dt) in enumerate(zip(tensors, _SYSTEM_TYPES)):
        if not isinstance(t, torch.Tensor) or t.get_device() != index:
            break
        if t.dtype is not dt:
            raise TypeError(f"params.{SYSTEM_FIELDS[i]} must be {dt}")
        if not t.is_contiguous():
            t = tensors[i] = t.contiguous()
        ptrs.append(t.data_ptr())
    in_place = len(ptrs) == len(tensors)
    parts = [np.empty((len(shards), _ARG_WORDS), dtype=np.uint64),
             np.asarray(row0s, dtype=np.int32)]
    if not in_place:
        blob, offs = program_bytes(p)
        parts.append(blob)
    shapes = {f: _shape(getattr(p, f)) for f in _DIM_FIELDS}
    _check_program(shapes, n, first.capacity.shape[1])

    def blocks(addr, _keep=tensors) -> np.ndarray:
        return system_args(shards, row0s, n, ptrs if in_place
                           else [addr[2] + o for o in offs], shapes)

    return parts, blocks


def system_masks_on(shards, row0s, n: int, p) -> torch.Tensor:
    """csrc/system.cu's `system_rows` in one launch over the node shards
    `shards` (ClusterArrays on one CUDA device, contiguous, of equal rows;
    their first global rows `row0s`) of a view of `n` rows: bool [2, n] on
    that device, row 0 constraint-feasible, row 1 feasible-and-fits,
    written at the shards' rows. Program `p` as tensors on the device is
    read in place; otherwise (the numpy `TGParams` that `compile_tg`
    returns, or tensors elsewhere) the fields the kernel reads go as one
    byte string (`program_bytes`). The argument blocks and those bytes go
    to the card in one staged copy (`system_stage`), enqueued with the
    launch in one library call. Raises when the build or the launch
    fails; never falls back."""
    first = shards[0]
    _check_cluster(first)
    index = first.used.get_device()
    like = [(t.dtype, t.shape) for t in first]
    for sh in shards[1:]:
        for t, (dt, shape) in zip(sh, like):
            if (t.get_device() != index or t.dtype != dt or t.shape != shape
                    or not t.is_contiguous()):
                raise ValueError("the node shards of one launch must share "
                                 "a device, types and shapes, contiguous")
    parts, blocks = system_stage(shards, row0s, n, p)
    dev = first.used.device
    buf, addr, upload = _staged(parts, dev)
    args = blocks(addr)
    out = torch.empty((2, n), dtype=torch.bool, device=dev)
    run = _SystemRun(run_size=ctypes.sizeof(_SystemRun),
                     args_size=ctypes.sizeof(_PlaceArgs), blocks=len(shards),
                     rows=first.capacity.shape[0], n=n, row0=addr[1],
                     out=out.data_ptr())
    # the staged copy, the launch and the ring's event in one library call
    upload([args] + parts[1:], lambda host, total, done: _SYSTEM.masks(
        index, args, host.data_ptr(), addr[0], total, run, done))
    # the staged buffer may be freed now: the caching allocator hands its
    # memory only to work queued after this launch on the same stream
    del buf
    return out


def system_feasibility_cuda(cluster: ClusterArrays, p) -> torch.Tensor:
    """K2 on CUDA tensors: `system_masks_on` with one argument block at
    row 0 (`csrc/system.cu` `system_rows`). bool [2, N]."""
    if cluster.used.device.type != "cuda":
        raise ValueError("system_feasibility_cuda needs CUDA tensors")
    return system_masks_on([cluster], [0], cluster.capacity.shape[0], p)


def system_pass_cuda(cluster: ClusterArrays, p: TGParams) -> torch.Tensor:
    """K2's old route, kept to hold and time `system_feasibility_cuda`
    against: `csrc/system.cu` `system_pass` (the PlaceArgs by value, a
    fixed 256-thread block, every program field read from global memory)
    on a program of tensors on the cluster's card. bool [2, N]; raises
    when the build or the launch fails."""
    if cluster.used.device.type != "cuda":
        raise ValueError("system_pass_cuda needs CUDA tensors")
    _check_inputs(cluster, p, p.penalty_idx.shape[0])
    cluster = ClusterArrays(*(t.contiguous() for t in cluster))
    p = TGParams(*(t.contiguous() for t in p))
    dev = cluster.used.device
    out = torch.empty((2, cluster.capacity.shape[0]), dtype=torch.bool,
                      device=dev)
    _SYSTEM.launch(program_args(cluster, p), out[0].data_ptr(),
                   out[1].data_ptr(), device=dev)
    return out


def system_feasibility(cluster, p, route: Optional[str] = None):
    """(constraint-feasible, feasible-and-fits) as one bool [2, N] (rows 0
    and 1; it unpacks as the pair): the plain version for CPU tensors, K2
    (`system_feasibility_cuda`) for CUDA tensors, and on a sharded view
    B12 (`kernels/shard.py` `sharded_system_feasibility`, which alone
    takes a `route`). `p` is the program as tensors or as the numpy
    `TGParams` that `compile_tg` returns: on the card it goes in K2's one
    staged copy, on the CPU it is converted."""
    shard = _sharded_routes(cluster)
    if shard is not None:
        return shard.sharded_system_feasibility(cluster, p, route)
    if route is not None:
        raise ValueError(f"route {route!r} needs a sharded view")
    kind = cluster.used.device.type
    if kind == "cpu":
        return torch.stack(system_feasibility_plain(
            cluster, _tensor_program(p, "cpu")))
    if kind == "cuda":
        return system_feasibility_cuda(cluster, p)
    raise ValueError(f"no system_feasibility implementation for {kind!r}")


# ---- chains and waves of programs (K4, K5) ------------------------------------
# The batched server path runs programs in CHAINS: program b places against
# the (used, dyn_free) carry that programs 0..b-1 left, so a batch of evals
# never over-commits a node. A WAVE runs L such chains (lanes) side by side
# and folds their carries row by row. Programs arrive in three layouts:
#   - a stacked TGParams ([B, ...] fields): `place_task_group_chain`;
#   - field-major packed buffers (`pack_params` of a stacked batch):
#     `place_packed_chain`, the coordinator's fallback transport;
#   - rows of the device program table (static halves) plus per-program
#     dynamic rows: `place_table_chain` and `place_table_wave`.
# Each has a plain PyTorch version (a Python loop over
# `place_task_group_plain` with the carry update and fold written in torch)
# and a CUDA route, chosen by the device of cluster.used: the lane route
# (`csrc/lanes.cu`, below) by shape, else `csrc/chain.cu`.


def _field_views(bufs: dict, spec) -> dict:
    """{name: tensor} from class buffers [..., L] and a row spec (name,
    class, offset, shape): static column slices, u8 read as bool."""
    out = {}
    for name, cls, off, shape in spec:
        size = int(np.prod(shape)) if shape else 1
        seg = bufs[cls][..., off:off + size]
        a = seg.reshape(tuple(seg.shape[:-1]) + tuple(shape))
        out[name] = (a != 0) if cls == "u" else a
    return out


def host_rows(rows) -> np.ndarray:
    """Table row indices on the host (a CUDA tensor is copied back)."""
    if isinstance(rows, torch.Tensor):
        rows = rows.cpu().numpy()
    return np.asarray(rows, dtype=np.int64)


def _assemble_table_batch(ti, tf, tu, rows, di, df, du, sspec, dspec
                          ) -> TGParams:
    """Batched TGParams from table rows and dynamic rows: the static
    half gathered by row (`rows` i64[B]), both halves unpacked."""
    idx = torch.as_tensor(host_rows(rows), device=ti.device)
    fields = _field_views({"i": ti[idx], "f": tf[idx], "u": tu[idx]}, sspec)
    fields.update(_field_views({"i": di, "f": df, "u": du}, dspec))
    return TGParams(**fields)


def _unpack_params(i32buf, f32buf, u8buf, spec) -> TGParams:
    """TGParams from field-major packed buffers (`pack_params`)."""
    fields = {}
    bufs = {"i": i32buf, "f": f32buf, "u": u8buf}
    for name, cls, off, shape in spec:
        size = int(np.prod(shape)) if shape else 1
        a = bufs[cls][off:off + size].reshape(tuple(shape))
        fields[name] = (a != 0) if cls == "u" else a
    return TGParams(**fields)


def _program(batch: TGParams, b: int) -> TGParams:
    return TGParams(*(t[b] for t in batch))


def _stack_results(results) -> PlacementResult:
    ex = None
    if results[0].explain is not None:
        ex = PlacementExplain(*(torch.stack(leaf) for leaf in
                                zip(*(r.explain for r in results))))
    return PlacementResult(*(torch.stack(f) for f in
                             zip(*(r[:6] for r in results))), explain=ex)


def _chain_with_carry(cluster: ClusterArrays, batch: TGParams,
                      max_allocs: int, explain: bool = False):
    """Plain chain over the leading program axis of `batch`; returns the
    per-program results (stacked) and the final (used, dyn_free) carry.
    The dyn_free carry update is `dyn - placed * n_dyn` in f32, with
    `placed` the count of this program's selections on each row."""
    n = cluster.used.shape[0]
    used, dyn = cluster.used, cluster.dyn_free
    results = []
    for b in range(batch.n_place.shape[0]):
        p = _program(batch, b)
        r = place_task_group_plain(cluster._replace(used=used, dyn_free=dyn),
                                   p, max_allocs, explain)
        sel = r.sel_idx.long()
        placed = torch.zeros(n, dtype=torch.float32, device=dyn.device)
        placed = placed.index_add_(0, sel.clamp(min=0),
                                   (sel >= 0).float())
        used, dyn = r.new_used, dyn - placed * p.n_dyn
        results.append(r)
    return _stack_results(results), (used, dyn)


def _flat_outputs(r: PlacementResult, explain: bool) -> tuple:
    base = (r.sel_idx, r.sel_score, r.nodes_feasible, r.nodes_fit)
    return base + tuple(r.explain) if explain else base


def place_task_group_chain_plain(cluster, batch, max_allocs, explain=False):
    return _chain_with_carry(cluster, batch, max_allocs, explain)[0]


def place_packed_chain_plain(cluster, i32buf, f32buf, u8buf, spec,
                             max_allocs, explain=False):
    batch = _unpack_params(i32buf, f32buf, u8buf, spec)
    return _flat_outputs(place_task_group_chain_plain(
        cluster, batch, max_allocs, explain), explain)


def place_table_chain_plain(cluster, ti, tf, tu, rows, di, df, du, sspec,
                            dspec, max_allocs, explain=False):
    batch = _assemble_table_batch(ti, tf, tu, rows, di, df, du, sspec, dspec)
    r, carry = _chain_with_carry(cluster, batch, max_allocs, explain)
    return _flat_outputs(r, explain), carry


def place_table_wave_plain(cluster, ti, tf, tu, rows, di, df, du, sspec,
                           dspec, max_allocs, explain=False):
    """L lane chains (rows i64[L, P], dynamic rows [L, P, Ld]) and the
    fold: a row's final (used, dyn_free) is copied bitwise from the
    highest-numbered lane that changed it (else the view's), and rows
    changed by more than one lane are counted (the last output, i32)."""
    rows = host_rows(rows)
    outs, used_l, dyn_l = [], [], []
    for lane in range(rows.shape[0]):
        batch = _assemble_table_batch(ti, tf, tu, rows[lane], di[lane],
                                      df[lane], du[lane], sspec, dspec)
        r, (u, d) = _chain_with_carry(cluster, batch, max_allocs, explain)
        outs.append(_flat_outputs(r, explain))
        used_l.append(u)
        dyn_l.append(d)
    used0, dyn0 = cluster.used, cluster.dyn_free
    used_l, dyn_l = torch.stack(used_l), torch.stack(dyn_l)
    changed = torch.any(used_l != used0[None], dim=-1) | (dyn_l != dyn0[None])
    collisions = (changed.to(torch.int32).sum(dim=0) > 1).sum().to(
        torch.int32)
    used_f, dyn_f = used0, dyn0
    for lane in range(rows.shape[0]):
        m = changed[lane]
        used_f = torch.where(m[:, None], used_l[lane], used_f)
        dyn_f = torch.where(m, dyn_l[lane], dyn_f)
    flat = tuple(torch.cat(leaf) for leaf in zip(*outs))
    return flat + (collisions,), (used_f, dyn_f)


class _ChainLaneArgs(ctypes.Structure):
    """Mirror of `LaneArgs` in csrc/chain.cu."""

    _fields_ = [("used0", _VOID), ("dyn0", _VOID), ("n", _INT), ("r", _INT),
                ("used_l", _VOID), ("dyn_l", _VOID), ("used_snap", _VOID),
                ("used_f", _VOID), ("dyn_f", _VOID), ("collisions", _VOID)]


class _ChainLauncher:
    """The chain/wave library (csrc/chain.cu), built at first use, and
    the dispatch counts of K4 (chains), K5 (waves) and K6 (batches); the
    kernel launches of K4's and K5's dispatches on either route, and the
    route each took (chain.cu's "lanes", or lanes.cu's "cluster")."""

    def __init__(self):
        self.launches = {"chain": 0, "wave": 0, "batch": 0}
        self.kernels = {"chain": 0, "wave": 0}
        self.routes = {"cluster": 0, "lanes": 0}
        self.last_route = None
        self._lib = None

    def lib(self):
        if self._lib is None:
            from ._build import load_library

            lib = load_library("chain")
            for fn in ("nomad_chain_args_size", "nomad_chain_lane_args_size"):
                getattr(lib, fn).restype = ctypes.c_size_t
                getattr(lib, fn).argtypes = []
            lib.nomad_place_lanes.restype = ctypes.c_int
            lib.nomad_place_lanes.argtypes = [
                ctypes.POINTER(_PlaceArgs), _VOID, _INT, _INT,
                ctypes.POINTER(_ChainLaneArgs), _INT, _VOID]
            lib.nomad_place_batch.restype = ctypes.c_int
            lib.nomad_place_batch.argtypes = [
                ctypes.POINTER(_PlaceArgs), _VOID, _INT,
                ctypes.POINTER(_ChainLaneArgs), _VOID]
            lib.nomad_place_batch_pooled.restype = ctypes.c_int
            lib.nomad_place_batch_pooled.argtypes = [
                ctypes.POINTER(_PlaceArgs), _VOID, _INT, _INT,
                ctypes.POINTER(_ChainLaneArgs), _VOID]
            lib.nomad_chain_error_string.restype = ctypes.c_char_p
            lib.nomad_chain_error_string.argtypes = [ctypes.c_int]
            if (lib.nomad_chain_args_size() != ctypes.sizeof(_PlaceArgs)
                    or lib.nomad_chain_lane_args_size()
                    != ctypes.sizeof(_ChainLaneArgs)):
                raise RuntimeError(
                    "chain library's argument layout differs from the "
                    "wrapper's (rebuild csrc/chain.cu)")
            self._lib = lib
        return self._lib


_CHAIN = _ChainLauncher()


def chain_launch_count() -> int:
    """K4 dispatches (chains of programs) since the last reset."""
    return _CHAIN.launches["chain"]


def wave_launch_count() -> int:
    """K5 dispatches (waves of lane chains) since the last reset."""
    return _CHAIN.launches["wave"]


def batch_launch_count() -> int:
    """K6 dispatches through csrc/chain.cu (`place_task_group_batch`, and
    `place_packed_batch` on its pooled route) since the last reset; the
    on-chip route counts in `onchip_launch_count`."""
    return _CHAIN.launches["batch"]


def chain_kernel_launches() -> dict:
    """Kernel launches of the K4 and K5 dispatches since the last reset,
    on either route: {"chain": ..., "wave": ...}. The lane route
    (csrc/lanes.cu) launches one kernel a chain and two a wave; chain.cu's
    two and three."""
    return dict(_CHAIN.kernels)


def chain_route_counts() -> dict:
    """K4 and K5 dispatches since the last reset by route: {"cluster":
    the lane route, "lanes": chain.cu's}."""
    return dict(_CHAIN.routes)


def last_chain_dispatch_route():
    """(route, cluster size or None) of the last K4 or K5 dispatch on the
    card: ("cluster", C) on the lane route, ("lanes", None) on chain.cu's."""
    return _CHAIN.last_route


def reset_chain_launch_counts() -> None:
    """Zero the K4, K5 and K6 counts (dispatches, kernel launches and
    routes), the on-chip K6 kernel's too."""
    _CHAIN.launches = {"chain": 0, "wave": 0, "batch": 0}
    _CHAIN.kernels = {"chain": 0, "wave": 0}
    _CHAIN.routes = {"cluster": 0, "lanes": 0}
    _ONCHIP.launches = 0


def build_chain_kernel() -> None:
    """Build (or load the cached build of) the chain/wave library now."""
    _CHAIN.lib()


_ESIZE = {"i": 4, "f": 4, "u": 1}


def _check_cluster(cluster: ClusterArrays) -> None:
    dev = cluster.used.device
    if dev.type != "cuda":
        raise ValueError("the chain kernels need CUDA tensors")
    for name, t in cluster._asdict().items():
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"cluster.{name} must be contiguous on {dev}")
    for name, dt in _CLUSTER_TYPES.items():
        if getattr(cluster, name).dtype != dt:
            raise TypeError(f"cluster.{name} must be {dt}")
    if cluster.attrs.dtype not in (torch.int16, torch.int32):
        raise TypeError("cluster.attrs must be int16 or int32")


def _check_class_buf(name, t, cls, dev):
    want = {"i": torch.int32, "f": torch.float32, "u": torch.uint8}[cls]
    if t.device != dev or t.dtype != want or not t.is_contiguous():
        raise TypeError(f"{name} must be contiguous {want} on {dev}")


#: PlaceArgs as a numpy record: a dispatch's argument blocks are filled a
#: field (a column) at a time
_ARGS_DTYPE = np.dtype(_PlaceArgs)


def _rows_ptrs(t: torch.Tensor, index) -> np.ndarray:
    """Device pointers of rows `index` (along dim 0) of tensor `t`."""
    return t.data_ptr() + np.asarray(index, np.int64) * (
        t.stride(0) * t.element_size())


def args_pointer(args: np.ndarray):
    """ctypes pointer to the first PlaceArgs block of `args`."""
    return args.ctypes.data_as(ctypes.POINTER(_PlaceArgs))


class _PinnedRing:
    """Pinned host buffers for staged copies, kept across calls and used
    in turn. A buffer is refilled only once the work last enqueued from it
    has run (an event recorded after it, one kept a buffer and device),
    so a caller waits at most on the copy SLOTS calls back, never on its
    own; a lock keeps two threads out of one buffer."""

    SLOTS = 4

    def __init__(self):
        self._lock = threading.Lock()
        self._host = [None] * self.SLOTS
        self._np = [None] * self.SLOTS
        self._done = [None] * self.SLOTS
        self._events: dict = {}
        self._next = 0

    def send(self, total: int, offs, parts, dev, enqueue) -> None:
        """Fill a kept buffer with `parts` at byte offsets `offs` (`total`
        bytes), then `enqueue(host, total, done)`: enqueue the copy of the
        first `total` bytes of pinned tensor `host` on the device's
        current stream and record event `done` there after it."""
        with self._lock:
            k = self._next
            self._next = (k + 1) % self.SLOTS
            if self._done[k] is not None:
                self._done[k].synchronize()
            host = self._host[k]
            if host is None or host.numel() < total:
                host = self._host[k] = torch.empty(
                    1 << max(12, (total - 1).bit_length()),
                    dtype=torch.uint8, pin_memory=True)
                self._np[k] = host.numpy()
            fill_stage(self._np[k], offs, parts)
            done = self._events.get((k, dev))
            if done is None:
                # recorded once here so that its handle exists on `dev`
                done = self._events[(k, dev)] = torch.cuda.Event()
                done.record(torch.cuda.current_stream(dev))
            enqueue(host, total, done)
            self._done[k] = done


_PINNED = _PinnedRing()


def stage_offsets(parts):
    """(byte offset of each of `parts`, total bytes): each part on a
    16-byte boundary, as one staged copy lays them out."""
    offs, total = [], 0
    for a in parts:
        offs.append(total)
        total = (total + a.nbytes + 15) & ~15
    return offs, total


def fill_stage(h: np.ndarray, offs, parts) -> None:
    """Write `parts` (numpy arrays) into the uint8 buffer `h` at `offs`."""
    for off, a in zip(offs, parts):
        h[off:off + a.nbytes] = np.ascontiguousarray(a).view(
            np.uint8).reshape(-1)


def _staged(parts, dev):
    """One device buffer holding `parts` (numpy arrays, `stage_offsets`):
    (the buffer, each part's device address, a function that fills a kept
    pinned host buffer (`_PinnedRing`) with the parts and enqueues the one
    copy on the device's current stream). Addresses are known before the
    bytes are, so that argument blocks can point into the buffer.
    `upload(filled, enqueue)` takes the ring's `enqueue(host, total,
    done)` in place of the torch copy (the system masks copy and launch in one
    library call)."""
    offs, total = stage_offsets(parts)
    buf = torch.empty(total, dtype=torch.uint8, device=dev)
    base = buf.data_ptr()

    def copy(host, size, done):
        with torch.cuda.device(dev):
            buf.copy_(host[:size], non_blocking=True)
            done.record()

    def upload(filled, enqueue=copy):
        _PINNED.send(total, offs, filled, dev, enqueue)

    return buf, [base + o for o in offs], upload


def _lane_args(cluster: ClusterArrays, shapes: dict, ptrs_of, lanes: int,
               per_lane: int, max_allocs: int, explain: bool,
               slots: Optional[int] = None, n_global: Optional[int] = None,
               onchip: bool = False, flat: bool = False):
    """The per-program scratch and outputs (leading axis lanes·per_lane),
    the per-lane scratch and used carries (leading axis lanes), and the
    programs' PlaceArgs, on the host and copied to the cluster's device
    on its current stream. `shapes` maps each TGParams field to its
    per-program shape; `ptrs_of(field)` gives every program's (lane-major)
    device pointer for that field, an int64 array. With `slots`, the lane
    buffers are a pool of that many, program k in slot k mod slots (K6's
    pooled route). With `onchip` (K6's on-chip route) only the outputs
    exist: no scratch, no lane buffers, no carry, and every scratch
    pointer is null; with `flat` (the lane route) only the flat outputs
    exist. `n_global` is the row count explain's top-K is sized
    for (a shard's view reports its part of the global one). Returns
    (dims, host args as a PlaceArgs record array, device args,
    per-program buffers, per-lane buffers, lane used carries or None)."""
    from ..convert import to_device_async
    from ..lib.transfer import default_ledger

    dev = cluster.used.device
    n, r = cluster.capacity.shape
    b = lanes * per_lane
    if shapes["penalty_idx"][0] != max_allocs \
            or shapes["preferred_idx"][0] != max_allocs:
        raise ValueError("penalty/preferred rows must equal max_allocs")
    if shapes["extra_mask"][0] not in (1, n) or shapes["ask"] != (r,):
        raise ValueError("program shapes disagree with the cluster")
    dims = _program_dims(shapes, max_allocs, explain,
                         n if n_global is None else n_global)
    groups = _scratch_shapes(dims, n, r, explain, onchip, flat)
    n_lanes = lanes if slots is None else slots
    if slots is not None:
        # the pooled route returns no step-0 score vector: it is slot
        # scratch there
        groups["lane"]["final0"] = groups["prog"].pop("final0")

    def alloc(count, shape, dt):
        shape = shape if isinstance(shape, tuple) else (shape,)
        return torch.empty((count,) + shape, dtype=dt, device=dev)

    prog = {k: alloc(b, sh, dt) for k, (sh, dt) in groups["prog"].items()}
    lane = {k: alloc(n_lanes, sh, dt)
            for k, (sh, dt) in groups["lane"].items()}
    used_l = (None if onchip or flat
              else alloc(n_lanes, (n, r), torch.float32))

    base = _PlaceArgs()
    _set_cluster(base, cluster)
    for name, val in dims.items():
        setattr(base, name, val)
    args = np.repeat(np.frombuffer(bytearray(base), dtype=_ARGS_DTYPE), b)
    k = np.arange(b)
    lane_of = k // per_lane if slots is None else k % slots
    for f in TGParams._fields:
        args[f] = ptrs_of(f)
    for name, t in prog.items():
        args[name] = _rows_ptrs(t, k)
    for name, t in lane.items():
        args[name] = _rows_ptrs(t, lane_of)
    if used_l is not None:
        args["new_used"] = _rows_ptrs(used_l, lane_of)
    raw = args.view(np.uint8)
    with default_ledger().timed("kernels.place_args", raw.nbytes):
        dev_args = to_device_async(raw, dev)
    return dims, args, dev_args, prog, lane, used_l


def _launch_lanes(cluster: ClusterArrays, shapes: dict, ptrs_of, lanes: int,
                  per_lane: int, max_allocs: int, explain: bool, fold: bool,
                  snapshots: bool = False, batch: bool = False,
                  pooled: bool = False):
    """Enqueue one dispatch of `lanes` chains of `per_lane` programs on
    the current stream (`_lane_args` says what `shapes` and `ptrs_of`
    are). With `batch` the lanes are a K6 batch (one program a lane, no
    fold); `pooled` runs that batch in a pool of carries, one per
    resident scan block, and returns no lane carries and no step-0
    score vectors. Returns the
    per-program buffers (leading axis lanes·per_lane) and the lane
    carries."""
    lib = _CHAIN.lib()
    dev = cluster.used.device
    n, r = cluster.capacity.shape
    b = lanes * per_lane
    slots = (min(b, torch.cuda.get_device_properties(dev)
                 .multi_processor_count) if pooled else None)
    dims, args, dev_args, prog, _lane, used_l = _lane_args(
        cluster, shapes, ptrs_of, lanes, per_lane, max_allocs, explain,
        slots=slots)
    dyn_l = (None if pooled
             else torch.empty((lanes, n), dtype=torch.float32, device=dev))
    snap = (torch.empty((b, n, r), dtype=torch.float32, device=dev)
            if snapshots else None)

    la = _ChainLaneArgs()
    la.used0, la.dyn0 = cluster.used.data_ptr(), cluster.dyn_free.data_ptr()
    la.n, la.r = n, r
    la.used_l = used_l.data_ptr()
    la.dyn_l = dyn_l.data_ptr() if dyn_l is not None else None
    la.used_snap = snap.data_ptr() if snap is not None else None
    out_f = None
    if fold:
        out_f = (torch.empty((n, r), dtype=torch.float32, device=dev),
                 torch.empty(n, dtype=torch.float32, device=dev),
                 torch.zeros(1, dtype=torch.int32, device=dev))
        la.used_f, la.dyn_f, la.collisions = (t.data_ptr() for t in out_f)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if pooled:
        err = lib.nomad_place_batch_pooled(args_pointer(args),
                                           dev_args.data_ptr(), b, slots,
                                           ctypes.byref(la), stream)
    elif batch:
        err = lib.nomad_place_batch(args_pointer(args),
                                    dev_args.data_ptr(), b, ctypes.byref(la),
                                    stream)
    else:
        err = lib.nomad_place_lanes(args_pointer(args),
                                    dev_args.data_ptr(), lanes, per_lane,
                                    ctypes.byref(la), int(fold), stream)
    if err != 0:
        raise RuntimeError("chain kernel launch failed: "
                           + lib.nomad_chain_error_string(err).decode())
    kind = "batch" if batch or pooled else "wave" if fold else "chain"
    _CHAIN.launches[kind] += 1
    if kind != "batch":
        _CHAIN.kernels[kind] += 3 if fold else 2
        _CHAIN.routes["lanes"] += 1
        _CHAIN.last_route = ("lanes", None)
    # dev_args and the scratch may be freed now: the caching allocator
    # hands their memory only to work queued after this launch on the
    # same stream
    base = (prog["sel_idx"], prog["sel_score"], prog["nodes_feasible"],
            prog["nodes_fit"])
    ex = _explain_out(prog, dims["c"]) if explain else None
    lanes_out = None if pooled else (used_l, dyn_l)
    return base, ex, lanes_out, out_f, (prog.get("final0"), snap)


# ---- the lane route of chains and waves (K4, K5; csrc/lanes.cu) --------------
# A lane is one thread-block cluster of C blocks, block j keeping rows
# [j·rows, (j + 1)·rows) of the view in shared memory; every lane of a
# dispatch is one launch, a wave's fold a second. The carry is the view
# plus the lane's overlay (the rows a program held a delta for or placed
# on). C is chosen by shape alone (`lane_route`); where no layout fits,
# the dispatch takes chain.cu's `nomad_place_lanes`, as
# `place_task_group_chain` (which returns every program's carry) always
# does.

#: the largest thread-block cluster (the portable size of sm_90)
MAX_CLUSTER = 8
#: rows a block of the lane route keeps at the least before the rows are
#: split over more blocks: below it a cluster's barriers cost more than
#: the rows a block gives away
LANE_SLICE_ROWS = 2048
#: threads of a lane block, the top-K lists of a warp (slots) and of a
#: thread (K at most), and the words of a top-K entry (csrc/lanes.cu,
#: csrc/cluster_core.cuh)
_LANE_THREADS, _TOPK_MAX, _LANE_TOPK, _TOPK_WORDS = 512, 8, 5, 7
#: fixed counters of a lane block before exh_dim and filt_constraint
_CNT_FIXED = 9
#: the lane layout's regions, in order (`lane_offsets`, csrc/lanes.cu)
_LANE_REGIONS = ("args", "red", "cnt", "placed", "pen", "scounts",
                 "dcounts", "sptab", "minmax", "seen", "dptab", "consts",
                 "lists", "slots", "win", "spec", "overlay", "prefix", "meta",
                 "exh", "stok", "dtok")
#: sizeof(SpecRow) in csrc/onchip.cuh
_SPEC_ROW_BYTES = 16


def record_words(dims: dict, r: int) -> int:
    """Words of a block's step record (`shard_rec_words`,
    csrc/cluster_core.cuh)."""
    base = 7 + 2 * (dims["s"] + dims["p"])
    if dims["explain"]:
        base += 4 + r + _TOPK_WORDS * dims["topk"] + 3 + dims["c"]
    return base


def lane_rows(n: int, clusters: int) -> int:
    """Rows a block of a C-block lane keeps: n / C rounded up to 32, so
    that no two blocks share a word of the overlay bitmap."""
    per = -(-n // clusters)
    return -(-per // 32) * 32


def lane_layout(rows: int, dims: dict, r: int, clusters: int) -> dict:
    """A lane block's shared memory for programs of `dims`
    (`_program_dims`) on `rows` rows, R = r, in clusters of `clusters`:
    region → (offset, bytes), each on a 16-byte boundary, and "total".
    Per row: the score prefix (f32), its bits (u8), its exhaustion code
    with explain (u8), an overlay bit and a token per spread row and per
    distinct_property (u8, or u16 past 256 values); two sets of C record
    slots (by step parity)."""
    s, sv, p, dv = dims["s"], dims["sv"], dims["p"], dims["dv"]
    ex = dims["explain"]
    sizes = dict(
        args=ctypes.sizeof(_PlaceArgs), red=33 * _BEST_BYTES,
        cnt=4 * (_CNT_FIXED + r + dims["c"]), placed=4 * dims["m"],
        pen=_PEN_ROW_BYTES * dims["pn"], scounts=4 * s * sv,
        dcounts=4 * p * dv, sptab=4 * s * sv, minmax=8 * s, seen=s,
        dptab=p * dv,
        consts=4 * (s * sv + s + p + dims["m"] * dims["pn"]) + 2 * s + p,
        lists=(_LANE_THREADS // 32) * _TOPK_MAX * _BEST_BYTES if ex else 0,
        slots=2 * clusters * 4 * (-(-record_words(dims, r) // 4) * 4),
        win=4 * (-(-(2 + s + p) // 4) * 4), spec=_SPEC_ROW_BYTES,
        overlay=4 * -(-rows // 32),
        prefix=4 * rows, meta=rows, exh=rows if ex else 0,
        stok=s * rows * _tok_bytes(sv), dtok=p * rows * _tok_bytes(dv))
    out, off = {}, 0
    for name in _LANE_REGIONS:
        out[name] = (off, sizes[name])
        off = (off + sizes[name] + 15) & ~15
    out["total"] = off
    return out


def lane_route(n: int, lanes: int, dims: dict, r: int, sms: int) -> int:
    """The cluster size C of a dispatch of `lanes` lanes of programs of
    `dims` on n rows, by shape alone, or 0 for chain.cu's route. C is the
    largest power of two ≤ 8 with L·C ≤ the card's SMs (every lane's
    cluster resident at once) and at least LANE_SLICE_ROWS rows a block;
    where that block's layout exceeds 227 KB, C doubles (the clusters may
    then queue) until it fits. 0 where none fits, where a vocabulary
    passes u16 tokens, or where a program has no step."""
    if (dims["m"] < 1 or max(dims["sv"], dims["dv"]) > 65536
            or dims["topk"] > _LANE_TOPK):
        return 0
    c = 1
    while (c < MAX_CLUSTER and lanes * c * 2 <= sms
           and n // (c * 2) >= LANE_SLICE_ROWS):
        c *= 2
    while lane_layout(lane_rows(n, c), dims, r, c)["total"] > BLOCK_SMEM:
        if c == MAX_CLUSTER:
            return 0
        c *= 2
    return c


class _LaneRun(ctypes.Structure):
    """Mirror of `LaneRun` in csrc/lanes.cu."""

    _fields_ = [("lanes", _INT), ("per_lane", _INT), ("clusters", _INT),
                ("rows", _INT), ("n", _INT), ("r", _INT), ("fold", _INT),
                ("shards", _INT),
                ("used0", _VOID), ("dyn0", _VOID), ("carry_used", _VOID),
                ("carry_dyn", _VOID), ("overlay", _VOID),
                ("out_used", _VOID), ("out_dyn", _VOID),
                ("collisions", _VOID)]


#: shard copies (batch rows × node shards) K9's fold on one card takes
#: (csrc/lanes.cu MAX_FOLD_COPIES)
MAX_FOLD_COPIES = 64


class _LaneShardFold(ctypes.Structure):
    """Mirror of `LaneShardFold` in csrc/lanes.cu (K9's fold)."""

    _fields_ = [("shards", _INT), ("batch_rows", _INT), ("per_row", _INT),
                ("count", _INT), ("new_used", _VOID),
                ("used", _VOID * MAX_FOLD_COPIES),
                ("out", _VOID * MAX_CLUSTER)]


class _LaneLauncher:
    """The lane-route library (csrc/lanes.cu), built at first use."""

    def __init__(self):
        self._lib = None

    def lib(self):
        if self._lib is None:
            from ._build import load_library

            lib = load_library("lanes")
            for fn in ("nomad_lanes_args_size", "nomad_lanes_run_size",
                       "nomad_lanes_fold_size"):
                getattr(lib, fn).restype = ctypes.c_size_t
                getattr(lib, fn).argtypes = []
            lib.nomad_lanes_smem.restype = ctypes.c_size_t
            lib.nomad_lanes_smem.argtypes = [ctypes.POINTER(_PlaceArgs),
                                             _INT, _INT]
            lib.nomad_place_lane_clusters.restype = ctypes.c_int
            lib.nomad_place_lane_clusters.argtypes = [
                ctypes.POINTER(_PlaceArgs), _VOID, ctypes.POINTER(_LaneRun),
                _VOID, ctypes.POINTER(ctypes.c_int)]
            lib.nomad_lanes_shard_fold.restype = ctypes.c_int
            lib.nomad_lanes_shard_fold.argtypes = [
                ctypes.POINTER(_LaneShardFold), _VOID]
            lib.nomad_lanes_error_string.restype = ctypes.c_char_p
            lib.nomad_lanes_error_string.argtypes = [ctypes.c_int]
            if (lib.nomad_lanes_args_size() != ctypes.sizeof(_PlaceArgs)
                    or lib.nomad_lanes_run_size() != ctypes.sizeof(_LaneRun)
                    or lib.nomad_lanes_fold_size()
                    != ctypes.sizeof(_LaneShardFold)):
                raise RuntimeError(
                    "lanes library's argument layout differs from the "
                    "wrapper's (rebuild csrc/lanes.cu)")
            self._lib = lib
        return self._lib

    def check_layout(self, args: np.ndarray, rows: int, dims: dict, r: int,
                     clusters: int) -> None:
        """Raises unless the library's shared-memory layout for blocks of
        `rows` rows in clusters of `clusters` is `lane_layout`'s."""
        want = lane_layout(rows, dims, r, clusters)["total"]
        got = self.lib().nomad_lanes_smem(args_pointer(args), rows, clusters)
        if got != want:
            raise RuntimeError(f"lanes library's shared-memory layout "
                               f"({got} B) differs from lane_layout's "
                               f"({want} B)")

    def launch(self, args: np.ndarray, dev_args: int, run: _LaneRun, dev,
               count) -> None:
        """One `nomad_place_lane_clusters` call on the device's current
        stream; `count(k)` gets the kernels it launched, then it raises
        when the call failed."""
        lib = self.lib()
        launches = ctypes.c_int(0)
        with torch.cuda.device(dev):
            err = lib.nomad_place_lane_clusters(
                args_pointer(args), dev_args, ctypes.byref(run),
                torch.cuda.current_stream(dev).cuda_stream,
                ctypes.byref(launches))
        count(launches.value)
        if err != 0:
            raise RuntimeError("lane-route kernel launch failed: "
                               + lib.nomad_lanes_error_string(err).decode())

    def shard_fold(self, fold: _LaneShardFold, dev) -> None:
        """K9's fold (`nomad_lanes_shard_fold`, one launch) on the
        device's current stream; raises when it is refused."""
        lib = self.lib()
        with torch.cuda.device(dev):
            err = lib.nomad_lanes_shard_fold(
                ctypes.byref(fold), torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError("K9 fold launch failed: "
                               + lib.nomad_lanes_error_string(err).decode())


_LANES = _LaneLauncher()


def build_lanes_kernel() -> None:
    """Build (or load the cached build of) the lane-route library now."""
    _LANES.lib()


def _launch_lane_clusters(cluster: ClusterArrays, shapes: dict, ptrs_of,
                          lanes: int, per_lane: int, max_allocs: int,
                          explain: bool, fold: bool, carry: bool,
                          clusters: int):
    """One dispatch of `lanes` chains of `per_lane` programs on the lane
    route at cluster size `clusters`: one launch, and for a wave (`fold`)
    the fold's. Returns the per-program outputs (leading axis
    lanes·per_lane), the explain buffers, the final (used, dyn_free)
    carry (a chain with `carry`) or the folded one (a wave), and the
    collision count (a wave). Raises when the library's layout differs
    from `lane_layout` or a launch fails."""
    dev = cluster.used.device
    n, r = cluster.capacity.shape
    dims, args, dev_args, prog, _lane, _used = _lane_args(
        cluster, shapes, ptrs_of, lanes, per_lane, max_allocs, explain,
        flat=True)
    rows = lane_rows(n, clusters)
    _LANES.check_layout(args, rows, dims, r, clusters)

    def empty(shape, dt=torch.float32):
        return torch.empty(shape, dtype=dt, device=dev)

    run = _LaneRun(lanes=lanes, per_lane=per_lane, clusters=clusters,
                   rows=rows, n=n, r=r, fold=int(fold))
    run.used0, run.dyn0 = cluster.used.data_ptr(), cluster.dyn_free.data_ptr()
    out, coll = None, None
    if fold:
        carry_l = (empty((lanes, n, r)), empty((lanes, n)))
        bits = empty((lanes, -(-n // 32)), torch.int32)
        out = (empty((n, r)), empty(n))
        coll = empty(1, torch.int32)
        run.overlay, run.collisions = bits.data_ptr(), coll.data_ptr()
    elif carry:
        out = (empty((n, r)), empty(n))
        carry_l = out   # the chain's carry buffers are its outputs
    else:
        carry_l = (empty((n, r)), empty(n))
    run.carry_used, run.carry_dyn = (t.data_ptr() for t in carry_l)
    if out is not None:
        run.out_used, run.out_dyn = (t.data_ptr() for t in out)
    kind = "wave" if fold else "chain"

    def count(k):
        _CHAIN.kernels[kind] += k

    _LANES.launch(args, dev_args.data_ptr(), run, dev, count)
    _CHAIN.launches[kind] += 1
    _CHAIN.routes["cluster"] += 1
    _CHAIN.last_route = ("cluster", clusters)
    # the scratch may be freed now: the caching allocator hands its memory
    # only to work queued after these launches on the same stream
    base = (prog["sel_idx"], prog["sel_score"], prog["nodes_feasible"],
            prog["nodes_fit"])
    ex = _explain_out(prog, dims["c"]) if explain else None
    return base, ex, out, coll


def _chain_dispatch(cluster: ClusterArrays, shapes: dict, ptrs_of,
                    lanes: int, per_lane: int, max_allocs: int,
                    explain: bool, fold: bool, carry: bool,
                    clusters: Optional[int] = None):
    """One K4 (`fold` False, one lane) or K5 dispatch on the card.
    `clusters` None: the route by shape (`lane_route`); 0: chain.cu's
    `nomad_place_lanes`; C > 0: the lane route at cluster size C (the
    card tests and chip_smoke.py hold the routes and sizes against each
    other). Returns (flat outputs, explain, carry or None, collisions or
    None)."""
    if clusters is None:
        n, r = cluster.capacity.shape
        dims = _program_dims(shapes, max_allocs, explain, n)
        sms = torch.cuda.get_device_properties(
            cluster.used.device).multi_processor_count
        clusters = lane_route(n, lanes, dims, r, sms)
    if clusters:
        return _launch_lane_clusters(cluster, shapes, ptrs_of, lanes,
                                     per_lane, max_allocs, explain, fold,
                                     carry, clusters)
    base, ex, lanes_out, out_f, _s = _launch_lanes(
        cluster, shapes, ptrs_of, lanes, per_lane, max_allocs, explain,
        fold=fold)
    if fold:
        return base, ex, out_f[:2], out_f[2]
    if not carry:
        return base, ex, None, None
    used_l, dyn_l = lanes_out
    return base, ex, (used_l[0], dyn_l[0]), None


def _table_source(ti, tf, tu, rows, di, df, du, sspec, dspec, b):
    """(shapes, ptrs_of) for table programs: static fields point into
    their table row, dynamic fields into their program's dynamic row."""
    dev = ti.device
    tables = {"i": ti, "f": tf, "u": tu}
    dyn = {"i": di.reshape(b, -1), "f": df.reshape(b, -1),
           "u": du.reshape(b, -1)}
    for cls in "ifu":
        _check_class_buf(f"table[{cls}]", tables[cls], cls, dev)
        _check_class_buf(f"dyn[{cls}]", dyn[cls], cls, dev)
    rows = host_rows(rows).reshape(-1)
    if rows.shape[0] != b or (rows < 0).any() or (rows >= ti.shape[0]).any():
        raise ValueError("table rows out of range or of the wrong count")
    where = {}
    for spec, src in ((sspec, "table"), (dspec, "dyn")):
        for name, cls, off, shape in spec:
            where[name] = (src, cls, off, tuple(shape))

    def ptrs_of(name):
        src, cls, off, _shape = where[name]
        t, idx = ((tables[cls], rows) if src == "table"
                  else (dyn[cls], np.arange(b)))
        return _rows_ptrs(t, idx) + off * _ESIZE[cls]

    return {name: w[3] for name, w in where.items()}, ptrs_of


def place_table_chain_cuda(cluster, ti, tf, tu, rows, di, df, du, sspec,
                           dspec, max_allocs, explain=False, clusters=None):
    """`place_table_chain` on the card; `clusters` as `_chain_dispatch`
    takes it."""
    _check_cluster(cluster)
    b = int(host_rows(rows).size)
    shapes, ptrs_of = _table_source(ti, tf, tu, rows, di, df, du, sspec,
                                    dspec, b)
    base, ex, carry, _coll = _chain_dispatch(
        cluster, shapes, ptrs_of, 1, b, max_allocs, explain, fold=False,
        carry=True, clusters=clusters)
    out = base + tuple(ex) if explain else base
    return out, carry


def place_table_wave_cuda(cluster, ti, tf, tu, rows, di, df, du, sspec,
                          dspec, max_allocs, explain=False, clusters=None):
    """`place_table_wave` on the card; `clusters` as `_chain_dispatch`
    takes it."""
    _check_cluster(cluster)
    lanes, per_lane = host_rows(rows).shape
    shapes, ptrs_of = _table_source(ti, tf, tu, rows, di, df, du, sspec,
                                    dspec, lanes * per_lane)
    base, ex, carry, coll = _chain_dispatch(
        cluster, shapes, ptrs_of, lanes, per_lane, max_allocs, explain,
        fold=True, carry=True, clusters=clusters)
    out = base + tuple(ex) if explain else base
    return out + (coll.reshape(()),), carry


def _stacked_source(cluster, batch):
    """(b, shapes, ptrs_of) for a stacked TGParams ([B, ...] fields on the
    cluster's device): program k's fields are its slices."""
    batch = TGParams(*(t.contiguous() for t in batch))
    b = batch.n_place.shape[0]
    for name, dt in PARAM_TYPES.items():
        t = getattr(batch, name)
        if t.device != cluster.used.device or t.dtype != dt \
                or t.shape[0] != b:
            raise TypeError(f"batch.{name} must be {dt}[{b}, ...] on the "
                            "cluster's device")
    fields = batch._asdict()

    def ptrs_of(name):
        return _rows_ptrs(fields[name], np.arange(b))

    return b, {name: tuple(t.shape[1:]) for name, t in fields.items()}, \
        ptrs_of


def packed_ptrs(starts: dict, spec):
    """(b, shapes, ptrs_of) for field-major packed buffers (`pack_params`
    of a stacked batch) whose class buffers lie at device addresses
    `starts` ("i", "f", "u")."""
    where = {name: (cls, off, tuple(shape)) for name, cls, off, shape in spec}
    b = where["n_place"][2][0]

    def ptrs_of(name):
        cls, off, shape = where[name]
        size = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        return starts[cls] + (off + np.arange(b, dtype=np.int64)
                              * size) * _ESIZE[cls]

    return b, {name: w[2][1:] for name, w in where.items()}, ptrs_of


def _packed_source(cluster, i32buf, f32buf, u8buf, spec):
    """(b, shapes, ptrs_of) for field-major packed buffers on the
    cluster's device."""
    bufs = {"i": i32buf, "f": f32buf, "u": u8buf}
    for cls in "ifu":
        _check_class_buf(f"packed[{cls}]", bufs[cls], cls,
                         cluster.used.device)
    return packed_ptrs({cls: t.data_ptr() for cls, t in bufs.items()}, spec)


def place_task_group_chain_cuda(cluster, batch, max_allocs, explain=False):
    _check_cluster(cluster)
    b, shapes, ptrs_of = _stacked_source(cluster, batch)
    base, ex, _lanes, _f, (final0, snap) = _launch_lanes(
        cluster, shapes, ptrs_of, 1, b, max_allocs, explain, fold=False,
        snapshots=True)
    return PlacementResult(sel_idx=base[0], sel_score=base[1],
                           new_used=snap, nodes_feasible=base[2],
                           nodes_fit=base[3], final_scores0=final0,
                           explain=ex)


def place_packed_chain_cuda(cluster, i32buf, f32buf, u8buf, spec,
                            max_allocs, explain=False, clusters=None):
    """`place_packed_chain` on the card; `clusters` as `_chain_dispatch`
    takes it."""
    _check_cluster(cluster)
    b, shapes, ptrs_of = _packed_source(cluster, i32buf, f32buf, u8buf, spec)
    base, ex, _carry, _coll = _chain_dispatch(
        cluster, shapes, ptrs_of, 1, b, max_allocs, explain, fold=False,
        carry=False, clusters=clusters)
    return base + tuple(ex) if explain else base


def _route(cluster, plain, cuda):
    kind = cluster.used.device.type
    if kind == "cpu":
        return plain
    if kind == "cuda":
        return cuda
    raise ValueError(f"no placement implementation for device {kind!r}")


def place_task_group_chain(cluster: ClusterArrays, batch: TGParams,
                           max_allocs: int,
                           explain: bool = False) -> PlacementResult:
    """Chained placement of a stacked batch ([B, ...] fields): program b
    sees programs 0..b-1's placements; new_used is the carry after each
    program. Plain on CPU tensors, the chain kernel on CUDA tensors; on a
    sharded view the sharded chain (B10, kernels/shard.py)."""
    shard = _sharded_routes(cluster)
    if shard is not None:
        return shard.sharded_chain(cluster, batch, max_allocs, explain)
    return _route(cluster, place_task_group_chain_plain,
                  place_task_group_chain_cuda)(cluster, batch, max_allocs,
                                               explain)


def place_packed_chain(cluster, i32buf, f32buf, u8buf, spec, max_allocs,
                       explain=False):
    """Chained placement over field-major packed buffers; returns
    (sel_idx, sel_score, nodes_feasible, nodes_fit[, explain leaves]). On
    a sharded view (the coordinator's route under a mesh) the sharded
    chain (B10, kernels/shard.py), its outputs on the lead device."""
    shard = _sharded_routes(cluster)
    if shard is not None:
        return shard.sharded_packed_chain(cluster, i32buf, f32buf, u8buf,
                                          spec, max_allocs, explain)
    return _route(cluster, place_packed_chain_plain,
                  place_packed_chain_cuda)(cluster, i32buf, f32buf, u8buf,
                                           spec, max_allocs, explain)


def place_table_chain(cluster, ti, tf, tu, rows, di, df, du, sspec, dspec,
                      max_allocs, explain=False):
    """Chained placement of table programs: `rows` (host indices, [B])
    pick each program's static row of the class tables (ti, tf, tu);
    di/df/du [B, Ld*] are the dynamic rows. Returns (flat outputs, the
    final (used, dyn_free) carry)."""
    return _route(cluster, place_table_chain_plain,
                  place_table_chain_cuda)(cluster, ti, tf, tu, rows, di, df,
                                          du, sspec, dspec, max_allocs,
                                          explain)


def place_table_wave(cluster, ti, tf, tu, rows, di, df, du, sspec, dspec,
                     max_allocs, explain=False):
    """L lanes of table chains in parallel (`rows` host [L, P], dynamic
    rows [L, P, Ld*]). Returns (flat outputs [L·P, ...] lane-major plus
    the collision count last, the folded (used, dyn_free) carry)."""
    return _route(cluster, place_table_wave_plain,
                  place_table_wave_cuda)(cluster, ti, tf, tu, rows, di, df,
                                         du, sspec, dspec, max_allocs,
                                         explain)


# ---- batches of independent programs (K6) --------------------------------------
# The vmap transport: B programs against one snapshot, none seeing another's
# placements (the reference's N workers racing on one MVCC snapshot; plan
# apply resolves conflicts). The plain version loops K1's plain version.
# `place_task_group_batch`'s CUDA route is a K5 wave of B one-program lanes
# with no fold (`csrc/chain.cu` `nomad_place_batch`). `place_packed_batch`
# takes, by shape alone (`batch_route`), the on-chip route (`csrc/batch.cu`:
# one launch, each program's rows in shared memory) when a program's row
# state fits a block's shared memory, else the pooled route (`csrc/chain.cu`
# `nomad_place_batch_pooled`: a static grid, then scan blocks over carry
# slots).

#: shared memory one block may use on Hopper (227 KB)
BLOCK_SMEM = 232_448
#: the on-chip layout's regions, in order (`onchip_offsets`, csrc/batch.cu)
_ONCHIP_REGIONS = ("args", "red", "placed", "pen", "scounts",
                   "dcounts", "sptab", "minmax", "seen", "dptab", "prefix",
                   "meta", "stok", "dtok")
#: sizeof(PenRow), sizeof(Best) in csrc/batch.cu and place_core.cuh
_PEN_ROW_BYTES, _BEST_BYTES = 20, 8


def _tok_bytes(v: int) -> int:
    return 1 if v <= 256 else 2


def onchip_layout(n: int, dims: dict) -> dict:
    """The on-chip route's shared memory for programs of `dims`
    (`_program_dims`) on n rows: region → (offset, bytes), each region on
    a 16-byte boundary, and "total". Per row: the score prefix (f32), its
    bits and term count (u8), and a token per spread row and per
    distinct_property (u8, or u16 past 256 values)."""
    s, sv, p, dv = dims["s"], dims["sv"], dims["p"], dims["dv"]
    sizes = dict(
        args=ctypes.sizeof(_PlaceArgs), red=33 * _BEST_BYTES,
        placed=4 * dims["m"], pen=_PEN_ROW_BYTES * dims["pn"],
        scounts=4 * s * sv, dcounts=4 * p * dv, sptab=4 * s * sv,
        minmax=8 * s, seen=s, dptab=p * dv, prefix=4 * n, meta=n,
        stok=s * n * _tok_bytes(sv), dtok=p * n * _tok_bytes(dv))
    out, off = {}, 0
    for name in _ONCHIP_REGIONS:
        out[name] = (off, sizes[name])
        off = (off + sizes[name] + 15) & ~15
    out["total"] = off
    return out


def batch_route(n: int, dims: dict) -> str:
    """K6's packed route for programs of `dims` on n rows, by shape alone:
    "onchip" when the on-chip layout fits one block's shared memory (and
    the token vocabularies fit u16), else "pooled"."""
    if max(dims["sv"], dims["dv"]) > 65536:
        return "pooled"
    return ("onchip" if onchip_layout(n, dims)["total"] <= BLOCK_SMEM
            else "pooled")


class _OnchipLauncher:
    """The on-chip batch library (csrc/batch.cu), built at first use; its
    launch count, and the route and launch shape of the last packed
    dispatch."""

    def __init__(self):
        self.launches = 0
        self.route = None
        self.config = None
        self._lib = None

    def lib(self):
        if self._lib is None:
            from ._build import load_library

            lib = load_library("batch")
            lib.nomad_batch_args_size.restype = ctypes.c_size_t
            lib.nomad_batch_args_size.argtypes = []
            lib.nomad_batch_onchip_smem.restype = ctypes.c_size_t
            lib.nomad_batch_onchip_smem.argtypes = [
                ctypes.POINTER(_PlaceArgs)]
            lib.nomad_place_batch_onchip.restype = ctypes.c_int
            lib.nomad_place_batch_onchip.argtypes = [
                ctypes.POINTER(_PlaceArgs), _VOID, _INT, _INT, _VOID,
                ctypes.POINTER(ctypes.c_int)]
            lib.nomad_batch_error_string.restype = ctypes.c_char_p
            lib.nomad_batch_error_string.argtypes = [ctypes.c_int]
            if lib.nomad_batch_args_size() != ctypes.sizeof(_PlaceArgs):
                raise RuntimeError(
                    "batch library's PlaceArgs layout differs from the "
                    "wrapper's (rebuild csrc/batch.cu)")
            self._lib = lib
        return self._lib


_ONCHIP = _OnchipLauncher()


def onchip_launch_count() -> int:
    """Launches of the on-chip K6 kernel since the last reset (one a
    packed dispatch on that route)."""
    return _ONCHIP.launches


def last_batch_route():
    """(route, (blocks, threads) or None) of the last packed dispatch on
    the card."""
    return _ONCHIP.route, _ONCHIP.config


def build_batch_kernel() -> None:
    """Build (or load the cached build of) the on-chip batch library."""
    _ONCHIP.lib()


def _launch_onchip(cluster, shapes, ptrs_of, b, max_allocs):
    """One launch of csrc/batch.cu's `batch_onchip` for b programs;
    returns (sel_idx, sel_score). Raises when the library's layout
    differs from `onchip_layout` or the launch fails."""
    lib = _ONCHIP.lib()
    dev = cluster.used.device
    n = cluster.capacity.shape[0]
    dims, args, dev_args, prog, _lane, _used = _lane_args(
        cluster, shapes, ptrs_of, b, 1, max_allocs, False, onchip=True)
    want = onchip_layout(n, dims)["total"]
    got = lib.nomad_batch_onchip_smem(args_pointer(args))
    if got != want:
        raise RuntimeError(f"batch library's shared-memory layout ({got} B) "
                           f"differs from onchip_layout's ({want} B)")
    config = (ctypes.c_int * 2)()
    err = lib.nomad_place_batch_onchip(
        args_pointer(args), dev_args.data_ptr(), b,
        torch.cuda.get_device_properties(dev).multi_processor_count,
        torch.cuda.current_stream(dev).cuda_stream, config)
    if err != 0:
        raise RuntimeError("on-chip batch kernel launch failed: "
                           + lib.nomad_batch_error_string(err).decode())
    _ONCHIP.launches += 1
    _ONCHIP.config = (config[0], config[1])
    return prog["sel_idx"], prog["sel_score"]


def place_task_group_batch_plain(cluster, batch, max_allocs, explain=False):
    return _stack_results([
        place_task_group_plain(cluster, _program(batch, b), max_allocs,
                               explain)
        for b in range(batch.n_place.shape[0])])


def place_packed_batch_plain(cluster, i32buf, f32buf, u8buf, spec,
                             max_allocs):
    r = place_task_group_batch_plain(
        cluster, _unpack_params(i32buf, f32buf, u8buf, spec), max_allocs)
    return r.sel_idx, r.sel_score


def place_task_group_batch_cuda(cluster, batch, max_allocs, explain=False):
    _check_cluster(cluster)
    b, shapes, ptrs_of = _stacked_source(cluster, batch)
    base, ex, (used_l, _dyn), _f, (final0, _s) = _launch_lanes(
        cluster, shapes, ptrs_of, b, 1, max_allocs, explain, fold=False,
        batch=True)
    return PlacementResult(sel_idx=base[0], sel_score=base[1],
                           new_used=used_l, nodes_feasible=base[2],
                           nodes_fit=base[3], final_scores0=final0,
                           explain=ex)


def _packed_batch_on(route, cluster, i32buf, f32buf, u8buf, spec,
                     max_allocs):
    """`place_packed_batch` on the card through `route` ("onchip" or
    "pooled"); the two give bitwise the same results."""
    _check_cluster(cluster)
    b, shapes, ptrs_of = _packed_source(cluster, i32buf, f32buf, u8buf, spec)
    _ONCHIP.route, _ONCHIP.config = route, None
    if route == "onchip":
        return _launch_onchip(cluster, shapes, ptrs_of, b, max_allocs)
    if route != "pooled":
        raise ValueError(f"no K6 route {route!r}")
    base, _ex, _lanes, _f, _s = _launch_lanes(
        cluster, shapes, ptrs_of, b, 1, max_allocs, False, fold=False,
        pooled=True)
    return base[0], base[1]


def place_packed_batch_cuda(cluster, i32buf, f32buf, u8buf, spec,
                            max_allocs):
    """K6's packed route on the card, chosen by `batch_route` from the
    row count and the programs' shapes alone."""
    n = cluster.capacity.shape[0]
    shapes = {name: tuple(shape[1:]) for name, _c, _o, shape in spec}
    route = batch_route(n, _program_dims(shapes, max_allocs, False, n))
    return _packed_batch_on(route, cluster, i32buf, f32buf, u8buf, spec,
                            max_allocs)


def place_task_group_batch(cluster: ClusterArrays, batch: TGParams,
                           max_allocs: int,
                           explain: bool = False) -> PlacementResult:
    """Batched placement of a stacked batch ([B, ...] fields): each
    program against the same snapshot, independently; every output gains
    a leading B (new_used is [B, N, R]). Plain on CPU tensors, the K6
    kernel on CUDA tensors."""
    return _route(cluster, place_task_group_batch_plain,
                  place_task_group_batch_cuda)(cluster, batch, max_allocs,
                                               explain)


def place_packed_batch(cluster, i32buf, f32buf, u8buf, spec, max_allocs):
    """Batched placement over field-major packed buffers; returns only
    (sel_idx, sel_score), [B, M] each, as the reference does — so the
    kernels keep no per-program carry: on the card one launch with each
    program's rows in shared memory where they fit (`batch_route`), else
    a scan in a pool of carries, one per resident block."""
    return _route(cluster, place_packed_batch_plain,
                  place_packed_batch_cuda)(cluster, i32buf, f32buf, u8buf,
                                           spec, max_allocs)


# ---- program packing (host numpy) --------------------------------------------
# Copied from the reference package: the field partition of the device
# program table and the row packers its transports use.

_PACK_I32 = ("n_place", "algorithm", "key_idx", "aff_key_idx", "penalty_idx",
             "preferred_idx", "jc_idx", "jtc_idx", "delta_idx",
             "cand_idx", "dp_key_idx", "spread_key_idx", "res_ports",
             "pclr_idx", "pclr_port", "pset_idx", "pset_port")
_PACK_F32 = ("ask", "desired_count", "aff_lut", "aff_inv_sum", "jc_val",
             "jtc_val", "delta_res", "dp_allowed", "dp_counts0",
             "spread_weight", "spread_desired", "spread_counts0", "n_dyn")

#: STATIC fields are plan-independent (the job spec's compiled program);
#: DYNAMIC fields are per-eval plan-relative state.
STATIC_FIELDS = (
    "ask", "desired_count", "algorithm", "key_idx", "lut", "aff_key_idx",
    "aff_lut", "aff_inv_sum", "extra_mask", "distinct_hosts", "res_ports",
    "n_dyn", "dp_key_idx", "dp_allowed", "dp_active", "spread_key_idx",
    "spread_weight", "spread_has_targets", "spread_desired",
    "spread_active",
)
DYN_FIELDS = tuple(f for f in TGParams._fields if f not in STATIC_FIELDS)


def _pack_class(name: str):
    if name in _PACK_I32:
        return "i", np.int32
    if name in _PACK_F32:
        return "f", np.float32
    return "u", np.uint8


_PACK_CLASS = {name: _pack_class(name) for name in TGParams._fields}


def pack_param_rows_batch(padded, fields):
    """Pack a batch of same-shaped programs' `fields` into row-major
    [B, L*] (i32, f32, u8) buffers plus the shared spec."""
    bufs = {"i": [], "f": [], "u": []}
    offs = {"i": 0, "f": 0, "u": 0}
    spec = []
    b = len(padded)
    for name in fields:
        cls, dt = _PACK_CLASS[name]
        stacked = np.stack([np.asarray(getattr(p, name)) for p in padded])
        flat = np.ascontiguousarray(stacked, dtype=dt).reshape(b, -1)
        spec.append((name, cls, offs[cls], stacked.shape[1:]))
        offs[cls] += flat.shape[1]
        bufs[cls].append(flat)
    cat = {c: (np.concatenate(v, axis=1) if v
               else np.zeros((b, 0), dtype=d))
           for (c, v), d in zip(bufs.items(),
                                (np.int32, np.float32, np.uint8))}
    return cat["i"], cat["f"], cat["u"], tuple(spec)


def pack_params(batch):
    """Flatten a (batched) numpy TGParams into (i32, f32, u8) buffers plus
    a spec, field-major."""
    bufs = {"i": [], "f": [], "u": []}
    spec = []
    for name in TGParams._fields:
        a = np.asarray(getattr(batch, name))
        cls, dt = _pack_class(name)
        flat = np.ascontiguousarray(a, dtype=dt).reshape(-1)
        off = sum(x.size for x in bufs[cls])
        bufs[cls].append(flat)
        spec.append((name, cls, off, a.shape))
    cat = {c: (np.concatenate(v) if v else np.zeros(0, dtype=d))
           for (c, v), d in zip(bufs.items(),
                                (np.int32, np.float32, np.uint8))}
    return cat["i"], cat["f"], cat["u"], tuple(spec)


def pack_param_rows(p, fields):
    """Pack ONE program's `fields` into flat (i32, f32, u8) rows + spec,
    row-major per program."""
    bufs = {"i": [], "f": [], "u": []}
    offs = {"i": 0, "f": 0, "u": 0}
    spec = []
    for name in fields:
        a = np.asarray(getattr(p, name))
        cls, dt = _pack_class(name)
        flat = np.ascontiguousarray(a, dtype=dt).reshape(-1)
        spec.append((name, cls, offs[cls], a.shape))
        offs[cls] += flat.size
        bufs[cls].append(flat)
    cat = {c: (np.concatenate(v) if v else np.zeros(0, dtype=d))
           for (c, v), d in zip(bufs.items(),
                                (np.int32, np.float32, np.uint8))}
    return cat["i"], cat["f"], cat["u"], tuple(spec)
