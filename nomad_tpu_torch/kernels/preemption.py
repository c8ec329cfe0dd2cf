"""Preemption candidate ranking (K3).

When bin-packing finds no node with room, the reference retries each node
with eviction enabled (`rank.go:228-448`, a scalar per-node loop calling
the greedy Preemptor). As in `nomad_tpu/kernels/preemption.py`, the search
over nodes is one dense pass: per node, sort that node's preemptible
allocs by job priority ascending, prefix-sum the released resources, find
the minimal victim prefix whose release admits the ask, and score it by
the post-eviction bin-pack fit (`funcs.go:175`) and the logistic
net-priority preemption score (`rank.go:747-783`), averaged. The winning
node's exact victim set is then refined on the host by the greedy
Preemptor (`scheduler/preemption.py`).

Shapes: N node rows × A candidate slots (bucketed). Ineligible slots
(padding, priority delta < 10, the job's own allocs) carry priority
INF_PRIO, so the stable sort puts them behind every real candidate and
the prefix stops at the first of them.

Two implementations compute the same function:

- `preempt_rank_plain`: plain PyTorch on any device. The CPU tests compare
  it with the JAX package; `chip_smoke.py` compares the kernel with it on
  the card.
- the hand-written CUDA kernel (`csrc/preempt.cu`), launched by
  `preempt_rank` for CUDA tensors.

`preempt_rank` dispatches on the device of `cluster.used`: CPU → plain,
CUDA → the kernel (or raise). There is no fallback between the two. The
kernel reads only the cluster's capacity, used, node_ok and attrs; its
`ports_used` and `dyn_free` may be None.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..structs.funcs import PREEMPTION_SCORE_ORIGIN, PREEMPTION_SCORE_RATE
from .placement import (PARAM_TYPES, ClusterArrays, TGParams, _RowLauncher,
                        _lookup, _scatter, _tokens, constraint_mask,
                        fit_scores, program_args)

NEG_INF = -1e30
INF_PRIO = 1e9


class PreemptionCandidates(NamedTuple):
    """Per-node candidate-alloc table (host-built, device-resident)."""

    prio: torch.Tensor    # f32[N, A] — victim job priority; INF_PRIO = pad
    usage: torch.Tensor   # f32[N, A, R] — per-alloc resource rows


class PreemptionResult(NamedTuple):
    best_row: torch.Tensor    # i32 — chosen node row, −1 if none feasible
    best_k: torch.Tensor      # i32 — victims in the minimal prefix there
    best_score: torch.Tensor  # f32 — combined normalized score
    order: torch.Tensor       # i32[N, A] — priority-ascending permutation
    feasible: torch.Tensor    # bool[N] — admits the ask after some eviction
    scores: torch.Tensor      # f32[N] — combined score (NEG_INF infeasible)


def _feasible(cluster: ClusterArrays, p: TGParams) -> torch.Tensor:
    """The placement kernel's mask as the retry sees it: constraints,
    distinct_hosts and the distinct_property starting counts (the
    reference keeps DistinctHosts/DistinctPropertyIterator ahead of the
    evict-enabled BinPackIterator, stack.go:321-411)."""
    n = cluster.capacity.shape[0]
    feas = constraint_mask(cluster, p)
    if p.jc_idx.shape[0]:
        job_cnt0 = _scatter(p.jc_idx, p.jc_val, n)
        feas = feas & ~(p.distinct_hosts & (job_cnt0 > 0))
    if p.dp_key_idx.shape[0]:
        d_v = p.dp_counts0.shape[1]
        dtok = _tokens(cluster.attrs, p.dp_key_idx, d_v)
        row_ok = (((_lookup(p.dp_counts0, dtok) < p.dp_allowed[None, :])
                   & (dtok != d_v - 1)) | ~p.dp_active[None, :])
        feas = feas & torch.all(row_ok, dim=1)
    return feas


def preempt_rank_plain(cluster: ClusterArrays, p: TGParams,
                       cand: PreemptionCandidates) -> PreemptionResult:
    """Plain PyTorch ranking, term by term the reference's `preempt_rank`;
    its one-hot selections of the minimal prefix are direct indexing
    (one non-zero term each)."""
    cap = cluster.capacity
    n, a = cand.prio.shape
    dev = cap.device
    feas = _feasible(cluster, p)
    used = cluster.used
    if p.delta_idx.shape[0]:
        used = used - _scatter(p.delta_idx, p.delta_res, n)

    order = torch.argsort(cand.prio, dim=1, stable=True)
    prio_s = torch.gather(cand.prio, 1, order)
    usage_s = torch.gather(cand.usage, 1,
                           order[:, :, None].expand(-1, -1, cap.shape[1]))
    eligible = prio_s < INF_PRIO
    prefix_ok = torch.cumprod(eligible.to(torch.int32), dim=1).bool()
    release = torch.cumsum(usage_s, dim=1)
    util_k = (used[:, None, :] - release) + p.ask[None, None, :]
    fits_k = torch.all(util_k <= cap[:, None, :], dim=2) & prefix_ok
    any_fit = torch.any(fits_k, dim=1) & feas
    k_idx = torch.argmax(fits_k.to(torch.int32), dim=1)   # first fit

    psum = torch.cumsum(torch.where(eligible, prio_s, 0.0), dim=1)
    rows = torch.arange(n, device=dev)
    max_p = prio_s[rows, k_idx]           # sorted: the prefix's last is max
    sum_p = psum[rows, k_idx]
    net_prio = torch.where(max_p > 0,
                           max_p + sum_p / torch.clamp(max_p, min=1.0), 0.0)
    pre_score = 1.0 / (1.0 + torch.exp(
        PREEMPTION_SCORE_RATE * (net_prio - PREEMPTION_SCORE_ORIGIN)))
    binpack, _ = fit_scores(util_k[rows, k_idx], cap)
    scores = torch.where(any_fit, (binpack + pre_score) / 2.0, NEG_INF)

    best = torch.argmax(scores)
    found = scores[best] > NEG_INF
    return PreemptionResult(
        best_row=torch.where(found, best, -1).to(torch.int32),
        best_k=torch.where(found, k_idx[best] + 1, 0).to(torch.int32),
        best_score=torch.where(found, scores[best], 0.0),
        order=order.to(torch.int32),
        feasible=any_fit,
        scores=scores,
    )


_VOID, _INT = ctypes.c_void_p, ctypes.c_int
_PREEMPT = _RowLauncher("preempt", "nomad_preempt_rank",
                        [_VOID, _VOID, _INT] + [_VOID] * 7)

#: the cluster fields K3 reads, and their types (attrs i16 or i32)
_READ = {"capacity": torch.float32, "used": torch.float32,
         "node_ok": torch.bool}


def launch_count() -> int:
    """K3 launches since the last reset."""
    return _PREEMPT.launches


def reset_launch_count() -> None:
    _PREEMPT.launches = 0


def build_kernel() -> None:
    """Build (or load the cached build of) the K3 library now."""
    _PREEMPT.lib()


def _check(cluster: ClusterArrays, p: TGParams,
           cand: PreemptionCandidates) -> None:
    dev = cluster.used.device
    tensors = [(f"cluster.{f}", getattr(cluster, f))
               for f in (*_READ, "attrs")]
    tensors += [(f"params.{f}", t) for f, t in p._asdict().items()]
    tensors += [("cand.prio", cand.prio), ("cand.usage", cand.usage)]
    for name, t in tensors:
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, cluster on {dev}")
    for name, dt in _READ.items():
        if getattr(cluster, name).dtype != dt:
            raise TypeError(f"cluster.{name} must be {dt}")
    if cluster.attrs.dtype not in (torch.int16, torch.int32):
        raise TypeError("cluster.attrs must be int16 or int32")
    for name, dt in PARAM_TYPES.items():
        if getattr(p, name).dtype != dt:
            raise TypeError(f"params.{name} must be {dt}")
    if cand.prio.dtype != torch.float32 or cand.usage.dtype != torch.float32:
        raise TypeError("candidate tables must be float32")
    n, r = cluster.capacity.shape
    a = cand.prio.shape[1] if cand.prio.dim() == 2 else 0
    if cand.prio.shape != (n, a) or cand.usage.shape != (n, a, r) or a < 1:
        raise ValueError("candidate tables must be [N, A] and [N, A, R], "
                         "A ≥ 1")
    if not 2 <= r <= 32 or cluster.used.shape != (n, r) \
            or p.ask.shape != (r,):
        raise ValueError("capacity, used and ask disagree, or R > 32")
    if p.extra_mask.shape[0] not in (1, n):
        raise ValueError("extra_mask must have 1 or N entries")


def preempt_rank_cuda(cluster: ClusterArrays, p: TGParams,
                      cand: PreemptionCandidates) -> PreemptionResult:
    """K3 on CUDA tensors (`csrc/preempt.cu`): one warp per node row,
    then one block's argmax over the rows. Raises when the build or the
    launch fails; never falls back."""
    if cluster.used.device.type != "cuda":
        raise ValueError("preempt_rank_cuda needs CUDA tensors")
    _check(cluster, p, cand)
    cluster = ClusterArrays(*(None if t is None else t.contiguous()
                              for t in cluster))
    p = TGParams(*(t.contiguous() for t in p))
    prio, usage = cand.prio.contiguous(), cand.usage.contiguous()
    dev = cluster.used.device
    n, a = prio.shape
    order = torch.empty((n, a), dtype=torch.int32, device=dev)
    feasible = torch.empty(n, dtype=torch.bool, device=dev)
    scores = torch.empty(n, dtype=torch.float32, device=dev)
    kbuf = torch.empty(n, dtype=torch.int32, device=dev)
    best = torch.empty(2, dtype=torch.int32, device=dev)
    best_score = torch.empty((), dtype=torch.float32, device=dev)
    _PREEMPT.launch(program_args(cluster, p), prio.data_ptr(),
                    usage.data_ptr(), a, order.data_ptr(),
                    feasible.data_ptr(), scores.data_ptr(), kbuf.data_ptr(),
                    best[0].data_ptr(), best[1].data_ptr(),
                    best_score.data_ptr(), device=dev)
    return PreemptionResult(best_row=best[0], best_k=best[1],
                            best_score=best_score, order=order,
                            feasible=feasible, scores=scores)


def preempt_rank(cluster: ClusterArrays, p: TGParams,
                 cand: PreemptionCandidates) -> PreemptionResult:
    """Rank every node for a preemption retry: the plain version for CPU
    tensors, the K3 kernel for CUDA tensors."""
    kind = cluster.used.device.type
    if kind == "cpu":
        return preempt_rank_plain(cluster, p, cand)
    if kind == "cuda":
        return preempt_rank_cuda(cluster, p, cand)
    raise ValueError(f"no preempt_rank implementation for device {kind!r}")
