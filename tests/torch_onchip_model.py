"""The on-chip scan's row arithmetic in torch, for the CPU models of
K6's on-chip route (`tests/test_torch_batch_onchip.py`) and the chain and
wave lane route (`tests/test_torch_lanes_onchip.py`): a row's entry
terms, the carry after a program's placements, and the spread table.
Every expression is the plain version's (`kernels/placement.py`
`_step_plain`, `_spread_boost`), so the models can be held bitwise to it.
"""
import torch

from nomad_tpu_torch.kernels import placement as tp


def terms(cluster, p, st, used, jc, tgc, splaced, penalty):
    """Every row's entry for the carry given: (prefix, term count, fit
    bit, distinct_hosts bit), step_rows' arithmetic up to the spread term
    (the fit over whole columns, as the plain version takes it)."""
    cap = cluster.capacity
    util = used + p.ask[None, :]
    any_over = torch.any(util > cap, dim=1)
    dyn_ok = (st["dyn_free"] - splaced * p.n_dyn) >= p.n_dyn
    res_ok = st["res_free"] & ~(st["has_res_ask"] & (splaced > 0))
    fit_bit = st["feas"] & ~any_over & dyn_ok & res_ok
    dh = p.distinct_hosts & (jc > 0)
    binpack, spreadfit = tp.fit_scores(util, cap)
    prefix = torch.where(p.algorithm == 1, spreadfit, binpack)
    collide = tgc > 0
    anti = -(tgc + 1.0) / torch.clamp(p.desired_count, min=1.0)
    prefix = prefix + torch.where(collide, anti, 0.0)
    prefix = prefix + torch.where(penalty, -1.0, 0.0)
    aff = st["aff_score"]
    inc_aff = aff != 0.0
    prefix = prefix + torch.where(inc_aff, aff, 0.0)
    cnt = 1 + collide.int() + penalty.int() + inc_aff.int()
    return prefix, cnt, fit_bit, dh


def carry(st, p, placed, n):
    """The carry after the placements `placed` (rows, in step order), as
    take_row leaves it: each ask, and each 1, added one at a time."""
    used, jc, tgc = st["used"].clone(), st["job_cnt"].clone(), \
        st["tg_cnt"].clone()
    splaced = torch.zeros(n, dtype=torch.float32)
    for row in placed:
        used[row] = used[row] + p.ask
        jc[row] = jc[row] + 1.0
        tgc[row] = tgc[row] + 1.0
        splaced[row] = splaced[row] + 1.0
    return used, jc, tgc, splaced


def spread_table(counts, p):
    """[S, sv]: the boost of each (spread row, token) at `counts` —
    `_spread_boost`'s arithmetic with the token as the varying index."""
    s_n, v = counts.shape
    tab = torch.zeros((s_n, v), dtype=torch.float32)
    tok = torch.arange(v)
    big = 3.4e38
    for s in range(s_n):
        cur = counts[s][tok]
        desired = p.spread_desired[s][tok]
        target = torch.where(
            desired > 0.0,
            (desired - (cur + 1.0)) / torch.where(desired > 0, desired, 1.0)
            * p.spread_weight[s], -1.0)
        seen = counts[s] > 0.0
        minc = torch.min(torch.where(seen, counts[s], big))
        maxc = torch.max(torch.where(seen, counts[s], -big))
        minc_safe = torch.where(minc > 0, minc, 1.0)
        delta_boost = torch.where(minc == 0.0, -1.0, (minc - cur) / minc_safe)
        even = torch.where(
            cur != minc, delta_boost,
            torch.where(minc == maxc, -1.0,
                        torch.where(minc == 0.0, 1.0,
                                    (maxc - minc) / minc_safe)))
        even = torch.where(tok == v - 1, -1.0, even)
        even = torch.where(torch.any(seen), even, 0.0)
        boost = torch.where(p.spread_has_targets[s], target, even)
        tab[s] = torch.where(p.spread_active[s], boost, 0.0)
    return tab
