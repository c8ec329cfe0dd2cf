"""The on-chip scan's row arithmetic in torch, for the CPU models of
K6's on-chip route (`tests/test_torch_batch_onchip.py`) and the lane
route of csrc/lanes.cu — chains and waves
(`tests/test_torch_lanes_onchip.py`), the single program and the sharded
step (`tests/test_torch_cluster_routes.py`): a row's entry terms, the
carry after a program's placements, the spread table, and the lane
model itself (`program_model`, `lane_chain_model`, `wave_model`). Every
expression is the plain version's (`kernels/placement.py` `_step_plain`,
`_spread_boost`), so the models can be held bitwise to it.
"""
import numpy as np
import torch

from nomad_tpu_torch.kernels import placement as tp

NEG_INF = tp.NEG_INF
LOWEST = -3.4028234663852886e38
NONE = 0x7FFFFFFF


def terms(cluster, p, st, used, jc, tgc, splaced, penalty,
          fit=tp.fit_scores):
    """Every row's entry for the carry given: (prefix, term count, fit
    bit, distinct_hosts bit), step_rows' arithmetic up to the spread term
    (the fit over whole columns, as the plain version takes it, by `fit`:
    `sliced_fit` takes it a node shard at a time)."""
    cap = cluster.capacity
    util = used + p.ask[None, :]
    any_over = torch.any(util > cap, dim=1)
    dyn_ok = (st["dyn_free"] - splaced * p.n_dyn) >= p.n_dyn
    res_ok = st["res_free"] & ~(st["has_res_ask"] & (splaced > 0))
    fit_bit = st["feas"] & ~any_over & dyn_ok & res_ok
    dh = p.distinct_hosts & (jc > 0)
    binpack, spreadfit = fit(util, cap)
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


def sliced_fit(slices):
    """`fit_scores` taken over each row slice on its own, as the plain
    sharded version takes it a shard at a time: torch's CPU exp2 may round
    a row an ulp apart in a tensor of another length (its vector loop and
    its scalar tail), so a model held bitwise to a sharded version takes
    it over the same lengths."""
    def fit(util, cap):
        parts = [tp.fit_scores(util[a:b], cap[a:b]) for a, b in slices]
        return tuple(torch.cat(x) for x in zip(*parts))
    return fit


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


# ---- the model -----------------------------------------------------------------


def _exh(cluster, p, st, used, splaced):
    """Every row's exhaustion code for the carry given (`row_exh`): 0 it
    fits, 1 + r dimension r the first over capacity, R + 1 no dynamic
    port, R + 2 a reserved port taken."""
    r_dims = cluster.capacity.shape[1]
    over = (used + p.ask[None, :]) > cluster.capacity
    first = torch.argmax(over.to(torch.uint8), dim=1)
    dyn_ok = (st["dyn_free"] - splaced * p.n_dyn) >= p.n_dyn
    res_ok = st["res_free"] & ~(st["has_res_ask"] & (splaced > 0))
    code = torch.where(~res_ok, r_dims + 2, 0)
    code = torch.where(~dyn_ok, r_dims + 1, code)
    return torch.where(over.any(dim=1), 1 + first, code)


def _parts(cluster, p, st, used, tgc, penalty, sp, fit=tp.fit_scores):
    """Every row's five score parts (step_rows' `parts`)."""
    binpack, spreadfit = fit(used + p.ask[None, :], cluster.capacity)
    fit = torch.where(p.algorithm == 1, spreadfit, binpack)
    anti = -(tgc + 1.0) / torch.clamp(p.desired_count, min=1.0)
    aff = st["aff_score"]
    return torch.stack((fit, torch.where(tgc > 0, anti, 0.0),
                        torch.where(penalty, -1.0, 0.0),
                        torch.where(aff != 0.0, aff, 0.0),
                        torch.where(sp != 0.0, sp, 0.0)), dim=1)


def _static_rows(cluster, p):
    """Per row: the node is evaluated (node_ok and a sampled candidate),
    every constraint LUT row accepts it, the extra mask, and which
    constraints fail (static_row's bits)."""
    n = cluster.capacity.shape[0]
    v = p.lut.shape[1]
    fails = (~tp._lookup(p.lut, tp._tokens(cluster.attrs, p.key_idx, v))
             if p.lut.shape[0] else torch.zeros((n, 0), dtype=torch.bool))
    base = cluster.node_ok.clone()
    if p.cand_idx.shape[0]:
        in_cand = tp._scatter(p.cand_idx, torch.ones(p.cand_idx.shape[0]),
                              n) > 0
        base = base & (in_cand | ~p.use_cand)
    extra = p.extra_mask.expand(n)
    return base, ~fails.any(dim=1), extra, fails


def program_model(cluster, p, m, slices, explain, fit=tp.fit_scores):
    """One program on the blocks' row slices (`cluster` holding the
    lane's carry for every row): (per-step outputs — step 0's masked
    score of every row among them, "final0" — the rows it placed on, the
    view's used less the program's deltas). Every block's record is built
    from its rows alone and the records are combined; `fit` as `terms`
    takes it."""
    i32 = torch.int32
    n = cluster.capacity.shape[0]
    k_top = min(tp.EXPLAIN_TOPK, n)
    st = tp._static_plain(cluster, p, False)
    zero = torch.zeros(n)
    no_pen = torch.zeros(n, dtype=torch.bool)
    prefix, cnt, fit_bit, dh = terms(cluster, p, st, st["used"],
                                     st["job_cnt"], st["tg_cnt"], zero, no_pen,
                                     fit)
    exh = _exh(cluster, p, st, st["used"], zero)
    feas, stok, dtok = st["feas"], st["stok"], st["dtok"]
    scounts, dcounts = p.spread_counts0.clone(), p.dp_counts0.clone()
    dv, r_dims = dcounts.shape[1], cluster.capacity.shape[1]
    base, lut_all, extra, fails = _static_rows(cluster, p)
    out = dict(sel=[], score=[], fit=[], ex=[])
    out["feasible"] = sum(int(feas[a:b].sum()) for a, b in slices)
    if explain:
        st_counts = [sum(int(x[a:b].sum()) for a, b in slices) for x in (
            base, base & ~lut_all, base & lut_all & ~extra)]
        out["static"] = st_counts + [
            (fails[a:b] & base[a:b, None]).sum(dim=0) for a, b in slices]
    placed = []
    found = False
    for step in range(m):
        pens = p.penalty_idx[step].tolist()
        if (step > 0 and step >= int(p.n_place) and not found
                and pens == p.penalty_idx[step - 1].tolist()):
            # an idle step: the previous step's state, so its outputs
            out["sel"].append(-1)
            out["score"].append(torch.tensor(0.0))
            out["fit"].append(out["fit"][-1])
            if explain:
                out["ex"].append(out["ex"][-1])
            continue
        sptab = spread_table(scounts, p)
        dptab = (((dcounts < p.dp_allowed[:, None])
                  & (torch.arange(dv)[None, :] != dv - 1))
                 | ~p.dp_active[:, None])
        pen_mask = no_pen.clone()
        saved = {}
        for row in pens:
            if row < 0 or row >= n or row in saved:
                continue
            pen = no_pen.clone()
            pen[row] = True
            pen_mask[row] = True
            pp, pc, _f, _d = terms(cluster, p, st, *carry(st, p, placed, n),
                                   pen, fit)
            saved[row] = (prefix[row].clone(), cnt[row].clone())
            prefix[row], cnt[row] = pp[row], pc[row]
        dp_ok = torch.ones(n, dtype=torch.bool)
        for q in range(dtok.shape[1]):
            dp_ok = dp_ok & dptab[q][dtok[:, q]]
        ok = fit_bit & ~dh & dp_ok
        sp = torch.zeros(n)
        for s in range(stok.shape[1]):
            sp = sp + sptab[s][stok[:, s]]
        inc = sp != 0.0
        masked = torch.where(
            ok, (prefix + torch.where(inc, sp, 0.0)) / (cnt + inc.int())
            .float(), NEG_INF)
        if step == 0:
            out["final0"] = masked.clone()
        pref = int(p.preferred_idx[step])
        # each block's record
        recs = []
        for a, b in slices:
            rec = dict(best=(LOWEST, NONE), ok=False, fit=0, pref=None,
                       top=[], counts=np.zeros(4 + r_dims, np.int64))
            if b > a:
                li = int(torch.argmax(masked[a:b]))
                rec["best"] = (float(masked[a + li]), a + li)
                rec["ok"] = bool(ok[a + li])
                rec["fit"] = int(fit_bit[a:b].sum())
            if a <= pref < b and bool(ok[pref]):
                rec["pref"] = masked[pref]
            if explain and b > a:
                f, d_, dpm = feas[a:b], dh[a:b], dp_ok[a:b]
                dh_fail = f & d_
                dp_fail = (f & ~dh_fail & ~dpm if dtok.shape[1]
                           else torch.zeros_like(f))
                cand_m = f & ~dh_fail & ~dp_fail
                code = exh[a:b]
                rec["counts"] = np.array(
                    [int(dh_fail.sum()), int(dp_fail.sum()),
                     int((cand_m & (code == r_dims + 1)).sum()),
                     int((cand_m & (code == r_dims + 2)).sum())]
                    + [int((cand_m & (code == 1 + q)).sum())
                       for q in range(r_dims)])
                order = torch.sort(masked[a:b], descending=True,
                                   stable=True).indices[:k_top]
                rec["top"] = [(float(masked[a + i]), a + int(i))
                              for i in order]
            recs.append(rec)
        # the combine
        best = max((rc["best"] for rc in recs), key=lambda e: (e[0], -e[1]))
        best_rec = next(rc for rc in recs if rc["best"] == best)
        pref_recs = [rc for rc in recs if rc["pref"] is not None]
        found = (bool(pref_recs) or best_rec["ok"]) and step < int(p.n_place)
        idx = pref if pref_recs else best[1]
        out["sel"].append(idx if found else -1)
        out["score"].append((pref_recs[0]["pref"] if pref_recs
                             else masked[best[1]]) if found
                            else torch.tensor(0.0))
        out["fit"].append(sum(rc["fit"] for rc in recs))
        if explain:
            counts = sum(rc["counts"] for rc in recs)
            top = sorted((e for rc in recs for e in rc["top"]),
                         key=lambda e: (-e[0], e[1]))[:k_top]
            parts = _parts(cluster, p, st, carry(st, p, placed, n)[0],
                           carry(st, p, placed, n)[2], pen_mask, sp, fit)
            rows = torch.tensor([e[1] for e in top])
            keep = masked[rows] > NEG_INF / 2
            out["ex"].append((counts, rows, masked[rows],
                              parts[rows] * keep[:, None]))
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
            c_used, c_jc, c_tgc, c_sp = carry(st, p, placed, n)
            pv, cv, fv, dv_ = terms(cluster, p, st, c_used, c_jc, c_tgc,
                                    c_sp, no_pen, fit)
            prefix[idx], cnt[idx] = pv[idx], cv[idx]
            fit_bit[idx], dh[idx] = fv[idx], dv_[idx]
            exh[idx] = _exh(cluster, p, st, c_used, c_sp)[idx]
    return out, placed, st["used"]


def _program_outputs(out, m, explain, c):
    """One program's flat outputs, with explain its PlacementExplain."""
    i32 = torch.int32
    base = (torch.tensor(out["sel"], dtype=i32),
            torch.stack([torch.as_tensor(x) for x in out["score"]]).float(),
            torch.tensor(out["feasible"], dtype=i32),
            torch.tensor(out["fit"], dtype=i32))
    if not explain:
        return base
    st = out["static"]
    cols = list(zip(*out["ex"]))
    counts = np.stack(cols[0])
    ex = tp.PlacementExplain(
        nodes_evaluated=torch.tensor(st[0], dtype=i32),
        filt_constraint=sum(st[3:]).to(i32).reshape(c),
        filt_lut=torch.tensor(st[1], dtype=i32),
        filt_extra=torch.tensor(st[2], dtype=i32),
        filt_distinct=torch.tensor(counts[:, 0], dtype=i32),
        filt_dp=torch.tensor(counts[:, 1], dtype=i32),
        exh_dim=torch.tensor(counts[:, 4:], dtype=i32),
        exh_dyn_ports=torch.tensor(counts[:, 2], dtype=i32),
        exh_res_ports=torch.tensor(counts[:, 3], dtype=i32),
        topk_idx=torch.stack(cols[1]).to(i32),
        topk_score=torch.stack(cols[2]),
        topk_parts=torch.stack(cols[3]))
    return base + tuple(ex)


def program_carry(view_used, p, placed, used0):
    """A program's carry's used as the lane route writes it: the view's
    rows, and each row it held a delta for or placed on at used0 plus its
    asks, added one at a time."""
    n = view_used.shape[0]
    used = view_used.clone()
    touched = [x for x in p.delta_idx.tolist() if 0 <= x < n] + placed
    for row in dict.fromkeys(touched):
        u = used0[row].clone()
        for _ in range(placed.count(row)):
            u = u + p.ask
        used[row] = u
    return used


def single_model(cluster, p, m, slices, explain=False, fit=tp.fit_scores):
    """One program as one lane on the view (K1 on the lane route; a K9
    program over its node shards): (flat outputs, step 0's masked score
    of every row, the carry's used)."""
    out, placed, used0 = program_model(cluster, p, m, slices, explain, fit)
    return (_program_outputs(out, m, explain, p.key_idx.shape[0]),
            out["final0"], program_carry(cluster.used, p, placed, used0))


def lane_chain_model(cluster, batch, m, clusters, explain):
    """One lane's chain on C = `clusters` blocks: (flat outputs, the
    final (used, dyn_free) carry — the view with the overlay rows
    replaced — and the overlay)."""
    n = cluster.capacity.shape[0]
    rows = tp.lane_rows(n, clusters)
    slices = [(min(n, j * rows), min(n, (j + 1) * rows))
              for j in range(clusters)]
    view_u, view_d = cluster.used, cluster.dyn_free
    carry_u, carry_d = torch.zeros_like(view_u), torch.zeros_like(view_d)
    overlay = torch.zeros(n, dtype=torch.bool)
    outs = []
    for b in range(batch.n_place.shape[0]):
        p = tp._program(batch, b)
        src_u = torch.where(overlay[:, None], carry_u, view_u)
        src_d = torch.where(overlay, carry_d, view_d)
        out, placed, used0 = program_model(
            cluster._replace(used=src_u, dyn_free=src_d), p, m, slices,
            explain)
        outs.append(_program_outputs(out, m, explain, p.key_idx.shape[0]))
        touched = [x for x in p.delta_idx.tolist() if 0 <= x < n] + placed
        for row in dict.fromkeys(touched):
            u = used0[row].clone()
            for _ in range(placed.count(row)):
                u = u + p.ask
            carry_u[row] = u
            k = placed.count(row)
            carry_d[row] = (src_d[row] - torch.tensor(float(k)) * p.n_dyn
                            if k else src_d[row])
            overlay[row] = True
    flat = tuple(torch.stack(leaf) for leaf in zip(*outs))
    final = (torch.where(overlay[:, None], carry_u, view_u),
             torch.where(overlay, carry_d, view_d))
    return flat, final, overlay


def wave_model(cluster, lanes, m, clusters, explain):
    """L lane chains (stacked TGParams each) and the fold by value."""
    view_u, view_d = cluster.used, cluster.dyn_free
    outs, finals, overlays = [], [], []
    for batch in lanes:
        flat, final, overlay = lane_chain_model(cluster, batch, m, clusters,
                                                explain)
        outs.append(flat)
        finals.append(final)
        overlays.append(overlay)
    changed = [ov & ((u != view_u).any(dim=1) | (d != view_d))
               for ov, (u, d) in zip(overlays, finals)]
    count = torch.stack(changed).int().sum(dim=0)
    used, dyn = view_u.clone(), view_d.clone()
    for ch, (u, d) in zip(changed, finals):
        used[ch], dyn[ch] = u[ch], d[ch]
    flat = tuple(torch.cat(leaf) for leaf in zip(*outs))
    return (flat + (((count > 1).sum()).to(torch.int32),), (used, dyn),
            overlays, changed)
