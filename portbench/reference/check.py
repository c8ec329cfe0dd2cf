"""Plain reference of what the state must hold after a run.

Works out, from the inputs the benchmark made (the spec drawn from the
seed and the loop's actions), which jobs must be running, what each of
their allocs must ask for, where each may lie, what every node must have
in use, and which node each placement should have gone to; then holds
the program's read-back state and choices to it. NumPy, and torch only
for the lower-precision control; imports nothing of the port.

The readback (`portbench/harness.py` `readback`) is plain data:
`allocs`, one (alloc id, node id, job id, cpu, memory MB, disk MB,
device ids) per non-terminal alloc in the state store; `jobs`, job id ->
the same rows with a terminal flag, for every alloc of each job the loop
registered; `used`, node id -> (cpu, memory MB, disk MB) of the
program's own accounting; `evals`, eval id -> terminal status; `rows`,
the node id of each row of the program's cluster view (None for a free
row); and `taps`, a sample of the window's chain dispatches, each the
use the kernel read, [rows, R] with the columns cpu, memory, disk,
network and then device pools; the rows it chose, [programs, steps] with
-1 where it chose none; and the job of the traffic each program placed,
in chain order (None for an eval the loop did not submit).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

#: the gap given to a choice of a node the job may not run on, or that
#: has no room: above any gap between two scores, which lie in [-2, 1]
INFEASIBLE_GAP = 10.0
#: fewest placements the ranking check has to judge in a run
MIN_JUDGED = 200
#: each number's limit (see PERF.md: the readings each was set from);
#: a number not named here is an exact count with the limit 0
LIMITS = {"rank_gap": 1e-3, "occupancy_drift": 3200.0}


def live_jobs(actions: List[Tuple[str, int]]) -> set:
    """Indices of the jobs that must be running after the loop's actions."""
    live = set()
    for kind, k in actions:
        if kind == "register":
            live.add(k)
        else:
            live.discard(k)
    return live


def _attr(node, ltarget: str):
    return {"${attr.kernel.name}": "linux",
            "${node.class}": node.node_class,
            "${node.datacenter}": node.datacenter}.get(ltarget)


def _satisfies(node, constraints) -> bool:
    for lt, op, rt in constraints:
        v = _attr(node, lt)
        if op in ("=", "==", "is") and v != rt:
            return False
        if op in ("!=", "not") and v == rt:
            return False
    return True


def _affinity(node, affinity) -> float:
    """The node's normalised affinity score: the matched weights over the
    sum of the weights' sizes (one affinity here)."""
    if not affinity:
        return 0.0
    a = affinity
    v = _attr(node, a["ltarget"])
    hit = (v == a["rtarget"]) if a["operand"] in ("=", "==", "is") \
        else (v != a["rtarget"])
    return float(a["weight"]) / abs(float(a["weight"])) if hit else 0.0


def expected_usage(spec, placements, dtype=np.int64):
    """Every node's use [n, 3] (cpu, memory MB, disk MB) in `dtype`: the
    filler allocs and, on each node the program placed a live job's
    alloc, that job's ask. Summed in the order of the inputs, one alloc
    at a time."""
    n = len(spec.nodes)
    row = {ns.id: ns.index for ns in spec.nodes}
    rows, asks = [], []
    for fa in spec.filler_allocs:
        rows.append(fa.node)
        asks.append((fa.cpu, fa.memory_mb, fa.disk_mb))
    for node_id, k in placements:
        js = spec.job(k)
        rows.append(row[node_id])
        asks.append((js.cpu, js.memory_mb, js.disk_mb))
    if dtype == np.int64:
        out = np.zeros((n, 3), dtype=np.int64)
        np.add.at(out, np.asarray(rows, dtype=np.int64),
                  np.asarray(asks, dtype=np.int64))
        return out
    import torch

    out = torch.zeros((n, 3), dtype=dtype)
    idx = torch.as_tensor(rows)
    val = torch.as_tensor(asks, dtype=dtype)
    # one alloc at a time, each add rounded to `dtype`, in input order
    order = np.argsort(np.asarray(rows), kind="stable")
    counts = np.bincount(np.asarray(rows), minlength=n)
    depth = int(counts.max()) if len(rows) else 0
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(rows)) - np.repeat(starts, counts)
    for d in range(depth):
        take = torch.as_tensor(order[pos == d])
        out.index_add_(0, idx[take], val[take])
    return out.float().numpy().astype(np.float64)


class _Rows:
    """The reference's view of the program's rows: each row's capacity
    (the view's columns; no node has devices, so those read 0), whether
    a job of the spec may run there, and its affinity score."""

    def __init__(self, spec, row_ids: List[Optional[str]], r: int):
        nodes = {ns.id: ns for ns in spec.nodes}
        js = spec.job(0)
        n = len(row_ids)
        self.cap = np.zeros((n, r), dtype=np.float64)
        self.ok = np.zeros(n, dtype=bool)
        self.aff = np.zeros(n, dtype=np.float64)
        for i, nid in enumerate(row_ids):
            ns = nodes.get(nid)
            if ns is None:
                continue
            self.cap[i, :3] = ns.capacity(spec.reserved)
            self.cap[i, 3] = ns.mbits
            self.ok[i] = (ns.datacenter in js.datacenters
                          and _satisfies(ns, js.constraints))
            self.aff[i] = _affinity(ns, js.affinity)


def _scores(rows: _Rows, used, tg, ask, count, sel=None):
    """Each row's final score in float64 (the bin-pack fit, the job
    anti-affinity where the group already has an alloc on the row, and
    the affinity where it is not 0, averaged over the terms included) and
    whether the ask fits; over the rows `sel`, or all."""
    s = slice(None) if sel is None else sel
    util = used[s] + ask
    cap = rows.cap[s]
    fits = rows.ok[s] & np.all(util <= cap, axis=1)
    free_cpu = 1.0 - util[..., 0] / np.maximum(cap[..., 0], 1.0)
    free_mem = 1.0 - util[..., 1] / np.maximum(cap[..., 1], 1.0)
    fit = np.clip(20.0 - (10.0 ** free_cpu + 10.0 ** free_mem), 0, 18) / 18
    t = tg[s]
    collide = t > 0
    aff = rows.aff[s]
    inc_aff = aff != 0.0
    total = (fit + np.where(collide, -(t + 1.0) / max(count, 1), 0.0)
             + np.where(inc_aff, aff, 0.0))
    return total / (1.0 + collide + inc_aff), fits


def _scores_low(rows: _Rows, used, tg, ask, count, dtype):
    """The same scores computed in `dtype` (a torch type below float32),
    for the control."""
    import torch

    def t(x):
        return torch.as_tensor(x).to(dtype)

    util = t(used) + t(ask)
    cap = t(rows.cap)
    fits = torch.as_tensor(rows.ok) & torch.all(util <= cap, dim=1)
    free_cpu = 1.0 - util[:, 0] / torch.clamp(cap[:, 0], min=1.0)
    free_mem = 1.0 - util[:, 1] / torch.clamp(cap[:, 1], min=1.0)
    ten = t(10.0)
    fit = torch.clamp(20.0 - (ten ** free_cpu + ten ** free_mem), 0, 18) / 18
    tg_t = t(tg)
    collide = tg_t > 0
    aff = t(rows.aff)
    inc_aff = aff != 0
    total = (fit + torch.where(collide, -(tg_t + 1.0) / max(count, 1),
                               t(0.0))
             + torch.where(inc_aff, aff, t(0.0)))
    final = total / (1.0 + collide.to(dtype) + inc_aff.to(dtype))
    return torch.where(fits, final, t(-1e30))


def rank_gaps(spec, readback, low_dtype=None) -> Tuple[float, int]:
    """The widest gap, over the sampled dispatches' placements, by which
    the chosen row's score lies below the best feasible row's, each step
    scored against the use the kernel read plus the placements before it
    in the chain; and the number of placements judged. A program is
    judged when it places a whole job of the traffic (a first attempt:
    the job had no allocs); the chain is followed up to its first
    program that places something and is not so judged. With
    `low_dtype`, each step's choice is the control's: the reference's
    own argmax in that type, judged the same way."""
    row_ids = readback["rows"]
    worst, judged = 0.0, 0
    rows = None
    for used0, sel, jobs in readback["taps"]:
        if rows is None:
            rows = _Rows(spec, row_ids, used0.shape[1])
        used = np.asarray(used0, dtype=np.float64).copy()
        for b, prog in enumerate(np.asarray(sel)):
            chosen = [int(x) for x in prog if x >= 0]
            if not chosen:
                continue
            k = jobs[b] if b < len(jobs) else None
            if k is None or len(chosen) != spec.job(k).count:
                break
            js = spec.job(k)
            ask = np.zeros(used.shape[1])
            ask[:3] = (js.cpu, js.memory_mb, js.disk_mb)
            tg = np.zeros(len(row_ids))
            final, fits = _scores(rows, used, tg, ask, js.count)
            masked = np.where(fits, final, -np.inf)
            for x in chosen:
                pick = x
                if low_dtype is not None:
                    import torch

                    low = _scores_low(rows, used, tg, ask, js.count,
                                      low_dtype)
                    pick = int(torch.argmax(low.float()))
                gap = (masked.max() - masked[pick]
                       if np.isfinite(masked[pick]) else INFEASIBLE_GAP)
                worst = max(worst, float(gap))
                judged += 1
                # the program's own choice carries, as in the kernel
                used[x] += ask
                tg[x] += 1
                f, ok = _scores(rows, used, tg, ask, js.count,
                                sel=np.array([x]))
                masked[x] = f[0] if ok[0] else -np.inf
    return worst, judged


def check(spec, actions, readback, low_dtype=None,
          notes: Optional[Dict] = None) -> Dict[str, float]:
    """The numbers compared, each to be held against its limit
    (`LIMITS`, else 0: an exact count or an exact sum). With `low_dtype`
    the reference, computed in that type, takes the program's place: its
    tallies stand for the program's accounting and its choices for the
    kernel's (the control)."""
    nodes = {ns.id: ns for ns in spec.nodes}
    jobs = {spec.job(k).id: k for _kind, k in actions}
    filler_ids = {fa.id: fa for fa in spec.filler_allocs}
    live = live_jobs(actions)

    incomplete = sum(1 for st in readback["evals"].values()
                     if st != "complete")

    filler_seen = stray = infeasible = count_err = 0
    placements = []
    for aid, node_id, job_id, cpu, mem, disk, dev_ids in readback["allocs"]:
        node = nodes.get(node_id)
        if aid in filler_ids:
            fa = filler_ids[aid]
            filler_seen += 1
            if (node is None or node.index != fa.node
                    or (cpu, mem, disk) != (fa.cpu, fa.memory_mb, fa.disk_mb)):
                stray += 1
        elif job_id in jobs and node is not None:
            placements.append((node_id, jobs[job_id]))
        else:
            stray += 1
    # every job the loop registered got its count, each alloc where the
    # job may run and with the job's ask; the live ones still run and the
    # retired ones (completed by their clients) do not
    for job_id, k in jobs.items():
        js = spec.job(k)
        rows = readback["jobs"].get(job_id, [])
        running = sum(1 for r in rows if not r[-1])
        count_err += abs(js.count - len(rows))
        count_err += abs((js.count if k in live else 0) - running)
        for _aid, node_id, _job, cpu, mem, disk, dev_ids, _term in rows:
            node = nodes.get(node_id)
            ok = (node is not None and node.datacenter in js.datacenters
                  and _satisfies(node, js.constraints)
                  and (cpu, mem, disk) == (js.cpu, js.memory_mb, js.disk_mb)
                  and not dev_ids)
            infeasible += 0 if ok else 1
    count_err += stray + abs(len(spec.filler_allocs) - filler_seen)

    ref = expected_usage(spec, placements)
    if low_dtype is None:
        prog = np.zeros_like(ref, dtype=np.float64)
        for node_id, use in readback["used"].items():
            if node_id in nodes:
                prog[nodes[node_id].index] = use
    else:
        prog = expected_usage(spec, placements, dtype=low_dtype)
    cap = np.asarray([ns.capacity(spec.reserved) for ns in spec.nodes],
                     dtype=np.int64)
    # the filler is drawn without regard to room, as the synthetic
    # cluster draws it; a node the scheduler placed on must have room
    placed_on = np.zeros(len(spec.nodes), dtype=bool)
    for node_id, _k in placements:
        placed_on[nodes[node_id].index] = True
    gap, judged = rank_gaps(spec, readback, low_dtype)
    if notes is not None:
        notes["rank_judged"] = judged
    return {
        "evals_incomplete": float(incomplete),
        "alloc_count_err": float(count_err),
        "infeasible": float(infeasible),
        "usage_gap": float(np.abs(prog - ref).max()),
        "overcommit": float((np.any(ref > cap, axis=1) & placed_on).sum()),
        # the traffic holds the cluster at the configuration's running
        # allocs: once the pending evals are done, exactly
        "alloc_level_err": float(abs(len(readback["allocs"])
                                     - spec.config["running_allocs"])),
        "rank_gap": gap,
        "rank_unjudged": float(max(MIN_JUDGED - judged, 0)),
    }
