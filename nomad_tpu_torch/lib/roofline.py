"""Roofline accounting for the port's hand-written kernels on NVIDIA cards.

- The static cost of one call (operations, bytes accessed), counted by
  `kernel_cost` for the reference function the kernel computes: each
  input the function needs read once, each output written once, against
  the operations of the function's own work on these inputs. Where that
  work depends on the data (a step after one that placed nothing, with
  the same penalty rows, changes nothing), the count reads this run's
  selections: they are outputs, bitwise equal on every route. A count
  never reads the route that ran, so two routes of one function on the
  same inputs have one count. torch has no cost model for a hand-written
  kernel, hence the counts here.
- Device peaks from NVIDIA's published H100 datasheet, keyed by a
  substring of `torch.cuda.get_device_name`: fp32 FLOP/s of the CUDA
  cores, not the tensor cores (every kernel of the port is f32/int32
  scalar work with no matrix product), and HBM bytes/s. They are the
  datasheet's boost-clock ceilings, not measurements: a card held below
  its power limit runs under them.
- `summarize` places one timed call on the roofline: arithmetic intensity
  against the ridge point says whether the call is compute- or
  bandwidth-bound, and the achieved/peak fractions how close to the
  ceiling it runs. On the CPU or an unknown card the peaks are null and
  only achieved rates are reported.

Imports no torch at module level; the counts that read tensors load it.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

#: torch.cuda.get_device_name substring -> (fp32 non-tensor FLOP/s, HBM
#: bytes/s), NVIDIA H100 datasheet: SXM5 ("H100 80GB HBM3") 67 TFLOP/s,
#: 3.35 TB/s; PCIe 51 TFLOP/s, 2.0 TB/s; NVL 60 TFLOP/s, 3.9 TB/s
DEVICE_PEAKS: Tuple[Tuple[str, Tuple[float, float]], ...] = (
    ("H100 80GB HBM3", (67e12, 3.35e12)),
    ("H100 PCIe", (51e12, 2.0e12)),
    ("H100 NVL", (60e12, 3.9e12)),
)


def device_peaks(device) -> Tuple[Optional[float], Optional[float], str]:
    """(peak_flops_per_s, peak_hbm_bytes_per_s, kind) of one torch device;
    (None, None, kind) for the CPU or a card not in the table."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return None, None, device.type
    kind = torch.cuda.get_device_name(device)
    low = kind.lower()
    for sub, peaks in DEVICE_PEAKS:
        if sub.lower() in low:
            return peaks[0], peaks[1], kind
    return None, None, kind


def bound_ms(cost: Dict[str, float], peaks) -> Tuple[float, str]:
    """Least milliseconds a call of static `cost` takes at `peaks`
    ((FLOP/s, bytes/s), as `device_peaks` gives them), and which of the
    two roofs bounds it: "bytes" or "operations"."""
    t_bytes = cost["bytes_accessed"] / peaks[1] * 1e3
    t_ops = cost["flops"] / peaks[0] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_compiled(call: Callable[[], Any], iters: int = 10, warmup: int = 2,
                  device=None) -> float:
    """Mean wall seconds per call of `call()`, its card synchronised
    before and after the timed loop (`device`; None: the current card
    when there is one; a CPU device: no synchronisation)."""
    sync = _synchronizer(device)
    for _ in range(max(warmup, 0)):
        call()
    sync()
    n = max(iters, 1)
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    sync()
    return (time.perf_counter() - t0) / n


def _synchronizer(device) -> Callable[[], None]:
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return lambda: None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return lambda: None
    return lambda: torch.cuda.synchronize(device)


def summarize(name: str, cost: Dict[str, float], seconds_per_call: float,
              device) -> Dict[str, Any]:
    """One kernel's roofline placement. `seconds_per_call` times ONE
    call whose static cost is `cost`."""
    peak_flops, peak_bw, kind = device_peaks(device)
    flops = cost.get("flops", 0.0)
    bytes_ = cost.get("bytes_accessed", 0.0)
    out: Dict[str, Any] = {
        "kernel": name,
        "device_kind": kind,
        "flops_per_dispatch": flops,
        "bytes_per_dispatch": bytes_,
        "seconds_per_dispatch": round(seconds_per_call, 6),
        "achieved_flops_per_sec": (round(flops / seconds_per_call, 1)
                                   if seconds_per_call else None),
        "achieved_bytes_per_sec": (round(bytes_ / seconds_per_call, 1)
                                   if seconds_per_call else None),
        "arithmetic_intensity_flops_per_byte": (
            round(flops / bytes_, 4) if bytes_ else None),
        "peak_flops_per_sec": peak_flops,
        "peak_hbm_bytes_per_sec": peak_bw,
    }
    if peak_flops and peak_bw and seconds_per_call and bytes_:
        intensity = flops / bytes_
        ridge = peak_flops / peak_bw  # FLOP/byte where the roofs meet
        out["ridge_point_flops_per_byte"] = round(ridge, 2)
        out["bound"] = "compute" if intensity >= ridge else "memory"
        out["pct_of_peak_flops"] = round(
            100.0 * (flops / seconds_per_call) / peak_flops, 3)
        out["pct_of_peak_hbm_bw"] = round(
            100.0 * (bytes_ / seconds_per_call) / peak_bw, 3)
        # the roofline-attainable time for this kernel on this device:
        # max(compute roof, bandwidth roof); headroom is measured/ideal
        ideal_s = max(flops / peak_flops, bytes_ / peak_bw)
        out["roofline_attainable_s"] = round(ideal_s, 9)
        out["headroom_x"] = (round(seconds_per_call / ideal_s, 2)
                             if ideal_s else None)
    else:
        out["bound"] = "unknown"
        out["note"] = ("no published peak for this device; achieved "
                       "rates only")
    return out


# ---- the counts: one per reference function ----

def kernel_cost(kernel: str, **inputs) -> Dict[str, float]:
    """{"flops": .., "bytes_accessed": ..} of one call of the reference
    function `kernel` on `inputs` (the keyword arguments of its count
    below). A sharded view's call is the same function's: pass the whole
    view as `cluster`."""
    try:
        count = _COUNTS[kernel]
    except KeyError:
        raise ValueError(f"no count for {kernel!r}; counted: "
                         f"{sorted(_COUNTS)}") from None
    bytes_, ops, *extra = count(**inputs)
    out = {"flops": float(ops), "bytes_accessed": float(bytes_)}
    if extra:
        out.update(extra[0])
    return out


def _host(p):
    """A program (a named tuple of tensors) on the host."""
    return type(p)(*(t.cpu() for t in p))


def _programs(batch) -> list:
    """The programs of a batched program, each on the host."""
    batch = _host(batch)
    return [type(batch)(*(t[b] for t in batch))
            for b in range(batch.n_place.shape[0])]


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _io(cluster, p, m: int, own_carry: bool = True):
    """One program's bytes: (view read, program read, outputs written).
    `own_carry` counts new_used and final_scores0 as its outputs; a
    chain program writes only its per-step outputs."""
    n, r = cluster.capacity.shape
    c, a = p.key_idx.shape[0], p.aff_key_idx.shape[0]
    s, q = p.spread_key_idx.shape[0], p.dp_key_idx.shape[0]
    words = len({int(x) >> 5 for x in p.res_ports.tolist() if x >= 0})
    attr_b = cluster.attrs.element_size()
    view_in = (n * r * 4 * 2             # capacity, used
               + n * (1 + 4)             # node_ok, dyn_free
               + n * (c + a + s + q) * attr_b   # referenced attr columns
               + n * words * 4)          # referenced port words
    prog_in = ((n if p.extra_mask.shape[0] == n else 0)
               + sum(t.numel() * t.element_size() for t in p))
    bytes_out = m * 12 + 4                   # per step, nodes_feasible
    if own_carry:
        bytes_out += n * r * 4 + n * 4       # new_used, final0
    return view_in, prog_in, bytes_out


def _combine(parts, extra_out: int = 0):
    """(bytes, operations) of per-program parts: the view is read once
    however many programs read it; `extra_out` adds outputs written once
    per call (a carry)."""
    view = max(v for v, _p, _o, _ops in parts)
    bytes_ = view + sum(p + o for _v, p, o, _ops in parts) + extra_out
    return bytes_, sum(x[3] for x in parts)


def _active_steps(p, sel) -> int:
    """Steps that do row work for one program with selections `sel`
    (this run's): a step past n_place after a step that placed nothing,
    with the previous step's penalty rows, changes nothing."""
    pen = p.penalty_idx.tolist()
    n_place = int(p.n_place)
    return sum(1 for s in range(len(sel))
               if not (s > 0 and s >= n_place and int(sel[s - 1]) < 0
                       and pen[s] == pen[s - 1]))


def _onchip_ops(cluster, p, m: int) -> int:
    """Operations of one program when a row's score terms are computed
    once and then only what a step changes: every row's entry from the
    view once (the fit over R, the score prefix, the constraint,
    affinity, token and port lookups); the rows the program's lists name
    recomputed from all their terms, with the repeat check; per row and
    step the spread table lookups and adds, the distinct_property mask
    lookups and tests, the bit test, the prefix add, the divide and the
    argmax compare; per step the spread and distinct_property tables,
    and the placed row and the penalty rows recomputed."""
    n, r = cluster.capacity.shape
    c, a = p.key_idx.shape[0], p.aff_key_idx.shape[0]
    s, q = p.spread_key_idx.shape[0], p.dp_key_idx.shape[0]
    sv, dv = p.spread_desired.shape[-1], p.dp_counts0.shape[-1]
    j, j2, d = p.jc_idx.shape[0], p.jtc_idx.shape[0], p.delta_idx.shape[0]
    pc, ps = p.pclr_idx.shape[0], p.pset_idx.shape[0]
    pn = p.penalty_idx.shape[1]
    row = 2 * r + 40 + c + a + s + q + p.res_ports.shape[0]
    recompute = row + d * r + j + j2 + pc + ps
    lists = d + j + j2 + pc + ps + p.cand_idx.shape[0]
    return (n * row + lists * (recompute + lists)
            + n * m * (2 * s + 2 * q + 5)
            + m * (s * sv * 14 + q * dv * 3 + (1 + pn) * (recompute + m * r)))


def _lane_ops(cluster, p, m: int, explain: bool, steps: int) -> int:
    """Operations of one program of a chain, `steps` of its m steps run:
    `_onchip_ops`, the new carry of the rows the program touched, and
    with explain the static filter counts a row, the filter tests and
    the top-K insertion a row step, and per step the top-K merges and the
    K rows' parts recomputed."""
    n, r = cluster.capacity.shape
    c, d = p.key_idx.shape[0], p.delta_idx.shape[0]
    ops = _onchip_ops(cluster, p, steps) + (d + m) * (r * (m + 2) + m + 2)
    if explain:
        k = min(5, n)
        row = 2 * r + 40 + c + p.aff_key_idx.shape[0]
        ops += (n * (c + p.cand_idx.shape[0] + 3) + n * steps * (6 + 2 * k)
                + steps * k * (row + d * r + 16 * 8 + 5))
    return ops


def _task_group_cost(cluster, program, m: int, sel, explain: bool = True):
    """`place_task_group` (K1; B11 on a sharded view): the view read
    once, the program's fields, its per-step outputs with new_used and
    final_scores0; the operations of the steps `sel` makes it run."""
    p = _host(program)
    ops = _lane_ops(cluster, p, m, explain, _active_steps(p, sel.cpu()))
    return _combine([(*_io(cluster, p, m), ops)])


def _chain_cost(cluster, programs, m: int, sel, explain: bool = True,
                lanes: int = 1):
    """`place_table_chain` / `place_packed_chain` (K4; B10 on a sharded
    view) and, with `lanes` > 1, `place_table_wave` (K5): the view read
    once, every program's fields and per-step outputs, the final carry
    (and a wave's collision count) written once; each program's
    operations over the steps its selections `sel` ([programs, m]) make
    it run."""
    n, r = cluster.capacity.shape
    progs = _programs(programs)
    sel = sel.reshape(len(progs), -1).cpu()
    parts = [(*_io(cluster, p, m, own_carry=False),
              _lane_ops(cluster, p, m, explain, _active_steps(p, sel[b])))
             for b, p in enumerate(progs)]
    carry = n * r * 4 + n * 4 + (4 if lanes > 1 else 0)
    return _combine(parts, extra_out=carry)


def _packed_batch_cost(cluster, programs, m: int):
    """`place_packed_batch` (K6): the view read once, every program's
    fields, its sel_idx and sel_score; the operations of `_onchip_ops`."""
    parts = []
    for p in _programs(programs):
        v, pr, _o = _io(cluster, p, m)
        parts.append((v, pr, m * 8, _onchip_ops(cluster, p, m)))
    return _combine(parts)


def _step_cost(cluster, programs, m: int, sel):
    """`scheduler_step` (K9): the view once, every program's fields and
    outputs, new_used [B, N, R] among them; each program's operations
    over the steps its selections make it run, and the fold's two a
    carry element."""
    n, r = cluster.capacity.shape
    sel = sel.cpu()
    parts = [(*_io(cluster, p, m),
              _lane_ops(cluster, p, m, False, _active_steps(p, sel[b]))
              + 2 * n * r)
             for b, p in enumerate(_programs(programs))]
    return _combine(parts)


def _system_cost(cluster, program):
    """`system_feasibility` (K2; B12 on a sharded view): capacity, used,
    node_ok, dyn_free, the referenced attribute columns and port words
    and the program's fields read, two bool[N] written."""
    p = _host(program)
    n, r = cluster.capacity.shape
    c, d = p.key_idx.shape[0], p.delta_idx.shape[0]
    pp, pc, ps = (p.res_ports.shape[0], p.pclr_idx.shape[0],
                  p.pset_idx.shape[0])
    words = len({int(x) >> 5 for x in p.res_ports.tolist() if x >= 0})
    bytes_ = (n * r * 4 * 2 + n * (1 + 4)
              + n * c * cluster.attrs.element_size()
              + n * words * 4 + 2 * n
              + _nbytes(p.ask, p.key_idx, p.lut, p.extra_mask, p.delta_idx,
                        p.delta_res, p.res_ports, p.n_dyn, p.pclr_idx,
                        p.pclr_port, p.pset_idx, p.pset_port))
    ops = n * (c + 2 * r + d * (r + 1) + pp * (pc + ps + 2) + 2 * (pc + ps))
    return bytes_, ops


def _preempt_walk(cluster, p, candidates, order) -> int:
    """Candidate slots the prefix walk must read on this data: up to the
    first fitting prefix, or up to the first ineligible slot where none
    fits (summed over rows)."""
    import torch

    from ..kernels.preemption import INF_PRIO

    prio_s = torch.gather(candidates.prio, 1, order.long())
    elig = torch.cumprod((prio_s < INF_PRIO).int(), dim=1).bool()
    r = cluster.capacity.shape[1]
    usage_s = torch.gather(candidates.usage, 1,
                           order.long()[:, :, None].expand(-1, -1, r))
    util = (cluster.used[:, None, :] - torch.cumsum(usage_s, dim=1)) \
        + p.ask[None, None, :]
    fits = torch.all(util <= cluster.capacity[:, None, :], dim=2) & elig
    first = torch.argmax(fits.int(), dim=1) + 1
    walked = torch.where(fits.any(dim=1), first, elig.sum(dim=1))
    return int(walked.sum())


def _preempt_cost(cluster, program, candidates, order, entries=None):
    """`preempt_rank` (K3): every row's priorities (the rank sort), the
    usage rows its walk reaches, capacity, used, node_ok, the referenced
    attribute columns read; order, feasible, scores and the three
    scalars written. Its operations: A² rank compares a row, R per
    walked slot. On the dense table the priorities are N·A words; on the
    compact table of `entries` real victims they are the row offsets and
    each entry's slot and priority (the kernel writes the pads itself).
    Also returns the slots walked."""
    p = program
    n, a = candidates.prio.shape
    r = cluster.capacity.shape[1]
    walked = _preempt_walk(cluster, p, candidates, order)
    cols = p.key_idx.shape[0] + p.dp_key_idx.shape[0]
    table = n * a * 4 if entries is None else 4 * (n + 1) + 8 * entries
    bytes_ = (table + walked * r * 4 + n * r * 4 * 2 + n
              + n * cols * cluster.attrs.element_size()
              + n * a * 4 + n + n * 4 + 12
              + _nbytes(p.ask, p.key_idx, p.lut, p.extra_mask, p.jc_idx,
                        p.jc_val, p.dp_key_idx, p.dp_counts0))
    ops = n * a * a * 2 + walked * (r * 3 + 1) + n * (cols + 20)
    return bytes_, ops, {"slots_walked": walked}


def _view_delta_cost(hot_rows: int, r: int, port_rows: int = 0,
                     port_words: int = 0, words_per_row: int = 0):
    """The view's row delta (K7; B13 a shard copy at a time, `hot_rows`
    summed over the copies): a hot row reads its index, used, node_ok
    and dyn_free and writes the last three; a port row reads its index
    and bitmap row and writes the row; a port word reads its row, column
    and value and writes the word."""
    w = words_per_row
    return (hot_rows * (4 + 4 * r + 1 + 4) + hot_rows * (4 * r + 1 + 4)
            + port_rows * (4 + 4 * w) + port_rows * 4 * w
            + port_words * 12 + port_words * 4), 0


def _table_insert_cost(table_rows: int, rows: int, widths):
    """The program-table insert (K8) of `rows` rows into the three class
    tables of `table_rows` rows, `widths` = their (i32, f32, u8) row
    widths in elements: the three tables read and written, the rows and
    their indices read."""
    li, lf, lu = widths
    return (2 * table_rows * (4 * li + 4 * lf + lu)
            + rows * (4 + 4 * li + 4 * lf + lu)), 0


_COUNTS: Dict[str, Callable] = {
    "place_task_group": _task_group_cost,
    "place_table_chain": _chain_cost,
    "place_packed_chain": _chain_cost,
    "place_task_group_chain": _chain_cost,
    "place_table_wave": _chain_cost,
    "place_packed_batch": _packed_batch_cost,
    "scheduler_step": _step_cost,
    "system_feasibility": _system_cost,
    "preempt_rank": _preempt_cost,
    "view_delta": _view_delta_cost,
    "table_insert": _table_insert_cost,
}
