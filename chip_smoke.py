#!/usr/bin/env python3
"""Drive the PyTorch port (`nomad_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any mismatch or error raises and the script exits
non-zero without printing a result:

1. The card: `torch.cuda.get_device_name()` and nvidia-smi's name and power
   limit.
2. Build the CUDA kernels from `nomad_tpu_torch/kernels/csrc` (one nvcc
   per source, all at once, into `build/`: placement, chain, lanes,
   batch, rows, system, preempt, shard), and print the build seconds and
   ptxas' registers and spills of each kernel.
3. Kernel against plain, at full width: the 10,000-node / 100,000-alloc
   synthetic cluster (N = 16384 rows), one program per case (binpack,
   spread algorithm, constraints, all-infeasible, affinity, spread targets,
   even spread, distinct_hosts, distinct_property, reserved and dynamic
   ports with plan releases/consumptions, delta and penalty rows, a
   preferred node, sampled candidates, GPU asks, n_place = 0), each with
   explain on and off. Indices and counts must be equal; scores, carries
   and top-K parts within 1e-6 (values in [-2, 1], one f32 ulp ≤ 2.4e-7;
   exp2f and torch.exp2 may differ by an ulp). Times the kernel and the
   plain version at the main path's shape.
4. The slice: `Harness(state)` on the card (the default device) processes
   8 service evals of count 10 (affinity, spread, distinct_hosts,
   distinct_property, GPU asks). All 80 allocs must be placed, the kernel's
   launch count must equal the number of selects, and every select's
   kernel output must equal the plain version on the CUDA inputs it read
   (a copy taken at the launch: later refreshes write the view in place).
5. The chain, wave and insert kernels against their plain versions at
   full width (N = 16384): a chain of B = 8 programs of the phase-3 mix
   through the device program table (a fresh table: its commit is one
   insert launch), explain on and off; the same at phase 6's dispatch
   shape, a chain of 16 programs of its mix; a wave of L = 3
   datacenter-pinned lanes of P = 4 programs, and a built stale-footprint
   wave whose lanes overlap (collisions > 0, equal in both). K4 and K5
   run on the lane route (`csrc/lanes.cu`, a lane one thread-block
   cluster of the C blocks `lane_route` picks) and on chain.cu's route:
   outputs and carries bitwise each other and 0.0 from plain, explain off
   and on; both timed in turns with the lane route at C = 1 (back-to-back
   CUDA events and the device span, kernel launches a dispatch — one a
   chain, two a wave — and peak memory), the bound by the lane route's
   operations count beside chain.cu's. The fused insert (K8) of 8
   random rows into the table's three class tables (T = 512) bitwise
   against its plain version on the same staged buffer. Times each kernel,
   its plain version and (for the insert) `torch.index_copy`, with each
   bound; the insert three ways in turns: (a) call time, 200 calls
   between CUDA events; (b) device time, 200 launches in one CUDA graph;
   (c) the route from host arrays (pack, one staged copy, one launch)
   against staging each array and `index_copy`.
6. The server path at the server's defaults (speculative dispatch, chain
   adoption and the row-delta view on): a port `Server` (eval_batch 16)
   on the card over a second copy of the cluster, ingested as `bench.py`
   does, plus 64 running services holding a reserved and a dynamic port.
   After a warm-up, three bursts of 64 service jobs of count 10 (half
   pinned to one datacenter, so drains yield waves) are registered, one
   burst at a time; between bursts four port-holding services finish and
   one node re-registers. Every eval must complete with all 640 allocs of
   its burst placed, distinct_hosts respected and no partial plan; the
   chain, wave, insert and view row-delta (K7) kernels must have launched,
   K8 once an insert and K7 once a refresh that applied a row delta,
   every chain dispatch one kernel launch and every wave at most two, all
   on the lane route;
   every chain/wave launch is held against its plain version on the inputs
   it read (a copy taken at the launch), and the view it read must be
   unchanged when its lease is released. After each burst, once quiet,
   the refreshed device view must equal a cold upload bitwise. Prints per
   burst evals/sec, eval latency (register → complete), dispatch and wave
   counts, the per-eval phase means of the eval tracer, the `view.*` and
   `spec.*` counters, the transfer bytes by ledger site and the garbage
   collections.
7. The slice at full width, on the phase-3 cluster (N = 16384): (a) rounds
   of randomized churn (placements and stops holding ports, a node
   re-registration, a node removal) refreshed through K7, each flush one
   launch, equal to its plain version on the same packed buffer (applied
   to a copy of what it writes) and the view equal to a cold upload,
   bitwise; K7's fused refresh of 64 hot rows, 8 port rows and 64 port
   words timed as phase 5 times the insert (call, device and route time)
   against its plain version and the five `index_copy_` calls of the
   same delta, beside the whole-group uploads it replaces; (b) three
   speculative rounds of datacenter-pinned programs against a sequential
   twin cluster (a deep copy): equal node choices, bit-equal scores, every
   launch certified; (c) the refresh after the chain's plans commit books
   0 bytes at the hot, static and port full-upload and hot-delta sites
   and adopts the chain carry, equal to a cold upload; a foreign commit in
   one datacenter between launch and certification rolls back that lane
   only; (d) a refresh under a held lease writes copies and leaves the
   leased tensors unchanged.
8. The system scheduler (K2) and preemption (K3) at full width, N = 16384:
   (a) on a synthetic BASELINE state of its own (config 4 mutates the
   cluster; every node is given at least one filler alloc), K2 on the
   leased device view against its plain version and its old pass
   (`system_pass_cuda`), fed the program as tensors and as numpy, both
   masks equal bit for bit, for `synth_system_job`'s program and a
   variant with plan deltas and a reserved plus a dynamic port ask; K2
   (csrc/system.cu `system_rows`, one argument block) and the old pass
   timed in turns on the same tensors (back-to-back CUDA events), and the
   route from host arrays (numpy program in, masks on the host: one
   staged copy, one launch, one copy back) against the route the system
   scheduler took before (a copy a field, the old pass, a copy a mask),
   in turns on the host clock; (b) K3 (`csrc/preempt.cu` `rank_block`,
   one launch a call) against its plain version and its old two-launch
   route on the candidate table the retry's host code builds from the
   filler allocs for a priority-100 ask one cpu above any node's free
   room, and on one of all-equal priorities with pads, from dense
   tensors, from a compact table of tensors and from the retry's host
   arrays (snapshot, numpy program, compact table in one staged copy):
   bitwise the old route, indices, k, order and feasible equal to plain,
   scores within 1e-6, one launch a call against two; timed: new and
   old on the same tensors in turns (back-to-back CUDA events), the
   route from host arrays against the retry's old route (a copy a field,
   the dense table and four snapshot tensors, two launches, two syncs)
   in turns on the host clock, the host set-up alone, the plain version,
   the table build and the old four-tensor upload; counted a call:
   launches, library host calls, torch operations, bytes staged against
   bytes uploaded; the bound on the dense and the compact table; (c)
   BASELINE config 4:
   two `synth_system_job` evals through the port's `Harness`, with
   `bench.py` `bench_system`'s checks (the placed node set equals a
   scalar recomputation; every preemption-backed placement is on a
   feasible-but-full node, evicts only lower-priority allocs and fits
   afterwards); evals/s, placements/s, preemption placements, K2
   launches and the host time per eval, split into compile_tg, K2 with
   its staged copy, and the rest (the masks' copy back, the per-node
   decode loop). (d) runs on phase 6's server
   after its bursts (so it prints before phase 7): a system job's eval
   completes through the worker's system route (K2 launched, no nack);
   then, with service preemption on, a priority-100 service job whose ask
   fits no node without eviction is placed by evicting lower-priority
   allocs (K3 launched once a retry, its old route never), its plan
   applied, `carry_exact` False, the node fitting afterwards; the eval's
   wall split into the victim table's build, the K3 route, the Preemptor
   and the rest.
9. The batched-eval path (K6) and the node-sharded step (K9): (a) on the
   phase-3 cluster, `place_task_group_batch` against its plain version
   for B = 64 programs of `bench.py`'s eval mix (count 8), explain off and
   on, and both packed routes at B = 64 against it (explain off); at
   B = 4096, bench's default batch, and B = 1024, the loop's, the two
   packed routes — the on-chip route (`csrc/batch.cu`, one launch, which
   `place_packed_batch` takes at N = 16384) and the pooled route
   (`csrc/chain.cu`, two launches) — sel_idx and sel_score bitwise the
   full-carry route's, which equals plain at B = 4096 (indices and
   counts equal, scores within 1e-6); the two routes timed in turns
   (host clock synced, device span, back-to-back CUDA events) with their
   kernel launches a dispatch, peak device memory and bound. Then a view
   past the on-chip limit (the phase-3 view padded to N = 65,536): 32
   programs take the pooled route, equal to plain and bitwise the
   on-chip route on the unpadded view. And phase 3's programs (ports with
   plan releases, deltas and penalties, preferred rows, sampled
   candidates) in one packed dispatch: both routes bitwise the
   full-carry route, which equals plain. (b) `bench.py` `bench_tpu`'s single-device
   loop on the port (a host `compile_tg` per eval, `stack_params`,
   `pack_params`, one `place_packed_batch` per batch on the on-chip
   route, asynchronous until
   the end): 4,096 evals in batches of 1,024 (cut from bench's 16,384 /
   4,096 to keep the smoke's time); evals/s and placed/total beside the
   card's name and power limit, then every batch's sel_idx held against
   the plain version on the inputs it read. (c) K9 on four shards in
   meshes (2, 2) and (1, 4) over the cards (all four on one card when
   there is one): `entry.dryrun_multichip(4, ...)` at its own size
   (10,000 nodes, 5,000 allocs, 64 evals of count 4; each dry run ends
   with the live server on its mesh, 8 jobs through the sharded chain),
   then the phase-3 cluster with B = 64; each equal to its plain version
   and to K6 on the whole view (sel_idx and counts exactly, scores
   within 1e-6), the fold-in bitwise against plain; timed per dispatch
   and per step. The on-chip K6 kernel's launches are counted around (b),
   the pooled route's around the padded view's dispatch, K9's around the
   dry runs.
10. The server on a device mesh (B10-B13), four shards of the card in
   meshes (1, 4) and (2, 2): (a) on the phase-3 cluster, at (1, 4),
   (2, 2) and (1, 8), the packed chain (B10) of phase 5's 8 programs,
   explain off and on, the single program with explain (B11) and the
   system masks (B12) against their plain versions on the same shards
   and the unsharded K4, K1 and K2; B10 and B11 through their cluster
   route (two launches a dispatch when the shards share the card) and
   their steps route, bitwise equal, both timed in turns (host clock and
   device span a dispatch) with their host calls and launches; B12
   through its cards route (one `system_rows` launch a card, 2 host
   calls; also from a numpy program) and its shards route (K2's old pass
   a shard, rebased), bitwise equal, timed in turns on the host clock
   with their launches, host calls and torch operations a call; then two
   churn rounds through
   the view cache under a (2, 2) mesh, every flush replayed on CPU copies
   of the shards (plain) and on an unsharded copy (K7), every copy equal
   to both and to a cold upload, one launch for each shard copy with
   changes (B13), K7's hot part at 64 rows timed.
   (b) the phase-6 ingest and 64 evals of its mix, queued at once, then a
   lone eval and a system eval, through `Server(ServerConfig(mesh=...))`
   for each mesh and through `mesh=None`: placements equal alloc by
   alloc; evals/s, latency and dispatches printed; the B10-B13 launch
   counts are read around the meshed runs, beside the calls they were
   made in (B10 and B11 dispatches, B12 mask calls, B13 flushes); on the
   cluster route B10 and B11 launch 2 a dispatch, B12 one a card a mask
   call. (d)
   one K6 dispatch on each of the full-carry and (on-chip) packed
   routes, and one K9 batch row, of 65,536 programs (16 tiled) on
   64 rows, every copy equal to its original's plain result; the packed
   route bitwise the full-carry one; B12 on that view's four shards of 16
   rows equal to K2; and B12 over 64 shards of 256 rows of the phase-3
   view (one launch) equal to K2 on the whole view and to the shards
   route, both timed. ((c), the dry run's server half, runs in 9 (c).)
11. Prints the kernels line, then `{"ok": true, "device": {...}}` last.
"""
from __future__ import annotations

import copy
import gc
import json
import random
import statistics
import subprocess
import sys
import threading
import time
import uuid

SEED = 20261017
N_NODES, N_ALLOCS = 10_000, 100_000
#: bursts of 64 evals through the server (phase 6), for the spread
BURSTS = 3
#: phase 7: churn rounds refreshed through K7; speculative rounds of the
#: chain; allocs per program of those rounds
CHURN_ROUNDS = 4
SPEC_ROUNDS = 3
SPEC_COUNT = 10
TOL = 1e-6
#: published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and fp32
#: operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def _compare(want, got, what: str) -> float:
    """Equal indices/counts, floats within TOL; returns the max abs error."""
    import torch

    err = 0.0

    def close(a, b, name):
        nonlocal err
        a, b = a.detach().float().cpu(), b.detach().float().cpu()
        if a.shape != b.shape:
            raise AssertionError(f"{what}: {name} shape {a.shape} vs {b.shape}")
        d = float((a - b).abs().max()) if a.numel() else 0.0
        if not (d <= TOL):
            raise AssertionError(f"{what}: {name} differs by {d}")
        err = max(err, d)

    def equal(a, b, name):
        a, b = a.cpu(), b.cpu()
        if a.shape != b.shape or not torch.equal(a.to(b.dtype), b):
            raise AssertionError(f"{what}: {name} differs:\n{a}\n{b}")

    for f in ("sel_idx", "nodes_feasible", "nodes_fit"):
        equal(getattr(want, f), getattr(got, f), f)
    for f in ("sel_score", "new_used", "final_scores0"):
        close(getattr(want, f), getattr(got, f), f)
    if (want.explain is None) != (got.explain is None):
        raise AssertionError(f"{what}: explain present in one only")
    if want.explain is not None:
        for f in type(want.explain)._fields:
            a, b = getattr(want.explain, f), getattr(got.explain, f)
            (close if f in ("topk_score", "topk_parts") else equal)(a, b, f)
    return err


def _max_diff(a, b) -> float:
    """The largest |a − b| over two tensors of one shape (any dtype; bool
    masks as 0/1), read on the host."""
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float((a - b).abs().max()) if a.numel() else 0.0


def _time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(fn, reps: int) -> float:
    """Device time of one call of `fn`: `reps` calls captured in one CUDA
    graph and replayed between two events, so the host's issue of each
    launch is not in the time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _wall_ms(fn, reps: int) -> float:
    """Host wall time of one call of `fn` (host-only work) over `reps`."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def _bound(cluster, p, m: int):
    """Least time the card could take for one program, and what bounds
    it: each input the function needs read once, each output written
    once, over HBM bandwidth; against the fp32 operations it does."""
    return _bound_of([_bound_parts(cluster, p, m)], cluster)


def _bound_of(parts, cluster, extra_out: int = 0):
    """Combine per-program (view bytes, program bytes, output bytes,
    operations): the view is read once however many programs read it;
    `extra_out` adds outputs written once per dispatch (a carry)."""
    view = max(v for v, _p, _o, _ops in parts)
    bytes_ = view + sum(p + o for _v, p, o, _ops in parts) + extra_out
    return _bound_ms(bytes_, sum(x[3] for x in parts))


def _bound_ms(bytes_: float, ops: float):
    """Least time for `bytes_` moved once and `ops` fp32 operations on
    the card, and which of the two bounds it."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _bound_parts(cluster, p, m: int, own_carry: bool = True):
    """One program's share: (view bytes, program bytes, output bytes,
    operations). `own_carry` counts new_used and final_scores0 as its
    outputs (K1); a chain program writes only its per-step outputs."""
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
    ops_row_step = 2 * r + 40 + 12 * s + 4 * q + p.penalty_idx.shape[1]
    ops = (n * m * ops_row_step
           + n * (c + a + s + q + p.delta_idx.shape[0] * r
                  + p.jc_idx.shape[0] + p.jtc_idx.shape[0]
                  + p.cand_idx.shape[0]
                  + p.res_ports.shape[0] * (p.pclr_idx.shape[0]
                                            + p.pset_idx.shape[0])))
    return view_in, prog_in, bytes_out, ops


def _compare_flat(want, got, what: str, explain: bool) -> float:
    """Flat chain/wave outputs (sel, score, feasible, fit[, explain
    leaves][, collisions]) and carries: integer leaves equal, float
    leaves within TOL; returns the max abs error."""
    import torch

    from nomad_tpu_torch.kernels.placement import PlacementExplain

    floats = {1}
    if explain:
        names = PlacementExplain._fields
        floats |= {4 + names.index("topk_score"),
                   4 + names.index("topk_parts")}
    (w_out, w_carry), (g_out, g_carry) = want, got
    if len(w_out) != len(g_out):
        raise AssertionError(f"{what}: {len(w_out)} vs {len(g_out)} outputs")
    err = 0.0
    for i, (a, b) in enumerate(zip(w_out, g_out)):
        a, b = a.cpu(), b.cpu()
        if a.shape != b.shape:
            raise AssertionError(f"{what}: output {i} shape {a.shape} vs "
                                 f"{b.shape}")
        if i in floats:
            d = float((a.float() - b.float()).abs().max()) if a.numel() else 0.
            if not d <= TOL:
                raise AssertionError(f"{what}: output {i} differs by {d}")
            err = max(err, d)
        elif not torch.equal(a.to(b.dtype), b):
            raise AssertionError(f"{what}: output {i} differs")
    for name, a, b in zip(("used", "dyn_free"), w_carry, g_carry):
        d = float((a.float() - b.float()).abs().max().cpu())
        if not d <= TOL:
            raise AssertionError(f"{what}: carry {name} differs by {d}")
        err = max(err, d)
    return err


def _table_transport(torch, progs, dev):
    """Program-table transport of `progs` on `dev` (a fresh table: its
    commit inserts every row through the row-scatter kernel)."""
    from nomad_tpu_torch.convert import tensor_from_numpy
    from nomad_tpu_torch.lib.transfer import default_ledger
    from nomad_tpu_torch.server.program_table import DeviceProgramTable

    table = DeviceProgramTable(device=dev)
    prep = table.prepare(progs)
    if prep is None:
        raise AssertionError("programs exceed the table's ceilings")
    ti, tf, tu, _nb, _count = table.commit(prep, default_ledger())
    dyn = tuple(tensor_from_numpy(d, torch.device(dev))
                for d in (prep.dyn_i, prep.dyn_f, prep.dyn_u))
    return prep, (ti, tf, tu), dyn


def _active_steps(p, sel) -> int:
    """Steps the lane route runs of one program with selections `sel`
    (this run's): a step past n_place after a step that placed nothing,
    with the previous step's penalty rows, is idle (csrc/lanes.cu
    `idle_step`) and does no row work."""
    pen = p.penalty_idx.tolist()
    n_place = int(p.n_place)
    return sum(1 for s in range(len(sel))
               if not (s > 0 and s >= n_place and int(sel[s - 1]) < 0
                       and pen[s] == pen[s - 1]))


def _lane_ops(cluster, p, m: int, explain: bool, steps: int) -> int:
    """Operations of one program on the chain and wave lane route
    (csrc/lanes.cu), `steps` of its m steps run: K6's on-chip count
    (`_onchip_ops`: a row's terms once a program, ≈ 9 operations a row
    step after), the new carry of the rows the program touched, and with
    explain the static filter counts a row, the filter tests and the
    top-K insertion a row step, and per step the top-K merges and the K
    rows' parts recomputed."""
    n, r = cluster.capacity.shape
    c, d = p.key_idx.shape[0], p.delta_idx.shape[0]
    ops = _onchip_ops(cluster, p, steps) + (d + m) * (r * (m + 2) + m + 2)
    if explain:
        k = min(5, n)
        row = 2 * r + 40 + c + p.aff_key_idx.shape[0]
        ops += (n * (c + p.cand_idx.shape[0] + 3) + n * steps * (6 + 2 * k)
                + steps * k * (row + d * r + 16 * 8 + 5))
    return ops


def _chain_bound(kp, arrays, prep, tables, dyn, sel, n_lanes=1,
                 explain=True):
    """Bound of one chain or wave dispatch whose selections were `sel`
    ([programs, m], this run's): the view read once, every program's
    static and dynamic fields, per-step outputs, and the final carry
    written once, against the operations of the lane route (`_lane_ops`,
    the steps this run's data makes it run). Returns (bound ms, what
    bounds it, and the same by chain.cu's count — every term of every row
    at every step)."""
    n, r = arrays.capacity.shape
    batch = kp._assemble_table_batch(*tables, kp.host_rows(prep.rows)
                                     .reshape(-1), *(d.reshape(
                                         -1, d.shape[-1]) for d in dyn),
                                     prep.sspec, prep.dspec)
    parts = [_bound_parts(arrays, kp._program(batch, b), prep.m,
                          own_carry=False)
             for b in range(batch.n_place.shape[0])]
    carry = n * r * 4 + n * 4 + (4 if n_lanes > 1 else 0)
    sel = sel.reshape(len(parts), -1).cpu()
    lane = []
    for b, (v, pr, o, _ops) in enumerate(parts):
        p = kp._program(batch, b)
        lane.append((v, pr, o, _lane_ops(arrays, p, prep.m, explain,
                                         _active_steps(p, sel[b]))))
    return (*_bound_of(lane, arrays, extra_out=carry),
            *_bound_of(parts, arrays, extra_out=carry))


#: dispatches a timing of phase 5's chain and wave routes takes a turn
LANE_REPS = 10
#: programs a timing of phase 3's K1 routes takes a turn
K1_REPS = 30


def _launch_spans(torch, fn, reps: int, hooks):
    """`reps` calls of `fn`, one at a time: each one's device span, from a
    CUDA event recorded just before its first kernel launch (`hooks`:
    (launcher, method name) pairs, patched for the calls) to one recorded
    when it returns — the kernels' device time, without the host's
    set-up before the launch. Returns the spans (ms)."""
    first = []

    def wrap(real):
        def call(*args, **kw):
            if not first:
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                first.append(e)
            return real(*args, **kw)
        return call

    for obj, name in hooks:
        setattr(obj, name, wrap(getattr(obj, name)))
    spans = []
    try:
        for _ in range(reps):
            first.clear()
            torch.cuda.synchronize()
            fn()
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            torch.cuda.synchronize()
            spans.append(first[0].elapsed_time(end))
    finally:
        for obj, name in hooks:
            delattr(obj, name)   # the class's method again
    return spans


def _k1_leaves(r) -> list:
    """A K1 result's tensors: outputs, carry, step-0 scores, explain."""
    return list(r[:6]) + (list(r.explain) if r.explain is not None else [])


def _k1_routes(torch, kp, arrays, p, m, explain, card=""):
    """K1 (one program) on its two CUDA routes — the lane route at the
    size it picks and placement.cu's (`clusters=0`) — bitwise each
    other; timed in turns (lane, placement.cu, placement.cu, lane),
    K1_REPS programs each: back-to-back CUDA events and the median device
    span from the first launch (`_launch_spans`); kernel launches a
    program and peak device memory. Returns (the lane route's result,
    route → numbers)."""
    fns = {"lane": lambda: kp.place_task_group_cuda(arrays, p, m, explain),
           "placement.cu": lambda: kp.place_task_group_cuda(
               arrays, p, m, explain, clusters=0)}
    hooks = ((kp._LANES, "launch"), (kp._LAUNCHER, "launch"))
    res, out = {}, {}
    for route, fn in fns.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        k0 = kp.single_kernel_launches()
        res[route] = fn()
        torch.cuda.synchronize()
        out[route] = dict(peak=(torch.cuda.max_memory_allocated() - base)
                          / 2 ** 20,
                          launches=kp.single_kernel_launches() - k0,
                          route=kp.last_single_route())
    if out["lane"]["route"][0] != "cluster" or out["lane"]["launches"] != 1:
        raise AssertionError(f"K1: the lane route took {out['lane']}")
    if out["placement.cu"]["route"] != ("scan", None) \
            or out["placement.cu"]["launches"] != 2:
        raise AssertionError(f"K1: clusters=0 took {out['placement.cu']}")
    _same_bits(_k1_leaves(res["placement.cu"]), _k1_leaves(res["lane"]),
               f"K1 explain={explain} lane route vs placement.cu")
    for route in ("lane", "placement.cu", "placement.cu", "lane"):
        r = out[route]
        r.setdefault("events", []).append(_time_ms(fns[route], K1_REPS))
        r.setdefault("span", []).extend(
            _launch_spans(torch, fns[route], K1_REPS, hooks))
    for route, r in out.items():
        r["events"] = statistics.median(r["events"])
        r["span"] = statistics.median(r["span"])
        print(f"K1 explain={'on' if explain else 'off'} {route} (C="
              f"{r['route'][1] or '-'}): events {r['events']:.4f} ms a "
              f"program, span {r['span']:.4f} ms, {r['launches']} kernel "
              f"launches a program, peak {r['peak']:.2f} MiB; {card}")
    return res["lane"], out


def _k1_bound(kp, arrays, p, m, sel, explain):
    """Bound of one K1 program on the lane route: the view read once, the
    program's fields, its outputs with new_used and final_scores0, against
    the lane route's operations (`_lane_ops`, the steps this run's data
    runs). Returns (ms, what bounds it)."""
    cpu = kp.TGParams(*(t.cpu() for t in p))
    v, pr, o, _ops = _bound_parts(arrays, cpu, m)
    ops = _lane_ops(arrays, cpu, m, explain, _active_steps(cpu, sel.cpu()))
    return _bound_of([(v, pr, o, ops)], arrays)


def _leaves(x) -> list:
    """The tensors of nested tuples (outputs and carries), in order."""
    if isinstance(x, (tuple, list)):
        return [t for part in x for t in _leaves(part)]
    return [x]


def _same_bits(want, got, what: str) -> None:
    """Two outputs or carries (nested tuples of tensors), leaf by leaf,
    bit for bit."""
    import torch

    want, got = _leaves(want), _leaves(got)
    if len(want) != len(got):
        raise AssertionError(f"{what}: {len(want)} vs {len(got)} leaves")
    for i, (a, b) in enumerate(zip(want, got)):
        a, b = a.detach().cpu().contiguous(), b.detach().cpu().contiguous()
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"{what}: leaf {i} differs")


def _lane_routes(torch, kp, what, run, explain, bound, kind):
    """One K4 or K5 dispatch shape on both routes: `run(clusters,
    explain)` on the lane route at the size it picks (and, timed, at
    C = 1) and on chain.cu's route (`clusters=0`), bitwise each other;
    timed in turns (picked, C = 1, chain.cu, chain.cu, C = 1, picked),
    LANE_REPS dispatches each: back-to-back CUDA events and the median
    device span (`_k6_samples`); kernel launches a dispatch and peak
    device memory. Prints one line a route; returns route → numbers."""
    picked = kp.lane_route(*bound["route_args"])
    fns = {"picked": lambda: run(None, explain),
           "c1": lambda: run(1, explain),
           "chain.cu": lambda: run(0, explain)}
    outs, out = {}, {}
    for route, fn in fns.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        k0 = kp.chain_kernel_launches()[kind]
        outs[route] = fn()
        torch.cuda.synchronize()
        out[route] = {"peak": (torch.cuda.max_memory_allocated() - base)
                      / 2 ** 20,
                      "launches": kp.chain_kernel_launches()[kind] - k0,
                      "route": kp.last_chain_dispatch_route()}
    if out["picked"]["route"] != ("cluster", picked) or picked == 0:
        raise AssertionError(f"{what}: took {out['picked']['route']}, "
                             f"lane_route gives {picked}")
    if out["chain.cu"]["route"] != ("lanes", None):
        raise AssertionError(f"{what}: clusters=0 took "
                             f"{out['chain.cu']['route']}")
    want = {"chain": 1, "wave": 2}[kind]
    for route in ("picked", "c1"):
        if out[route]["launches"] != want:
            raise AssertionError(f"{what}: {out[route]['launches']} kernel "
                                 f"launches a dispatch on the lane route")
        _same_bits(outs["chain.cu"], outs[route], f"{what} {route}")
    for route in ("picked", "c1", "chain.cu", "chain.cu", "c1", "picked"):
        r = out[route]
        _hosts, spans = _k6_samples(torch, kp, fns[route], LANE_REPS)
        r.setdefault("span", []).extend(spans)
        r.setdefault("events", []).append(_time_ms(fns[route], LANE_REPS))
    for route, r in out.items():
        r["span"] = statistics.median(r["span"])
        r["events"] = statistics.median(r["events"])
        print(f"{what} explain={'on' if explain else 'off'} {route} "
              f"(C={picked if route == 'picked' else 1 if route == 'c1' else '-'}"
              f"): events {r['events']:.4f} ms, span {r['span']:.4f} ms, "
              f"{r['launches']} kernel launches a dispatch, peak "
              f"{r['peak']:.2f} MiB")
    print(f"{what}: bound {bound['ms']:.6f} ms ({bound['by']}; chain.cu's "
          f"count {bound['old_ms']:.6f} ms, {bound['old_by']}); lane route "
          f"bitwise chain.cu's at C={picked} and C=1")
    return outs["picked"], out


def _phase5_kernels(torch, kp, kr, cases, nodes, rng):
    """K4, K5 and K8 against their plain versions at full width, timed."""
    from nomad_tpu_torch.synth import synth_service_job

    out = {"err": {"chain": 0.0, "wave": 0.0, "insert": 0.0}}
    mix = ("binpack", "constraint", "affinity", "spread_targets",
           "distinct_hosts", "distinct_property", "ports", "delta_penalty")
    progs = []
    for name in mix:
        stack, j, n_place, plan, _rows = cases[name]
        progs.append(stack.compile_tg(j, j.task_groups[0], n_place, plan)[0])
    arrays = cases["binpack"][0].device_arrays()

    # K8: a fresh table's insert in one launch, then the fused insert
    # against its plain version and index_copy, timed three ways
    before = kr.launch_count()
    prep, tables, dyn = _table_transport(torch, progs, "cuda")
    if kr.launch_count() != before + 1:
        raise AssertionError("the table insert did not launch the kernel "
                             "exactly once")
    out["insert"], out["err"]["insert"] = _k8_timing(torch, kr, tables,
                                                     rng)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n, r = arrays.capacity.shape

    def bound_of(prep, tables, dyn, sel, lanes, per_lane, explain):
        shapes = {name: tuple(shape) for name, _c, _o, shape in
                  tuple(prep.sspec) + tuple(prep.dspec)}
        dims = kp._program_dims(shapes, prep.m, explain, n)
        ms, by, old_ms, old_by = _chain_bound(kp, arrays, prep, tables, dyn,
                                              sel, lanes, explain)
        return dict(ms=ms, by=by, old_ms=old_ms, old_by=old_by,
                    route_args=(n, lanes, dims, r, sms))

    def chain_case(what, prep, tables, dyn):
        """K4 on one chain, explain off and on: both routes against
        plain (0.0) and each other (bitwise), timed; the plain version
        timed with explain on."""
        args = (arrays, *tables, prep.rows, *dyn, prep.sspec, prep.dspec,
                prep.m)
        res = {}
        sel = kp.place_table_chain_plain(*args)[0][0]
        for explain in (False, True):
            bound = bound_of(prep, tables, dyn, sel, 1, len(prep.rows),
                             explain)
            got, res[explain] = _lane_routes(
                torch, kp, what, lambda c, ex: kp.place_table_chain_cuda(
                    *args, explain=ex, clusters=c), explain, bound, "chain")
            res[explain]["bound"] = bound
            want = kp.place_table_chain_plain(*args, explain=explain)
            err = _compare_flat(want, got, f"{what}/explain={explain}",
                                explain)
            if err != 0.0:
                raise AssertionError(f"{what}: {err} from plain")
        res["plain"] = _time_ms(
            lambda: kp.place_table_chain_plain(*args, explain=True), 2)
        res["placed"] = int((got[0][0] >= 0).sum())
        return res

    # K4: the chain of the 8 programs, explain off and on
    k4 = chain_case(f"K4 chain B={len(mix)} M={prep.m}", prep, tables, dyn)
    on, off = k4[True], k4[False]
    out["chain"] = dict(ms=on["picked"]["events"], plain_ms=k4["plain"],
                        bound_ms=on["bound"]["ms"],
                        bound_by=on["bound"]["by"], library_ms=None,
                        span_ms=on["picked"]["span"],
                        explain_off_ms=off["picked"]["events"],
                        c1_ms=on["c1"]["events"],
                        chain_cu_ms=on["chain.cu"]["events"],
                        clusters=on["picked"]["route"][1])
    print(f"chain==plain B={len(mix)} M={prep.m} placed(step 0)="
          f"{k4['placed']}: lane route {on['picked']['events']:.4f} ms "
          f"(explain off {off['picked']['events']:.4f} ms; C=1 "
          f"{on['c1']['events']:.4f}), chain.cu {on['chain.cu']['events']:.4f}"
          f" ms, plain {k4['plain']:.4f} ms, bound "
          f"{on['bound']['ms']:.6f} ms ({on['bound']['by']})")

    # K4 at phase 6's dispatch shape: a chain of 16 programs of its mix
    jobs16, _dh = _mix(random.Random(SEED + 5), 16)
    stack16 = cases["binpack"][0]
    progs16 = [stack16.compile_tg(j, j.task_groups[0], 10, None)[0]
               for j in jobs16]
    prep16, tables16, dyn16 = _table_transport(torch, progs16, "cuda")
    k4_16 = chain_case(f"K4 chain B=16 M={prep16.m}", prep16, tables16,
                       dyn16)
    out["chain16"] = {ex: k4_16[ex]["picked"]["events"]
                      for ex in (False, True)}

    # K5: three datacenter-pinned lanes of four programs
    stack = cases["binpack"][0]
    lanes, per_lane = 3, 4
    pinned = []
    for lane in range(lanes):
        for k in range(per_lane):
            j = synth_service_job(
                rng, count=10, datacenter=f"dc{lane + 1}",
                with_affinity=k % 2 == 0, with_spread=k == 1,
                distinct_hosts=k == 3)
            pinned.append(stack.compile_tg(j, j.task_groups[0], 10, None)[0])
    prep, tables, dyn = _table_transport(torch, pinned, "cuda")
    wargs = (arrays, *tables, prep.rows.reshape(lanes, per_lane),
             *(d.reshape(lanes, per_lane, -1) for d in dyn), prep.sspec,
             prep.dspec, prep.m)
    k5 = {}
    sel = kp.place_table_wave_plain(*wargs)[0][0]
    for explain in (False, True):
        bound = bound_of(prep, tables, dyn, sel, lanes, per_lane, explain)
        got, k5[explain] = _lane_routes(
            torch, kp, f"K5 wave L={lanes} P={per_lane} M={prep.m}",
            lambda c, ex: kp.place_table_wave_cuda(*wargs, explain=ex,
                                                   clusters=c),
            explain, bound, "wave")
        k5[explain]["bound"] = bound
        want = kp.place_table_wave_plain(*wargs, explain=explain)
        torch.cuda.synchronize()
        err = _compare_flat(want, got, f"wave/explain={explain}", explain)
        if err != 0.0:
            raise AssertionError(f"wave: {err} from plain")
        if int(got[0][-1]) != 0:
            raise AssertionError("disjoint lanes reported collisions")
    chain = kp.place_table_chain_cuda(arrays, *tables, prep.rows, *dyn,
                                      prep.sspec, prep.dspec, prep.m, True)
    for a, b in list(zip(chain[0], got[0][:-1])) + list(zip(chain[1],
                                                             got[1])):
        if not torch.equal(a, b):
            raise AssertionError("disjoint wave differs from the chain")
    w_plain = _time_ms(
        lambda: kp.place_table_wave_plain(*wargs, explain=True), 2)
    c_ms = _time_ms(lambda: kp.place_table_chain_cuda(
        arrays, *tables, prep.rows, *dyn, prep.sspec, prep.dspec, prep.m,
        True), 20)
    on, off = k5[True], k5[False]
    out["wave"] = dict(ms=on["picked"]["events"], plain_ms=w_plain,
                       bound_ms=on["bound"]["ms"], bound_by=on["bound"]["by"],
                       library_ms=None, span_ms=on["picked"]["span"],
                       explain_off_ms=off["picked"]["events"],
                       c1_ms=on["c1"]["events"],
                       chain_cu_ms=on["chain.cu"]["events"],
                       clusters=on["picked"]["route"][1])
    print(f"wave==plain L={lanes} P={per_lane} M={prep.m}, disjoint lanes "
          f"== chain of the same 12 programs: wave "
          f"{on['picked']['events']:.4f} ms (explain off "
          f"{off['picked']['events']:.4f}; chain.cu "
          f"{on['chain.cu']['events']:.4f}), chain {c_ms:.4f} ms, plain "
          f"wave {w_plain:.4f} ms, bound {on['bound']['ms']:.6f} ms "
          f"({on['bound']['by']})")

    # a stale footprint: two unpinned lanes that pick the same nodes
    stale = []
    for _ in range(2):
        j = synth_service_job(rng, count=10)
        stale.append(stack.compile_tg(j, j.task_groups[0], 10, None)[0])
    stale = stale + stale   # lane 1 repeats lane 0: the same rows change
    prep, tables, dyn = _table_transport(torch, stale, "cuda")
    sargs = (arrays, *tables, prep.rows.reshape(2, 2),
             *(d.reshape(2, 2, -1) for d in dyn), prep.sspec, prep.dspec,
             prep.m)
    got = kp.place_table_wave_cuda(*sargs, explain=True)
    old = kp.place_table_wave_cuda(*sargs, explain=True, clusters=0)
    want = kp.place_table_wave_plain(*sargs, explain=True)
    torch.cuda.synchronize()
    _same_bits(old, got, "stale wave")
    err = _compare_flat(want, got, "stale wave", True)
    if err != 0.0:
        raise AssertionError(f"stale wave: {err} from plain")
    coll = int(got[0][-1])
    if coll <= 0 or coll != int(want[0][-1]):
        raise AssertionError(f"stale wave collisions {coll} vs "
                             f"{int(want[0][-1])}")
    print(f"stale-footprint wave: {coll} collision rows, equal to plain and "
          "bitwise chain.cu's route")
    out["max_err"] = max(out["err"].values())
    return out


def _k8_timing(torch, kr, tables, rng):
    """K8 at the main path's shape: K = 8 random rows into the program
    table's three class tables (T = 512 rows, the default capacity), the
    kernel bitwise against its plain version on the same staged buffer,
    the staged rows where idx names them and the old tables unwritten.
    Timed in turns within this call: (a) call time of the kernel, the
    plain version and `torch.index_copy` out of place (one call a table,
    the same function), inputs on the card; (b) device time, 200 launches
    in one CUDA graph; (c) the route from host arrays: pack, one staged
    copy and the launch, against staging each array and index_copy.
    Returns (timings, max abs error)."""
    import numpy as np

    from nomad_tpu_torch.convert import to_device_async

    dev = tables[0].device
    t = tables[0].shape[0]
    nrng = np.random.default_rng(rng.randrange(2 ** 31))
    k = 8
    idx = np.sort(nrng.choice(t, k, replace=False)).astype(np.int32)
    li, lf, lu = (x.shape[1] for x in tables)
    rows = (nrng.integers(-2 ** 31, 2 ** 31 - 1, (k, li), dtype=np.int32),
            nrng.standard_normal((k, lf)).astype(np.float32),
            nrng.integers(0, 256, (k, lu), dtype=np.uint8))
    old = [x.clone() for x in tables]
    staged = kr.pack_insert(idx, *rows, dev).to(dev)
    got = kr.table_insert_cuda(tables, staged)
    want = kr.table_insert_plain(tables, staged)
    torch.cuda.synchronize()
    err = 0.0
    for g, w, r, o, x in zip(got, want, rows, old, tables):
        if not (torch.equal(g, w) and np.array_equal(
                g[torch.as_tensor(idx, device=dev).long()].cpu().numpy(), r)
                and torch.equal(o, x)):
            raise AssertionError(f"fused insert differs ({g.dtype})")
        err = max(err, _max_diff(g, w))
    idx64 = torch.as_tensor(idx, device=dev).long()
    srcs = [torch.as_tensor(r, device=dev) for r in rows]

    def library():
        return [torch.index_copy(x, 0, idx64, r_)
                for x, r_ in zip(tables, srcs)]

    def torch_route():
        i = to_device_async(idx, dev).long()
        return [torch.index_copy(x, 0, i, to_device_async(r_, dev))
                for x, r_ in zip(tables, rows)]

    res = dict(ms=_time_ms(lambda: kr.table_insert_cuda(tables, staged), 200),
               plain_ms=_time_ms(lambda: kr.table_insert_plain(tables,
                                                               staged), 200),
               library_ms=_time_ms(library, 200))
    res["device_ms"] = _graph_ms(
        lambda: kr.table_insert_cuda(tables, staged), 200)
    res["library_device_ms"] = _graph_ms(library, 200)
    res["route_ms"] = _time_ms(lambda: kr.table_insert(
        tables, kr.pack_insert(idx, *rows, dev)), 200)
    res["library_route_ms"] = _time_ms(torch_route, 200)
    # what the host spends: the three output allocations of a call, and
    # the pack into one pinned buffer of the route
    alloc_ms = _wall_ms(lambda: [torch.empty(x.shape, dtype=x.dtype,
                                             device=dev) for x in tables], 200)
    pack_ms = _wall_ms(lambda: kr.pack_insert(idx, *rows, dev), 200)
    nbytes = (2 * t * (4 * li + 4 * lf + lu)
              + k * (4 + 4 * li + 4 * lf + lu))
    res["bound_ms"], res["bound_by"] = _bound_ms(nbytes, 0)
    print(f"insert (K = {k} rows into the i32/f32/u8 tables of T = {t} rows, "
          f"row bytes {[4 * li, 4 * lf, lu]}): call: kernel "
          f"{res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, index_copy "
          f"{res['library_ms']:.4f} ms; device (a CUDA graph of 200 calls): "
          f"kernel {res['device_ms']:.4f} ms, index_copy "
          f"{res['library_device_ms']:.4f} ms; route from host arrays: "
          f"packed + one copy + one launch {res['route_ms']:.4f} ms, staged "
          f"arrays + index_copy "
          f"{res['library_route_ms']:.4f} ms; host parts: three output "
          f"allocations {alloc_ms:.4f} ms, pack {pack_ms:.4f} ms; bound "
          f"{res['bound_ms']:.7f} ms ({res['bound_by']}, {nbytes} bytes); "
          f"max_abs_err {err}")
    return res, err


def _mean(xs) -> float:
    return sum(xs) / len(xs) if xs else 0.0


def _snap(torch, x):
    """A device copy of every tensor in `x` (nested tuples and named
    tuples kept), cloned on the current stream: taken right after a
    launch it holds what the launch wrote, taken before it what the
    launch reads."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        out = [_snap(torch, y) for y in x]
        return type(x)(*out) if hasattr(x, "_fields") else tuple(out)
    return x


def _ingest(s, srng):
    """`bench.py`'s ingest into a Server's state: N_NODES synthetic nodes,
    N_ALLOCS running allocs of filler jobs, and 64 running services
    holding a reserved and a dynamic port. Returns (nodes, filler jobs,
    the port holders)."""
    from nomad_tpu_torch.synth import (synth_alloc, synth_node,
                                       synth_service_job)

    nodes = []
    for i in range(N_NODES):
        node = synth_node(srng, i)
        nodes.append(node)
        s.state.upsert_node(node)
    filler = [synth_service_job(srng) for _ in range(max(N_ALLOCS // 200, 1))]
    for j in filler:
        s.state.upsert_job(j)
    for i in range(N_ALLOCS):
        s.state.upsert_alloc(synth_alloc(
            srng, nodes[srng.randrange(N_NODES)], filler[i % len(filler)]))
    holders = []
    for k in range(64):
        node = nodes[srng.randrange(N_NODES)]
        a = _port_alloc(node.id, filler[0].id, (100, 64, 10),
                        [_ports_net(node, 8080, 20000 + k)])
        a.job = filler[0]
        s.state.upsert_alloc(a)
        holders.append(a)
    return nodes, filler, holders


def _mix(srng, n):
    """`bench.py`'s e2e mix of `n` service jobs of count 10: half pinned
    to one datacenter. The pinned half registers first: a drain of pinned
    jobs partitions into disjoint conflict groups and dispatches a wave,
    while an unpinned job's footprint is every node and merges its whole
    drain into one chain. Returns (jobs, their distinct_hosts flags)."""
    from nomad_tpu_torch.synth import synth_service_job

    order = sorted(range(n), key=lambda i: i % 2 == 0)
    jobs = [synth_service_job(
        srng, count=10, with_affinity=i % 2 == 0,
        with_spread=i % 3 == 0, distinct_hosts=i % 5 == 0,
        with_devices=i % 4 == 0,
        datacenter=f"dc{1 + (i // 2) % 3}" if i % 2 == 1 else None)
        for i in order]
    return jobs, [i % 5 == 0 for i in order]


def _phase6_server(torch, kp, kr, rng, device=None, then=None):
    """The batched server path on the card (`device` None) at the
    BASELINE size, at the server's defaults (speculation, chain adoption
    and the row-delta view on). `then(server)`, if given, runs on the
    started server after the bursts, before it shuts down."""
    from nomad_tpu_torch.lib.metrics import default_registry
    from nomad_tpu_torch.lib.transfer import default_ledger
    from nomad_tpu_torch.scheduler import stack as stack_mod
    from nomad_tpu_torch.scheduler.stack import TorchStack
    from nomad_tpu_torch.server import Server, ServerConfig

    out = {"err": {"chain": 0.0, "wave": 0.0}}
    srng = random.Random(SEED + 1)
    t0 = time.perf_counter()
    s = Server(ServerConfig(num_schedulers=1, heartbeat_ttl=3600.0,
                            eval_batch=16), device=device)
    if device is None and s.device.type != "cuda":
        raise AssertionError(f"Server default device is {s.device}")
    try:
        # started before the ingest: `start()` arms one TTL timer thread
        # per node already in the state (heartbeat.py), 10,000 threads
        # here; nodes upserted afterwards, as bench.py upserts them, arm
        # none (their TTL of an hour would never fire in this run anyway)
        s.start()
        nodes, filler, holders = _ingest(s, srng)
        cl = s.state.cluster
        print(f"server: ingested {N_NODES} nodes / {N_ALLOCS + 64} allocs in "
              f"{time.perf_counter() - t0:.1f} s")

        def feed(n):
            return _mix(srng, n)

        def run(jobs):
            evs = [s.job_register(j) for j in jobs]
            done = []
            for ev in evs:
                got = s.wait_for_eval(ev.id, statuses=(
                    "complete", "failed", "blocked", "cancelled"),
                    timeout=600.0)
                if got is None or got.status != "complete":
                    raise AssertionError(f"eval {ev.id}: {got}")
                done.append(got)
            return evs, done

        def churn(burst):
            # between bursts, what clients report meanwhile: four
            # port-holding services finish, one node re-registers
            for _ in range(4):
                a = copy.copy(holders.pop(srng.randrange(len(holders))))
                a.client_status = "complete"
                s.state.upsert_alloc(a)
            node = copy.copy(nodes[srng.randrange(N_NODES)])
            node.meta = dict(node.meta or {}, burst=str(burst))
            s.state.upsert_node(node)

        t0 = time.perf_counter()
        warm, _dh = feed(16)
        run(warm)
        print(f"server: warm-up of {len(warm)} evals in "
              f"{time.perf_counter() - t0:.1f} s")

        records, leased, views, released_bad = [], {}, {}, []
        names = ("place_table_chain", "place_table_wave",
                 "place_packed_chain", "place_task_group")
        real = {name: getattr(kp, name) for name in names}
        real_da = TorchStack.device_arrays
        real_scv = stack_mod.spec_chain_view
        real_rel = stack_mod.release_view

        def recorder(name):
            fn = real[name]

            def rec(*args, **kw):
                snap = _snap(torch, args)
                views[id(args[0])] = (args[0], snap[0])
                res = fn(*args, **kw)
                # the outputs as the launch wrote them: an adopted carry
                # becomes the view's tensor, which later refreshes write
                records.append((name, snap, kw, _snap(torch, res)))
                return res
            return rec

        def device_arrays(self, lease_token=None):
            arrays = real_da(self, lease_token=lease_token)
            if lease_token is not None:
                leased[lease_token] = arrays
            return arrays

        def spec_chain_view(cluster, lease_token, device=None):
            arrays = real_scv(cluster, lease_token, device)
            if arrays is not None:
                leased[lease_token] = arrays
            return arrays

        def release_view(cluster, token):
            # the view a launch read must be what it was at the launch
            # until its lease ends (a refresh meanwhile writes copies)
            arrays = leased.pop(token, None)
            held = views.get(id(arrays)) if arrays is not None else None
            if held is not None and held[0] is arrays:
                for f in arrays._fields:
                    if not torch.equal(getattr(arrays, f),
                                       getattr(held[1], f)):
                        released_bad.append((token, f))
            real_rel(cluster, token)

        gc_pauses, gc_start = [], []

        def on_gc(phase, info):
            if phase == "start":
                gc_start.append(time.perf_counter())
            elif gc_start:
                gc_pauses.append((info["generation"],
                                  time.perf_counter() - gc_start.pop()))

        # the view the bursts start from: quiet, refreshed, equal to cold
        _cold_equal(torch, TorchStack(cl, device=s.device).device_arrays(),
                    cl, "after the warm-up")
        kp.reset_launch_count()
        kp.reset_chain_launch_counts()
        kr.reset_launch_count()
        kr.reset_delta_launch_counts()
        # K7 launches and refreshes that applied a delta, in the bursts
        k7 = refreshes = 0
        inserts0 = default_ledger().snapshot().get(
            "select_batch.table_insert", {}).get("count", 0)
        for name in names:
            setattr(kp, name, recorder(name))
        TorchStack.device_arrays = device_arrays
        stack_mod.spec_chain_view = spec_chain_view
        stack_mod.release_view = release_view
        gc.callbacks.append(on_gc)
        try:
            for burst in range(BURSTS):
                if burst:
                    churn(burst)
                k7_0 = kr.delta_launch_counts()
                d0 = default_registry().counters(prefix="view.").get(
                    "delta_uploads", 0)
                _server_burst(s, feed, run, gc_pauses, burst)
                k7 += kr.delta_launch_counts() - k7_0
                refreshes += default_registry().counters(
                    prefix="view.").get("delta_uploads", 0) - d0
                # quiet: the cached view, refreshed, equals a cold upload
                if s.device.type == "cuda":
                    torch.cuda.synchronize()
                _cold_equal(torch, TorchStack(
                    cl, device=s.device).device_arrays(), cl,
                    f"after burst {burst}")
        finally:
            for name in names:
                setattr(kp, name, real[name])
            TorchStack.device_arrays = real_da
            stack_mod.spec_chain_view = real_scv
            stack_mod.release_view = real_rel
            gc.callbacks.remove(on_gc)
        # one insert a commit with new rows: the ledger site books 4
        # arrays an insert
        inserts = (default_ledger().snapshot().get(
            "select_batch.table_insert", {}).get("count", 0) - inserts0) // 4
        launches = {"chain": kp.chain_launch_count(),
                    "wave": kp.wave_launch_count(),
                    "insert": kr.launch_count(),
                    "single": kp.launch_count(),
                    "k7": k7}
        out["launches"] = launches
        out["kernels"] = kernels = kp.chain_kernel_launches()
        routes = kp.chain_route_counts()
        for k in ("chain", "wave", "insert", "k7"):
            if launches[k] == 0:
                raise AssertionError(f"the {k} kernel never launched on the "
                                     f"server path: {launches}")
        # K4 and K5 on the lane route: one kernel launch a chain dispatch,
        # at most two a wave
        if s.device.type == "cuda" and (
                routes["lanes"] != 0
                or kernels["chain"] != launches["chain"]
                or kernels["wave"] > 2 * launches["wave"]):
            raise AssertionError(
                f"chain/wave dispatches {launches['chain']}/"
                f"{launches['wave']} took {kernels} kernel launches, routes "
                f"{routes}: not one a chain and at most two a wave on the "
                "lane route")
        print(f"server: K4 {launches['chain']} chain dispatches in "
              f"{kernels['chain']} kernel launches, K5 {launches['wave']} "
              f"waves in {kernels['wave']} (routes {routes})")
        if s.device.type == "cuda" and (launches["insert"] != inserts
                                        or k7 != refreshes):
            raise AssertionError(
                f"{launches['insert']} K8 launches for {inserts} inserts, "
                f"{k7} K7 launches for {refreshes} refreshes with a delta "
                "(one launch each)")
        print(f"server: K8 {launches['insert']} launches for {inserts} "
              f"inserts; K7 {k7} launches for {refreshes} refreshes that "
              "applied a row delta")
        if released_bad:
            raise AssertionError(f"leased views written before their "
                                 f"release: {released_bad[:4]}")

        # every recorded launch against its plain version on the inputs
        # it read (the snapshot taken at the launch)
        kinds = {"place_table_chain": "chain", "place_table_wave": "wave",
                 "place_packed_chain": "chain"}
        for i, (name, args, kw, res) in enumerate(records):
            if name == "place_task_group":
                want = kp.place_task_group_plain(*args, **kw)
                out["err"]["single"] = max(out["err"].get("single", 0.0),
                                           _compare(want, res,
                                                    f"server launch {i}"))
                continue
            want = getattr(kp, name + "_plain")(*args, **kw)
            if name == "place_packed_chain":
                want, res = (want, ()), (res, ())
            err = _compare_flat(want, res, f"server launch {i} ({name})",
                                kw.get("explain", False))
            out["err"][kinds[name]] = max(out["err"][kinds[name]], err)
        lanes = s.metrics.histogram("wave.lanes").summary()
        print(f"server: {BURSTS} bursts; lanes per wave over the run: mean "
              f"{lanes['mean']:.2f}, max {lanes['max']:.0f}; "
              f"launches {launches}; "
              f"{len(records)} chain/wave launches recorded, all equal to "
              "plain on the inputs they read, every leased view unchanged "
              "until its release")
        if then is not None:
            out["then"] = then(s)
    finally:
        s.shutdown()
    out["max_err"] = max(out["err"].values())
    return out


def _server_burst(s, feed, run, gc_pauses, burst):
    """One burst of 64 evals through a started Server: checks every
    placement and prints throughput, latency, dispatch, per-phase,
    view/speculation/transfer and garbage-collection numbers of the
    burst."""
    from nomad_tpu_torch.lib.metrics import default_registry
    from nomad_tpu_torch.lib.transfer import default_ledger

    jobs, dh = feed(64)
    c0 = s.metrics.counters()
    v0 = default_registry().counters(prefix="view.")
    led0 = default_ledger().snapshot()
    seq0 = s.timeline.last_index()
    p0 = dict(s.planner.stats)
    n_gc = len(gc_pauses)
    evs, done = run(jobs)
    c1 = s.metrics.counters()
    v1 = default_registry().counters(prefix="view.")
    led1 = default_ledger().snapshot()
    p1 = dict(s.planner.stats)

    # every eval complete, every alloc placed, distinct_hosts held
    placed = 0
    for j, want_dh in zip(jobs, dh):
        allocs = s.state.allocs_by_job("default", j.id)
        placed += len(allocs)
        if len(allocs) != 10:
            raise AssertionError(f"job {j.id}: {len(allocs)}/10 placed")
        if want_dh and len({a.node_id for a in allocs}) != 10:
            raise AssertionError(f"job {j.id}: distinct_hosts violated")
    partial = p1.get("partial", 0) - p0.get("partial", 0)
    if partial != 0:
        raise AssertionError(f"{partial} partial plans in the burst")

    lat = sorted(d.modify_time - e.create_time for e, d in zip(evs, done))
    span = max(d.modify_time for d in done) - min(e.create_time
                                                  for e in evs)
    q = lambda f: lat[min(int(f * len(lat)), len(lat) - 1)]  # noqa: E731
    # dispatch records are committed at launch, so every dispatch of the
    # burst is in the timeline once its evals have completed
    _i, recs = s.timeline.records_after(seq0)
    progs = sum(r["programs"] for r in recs)
    waves = c1.get("wave.dispatches", 0) - c0.get("wave.dispatches", 0)
    wprogs = c1.get("wave.programs", 0) - c0.get("wave.programs", 0)
    coll = c1.get("wave.collisions", 0) - c0.get("wave.collisions", 0)
    ker = [r["kernel_ms"] for r in recs if r["kernel_ms"] is not None]
    host = [r["host_ms"] for r in recs if r["host_ms"] is not None]
    phases = {}
    for e in evs:
        for sp in (s.tracer.get(e.id) or {}).get("spans", []):
            phases[sp["phase"]] = phases.get(sp["phase"], 0.0) \
                + sp["duration_ms"]
    gcs = {}
    for g, t in gc_pauses[n_gc:]:
        gcs.setdefault(g, []).append(t)
    tag = f"server burst {burst}:"
    print(f"{tag} {len(jobs)} evals, {placed} allocs placed, partial "
          f"{partial}; {len(jobs) / span:.2f} evals/s ({span:.3f} s); eval "
          f"latency p50 {q(0.5) * 1e3:.1f} ms, p99 {q(0.99) * 1e3:.1f} ms, "
          f"max {lat[-1] * 1e3:.1f} ms")
    print(f"{tag} {len(recs)} dispatches, {progs} programs "
          f"({progs / max(len(recs), 1):.2f} per dispatch), {waves} waves "
          f"of {wprogs} programs, {coll} collision rows; per dispatch "
          f"(host clock) pack+upload+view {_mean(host):.2f} ms, launch→"
          f"outputs on the host {_mean(ker):.2f} ms, dispatches covered "
          f"{sum(ker) / 1e3 / span:.3f} of the span")
    print(f"{tag} per-eval phase means (ms): " + ", ".join(
        f"{k} {v / len(evs):.2f}" for k, v in sorted(phases.items())))
    print(f"{tag} garbage collections: " + (", ".join(
        f"gen {g}: {len(ts)}, total {sum(ts) * 1e3:.1f} ms, max "
        f"{max(ts) * 1e3:.1f} ms" for g, ts in sorted(gcs.items()))
        or "none"))
    view = {k: v1.get(k, 0) - v0.get(k, 0) for k in sorted(v1)
            if v1.get(k, 0) != v0.get(k, 0)}
    spec = {k[5:]: c1.get(k, 0) - c0.get(k, 0) for k in sorted(c1)
            if k.startswith("spec.") and c1.get(k, 0) != c0.get(k, 0)}
    moved = {}
    for site, row in sorted(led1.items()):
        d = row["bytes"] - led0.get(site, {}).get("bytes", 0)
        if d:
            moved[site] = d
    print(f"{tag} view counters {view}")
    print(f"{tag} spec counters {spec}")
    print(f"{tag} transfer bytes by site {moved}")


def _cold_equal(torch, arrays, cl, what: str) -> None:
    """The device view equals a cold upload of the host cluster, bitwise
    (every tensor cast as the full upload casts it)."""
    import numpy as np

    from nomad_tpu_torch.convert import tensor_from_numpy

    dev = arrays.used.device
    attr_dt = np.int16 if cl.vocab.max_vocab < 32000 else np.int32
    cold = {"capacity": (cl.capacity, np.float32),
            "used": (cl.used, np.float32), "node_ok": (cl.node_ok, np.bool_),
            "attrs": (cl.attrs, attr_dt), "ports_used": (cl.ports_used, None),
            "dyn_free": (cl.dyn_free, np.float32)}
    for f, (a, dt) in cold.items():
        want = tensor_from_numpy(a, dev, dt)
        got = getattr(arrays, f)
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"{what}: the view's {f} differs from a "
                                 "cold upload")


def _port_alloc(node_id, job_id, ask, networks=()):
    """A running alloc of `ask` (cpu, memory, disk) on `node_id`."""
    from nomad_tpu_torch.mock import alloc_resources
    from nomad_tpu_torch.structs import Allocation

    return Allocation(
        id=uuid.uuid4().hex, namespace="default", job_id=job_id,
        task_group="web", node_id=node_id,
        allocated_resources=alloc_resources(
            cpu=int(ask[0]), memory_mb=int(ask[1]), disk_mb=int(ask[2]),
            networks=list(networks)),
        desired_status="run", client_status="running")


def _ports_net(node, reserved: int, dynamic: int):
    from nomad_tpu_torch.structs import NetworkResource, Port

    return NetworkResource(ip=node.node_resources.networks[0].ip, mbits=1,
                           reserved_ports=[Port("http", reserved)],
                           dynamic_ports=[Port("rpc", dynamic)])


def _park(cl, jobs, coord, n_place, device=None):
    """One scheduler thread per job, parked at `coord` (its run() not
    yet driven); returns (threads, {i: (node ids, scores, ask, dispatch
    token)})."""
    from nomad_tpu_torch.scheduler.stack import TorchStack

    results = {}

    def one(i, job):
        stack = TorchStack(cl, device=device)
        stack.coordinator = coord
        stack.coordinator_order = i
        try:
            r = stack.select(job, job.task_groups[0], n_place, None)
            results[i] = (r.node_ids, r.scores, r.ask, r.carry_token)
        finally:
            coord.thread_done()

    threads = []
    for i, j in enumerate(jobs):
        coord.add_thread()
        t = threading.Thread(target=one, args=(i, j), daemon=True)
        threads.append(t)
        t.start()
    deadline = time.time() + 60.0
    while time.time() < deadline:
        with coord._cv:
            if coord._parked and len(coord._parked) >= coord._live:
                return threads, results
        time.sleep(0.002)
    raise AssertionError("schedulers never parked")


def _drive(coord, threads) -> None:
    coord.run()
    for t in threads:
        t.join(120.0)


def _commit(cl, results, ids, foreign=None) -> None:
    """Commit each eval's placements as the plan applier does (usage ==
    the compiled ask), one window per eval stamped with its dispatch
    token; then a foreign alloc on node `foreign`, if given."""
    for i, eid in enumerate(ids):
        node_ids, _scores, ask, token = results[i]
        v_lo = cl.version
        for nid in node_ids:
            if nid is not None:
                cl.upsert_alloc(_port_alloc(nid, f"job-{eid}", ask))
        cl.mark_plan_window(eid, v_lo, cl.version, clean=True, exact=True,
                            token=token)
    if foreign is not None:
        cl.upsert_alloc(_port_alloc(foreign, "foreign", (123, 64, 10)))


def _dc_mask(cl, dc):
    import numpy as np

    m = np.zeros(cl.n_cap, dtype=bool)
    for nid, row in cl.row_of.items():
        if cl.nodes[nid].datacenter == dc:
            m[row] = True
    return m


def _k7_churn(torch, kr, cl, nodes, rng, out, device=None) -> None:
    """(a) Rounds of randomized churn refreshed through K7: every flush
    held against the plain version on the same packed buffer (applied to
    a clone of the tensors it writes), one launch a flush on the card,
    and the view against a cold upload."""
    from nomad_tpu_torch.scheduler import stack as stack_mod
    from nomad_tpu_torch.scheduler.stack import TorchStack

    stack = TorchStack(cl, device=device)
    _cold_equal(torch, stack.device_arrays(), cl, "before the churn")
    parts = dict.fromkeys(("hot", "port_rows", "port_words"), 0)
    flushes = [0]
    real = stack_mod.apply_view_delta

    def checked(bufs, delta, shard_rows=None):
        dev = bufs[0].device
        want = tuple(t.clone() for t in bufs)
        kr.view_delta_plain(want, kr.pack_view_delta([delta], [bufs],
                                                     dev).to(dev))
        n0 = kr.delta_launch_counts()
        real(bufs, delta, shard_rows)
        if dev.type == "cuda" and kr.delta_launch_counts() != n0 + 1:
            raise AssertionError("a K7 flush took other than one launch")
        for a, b in zip(want, bufs):
            if not torch.equal(a, b):
                raise AssertionError("K7 differs from its plain version")
            out["k7_err"] = max(out.get("k7_err", 0.0), _max_diff(a, b))
        flushes[0] += 1
        for name in parts:
            parts[name] += getattr(delta, name) is not None
        return bufs

    stack_mod.apply_view_delta = checked
    live, removed = [], set()
    try:
        for rnd in range(CHURN_ROUNDS):
            for k in range(16):      # placements holding two ports each
                node = nodes[rng.randrange(len(nodes))]
                if node.id in removed:
                    continue
                port = 9000 + rnd * 16 + k
                a = _port_alloc(node.id, f"churn-{rnd}", (100, 64, 10),
                                [_ports_net(node, port, port + 12000)])
                cl.upsert_alloc(a)
                live.append(a)
            for _ in range(8):       # stops release usage and ports
                a = live.pop(rng.randrange(len(live)))
                a.client_status = "complete"
                cl.upsert_alloc(a)
            node = nodes[rng.randrange(len(nodes))]
            if node.id not in removed:   # a re-registration
                node.meta = dict(node.meta or {}, churn=str(rnd))
                cl.upsert_node(node)
            held = {a.node_id for a in live}
            victim = next(n for n in nodes
                          if n.id not in removed and n.id not in held)
            cl.remove_node(victim.id)
            removed.add(victim.id)
            _cold_equal(torch, stack.device_arrays(), cl,
                        f"churn round {rnd}")
    finally:
        stack_mod.apply_view_delta = real
    if not all(parts.values()):
        raise AssertionError(f"a K7 part never ran in the churn: {parts}")
    out["churn_calls"] = dict(parts, flushes=flushes[0])
    print(f"slice (a): {CHURN_ROUNDS} churn rounds (16 placements with a "
          "reserved and a dynamic port, 8 stops, a node re-registration, "
          f"a node removal each): {flushes[0]} K7 flushes (parts {parts}), "
          "one launch each, each equal to its plain version on the same "
          "packed buffer and the view equal to a cold upload, bitwise")


def _k7_timing(torch, kr, cl, out) -> None:
    """K7's fused refresh at a delta of 64 hot rows, 8 port rows and 64
    port words, on copies of the view, timed in turns within this call:
    (a) call time of the kernel, the plain version and the five
    `index_copy_` calls of the same delta, inputs on the card; (b) device
    time, 200 launches in one CUDA graph; (c) the route from host arrays:
    pack, one staged copy and the launch, against staging each of the nine
    arrays and the five `index_copy_` calls. Beside them the whole-group
    uploads the delta replaces."""
    import numpy as np

    from nomad_tpu_torch.convert import tensor_from_numpy, to_device_async
    from nomad_tpu_torch.scheduler.stack import TorchStack

    v = TorchStack(cl).device_arrays()
    dev = v.used.device
    bufs = tuple(t.clone() for t in (v.used, v.node_ok, v.dyn_free,
                                     v.ports_used))
    used, ok, dyn, ports = bufs
    n, r = used.shape
    w = ports.shape[1]
    nrng = np.random.default_rng(SEED)
    pick = nrng.permutation(n).astype(np.int32)
    hidx, pidx = np.sort(pick[:64]), np.sort(pick[64:72])
    widx = pick[72:136]
    words = nrng.integers(0, w, 64).astype(np.int32)
    host = [t.cpu().numpy() for t in bufs]
    host_parts = (
        (hidx, host[0][hidx] + 1, ~host[1][hidx], host[2][hidx] - 1),
        (pidx, host[3][pidx] ^ 1),
        (widx, words, host[3][widx, words] ^ 1))
    delta = kr.ViewDelta()
    delta.add_hot(*host_parts[0])
    delta.add_port_rows(*host_parts[1])
    delta.add_port_words(*host_parts[2])
    staged = kr.pack_view_delta([delta], [bufs], dev).to(dev)
    got = kr.view_delta_cuda(tuple(t.clone() for t in bufs), staged)
    want = kr.view_delta_plain(tuple(t.clone() for t in bufs), staged)
    torch.cuda.synchronize()
    for a, b in zip(want, got):
        if not torch.equal(a, b):
            raise AssertionError("the timed K7 delta differs from plain")
        out["k7_err"] = max(out.get("k7_err", 0.0), _max_diff(a, b))
    (hi, hu, ho, hd), (pi, pv), (wr, wc, wv) = (
        [torch.as_tensor(a, device=dev) for a in part]
        for part in host_parts)
    h64, p64 = hi.long(), pi.long()
    flat = wr.long() * w + wc.long()

    def library():
        used.index_copy_(0, h64, hu)
        ok.index_copy_(0, h64, ho)
        dyn.index_copy_(0, h64, hd)
        ports.index_copy_(0, p64, pv)
        ports.view(-1).index_copy_(0, flat, wv)

    def torch_route():
        hi_, hu_, ho_, hd_, pi_, pv_, wr_, wc_, wv_ = (
            to_device_async(a, dev) for part in host_parts for a in part)
        i = hi_.long()
        used.index_copy_(0, i, hu_)
        ok.index_copy_(0, i, ho_)
        dyn.index_copy_(0, i, hd_)
        ports.index_copy_(0, pi_.long(), pv_)
        ports.view(-1).index_copy_(0, wr_.long() * w + wc_.long(), wv_)

    res = dict(ms=_time_ms(lambda: kr.view_delta_cuda(bufs, staged), 200),
               plain_ms=_time_ms(lambda: kr.view_delta_plain(bufs, staged),
                                 200),
               library_ms=_time_ms(library, 200))
    res["device_ms"] = _graph_ms(
        lambda: kr.view_delta_cuda(bufs, staged), 200)
    res["library_device_ms"] = _graph_ms(library, 200)
    res["route_ms"] = _time_ms(lambda: kr.apply_view_delta(bufs, delta), 200)
    res["library_route_ms"] = _time_ms(torch_route, 200)
    pack_ms = _wall_ms(lambda: kr.pack_view_delta([delta], [bufs], dev), 200)
    nbytes = (64 * (4 + 4 * r + 1 + 4) + 64 * (4 * r + 1 + 4)
              + 8 * (4 + 4 * w) + 8 * 4 * w + 64 * 12 + 64 * 4)
    res["bound_ms"], res["bound_by"] = _bound_ms(nbytes, 0)
    out["k7"] = res
    ports_np = np.ascontiguousarray(cl.ports_used)
    hot = (cl.used, cl.node_ok, cl.dyn_free)
    full_ports = _time_ms(lambda: tensor_from_numpy(ports_np, dev), 5)
    full_hot = _time_ms(lambda: [tensor_from_numpy(a, dev, dt) for a, dt in
                                 zip(hot, (np.float32, np.bool_,
                                           np.float32))], 5)
    hot_nb = cl.used.size * 4 + cl.node_ok.nbytes + cl.dyn_free.nbytes
    print(f"slice K7 refresh (64 hot rows, 8 port rows, 64 port words, one "
          f"launch): call: kernel {res['ms']:.4f} ms, plain "
          f"{res['plain_ms']:.4f} ms, five index_copy_ "
          f"{res['library_ms']:.4f} ms; device (a CUDA graph of 200 calls): "
          f"kernel {res['device_ms']:.4f} ms, five index_copy_ "
          f"{res['library_device_ms']:.4f} ms; route from host arrays: "
          f"packed + one copy + one launch {res['route_ms']:.4f} ms, nine "
          f"staged arrays + five index_copy_ "
          f"{res['library_route_ms']:.4f} ms; host part: pack "
          f"{pack_ms:.4f} ms; bound {res['bound_ms']:.7f} ms "
          f"({res['bound_by']}, {nbytes} bytes); against the whole-group "
          f"uploads it replaces: port bitmap {ports_np.nbytes / 2**20:.0f} "
          f"MiB {full_ports:.4f} ms, hot group {hot_nb / 2**20:.2f} MiB "
          f"{full_hot:.4f} ms")


def _spec_twin(torch, cl_a, cl_b, rng, out, device=None) -> None:
    """(b)-(d): SPEC_ROUNDS speculative rounds of datacenter-pinned
    programs on `cl_a` against the same rounds dispatched sequentially
    on `cl_b`; the refresh after the certified chain adopts its carry;
    a foreign commit rolls back only its lane; a leased view survives a
    refresh under churn."""
    import numpy as np

    from nomad_tpu_torch.lib.metrics import MetricsRegistry, default_registry
    from nomad_tpu_torch.lib.transfer import default_ledger
    from nomad_tpu_torch.scheduler import stack as stack_mod
    from nomad_tpu_torch.scheduler.stack import TorchStack
    from nomad_tpu_torch.server.select_batch import SelectCoordinator
    from nomad_tpu_torch.synth import synth_service_job

    dcs = ("dc1", "dc2", "dc3")
    masks = {id(cl): {i: _dc_mask(cl, dcs[i // 2]) for i in range(6)}
             for cl in (cl_a, cl_b)}

    def coord(cl, ids, reg=None):
        c = SelectCoordinator(registry=reg)
        c.trace_ids = dict(enumerate(ids))
        c.group_ids = {i: i // 2 for i in range(6)}    # 3 lanes of 2
        c.footprints = dict(masks[id(cl)])
        return c

    def real_round(cl, jobs, ids):
        c = coord(cl, ids)
        threads, res = _park(cl, jobs, c, SPEC_COUNT, device)
        _drive(c, threads)
        return res

    def spec_round(cl, jobs, ids, reg, prev, prev_ids, foreign=None):
        c = coord(cl, ids, reg)
        threads, res = _park(cl, jobs, c, SPEC_COUNT, device)
        if not c.try_spec_launch(cl):
            raise AssertionError(f"{ids[0]}: speculation never launched")
        _commit(cl, prev, prev_ids, foreign)
        _drive(c, threads)
        return res

    def same(ra, rb, what):
        for i in ra:
            sa = np.asarray(ra[i][1], dtype=np.float32).view(np.uint32)
            sb = np.asarray(rb[i][1], dtype=np.float32).view(np.uint32)
            if ra[i][0] != rb[i][0] or not np.array_equal(sa, sb):
                raise AssertionError(f"{what}: program {i} differs between "
                                     "the speculative and sequential runs")
            if sum(x is not None for x in ra[i][0]) != SPEC_COUNT:
                raise AssertionError(f"{what}: program {i} under-placed")

    def jobs_of():
        return [synth_service_job(rng, count=SPEC_COUNT,
                                  datacenter=dcs[i // 2]) for i in range(6)]

    reg = MetricsRegistry()
    ids = [f"r0-{i}" for i in range(6)]
    jobs = jobs_of()
    prev_a, prev_b = real_round(cl_a, jobs, ids), real_round(cl_b, jobs, ids)
    same(prev_a, prev_b, "round 0")
    for n in range(1, SPEC_ROUNDS + 1):
        rids, jobs = [f"r{n}-{i}" for i in range(6)], jobs_of()
        res_a = spec_round(cl_a, jobs, rids, reg, prev_a, ids)
        _commit(cl_b, prev_b, ids)
        res_b = real_round(cl_b, jobs, rids)
        same(res_a, res_b, f"round {n}")
        prev_a, prev_b, ids = res_a, res_b, rids
    c = reg.counters()
    if (c.get("spec.launches") != SPEC_ROUNDS
            or c.get("spec.certified") != SPEC_ROUNDS
            or c.get("spec.rolled_back", 0)):
        raise AssertionError(f"the chain did not certify clean: {c}")
    print(f"slice (b): {SPEC_ROUNDS} speculative rounds of 6 dc-pinned "
          f"programs (3 lanes of 2, count {SPEC_COUNT}) bit-identical to the "
          f"sequential twin; spec counters {c}")

    # (c) the refresh after the certified chain's plans commit adopts it
    _commit(cl_a, prev_a, ids)
    _commit(cl_b, prev_b, ids)
    sites = ("stack.hot_full", "stack.hot_delta", "stack.static_full",
             "stack.ports_full")
    led0 = default_ledger().snapshot()
    v0 = default_registry().counters(prefix="view.")
    view = TorchStack(cl_a, device=device).device_arrays()
    led1 = default_ledger().snapshot()
    v1 = default_registry().counters(prefix="view.")
    moved = {s: led1.get(s, {}).get("bytes", 0) - led0.get(s, {}).get(
        "bytes", 0) for s in sites}
    adopts = v1.get("chain_adopts", 0) - v0.get("chain_adopts", 0)
    rows = v1.get("chain_rows", 0) - v0.get("chain_rows", 0)
    if any(moved.values()) or adopts < 1:
        raise AssertionError(f"chain adoption: bytes {moved}, adopts "
                             f"{adopts}")
    _cold_equal(torch, view, cl_a, "the adopted view")
    out["adoption"] = dict(bytes=moved, chain_adopts=adopts, chain_rows=rows)
    print(f"slice (c): refresh after the certified chain: bytes {moved}, "
          f"view.chain_adopts +{adopts}, view.chain_rows +{rows}; the "
          "adopted view equals a cold upload")

    # a foreign commit in dc1 between launch and certification
    reg2 = MetricsRegistry()
    ids1, jobs1 = [f"f1-{i}" for i in range(6)], jobs_of()
    r1a, r1b = real_round(cl_a, jobs1, ids1), real_round(cl_b, jobs1, ids1)
    same(r1a, r1b, "conflict round 1")
    dc1 = next(nid for nid in sorted(cl_a.row_of)
               if cl_a.nodes[nid].datacenter == "dc1")
    ids2, jobs2 = [f"f2-{i}" for i in range(6)], jobs_of()
    r2a = spec_round(cl_a, jobs2, ids2, reg2, r1a, ids1, foreign=dc1)
    _commit(cl_b, r1b, ids1, foreign=dc1)
    r2b = real_round(cl_b, jobs2, ids2)
    same(r2a, r2b, "conflict round 2")
    c2 = reg2.counters()
    if c2.get("spec.rolled_back") != 1 \
            or c2.get("spec.redispatch_programs") != 2:
        raise AssertionError(f"the conflict did not roll back exactly the "
                             f"dc1 lane: {c2}")
    out["conflict"] = c2
    print(f"slice (b): a foreign commit in dc1 rolled back the dc1 lane "
          f"only ({c2.get('spec.redispatch_programs')} of 6 programs "
          "re-dispatched), and the result equals the sequential twin")

    # (d) the copy slot: a refresh under a held lease
    stack = TorchStack(cl_a, device=device)
    held = stack.device_arrays(lease_token="chip-smoke-held")
    snap = {f: getattr(held, f).clone() for f in held._fields}
    slots0 = default_registry().counters(prefix="view.").get("copy_slots", 0)
    nodes = [cl_a.nodes[nid] for nid in sorted(cl_a.row_of)[:8]]
    for k, node in enumerate(nodes):
        cl_a.upsert_alloc(_port_alloc(node.id, "slot", (100, 64, 10),
                                      [_ports_net(node, 9500 + k,
                                                  22000 + k)]))
    fresh = stack.device_arrays()
    slots = default_registry().counters(prefix="view.").get(
        "copy_slots", 0) - slots0
    for f, t in snap.items():
        if not torch.equal(getattr(held, f), t):
            raise AssertionError(f"copy slot: the leased {f} was written")
    stack_mod.release_view(cl_a, "chip-smoke-held")
    if slots != 1:
        raise AssertionError(f"view.copy_slots moved by {slots}")
    _cold_equal(torch, fresh, cl_a, "the refresh under a lease")
    print("slice (d): a refresh under a held lease wrote copies "
          "(view.copy_slots +1), the leased tensors unchanged, the new "
          "view equal to a cold upload")


def _phase7_slice(torch, kr, cl, nodes, rng, device=None):
    """The slice at full width (the 10,000-node / 100,000-alloc cluster,
    N = 16384): K7 under churn and timed; speculation against a
    sequential twin; chain adoption; a forced conflict; the copy slot.
    `device="cpu"` rehearses the control flow on the plain versions
    (nothing is timed)."""
    out = {}
    t0 = time.perf_counter()
    _k7_churn(torch, kr, cl, nodes, rng, out, device)
    if device is None:
        _k7_timing(torch, kr, cl, out)
    twin = copy.deepcopy(cl)
    _spec_twin(torch, cl, twin, rng, out, device)
    print(f"slice: phase 7 took {time.perf_counter() - t0:.1f} s")
    return out


# ---- phase 8: the system scheduler (K2) and preemption (K3) -------------------

#: evals of BASELINE config 4 through the Harness (phase 8 (c))
SYSTEM_EVALS = 2


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _k2_bound(arrays, p):
    """K2 reads capacity, used, node_ok, dyn_free, the referenced
    attribute columns and port words and the program's fields, and
    writes two bool[N]."""
    n, r = arrays.capacity.shape
    c, d = p.key_idx.shape[0], p.delta_idx.shape[0]
    pp, pc, ps = (p.res_ports.shape[0], p.pclr_idx.shape[0],
                  p.pset_idx.shape[0])
    words = len({int(x) >> 5 for x in p.res_ports.tolist() if x >= 0})
    bytes_ = (n * r * 4 * 2 + n * (1 + 4) + n * c * arrays.attrs.element_size()
              + n * words * 4 + 2 * n
              + _nbytes(p.ask, p.key_idx, p.lut, p.extra_mask, p.delta_idx,
                        p.delta_res, p.res_ports, p.n_dyn, p.pclr_idx,
                        p.pclr_port, p.pset_idx, p.pset_port))
    ops = n * (c + 2 * r + d * (r + 1) + pp * (pc + ps + 2) + 2 * (pc + ps))
    return _bound_ms(bytes_, ops)


def _k3_walk(torch, kpre, arrays, p, cand, order):
    """Candidate slots K3's prefix walk must read on this data: up to the
    first fitting prefix, or up to the first ineligible slot where none
    fits (summed over rows)."""
    prio_s = torch.gather(cand.prio, 1, order.long())
    elig = torch.cumprod((prio_s < kpre.INF_PRIO).int(), dim=1).bool()
    r = arrays.capacity.shape[1]
    usage_s = torch.gather(cand.usage, 1,
                           order.long()[:, :, None].expand(-1, -1, r))
    util = (arrays.used[:, None, :] - torch.cumsum(usage_s, dim=1)) \
        + p.ask[None, None, :]
    fits = torch.all(util <= arrays.capacity[:, None, :], dim=2) & elig
    first = torch.argmax(fits.int(), dim=1) + 1
    walked = torch.where(fits.any(dim=1), first, elig.sum(dim=1))
    return int(walked.sum())


def _k3_bound(torch, kpre, arrays, p, cand, order, entries=None):
    """K3 reads every row's priorities (the rank sort), the usage rows its
    walk reaches, capacity, used, node_ok, the referenced attribute
    columns; writes order, feasible, scores and the three scalars. Its
    operations: A² rank compares a row, R per walked slot. On the dense
    table the priorities are N·A words; on the compact table of `entries`
    real victims they are the row offsets and each entry's slot and
    priority (the absent slots are pads the kernel writes itself)."""
    n, a = cand.prio.shape
    r = arrays.capacity.shape[1]
    walked = _k3_walk(torch, kpre, arrays, p, cand, order)
    cols = p.key_idx.shape[0] + p.dp_key_idx.shape[0]
    table = n * a * 4 if entries is None else 4 * (n + 1) + 8 * entries
    bytes_ = (table + walked * r * 4 + n * r * 4 * 2 + n
              + n * cols * arrays.attrs.element_size()
              + n * a * 4 + n + n * 4 + 12
              + _nbytes(p.ask, p.key_idx, p.lut, p.extra_mask, p.jc_idx,
                        p.jc_val, p.dp_key_idx, p.dp_counts0))
    ops = n * a * a * 2 + walked * (r * 3 + 1) + n * (cols + 20)
    return _bound_ms(bytes_, ops), walked


def _fill_empty_nodes(state, nodes, rng) -> int:
    """One priority-50 filler alloc on every node that runs none, so an
    ask larger than any node's free room needs an eviction everywhere (a
    node without allocs would take it without one)."""
    from nomad_tpu_torch.synth import synth_alloc

    filler = next(a.job for a in state._allocs.values()
                  if a.job is not None and a.job.priority == 50)
    added = 0
    for node in nodes:
        if not any(not a.terminal_status()
                   for a in state.allocs_by_node(node.id)):
            state.upsert_alloc(synth_alloc(rng, node, filler))
            added += 1
    return added


def _preempt_job(rng, cl):
    """A priority-100 service job of one alloc whose cpu ask is one more
    than the most free cpu of any node: it fits on no node without an
    eviction, and on the large nodes after one."""
    import numpy as np

    from nomad_tpu_torch.synth import synth_service_job

    live = np.asarray(cl.node_ok[:cl.n_cap], dtype=bool)
    free = cl.capacity[:cl.n_cap, 0] - cl.used[:cl.n_cap, 0]
    ask = int(free[live].max()) + 1
    if ask > int(cl.capacity[:cl.n_cap, 0][live].max()):
        raise AssertionError(f"an ask of {ask} cpu fits no node at all")
    job = synth_service_job(rng, count=1)
    job.priority = 100
    res = job.task_groups[0].tasks[0].resources
    res.cpu, res.memory_mb = ask, 1024
    return job


def _system_program_variants(stack, state, nodes, rng):
    """(label, program) of `synth_system_job`, as the system scheduler
    compiles it (one alloc per ready node), and a variant with plan deltas
    (stopped filler allocs) and a reserved plus a dynamic port ask with
    released and consumed ports."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.scheduler.stack import PlanContext
    from nomad_tpu_torch.structs import NetworkResource, Port
    from nomad_tpu_torch.synth import synth_system_job

    job = synth_system_job(rng)
    tg = job.task_groups[0]
    yield "system job", stack.compile_tg(job, tg, len(nodes))[0]
    tg.tasks[0].resources.networks = [NetworkResource(
        mbits=1, reserved_ports=[Port("http", 8080)],
        dynamic_ports=[Port("rpc", 0)])]
    stopped = []
    for k, a in enumerate(list(state._allocs.values())[:16]):
        a = copy.copy(a)
        a.allocated_resources = mock.alloc_resources(
            cpu=200, memory_mb=128, networks=[NetworkResource(
                ip="10.0.0.1", mbits=1, reserved_ports=[Port("http", 8080)],
                dynamic_ports=[Port("rpc", 20000 + k)])])
        stopped.append(a)
    plan = PlanContext(stopped_allocs=stopped)
    for node in nodes[100:108]:
        pa = mock.alloc(job=job, node_id=node.id, task_group=tg.name)
        pa.allocated_resources = mock.alloc_resources(
            cpu=500, memory_mb=256, networks=[NetworkResource(
                ip=node.node_resources.networks[0].ip, mbits=1,
                reserved_ports=[Port("http", 8080)],
                dynamic_ports=[Port("rpc", 20003)])])
        plan.placed.append((node.id, tg.name, stack.cluster.usage_row(pa)))
        plan.placed_allocs.append(pa)
    yield "deltas + ports", stack.compile_tg(job, tg, len(nodes), plan)[0]


def _turns(fns: dict, timer, reps: int) -> dict:
    """Two routes timed in turns (a, b, b, a) by `timer(fn, reps)`: the
    mean of each route's two turns."""
    a, b = fns
    times = {a: [], b: []}
    for name in (a, b, b, a):
        times[name].append(timer(fns[name], reps))
    return {k: statistics.mean(v) for k, v in times.items()}


def _k2_against_plain(torch, kp, state, nodes, rng, out, device):
    """(a): K2 on the leased view against its plain version and its old
    pass, fed the program as tensors on the card and as numpy (both masks
    equal, bit for bit); timed: the new route and the old pass on the
    same tensors in turns (back-to-back CUDA events), and the route from
    host arrays (numpy program in, both masks on the host) against the
    route the system scheduler took before it (`params_from_numpy`'s copy
    a field, the old pass, a copy a mask)."""
    from nomad_tpu_torch.convert import params_from_numpy
    from nomad_tpu_torch.scheduler import stack as stack_mod

    cl = state.cluster
    stack = stack_mod.TorchStack(cl, device=device)
    dev = stack.device
    for label, params in _system_program_variants(stack, state, nodes, rng):
        token = next(stack_mod._DISPATCH_TOKENS)
        try:
            arrays = stack.device_arrays(lease_token=token)
            p = params_from_numpy(params, dev)
            got = _snap(torch, kp.system_feasibility(arrays, p))
            routes = {"numpy program": kp.system_feasibility(arrays, params)}
            if dev.type == "cuda":
                routes["old pass"] = kp.system_pass_cuda(arrays, p)
            want = kp.system_feasibility_plain(arrays, p)
            for what, other in [("plain", want)] + list(routes.items()):
                for name, g, w in zip(("feasible", "fits"), got, other):
                    if g.dtype != torch.bool or not torch.equal(g.cpu(),
                                                                w.cpu()):
                        raise AssertionError(f"K2 {label}: {name} differs "
                                             f"from {what}")
                    out["k2_err"] = max(out.get("k2_err", 0.0),
                                        _max_diff(g, w))
            n_feas, n_fit = int(got[0].sum()), int(got[1].sum())
            if not 0 < n_fit < n_feas:
                raise AssertionError(f"K2 {label}: {n_fit} of {n_feas}")
            line = (f"phase 8 (a) K2==plain==old pass, from tensors and "
                    f"from numpy, {label}: feasible {n_feas}, fits {n_fit}")
            if dev.type == "cuda":
                ev = _turns({
                    "new": lambda: kp.system_feasibility_cuda(arrays, p),
                    "old": lambda: kp.system_pass_cuda(arrays, p)},
                    _time_ms, 200)

                def today():
                    q = params_from_numpy(params, dev)
                    m = kp.system_pass_cuda(arrays, q)
                    return m[0].cpu(), m[1].cpu()

                host = _turns({
                    "new": lambda: kp.system_feasibility(arrays,
                                                         params).cpu(),
                    "old": today}, lambda f, n: _host_ms(torch, f, n), 50)
                before = kp.system_launch_count()
                kp.system_feasibility(arrays, params).cpu()
                launches = kp.system_launch_count() - before
                n = arrays.capacity.shape[0]

                def set_up(q):
                    parts, blocks = kp.system_stage([arrays], [0], n, q)
                    blocks(kp.stage_offsets(parts)[0])

                setup = {k: _wall_ms(lambda q=q: set_up(q), 200)
                         for k, q in (("tensors", p), ("numpy", params))}
                plain_ms = _time_ms(
                    lambda: kp.system_feasibility_plain(arrays, p), 50)
                bound_ms, bound_by = _k2_bound(arrays, p)
                line += (f"; kernel {ev['new']:.4f} ms a call (old pass "
                         f"{ev['old']:.4f}; back-to-back CUDA events, 200 "
                         f"calls in turns new, old, old, new), route from "
                         f"host arrays {host['new']:.4f} ms (the old "
                         f"route's field copies, pass and two mask copies "
                         f"{host['old']:.4f}; host clock, synced, 50 calls "
                         f"in turns), {launches} launch a call; the "
                         f"host set-up alone (program checked or packed, "
                         f"argument block built) {setup['tensors']:.4f} ms "
                         f"from tensors, {setup['numpy']:.4f} from numpy; "
                         f"plain "
                         f"{plain_ms:.4f} ms, bound {bound_ms:.7f} ms "
                         f"({bound_by})")
                if label == "system job":
                    out["k2"] = dict(ms=ev["new"], plain_ms=plain_ms,
                                     bound_ms=bound_ms, bound_by=bound_by,
                                     library_ms=None, old_pass_ms=ev["old"],
                                     host_route_ms=host["new"],
                                     old_host_route_ms=host["old"],
                                     setup_ms=setup["tensors"],
                                     numpy_setup_ms=setup["numpy"])
            print(line)
        finally:
            stack_mod.release_view(cl, token)


def _k3_same(torch, kpre, label, got, old, want, what):
    """`got` bit for bit the old route `old` (None off the card), and the
    plain version `want` on indices, order and feasible, scores within
    TOL; returns the largest score difference from plain."""
    err = 0.0
    for f in kpre.PreemptionResult._fields:
        g = getattr(got, f).cpu()
        if old is not None:
            o = getattr(old, f).cpu()
            if g.dtype != o.dtype or not torch.equal(g, o):
                raise AssertionError(f"K3 {label}, {what}: {f} differs from "
                                     "the old route")
        w = getattr(want, f).cpu()
        if f in ("scores", "best_score"):
            d = float((g - w).abs().max())
            if not d <= TOL:
                raise AssertionError(f"K3 {label}, {what}: {f} differs by "
                                     f"{d}")
            err = max(err, d)
        elif g.shape != w.shape or not torch.equal(g, w.to(g.dtype)):
            raise AssertionError(f"K3 {label}, {what}: {f} differs")
    return err


def _k3_launch_ms(torch, kpre, arrays, p, cand, reps: int) -> float:
    """Back-to-back CUDA-event time of `nomad_preempt_stage_rank` alone:
    one `preempt_rank_cuda` call's library call (its staged copy of the
    argument block and ticket, the `rank_block` launch, the ring's event)
    repeated `reps` times on that call's staged inputs and outputs, so
    the host's share is one ctypes call and the time the device's when
    that is longer. The call's staged buffer and outputs are held until
    the end."""
    held = {}
    real, real_staged = kpre._PREEMPT.rank, kpre._staged

    def grab(*call):
        held["call"] = call
        real(*call)

    def staged(parts, dev):
        out = real_staged(parts, dev)
        held["buf"] = out[0]
        return out

    kpre._PREEMPT.rank, kpre._staged = grab, staged
    try:
        held["result"] = kpre.preempt_rank_cuda(arrays, p, cand)
    finally:
        del kpre._PREEMPT.rank
        kpre._staged = real_staged
    return _time_ms(lambda: real(*held["call"]), reps)


def _k3_against_plain(torch, kpre, state, rng, out, device):
    """(b): K3 on a candidate table the retry's own host code builds from
    the filler allocs, and on one of all-equal priorities with pads,
    against its plain version and its old two-launch route, from dense
    tensors, a compact table of tensors and the retry's host arrays; one
    launch a call. Timed: the new kernel and the old route on the same
    tensors in turns (back-to-back CUDA events); the route from host
    arrays against the one the retry took before (a copy a program field,
    the dense table and the four snapshot tensors, two launches, two
    syncs) in turns on the host clock; the host set-up alone; the plain
    version; the table build and the old four-tensor upload. Counted a
    call: kernel launches, library host calls, torch operations, bytes
    staged against bytes uploaded."""
    import numpy as np

    from nomad_tpu_torch.convert import (candidates_from_numpy,
                                         params_from_numpy)
    from nomad_tpu_torch.device import resolve_device
    from nomad_tpu_torch.kernels import placement as kp
    from nomad_tpu_torch.scheduler.preemption import (candidate_table,
                                                      ranked_cluster,
                                                      ranked_snapshot)
    from nomad_tpu_torch.scheduler.stack import TorchStack
    from nomad_tpu_torch.structs import Plan

    cl = state.cluster
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    job = _preempt_job(rng, cl)
    params, _m = TorchStack(cl, device=dev).compile_tg(
        job, job.task_groups[0], 1)
    builds, uploads = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        table = candidate_table(state, cl, job, Plan())
        builds.append(time.perf_counter() - t0)
    for _ in range(5):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        arrays = ranked_cluster(cl, dev)
        if cuda:
            torch.cuda.synchronize()
        uploads.append(time.perf_counter() - t0)
    prio, usage = kpre.dense_candidates(table)
    n, a = prio.shape
    gen = np.random.default_rng(SEED)
    equal = np.where(prio < kpre.INF_PRIO, 50.0, kpre.INF_PRIO).astype(
        np.float32)
    equal[gen.random(prio.shape) < 0.1] = kpre.INF_PRIO   # pads between
    p = params_from_numpy(params, dev)
    snap = ranked_snapshot(cl)
    err = 0.0
    for label, tab in (("filler allocs", (prio, usage)),
                       ("equal priorities + pads", (equal, usage))):
        cand = candidates_from_numpy(*tab, dev)
        compact = kpre.compact_candidates(*tab)
        compact_t = kpre.CompactCandidates(
            *(torch.from_numpy(np.asarray(t)).to(dev) for t in compact[:4]),
            compact.slots)
        kpre.reset_launch_count()
        routes = {"dense tensors": kpre.preempt_rank(arrays, p, cand),
                  "compact tensors": kpre.preempt_rank(arrays, p, compact_t),
                  "host arrays": kpre.preempt_rank_compact(
                      snap, params, compact, device=dev)}
        launches = kpre.launch_count()
        old = kpre.preempt_rank_two_pass_cuda(arrays, p, cand) \
            if cuda else None
        want = kpre.preempt_rank_plain(arrays, p, cand)
        if cuda and (launches, kpre.two_pass_launch_count()) != (3, 2):
            raise AssertionError(f"K3 {label}: {launches} launches for 3 "
                                 "calls, the old route "
                                 f"{kpre.two_pass_launch_count()} for 1")
        for what, got in routes.items():
            err = max(err, _k3_same(torch, kpre, label, got, old, want,
                                    what))
        got = routes["dense tensors"]
        best, k, score = kpre.preempt_best(routes["host arrays"])
        if best < 0:
            raise AssertionError(f"K3 {label}: no node admits the ask")
        line = (f"phase 8 (b) K3==plain==old route {label}, from dense and "
                f"compact tensors and from host arrays: A={a}, entries "
                f"{int(compact.offsets[-1])}, feasible "
                f"{int(got.feasible.sum())}, best row {best} (cpu "
                f"{float(arrays.capacity[best, 0]):.0f}), k {k}, score "
                f"{score:.6f}")
        if cuda:
            ev = _turns({
                "new": lambda: kpre.preempt_rank_cuda(arrays, p, cand),
                "old": lambda: kpre.preempt_rank_two_pass_cuda(arrays, p,
                                                               cand)},
                _time_ms, 200)
            compact_ms = _time_ms(
                lambda: kpre.preempt_rank_cuda(arrays, p, compact_t), 200)
            launch_ms = _k3_launch_ms(torch, kpre, arrays, p, cand, 200)

            def new_route():
                return kpre.preempt_best(kpre.preempt_rank_compact(
                    ranked_snapshot(cl), params, compact, device=dev))

            def old_route():
                r = kpre.preempt_rank_two_pass_cuda(
                    ranked_cluster(cl, dev), params_from_numpy(params, dev),
                    candidates_from_numpy(*tab, dev))
                return int(r.best_row), float(r.best_score)

            host = _turns({"new": new_route, "old": old_route},
                          lambda f, m: _host_ms(torch, f, m), 50)
            counts = {}
            for what, fn in (("new", new_route), ("old", old_route)):
                kpre.reset_launch_count()
                fn()
                counts[what] = (kpre.launch_count()
                                + kpre.two_pass_launch_count(),
                                kpre.host_calls(), _torch_ops(fn))
            index = dev.index or 0

            def set_up(*inputs):
                parts, finish, (n_, a_, r_) = kpre.preempt_stage(*inputs,
                                                                 index)
                finish(kp.stage_offsets(parts)[0])
                kpre.preempt_layout(n_, a_, r_, 132)
                return parts

            setup = {k: _wall_ms(lambda v=v: set_up(*v), 200) for k, v in (
                ("tensors", (arrays, p, cand)),
                ("host", (ranked_snapshot(cl), params, compact)))}
            staged = sum(x.nbytes for x in set_up(snap, params, compact))
            uploaded = (_nbytes(*params_from_numpy(params, "cpu"))
                        + tab[0].nbytes + tab[1].nbytes
                        + _nbytes(*(t for t in arrays if t is not None)))
            plain_ms = _time_ms(
                lambda: kpre.preempt_rank_plain(arrays, p, cand), 20)
            (bound_ms, bound_by), walked = _k3_bound(
                torch, kpre, arrays, p, cand, got.order)
            (cbound_ms, cbound_by), _w = _k3_bound(
                torch, kpre, arrays, p, cand, got.order,
                entries=int(compact.offsets[-1]))
            line += (f"; kernel {ev['new']:.4f} ms a call from dense "
                     f"tensors (old route {ev['old']:.4f}; back-to-back "
                     f"CUDA events, 200 calls in turns new, old, old, new), "
                     f"{compact_ms:.4f} from compact tensors, "
                     f"{launch_ms:.4f} a library call alone (the staged "
                     f"copy of the argument block and the launch, 200 "
                     f"calls on one call's staged inputs); route from "
                     f"host arrays {host['new']:.4f} ms (the old route's "
                     f"uploads, two launches and two syncs "
                     f"{host['old']:.4f}; host clock, synced, 50 calls in "
                     f"turns); a call from host arrays: launches, library "
                     f"host calls, torch operations {counts['new']} (old "
                     f"{counts['old']}), {staged / 2**20:.3f} MiB staged in "
                     f"one copy (old {uploaded / 2**20:.3f} MiB uploaded); "
                     f"host set-up alone {setup['tensors']:.4f} ms from "
                     f"tensors, {setup['host']:.4f} from host arrays; plain "
                     f"{plain_ms:.4f} ms; bound {bound_ms:.7f} ms "
                     f"({bound_by}) on the dense table, {cbound_ms:.7f} "
                     f"({cbound_by}) on the compact; {walked} slots walked")
            if label == "filler allocs":
                out["k3"] = dict(
                    ms=ev["new"], plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=None,
                    old_route_ms=ev["old"], compact_ms=compact_ms,
                    launch_ms=launch_ms,
                    compact_bound_ms=cbound_ms, host_route_ms=host["new"],
                    old_host_route_ms=host["old"],
                    setup_ms=setup["tensors"], host_setup_ms=setup["host"],
                    kernel_launches_per_call=counts["new"][0],
                    old_route_launches_per_call=counts["old"][0],
                    staged_bytes=staged, old_uploaded_bytes=uploaded)
        print(line)
    out["k3_err"] = err
    print(f"phase 8 (b) host: candidate table (proposed_allocs over "
          f"{len(cl.row_of)} nodes, compact) " + " ".join(
              f"{t * 1e3:.1f}" for t in builds) + " ms; the old route's "
          f"four-tensor upload "
          f"({_nbytes(*(t for t in arrays if t is not None)) / 2**20:.2f} "
          "MiB) " + " ".join(f"{t * 1e3:.3f}" for t in uploads) + " ms")


def _config4(torch, kp, kpre, state, nodes, rng, out, device):
    """(c): BASELINE config 4 through the port's Harness, with the checks
    of `bench.py` `bench_system`: the placed node set (without victims)
    equals a scalar recomputation, and every preemption-backed placement
    is on a feasible-but-full node, names only lower-priority victims and
    fits after the eviction."""
    from nomad_tpu_torch.mock import alloc_resources
    from nomad_tpu_torch.scheduler import stack as stack_mod
    from nomad_tpu_torch.scheduler import system as system_mod
    from nomad_tpu_torch.scheduler.harness import Harness
    from nomad_tpu_torch.scheduler.oracle import driver_ok, meets_constraints
    from nomad_tpu_torch.structs import Allocation, Evaluation, allocs_fit
    from nomad_tpu_torch.synth import synth_system_job

    h = Harness(state, device=device)
    if device is None and h.device.type != "cuda":
        raise AssertionError(f"Harness default device is {h.device}")
    cuda = h.device.type == "cuda"
    walls, k2_walls, compute, compiles, compile_s = [], [], [], [], []
    real_k2 = kp.system_feasibility
    real_cp = system_mod.SystemScheduler._compute_placements
    real_compile = stack_mod.TorchStack.compile_tg

    def timed_compile(self, *a, **kw):
        t0 = time.perf_counter()
        try:
            return real_compile(self, *a, **kw)
        finally:
            compiles.append(time.perf_counter() - t0)

    def timed_cp(self, place):
        compiles.clear()
        t0 = time.perf_counter()
        try:
            return real_cp(self, place)
        finally:
            compute.append(time.perf_counter() - t0)
            compile_s.append(sum(compiles))

    def timed_k2(*a, **kw):
        t0 = time.perf_counter()
        res = real_k2(*a, **kw)
        if cuda:
            torch.cuda.synchronize()
        k2_walls.append(time.perf_counter() - t0)
        return res

    placements = preempt_placements = 0
    kp.reset_system_launch_count()
    kpre.reset_launch_count()
    kp.system_feasibility = timed_k2
    system_mod.SystemScheduler._compute_placements = timed_cp
    stack_mod.TorchStack.compile_tg = timed_compile
    try:
        for i in range(SYSTEM_EVALS):
            job = synth_system_job(rng)
            tg = job.task_groups[0]
            ask = job.combined_task_resources(tg)
            feasible, fit = set(), set()
            for n in nodes:
                if not n.ready() or n.datacenter not in job.datacenters:
                    continue
                if not all(driver_ok(n, t.driver) for t in tg.tasks):
                    continue
                if not meets_constraints(n, list(job.constraints)
                                         + list(tg.constraints)):
                    continue
                feasible.add(n.id)
                probe = Allocation(
                    id="probe", job_id=job.id, job=job, task_group=tg.name,
                    node_id=n.id, allocated_resources=alloc_resources(
                        cpu=ask.cpu, memory_mb=ask.memory_mb,
                        disk_mb=ask.disk_mb),
                    desired_status="run", client_status="pending")
                if allocs_fit(n, state.allocs_by_node(n.id) + [probe])[0]:
                    fit.add(n.id)
            state.upsert_job(job)
            n_plans = len(h.plans)
            t0 = time.perf_counter()
            h.process(Evaluation(id=uuid.uuid4().hex, namespace="default",
                                 job_id=job.id, type="system",
                                 priority=job.priority,
                                 triggered_by="job-register",
                                 status="pending"))
            walls.append(time.perf_counter() - t0)
            if h.evals[-1].status != "complete":
                raise AssertionError(f"system eval {i}: {h.evals[-1].status}")
            if len(h.plans) == n_plans:
                raise AssertionError(f"system eval {i} placed nothing")
            plan = h.plans[-1]
            got = [a for allocs in plan.node_allocation.values()
                   for a in allocs]
            plain = {a.node_id for a in got if not a.preempted_allocations}
            if plain != fit:
                raise AssertionError(
                    f"system eval {i}: {len(plain)} plain placements, "
                    f"{len(fit)} nodes fit; {len(plain ^ fit)} differ")
            by_id = {n.id: n for n in nodes}
            for a in got:
                if not a.preempted_allocations:
                    continue
                vids = set(a.preempted_allocations)
                victims = [v for vs in plan.node_preemptions.values()
                           for v in vs if v.id in vids]
                node = by_id.get(a.node_id)
                if not (a.node_id in feasible - fit and victims
                        and len(victims) == len(vids) and node is not None
                        and all((v.job.priority if v.job else 50)
                                < job.priority for v in victims)
                        and allocs_fit(node,
                                       state.allocs_by_node(a.node_id))[0]):
                    raise AssertionError(
                        f"system eval {i}: invalid preemption on "
                        f"{a.node_id}")
                preempt_placements += 1
            placements += len(got)
    finally:
        kp.system_feasibility = real_k2
        system_mod.SystemScheduler._compute_placements = real_cp
        stack_mod.TorchStack.compile_tg = real_compile
    k2, k3 = kp.system_launch_count(), kpre.launch_count()
    if cuda and k2 != SYSTEM_EVALS:
        raise AssertionError(f"{k2} K2 launches for {SYSTEM_EVALS} evals")
    if preempt_placements == 0:
        raise AssertionError("config 4 made no preemption placement")
    out["k2_launches_c"] = k2
    span = sum(walls)
    print(f"phase 8 (c) config 4: {SYSTEM_EVALS} system evals in "
          f"{span:.2f} s = {SYSTEM_EVALS / span:.3f} evals/s; {placements} "
          f"placements = {placements / span:.0f}/s; preemption placements "
          f"{preempt_placements}, all valid; node sets equal the scalar "
          f"recomputation; K2 launches {k2}, K3 launches {k3}")
    print("phase 8 (c) host per eval (s): wall " + " ".join(
        f"{w:.3f}" for w in walls) + "; compile + K2 + per-node decode "
        + " ".join(f"{c:.3f}" for c in compute) + "; K2 call with outputs "
        "on the host (ms) " + " ".join(f"{k * 1e3:.3f}" for k in k2_walls))
    # the placements' share of an eval: the compile_tg calls inside them,
    # the K2 calls (synced), and the rest — the masks' one copy back, the
    # lease and the per-node decode loop
    n = len(compute)
    spent, comp, k2s = sum(compute), sum(compile_s), sum(k2_walls)
    print(f"phase 8 (c) placements per eval: {spent / n * 1e3:.3f} ms = "
          f"compile_tg {comp / n * 1e3:.3f} ms ({comp / spent:.2%}) + K2 "
          f"with its staged copy {k2s / n * 1e3:.3f} ms ({k2s / spent:.3%}) "
          f"+ the rest (the masks' copy back, per-node decode) "
          f"{(spent - comp - k2s) / n * 1e3:.3f} ms "
          f"({(spent - comp - k2s) / spent:.2%}); no per-field upload "
          f"(0 ms: the program goes in K2's staged copy)")


def _phase8_system(torch, kp, kpre, device=None):
    """Phase 8 (a)–(c) on a synthetic state of its own (config 4 mutates
    the cluster): the BASELINE cluster at full width, N = 16384.
    `device="cpu"` rehearses the control flow on the plain versions
    (nothing is timed)."""
    from nomad_tpu_torch.synth import build_synthetic_state

    out = {}
    t0 = time.perf_counter()
    state, nodes = build_synthetic_state(N_NODES, N_ALLOCS, seed=SEED + 2)
    rng = random.Random(SEED + 2)
    added = _fill_empty_nodes(state, nodes, rng)
    print(f"phase 8: synthetic {N_NODES} nodes, {N_ALLOCS} allocs (+{added} "
          f"on nodes that had none), n_cap {state.cluster.n_cap}, built in "
          f"{time.perf_counter() - t0:.1f} s")
    _k2_against_plain(torch, kp, state, nodes, rng, out, device)
    _k3_against_plain(torch, kpre, state, rng, out, device)
    _config4(torch, kp, kpre, state, nodes, rng, out, device)
    print(f"phase 8 (a)-(c) took {time.perf_counter() - t0:.1f} s")
    return out


def _k3_server_routes(torch, kpre, s, job):
    """The retry's K3 route again on the server's state after (d)'s eval,
    from this thread while the server runs: the new route (snapshot,
    staged copy and launch, one copy back) and the old one (a copy a
    program field, the dense table and four snapshot tensors, two
    launches, two syncs) on one victim table, 5 calls each in turns on
    the host clock, synced."""
    from nomad_tpu_torch.convert import (candidates_from_numpy,
                                         params_from_numpy)
    from nomad_tpu_torch.scheduler import preemption as tpre
    from nomad_tpu_torch.scheduler.stack import TorchStack
    from nomad_tpu_torch.structs import Plan

    cl, dev = s.state.cluster, s.device
    params, _m = TorchStack(cl, device=dev).compile_tg(
        job, job.task_groups[0], 1)
    table = tpre.candidate_table(s.state, cl, job, Plan())
    dense = kpre.dense_candidates(table)

    def new():
        return kpre.preempt_best(kpre.preempt_rank_compact(
            tpre.ranked_snapshot(cl), params, table, device=dev))

    def old():
        r = kpre.preempt_rank_two_pass_cuda(
            tpre.ranked_cluster(cl, dev), params_from_numpy(params, dev),
            candidates_from_numpy(*dense, dev))
        return int(r.best_row), float(r.best_score)

    if new()[0] != old()[0]:
        raise AssertionError("K3 on the server's state: the routes differ")
    ms = _turns({"new": new, "old": old},
                lambda f, n: _host_ms(torch, f, n), 5)
    print(f"phase 8 (d) K3 route on the server's state after the eval "
          f"(this thread, the server running; {int(table.offsets[-1])} "
          f"victims, A={table.slots}): {ms['new']:.4f} ms a call against "
          f"the old route's {ms['old']:.4f} (host clock, synced, 5 calls "
          f"in turns)")


def _phase8_server(torch, kp, kpre, s, rng):
    """(d): on a started Server at full width, a system job's eval
    completes through the worker's system route (K2 launched, no nack);
    then, with service preemption on, a priority-100 service job whose
    ask fits no node without eviction places by evicting lower-priority
    allocs (K3 launched once, its old route never), its plan applied and
    marked inexact for carry adoption, and the node fits afterwards. The
    preemption eval's wall is split into the victim table's build, the
    K3 route (the snapshot, the staged copy and launch, the one copy
    back), the Preemptor and the rest."""
    from nomad_tpu_torch.scheduler import preemption as tpre
    from nomad_tpu_torch.scheduler.util import SchedulerConfiguration
    from nomad_tpu_torch.structs import allocs_fit
    from nomad_tpu_torch.synth import synth_system_job

    final = ("complete", "failed", "blocked", "cancelled")
    cuda = s.device.type == "cuda"
    nacks, plans = [], []
    real_nack, real_apply = s.broker.nack, s.planner.apply

    def nack(eval_id, token):
        nacks.append(eval_id)
        return real_nack(eval_id, token)

    def apply(plan):
        plans.append(plan)
        return real_apply(plan)

    s.broker.nack, s.planner.apply = nack, apply
    try:
        kp.reset_system_launch_count()
        job = synth_system_job(rng)
        t0 = time.perf_counter()
        ev = s.job_register(job)
        got = s.wait_for_eval(ev.id, statuses=final, timeout=600.0)
        sys_s = time.perf_counter() - t0
        if got is None or got.status != "complete":
            raise AssertionError(f"system eval through the server: {got}")
        k2 = kp.system_launch_count()
        n_sys = len(s.state.allocs_by_job("default", job.id))
        if (cuda and k2 < 1) or nacks or n_sys == 0:
            raise AssertionError(f"system eval: K2 launches {k2}, nacks "
                                 f"{nacks}, {n_sys} allocs")
        print(f"phase 8 (d) server: system eval complete in {sys_s:.2f} s, "
              f"{n_sys} allocs, K2 launches {k2}, nacks 0")

        added = _fill_empty_nodes(s.state, list(s.state.nodes()), rng)
        s.state.set_scheduler_config(
            SchedulerConfiguration(preemption_service_enabled=True))
        kpre.reset_launch_count()
        pj = _preempt_job(rng, s.state.cluster)
        plans.clear()
        spent = {"table": [], "snapshot": [], "rank": [], "best": [],
                 "preemptor": [], "ring": [], "library": []}
        real = {"table": tpre.candidate_table,
                "snapshot": tpre.ranked_snapshot,
                "rank": tpre.preempt_rank_compact, "best": tpre.preempt_best,
                "preemptor": tpre.Preemptor.preempt_for_task_group}

        inside = []   # set while the K3 route stages and launches

        def timed(key, fn):
            def call(*a, **kw):
                t1 = time.perf_counter()
                if key == "rank":
                    inside.append(1)
                try:
                    return fn(*a, **kw)
                finally:
                    if key == "rank":
                        inside.pop()
                    if key not in ("ring", "library") or inside:
                        spent[key].append(time.perf_counter() - t1)
            return call

        # inside the staged copy and launch: the pinned ring's fill and
        # wait (which enqueues through the library call) and the library
        # call alone (the copy, the launch and the event enqueued)
        kp._PINNED.send = timed("ring", kp._PINNED.send)
        kpre._PREEMPT.rank = timed("library", kpre._PREEMPT.rank)

        tpre.candidate_table = timed("table", real["table"])
        tpre.ranked_snapshot = timed("snapshot", real["snapshot"])
        tpre.preempt_rank_compact = timed("rank", real["rank"])
        tpre.preempt_best = timed("best", real["best"])
        tpre.Preemptor.preempt_for_task_group = timed("preemptor",
                                                      real["preemptor"])
        try:
            t0 = time.perf_counter()
            ev = s.job_register(pj)
            got = s.wait_for_eval(ev.id, statuses=final, timeout=600.0)
            pre_s = time.perf_counter() - t0
        finally:
            tpre.candidate_table = real["table"]
            tpre.ranked_snapshot = real["snapshot"]
            tpre.preempt_rank_compact = real["rank"]
            tpre.preempt_best = real["best"]
            tpre.Preemptor.preempt_for_task_group = real["preemptor"]
            del kp._PINNED.send, kpre._PREEMPT.rank
        if got is None or got.status != "complete":
            raise AssertionError(f"preemption eval through the server: {got}")
        k3 = kpre.launch_count()
        retries = len(spent["table"])
        allocs = s.state.allocs_by_job("default", pj.id)
        if (cuda and (k3 != retries or kpre.two_pass_launch_count())) \
                or retries < 1 or nacks or len(allocs) != 1 \
                or not allocs[0].preempted_allocations:
            raise AssertionError(f"preemption eval: K3 launches {k3} in "
                                 f"{retries} retries (old route "
                                 f"{kpre.two_pass_launch_count()}), nacks "
                                 f"{nacks}, allocs {allocs}")
        a = allocs[0]
        plan = next(p for p in plans for v in p.node_allocation.values()
                    for x in v if x.id == a.id)
        victims = [s.state.alloc_by_id(v) for v in a.preempted_allocations]
        node = s.state.node_by_id(a.node_id)
        if not all(v is not None and v.desired_status == "evict"
                   and v.job.priority < pj.priority for v in victims):
            raise AssertionError("victims not evicted or not lower priority")
        if not allocs_fit(node, s.state.allocs_by_node(node.id))[0]:
            raise AssertionError("the node does not fit after the eviction")
        if plan.carry_exact is not False:
            raise AssertionError(f"plan carry_exact {plan.carry_exact}")
        print(f"phase 8 (d) server: preemption eval complete in {pre_s:.2f} "
              f"s (+{added} filler allocs on empty nodes first; ask cpu "
              f"{pj.task_groups[0].tasks[0].resources.cpu}): placed on "
              f"{node.name} evicting {len(victims)} lower-priority allocs, "
              f"the node fits after, plan carry_exact False; K3 launches "
              f"{k3} in {retries} retry, nacks 0")
        parts = {k: sum(v) * 1e3 for k, v in spent.items()}
        route = parts["snapshot"] + parts["rank"] + parts["best"]
        rest = (pre_s * 1e3 - parts["table"] - route
                - parts["preemptor"])
        print(f"phase 8 (d) preemption eval split: {pre_s * 1e3:.3f} ms = "
              f"victim table build {parts['table']:.3f} ms + K3 route "
              f"{route:.3f} ms (snapshot {parts['snapshot']:.3f}, staged "
              f"copy and launch {parts['rank']:.3f} — of it the pinned "
              f"ring's fill and wait {parts['ring'] - parts['library']:.3f}"
              f" and the library call {parts['library']:.3f} — the one "
              f"copy back and its sync {parts['best']:.3f}) + Preemptor "
              f"{parts['preemptor']:.3f} ms + the rest (broker, reconcile, "
              f"compile, the placement dispatch, plan apply) {rest:.3f} ms")
        if cuda:
            _k3_server_routes(torch, kpre, s, pj)
        return {"k2_launches_d": k2, "k3_launches_d": k3}
    finally:
        s.broker.nack, s.planner.apply = real_nack, real_apply


# ---- phase 9: the batched-eval path (K6) and the sharded step (K9) ------------

#: bench.py's default batch (one K6 dispatch at this B in (a))
K6_BATCH = 4096
#: (b): bench_tpu's loop, cut from bench.py's 16,384 evals in batches of
#: 4,096 to keep the smoke's time
BENCH_EVALS, BENCH_BATCH, BENCH_COUNT = 4096, 1024, 8
#: (c): four shards in two mesh shapes; (a) and (c): B of the small runs
K9_SHAPES = ((2, 2), (1, 4))
SMALL_BATCH = 64
#: (a): dispatches a turn when the two packed routes are timed
K6_REPS = 5
#: a view past the on-chip route's limit (pooled route), and its B
OVERSIZED_N, OVERSIZED_B = 65536, 32


def _bench_jobs(state, rng, n, count):
    """`bench.py` `build`'s eval mix (BASELINE configs 1, 2, 3 and 5),
    each job upserted as bench does."""
    from nomad_tpu_torch.synth import synth_service_job

    jobs = []
    for i in range(n):
        j = synth_service_job(
            rng, count=count,
            with_affinity=(i % 2 == 0), with_spread=(i % 3 == 0),
            distinct_hosts=(i % 5 == 0), with_devices=(i % 4 == 0),
            distinct_property=(i % 7 == 0))
        state.upsert_job(j)
        jobs.append(j)
    return jobs


def _sync_all(torch) -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _host_ms(torch, fn, reps: int) -> float:
    """Host clock per call over `reps` calls, every card synced before
    and after (a sharded dispatch spans the cards' streams)."""
    fn()
    _sync_all(torch)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync_all(torch)
    return (time.perf_counter() - t0) / reps * 1e3


def _once_ms(torch, fn, on_card: bool):
    """(result, host ms) of one call, synced when on the card."""
    t0 = time.perf_counter()
    out = fn()
    if on_card:
        _sync_all(torch)
    return out, (time.perf_counter() - t0) * 1e3


def _batch_bound(torch, kp, arrays, batch, m, packed=False):
    """Bound of one K6 (or K9) dispatch: the view read once, every
    program's fields, and each program's outputs — its new_used and
    final_scores0 among them, or with `packed` (`place_packed_batch`,
    which returns only sel_idx and sel_score) those two alone."""
    cpu = kp.TGParams(*(t.cpu() for t in batch))
    parts = [_bound_parts(arrays, kp._program(cpu, b), m)
             for b in range(cpu.n_place.shape[0])]
    if packed:
        parts = [(v, p, m * 8, ops) for v, p, _o, ops in parts]
    return _bound_of(parts, arrays)


def _onchip_ops(cluster, p, m: int) -> int:
    """Operations of one program on K6's on-chip route (csrc/batch.cu),
    which computes a row's score terms once and then only what a step
    changes: every row's entry from the view once (the fit over R, the
    score prefix, the constraint, affinity, token and port lookups); the
    rows the program's lists name recomputed from all their terms, with
    the repeat check; per row and step the spread table lookups and
    adds, the distinct_property mask lookups and tests, the bit test,
    the prefix add, the divide and the argmax compare; per step the
    spread and distinct_property tables, and the placed row and the
    penalty rows recomputed."""
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


def _onchip_bound(torch, kp, arrays, batch, m):
    """Bound of one packed K6 dispatch on the on-chip route: the bytes of
    `_batch_bound(packed=True)`, the operations of `_onchip_ops`."""
    cpu = kp.TGParams(*(t.cpu() for t in batch))
    parts = []
    for b in range(cpu.n_place.shape[0]):
        p = kp._program(cpu, b)
        v, pr, _o, _ops = _bound_parts(arrays, p, m)
        parts.append((v, pr, m * 8, _onchip_ops(arrays, p, m)))
    return _bound_of(parts, arrays)


def _k6_samples(torch, kp, fn, reps: int):
    """`reps` K6 packed dispatches of `fn`, one at a time: each one's host
    clock (the card synced before and after) and device span (a CUDA
    event on the current stream as the argument blocks' upload is
    enqueued, so the host's fill before it is outside, and one after the
    dispatch returns: the kernels' device time). Returns (host ms, span
    ms) lists."""
    first = []
    real = kp._lane_args

    def lane_args(*args, **kw):
        out = real(*args, **kw)
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        first.append(e)
        return out

    hosts, spans = [], []
    kp._lane_args = lane_args
    try:
        for _ in range(reps):
            first.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            torch.cuda.synchronize()
            hosts.append((time.perf_counter() - t0) * 1e3)
            spans.append(first[0].elapsed_time(end))
    finally:
        kp._lane_args = real
    return hosts, spans


def _k6_routes(torch, kp, arrays, bufs, spec, m, pb, b, on_card):
    """K6's two packed routes at one B: the on-chip route (by shape, as
    `place_packed_batch` takes it) and the pooled route, each bitwise the
    full-carry route (`place_task_group_batch`); on the card both timed
    in turns (on-chip, pooled, pooled, on-chip) of K6_REPS dispatches:
    medians of the host clock and the device span a dispatch, the
    back-to-back CUDA-event time (`_time_ms`), kernel launches a dispatch
    and the peak device memory of one dispatch. Returns route → numbers."""
    def packed():
        return kp.place_packed_batch(arrays, *bufs, spec, m)

    def pooled():
        return kp._packed_batch_on("pooled", arrays, *bufs, spec, m)

    full = kp.place_task_group_batch(arrays, pb, m)
    fns = {"onchip": packed, "pooled": pooled}
    out = {}
    for route, fn in fns.items():
        before = (kp.onchip_launch_count(), kp.batch_launch_count())
        if on_card:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        sel, score = fn()
        r = out[route] = {}
        if on_card:
            torch.cuda.synchronize()
            r["peak"] = torch.cuda.max_memory_allocated() - base
            if kp.last_batch_route()[0] != route:
                raise AssertionError(f"K6 B={b}: a {route} dispatch took "
                                     f"the {kp.last_batch_route()[0]} route")
            r["config"] = kp.last_batch_route()[1]
        # kernel launches of the dispatch: the on-chip kernel counts its
        # own; a pooled dispatch is chain_static (a launch per 65,535
        # programs) and batch_scan
        onchip = kp.onchip_launch_count() - before[0]
        pooled_n = kp.batch_launch_count() - before[1]
        r["launches"] = onchip + pooled_n * (1 + -(-b // 65535))
        if not (torch.equal(sel, full.sel_idx) and torch.equal(
                score.view(torch.int32), full.sel_score.view(torch.int32))):
            raise AssertionError(f"K6 B={b}: the {route} route differs from "
                                 "place_task_group_batch")
    if on_card:
        for route in ("onchip", "pooled", "pooled", "onchip"):
            hosts, spans = _k6_samples(torch, kp, fns[route], K6_REPS)
            r = out[route]
            r.setdefault("host", []).extend(hosts)
            r.setdefault("span", []).extend(spans)
            r.setdefault("events", []).append(_time_ms(fns[route], K6_REPS))
        for r in out.values():
            for k in ("host", "span", "events"):
                r[k] = statistics.median(r[k])
    return out, full


def _phase9_batch(torch, kp, state, rng, device=None):
    """(a) K6 against plain on the phase-3 cluster: B = 64 of bench's mix,
    explain off and on, both packed routes' sel_idx and sel_score equal
    to plain; at B = 4096 and 1024 the on-chip and pooled packed routes
    bitwise the full-carry route, which equals plain at B = 4096; both
    routes timed in turns with their bounds and peaks. `device="cpu"`
    rehearses the control flow (every side plain, nothing timed)."""
    from nomad_tpu_torch.convert import params_from_numpy, tensor_from_numpy
    from nomad_tpu_torch.parallel.pad import stack_params
    from nomad_tpu_torch.scheduler.stack import TorchStack

    dev = torch.device(device or "cuda")
    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    stack = TorchStack(state.cluster, device=dev)
    jobs = _bench_jobs(state, rng, K6_BATCH, BENCH_COUNT)
    progs = [stack.compile_tg(j, j.task_groups[0], BENCH_COUNT)[0]
             for j in jobs]
    arrays = stack.device_arrays()
    out = {"err": 0.0}
    small, m = stack_params(progs[:SMALL_BATCH])
    p64 = params_from_numpy(small, dev)
    for explain in (False, True):
        got = kp.place_task_group_batch(arrays, p64, m, explain)
        want = kp.place_task_group_batch_plain(arrays, p64, m, explain)
        out["err"] = max(out["err"], _compare(
            want, got, f"K6 B={SMALL_BATCH} explain={explain}"))
        if not explain:
            want64 = want
    bufs64 = [tensor_from_numpy(x, dev) for x in kp.pack_params(small)[:3]]
    spec64 = kp.pack_params(small)[3]
    for route in ("onchip", "pooled"):
        sel, score = (kp._packed_batch_on(route, arrays, *bufs64, spec64, m)
                      if on_card else kp.place_packed_batch(
                          arrays, *bufs64, spec64, m))
        if not torch.equal(sel.cpu(), want64.sel_idx.cpu()):
            raise AssertionError(f"K6 B={SMALL_BATCH} {route}: sel_idx "
                                 "differs from plain")
        out["err"] = max(out["err"], _max_diff(score, want64.sel_score))
    if not out["err"] <= TOL:
        raise AssertionError(f"K6 B={SMALL_BATCH}: scores differ by "
                             f"{out['err']}")
    ms64 = (_time_ms(lambda: kp.place_task_group_batch(arrays, p64, m), 20)
            if on_card else None)
    print(f"K6==plain B={SMALL_BATCH} M={m} (bench's mix, count "
          f"{BENCH_COUNT}): full-carry route explain off and on, on-chip "
          f"and pooled packed routes (explain off), max_abs_err "
          f"{out['err']}: placed {int((got.sel_idx >= 0).sum())}/"
          f"{got.sel_idx.numel()}; one full-carry dispatch (explain off) "
          + (f"{ms64:.4f} ms" if ms64 is not None else "not timed"))
    out["small"] = (small, m)

    routes = {}
    for b in (K6_BATCH, BENCH_BATCH):
        big, m = stack_params(progs[:b])
        pb = params_from_numpy(big, dev)
        ibuf, fbuf, ubuf, spec = kp.pack_params(big)
        bufs = [tensor_from_numpy(x, dev) for x in (ibuf, fbuf, ubuf)]
        if not on_card:
            sel, score = kp.place_packed_batch(arrays, *bufs, spec, m)
            full = kp.place_task_group_batch(arrays, pb, m)
            if not torch.equal(sel, full.sel_idx):
                raise AssertionError(f"K6 B={b}: packed differs from full")
        else:
            routes[b], full = _k6_routes(torch, kp, arrays, bufs, spec, m,
                                         pb, b, on_card)
        if b == K6_BATCH:
            got = kp.PlacementResult(*(t.cpu() for t in full[:6]))
            want, plain_ms = _once_ms(
                torch, lambda: kp.place_task_group_batch_plain(arrays, pb, m),
                on_card)
            out["err"] = max(out["err"], _compare(want, got, f"K6 B={b}"))
            bound_ms, bound_by = _onchip_bound(torch, kp, arrays, pb, m)
            pooled_bound = _batch_bound(torch, kp, arrays, pb, m,
                                        packed=True)
            full_bound = _batch_bound(torch, kp, arrays, pb, m)
            del want, got
        del full
    if on_card:
        rs = routes[K6_BATCH]
        # ms: back-to-back CUDA events, as every kernel is timed; beside
        # it the device span and, on the same inputs, the pooled route
        out["k6"] = dict(ms=rs["onchip"]["events"], plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=None, span_ms=rs["onchip"]["span"],
                         pooled_ms=rs["pooled"]["events"])
        for b, rs in routes.items():
            print(f"K6 packed routes B={b} M={m}: on-chip and pooled sel_idx "
                  f"and sel_score bitwise place_task_group_batch's; ms a "
                  f"dispatch, medians in turns (on-chip, pooled, pooled, "
                  f"on-chip) of {K6_REPS}: " + "; ".join(
                      f"{route} host {r['host']:.4f}, device span "
                      f"{r['span']:.4f}, back-to-back events "
                      f"{r['events']:.4f}, {r['launches']} kernel "
                      f"launch(es) a dispatch, peak "
                      f"{r['peak'] / 2**20:.2f} MiB"
                      + (f", grid {r['config'][0]} x {r['config'][1]}"
                         if r.get("config") else "")
                      for route, r in rs.items()))
    print(f"K6==plain B={K6_BATCH} M={m}: the full-carry route equals "
          f"plain; bound on-chip route {bound_ms:.6f} ms ({bound_by}), "
          f"pooled route {pooled_bound[0]:.6f} ms ({pooled_bound[1]}), "
          f"full-carry {full_bound[0]:.6f} ms ({full_bound[1]}); plain "
          f"{plain_ms:.1f} ms")
    print(f"phase 9 (a) took {time.perf_counter() - t0:.1f} s")
    return stack, arrays, out


def _phase9_cases(torch, kp, cases, device=None):
    """(a) K6 on phase 3's programs (ports with plan releases and
    consumptions, deltas and penalties, preferred rows, sampled
    candidates, every stanza), stacked into one packed dispatch on the
    phase-3 view: the on-chip route bitwise the pooled and full-carry
    routes, which equal plain. Returns the max error."""
    from nomad_tpu_torch.convert import params_from_numpy, tensor_from_numpy
    from nomad_tpu_torch.parallel.pad import stack_params

    dev = torch.device(device or "cuda")
    progs = [st.compile_tg(j, j.task_groups[0], n_place, plan,
                           sampled_rows=rows)[0]
             for st, j, n_place, plan, rows in cases.values()]
    batch, m = stack_params(progs)
    arrays = next(iter(cases.values()))[0].device_arrays()
    pb = params_from_numpy(batch, dev)
    bufs = [tensor_from_numpy(x, dev) for x in kp.pack_params(batch)[:3]]
    spec = kp.pack_params(batch)[3]
    full = kp.place_task_group_batch(arrays, pb, m)
    want = kp.place_task_group_batch_plain(arrays, pb, m)
    err = _compare(want, full, "K6 phase-3 cases")
    routes = (("onchip", "pooled") if dev.type == "cuda" else (None,))
    for route in routes:
        sel, score = (kp._packed_batch_on(route, arrays, *bufs, spec, m)
                      if route else kp.place_packed_batch(arrays, *bufs,
                                                          spec, m))
        if not (torch.equal(sel, full.sel_idx) and torch.equal(
                score.view(torch.int32), full.sel_score.view(torch.int32))):
            raise AssertionError(f"K6 phase-3 cases: the {route} route "
                                 "differs from the full-carry route")
    print(f"K6 phase-3 cases: {len(progs)} programs ({', '.join(cases)}), "
          f"M={m}: on-chip and pooled packed routes bitwise the full-carry "
          f"route, == plain (max_abs_err {err}); placed "
          f"{int((full.sel_idx >= 0).sum())}/{full.sel_idx.numel()}")
    return err


def _phase9_oversized(torch, kp, arrays, small, device=None):
    """A view past the on-chip limit: the phase-3 view padded to
    OVERSIZED_N rows with copies of its last row, marked not ok. `place_packed_batch`
    must take the pooled route there, its (sel_idx, sel_score) equal to
    plain on the padded view and bitwise the on-chip route's on the
    unpadded one (the pad rows are never feasible). On the card the
    pooled route is timed there (back-to-back CUDA events), with plain
    and the bound at that shape. Returns (pooled dispatches, max error,
    the kernels line's numbers or None)."""
    from nomad_tpu_torch.convert import params_from_numpy, tensor_from_numpy

    dev = torch.device(device or "cuda")
    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    batch, m = small
    n0 = arrays.capacity.shape[0]
    view = kp.ClusterArrays(*(torch.cat((t, t[-1:].expand(
        (OVERSIZED_N - n0,) + tuple(t.shape[1:])))) for t in arrays))
    view.node_ok[n0:] = False
    batch = kp.TGParams(*(f[:OVERSIZED_B] for f in batch))
    ibuf, fbuf, ubuf, spec = kp.pack_params(batch)
    bufs = [tensor_from_numpy(x, dev) for x in (ibuf, fbuf, ubuf)]
    shapes = {name: tuple(shape[1:]) for name, _c, _o, shape in spec}
    route = kp.batch_route(OVERSIZED_N, kp._program_dims(
        shapes, m, False, OVERSIZED_N))
    if route != "pooled":
        raise AssertionError(f"N={OVERSIZED_N}: route {route}, not pooled")
    want = kp.place_packed_batch(arrays, *bufs, spec, m)
    kp.reset_chain_launch_counts()
    sel, score = kp.place_packed_batch(view, *bufs, spec, m)
    launches = kp.batch_launch_count()
    if on_card and (launches != 1 or kp.onchip_launch_count() != 0
                    or kp.last_batch_route()[0] != "pooled"):
        raise AssertionError(f"N={OVERSIZED_N}: {launches} pooled and "
                             f"{kp.onchip_launch_count()} on-chip dispatches")
    (plain_sel, plain_score), plain_ms = _once_ms(
        torch, lambda: kp.place_packed_batch_plain(view, *bufs, spec, m),
        on_card)
    if not torch.equal(sel.cpu(), plain_sel.cpu()):
        raise AssertionError(f"N={OVERSIZED_N}: sel_idx differs from plain")
    err = _max_diff(score, plain_score)
    if not err <= TOL:
        raise AssertionError(f"N={OVERSIZED_N}: scores differ by {err}")
    if not (torch.equal(sel, want[0]) and torch.equal(
            score.view(torch.int32), want[1].view(torch.int32))):
        raise AssertionError(f"N={OVERSIZED_N}: the pooled route differs "
                             "from the on-chip route on the unpadded view")
    nums = None
    if on_card:
        bound_ms, bound_by = _batch_bound(
            torch, kp, view, params_from_numpy(batch, "cpu"), m, packed=True)
        nums = dict(ms=_time_ms(lambda: kp.place_packed_batch(
            view, *bufs, spec, m), K6_REPS), plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    print(f"K6 oversized view N={OVERSIZED_N} B={OVERSIZED_B} M={m}: "
          f"place_packed_batch took the pooled route ({launches} dispatch), "
          f"== plain (max_abs_err {err}), bitwise the on-chip route on the "
          f"{arrays.capacity.shape[0]}-row view"
          + (f"; pooled {nums['ms']:.4f} ms a dispatch (back-to-back "
             f"events), plain {plain_ms:.1f} ms, bound "
             f"{nums['bound_ms']:.6f} ms ({nums['bound_by']})"
             if nums else "")
          + f"; {time.perf_counter() - t0:.1f} s")
    del view
    return launches, err, nums


def _phase9_bench(torch, kp, state, stack, rng, card, device=None):
    """(b) `bench.py` `bench_tpu`'s single-device loop on the port: per
    eval a host `compile_tg`, then `stack_params`, `pack_params` and one
    `place_packed_batch` per batch (the on-chip route at N = 16384), left
    asynchronous until the end. Every batch's sel_idx is then held
    against the plain version on the inputs it read. Returns (on-chip K6
    launches in the loop, max error, evals/s)."""
    from nomad_tpu_torch.convert import to_device_async
    from nomad_tpu_torch.parallel.pad import stack_params

    dev = torch.device(device or "cuda")
    on_card = dev.type == "cuda"
    jobs = _bench_jobs(state, rng, BENCH_EVALS, BENCH_COUNT)

    def dispatch(job_batch):
        params = [stack.compile_tg(j, j.task_groups[0], BENCH_COUNT)[0]
                  for j in job_batch]
        batched, m = stack_params(params)
        ibuf, fbuf, ubuf, spec = kp.pack_params(batched)
        arrays = stack.device_arrays()
        bufs = [to_device_async(b, dev) for b in (ibuf, fbuf, ubuf)]
        sel, scores = kp.place_packed_batch(arrays, *bufs, spec, m)
        return sel, scores, (arrays, bufs, spec, m)

    kp.reset_chain_launch_counts()
    t0 = time.perf_counter()
    dispatch(jobs[:BENCH_BATCH])[0].cpu()
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    results = []
    for i in range(0, len(jobs), BENCH_BATCH):
        results.append(dispatch(jobs[i:i + BENCH_BATCH]))
    sels = [(s.cpu(), sc.cpu()) for s, sc, _i in results]   # the sync point
    dt = time.perf_counter() - t0
    launches = kp.onchip_launch_count()
    if on_card and (launches != len(results) + 1
                    or kp.batch_launch_count() != 0):
        raise AssertionError(f"{launches} on-chip K6 launches and "
                             f"{kp.batch_launch_count()} pooled for "
                             f"{len(results) + 1} batches")
    placed = int(sum(int((s >= 0).sum()) for s, _sc in sels))
    total = sum(s.numel() for s, _sc in sels)
    err = 0.0
    for k, ((_s, _sc, (arrays, bufs, spec, m)), (got, score)) in enumerate(
            zip(results, sels)):
        want, want_score = kp.place_packed_batch_plain(arrays, *bufs, spec,
                                                       m)
        if not torch.equal(want.cpu(), got):
            raise AssertionError(f"bench batch {k}: sel_idx differs from "
                                 "plain")
        err = max(err, float((score - want_score.cpu()).abs().max()))
    if not err <= TOL:
        raise AssertionError(f"bench loop scores differ by {err}")
    rate = len(jobs) / dt
    line = (f"bench loop (bench.py bench_tpu, single-device route; "
            f"{len(jobs)} evals in batches of {BENCH_BATCH}, cut from "
            f"bench's 16,384 / 4,096 to keep the smoke's time): "
            f"{rate:.1f} evals/s ({dt:.3f} s; warm-up batch {warm:.3f} s), "
            f"placed {placed}/{total}; {card}")
    print(line)
    print(f"bench loop: every batch's sel_idx equal to plain on the inputs "
          f"it read; {launches} launches of the on-chip K6 kernel, one a "
          f"batch")
    return launches, err, rate


def _k9_against(torch, ks, mesh, sc, batched, m, want6, what, on_card):
    """K9 (`scheduler_step`) against its plain version and against K6 on
    the whole view (`want6`): sel_idx and counts equal, scores within
    TOL; the fold-in bitwise against plain. Returns the max error."""
    from nomad_tpu_torch.parallel import scheduler_step

    new_cluster, got = scheduler_step(mesh, m)(sc, batched)
    want, folded = ks.sharded_place_plain(sc, batched, m, fold=True)
    if on_card:
        _sync_all(torch)
    err = max(_compare(want, got, f"K9 {what} vs plain"),
              _compare(want6, got, f"K9 {what} vs K6"))
    for row in new_cluster.shards:
        for j, shard in enumerate(row):
            if not torch.equal(shard.used.cpu(), folded[j].cpu()):
                raise AssertionError(f"K9 {what}: fold of shard {j} "
                                     "differs from plain")
    return err


#: synced dispatches a timing of phase 9 (c)'s K9 routes takes a turn
K9_REPS = 5


def _k9_bound(kp, arrays, batch, m, sel):
    """Bound of one K9 dispatch on the cluster route: the bytes of
    `_batch_bound` (the view once, every program's fields and outputs,
    new_used [B, N, R] among them), against the lane route's operations a
    program (`_lane_ops`, the steps this run's data runs) and the fold's
    two a carry element."""
    cpu = kp.TGParams(*(t.cpu() for t in batch))
    n, r = arrays.capacity.shape
    parts = []
    for b in range(cpu.n_place.shape[0]):
        p = kp._program(cpu, b)
        v, pr, o, _ops = _bound_parts(arrays, p, m)
        parts.append((v, pr, o, _lane_ops(arrays, p, m, False, _active_steps(
            p, sel[b].cpu())) + 2 * n * r))
    return _bound_of(parts, arrays)


def _k9_routes(torch, kp, ks, sc, batched, m, what, card=""):
    """K9 with the fold on both CUDA routes of one sharded view: the
    cluster route (by shape) and the steps route (`route="steps"`),
    bitwise each other (outputs and the folded view); timed in turns
    (cluster, steps, steps, cluster), K9_REPS synced dispatches each:
    the host clock a dispatch (every card synced before and after) and
    the device span from the first launch (`_launch_spans`); host calls
    and kernel launches of a dispatch, peak device memory. Returns (the
    cluster route's result, route → numbers)."""
    fns = {"cluster": lambda: ks.sharded_place_cuda(sc, batched, m,
                                                    fold=True),
           "steps": lambda: ks.sharded_place_cuda(sc, batched, m, fold=True,
                                                  route="steps")}
    hooks = ((ks._SHARD, "call"), (kp._LANES, "launch"))
    res, out = {}, {}
    for route, fn in fns.items():
        _sync_all(torch)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        k0 = ks.step_kernel_launches()
        res[route] = fn()
        _sync_all(torch)
        out[route] = dict(peak=(torch.cuda.max_memory_allocated() - base)
                          / 2 ** 20,
                          launches=ks.step_kernel_launches() - k0,
                          calls=ks.host_calls(), route=ks.last_step_route())
        if out[route]["route"] != route:
            raise AssertionError(f"K9 {what}: the {route} dispatch took "
                                 f"{out[route]['route']}")
    if out["cluster"]["launches"] > 3 or out["cluster"]["calls"] > 5:
        raise AssertionError(f"K9 {what}: the cluster route took "
                             f"{out['cluster']}")
    _same_bits(list(res["steps"][0][:6]) + list(res["steps"][1]),
               list(res["cluster"][0][:6]) + list(res["cluster"][1]),
               f"K9 {what} cluster route vs steps route")
    for route in ("cluster", "steps", "steps", "cluster"):
        r = out[route]
        r.setdefault("host", []).append(_host_ms(torch, fns[route],
                                                 K9_REPS))
        r.setdefault("span", []).extend(
            _launch_spans(torch, fns[route], K9_REPS, hooks))
    for route, r in out.items():
        r["host"] = statistics.median(r["host"])
        r["span"] = statistics.median(r["span"])
        print(f"K9 {what} {route}: {r['host']:.4f} ms a synced dispatch "
              f"(host clock), span {r['span']:.4f} ms, {r['calls']} host "
              f"calls, {r['launches']} kernel launches a dispatch, peak "
              f"{r['peak']:.2f} MiB; {card}")
    return res["cluster"], out


def _phase9_shard(torch, kp, arrays, small, device=None, card=""):
    """(c) K9 on four shards, meshes (2, 2) and (1, 4) over the cards
    (repeating a card when there are fewer than four): through
    `entry.dryrun_multichip(4, ...)` at its own size (the main path: the
    launch counts are read around it; on one card the cluster route, one
    lane-kernel launch and the fold's a dispatch), then on the phase-3
    cluster with B = 64; each against its plain version and K6, and on
    the card both CUDA routes bitwise each other, timed in turns."""
    from nomad_tpu_torch import entry
    from nomad_tpu_torch.convert import params_from_numpy
    from nomad_tpu_torch.kernels import shard as ks
    from nomad_tpu_torch.parallel import make_mesh, shard_cluster

    on_card = device is None or torch.device(device).type == "cuda"
    count = torch.cuda.device_count() if on_card else 4
    devs = ([f"cuda:{i % count}" for i in range(4)] if on_card
            else [device] * 4)
    out = {"err": 0.0, "launches": 0, "calls": 0}
    t0 = time.perf_counter()
    for shape in K9_SHAPES:
        ks.reset_launch_count()
        run = entry.dryrun_multichip(4, devices=devs, batch=shape[0])
        calls, launches = ks.launch_count(), ks.step_kernel_launches()
        route = ks.last_step_route()
        out["calls"] += calls
        out["launches"] += launches
        if on_card and (calls != 1 or (count == 1 and (
                route != "cluster" or launches != 2))):
            raise AssertionError(f"dry run {shape}: {calls} K9 dispatches, "
                                 f"{launches} kernel launches, route {route}")
        whole = run.cluster.full()
        want6 = kp.place_task_group_batch(
            whole, params_from_numpy(run.batch, whole.used.device),
            run.max_allocs)
        out["err"] = max(out["err"], _k9_against(
            torch, ks, run.mesh, run.cluster, run.batch, run.max_allocs,
            want6, f"dry run {shape}", on_card))
        print(f"K9 dry run {shape}: == plain == K6 on the whole view, fold "
              f"bitwise; {calls} K9 dispatch, {launches} kernel launches, "
              f"{route} route")
    batched, m = small
    want6 = kp.place_task_group_batch(arrays,
                                      params_from_numpy(batched,
                                                        arrays.used.device),
                                      m)
    old_bound, old_by = _batch_bound(
        torch, kp, arrays, params_from_numpy(batched, "cpu"), m)
    for shape in K9_SHAPES:
        mesh = make_mesh(4, batch=shape[0], devices=devs)
        sc = shard_cluster(arrays, mesh)
        out["err"] = max(out["err"], _k9_against(
            torch, ks, mesh, sc, batched, m, want6,
            f"phase-3 cluster {shape}", on_card))
        _w, plain_ms = _once_ms(torch, lambda: ks.sharded_place_plain(
            sc, batched, m, fold=True), on_card)
        nums = dict(ms=None, plain_ms=plain_ms, bound_ms=old_bound,
                    bound_by=old_by, library_ms=None)
        if on_card and count == 1:
            got, rs = _k9_routes(torch, kp, ks, sc, batched, m,
                                 f"B={SMALL_BATCH} {shape}", card)
            bound_ms, bound_by = _k9_bound(kp, arrays, params_from_numpy(
                batched, "cpu"), m, got[0].sel_idx)
            c, st = rs["cluster"], rs["steps"]
            nums.update(
                ms=c["host"], bound_ms=bound_ms, bound_by=bound_by,
                span_ms=c["span"], host_calls=c["calls"],
                kernel_launches=c["launches"], peak_mib=c["peak"],
                steps_ms=st["host"], steps_span_ms=st["span"],
                steps_host_calls=st["calls"],
                steps_kernel_launches=st["launches"],
                steps_peak_mib=st["peak"], steps_bound_ms=old_bound)
        elif on_card:
            nums["ms"] = _host_ms(torch, lambda: ks.sharded_place(
                sc, batched, m, fold=True), K9_REPS)
        out[shape] = nums
        ms = nums["ms"]
        print(f"K9 phase-3 cluster {shape} B={SMALL_BATCH} M={m}: == plain "
              f"== K6, fold bitwise; "
              + (f"{ms:.4f} ms a dispatch, {ms / m:.4f} ms a step"
                 if ms is not None else "not timed")
              + f"; plain {plain_ms:.1f} ms; bound {nums['bound_ms']:.6f} ms "
              f"({nums['bound_by']}; the steps route's count "
              f"{old_bound:.6f} ms, {old_by}); shards on {sorted(set(devs))}")
    print(f"phase 9 (c) took {time.perf_counter() - t0:.1f} s")
    return out


# ---- phase 10: the server on a device mesh (B10-B13); C1 at 65,536 programs ----

#: four shards of the card in two mesh shapes (the kernels line reads the
#: first)
MESH_SHAPES = ((1, 4), (2, 2))
#: (a): the sharded routes' shapes; (1, 8) is the widest thread-block
#: cluster of the chain kernel
ROUTE_SHAPES = MESH_SHAPES + ((1, 8),)
#: (a): programs of the sharded chain, the phase-3 mix as phase 5 runs it
CHAIN_MIX = ("binpack", "constraint", "affinity", "spread_targets",
             "distinct_hosts", "distinct_property", "ports", "delta_penalty")
#: (b): service evals through each server, all queued before start()
MESH_EVALS = 64
#: (d): programs of one dispatch past gridDim.y's 65,535, tiled from 16
TILED_COPIES = 4096
#: (a): dispatches timed a route
ROUTE_REPS = 10
#: (d): node shards of the phase-3 view for B12's many small shards
MANY_SHARDS = 64


def _mesh(torch, shape, device=None):
    """A mesh of shape[0] x shape[1] shards over the cards (repeating a
    card when there are fewer), or over `device`."""
    from nomad_tpu_torch.parallel import make_mesh

    n = shape[0] * shape[1]
    on_card = device is None or torch.device(device).type == "cuda"
    count = torch.cuda.device_count() if on_card else n
    devs = ([f"cuda:{i % count}" for i in range(n)] if on_card
            else [device] * n)
    return make_mesh(n, batch=shape[0], devices=devs)


def _dispatch_samples(torch, ks, fn, reps: int):
    """`reps` sharded chain dispatches of `fn`, one at a time: each one's
    host clock (every card synced before and after) and device span (CUDA
    events on the current stream just before its first launch, so the
    host's set-up before it is outside, and just after it returns: on the
    cluster route the two kernels' device time, on the steps route also
    the device's waits for the host's launches and copies). Returns (host
    ms, span ms) lists."""
    first = []

    def call(*args, **kw):
        if not first:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            first.append(e)
        return real(*args, **kw)

    real = ks._SHARD.call
    hosts, spans = [], []
    ks._SHARD.call = call
    try:
        for _ in range(reps):
            first.clear()
            _sync_all(torch)
            t0 = time.perf_counter()
            fn()
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            _sync_all(torch)
            hosts.append((time.perf_counter() - t0) * 1e3)
            spans.append(first[0].elapsed_time(end))
    finally:
        del ks._SHARD.call
    return hosts, spans


def _route_times(torch, ks, what, fns, on_card):
    """B10's or B11's two CUDA routes on one sharded view, in turns
    (cluster, steps, steps, cluster) of ROUTE_REPS dispatches: per route
    the medians over both turns of the host clock and the device span a
    dispatch (`_dispatch_samples`), the host calls and the kernel launches
    of one dispatch. `fns` maps the route to a dispatch."""
    out = {}
    if not on_card:
        return out
    for route in ("cluster", "steps", "steps", "cluster"):
        before = ks.route_launch_counts()[what]
        fns[route]()
        _sync_all(torch)
        launches = ks.route_launch_counts()[what] - before
        calls = ks.host_calls()
        if ks.last_chain_route() != route:
            raise AssertionError(f"{what}: {route} dispatch took the "
                                 f"{ks.last_chain_route()} route")
        hosts, spans = _dispatch_samples(torch, ks, fns[route], ROUTE_REPS)
        r = out.setdefault(route, dict(host_ms=[], span_ms=[]))
        r["host_ms"] += hosts
        r["span_ms"] += spans
        r.update(calls=calls, launches=launches)
    for r in out.values():
        r["host_ms"] = statistics.median(r["host_ms"])
        r["span_ms"] = statistics.median(r["span_ms"])
    return out


def _torch_ops(fn) -> int:
    """The torch operations (aten calls: kernels, copies, allocations) one
    call of `fn` dispatches, counted by a TorchDispatchMode."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def _b12_routes(torch, ks, kp, sc, sysp):
    """B12's two CUDA routes on one sharded view, in turns (cards, shards,
    shards, cards) of ROUTE_REPS calls each on the host clock, every card
    synced before and after (`_host_ms`): per route the mean of its two
    turns, and for one call its kernel launches, its library host calls
    (`ks.host_calls()`: staged copies, launches, copies between cards)
    and the torch operations it dispatches."""
    fns = {"cards": lambda: kp.system_feasibility(sc, sysp),
           "shards": lambda: kp.system_feasibility(sc, sysp,
                                                   route="shards")}
    out = {k: dict(ms=v) for k, v in _turns(
        fns, lambda f, n: _host_ms(torch, f, n), ROUTE_REPS).items()}
    for route, fn in fns.items():
        before = ks.route_launch_counts()["system"]
        fn()
        out[route]["launches"] = ks.route_launch_counts()["system"] - before
        out[route]["calls"] = ks.host_calls()
        out[route]["torch_ops"] = _torch_ops(fn)
    _sync_all(torch)
    return out


def _phase10_routes(torch, kp, ks, arrays, chain, single, sysp, device=None,
                    card="", sys_np=None):
    """(a) B10, B11 and B12 on sharded views of the card, meshes (1, 4),
    (2, 2) and (1, 8): each against its plain version on the same shards
    and against the unsharded kernel on the whole view (K4, K1, K2);
    indices, counts and masks equal, floats within TOL. B10 and B11 also
    take their steps route, called directly, which must equal the cluster
    route bitwise. Timed per dispatch: the entry point on the host clock
    with the card synced (the kernels line's ms), and both CUDA routes in
    turns on the host clock and as a device span between CUDA events,
    with their host calls and launches. `chain` = (packed buffers, spec,
    max_allocs, stacked programs), `single` = (program, max_allocs),
    `sysp` a system program (tensors; `sys_np` the same as numpy). B12's
    cards route (one launch a card) must equal its shards route (K2's old
    pass a shard, rebased), plain and K2 bit for bit, from tensors and
    from numpy; the two are timed in turns with their launches, host
    calls and torch operations a call."""
    from nomad_tpu_torch.parallel import shard_cluster

    on_card = device is None or torch.device(device).type == "cuda"
    bufs, spec, m, stacked = chain
    p1, m1 = single
    out = {"err": dict.fromkeys(("chain", "single", "system"), 0.0)}
    cpu_batch = kp.TGParams(*(t.cpu() for t in stacked))
    bounds = {
        "chain": _bound_of([_bound_parts(arrays, kp._program(cpu_batch, b),
                                         m, own_carry=False)
                            for b in range(cpu_batch.n_place.shape[0])],
                           arrays),
        "single": _bound(arrays, p1, m1),
        "system": _k2_bound(arrays, sysp)}
    batch = kp._unpack_params(*bufs, spec)
    batch1 = kp.TGParams(*(t.unsqueeze(0) for t in p1))
    unsharded = {"chain": "K4", "single": "K1", "system": "K2"}
    for shape in ROUTE_SHAPES:
        sc = shard_cluster(arrays, _mesh(torch, shape, device))
        layout = ks.chain_route(sc.devices[0])
        calls = {}
        for explain in (False, True):
            got = kp.place_packed_chain(sc, *bufs, spec, m, explain=explain)
            calls["chain"] = ks.host_calls()
            if ks.last_chain_route() != layout:
                raise AssertionError(f"B10 {shape}: took the "
                                     f"{ks.last_chain_route()} route, the "
                                     f"layout gives {layout}")
            plain = kp._flat_outputs(ks.sharded_chain_plain(
                sc, batch, m, explain)[0], explain)
            k4 = kp.place_packed_chain(arrays, *bufs, spec, m,
                                       explain=explain)
            for want, what in ((plain, "plain"), (k4, "K4")):
                out["err"]["chain"] = max(out["err"]["chain"], _compare_flat(
                    (want, ()), (got, ()), f"B10 {shape} vs {what}",
                    explain))
        got = kp.place_task_group(sc, p1, m1, explain=True)
        calls["single"] = ks.host_calls()
        plain = ks.sharded_task_group_plain(sc, p1, m1, True)
        for want, what in ((plain, "plain"),
                           (kp.place_task_group(arrays, p1, m1, True), "K1")):
            out["err"]["single"] = max(out["err"]["single"], _compare(
                want, got, f"B11 {shape} vs {what}"))
        if on_card and layout == "cluster":
            if calls != {"chain": 2, "single": 2}:
                raise AssertionError(f"{shape}: host calls a dispatch "
                                     f"{calls}, the cluster route makes 2")
            # the two CUDA routes on the same shards, bit for bit
            for what, b, mm in (("chain", batch, m), ("single", batch1, m1)):
                for explain in (False, True):
                    a = ks._chain_cluster(sc, b, mm, explain, route=what)
                    z = ks._chain_steps(sc, b, mm, explain, route=what)
                    _bitwise(torch, a, z, f"{what} {shape} cluster vs "
                             f"steps, explain {explain}")
        before = ks.route_launch_counts()["system"]
        got = kp.system_feasibility(sc, sysp)
        b12_launches = ks.route_launch_counts()["system"] - before
        calls["system"] = ks.host_calls()
        wants = [(ks.sharded_system_plain(sc, sysp), "plain"),
                 (kp.system_feasibility(arrays, sysp), "K2")]
        if on_card:
            cards = len(ks.card_groups([sh.used.device
                                        for sh in sc.shards[0]]))
            lead = sc.shards[0][0].used.device
            off = sum(sh.used.device != lead for sh in sc.shards[0])
            if b12_launches != cards or calls["system"] != 2 * cards + off:
                raise AssertionError(
                    f"B12 {shape}: {b12_launches} launches and "
                    f"{calls['system']} host calls on {cards} card(s)")
            wants += [(kp.system_feasibility(sc, sysp, route="shards"),
                       "the shards route")]
            if sys_np is not None:
                wants += [(kp.system_feasibility(sc, sys_np),
                           "the cards route from numpy")]
        for want, what in wants:
            for a, b, name in zip(want, got, ("feasible", "fits")):
                if b.dtype != torch.bool or not torch.equal(a.cpu(), b.cpu()):
                    raise AssertionError(f"B12 {shape}: {name} differs from "
                                         f"{what}")
                out["err"]["system"] = max(out["err"]["system"],
                                           _max_diff(a, b))
        fns = {
            "chain": (lambda: kp.place_packed_chain(sc, *bufs, spec, m,
                                                    explain=True),
                      lambda: ks.sharded_chain_plain(sc, batch, m, True)),
            "single": (lambda: kp.place_task_group(sc, p1, m1, True),
                       lambda: ks.sharded_task_group_plain(sc, p1, m1,
                                                           True)),
            "system": (lambda: kp.system_feasibility(sc, sysp),
                       lambda: ks.sharded_system_plain(sc, sysp))}
        two = {
            "chain": {"cluster": lambda: ks._chain_cluster(
                          sc, batch, m, True, snapshots=False),
                      "steps": lambda: ks._chain_steps(
                          sc, batch, m, True, snapshots=False)},
            "single": {"cluster": lambda: ks._chain_cluster(
                           sc, batch1, m1, True, route="single"),
                       "steps": lambda: ks._chain_steps(
                           sc, batch1, m1, True, route="single")}}
        for route, (kernel, plain_fn) in fns.items():
            ms = _host_ms(torch, kernel, ROUTE_REPS) if on_card else None
            _w, plain_ms = _once_ms(torch, plain_fn, on_card)
            bound_ms, bound_by = bounds[route]
            times = (_route_times(torch, ks, route, two[route], on_card)
                     if route in two and layout == "cluster" else {})
            entry = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None)
            b12 = (_b12_routes(torch, ks, kp, sc, sysp)
                   if route == "system" and on_card else None)
            if b12:
                entry.update(cards_ms=b12["cards"]["ms"],
                             shards_ms=b12["shards"]["ms"],
                             launches_per_call=b12["cards"]["launches"],
                             shards_launches_per_call=b12["shards"][
                                 "launches"],
                             host_calls=b12["cards"]["calls"],
                             torch_ops=b12["cards"]["torch_ops"],
                             shards_torch_ops=b12["shards"]["torch_ops"])
            if times:
                entry.update(steps_ms=times["steps"]["host_ms"],
                             span_ms=times["cluster"]["span_ms"],
                             steps_span_ms=times["steps"]["span_ms"])
                # the scan alone: the cluster route's span, explain off
                b, mm = (batch, m) if route == "chain" else (batch1, m1)
                _h, off = _dispatch_samples(
                    torch, ks, lambda: ks._chain_cluster(
                        sc, b, mm, False, snapshots=False), ROUTE_REPS)
                times["cluster"]["off_ms"] = statistics.median(off)
                steps = b.n_place.shape[0] * mm
            out.setdefault(shape, {})[route] = entry
            print(f"phase 10 (a) {route} {shape}: == plain == unsharded "
                  f"({unsharded[route]}), max_abs_err {out['err'][route]}; "
                  + (f"{ms:.4f} ms a dispatch" if ms is not None
                     else "not timed")
                  + f"; plain {plain_ms:.1f} ms; bound {bound_ms:.6f} ms "
                  f"({bound_by}); host calls a dispatch {calls[route]}"
                  + (f"; route {layout}" if route in two else "")
                  + (f"; the {shape[0] * shape[1]} shards share one card"
                     if on_card and torch.cuda.device_count() == 1 else ""))
            for name, t in (b12 or {}).items():
                print(f"phase 10 (a) system {shape} {name} route: "
                      f"{t['ms']:.4f} ms a call (host clock, every card "
                      f"synced; mean of two turns of {ROUTE_REPS} calls, "
                      f"cards, shards, shards, cards); {t['launches']} "
                      f"kernel launches, {t['calls']} library host calls, "
                      f"{t['torch_ops']} torch operations a call; {card}")
            for name, t in times.items():
                print(f"phase 10 (a) {route} {shape} {name} route: host "
                      f"clock {t['host_ms']:.4f} ms, device span from the "
                      f"first launch (CUDA events) {t['span_ms']:.4f} ms a "
                      f"dispatch (medians of {2 * ROUTE_REPS} dispatches in "
                      f"turns, cluster, steps, steps, cluster); "
                      f"{t['calls']} host calls, {t['launches']} launches a "
                      f"dispatch; {card}")
            if times:
                on = times["cluster"]["span_ms"]
                off = times["cluster"]["off_ms"]
                print(f"phase 10 (a) {route} {shape} cluster route, explain "
                      f"off: device span {off:.4f} ms a dispatch (median of "
                      f"{ROUTE_REPS}); a step of the {steps}: "
                      f"{off / steps * 1e3:.1f} µs, explain's share "
                      f"{(on - off) / steps * 1e3:.1f} µs; {card}")
    return out


def _bitwise(torch, want, got, what: str) -> None:
    """Two (PlacementResult, carries) of the sharded chain, bit for bit:
    every output and explain leaf, new_used where both have it, and the
    shards' final (used, dyn_free)."""
    def bits(t):
        t = t.detach().cpu().contiguous()
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    (rw, cw), (rg, cg) = want, got
    leaves = [(f, getattr(rw, f), getattr(rg, f))
              for f in ("sel_idx", "sel_score", "nodes_feasible", "nodes_fit",
                        "new_used", "final_scores0")]
    if rw.explain is not None:
        leaves += [(f, a, b) for f, a, b in zip(
            type(rw.explain)._fields, rw.explain, rg.explain)]
    for (u, d), (gu, gd) in zip(cw, cg):
        leaves += [("carry used", u, gu), ("carry dyn_free", d, gd)]
    for name, a, b in leaves:
        if (a is None) != (b is None) or (a is not None and not (
                a.shape == b.shape and torch.equal(bits(a), bits(b)))):
            raise AssertionError(f"{what}: {name} differs")


def _phase10_view(torch, kr, cl, nodes, rng, device=None):
    """(a) B13: the view cache under a (2, 2) mesh keeps a sharded view
    and refreshes it with K7 per shard. Rounds of churn on the phase-3
    cluster; every flush the refresh made is replayed on a CPU copy of
    the shards (the plain version) and, with its global rows, on an
    unsharded copy of the view (K7 on the whole view): the fields K7
    writes equal both in every copy of every shard, and every field a
    cold upload, bitwise; the flushes launched once for each shard copy
    with changes. Then K7's hot part at 64 rows on the shards (one packed
    buffer for the card, one launch a copy) is timed against its plain
    version."""
    import numpy as np

    from nomad_tpu_torch.kernels.placement import ClusterArrays
    from nomad_tpu_torch.parallel import set_active_mesh
    from nomad_tpu_torch.parallel.mesh import copy_fields, shard_copies
    from nomad_tpu_torch.scheduler import stack as stack_mod
    from nomad_tpu_torch.scheduler.stack import TorchStack

    dev = torch.device(device or "cuda")
    on_card = dev.type == "cuda"
    real = stack_mod.apply_view_delta
    calls = []

    def recorder(bufs, delta, shard_rows=None):
        if shard_rows is not None:
            calls.append((delta, shard_rows, list(bufs[0])))
        return real(bufs, delta, shard_rows)

    def fields(sc, to=None):
        """Per field {(device, node shard): tensor} of a sharded view (a
        copy on `to` when given)."""
        return ClusterArrays(*({k: t if to is None else t.to(to, copy=True)
                                for k, t in f.items()}
                               for f in copy_fields(sc)))

    def k7_bufs(f):
        return (f.used, f.node_ok, f.dyn_free, f.ports_used)

    set_active_mesh(_mesh(torch, (2, 2), device))
    try:
        stack = TorchStack(cl, device=dev)
        sc = stack.device_arrays()
        plain = fields(sc, "cpu")
        flat = sc.full()
        flat = ClusterArrays(*(t.clone() for t in flat))
        kr.reset_sharded_delta_launch_count()
        stack_mod.apply_view_delta = recorder
        try:
            live = []
            for rnd in range(2):
                for k in range(16):
                    node = nodes[rng.randrange(len(nodes))]
                    port = 9500 + rnd * 16 + k
                    a = _port_alloc(node.id, f"mesh-{rnd}", (100, 64, 10),
                                    [_ports_net(node, port, port + 12000)])
                    cl.upsert_alloc(a)
                    live.append(a)
                for _ in range(6):
                    a = live.pop(rng.randrange(len(live)))
                    a.client_status = "complete"
                    cl.upsert_alloc(a)
                node = nodes[rng.randrange(len(nodes))]
                node.meta = dict(node.meta or {}, mesh=str(rnd))
                cl.upsert_node(node)
                sc = stack.device_arrays()
        finally:
            stack_mod.apply_view_delta = real
        launches = kr.sharded_delta_launch_count()
        rows = sc.n // len(sc.row0)
        copies_changed = 0
        for delta, shard_rows, keys in calls:
            kr.apply_view_delta(k7_bufs(plain), delta, shard_rows)
            kr.apply_view_delta(k7_bufs(flat), delta)
            changed = delta.split(shard_rows, len(sc.row0))
            copies_changed += sum(key[1] in changed for key in keys)
        if on_card:
            _sync_all(torch)
        err = 0.0
        for (d, j), copy in shard_copies(sc).items():
            # the fields K7 writes (a re-registration re-uploads the static
            # ones, held against the cold upload below)
            for f in ("used", "node_ok", "dyn_free", "ports_used"):
                got = getattr(copy, f).cpu()
                wants = (getattr(plain, f)[(d, j)],
                         getattr(flat, f)[j * rows:(j + 1) * rows].cpu())
                if not all(torch.equal(got, w) for w in wants):
                    raise AssertionError(f"B13: copy ({d}, {j}) {f} differs "
                                         "from plain or the unsharded K7")
                err = max([err] + [_max_diff(w, got) for w in wants])
        for i in range(len(sc.devices)):
            _cold_equal(torch, ClusterArrays(*(torch.cat(
                [getattr(c, f) for c in sc.shards[i]])
                for f in ClusterArrays._fields)), cl,
                f"B13 batch row {i}")
        parts = sorted({name for delta, _r, _k in calls
                        for name in ("hot", "port_rows", "port_words")
                        if getattr(delta, name) is not None})
        if on_card and (launches != copies_changed or len(parts) < 3):
            raise AssertionError(f"B13: {launches} sharded K7 launches for "
                                 f"{copies_changed} shard copies with "
                                 f"changes, parts {parts}")
        # K7's hot part at 64 rows on the shards, every copy
        idx = np.sort(np.random.default_rng(SEED).choice(
            cl.n_cap, 64, replace=False)).astype(np.int32)
        delta = kr.ViewDelta()
        delta.add_hot(idx, cl.used[idx], cl.node_ok[idx], cl.dyn_free[idx])
        cur = k7_bufs(fields(sc))
        ms = (_host_ms(torch, lambda: kr.apply_view_delta(cur, delta, rows),
                       20) if on_card else None)
        t0 = time.perf_counter()
        for _ in range(20):
            kr.apply_view_delta(k7_bufs(plain), delta, rows)
        plain_ms = (time.perf_counter() - t0) / 20 * 1e3
        n_copies = len(shard_copies(sc))
        # a hot row reads its index, used, node_ok and dyn_free values and
        # writes the last three, once in each copy of its shard
        row_in = 4 + cl.used.shape[1] * 4 + 1 + 4
        bound_ms, bound_by = _bound_ms(
            64 * (n_copies // len(sc.row0)) * (2 * row_in - 4), 0)
        out = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=None)
        print(f"phase 10 (a) B13 (2, 2): 2 churn rounds refreshed with K7 per "
              f"shard ({len(calls)} flushes, {launches} K7 launches for "
              f"{copies_changed} shard copies with changes, parts {parts}); "
              "every copy == plain == K7 on the unsharded view == a cold "
              f"upload, bitwise (max_abs_err {err}); hot part at 64 rows "
              f"over {n_copies} copies (one packed buffer, a launch a copy) "
              + (f"{ms:.4f} ms" if ms is not None else "not timed")
              + f", plain {plain_ms:.4f} ms, bound {bound_ms:.7f} ms "
              f"({bound_by})")
        return out, err
    finally:
        set_active_mesh(None)


def _phase10_server(torch, kp, ks, kr, device=None):
    """(b) The phase-6 state and mix through `Server(ServerConfig(
    num_schedulers=1, eval_batch=16, mesh=...))`, all evals queued at once
    (registered with the broker's leader gate closed, then restored, the
    way `start()` restores evals registered before it; the server itself
    starts before the ingest so that it arms no 10,000 heartbeat timer
    threads), then one service eval alone (the single program) and a
    system job's eval: for each mesh shape the placements, alloc by
    alloc, must equal the same feed through `mesh=None`. Every sharded
    chain (B10) and single (B11) dispatch of a meshed server is captured
    (the view and programs it read, the outputs it wrote) and held
    against its plain version on those inputs. The meshed runs are this
    phase's main path: the launch counts of B10-B13 are set to 0 just
    before each and read just after (summed here). Returns (the counts,
    the max error of the captured dispatches by route, the calls on the
    sharded view by route: dispatches, system mask calls, view flushes)."""
    from nomad_tpu_torch.parallel import get_active_mesh
    from nomad_tpu_torch.scheduler import stack as stack_mod
    from nomad_tpu_torch.server import Server, ServerConfig
    from nomad_tpu_torch.synth import synth_service_job, synth_system_job

    on_card = device is None or torch.device(device).type == "cuda"
    final = ("complete", "failed", "blocked", "cancelled")
    base = None
    counts = dict.fromkeys(ks.ROUTES + ("view",), 0)
    err = {"chain": 0.0, "single": 0.0}
    # the coordinator's chain and single routes, and the stack's solo one
    sites = ((kp, "place_packed_chain", "chain"),
             (kp, "place_task_group", "single"),
             (stack_mod, "place_task_group", "single"))
    real = [getattr(mod, name) for mod, name, _r in sites]
    records = []
    # calls on the sharded view (B12's system masks, B13's flushes; B10's
    # and B11's dispatches are the records), summed over the meshed runs
    calls = dict.fromkeys(ks.ROUTES + ("view",), 0)
    run_calls = dict(calls)
    real_sys, real_flush = kp.system_feasibility, stack_mod.apply_view_delta

    def counting_sys(arrays, *args, **kw):
        if isinstance(arrays, ks.ShardedCluster):
            run_calls["system"] += 1
        return real_sys(arrays, *args, **kw)

    def counting_flush(bufs, delta, shard_rows=None):
        if shard_rows is not None:
            run_calls["view"] += 1
        return real_flush(bufs, delta, shard_rows)

    def recorder(fn, route):
        def rec(arrays, *args, **kw):
            if not isinstance(arrays, ks.ShardedCluster):
                return fn(arrays, *args, **kw)
            snap = _snap(torch, (arrays,) + args)
            res = fn(arrays, *args, **kw)
            records.append((route, snap, kw.get("explain", False),
                            _snap(torch, res)))
            return res
        return rec

    def capture(on):
        for (mod, name, route), fn in zip(sites, real):
            setattr(mod, name, recorder(fn, route) if on else fn)
        kp.system_feasibility = counting_sys if on else real_sys
        stack_mod.apply_view_delta = counting_flush if on else real_flush

    for shape in (None,) + MESH_SHAPES:
        mesh = None if shape is None else _mesh(torch, shape, device)
        label = "mesh=None" if shape is None else f"mesh {shape}"
        srng = random.Random(SEED + 5)
        t0 = time.perf_counter()
        s = Server(ServerConfig(num_schedulers=1, heartbeat_ttl=3600.0,
                                eval_batch=16, mesh=mesh), device=device)
        try:
            # started before the ingest, as in phase 6: `start()` arms a
            # TTL timer thread per node already in the state, 10,000 here
            s.start()
            _ingest(s, srng)
            jobs, dh = _mix(srng, MESH_EVALS)
            # every eval queued at once: registered while the broker's
            # leader gate is closed, then restored together, as `start()`
            # restores the evals registered before it
            s.broker.set_enabled(False)
            evs = [s.job_register(j) for j in jobs]
            ingest_s = time.perf_counter() - t0
            records.clear()
            run_calls.update(dict.fromkeys(run_calls, 0))
            capture(True)
            ks.reset_route_launch_counts()
            kr.reset_sharded_delta_launch_count()
            start = time.time()
            s.broker.set_enabled(True)
            s._restore_evals()
            done = [s.wait_for_eval(ev.id, statuses=final, timeout=600.0)
                    for ev in evs]
            if any(d is None or d.status != "complete" for d in done):
                raise AssertionError(
                    f"{label}: {[d and d.status for d in done]}")
            lat = sorted(d.modify_time - start for d in done)
            span = lat[-1]
            deadline = time.time() + 10.0
            while s.workers[0].batch_stats.get("evals", 0) < MESH_EVALS \
                    and time.time() < deadline:
                time.sleep(0.01)   # the worker's counters land last
            stats = dict(s.workers[0].batch_stats)
            one = synth_service_job(srng, count=3)
            got = s.wait_for_eval(s.job_register(one).id, statuses=final,
                                  timeout=600.0)
            sysj = synth_system_job(srng)
            got2 = s.wait_for_eval(s.job_register(sysj).id, statuses=final,
                                   timeout=600.0)
            if got is None or got.status != "complete" or got2 is None \
                    or got2.status != "complete":
                raise AssertionError(f"{label}: lone eval {got}, system "
                                     f"{got2}")
            run_counts = dict(ks.route_launch_counts(),
                              view=kr.sharded_delta_launch_count())
            capture(False)
            names = {nid: nd.name for nid, nd in s.state._nodes.items()}
            placed = {}
            for ji, j in enumerate(jobs + [one, sysj]):
                allocs = s.state.allocs_by_job("default", j.id)
                if ji < len(jobs) and (len(allocs) != 10 or (
                        dh[ji] and len({a.node_id for a in allocs}) != 10)):
                    raise AssertionError(f"{label}: job {ji} placed "
                                         f"{len(allocs)}/10")
                for a in allocs:
                    placed[(ji, a.name.rsplit("[", 1)[1])] = names[a.node_id]
            n_sys = len(s.state.allocs_by_job("default", sysj.id))
        finally:
            capture(False)
            s.shutdown()
        if get_active_mesh() is not None:
            raise AssertionError("the server left its mesh installed")
        q = lambda f: lat[min(int(f * len(lat)), len(lat) - 1)]  # noqa: E731
        disp = stats.get("dispatches", 0)
        print(f"phase 10 (b) server {label}: ingest + {MESH_EVALS} evals "
              f"queued in {ingest_s:.1f} s; {MESH_EVALS} evals in "
              f"{span:.3f} s from their release, {MESH_EVALS / span:.2f} "
              f"evals/s, latency from the release p50 {q(0.5) * 1e3:.1f} ms, "
              f"p99 "
              f"{q(0.99) * 1e3:.1f} ms; {disp} dispatches of "
              f"{stats.get('programs', 0)} programs, "
              f"{stats.get('dispatch_ms', 0.0) / max(disp, 1):.1f} ms a "
              f"dispatch on the coordinator; then a lone eval and a system "
              f"eval ({n_sys} allocs); sharded launches {run_counts}")
        if shape is None:
            base = placed
            continue
        for k, n in run_counts.items():
            counts[k] += n
        for route in ("chain", "single"):
            run_calls[route] = sum(r == route for r, *_x in records)
        for k, n in run_calls.items():
            calls[k] += n
        print(f"phase 10 (b) {label}: calls on the sharded view {run_calls} "
              f"(chain and single: dispatches; system: mask calls; view: "
              f"flushes) for the launches {run_counts}")
        if set(base) != set(placed) or any(base[k] != placed[k]
                                           for k in base):
            diff = sorted(k for k in base if base.get(k) != placed.get(k))
            raise AssertionError(f"{label}: the meshed server places "
                                 f"differently: {len(diff)} allocs, e.g. "
                                 f"{diff[:4]}")
        if on_card and not all(run_counts.values()):
            raise AssertionError(f"{label}: a sharded route never launched "
                                 f"on the meshed server: {run_counts}")
        cards = len(ks.card_groups(mesh.grid()[0]))
        if on_card and run_counts["system"] != cards * run_calls["system"]:
            raise AssertionError(
                f"{label}: {run_counts['system']} B12 launches for "
                f"{run_calls['system']} mask calls on {cards} card(s), the "
                "cards route makes one a card")
        if on_card and ks.chain_route(mesh.grid()[0]) == "cluster":
            # every chain and single dispatch: one static, one cluster launch
            for route in ("chain", "single"):
                if run_counts[route] != 2 * run_calls[route]:
                    raise AssertionError(
                        f"{label}: {run_counts[route]} {route} launches for "
                        f"{run_calls[route]} dispatches, the cluster route "
                        "makes 2 a dispatch")
        t1 = time.perf_counter()
        shapes = []
        for i, (route, args, explain, res) in enumerate(records):
            what = f"{label} {route} dispatch {i}"
            if route == "chain":
                sc, ib, fb, ub, spec, m = args
                batch = kp._unpack_params(ib, fb, ub, spec)
                want = kp._flat_outputs(ks.sharded_chain_plain(
                    sc, batch, m, explain)[0], explain)
                err[route] = max(err[route], _compare_flat(
                    (want, ()), (res, ()), what, explain))
                shapes.append(f"P={batch.n_place.shape[0]} M={m}")
            else:
                sc, p, m = args
                want = ks.sharded_task_group_plain(sc, p, m, explain)
                err[route] = max(err[route], _compare(want, res, what))
                shapes.append(f"single M={m}")
        if not any(r == "chain" for r, *_x in records):
            raise AssertionError(f"{label}: no sharded chain dispatch")
        records.clear()
        print(f"phase 10 (b) {label}: {len(placed)} allocs placed alike "
              f"with and without the mesh; {len(shapes)} captured sharded "
              f"dispatches ({', '.join(shapes)}) == plain on the inputs "
              f"they read, max_abs_err {err} "
              f"({time.perf_counter() - t1:.1f} s)")
    return counts, err, calls


def _tiled(kp, small, copies):
    import numpy as np

    return kp.TGParams(*(np.tile(np.asarray(f), (copies,) + (1,) * (
        np.asarray(f).ndim - 1)) for f in small))


def _wave_past_grid_y(torch, kp, arrays, progs, dev):
    """C1: a wave of 16 · TILED_COPIES one-program lanes (65,536, past
    gridDim.y's 65,535) from the program table: on the card the lane
    route, one launch and the fold's, bitwise chain.cu's route; every
    lane equal to the plain result of its original, the fold the plain
    fold of the 16, and every row a lane changed a collision (all its
    lanes' copies change it). Returns the lane count."""
    import numpy as np

    from nomad_tpu_torch.convert import tensor_from_numpy
    from nomad_tpu_torch.lib.transfer import default_ledger
    from nomad_tpu_torch.server.program_table import DeviceProgramTable

    table = DeviceProgramTable(device=dev)
    prep = table.prepare(progs)
    ti, tf, tu, _nb, _count = table.commit(prep, default_ledger())
    dyn = [tensor_from_numpy(d, dev)
           for d in (prep.dyn_i, prep.dyn_f, prep.dyn_u)]
    k = len(progs)
    rows = np.tile(np.asarray(prep.rows).reshape(k, 1), (TILED_COPIES, 1))
    wdyn = [d.reshape(k, 1, -1).repeat(TILED_COPIES, 1, 1) for d in dyn]
    args = (arrays, ti, tf, tu, rows, *wdyn, prep.sspec, prep.dspec, prep.m)
    k0 = kp.chain_kernel_launches()["wave"]
    out, carry = kp.place_table_wave(*args)
    if dev.type == "cuda":
        launches = kp.chain_kernel_launches()["wave"] - k0
        if kp.last_chain_dispatch_route()[0] != "cluster" or launches != 2:
            raise AssertionError(f"wave of {rows.shape[0]} lanes: "
                                 f"{kp.last_chain_dispatch_route()}, "
                                 f"{launches} kernel launches")
        ref = kp.place_table_wave_cuda(*args, clusters=0)
        _same_bits(ref, (out, carry), f"wave of {rows.shape[0]} lanes: "
                   "lane route vs chain.cu")
    want_out, want_carry = kp.place_table_wave_plain(
        arrays, ti, tf, tu, np.asarray(prep.rows).reshape(k, 1),
        *[d.reshape(k, 1, -1) for d in dyn], prep.sspec, prep.dspec, prep.m)
    for i, (w, g) in enumerate(zip(want_out[:-1], out[:-1])):
        w, g = w.cpu(), g.cpu()
        g = g.reshape((TILED_COPIES,) + tuple(w.shape))
        if not torch.equal(g, w.expand_as(g).to(g.dtype)):
            raise AssertionError(f"wave of {rows.shape[0]} lanes: output "
                                 f"{i} of a lane differs from its "
                                 "original's plain result")
    for w, g, name in zip(want_carry, carry, ("used", "dyn_free")):
        if not torch.equal(w.cpu(), g.cpu()):
            raise AssertionError(f"wave of {rows.shape[0]} lanes: the "
                                 f"folded {name} differs from plain's")
    changed = ((want_carry[0] != arrays.used).any(dim=1)
               | (want_carry[1] != arrays.dyn_free))
    if int(changed.sum()) == 0 or int(out[-1]) != int(changed.sum()):
        raise AssertionError(f"wave of {rows.shape[0]} lanes: "
                             f"{int(out[-1])} collisions, "
                             f"{int(changed.sum())} rows changed")
    return rows.shape[0]


def _phase10_many_shards(torch, kp, ks, arrays, sysp, sys_np, device=None,
                         card=""):
    """(d) B12 over many small shards: the phase-3 view as MANY_SHARDS
    node shards (256 rows each at N = 16384), one launch a card; both
    masks, from numpy and from tensors, equal K2 on the whole view and
    (on the card) the shards route, bit for bit; the two routes timed in
    turns. Returns the max error."""
    from nomad_tpu_torch.parallel import shard_cluster

    on_card = device is None or torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    sc = shard_cluster(arrays, _mesh(torch, (1, MANY_SHARDS), device))
    rows = sc.n // MANY_SHARDS
    before = ks.route_launch_counts()["system"]
    got = kp.system_feasibility(sc, sys_np)
    launches = ks.route_launch_counts()["system"] - before
    wants = [(kp.system_feasibility(arrays, sysp), "K2 on the whole view"),
             (kp.system_feasibility(sc, sysp), "the cards route from "
              "tensors")]
    cards = len(ks.card_groups([sh.used.device for sh in sc.shards[0]]))
    if on_card:
        if launches != cards:
            raise AssertionError(f"B12 over {MANY_SHARDS} shards: "
                                 f"{launches} launches on {cards} card(s)")
        wants.append((kp.system_feasibility(sc, sysp, route="shards"),
                      "the shards route"))
    err = 0.0
    for want, what in wants:
        for a, b, name in zip(want, got, ("feasible", "fits")):
            if b.dtype != torch.bool or not torch.equal(a.cpu(), b.cpu()):
                raise AssertionError(f"B12 over {MANY_SHARDS} shards: "
                                     f"{name} differs from {what}")
            err = max(err, _max_diff(a, b))
    line = (f"phase 10 (d) B12 over {MANY_SHARDS} shards of {rows} rows: "
            f"== K2 on the whole view, == the cards route from tensors"
            + (" and the shards route" if on_card else "")
            + f", bit for bit; {launches} launch on {cards} card(s)")
    if on_card:
        t = _b12_routes(torch, ks, kp, sc, sysp)
        line += "; " + ", ".join(
            f"{k} route {v['ms']:.4f} ms a call ({v['launches']} launches, "
            f"{v['calls']} library host calls, {v['torch_ops']} torch "
            f"operations)" for k, v in t.items()) + f"; {card}"
    print(line + f" ({time.perf_counter() - t0:.1f} s)")
    return err


def _phase10_limits(torch, kp, ks, device=None):
    """(d) C1: one K6 dispatch (the full-carry route, and the packed one
    on its on-chip route), one K9 batch row (its cluster route on the
    card) and one K5 wave of 65,536 programs on a 64-row view (16
    distinct programs tiled): every copy equal to the plain result of its
    original. C2: the packed route's (sel_idx, sel_score) bitwise the
    full-carry route's."""
    from nomad_tpu_torch.convert import params_from_numpy, tensor_from_numpy
    from nomad_tpu_torch.parallel import shard_cluster
    from nomad_tpu_torch.parallel.pad import stack_params
    from nomad_tpu_torch.scheduler.stack import TorchStack
    from nomad_tpu_torch.synth import build_synthetic_state

    dev = torch.device(device or "cuda")
    t0 = time.perf_counter()
    state, _nodes = build_synthetic_state(48, 200, seed=SEED)
    stack = TorchStack(state.cluster, device=dev)
    jobs = _bench_jobs(state, random.Random(SEED + 9), 16, 3)
    progs = [stack.compile_tg(j, j.task_groups[0], 3)[0] for j in jobs]
    small, m = stack_params(progs)
    big = _tiled(kp, small, TILED_COPIES)
    arrays = stack.device_arrays()
    b = TILED_COPIES * 16

    def same(want, got, fields, what):
        for f in fields:
            w, g = getattr(want, f).cpu(), getattr(got, f).cpu()
            g = g.reshape((-1,) + tuple(w.shape))
            if not torch.equal(g, w.expand_as(g).to(g.dtype)):
                raise AssertionError(f"{what}: {f} of a copy differs from "
                                     "its original's plain result")

    want = kp.place_task_group_batch_plain(arrays, params_from_numpy(
        small, dev), m)
    got = kp.place_task_group_batch(arrays, params_from_numpy(big, dev), m)
    ibuf, fbuf, ubuf, spec = kp.pack_params(big)
    bufs = [tensor_from_numpy(x, dev) for x in (ibuf, fbuf, ubuf)]
    sel, score = kp.place_packed_batch(arrays, *bufs, spec, m)
    if dev.type == "cuda" and kp.last_batch_route()[0] != "onchip":
        raise AssertionError(f"K6 B={b}: the packed dispatch took the "
                             f"{kp.last_batch_route()[0]} route")
    same(want, got, ("sel_idx", "nodes_feasible", "nodes_fit", "sel_score",
                     "new_used"), f"K6 B={b}")
    same(want, kp.PlacementResult(sel, score, None, None, None, None, None),
         ("sel_idx", "sel_score"), f"K6 packed B={b}")
    if not (torch.equal(sel, got.sel_idx) and torch.equal(
            score.view(torch.int32), got.sel_score.view(torch.int32))):
        raise AssertionError(f"K6 B={b}: the packed route differs from the "
                             "full-carry route")
    del got
    sc = shard_cluster(arrays, _mesh(torch, (1, 4), device))
    want9, _f = ks.sharded_place_plain(sc, small, m)
    got9, _f = ks.sharded_place(sc, big, m)
    if dev.type == "cuda" and ks.last_step_route() != "cluster":
        raise AssertionError(f"K9 B={b}: the {ks.last_step_route()} route")
    same(want9, got9, ("sel_idx", "nodes_feasible", "nodes_fit",
                       "sel_score", "final_scores0", "new_used"),
         f"K9 B={b}")
    del got9
    # B12 on the same (1, 4) view: shards of 16 rows, one launch a card
    from nomad_tpu_torch.synth import synth_system_job

    sysj = synth_system_job(random.Random(SEED + 10))
    psys = stack.compile_tg(sysj, sysj.task_groups[0], len(_nodes))[0]
    before = ks.route_launch_counts()["system"]
    masks = kp.system_feasibility(sc, psys)
    b12 = ks.route_launch_counts()["system"] - before
    whole = kp.system_feasibility(arrays, psys)
    if not torch.equal(masks.cpu(), whole.cpu()) or not masks[0].any():
        raise AssertionError("B12 on 16-row shards differs from K2")
    if dev.type == "cuda" and b12 != len(
            ks.card_groups([sh.used.device for sh in sc.shards[0]])):
        raise AssertionError(f"B12 on 16-row shards: {b12} launches")
    lanes = _wave_past_grid_y(torch, kp, arrays, progs, dev)
    print(f"phase 10 (d) C1: K6 (the full-carry route, and the packed "
          f"dispatch on its on-chip route, grid {kp.last_batch_route()[1]}), "
          f"one K9 batch row of {b} programs ({ks.last_step_route()} route) "
          f"and one wave of {lanes} lanes (the lane route, bitwise "
          f"chain.cu's) on {arrays.capacity.shape[0]} rows, every copy equal "
          f"to the plain result of its original; B12 on those four "
          f"shards of {sc.n // 4} rows == K2, {b12} launch; C2: the packed "
          f"route's "
          f"sel_idx and sel_score bitwise the full-carry route's "
          f"({time.perf_counter() - t0:.1f} s)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; "
              "this script needs an NVIDIA card", file=sys.stderr)
        return 1

    from nomad_tpu_torch import mock
    from nomad_tpu_torch.convert import params_from_numpy, tensor_from_numpy
    from nomad_tpu_torch.kernels import _build
    from nomad_tpu_torch.kernels import placement as kp
    from nomad_tpu_torch.kernels import preemption as kpre
    from nomad_tpu_torch.kernels import rows as kr
    from nomad_tpu_torch.kernels import shard as ks
    from nomad_tpu_torch.parallel.pad import pad_params, stack_params
    from nomad_tpu_torch.scheduler import stack as stack_mod
    from nomad_tpu_torch.scheduler.harness import Harness
    from nomad_tpu_torch.scheduler.stack import PlanContext, TorchStack
    from nomad_tpu_torch.structs import (Constraint, Evaluation,
                                         NetworkResource, Port, Spread)
    from nomad_tpu_torch.synth import (build_synthetic_state,
                                       synth_service_job, synth_system_job)

    # ---- 1. the card ----
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    print(f"device: {kind} (count {count}), torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    print(smi[0])

    # ---- 2. build ----
    t0 = time.perf_counter()
    sources = ("placement", "chain", "lanes", "batch", "rows", "system",
               "preempt", "shard")
    _build.build_all(sources)
    kp.build_kernel()
    kp.build_chain_kernel()
    kp.build_lanes_kernel()
    kp.build_batch_kernel()
    kp.build_system_kernel()
    kpre.build_kernel()
    kr.build_kernel()
    ks.build_kernel()
    print(f"build: {', '.join(f'{n}.cu' for n in sources)} in parallel, "
          f"{time.perf_counter() - t0:.2f} s in all")
    for name in sources:
        secs, log = _build.BUILD_INFO[name]
        print(f"  {name}.cu: nvcc {secs:.2f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print("    ptxas:", line.strip())

    # ---- 3. kernel against plain at full width ----
    t0 = time.perf_counter()
    state, nodes = build_synthetic_state(N_NODES, N_ALLOCS, seed=SEED)
    cl = state.cluster
    print(f"synthetic: {N_NODES} nodes, {N_ALLOCS} allocs, n_cap {cl.n_cap}, "
          f"built in {time.perf_counter() - t0:.1f} s")
    rng = random.Random(SEED)

    # allocs holding a reserved and a dynamic port on 64 nodes
    holder = synth_service_job(rng, count=1)
    state.upsert_job(holder)
    holders = []
    for k, node in enumerate(nodes[:64]):
        a = mock.alloc(job=holder, node_id=node.id, client_status="running")
        a.job_id = holder.id
        a.allocated_resources = mock.alloc_resources(
            cpu=100, memory_mb=64, disk_mb=10, networks=[NetworkResource(
                ip=node.node_resources.networks[0].ip, mbits=1,
                reserved_ports=[Port("http", 8080)],
                dynamic_ports=[Port("rpc", 20000 + k)])])
        state.upsert_alloc(a)
        holders.append(a)

    def job(**kw):
        return synth_service_job(rng, count=10, **kw)

    def with_constraint(j, c):
        j.constraints.append(c)
        return j

    def port_job():
        j = job()
        j.task_groups[0].tasks[0].resources.networks = [NetworkResource(
            mbits=1, reserved_ports=[Port("http", 8080)],
            dynamic_ports=[Port("rpc", 0)])]
        return j

    def port_plan(j):
        tg = j.task_groups[0]
        plan = PlanContext(stopped_allocs=holders[:4])
        for node in nodes[100:103]:
            pa = mock.alloc(job=j, node_id=node.id, task_group=tg.name)
            pa.allocated_resources = mock.alloc_resources(
                cpu=250, memory_mb=128, networks=[NetworkResource(
                    ip=node.node_resources.networks[0].ip, mbits=1,
                    reserved_ports=[Port("http", 8080)],
                    dynamic_ports=[Port("rpc", 20005)])])
            plan.placed.append((node.id, tg.name, cl.usage_row(pa)))
            plan.placed_allocs.append(pa)
        return plan

    filler = list(state._allocs.values())[:8]
    even = job()
    even.spreads = [Spread(attribute="${attr.rack}", weight=50)]
    pj = port_job()
    sampled = sorted(rng.sample(range(N_NODES), min(2048, N_NODES // 4)))
    binpack, spread_alg = TorchStack(cl), TorchStack(cl, algorithm="spread")
    cases = {
        "binpack": (binpack, job(), 10, None, None),
        "algorithm_spread": (spread_alg, job(), 10, None, None),
        "constraint": (binpack, with_constraint(job(), Constraint(
            "${node.class}", "linux-large", "=")), 10, None, None),
        "all_infeasible": (binpack, with_constraint(job(), Constraint(
            "${attr.kernel.name}", "windows", "=")), 10, None, None),
        "affinity": (binpack, job(with_affinity=True), 10, None, None),
        "spread_targets": (binpack, job(with_spread=True), 10, None, None),
        "even_spread": (binpack, even, 10, None, None),
        "distinct_hosts": (binpack, job(distinct_hosts=True), 10, None,
                           None),
        "distinct_property": (binpack, job(distinct_property=True), 10,
                              None, None),
        "ports": (binpack, pj, 10, port_plan(pj), None),
        "delta_penalty": (binpack, job(), 10, PlanContext(
            stopped_allocs=filler, penalty_node_ids=[
                frozenset({nodes[i].id, nodes[i + 1].id})
                for i in range(0, 20, 2)]), None),
        "preferred": (binpack, job(), 10, PlanContext(
            preferred_node_ids=[nodes[7].id, None, nodes[9].id]), None),
        "sampled": (binpack, job(with_affinity=True), 10, None, sampled),
        "gpu": (binpack, job(with_devices=True), 10, None, None),
        "n_place_zero": (binpack, job(), 0, None, None),
    }
    max_err = 0.0
    timing_inputs = None
    for name, (stack, j, n_place, plan, rows) in cases.items():
        tg = j.task_groups[0]
        params, m = stack.compile_tg(j, tg, n_place, plan,
                                     sampled_rows=rows)
        (padded,), _ = pad_params([params])
        arrays = stack.device_arrays()
        p = params_from_numpy(padded, "cuda")
        placed = None
        for explain in (False, True):
            # K1 by shape (the lane route, csrc/lanes.cu), and placement.cu
            got = kp.place_task_group_cuda(arrays, p, m, explain)
            route = kp.last_single_route()
            scan = kp.place_task_group_cuda(arrays, p, m, explain,
                                            clusters=0)
            want = kp.place_task_group_plain(arrays, p, m, explain)
            torch.cuda.synchronize()
            max_err = max(max_err, _compare(want, got, f"{name}/{explain}"))
            _same_bits(_k1_leaves(scan), _k1_leaves(got),
                       f"{name}/{explain} lane route vs placement.cu")
            placed = int((got.sel_idx >= 0).sum())
        print(f"kernel==plain {name:18s} M={m:2d} placed={placed:2d} "
              f"feasible={int(got.nodes_feasible)}; route {route}, "
              f"bitwise placement.cu's")
        if name == "affinity":
            timing_inputs = (arrays, p, m)
    if placed is None:
        raise AssertionError("no case ran")
    print(f"K1: every phase-3 case, explain off and on, on the lane route "
          f"bitwise placement.cu's; max abs error against plain {max_err}")

    arrays, p, m = timing_inputs
    k1_res, k1 = _k1_routes(torch, kp, arrays, p, m, True, smi[0])
    _res_off, k1_off = _k1_routes(torch, kp, arrays, p, m, False, smi[0])
    kernel_ms = k1["lane"]["events"]
    plain_ms = _time_ms(lambda: kp.place_task_group_plain(arrays, p, m, True),
                        5)
    bound_ms, bound_by = _k1_bound(kp, arrays, p, m, k1_res.sel_idx, True)
    old_bound, old_by = _bound(arrays, p, m)
    print(f"timing (N={arrays.capacity.shape[0]}, M={m}, explain on; "
          f"{smi[0]}): lane route {kernel_ms:.4f} ms, placement.cu "
          f"{k1['placement.cu']['events']:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.6f} ms ({bound_by}; placement.cu's count "
          f"{old_bound:.6f} ms, {old_by}); explain off: lane route "
          f"{k1_off['lane']['events']:.4f} ms, placement.cu "
          f"{k1_off['placement.cu']['events']:.4f} ms")

    # ---- 4. the slice through Harness on the card ----
    calls = []
    real_place = stack_mod.place_task_group

    def recording_place(cluster, params, max_allocs, explain=False):
        # the inputs as the launch read them: later evals' refreshes
        # write the cached view in place once this select's lease ends
        snap = _snap(torch, (cluster, params))
        res = real_place(cluster, params, max_allocs, explain=explain)
        calls.append((*snap, max_allocs, explain, res))
        return res

    h = Harness(state)
    if h.device.type != "cuda":
        raise AssertionError(f"Harness default device is {h.device}")
    mix = [dict(with_affinity=i % 2 == 0, with_spread=i % 3 == 0,
                distinct_hosts=i % 4 == 1, with_devices=i % 4 == 3,
                distinct_property=i % 5 == 2) for i in range(8)]
    jobs = [synth_service_job(rng, count=10, **kw) for kw in mix]
    walls = []
    gc_pauses = []      # (generation, seconds) of collections in the evals
    gc_start = []

    def on_gc(phase, info):
        if phase == "start":
            gc_start.append(time.perf_counter())
        elif gc_start:
            gc_pauses.append((info["generation"],
                              time.perf_counter() - gc_start.pop()))

    torch.cuda.reset_peak_memory_stats()
    stack_mod.place_task_group = recording_place
    kp.reset_launch_count()     # K1's programs, kernel launches and routes
    gc.callbacks.append(on_gc)
    try:
        for j in jobs:
            state.upsert_job(j)
            ev = Evaluation(namespace="default", priority=j.priority,
                            type="service", job_id=j.id, status="pending")
            t0 = time.perf_counter()
            h.process(ev)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    finally:
        stack_mod.place_task_group = real_place
        gc.callbacks.remove(on_gc)
    launches = kp.launch_count()
    k1_kernels = kp.single_kernel_launches()
    k1_routes = kp.single_route_counts()
    peak = torch.cuda.max_memory_allocated()

    if launches != len(calls) or launches == 0:
        raise AssertionError(f"{launches} kernel launches for "
                             f"{len(calls)} selects")
    if k1_routes["cluster"] != launches or k1_kernels != launches:
        raise AssertionError(f"K1 on the Harness path: {k1_routes}, "
                             f"{k1_kernels} kernel launches for {launches} "
                             "selects (one lane-route launch each)")
    placed = {}
    for plan in h.plans:
        for node_id, allocs in plan.node_allocation.items():
            for a in allocs:
                placed.setdefault(a.job_id, []).append(node_id)
    for j, kw in zip(jobs, mix):
        got = placed.get(j.id, [])
        if len(got) != 10:
            raise AssertionError(f"job {j.id}: {len(got)}/10 placed")
        if kw["distinct_hosts"] and len(set(got)) != 10:
            raise AssertionError(f"job {j.id}: distinct_hosts violated")
    if any(e.status != "complete" for e in h.evals):
        raise AssertionError([e.status for e in h.evals])
    for i, (cluster, params, max_allocs, explain, res) in enumerate(calls):
        want = kp.place_task_group_plain(cluster, params, max_allocs, explain)
        max_err = max(max_err, _compare(want, res, f"select {i}"))
    torch.cuda.synchronize()
    print(f"slice: {len(jobs)} evals, {sum(map(len, placed.values()))} allocs "
          f"placed, {len(calls)} selects, {launches} programs on the card in "
          f"{k1_kernels} kernel launches, all on the lane route")
    print(f"slice: per-eval wall median {statistics.median(walls) * 1e3:.1f} "
          f"ms, max {max(walls) * 1e3:.1f} ms; kernel {kernel_ms:.4f} "
          f"ms/launch, plain {plain_ms:.4f} ms/launch; peak device memory "
          f"{peak / 2**20:.1f} MiB")
    gcs = {}
    for g, t in gc_pauses:
        gcs.setdefault(g, []).append(t)
    print("slice: per-eval wall ms " + " ".join(
        f"{w * 1e3:.1f}" for w in walls) + "; garbage collections during "
        "the evals: " + (", ".join(
            f"gen {g}: {len(ts)}, total {sum(ts) * 1e3:.1f} ms, max "
            f"{max(ts) * 1e3:.1f} ms" for g, ts in sorted(gcs.items()))
            or "none"))

    k1_launches = launches

    # ---- 5. chain, wave and insert kernels against plain ----
    k5 = _phase5_kernels(torch, kp, kr, cases, nodes, rng)
    max_err = max(max_err, k5["max_err"])

    # ---- 6. the server path, then 8 (d) on the same server ----
    server = _phase6_server(
        torch, kp, kr, rng,
        then=lambda s: _phase8_server(torch, kp, kpre, s,
                                      random.Random(SEED + 3)))
    max_err = max(max_err, server["max_err"])
    served = server["then"]

    # ---- 7. the slice at full width ----
    slice_ = _phase7_slice(torch, kr, cl, nodes, rng)

    # ---- 8. the system scheduler and preemption at full width ----
    sys8 = _phase8_system(torch, kp, kpre)

    # ---- 9. the batched-eval path (K6) and the sharded step (K9) ----
    stack9, arrays9, k6 = _phase9_batch(torch, kp, state, rng)
    k6_launches, bench_err, _rate = _phase9_bench(torch, kp, state, stack9,
                                                  rng, smi[0])
    k6["err"] = max(k6["err"], _phase9_cases(torch, kp, cases))
    k6_pooled, oversized_err, pooled_nums = _phase9_oversized(
        torch, kp, arrays9, k6["small"])
    k9 = _phase9_shard(torch, kp, arrays9, k6["small"], card=smi[0])

    # ---- 10. the server on a device mesh (B10-B13); C1 and C2 ----
    t0 = time.perf_counter()
    progs = [st.compile_tg(j, j.task_groups[0], n_place, plan)[0]
             for st, j, n_place, plan, _rows in (cases[c] for c in CHAIN_MIX)]
    stacked, m10 = stack_params(progs)
    ibuf, fbuf, ubuf, spec10 = kp.pack_params(stacked)
    bufs10 = [tensor_from_numpy(b, torch.device("cuda"))
              for b in (ibuf, fbuf, ubuf)]
    st_aff, j_aff = cases["affinity"][0], cases["affinity"][1]
    (p_aff,), m_aff = pad_params([st_aff.compile_tg(j_aff, j_aff.task_groups[0],
                                                    10)[0]])
    sysj = synth_system_job(rng)
    (p_sys,), _m = pad_params([binpack.compile_tg(sysj, sysj.task_groups[0],
                                                  1)[0]])
    routes = _phase10_routes(
        torch, kp, ks, binpack.device_arrays(),
        (bufs10, spec10, m10, params_from_numpy(stacked, "cuda")),
        (params_from_numpy(p_aff, "cuda"), m_aff),
        params_from_numpy(p_sys, "cuda"), card=smi[0], sys_np=p_sys)
    view13, view_err = _phase10_view(torch, kr, cl, nodes, rng)
    counts10, server10, calls10 = _phase10_server(torch, kp, ks, kr)
    _phase10_limits(torch, kp, ks)
    many_err = _phase10_many_shards(
        torch, kp, ks, binpack.device_arrays(),
        params_from_numpy(p_sys, "cuda"), p_sys, card=smi[0])
    print(f"phase 10 took {time.perf_counter() - t0:.1f} s")

    print(json.dumps({"kernels": [{
        "name": "place_task_group",
        "route": "cuda",
        "source": "nomad_tpu_torch/kernels/csrc/lanes.cu",
        "replaces": "nomad_tpu/kernels/placement.py:345",
        "launches": k1_launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "span_ms": k1["lane"]["span"],
        "explain_off_ms": k1_off["lane"]["events"],
        "clusters": k1["lane"]["route"][1],
        "kernel_launches_per_program": k1["lane"]["launches"],
        "peak_mib": k1["lane"]["peak"],
        "placement_cu_ms": k1["placement.cu"]["events"],
        "placement_cu_span_ms": k1["placement.cu"]["span"],
        "placement_cu_explain_off_ms": k1_off["placement.cu"]["events"],
        "placement_cu_peak_mib": k1["placement.cu"]["peak"],
        "placement_cu_bound_ms": old_bound,
    }, {
        "name": "place_table_chain",
        "route": "cuda",
        "source": "nomad_tpu_torch/kernels/csrc/lanes.cu",
        "replaces": "nomad_tpu/kernels/placement.py:754",
        "calls": server["launches"]["chain"],
        "launches": server["kernels"]["chain"],
        "max_abs_err": max(k5["err"]["chain"], server["err"]["chain"]),
        **k5["chain"],
    }, {
        "name": "place_table_wave",
        "route": "cuda",
        "source": "nomad_tpu_torch/kernels/csrc/lanes.cu",
        "replaces": "nomad_tpu/kernels/placement.py:878",
        "calls": server["launches"]["wave"],
        "launches": server["kernels"]["wave"],
        "max_abs_err": max(k5["err"]["wave"], server["err"]["wave"]),
        **k5["wave"],
    }, {
        "name": "program_table_insert",
        "route": "cuda",
        "source": "nomad_tpu_torch/kernels/csrc/rows.cu",
        "replaces": "nomad_tpu/server/program_table.py:99",
        "launches": server["launches"]["insert"],
        "max_abs_err": k5["err"]["insert"],
        **k5["insert"],
    }, {
        "name": "view_row_delta",
        "route": "cuda",
        "source": "nomad_tpu_torch/kernels/csrc/rows.cu",
        "replaces": "nomad_tpu/scheduler/stack.py:115",
        "launches": server["launches"]["k7"],
        "max_abs_err": slice_["k7_err"],
        **slice_["k7"],
    }, {
        "name": "system_feasibility",
        "route": "cuda",
        "source": "nomad_tpu_torch/kernels/csrc/system.cu",
        "replaces": "nomad_tpu/kernels/placement.py:957",
        "launches": sys8["k2_launches_c"] + served["k2_launches_d"],
        "max_abs_err": sys8["k2_err"],
        **sys8["k2"],
    }, {
        "name": "preempt_rank",
        "route": "cuda",
        "source": "nomad_tpu_torch/kernels/csrc/preempt.cu",
        "replaces": "nomad_tpu/kernels/preemption.py:62",
        "launches": served["k3_launches_d"],
        "max_abs_err": sys8["k3_err"],
        **sys8["k3"],
    }, {
        "name": "place_packed_batch_onchip",
        "route": "cuda",
        "source": "nomad_tpu_torch/kernels/csrc/batch.cu",
        "replaces": "nomad_tpu/kernels/placement.py:744",
        "launches": k6_launches,
        "max_abs_err": max(k6["err"], bench_err),
        **k6["k6"],
    }, {
        "name": "place_packed_batch",
        "route": "cuda",
        "source": "nomad_tpu_torch/kernels/csrc/chain.cu",
        "replaces": "nomad_tpu/kernels/placement.py:744",
        "launches": k6_pooled,
        "max_abs_err": max(k6["err"], oversized_err),
        **pooled_nums,
    }, {
        "name": "scheduler_step",
        "route": "cuda",
        "source": "nomad_tpu_torch/kernels/csrc/lanes.cu",
        "replaces": "nomad_tpu/parallel/mesh.py:287",
        "calls": k9["calls"],
        "launches": k9["launches"],
        "max_abs_err": k9["err"],
        **k9[(1, 4)],
        "mesh_2x2_ms": k9[(2, 2)]["ms"],
        "mesh_2x2_steps_ms": k9[(2, 2)].get("steps_ms"),
    }, {
        "name": "place_packed_chain_sharded",
        "route": "cuda",
        "calls": calls10["chain"],
        "source": "nomad_tpu_torch/kernels/csrc/shard.cu",
        "replaces": "nomad_tpu/kernels/placement.py:802",
        "launches": counts10["chain"],
        "max_abs_err": max(routes["err"]["chain"], server10["chain"]),
        **routes[MESH_SHAPES[0]]["chain"],
    }, {
        "name": "place_task_group_sharded",
        "route": "cuda",
        "calls": calls10["single"],
        "source": "nomad_tpu_torch/kernels/csrc/shard.cu",
        "replaces": "nomad_tpu/kernels/placement.py:345",
        "launches": counts10["single"],
        "max_abs_err": max(routes["err"]["single"], server10["single"]),
        **routes[MESH_SHAPES[0]]["single"],
    }, {
        "name": "system_feasibility_sharded",
        "route": "cuda",
        "calls": calls10["system"],
        "source": "nomad_tpu_torch/kernels/csrc/system.cu",
        "replaces": "nomad_tpu/kernels/placement.py:957",
        "launches": counts10["system"],
        "max_abs_err": max(routes["err"]["system"], many_err),
        **routes[MESH_SHAPES[0]]["system"],
        "mesh_2x2_ms": routes[(2, 2)]["system"]["ms"],
        "mesh_2x2_shards_ms": routes[(2, 2)]["system"].get("shards_ms"),
        "mesh_1x8_ms": routes[(1, 8)]["system"]["ms"],
        "mesh_1x8_shards_ms": routes[(1, 8)]["system"].get("shards_ms"),
    }, {
        "name": "view_row_delta_sharded",
        "route": "cuda",
        "calls": calls10["view"],
        "source": "nomad_tpu_torch/kernels/csrc/rows.cu",
        "replaces": "nomad_tpu/scheduler/stack.py:115",
        "launches": counts10["view"],
        "max_abs_err": view_err,
        **view13,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
