#!/usr/bin/env python3
"""Drive the PyTorch port (`nomad_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any mismatch or error raises and the script exits
non-zero without printing a result:

1. The card: `torch.cuda.get_device_name()` and nvidia-smi's name and power
   limit.
2. Build the CUDA kernels from `nomad_tpu_torch/kernels/csrc` (one nvcc
   per source, all at once, into `build/`: placement, chain, rows,
   system, preempt, shard), and print the build seconds.
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
5. The chain, wave and row-scatter kernels against their plain versions at
   full width (N = 16384): a chain of B = 8 programs of the phase-3 mix
   through the device program table, explain on and off; a wave of L = 3
   datacenter-pinned lanes of P = 4 programs, and a built stale-footprint
   wave whose lanes overlap (collisions > 0, equal in both); the table's
   insert into a fresh table against `index_copy_`. Times each kernel, its
   plain version and (for the insert) `index_copy_`, with each bound.
6. The server path at the server's defaults (speculative dispatch, chain
   adoption and the row-delta view on): a port `Server` (eval_batch 16)
   on the card over a second copy of the cluster, ingested as `bench.py`
   does, plus 64 running services holding a reserved and a dynamic port.
   After a warm-up, three bursts of 64 service jobs of count 10 (half
   pinned to one datacenter, so drains yield waves) are registered, one
   burst at a time; between bursts four port-holding services finish and
   one node re-registers. Every eval must complete with all 640 allocs of
   its burst placed, distinct_hosts respected and no partial plan; the
   chain, wave, insert and view row-delta (K7) kernels must have launched;
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
   re-registration, a node removal) refreshed through K7, each K7 call
   equal to its plain version on a copy of what it writes and the view
   equal to a cold upload, bitwise; K7's three parts timed against their
   plain versions and `index_copy_` at 64 hot rows, 8 port rows and 64
   port words, beside the whole-group uploads they replace; (b) three
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
   leased device view against its plain version, both masks equal, for
   `synth_system_job`'s program and a variant with plan deltas and a
   reserved plus a dynamic port ask; (b) K3 against its plain version on
   the candidate table the retry's host code builds from the filler
   allocs for a priority-100 ask one cpu above any node's free room, and
   on one of all-equal priorities with pads: indices, k, order and
   feasible equal, scores within 1e-6; K2, K3, their plain versions, the
   table build and the four-tensor upload timed; (c) BASELINE config 4:
   two `synth_system_job` evals through the port's `Harness`, with
   `bench.py` `bench_system`'s checks (the placed node set equals a
   scalar recomputation; every preemption-backed placement is on a
   feasible-but-full node, evicts only lower-priority allocs and fits
   afterwards); evals/s, placements/s, preemption placements, K2
   launches and the host time per eval. (d) runs on phase 6's server
   after its bursts (so it prints before phase 7): a system job's eval
   completes through the worker's system route (K2 launched, no nack);
   then, with service preemption on, a priority-100 service job whose ask
   fits no node without eviction is placed by evicting lower-priority
   allocs (K3 launched), its plan applied, `carry_exact` False, the node
   fitting afterwards.
9. The batched-eval path (K6) and the node-sharded step (K9): (a) on the
   phase-3 cluster, `place_task_group_batch` against its plain version
   for B = 64 programs of `bench.py`'s eval mix (count 8), explain off and
   on, and for one dispatch at B = 4096, bench's default batch: indices
   and counts equal, scores within 1e-6; K6, its plain version and its
   bound timed at B = 4096. (b) `bench.py` `bench_tpu`'s single-device
   loop on the port (a host `compile_tg` per eval, `stack_params`,
   `pack_params`, one `place_packed_batch` per batch, asynchronous until
   the end): 4,096 evals in batches of 1,024 (cut from bench's 16,384 /
   4,096 to keep the smoke's time); evals/s and placed/total beside the
   card's name and power limit, then every batch's sel_idx held against
   the plain version on the inputs it read. (c) K9 on four shards in
   meshes (2, 2) and (1, 4) over the cards (all four on one card when
   there is one): `entry.dryrun_multichip(4, ...)` at its own size
   (10,000 nodes, 5,000 allocs, 64 evals of count 4), then the phase-3
   cluster with B = 64; each equal to its plain version and to K6 on the
   whole view (sel_idx and counts exactly, scores within 1e-6), the
   fold-in bitwise against plain; timed per dispatch and per step.
   K6's launches are counted around (b), K9's around the dry runs.
10. Prints the kernels line, then `{"ok": true, "device": {...}}` last.
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


def _chain_bound(kp, arrays, prep, tables, dyn, n_lanes=1):
    """Bound of one chain or wave dispatch: the view read once, every
    program's static and dynamic fields, per-step outputs, and the
    final carry written once."""
    n, r = arrays.capacity.shape
    batch = kp._assemble_table_batch(*tables, kp.host_rows(prep.rows)
                                     .reshape(-1), *(d.reshape(
                                         -1, d.shape[-1]) for d in dyn),
                                     prep.sspec, prep.dspec)
    parts = [_bound_parts(arrays, kp._program(batch, b), prep.m,
                          own_carry=False)
             for b in range(batch.n_place.shape[0])]
    return _bound_of(parts, arrays, extra_out=n * r * 4 + n * 4
                     + (4 if n_lanes > 1 else 0))


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

    # K8: a fresh table's insert, then the same scatter against index_copy_
    before = kr.launch_count()
    prep, tables, dyn = _table_transport(torch, progs, "cuda")
    if kr.launch_count() != before + 3:
        raise AssertionError("the table insert did not launch the kernel")
    idx = torch.as_tensor(kp.host_rows(prep.rows)[:len(mix)],
                          dtype=torch.int32, device="cuda")
    srcs = [t[idx.long()].clone() for t in tables]
    for t, src in zip(tables, srcs):
        want = kr.row_scatter_plain(torch.zeros_like(t), idx, src)
        got = kr.row_scatter_cuda(torch.zeros_like(t), idx, src)
        torch.cuda.synchronize()
        if not torch.equal(want, got) or not torch.equal(got[idx.long()],
                                                         src):
            raise AssertionError(f"row scatter differs ({t.dtype})")
    dsts = [torch.zeros_like(t) for t in tables]
    idx64 = idx.long()

    def insert_kernel():
        for d, src in zip(dsts, srcs):
            kr.row_scatter_cuda(d, idx, src)

    def insert_plain():
        for d, src in zip(dsts, srcs):
            kr.row_scatter_plain(d, idx, src)

    def insert_library():
        for d, src in zip(dsts, srcs):
            d.index_copy_(0, idx64, src)

    ins_bytes = sum(2 * s_.numel() * s_.element_size() for s_ in srcs) \
        + 3 * idx.numel() * 4
    out["insert"] = dict(
        ms=_time_ms(insert_kernel, 200), plain_ms=_time_ms(insert_plain, 200),
        bound_ms=ins_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=_time_ms(insert_library, 200))
    print(f"insert (8 rows into the i32/f32/u8 tables, row bytes "
          f"{[t.shape[1] * t.element_size() for t in tables]}): kernel "
          f"{out['insert']['ms']:.4f} ms, plain {out['insert']['plain_ms']:.4f}"
          f" ms, index_copy_ {out['insert']['library_ms']:.4f} ms, bound "
          f"{out['insert']['bound_ms']:.6f} ms (bytes)")

    # K4: the chain of the 8 programs, explain off and on
    args = (arrays, *tables, prep.rows, *dyn, prep.sspec, prep.dspec, prep.m)
    for explain in (False, True):
        got = kp.place_table_chain_cuda(*args, explain=explain)
        want = kp.place_table_chain_plain(*args, explain=explain)
        torch.cuda.synchronize()
        out["err"]["chain"] = max(out["err"]["chain"], _compare_flat(
            want, got, f"chain/explain={explain}", explain))
    placed = int((got[0][0][:len(mix)] >= 0).sum())
    ms_off = _time_ms(lambda: kp.place_table_chain_cuda(*args), 20)
    ms_on = _time_ms(lambda: kp.place_table_chain_cuda(*args, explain=True),
                     20)
    plain_on = _time_ms(
        lambda: kp.place_table_chain_plain(*args, explain=True), 2)
    bound_ms, bound_by = _chain_bound(kp, arrays, prep, tables, dyn)
    out["chain"] = dict(ms=ms_on, plain_ms=plain_on, bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=None)
    print(f"chain==plain B={len(mix)} M={prep.m} placed(step 0)={placed}: "
          f"kernel {ms_on:.4f} ms (explain off {ms_off:.4f} ms), plain "
          f"{plain_on:.4f} ms, bound {bound_ms:.6f} ms ({bound_by})")

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
    for explain in (False, True):
        got = kp.place_table_wave_cuda(*wargs, explain=explain)
        want = kp.place_table_wave_plain(*wargs, explain=explain)
        torch.cuda.synchronize()
        out["err"]["wave"] = max(out["err"]["wave"], _compare_flat(
            want, got, f"wave/explain={explain}", explain))
        if int(got[0][-1]) != 0:
            raise AssertionError("disjoint lanes reported collisions")
    chain = kp.place_table_chain_cuda(arrays, *tables, prep.rows, *dyn,
                                      prep.sspec, prep.dspec, prep.m, True)
    for a, b in list(zip(chain[0], got[0][:-1])) + list(zip(chain[1],
                                                             got[1])):
        if not torch.equal(a, b):
            raise AssertionError("disjoint wave differs from the chain")
    w_ms = _time_ms(lambda: kp.place_table_wave_cuda(*wargs, explain=True),
                    20)
    w_plain = _time_ms(
        lambda: kp.place_table_wave_plain(*wargs, explain=True), 2)
    c_ms = _time_ms(lambda: kp.place_table_chain_cuda(
        arrays, *tables, prep.rows, *dyn, prep.sspec, prep.dspec, prep.m,
        True), 20)
    bound_ms, bound_by = _chain_bound(kp, arrays, prep, tables, dyn, lanes)
    out["wave"] = dict(ms=w_ms, plain_ms=w_plain, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=None)
    print(f"wave==plain L={lanes} P={per_lane} M={prep.m}, disjoint lanes "
          f"== chain of the same 12 programs: wave {w_ms:.4f} ms, chain "
          f"{c_ms:.4f} ms, plain wave {w_plain:.4f} ms, bound "
          f"{bound_ms:.6f} ms ({bound_by})")

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
    want = kp.place_table_wave_plain(*sargs, explain=True)
    torch.cuda.synchronize()
    out["err"]["wave"] = max(out["err"]["wave"], _compare_flat(
        want, got, "stale wave", True))
    coll = int(got[0][-1])
    if coll <= 0 or coll != int(want[0][-1]):
        raise AssertionError(f"stale wave collisions {coll} vs "
                             f"{int(want[0][-1])}")
    print(f"stale-footprint wave: {coll} collision rows, equal to plain")
    out["max_err"] = max(out["err"].values())
    return out


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
    from nomad_tpu_torch.synth import (synth_alloc, synth_node,
                                       synth_service_job)

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
        nodes = []
        for i in range(N_NODES):
            node = synth_node(srng, i)
            nodes.append(node)
            s.state.upsert_node(node)
        filler = [synth_service_job(srng)
                  for _ in range(max(N_ALLOCS // 200, 1))]
        for j in filler:
            s.state.upsert_job(j)
        for i in range(N_ALLOCS):
            s.state.upsert_alloc(synth_alloc(
                srng, nodes[srng.randrange(N_NODES)],
                filler[i % len(filler)]))
        # running services holding a reserved and a dynamic port: the
        # client stops a few between bursts (below)
        holders = []
        for k in range(64):
            node = nodes[srng.randrange(N_NODES)]
            a = _port_alloc(node.id, filler[0].id, (100, 64, 10),
                            [_ports_net(node, 8080, 20000 + k)])
            a.job = filler[0]
            s.state.upsert_alloc(a)
            holders.append(a)
        cl = s.state.cluster
        print(f"server: ingested {N_NODES} nodes / {N_ALLOCS + 64} allocs in "
              f"{time.perf_counter() - t0:.1f} s")

        def feed(n):
            # the bench.py e2e mix: half the jobs pinned to one
            # datacenter. The pinned half registers first: a drain of
            # pinned jobs partitions into disjoint conflict groups and
            # dispatches a wave, while an unpinned job's footprint is
            # every node and merges its whole drain into one chain.
            order = sorted(range(n), key=lambda i: i % 2 == 0)
            jobs = [synth_service_job(
                srng, count=10, with_affinity=i % 2 == 0,
                with_spread=i % 3 == 0, distinct_hosts=i % 5 == 0,
                with_devices=i % 4 == 0,
                datacenter=f"dc{1 + (i // 2) % 3}" if i % 2 == 1 else None)
                for i in order]
            return jobs, [i % 5 == 0 for i in order]

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
        k7 = dict.fromkeys(kr.DELTA_PARTS, 0)
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
                _server_burst(s, feed, run, gc_pauses, burst)
                for part, n in kr.delta_launch_counts().items():
                    k7[part] += n - k7_0[part]
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
        launches = {"chain": kp.chain_launch_count(),
                    "wave": kp.wave_launch_count(),
                    "insert": kr.launch_count(),
                    "single": kp.launch_count(),
                    "k7": sum(k7.values()), "k7_parts": k7}
        out["launches"] = launches
        for k in ("chain", "wave", "insert", "k7"):
            if launches[k] == 0:
                raise AssertionError(f"the {k} kernel never launched on the "
                                     f"server path: {launches}")
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
    """(a) Rounds of randomized churn refreshed through K7, each part
    held against its plain version on the same inputs (a clone of the
    tensors it writes), and the view against a cold upload."""
    from nomad_tpu_torch.scheduler import stack as stack_mod
    from nomad_tpu_torch.scheduler.stack import TorchStack

    stack = TorchStack(cl, device=device)
    _cold_equal(torch, stack.device_arrays(), cl, "before the churn")
    calls = dict.fromkeys(kr.DELTA_PARTS, 0)
    n_dst = {"hot_rows": 3, "port_rows": 1, "port_words": 1}
    real = {p: getattr(stack_mod, f"{p}_update") for p in kr.DELTA_PARTS}
    plain = {p: getattr(kr, f"{p}_update_plain") for p in kr.DELTA_PARTS}

    def checked(part):
        def run(*args):
            k = n_dst[part]
            want = [t.clone() for t in args[:k]]
            plain[part](*want, *args[k:])
            real[part](*args)
            for a, b in zip(want, args[:k]):
                if not torch.equal(a, b):
                    raise AssertionError(f"K7 {part} differs from its "
                                         "plain version")
            calls[part] += 1
            for a, b in zip(want, args[:k]):
                out["k7_err"] = max(out.get("k7_err", 0.0), float(
                    (a.double() - b.double()).abs().max()) if a.numel()
                    else 0.0)
        return run

    for part in kr.DELTA_PARTS:
        setattr(stack_mod, f"{part}_update", checked(part))
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
        for part in kr.DELTA_PARTS:
            setattr(stack_mod, f"{part}_update", real[part])
    if not all(calls.values()):
        raise AssertionError(f"a K7 part never ran in the churn: {calls}")
    out["churn_calls"] = calls
    print(f"slice (a): {CHURN_ROUNDS} churn rounds (16 placements with a "
          "reserved and a dynamic port, 8 stops, a node re-registration, "
          f"a node removal each): K7 calls {calls}, each equal to its plain "
          "version and the view equal to a cold upload, bitwise")


def _k7_timing(torch, kr, cl, out) -> None:
    """K7's three parts against their plain versions and index_copy_ at
    a hot delta of 64 rows, 8 port rows and 64 port words, on copies of
    the view; and the whole-group uploads the delta replaces."""
    import numpy as np

    from nomad_tpu_torch.convert import tensor_from_numpy
    from nomad_tpu_torch.scheduler.stack import TorchStack

    v = TorchStack(cl).device_arrays()
    dev = v.used.device
    used, ok, dyn, ports = (v.used.clone(), v.node_ok.clone(),
                            v.dyn_free.clone(), v.ports_used.clone())
    n, r = used.shape
    w = ports.shape[1]
    g = torch.Generator().manual_seed(SEED)
    pick = torch.randperm(n, generator=g)
    hidx = pick[:64].to(torch.int32).to(dev)
    pidx = pick[64:72].to(torch.int32).to(dev)
    widx = pick[72:136].to(torch.int32).to(dev)
    words = torch.randint(0, w, (64,), generator=g,
                          dtype=torch.int32).to(dev)
    uv, ov, dv = (used[hidx.long()].clone() + 1, ~ok[hidx.long()],
                  dyn[hidx.long()].clone() - 1)
    pv = ports[pidx.long()].clone() ^ 1
    wv = ports[widx.long(), words.long()].clone() ^ 1
    flat = (widx.long() * w + words.long())
    h64, p64 = hidx.long(), pidx.long()
    parts = {
        "hot_rows": (
            lambda: kr.hot_rows_update_cuda(used, ok, dyn, hidx, uv, ov, dv),
            lambda: kr.hot_rows_update_plain(used, ok, dyn, hidx, uv, ov,
                                             dv),
            lambda: (used.index_copy_(0, h64, uv), ok.index_copy_(0, h64, ov),
                     dyn.index_copy_(0, h64, dv)),
            64 * (4 + 4 * r + 1 + 4) + 64 * (4 * r + 1 + 4)),
        "port_rows": (
            lambda: kr.port_rows_update_cuda(ports, pidx, pv),
            lambda: kr.port_rows_update_plain(ports, pidx, pv),
            lambda: ports.index_copy_(0, p64, pv),
            8 * (4 + 4 * w) + 8 * 4 * w),
        "port_words": (
            lambda: kr.port_words_update_cuda(ports, widx, words, wv),
            lambda: kr.port_words_update_plain(ports, widx, words, wv),
            lambda: ports.view(-1).index_copy_(0, flat, wv),
            64 * 12 + 64 * 4),
    }
    timing = {}
    for name, (kern, pl, lib, nbytes) in parts.items():
        timing[name] = dict(ms=_time_ms(kern, 200), plain_ms=_time_ms(pl, 200),
                            library_ms=_time_ms(lib, 200),
                            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
    ports_np = np.ascontiguousarray(cl.ports_used)
    hot = (cl.used, cl.node_ok, cl.dyn_free)
    full_ports = _time_ms(lambda: tensor_from_numpy(ports_np, dev), 5)
    full_hot = _time_ms(lambda: [tensor_from_numpy(a, dev, dt) for a, dt in
                                 zip(hot, (np.float32, np.bool_,
                                           np.float32))], 5)
    out["k7"] = dict(
        ms=sum(t["ms"] for t in timing.values()),
        plain_ms=sum(t["plain_ms"] for t in timing.values()),
        bound_ms=sum(t["bound_ms"] for t in timing.values()),
        bound_by="bytes",
        library_ms=sum(t["library_ms"] for t in timing.values()))
    out["k7_parts"] = timing
    hot_nb = cl.used.size * 4 + cl.node_ok.nbytes + cl.dyn_free.nbytes
    for name, t in timing.items():
        print(f"slice K7 {name}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, index_copy_ {t['library_ms']:.4f} ms,"
              f" bound {t['bound_ms']:.7f} ms (bytes)")
    print(f"slice K7 refresh (64 hot rows, 8 port rows, 64 port words): "
          f"kernels {out['k7']['ms']:.4f} ms against the whole-group "
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


def _k3_bound(torch, kpre, arrays, p, cand, order):
    """K3 reads every row's priorities (the rank sort), the usage rows its
    walk reaches, capacity, used, node_ok, the referenced attribute
    columns; writes order, feasible, scores and the three scalars. Its
    operations: A² rank compares a row, R per walked slot."""
    n, a = cand.prio.shape
    r = arrays.capacity.shape[1]
    walked = _k3_walk(torch, kpre, arrays, p, cand, order)
    cols = p.key_idx.shape[0] + p.dp_key_idx.shape[0]
    bytes_ = (n * a * 4 + walked * r * 4 + n * r * 4 * 2 + n
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


def _k2_against_plain(torch, kp, state, nodes, rng, out, device):
    """(a): K2 on the leased view against its plain version; timed."""
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
            want = kp.system_feasibility_plain(arrays, p)
            for name, g, w in zip(("feasible", "fits"), got, want):
                if g.dtype != torch.bool or not torch.equal(g.cpu(),
                                                            w.cpu()):
                    raise AssertionError(f"K2 {label}: {name} differs")
                out["k2_err"] = max(out.get("k2_err", 0.0), float(
                    (g.cpu().float() - w.cpu().float()).abs().max()))
            n_feas, n_fit = int(got[0].sum()), int(got[1].sum())
            if not 0 < n_fit < n_feas:
                raise AssertionError(f"K2 {label}: {n_fit} of {n_feas}")
            line = (f"phase 8 (a) K2==plain {label}: feasible {n_feas}, "
                    f"fits {n_fit}")
            if dev.type == "cuda":
                ms = _time_ms(lambda: kp.system_feasibility_cuda(arrays, p),
                              200)
                plain_ms = _time_ms(
                    lambda: kp.system_feasibility_plain(arrays, p), 50)
                bound_ms, bound_by = _k2_bound(arrays, p)
                line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                         f"bound {bound_ms:.7f} ms ({bound_by})")
                if label == "system job":
                    out["k2"] = dict(ms=ms, plain_ms=plain_ms,
                                     bound_ms=bound_ms, bound_by=bound_by,
                                     library_ms=None)
            print(line)
        finally:
            stack_mod.release_view(cl, token)


def _k3_against_plain(torch, kpre, state, rng, out, device):
    """(b): K3 on a candidate table the retry's own host code builds from
    the filler allocs, and on one of all-equal priorities with pads,
    against its plain version; K3, the plain version, the table build and
    the four-tensor upload timed."""
    import numpy as np

    from nomad_tpu_torch.convert import (candidates_from_numpy,
                                         params_from_numpy)
    from nomad_tpu_torch.device import resolve_device
    from nomad_tpu_torch.scheduler.preemption import (candidate_table,
                                                      ranked_cluster)
    from nomad_tpu_torch.scheduler.stack import TorchStack
    from nomad_tpu_torch.structs import Plan

    cl = state.cluster
    dev = resolve_device(device)
    job = _preempt_job(rng, cl)
    params, _m = TorchStack(cl, device=dev).compile_tg(
        job, job.task_groups[0], 1)
    builds, uploads = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        table = candidate_table(state, cl, job, Plan())
        builds.append(time.perf_counter() - t0)
    for _ in range(5):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        arrays = ranked_cluster(cl, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        uploads.append(time.perf_counter() - t0)
    prio, usage = table
    n, a = prio.shape
    gen = np.random.default_rng(SEED)
    equal = np.where(prio < kpre.INF_PRIO, 50.0, kpre.INF_PRIO).astype(
        np.float32)
    equal[gen.random(prio.shape) < 0.1] = kpre.INF_PRIO   # pads between
    p = params_from_numpy(params, dev)
    err = 0.0
    for label, tab in (("filler allocs", (prio, usage)),
                       ("equal priorities + pads", (equal, usage))):
        cand = candidates_from_numpy(*tab, dev)
        got = _snap(torch, kpre.preempt_rank(arrays, p, cand))
        want = kpre.preempt_rank_plain(arrays, p, cand)
        for f in ("best_row", "best_k", "order", "feasible"):
            g, w = getattr(got, f).cpu(), getattr(want, f).cpu()
            if g.shape != w.shape or not torch.equal(g, w.to(g.dtype)):
                raise AssertionError(f"K3 {label}: {f} differs")
        for f in ("scores", "best_score"):
            d = float((getattr(got, f).cpu() - getattr(want, f).cpu())
                      .abs().max())
            if not d <= TOL:
                raise AssertionError(f"K3 {label}: {f} differs by {d}")
            err = max(err, d)
        best = int(got.best_row)
        if best < 0:
            raise AssertionError(f"K3 {label}: no node admits the ask")
        line = (f"phase 8 (b) K3==plain {label}: A={a}, feasible "
                f"{int(got.feasible.sum())}, best row {best} "
                f"(cpu {float(arrays.capacity[best, 0]):.0f}), k "
                f"{int(got.best_k)}, score {float(got.best_score):.6f}")
        if dev.type == "cuda":
            ms = _time_ms(lambda: kpre.preempt_rank_cuda(arrays, p, cand),
                          200)
            plain_ms = _time_ms(
                lambda: kpre.preempt_rank_plain(arrays, p, cand), 20)
            (bound_ms, bound_by), walked = _k3_bound(
                torch, kpre, arrays, p, cand, got.order)
            line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                     f"{bound_ms:.7f} ms ({bound_by}; {walked} slots "
                     "walked)")
            if label == "filler allocs":
                out["k3"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=bound_by, library_ms=None)
        print(line)
    out["k3_err"] = err
    print(f"phase 8 (b) host: candidate table (proposed_allocs over "
          f"{len(cl.row_of)} nodes) " + " ".join(
              f"{t * 1e3:.1f}" for t in builds) + " ms; four-tensor upload "
          f"({_nbytes(*(t for t in arrays if t is not None)) / 2**20:.2f} "
          "MiB) " + " ".join(f"{t * 1e3:.3f}" for t in uploads) + " ms")


def _config4(torch, kp, kpre, state, nodes, rng, out, device):
    """(c): BASELINE config 4 through the port's Harness, with the checks
    of `bench.py` `bench_system`: the placed node set (without victims)
    equals a scalar recomputation, and every preemption-backed placement
    is on a feasible-but-full node, names only lower-priority victims and
    fits after the eviction."""
    from nomad_tpu_torch.mock import alloc_resources
    from nomad_tpu_torch.scheduler import system as system_mod
    from nomad_tpu_torch.scheduler.harness import Harness
    from nomad_tpu_torch.scheduler.oracle import driver_ok, meets_constraints
    from nomad_tpu_torch.structs import Allocation, Evaluation, allocs_fit
    from nomad_tpu_torch.synth import synth_system_job

    h = Harness(state, device=device)
    if device is None and h.device.type != "cuda":
        raise AssertionError(f"Harness default device is {h.device}")
    cuda = h.device.type == "cuda"
    walls, k2_walls, compute = [], [], []
    real_k2 = kp.system_feasibility
    real_cp = system_mod.SystemScheduler._compute_placements

    def timed_k2(*a, **kw):
        t0 = time.perf_counter()
        res = real_k2(*a, **kw)
        if cuda:
            torch.cuda.synchronize()
        k2_walls.append(time.perf_counter() - t0)
        return res

    def timed_cp(self, place):
        t0 = time.perf_counter()
        try:
            return real_cp(self, place)
        finally:
            compute.append(time.perf_counter() - t0)

    placements = preempt_placements = 0
    kp.reset_system_launch_count()
    kpre.reset_launch_count()
    kp.system_feasibility = timed_k2
    system_mod.SystemScheduler._compute_placements = timed_cp
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


def _phase8_server(torch, kp, kpre, s, rng):
    """(d): on a started Server at full width, a system job's eval
    completes through the worker's system route (K2 launched, no nack);
    then, with service preemption on, a priority-100 service job whose
    ask fits no node without eviction places by evicting lower-priority
    allocs (K3 launched), its plan applied and marked inexact for carry
    adoption, and the node fits afterwards."""
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
        t0 = time.perf_counter()
        ev = s.job_register(pj)
        got = s.wait_for_eval(ev.id, statuses=final, timeout=600.0)
        pre_s = time.perf_counter() - t0
        if got is None or got.status != "complete":
            raise AssertionError(f"preemption eval through the server: {got}")
        k3 = kpre.launch_count()
        allocs = s.state.allocs_by_job("default", pj.id)
        if (cuda and k3 < 1) or nacks or len(allocs) != 1 \
                or not allocs[0].preempted_allocations:
            raise AssertionError(f"preemption eval: K3 launches {k3}, "
                                 f"nacks {nacks}, allocs {allocs}")
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
              f"{k3}, nacks 0")
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


def _batch_bound(torch, kp, arrays, batch, m):
    """Bound of one K6 (or K9) dispatch: the view read once, every
    program's fields, and each program's outputs, its new_used and
    final_scores0 among them."""
    cpu = kp.TGParams(*(t.cpu() for t in batch))
    parts = [_bound_parts(arrays, kp._program(cpu, b), m)
             for b in range(cpu.n_place.shape[0])]
    return _bound_of(parts, arrays)


def _phase9_batch(torch, kp, state, rng, device=None):
    """(a) K6 against plain on the phase-3 cluster: B = 64 of bench's mix,
    explain off and on, and one dispatch at B = 4096; K6, its plain
    version and its bound timed at B = 4096. `device="cpu"` rehearses
    the control flow (both sides plain, nothing timed)."""
    from nomad_tpu_torch.convert import params_from_numpy
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
    ms64 = (_time_ms(lambda: kp.place_task_group_batch(arrays, p64, m), 20)
            if on_card else None)
    print(f"K6==plain B={SMALL_BATCH} M={m} (bench's mix, count "
          f"{BENCH_COUNT}), explain off and on: placed "
          f"{int((got.sel_idx >= 0).sum())}/{got.sel_idx.numel()}; one "
          f"dispatch (explain off) "
          + (f"{ms64:.4f} ms" if ms64 is not None else "not timed"))
    out["small"] = (small, m)

    big, m = stack_params(progs)
    pb = params_from_numpy(big, dev)
    got, ms = _once_ms(torch, lambda: kp.place_task_group_batch(
        arrays, pb, m), on_card)
    want, plain_ms = _once_ms(torch, lambda: kp.place_task_group_batch_plain(
        arrays, pb, m), on_card)
    out["err"] = max(out["err"], _compare(want, got,
                                                f"K6 B={K6_BATCH}"))
    del want, got
    bound_ms, bound_by = _batch_bound(torch, kp, arrays, pb, m)
    if on_card:
        ms = _time_ms(lambda: kp.place_task_group_batch(arrays, pb, m), 5)
    out["k6"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by, library_ms=None)
    print(f"K6==plain B={K6_BATCH} M={m}: kernel {ms:.4f} ms per dispatch "
          f"({ms / K6_BATCH:.6f} a program), plain {plain_ms:.1f} ms, "
          f"bound {bound_ms:.6f} ms ({bound_by}); peak device memory "
          + (f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
             if on_card else "not measured"))
    print(f"phase 9 (a) took {time.perf_counter() - t0:.1f} s")
    return stack, arrays, out


def _phase9_bench(torch, kp, state, stack, rng, card, device=None):
    """(b) `bench.py` `bench_tpu`'s single-device loop on the port: per
    eval a host `compile_tg`, then `stack_params`, `pack_params` and one
    `place_packed_batch` per batch, left asynchronous until the end.
    Every batch's sel_idx is then held against the plain version on the
    inputs it read. Returns (K6 launches in the loop, max error, line)."""
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
    launches = kp.batch_launch_count()
    if on_card and launches != len(results) + 1:
        raise AssertionError(f"{launches} K6 launches for "
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
          f"it read; {launches} K6 launches")
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


def _phase9_shard(torch, kp, arrays, small, device=None):
    """(c) K9 on four shards, meshes (2, 2) and (1, 4) over the cards
    (repeating a card when there are fewer than four): through
    `entry.dryrun_multichip(4, ...)` at its own size (the main path: the
    launch counts are read around it), then on the phase-3 cluster with
    B = 64; each against its plain version and K6, timed per dispatch
    and per step."""
    from nomad_tpu_torch import entry
    from nomad_tpu_torch.convert import params_from_numpy
    from nomad_tpu_torch.kernels import shard as ks
    from nomad_tpu_torch.parallel import (make_mesh, scheduler_step,
                                          shard_cluster)

    on_card = device is None or torch.device(device).type == "cuda"
    count = torch.cuda.device_count() if on_card else 4
    devs = ([f"cuda:{i % count}" for i in range(4)] if on_card
            else [device] * 4)
    out = {"err": 0.0, "launches": 0}
    t0 = time.perf_counter()
    for shape in K9_SHAPES:
        ks.reset_launch_count()
        run = entry.dryrun_multichip(4, devices=devs, batch=shape[0])
        launches = ks.launch_count()
        out["launches"] += launches
        if on_card and launches != 1:
            raise AssertionError(f"dry run {shape}: {launches} K9 launches")
        whole = run.cluster.full()
        want6 = kp.place_task_group_batch(
            whole, params_from_numpy(run.batch, whole.used.device),
            run.max_allocs)
        out["err"] = max(out["err"], _k9_against(
            torch, ks, run.mesh, run.cluster, run.batch, run.max_allocs,
            want6, f"dry run {shape}", on_card))
        print(f"K9 dry run {shape}: == plain == K6 on the whole view, fold "
              f"bitwise; {launches} K9 launch")
    batched, m = small
    want6 = kp.place_task_group_batch(arrays,
                                      params_from_numpy(batched,
                                                        arrays.used.device),
                                      m)
    bound_ms, bound_by = _batch_bound(
        torch, kp, arrays, params_from_numpy(batched, "cpu"), m)
    for shape in K9_SHAPES:
        mesh = make_mesh(4, batch=shape[0], devices=devs)
        sc = shard_cluster(arrays, mesh)
        out["err"] = max(out["err"], _k9_against(
            torch, ks, mesh, sc, batched, m, want6,
            f"phase-3 cluster {shape}", on_card))
        _w, plain_ms = _once_ms(torch, lambda: ks.sharded_place_plain(
            sc, batched, m, fold=True), on_card)
        step = scheduler_step(mesh, m)
        ms = (_host_ms(torch, lambda: step(sc, batched), 5) if on_card
              else None)
        out[shape] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=None)
        print(f"K9 phase-3 cluster {shape} B={SMALL_BATCH} M={m}: == plain "
              f"== K6, fold bitwise; "
              + (f"{ms:.4f} ms per dispatch, {ms / m:.4f} ms per step"
                 if ms is not None else "not timed")
              + f"; plain {plain_ms:.1f} ms; bound {bound_ms:.6f} ms "
              f"({bound_by}); shards on {sorted(set(devs))}")
    print(f"phase 9 (c) took {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; "
              "this script needs an NVIDIA card", file=sys.stderr)
        return 1

    from nomad_tpu_torch import mock
    from nomad_tpu_torch.convert import params_from_numpy
    from nomad_tpu_torch.kernels import _build
    from nomad_tpu_torch.kernels import placement as kp
    from nomad_tpu_torch.kernels import preemption as kpre
    from nomad_tpu_torch.kernels import rows as kr
    from nomad_tpu_torch.kernels import shard as ks
    from nomad_tpu_torch.parallel.pad import pad_params
    from nomad_tpu_torch.scheduler import stack as stack_mod
    from nomad_tpu_torch.scheduler.harness import Harness
    from nomad_tpu_torch.scheduler.stack import PlanContext, TorchStack
    from nomad_tpu_torch.structs import (Constraint, Evaluation,
                                         NetworkResource, Port, Spread)
    from nomad_tpu_torch.synth import (build_synthetic_state,
                                       synth_service_job)

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
    sources = ("placement", "chain", "rows", "system", "preempt", "shard")
    _build.build_all(sources)
    kp.build_kernel()
    kp.build_chain_kernel()
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
            got = kp.place_task_group_cuda(arrays, p, m, explain)
            want = kp.place_task_group_plain(arrays, p, m, explain)
            torch.cuda.synchronize()
            max_err = max(max_err, _compare(want, got, f"{name}/{explain}"))
            placed = int((got.sel_idx >= 0).sum())
        print(f"kernel==plain {name:18s} M={m:2d} placed={placed:2d} "
              f"feasible={int(got.nodes_feasible)}")
        if name == "affinity":
            timing_inputs = (arrays, p, m)
    if placed is None:
        raise AssertionError("no case ran")

    arrays, p, m = timing_inputs
    kernel_ms = _time_ms(lambda: kp.place_task_group_cuda(arrays, p, m, True),
                         30)
    plain_ms = _time_ms(lambda: kp.place_task_group_plain(arrays, p, m, True),
                        5)
    kernel_noex_ms = _time_ms(
        lambda: kp.place_task_group_cuda(arrays, p, m, False), 30)
    bound_ms, bound_by = _bound(arrays, p, m)
    print(f"timing (N={arrays.capacity.shape[0]}, M={m}, explain on): "
          f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.6f} ms ({bound_by}); kernel with explain off "
          f"{kernel_noex_ms:.4f} ms")

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
    kp.reset_launch_count()
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
    peak = torch.cuda.max_memory_allocated()

    if launches != len(calls) or launches == 0:
        raise AssertionError(f"{launches} kernel launches for "
                             f"{len(calls)} selects")
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
          f"placed, {len(calls)} selects, {launches} kernel launches")
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
    k9 = _phase9_shard(torch, kp, arrays9, k6["small"])

    print(json.dumps({"kernels": [{
        "name": "place_task_group",
        "route": "cuda",
        "source": "nomad_tpu_torch/kernels/csrc/placement.cu",
        "replaces": "nomad_tpu/kernels/placement.py:345",
        "launches": k1_launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "place_table_chain",
        "route": "cuda",
        "source": "nomad_tpu_torch/kernels/csrc/chain.cu",
        "replaces": "nomad_tpu/kernels/placement.py:754",
        "launches": server["launches"]["chain"],
        "max_abs_err": max(k5["err"]["chain"], server["err"]["chain"]),
        **k5["chain"],
    }, {
        "name": "place_table_wave",
        "route": "cuda",
        "source": "nomad_tpu_torch/kernels/csrc/chain.cu",
        "replaces": "nomad_tpu/kernels/placement.py:878",
        "launches": server["launches"]["wave"],
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
        "name": "place_task_group_batch",
        "route": "cuda",
        "source": "nomad_tpu_torch/kernels/csrc/chain.cu",
        "replaces": "nomad_tpu/kernels/placement.py:945",
        "launches": k6_launches,
        "max_abs_err": max(k6["err"], bench_err),
        **k6["k6"],
    }, {
        "name": "scheduler_step",
        "route": "cuda",
        "source": "nomad_tpu_torch/kernels/csrc/shard.cu",
        "replaces": "nomad_tpu/parallel/mesh.py:287",
        "launches": k9["launches"],
        "max_abs_err": k9["err"],
        **k9[(1, 4)],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
