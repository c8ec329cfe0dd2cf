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
   chain, two a wave — and peak memory), and the function's bound. The
   fused insert (K8) of 8
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
11. Persistence and consensus, on phase 6's path, at N_NODES nodes and
   PHASE11_ALLOCS allocs (cut from N_ALLOCS: every restore and
   fingerprint walks each alloc with its job on the host). (a) The
   durable server: the state ingested into a StateStore and written by
   `Wal.write_snapshot`, restored by `Server(ServerConfig(data_dir=...,
   fsync=True, eval_batch=16))` on the card to the source's
   `state_fingerprint`; a burst of 64 evals of the mix, journaled (WAL
   appends, bytes, plan apply's share); 16 evals written with no
   scheduler running; a restart to the fingerprint before shutdown, the
   16 requeued and placed, then 16 more, the view rebuilt by one cold
   upload and K7 deltas. (b) Three `ClusterServer`s on the card in one
   process, each restored from one Raft snapshot of the state taken by
   the port's Raft; 64 evals submitted through a follower and placed by
   the leader; three equal state and event fingerprints; the leader
   stopped hard, a new one elected, 16 evals placed by it; two equal
   fingerprints. Every window asserts phase 6's launch contract (K4 one
   launch a chain dispatch, K5 at most two a wave, K8 == inserts, K7 ==
   delta refreshes). Prints walls, evals/s, WAL and Raft numbers with
   the card's name and power limit.
12. The client and its plugins on the card's host: a port server on the
   card over N_NODES nodes and PHASE11_ALLOCS + 64 allocs, and CLIENTS
   port `Client`s in this process over `InProcConn`, one of them running
   the GPU fingerprint. In one launch window (phase 6's contract): (a)
   every client's node ready, the GPU client's carrying one
   `nvidia/gpu/<model>` group with the card's UUID and name as
   `nvidia-smi` gives them; (b) CLIENT_JOBS service jobs of CLIENT_COUNT
   mock tasks placed by the kernels and running on the clients (eval to
   running p50 and max), then stopped; (c) a batch task that asks for the
   card with a constraint on its model, placed on the GPU client with the
   card's UUID, whose `CUDA_VISIBLE_DEVICES` names exactly it; (d) exec
   tasks through the port's executor and taskinit children, held to no
   privileged isolation so that the host's cgroups and mounts stay as
   they are (the isolation applied is printed); (e) a raw_exec task
   through the port's out-of-process driver host. (f) the clients shut
   down and no child they started is left alive. Prints every part's
   wall, registration to ready and the window's counts with the card's
   name and power limit.
13. The agent, its HTTP API and the CLI: (a) an in-process port `Agent`
   on the card (its default device) with a data_dir and a node meta that
   no synthetic node has, over N_NODES nodes and PHASE11_ALLOCS + 64
   allocs ingested before it starts, driven only by `python -m
   nomad_tpu_torch -address ...` children: `job run` of CLIENT_COUNT mock
   tasks to running on the agent's node (a chain dispatch, K4), `job
   plan` of a second job (K1 through the port's Harness), `job status`,
   `alloc status`, `eval placement` (it names the agent's node),
   `operator hbm`, `operator metrics -format prometheus`, `job stop`; in
   one launch window (phase 6's contract, at least one K4 launch, one K8
   insert and one K1 program), every chain or wave launch equal to its
   plain version on the inputs it read; the threads before the agent and
   after its shutdown. (b) `python -m nomad_tpu_torch agent -dev` as a
   child at its default device: start to HTTP ready, one `job run` to a
   running alloc on its node, then SIGINT: exit 0, no child of it left.
   Prints each CLI child's wall and `job run` to running with the card's
   name and power limit. After the bursts (so lane and chain dispatches
   have run on the card) the agent's Prometheus exposition is scraped
   once more: every `site` value must be in the reference's
   `ALLOWED_SITES` and every label in `ALLOWED_LABELS`, and the lane
   dispatches' argument tables must have booked at the programs' site
   (`select_batch.pack_buffers`); the sites seen are printed.
14. The lint engine: `python -m nomad_tpu_torch.analysis --fail-on-new
   --stats` as a child must exit 0 with "findings by rule: clean"
   against `lint_baseline_torch.json`; prints its wall and CPU time.
15. The host core and the roofline: (a) the g++ build of
   `nomad_tpu_torch/native/core.cpp` (made in phase 2, beside the
   kernels; its seconds and whether it was cached) and `first_fit_ports`
   against its plain version at fills of 0, 50, 99 and 100 % of the
   dynamic port range; (b) on a synthetic state of its own (N_NODES
   nodes, N_ALLOCS allocs) the compiled select (`native.compiled_select`,
   host arrays only) against `TorchStack.select` on the card (K1) for the
   seven job variants of the reference's compiled-select test, count 10:
   the same node and scores within 1e-4 where both place, neither placing
   where one does not; its sampled mode (a seeded order) places validly
   with a mean score no higher than the exact mode's; (c) the compiled
   select's evals/s at N_NODES nodes, count 10, exact and sampled, over
   HOST_EVALS evals of `bench.py`'s mix, with the host CPU's model, the
   card's name and power limit; (d) `roofline.summarize` of every kernel
   timed above, one line each. Every bound this script prints is
   `nomad_tpu_torch.lib.roofline`'s count of the reference function
   (`kernel_cost`), one count a function whatever route ran, against the
   peaks `device_peaks` gives for the card (an unknown card raises).
16. The operator's lifecycle on the card: one port `Server` at its
   default device over N_NODES synthetic nodes and PHASE11_ALLOCS + 64
   allocs (cut from N_ALLOCS for phase 11's reason: every settle walks
   the allocs on the host) and PHASE16_NODES nodes of class
   PHASE16_CLASS that the phase's jobs are constrained to. Each step is
   one launch window (phase 6's contract) and a hard gate: (a) a service
   job of count PHASE16_COUNT and PHASE16_NEIGHBOURS jobs of count
   PHASE16_NEIGHBOUR settled running, then PHASE16_DRAIN of the first
   job's nodes drained with a deadline: every alloc on them replaced, no
   replacement on a draining node, every job back to its count running,
   the nodes drain-complete and ineligible; (b) the first job updated
   with an `update` stanza (canary 1, max_parallel 2): the canary placed,
   marked healthy through `Server.update_alloc_health`, promoted, the
   rollout successful and its version stable; then a bad version with
   `auto_revert`, its canary marked unhealthy: the deployment fails and
   the job reverts to the stable version's spec; (c) a periodic batch
   job force-launched, its child placed, run to completion, then a
   forced core GC reaps every terminal eval whose allocs are terminal
   (the child's among them) and those allocs, and nothing live; (d) the
   opt-out on the card: one burst of phase 6's mix (64 evals, queued at once)
   through two fresh servers on equal states, with `NOMAD_TPU_EXPLAIN`
   unset and `=0`: every placement's node and score bitwise equal, the
   kernel's attribution (`_attributed`) on every placement with explain
   on and on none opted out. Each
   step prints its wall and its K1, K4, K5, K7 and K8 launches with the
   card's name and power limit; every step launched a placement kernel,
   and the phase K1, K4, K7 and K8.
17. Residency and traces on the card: with a fresh process-wide
   residency ledger and the allocator's live bytes read first, one port
   `Server` at its default device (eval_batch 16) over N_NODES nodes and
   PHASE11_ALLOCS + 64 allocs (cut from N_ALLOCS for phase 11's reason;
   the planner holds per-alloc residency at 0, so the cut changes no
   device byte) takes PHASE17_BURSTS bursts of phase 6's mix (64 evals
   of count 10) in one launch window (phase 6's contract). (a) The
   ledger's live bytes must cover at least PHASE17_COVERAGE of the
   allocator's growth (`hbm.reconcile`, the reference's acceptance), the
   eight sites of PHASE17_SITES must be booked and every site must be in
   `ALLOWED_SITES`; prints each site's live and peak bytes, the growth
   and the coverage. (c) Every eval's trace complete and ordered, the
   fused ones with pack and kernel spans; every dispatch committed and
   ended on the timeline; the broker's depths back to 0 and
   `plan_apply.partial_rate` 0; prints the timeline's overlap, wasted
   and bubble ms and the K4, K5, K7 and K8 launches. (b) From (a)'s
   ledger, once the view is refreshed, `plan_capacity(PHASE17_NODES,
   ...)` projects n_cap 32768; a synthetic cluster of PHASE17_NODES nodes
   and PHASE17_ALLOCS allocs uploaded through `TorchStack` on the card
   with a fresh ledger books within PHASE17_PLAN_TOL of the prediction
   (the allocator's growth printed beside it); `plan_capacity(100000,
   1000000)` reads its limit from the card ("memory_stats") and fits.
   Prints the phase's wall with the card's name and power limit.
18. Prints the kernels line, then `{"ok": true, "device": {...}}` last.
"""
from __future__ import annotations

import collections
import concurrent.futures
import copy
import gc
import json
import os
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
#: (fp32 FLOP/s, HBM bytes/s) of the card in use, read by main() from
#: `nomad_tpu_torch.lib.roofline.device_peaks` (an unknown card raises);
#: a CPU rehearsal of a phase sets them itself
PEAKS = None


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


def _roof(cost):
    """Least time the card could take for one call of static `cost`
    (`roofline.kernel_cost`: each input read once, each output written
    once, the function's operations), and what bounds it."""
    from nomad_tpu_torch.lib import roofline

    if PEAKS is None:
        raise RuntimeError("no peaks of the card: main() reads them")
    return roofline.bound_ms(cost, PEAKS)


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


def _table_programs(kp, prep, tables, dyn):
    """The programs a table chain or wave reads, as one batch."""
    return kp._assemble_table_batch(*tables, kp.host_rows(prep.rows)
                                    .reshape(-1), *(d.reshape(
                                        -1, d.shape[-1]) for d in dyn),
                                    prep.sspec, prep.dspec)


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
    print(f"{what}: bound {bound['ms']:.6f} ms ({bound['by']}); lane "
          f"route bitwise chain.cu's at C={picked} and C=1")
    return outs["picked"], out


def _phase5_kernels(torch, kp, kr, cases, nodes, rng):
    """K4, K5 and K8 against their plain versions at full width, timed."""
    from nomad_tpu_torch.lib import roofline
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
        cost = roofline.kernel_cost(
            "place_table_wave" if lanes > 1 else "place_table_chain",
            cluster=arrays, programs=_table_programs(kp, prep, tables, dyn),
            m=prep.m, sel=sel, explain=explain, lanes=lanes)
        ms, by = _roof(cost)
        return dict(ms=ms, by=by, cost=cost,
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
                        cost=on["bound"]["cost"],
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
                       library_ms=None, cost=on["bound"]["cost"],
                       span_ms=on["picked"]["span"],
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
    from nomad_tpu_torch.lib import roofline

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
    res["cost"] = roofline.kernel_cost("table_insert", table_rows=t, rows=k,
                                       widths=(li, lf, lu))
    nbytes = int(res["cost"]["bytes_accessed"])
    res["bound_ms"], res["bound_by"] = _roof(res["cost"])
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


def _ingest(s, srng, n_allocs=None):
    """`bench.py`'s ingest into a Server's state: N_NODES synthetic nodes,
    N_ALLOCS (or `n_allocs`) running allocs of filler jobs, and 64 running
    services holding a reserved and a dynamic port. Returns (nodes, filler
    jobs, the port holders)."""
    from nomad_tpu_torch.synth import (synth_alloc, synth_node,
                                       synth_service_job)

    n_allocs = N_ALLOCS if n_allocs is None else n_allocs
    nodes = []
    for i in range(N_NODES):
        node = synth_node(srng, i)
        nodes.append(node)
        s.state.upsert_node(node)
    filler = [synth_service_job(srng) for _ in range(max(n_allocs // 200, 1))]
    for j in filler:
        s.state.upsert_job(j)
    for i in range(n_allocs):
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
        # started before the ingest: `start()` arms a TTL timer for each
        # node already in the state (heartbeat.py); nodes upserted
        # afterwards, as bench.py upserts them, arm none (their TTL of an
        # hour would never fire in this run anyway)
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
    burst. Returns the burst's evals/s and per-eval phase sums (ms)."""
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
    return {"evals_per_s": len(jobs) / span, "phases": phases,
            "evals": len(evs)}


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
    from nomad_tpu_torch.lib import roofline
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
    res["cost"] = roofline.kernel_cost("view_delta", hot_rows=64, r=r,
                                       port_rows=8, port_words=64,
                                       words_per_row=w)
    nbytes = int(res["cost"]["bytes_accessed"])
    res["bound_ms"], res["bound_by"] = _roof(res["cost"])
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
    from nomad_tpu_torch.lib import roofline
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
                cost = roofline.kernel_cost("system_feasibility",
                                            cluster=arrays, program=p)
                bound_ms, bound_by = _roof(cost)
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
                                     library_ms=None, cost=cost,
                                     old_pass_ms=ev["old"],
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
    from nomad_tpu_torch.lib import roofline
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
            cost = roofline.kernel_cost("preempt_rank", cluster=arrays,
                                        program=p, candidates=cand,
                                        order=got.order)
            walked = cost["slots_walked"]
            bound_ms, bound_by = _roof(cost)
            cbound_ms, cbound_by = _roof(roofline.kernel_cost(
                "preempt_rank", cluster=arrays, program=p, candidates=cand,
                order=got.order, entries=int(compact.offsets[-1])))
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
                    bound_by=bound_by, library_ms=None, cost=cost,
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
    from nomad_tpu_torch.lib import roofline
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
            cost = roofline.kernel_cost("place_packed_batch", cluster=arrays,
                                        programs=pb, m=m)
            bound_ms, bound_by = _roof(cost)
            del want, got
        del full
    if on_card:
        rs = routes[K6_BATCH]
        # ms: back-to-back CUDA events, as every kernel is timed; beside
        # it the device span and, on the same inputs, the pooled route
        out["k6"] = dict(ms=rs["onchip"]["events"], plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=None, cost=cost,
                         span_ms=rs["onchip"]["span"],
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
          f"plain; bound {bound_ms:.6f} ms ({bound_by}; "
          f"place_packed_batch's count, whichever route); plain "
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
    from nomad_tpu_torch.lib import roofline

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
        cost = roofline.kernel_cost("place_packed_batch", cluster=view,
                                    programs=params_from_numpy(batch, "cpu"),
                                    m=m)
        bound_ms, bound_by = _roof(cost)
        nums = dict(ms=_time_ms(lambda: kp.place_packed_batch(
            view, *bufs, spec, m), K6_REPS), plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            cost=cost)
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
    from nomad_tpu_torch.lib import roofline
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
    # K9's selections equal K6's on the whole view (held below)
    cost = roofline.kernel_cost("scheduler_step", cluster=arrays,
                                programs=params_from_numpy(batched, "cpu"),
                                m=m, sel=want6.sel_idx)
    bound_ms, bound_by = _roof(cost)
    for shape in K9_SHAPES:
        mesh = make_mesh(4, batch=shape[0], devices=devs)
        sc = shard_cluster(arrays, mesh)
        out["err"] = max(out["err"], _k9_against(
            torch, ks, mesh, sc, batched, m, want6,
            f"phase-3 cluster {shape}", on_card))
        _w, plain_ms = _once_ms(torch, lambda: ks.sharded_place_plain(
            sc, batched, m, fold=True), on_card)
        nums = dict(ms=None, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=None, cost=cost)
        if on_card and count == 1:
            _got, rs = _k9_routes(torch, kp, ks, sc, batched, m,
                                  f"B={SMALL_BATCH} {shape}", card)
            c, st = rs["cluster"], rs["steps"]
            nums.update(
                ms=c["host"], span_ms=c["span"], host_calls=c["calls"],
                kernel_launches=c["launches"], peak_mib=c["peak"],
                steps_ms=st["host"], steps_span_ms=st["span"],
                steps_host_calls=st["calls"],
                steps_kernel_launches=st["launches"],
                steps_peak_mib=st["peak"])
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
              f"({nums['bound_by']}); shards on {sorted(set(devs))}")
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
    from nomad_tpu_torch.lib import roofline
    from nomad_tpu_torch.parallel import shard_cluster

    on_card = device is None or torch.device(device).type == "cuda"
    bufs, spec, m, stacked = chain
    p1, m1 = single
    out = {"err": dict.fromkeys(("chain", "single", "system"), 0.0)}
    # one count a function, whichever route or view: B10 is K4's, B11
    # K1's, B12 K2's, from the whole view's shapes and the selections
    # (equal to the unsharded kernel's, held below)
    costs = {"system": roofline.kernel_cost("system_feasibility",
                                            cluster=arrays, program=sysp)}
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
            if explain and "chain" not in costs:
                costs["chain"] = roofline.kernel_cost(
                    "place_packed_chain", cluster=arrays, programs=stacked,
                    m=m, sel=k4[0], explain=True)
            for want, what in ((plain, "plain"), (k4, "K4")):
                out["err"]["chain"] = max(out["err"]["chain"], _compare_flat(
                    (want, ()), (got, ()), f"B10 {shape} vs {what}",
                    explain))
        got = kp.place_task_group(sc, p1, m1, explain=True)
        calls["single"] = ks.host_calls()
        plain = ks.sharded_task_group_plain(sc, p1, m1, True)
        k1 = kp.place_task_group(arrays, p1, m1, True)
        costs.setdefault("single", roofline.kernel_cost(
            "place_task_group", cluster=arrays, program=p1, m=m1,
            sel=k1.sel_idx, explain=True))
        for want, what in ((plain, "plain"), (k1, "K1")):
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
            bound_ms, bound_by = _roof(costs[route])
            times = (_route_times(torch, ks, route, two[route], on_card)
                     if route in two and layout == "cluster" else {})
            entry = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None,
                         cost=costs[route])
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
    from nomad_tpu_torch.lib import roofline
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
        # K7's count: 64 hot rows, once in each copy of its shard
        cost = roofline.kernel_cost(
            "view_delta", hot_rows=64 * (n_copies // len(sc.row0)),
            r=cl.used.shape[1])
        bound_ms, bound_by = _roof(cost)
        out = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=None, cost=cost)
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


# ---- phase 11: persistence and consensus (the durable server, a region) ----

#: allocs of phase 11's states at N_NODES nodes: cut from N_ALLOCS, since
#: each restore and each `state_fingerprint` walks every alloc with its
#: embedded job on the host (the phase prints each wall)
PHASE11_ALLOCS = 10_000
#: evals registered with no scheduler running before the restart (a)
PARKED_EVALS = 16
#: evals the region's new leader schedules after the failover (b)
FAILOVER_EVALS = 16
#: the region's Raft election timeout range (s): hashicorp/raft's
#: defaults (1 s, randomized up to 2 s) at Nomad's `raft_multiplier` 5.
#: The three servers share one interpreter here: in a burst a sleeping
#: thread waited up to 2.7 s past its wake-up on the card's host (the
#: phase prints it), past the port's own 0.15-0.3 s and hashicorp's
#: 1-2 s, and the region flapped
REGION_ELECTION_TIMEOUT = (5.0, 10.0)


def _scratch_dir(prefix: str) -> str:
    """A fresh directory under the checkout's `build/` (ignored by git)."""
    import os
    import tempfile

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    return tempfile.mkdtemp(prefix=prefix, dir=root)


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


class _LaunchWindow:
    """The launch counts of one stretch of a server's path: every count
    set to 0 at the start, read at the end. On the card the phase-6
    contract holds in the window: one K4 launch a chain dispatch, at most
    two a K5 wave, all on the lane route, K8 launches == program-table
    inserts, K7 launches == view refreshes that applied a row delta."""

    def __init__(self, kp, kr):
        from nomad_tpu_torch.lib.metrics import default_registry
        from nomad_tpu_torch.lib.transfer import default_ledger

        self.kp, self.kr = kp, kr
        self._registry, self._ledger = default_registry, default_ledger
        kp.reset_launch_count()
        kp.reset_chain_launch_counts()
        kr.reset_launch_count()
        kr.reset_delta_launch_counts()
        self._inserts0 = self._inserts()
        self._view0 = default_registry().counters(prefix="view.")

    def _inserts(self) -> int:
        # the ledger site books 4 arrays an insert
        return self._ledger().snapshot().get(
            "select_batch.table_insert", {}).get("count", 0)

    def close(self, what: str, on_card: bool) -> dict:
        kp, kr = self.kp, self.kr
        view = self._registry().counters(prefix="view.")
        views = {k: view.get(k, 0) - self._view0.get(k, 0)
                 for k in ("full_uploads", "delta_uploads")}
        out = {"chain": kp.chain_launch_count(),
               "wave": kp.wave_launch_count(),
               "insert": kr.launch_count(),
               "k7": kr.delta_launch_counts(),
               "inserts": (self._inserts() - self._inserts0) // 4,
               "kernels": kp.chain_kernel_launches(),
               "routes": kp.chain_route_counts(), **views}
        if on_card:
            kernels, routes = out["kernels"], out["routes"]
            if (routes["lanes"] != 0 or kernels["chain"] != out["chain"]
                    or kernels["wave"] > 2 * out["wave"]):
                raise AssertionError(
                    f"{what}: chain/wave dispatches {out['chain']}/"
                    f"{out['wave']} took {kernels} kernel launches, routes "
                    f"{routes}: not one a chain and at most two a wave on "
                    "the lane route")
            if (out["insert"] != out["inserts"]
                    or out["k7"] != out["delta_uploads"]):
                raise AssertionError(
                    f"{what}: {out['insert']} K8 launches for "
                    f"{out['inserts']} inserts, {out['k7']} K7 launches for "
                    f"{out['delta_uploads']} refreshes with a delta")
        print(f"{what}: K4 {out['chain']} chain dispatches in "
              f"{out['kernels']['chain']} kernel launches, K5 {out['wave']} "
              f"waves in {out['kernels']['wave']}, K8 {out['insert']} "
              f"launches for {out['inserts']} inserts, K7 {out['k7']} "
              f"launches for {out['delta_uploads']} delta refreshes; "
              f"{out['full_uploads']} cold view uploads")
        return out


def _sum_launches(windows) -> dict:
    """Dispatches and launches over windows; `*_kernels` are K4's and
    K5's kernel launches."""
    out = {k: sum(w[k] for w in windows)
           for k in ("chain", "wave", "insert", "k7")}
    for k in ("chain", "wave"):
        out[f"{k}_kernels"] = sum(w["kernels"][k] for w in windows)
    return out


def _share(phases: dict, name: str) -> float:
    total = sum(phases.values())
    return phases.get(name, 0.0) / total if total else 0.0


def _wait_evals(s, evs, timeout=600.0):
    done = []
    for ev in evs:
        got = s.wait_for_eval(ev.id, statuses=(
            "complete", "failed", "blocked", "cancelled"), timeout=timeout)
        if got is None or got.status != "complete":
            raise AssertionError(f"eval {ev.id}: {got}")
        done.append(got)
    return done


def _placed(s, jobs, dh, what: str) -> int:
    placed = 0
    for j, want_dh in zip(jobs, dh):
        allocs = s.state.allocs_by_job("default", j.id)
        placed += len(allocs)
        if len(allocs) != 10:
            raise AssertionError(f"{what}: job {j.id}: {len(allocs)}/10 "
                                 "placed")
        if want_dh and len({a.node_id for a in allocs}) != 10:
            raise AssertionError(f"{what}: job {j.id}: distinct_hosts "
                                 "violated")
    return placed


def _phase11_durable(torch, kp, kr, device=None, card=""):
    """(a) The durable server: a state of N_NODES nodes and PHASE11_ALLOCS
    allocs, ingested into a plain StateStore and written by the port's
    `Wal.write_snapshot`, restored by `Server(ServerConfig(data_dir=...,
    fsync=True, eval_batch=16))` on the card to the source's fingerprint;
    a burst of 64 evals of phase 6's mix, journaled; PARKED_EVALS evals
    registered with no scheduler running; a restart to the same
    fingerprint, the parked evals requeued and placed, the view rebuilt
    with one cold upload and K7 deltas after it."""
    import shutil
    import types

    from nomad_tpu_torch.server import Server, ServerConfig
    from nomad_tpu_torch.server.fsm import snapshot_state, state_fingerprint
    from nomad_tpu_torch.server.state import StateStore
    from nomad_tpu_torch.server.wal import Wal
    from nomad_tpu_torch.structs import Evaluation

    t_phase = time.perf_counter()
    on_card = device is None or torch.device(device).type == "cuda"
    srng = random.Random(SEED + 11)
    d = _scratch_dir("durable-")
    out = {"windows": []}
    try:
        src = types.SimpleNamespace(state=StateStore())
        _, t_ingest = _timed(lambda: _ingest(src, srng, PHASE11_ALLOCS))
        tree, t_tree = _timed(lambda: snapshot_state(src.state))
        wal = Wal(d, fsync=True)
        _, t_write = _timed(lambda: wal.write_snapshot(tree))
        snap_bytes = wal.status()["snapshot_bytes"]
        wal.close()
        fp_src, t_fp = _timed(lambda: state_fingerprint(src.state))
        del src, tree
        print(f"phase 11 (a) durable: {N_NODES} nodes, {PHASE11_ALLOCS + 64} "
              f"allocs (cut from {N_ALLOCS}) ingested into a StateStore in "
              f"{t_ingest:.1f} s; snapshot tree {t_tree:.1f} s, written by "
              f"Wal.write_snapshot (fsync) in {t_write:.2f} s, "
              f"{snap_bytes / 2**20:.1f} MiB; source fingerprint "
              f"{t_fp:.1f} s")

        def config():
            return ServerConfig(num_schedulers=1, heartbeat_ttl=3600.0,
                                gc_interval=3600.0, eval_batch=16,
                                data_dir=d, fsync=True)

        s, t_restore = _timed(lambda: Server(config(), device=device))
        if device is None and s.device.type != "cuda":
            raise AssertionError(f"durable Server default device is "
                                 f"{s.device}")
        fp, t_fp = _timed(lambda: state_fingerprint(s.state))
        if fp != fp_src:
            raise AssertionError("phase 11 (a): the restored state's "
                                 "fingerprint differs from the source's")
        _, t_start = _timed(s.start)
        print(f"phase 11 (a) restore: Server(data_dir, fsync) from "
              f"snapshot.mp in {t_restore:.1f} s (wall), fingerprint == "
              f"source's ({t_fp:.1f} s); start {t_start:.1f} s")
        try:
            def feed(n):
                return _mix(srng, n)

            def run(jobs):
                evs = [s.job_register(j) for j in jobs]
                return evs, _wait_evals(s, evs)

            wal0 = s.state.wal.status()
            win = _LaunchWindow(kp, kr)
            burst = _server_burst(s, feed, run, [], "11 (a)")
            out["windows"].append(win.close("phase 11 (a) burst", on_card))
            st = s.state.wal.status()
            hist = s.metrics.snapshot()["histograms"]
            fsync_ms = hist.get("wal.fsync_ms", {})
            out["evals_per_s"] = burst["evals_per_s"]
            out["plan_apply_share"] = _share(burst["phases"], "plan_apply")
            print(f"phase 11 (a) burst: {burst['evals_per_s']:.2f} evals/s; "
                  f"WAL {st['appends'] - wal0['appends']} appends, "
                  f"{st['log_bytes'] - wal0['log_bytes']} bytes "
                  f"(fsync mean {fsync_ms.get('mean', 0.0):.3f} ms), "
                  f"{st['snapshots']} rotations; plan apply "
                  f"{out['plan_apply_share']:.3f} of the per-eval phase "
                  f"time; {card}")

            parked, parked_dh = _mix(srng, PARKED_EVALS)
            evs = []
            for j in parked:
                s.state.upsert_job(j)
                ev = Evaluation(namespace="default", priority=j.priority,
                                type="service", job_id=j.id,
                                status="pending",
                                triggered_by="job-register")
                s.state.upsert_eval(ev)
                evs.append(ev)
            fp_before, t_fp = _timed(lambda: state_fingerprint(s.state))
        finally:
            s.shutdown()

        s, t_restore = _timed(lambda: Server(config(), device=device))
        try:
            fp, t_fp2 = _timed(lambda: state_fingerprint(s.state))
            if fp != fp_before:
                raise AssertionError("phase 11 (a): the restarted state's "
                                     "fingerprint differs from the one "
                                     "before shutdown")
            pending = sum(s.state.eval_by_id(e.id).status == "pending"
                          for e in evs)
            if pending != len(evs):
                raise AssertionError(f"{pending}/{len(evs)} parked evals "
                                     "pending after the restart")
            win = _LaunchWindow(kp, kr)
            _, t_start = _timed(s.start)
            _, t_requeue = _timed(lambda: _wait_evals(s, evs))
            placed = _placed(s, parked, parked_dh, "phase 11 (a) requeued")
            more, more_dh = _mix(srng, PARKED_EVALS)
            _, t_more = _timed(lambda: _wait_evals(
                s, [s.job_register(j) for j in more]))
            placed += _placed(s, more, more_dh, "phase 11 (a) after restart")
            w = win.close("phase 11 (a) restart", on_card)
            out["windows"].append(w)
            if w["full_uploads"] != 1 or (on_card and w["k7"] == 0):
                raise AssertionError(
                    f"phase 11 (a): the view after the restart took "
                    f"{w['full_uploads']} cold uploads and {w['k7']} K7 "
                    "launches (want one cold upload, then deltas)")
            print(f"phase 11 (a) restart: restore {t_restore:.1f} s (wall), "
                  f"fingerprint == before shutdown ({t_fp:.1f} s, "
                  f"{t_fp2:.1f} s); start {t_start:.1f} s; {len(evs)} parked "
                  f"evals requeued and complete in {t_requeue:.2f} s, "
                  f"{len(more)} more in {t_more:.2f} s, {placed} allocs "
                  f"placed; {w['full_uploads']} cold upload then "
                  f"{w['delta_uploads']} delta refreshes")
        finally:
            s.shutdown()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if on_card:
        total = _sum_launches(out["windows"])
        for k, n in total.items():
            if n == 0:
                raise AssertionError(f"phase 11 (a): the {k} kernel never "
                                     f"launched: {total}")
    print(f"phase 11 (a) took {time.perf_counter() - t_phase:.1f} s")
    return out


class _NoRpc:
    """A single-voter RaftNode only registers its handlers."""

    def register(self, name, fn):
        pass


def _seed_raft_snapshot(state, root: str, ids) -> int:
    """Each server's Raft `data_dir` gets the same FSM snapshot of
    `state`, taken by the port's Raft: a single-voter node whose FSM is
    the store wins its election, commits one entry (the scheduler
    configuration) and `force_snapshot`s; the file is copied into each
    directory."""
    import os
    import shutil

    from nomad_tpu_torch.raft import RaftNode
    from nomad_tpu_torch.scheduler.util import SchedulerConfiguration
    from nomad_tpu_torch.server.fsm import FSM, snapshot_state
    from nomad_tpu_torch.structs.codec import to_wire

    seed_dir = os.path.join(root, "seed")
    node = RaftNode("seed", {"seed": ("127.0.0.1", 0)}, _NoRpc(), None,
                    apply_fn=FSM(state).apply, data_dir=seed_dir,
                    snapshot_fn=lambda: snapshot_state(state))
    node.start()
    try:
        deadline = time.time() + 30.0
        while not node.is_leader():
            if time.time() > deadline:
                raise AssertionError("the seed Raft node never led")
            time.sleep(0.01)
        node.apply({"op": "set_scheduler_config",
                    "args": [to_wire(SchedulerConfiguration())]})
        index = node.force_snapshot()
    finally:
        node.shutdown()
    for i in ids:
        os.makedirs(os.path.join(root, i))
        shutil.copyfile(os.path.join(seed_dir, "raft_snap.mp"),
                        os.path.join(root, i, "raft_snap.mp"))
    return index


def _crash(agent) -> None:
    """A server stopped hard: no LEFT broadcast, its threads gone."""
    agent.raft.shutdown()
    agent.rpc.shutdown()
    agent.membership.stop()
    agent.autopilot.stop()
    agent.server.shutdown()
    agent.pool.close()


def _leader(agents, timeout=60.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        for a in agents:
            if a.is_leader() and a.server._running:
                return a
        time.sleep(0.02)
    raise AssertionError("no leader with its subsystems running")


class _WakeProbe:
    """The longest a sleeping Python thread waited past its 20 ms wake-up
    (the GIL and the host's other threads), over a window."""

    def __init__(self):
        self.max_gap = 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        last = time.monotonic()
        while not self._stop.wait(0.02):
            now = time.monotonic()
            self.max_gap = max(self.max_gap, now - last - 0.02)
            last = now

    def close(self) -> float:
        self._stop.set()
        self._thread.join()
        return self.max_gap


def _leaderships(agent) -> str:
    c = agent.raft.metrics.counters()
    return (f"{c.get('raft.elections', 0)} elections, "
            f"{c.get('raft.leadership_gained', 0)} gained, "
            f"{c.get('raft.leadership_lost', 0)} lost")


def _hold_still(agents, what: str) -> set:
    """Waits until every server has applied the same last index and the
    index holds still; returns {that state index}."""
    deadline = time.time() + 60.0
    while True:
        idx = {a.state.index.value for a in agents}
        applied = {a.raft.last_applied for a in agents}
        if len(idx) == 1 and len(applied) == 1:
            time.sleep(0.2)
            if ({a.state.index.value for a in agents} == idx
                    and {a.raft.last_applied for a in agents} == applied):
                return idx
        if time.time() > deadline:
            raise AssertionError(f"{what}: the servers never caught up "
                                 f"(indexes {idx}, applied {applied})")
        time.sleep(0.05)


def _region_prints(agents, what: str):
    """Once every server has applied the leader's last index and the
    index holds still, the servers' state and event fingerprints; equal,
    or the phase fails."""
    from nomad_tpu_torch.server.event_broker import events_fingerprint
    from nomad_tpu_torch.server.fsm import state_fingerprint

    for _ in range(5):
        idx = _hold_still(agents, what)
        t0 = time.perf_counter()
        prints = [(state_fingerprint(a.state),
                   events_fingerprint(a.state.event_broker.buffered()))
                  for a in agents]
        if {a.state.index.value for a in agents} == idx:
            break       # nothing was written while they were taken
    else:
        raise AssertionError(f"{what}: the region never held still")
    if len(set(prints)) != 1:
        raise AssertionError(f"{what}: the servers' fingerprints differ: "
                             f"{prints}")
    print(f"{what}: {len(agents)} servers at index {idx.pop()}, state and "
          f"event fingerprints equal ({time.perf_counter() - t0:.1f} s)")


def _counts_everywhere(agents, jobs, what: str) -> None:
    """Once the servers hold still, every server holds each job's live
    allocs at exactly its count (a placement made twice, as a new leader
    over state it had not yet applied once made one, shows here)."""
    _hold_still(agents, what)
    live = {}
    for a in agents:
        for j in jobs:
            want = sum(tg.count for tg in j.task_groups)
            got = sum(1 for x in a.state.allocs_by_job(j.namespace, j.id)
                      if not x.terminal_status())
            if got != want:
                raise AssertionError(f"{what}: {a.config.node_id} holds "
                                     f"{got} live allocs of job {j.id}, "
                                     f"its count is {want}")
            live[a.config.node_id] = live.get(a.config.node_id, 0) + got
    print(f"{what}: every server holds each of {len(jobs)} jobs at its "
          "count (" + ", ".join(f"{k} {v} live allocs"
                                for k, v in live.items()) + ")")


def _flap(agents, leader, timeout=60.0):
    """A leadership flap with no crash: a follower whose log equals the
    leader's runs an election (`raft._run_election`, as the region's CPU
    tests nudge one). If a write lands between the check and the vote,
    the vote is refused and the stepped-down leader, whose log is the
    longest, runs one and leads again; then the follower is nudged
    again. Returns (the follower, now leading; nudges)."""
    follower = next(a for a in agents if a is not leader)
    deadline = time.time() + timeout
    nudges = 0
    while time.time() < deadline:
        if not (leader.is_leader() and leader.server._running
                and follower.raft.log.last_index()
                == leader.raft.log.last_index()):
            time.sleep(0.005)
            continue
        nudges += 1
        threading.Thread(target=follower.raft._run_election,
                         daemon=True).start()
        won = time.time() + 1.5
        while time.time() < won and not follower.is_leader():
            time.sleep(0.005)
        if follower.is_leader():
            return follower, nudges
        if not leader.is_leader():
            leader.raft._run_election()
    raise AssertionError(f"no follower led within {timeout:.0f} s "
                         f"({nudges} nudges)")


def _phase11_region(torch, kp, kr, device=None, card=""):
    """(b) A three-server region on one device in one process: each
    server's Raft `data_dir` holds one snapshot of N_NODES nodes and
    PHASE11_ALLOCS allocs (`_seed_raft_snapshot`); 64 evals of phase 6's
    mix submitted through a follower, placed by the leader on the card;
    three equal state and event fingerprints; the leader stopped hard, a
    new one elected, FAILOVER_EVALS evals placed by it on the card; the
    two survivors' fingerprints equal and every job of the phase at its
    count on both; then a leadership flap with no crash while
    FAILOVER_EVALS more jobs register, and the counts again."""
    import os
    import shutil
    import types

    from nomad_tpu_torch.server.cluster import (ClusterServer,
                                                ClusterServerConfig)
    from nomad_tpu_torch.server.state import StateStore

    t_phase = time.perf_counter()
    on_card = device is None or torch.device(device).type == "cuda"
    srng = random.Random(SEED + 12)
    root = _scratch_dir("region-")
    ids = ("s0", "s1", "s2")
    out = {"windows": []}
    agents, crashed = [], []
    try:
        src = types.SimpleNamespace(state=StateStore())
        _, t_ingest = _timed(lambda: _ingest(src, srng, PHASE11_ALLOCS))
        index, t_seed = _timed(lambda: _seed_raft_snapshot(src.state, root,
                                                           ids))
        del src
        print(f"phase 11 (b) region: {N_NODES} nodes, {PHASE11_ALLOCS + 64} "
              f"allocs (cut from {N_ALLOCS}) in {t_ingest:.1f} s; one Raft "
              f"snapshot at index {index} in each of {len(ids)} data dirs "
              f"in {t_seed:.1f} s")
        peers = {}
        t0 = time.perf_counter()
        for i in ids:
            a = ClusterServer(ClusterServerConfig(
                node_id=i, num_schedulers=1, heartbeat_ttl=3600.0,
                gc_interval=3600.0, data_dir=os.path.join(root, i),
                fsync=True), device=device)
            if device is None and a.server.device.type != "cuda":
                raise AssertionError(f"ClusterServer default device is "
                                     f"{a.server.device}")
            peers[i] = a.addr
            agents.append(a)
        t_restore = time.perf_counter() - t0
        for a in agents:
            a.peers.clear()
            a.peers.update(peers)
            a.raft.peers = dict(peers)
            a.raft.election_timeout = REGION_ELECTION_TIMEOUT
            a.raft._timeout = a.raft._rand_timeout()
        for a in agents:
            if len(a.state.nodes()) != N_NODES:
                raise AssertionError(f"{a.config.node_id} restored "
                                     f"{len(a.state.nodes())} nodes")
            a.start()
        leader, t_elect = _timed(lambda: _leader(agents))
        follower = next(a for a in agents if a is not leader)
        print(f"phase 11 (b) region: {len(ids)} servers restored from the "
              f"snapshot in {t_restore:.1f} s (wall, in turn); leader "
              f"{leader.config.node_id} elected with its subsystems up in "
              f"{t_elect:.1f} s (eval_batch "
              f"{leader.server.config.eval_batch}); jobs submitted through "
              f"{follower.config.node_id}")
        s = leader.server

        phase_jobs = []

        def feed(n):
            jobs, dh = _mix(srng, n)
            phase_jobs.extend(jobs)
            return jobs, dh

        def run(jobs):
            evs = [follower.call("job_register", j) for j in jobs]
            return evs, _wait_evals(s, evs)

        commit0 = leader.raft.metrics.snapshot()["histograms"].get(
            "raft.commit_ms", {}).get("count", 0)
        lost0 = leader.raft.metrics.counters().get("raft.leadership_lost", 0)
        win = _LaunchWindow(kp, kr)
        probe = _WakeProbe()
        try:
            burst = _server_burst(s, feed, run, [], "11 (b)")
        finally:
            append = leader.raft.metrics.snapshot()["histograms"].get(
                "raft.append_ms", {})
            print(f"phase 11 (b) burst: longest thread wake-up delay "
                  f"{probe.close() * 1e3:.1f} ms; leader's AppendEntries "
                  f"RPCs mean {append.get('mean', 0.0):.2f} ms, p99 "
                  f"{append.get('p99', 0.0):.2f} ms; " + ", ".join(
                      f"{a.config.node_id} {_leaderships(a)}"
                      for a in agents))
        out["windows"].append(win.close("phase 11 (b) burst", on_card))
        if leader.raft.metrics.counters().get("raft.leadership_lost",
                                              0) != lost0:
            raise AssertionError("phase 11 (b): leadership moved during "
                                 "the burst: " + ", ".join(
                                     _leaderships(a) for a in agents))
        commit = leader.raft.metrics.snapshot()["histograms"].get(
            "raft.commit_ms", {})
        out["evals_per_s"] = burst["evals_per_s"]
        out["plan_apply_share"] = _share(burst["phases"], "plan_apply")
        print(f"phase 11 (b) burst: {burst['evals_per_s']:.2f} evals/s "
              f"through a follower; {commit.get('count', 0) - commit0} Raft "
              f"commits (mean {commit.get('mean', 0.0):.3f} ms over the "
              f"run); plan apply {out['plan_apply_share']:.3f} of the "
              f"per-eval phase time; {card}")
        _region_prints(agents, "phase 11 (b) after the burst")

        leader = _leader(agents)    # the one leading now, stopped hard
        crashed.append(leader)
        _crash(leader)
        survivors = [a for a in agents if a is not leader]
        new, t_elect = _timed(lambda: _leader(survivors))
        jobs, dh = _mix(srng, FAILOVER_EVALS)
        win = _LaunchWindow(kp, kr)
        _, t_evals = _timed(lambda: _wait_evals(
            new.server, [new.call("job_register", j) for j in jobs]))
        placed = _placed(new.server, jobs, dh, "phase 11 (b) new leader")
        w = win.close("phase 11 (b) new leader", on_card)
        out["windows"].append(w)
        if on_card and w["chain"] + w["wave"] == 0:
            raise AssertionError("phase 11 (b): the new leader placed "
                                 "without a chain or wave launch")
        out["failover_evals_per_s"] = len(jobs) / t_evals
        print(f"phase 11 (b) failover: {leader.config.node_id} stopped "
              f"hard; {new.config.node_id} leads with its subsystems up in "
              f"{t_elect:.1f} s; {len(jobs)} evals, {placed} allocs placed "
              f"on {new.server.device} in {t_evals:.2f} s "
              f"({out['failover_evals_per_s']:.2f} evals/s)")
        _region_prints(survivors, "phase 11 (b) after the failover")
        phase_jobs.extend(jobs)
        print(f"phase 11 (b) barrier: {new.config.node_id} committed its "
              f"leadership barrier in {new.last_barrier_ms:.3f} ms before "
              "its subsystems started")
        _counts_everywhere(survivors, phase_jobs,
                           "phase 11 (b) counts after the failover")

        # a nudged flap, no crash, while FAILOVER_EVALS jobs register
        via = next(a for a in survivors if a is not new)
        jobs, _dh = _mix(srng, FAILOVER_EVALS)
        phase_jobs.extend(jobs)
        evs, errors = [], []
        quarter = threading.Event()

        def register():
            try:
                for i, j in enumerate(jobs):
                    evs.append(via.call("job_register", j, timeout=60.0))
                    if i == len(jobs) // 4:
                        quarter.set()
            except Exception as e:  # noqa: BLE001 — raised below
                errors.append(e)
                quarter.set()

        t0 = time.perf_counter()
        gains0 = sum(a.raft.metrics.counters().get(
            "raft.leadership_gained", 0) for a in survivors)
        th = threading.Thread(target=register, daemon=True)
        th.start()
        quarter.wait(120.0)
        at = len(evs)
        flapped, nudges = _flap(survivors, new)
        th.join(120.0)
        if th.is_alive() or errors:
            raise AssertionError(f"phase 11 (b) flap: registration "
                                 f"{'hung' if th.is_alive() else errors}")
        now = _leader(survivors)
        _wait_evals(now.server, evs)
        t_flap = time.perf_counter() - t0
        gains = sum(a.raft.metrics.counters().get(
            "raft.leadership_gained", 0) for a in survivors) - gains0
        print(f"phase 11 (b) flap: {flapped.config.node_id} won a nudged "
              f"election ({nudges} nudges) after {at} of {len(jobs)} "
              f"registrations through {via.config.node_id}; "
              f"{now.config.node_id} leads, its barrier "
              f"{now.last_barrier_ms:.3f} ms; {gains} leadership gains; "
              f"{len(evs)} evals complete in {t_flap:.2f} s")
        _counts_everywhere(survivors, phase_jobs,
                           "phase 11 (b) counts after the flap")
        print("phase 11 (b) leadership: " + ", ".join(
            f"{a.config.node_id} {_leaderships(a)}" for a in agents)
            + f"; election timeout {REGION_ELECTION_TIMEOUT} s")
    finally:
        for a in agents:
            if a not in crashed:
                a.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    if on_card:
        total = _sum_launches(out["windows"])
        for k in ("chain", "insert", "k7"):
            if total[k] == 0:
                raise AssertionError(f"phase 11 (b): the {k} kernel never "
                                     f"launched: {total}")
    print(f"phase 11 (b) took {time.perf_counter() - t_phase:.1f} s")
    return out


#: phase 12: port clients on the card's host, in this interpreter, over
#: `InProcConn` to a port server on the card
CLIENTS = 4
#: the clients' node class, which no synthetic node has
CLIENT_CLASS = "card-host"
#: (b): service jobs of CLIENT_COUNT mock tasks each, on the clients
CLIENT_JOBS, CLIENT_COUNT = 16, 4

#: imported by the executors phase 12 starts (their PYTHONPATH is this
#: process's `sys.path`): an executor applies no cgroup, namespace or
#: chroot, so an exec task changes nothing of the host it runs on
_UNPRIVILEGED_SITE = """
from nomad_tpu_torch.plugins import isolation
_caps = isolation.capabilities
isolation.capabilities = lambda: {**_caps(), "cgroup": None,
                                  "namespaces": False, "chroot": False}
"""


def _cmdline(pid: int) -> list:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().decode("utf-8", "replace").split("\0")[:-1]
    except OSError:
        return []


def _pid_alive(pid: int) -> bool:
    """A process that exists and is not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (OSError, IndexError):
        return False


def _alive(pids: dict) -> dict:
    return {k: sorted(p for p in v if p and _pid_alive(p))
            for k, v in pids.items() if any(p and _pid_alive(p) for p in v)}


def _until(cond, timeout: float, what: str):
    """The first true value of `cond()`; AssertionError after
    `timeout`."""
    t0 = time.perf_counter()
    while True:
        v = cond()
        if v:
            return v
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"{what}: not within {timeout} s")
        time.sleep(0.005)


def _client_job(mock, kind: str, driver: str, config: dict, count=1,
                batch=True):
    """A job of one task on the clients' node class; no ports, no
    restart, no reschedule: a task's first exit is its last."""
    from nomad_tpu_torch.structs import Constraint

    job = mock.job()
    job.id = job.name = f"phase12-{kind}-{uuid.uuid4().hex[:8]}"
    if batch:
        job.type = "batch"
    job.constraints = [Constraint("${node.class}", CLIENT_CLASS, "=")]
    tg = job.task_groups[0]
    tg.count = count
    tg.networks = []
    tg.reschedule_policy = None
    tg.restart_policy.attempts = 0
    tg.restart_policy.mode = "fail"
    t = tg.tasks[0]
    t.driver, t.config = driver, config
    t.resources.networks = []
    t.resources.cpu, t.resources.memory_mb = 100, 64
    return job


def _task_log(clients, alloc, task: str, stream: str) -> str:
    for c in clients:
        runner = c.allocs.get(alloc.id)
        if runner is not None:
            path = os.path.join(runner.task_runners[task].logs_dir,
                                f"{task}.{stream}.0")
            with open(path) as f:
                return f.read()
    raise AssertionError(f"no client holds alloc {alloc.id}")


def _phase12_clients(torch, kp, kr, device=None, card=""):
    """Port clients on the card's host run the work the card's kernels
    placed. A port server on the card over N_NODES synthetic nodes and
    PHASE11_ALLOCS + 64 allocs; CLIENTS port `Client`s in this interpreter
    over `InProcConn`, each with its own data_dir and a node of
    CLIENT_CLASS; the last runs the GPU fingerprint, the others skip it,
    and the second runs raw_exec out of process. One launch window spans
    (a)-(e): (a) registration, the GPU client's node carrying the card
    as nvidia-smi names it; (b) CLIENT_JOBS service jobs of CLIENT_COUNT
    mock tasks running, then stopped; (c) a batch task that asks for the
    card and sees exactly it; (d) exec tasks through the port's executor
    and taskinit; (e) a raw_exec task through the port's driver host.
    (f): the window's launch contract, then the clients shut down and no
    child they started is left alive."""
    import shutil

    from nomad_tpu_torch import mock
    from nomad_tpu_torch.client import Client, ClientConfig, InProcConn
    from nomad_tpu_torch.server import Server, ServerConfig
    from nomad_tpu_torch.structs import Constraint, Node, RequestedDevice

    t_phase = time.perf_counter()
    on_card = device is None or torch.device(device).type == "cuda"
    srng = random.Random(SEED + 12)
    root = _scratch_dir("clients-")
    site = os.path.join(root, "site")
    os.makedirs(site)
    with open(os.path.join(site, "sitecustomize.py"), "w") as f:
        f.write(_UNPRIVILEGED_SITE)
    skip = "NOMAD_TPU_SKIP_GPU_FINGERPRINT"
    keys = (skip, "NOMAD_TPU_GCE_METADATA_URL", "NOMAD_TPU_AWS_METADATA_URL")
    saved = {k: os.environ.get(k) for k in keys}
    # the machine is sealed: the cloud fingerprinters read a refused
    # local port instead of a metadata service
    os.environ["NOMAD_TPU_GCE_METADATA_URL"] = "http://127.0.0.1:9"
    os.environ["NOMAD_TPU_AWS_METADATA_URL"] = "http://127.0.0.1:9"
    sys.path.insert(0, site)
    walls, out = {}, {}
    pids = {"executor": set(), "driver_host": set(), "task": set()}
    clients, done = [], False
    s = Server(ServerConfig(num_schedulers=1, heartbeat_ttl=60.0,
                            gc_interval=3600.0, eval_batch=16),
               device=device)
    if device is None and s.device.type != "cuda":
        raise AssertionError(f"Server default device is {s.device}")

    def allocs(job):
        return s.state.allocs_by_job("default", job.id)

    def settle(job, what, timeout=120.0):
        done = s.wait_for_eval(s.job_register(job).id, timeout=timeout)
        if done is None or done.status != "complete":
            raise AssertionError(f"{what}: eval {done}")
        _until(lambda: allocs(job) and all(
            a.client_status in ("complete", "failed", "lost")
            for a in allocs(job)), timeout, f"{what}: allocs terminal")
        return allocs(job)

    def running_handle(job, what):
        _until(lambda: allocs(job) and allocs(job)[0].client_status
               == "running", 60.0, f"{what}: running")
        (a,) = allocs(job)
        c = next(c for c in clients if a.id in c.allocs)
        runner = c.allocs[a.id].task_runners["web"]
        _until(lambda: runner.handle is not None, 30.0, f"{what}: handle")
        return runner.handle

    try:
        s.start()
        _, t_ingest = _timed(lambda: _ingest(s, srng, PHASE11_ALLOCS))
        print(f"phase 12 server: {N_NODES} nodes, {PHASE11_ALLOCS + 64} "
              f"allocs ingested in {t_ingest:.1f} s")
        win = _LaunchWindow(kp, kr)

        # ---- (a) registration; the GPU client last, once `skip` is off
        t0 = time.perf_counter()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=uuid,name",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        cards = [tuple(c.strip() for c in line.split(",", 1))
                 for line in smi if line.strip()]
        reg = []
        for i in range(CLIENTS):
            gpu = i == CLIENTS - 1
            if gpu:
                os.environ.pop(skip, None)
            else:
                os.environ[skip] = "1"
            c = Client(InProcConn(s), ClientConfig(
                data_dir=os.path.join(root, f"client{i}"),
                node=Node(name=f"card-host-{i}", datacenter="dc1",
                          node_class=CLIENT_CLASS),
                heartbeat_interval=1.0,
                plugin_config={"raw_exec": {"out_of_process": True}}
                if i == 1 else None))
            clients.append(c)
            t1 = time.perf_counter()
            c.start()
            _until(lambda c=c: getattr(s.state.node_by_id(c.node.id),
                                       "status", "") == "ready", 30.0,
                   f"client {i} registration")
            reg.append(time.perf_counter() - t1)
        node = s.state.node_by_id(clients[-1].node.id)
        groups = [g for g in node.node_resources.devices
                  if (g.vendor, g.type) == ("nvidia", "gpu")]
        if not cards or len(groups) != 1:
            raise AssertionError(f"phase 12 (a): nvidia-smi found {cards}; "
                                 f"the GPU client's node carries {groups}")
        (group,) = groups
        if ([i.id for i in group.instances] != [u for u, _ in cards]
                or group.attributes.get("model") != cards[0][1]
                or node.attributes.get("gpu.count") != str(len(cards))):
            raise AssertionError(f"phase 12 (a): group {group} is not the "
                                 f"card nvidia-smi names: {cards}")
        for c in clients[:-1]:
            other = s.state.node_by_id(c.node.id)
            if any(g.vendor == "nvidia" for g
                   in other.node_resources.devices):
                raise AssertionError("phase 12 (a): a client that skips "
                                     "the GPU fingerprint carries a card")
        walls["a"] = time.perf_counter() - t0
        out["register_ms"] = [r * 1e3 for r in reg]
        print(f"phase 12 (a) registration: {CLIENTS} clients ready in "
              + ", ".join(f"{r * 1e3:.1f}" for r in reg)
              + f" ms (start to ready); the GPU client's node carries "
              f"{group.id()} = {[i.id for i in group.instances]}, "
              f"{group.attributes}; {card}")

        # ---- (b) a burst of service jobs on the clients, then stopped
        t0 = time.perf_counter()
        jobs = [_client_job(mock, f"svc{k}", "mock_driver",
                            {"run_for": 3600.0}, count=CLIENT_COUNT,
                            batch=False) for k in range(CLIENT_JOBS)]
        registered, wall0, evs = {}, time.time(), []
        for j in jobs:
            registered[j.id] = time.perf_counter()
            evs.append(s.job_register(j))
        _wait_evals(s, evs, timeout=120.0)
        # the server's part: every eval complete, its allocs in the state
        t_placed = time.perf_counter() - t0
        seen = {}

        def all_running():
            now = time.perf_counter()
            for j in jobs:
                for a in allocs(j):
                    if a.client_status == "running" and a.id not in seen:
                        seen[a.id] = now - registered[j.id]
            return len(seen) == CLIENT_JOBS * CLIENT_COUNT

        _until(all_running, 120.0, "phase 12 (b): allocs running")
        mine = {c.node.id for c in clients}
        if any(a.node_id not in mine for j in jobs for a in allocs(j)):
            raise AssertionError("phase 12 (b): an alloc left the clients")
        lat = sorted(seen.values())
        out["running_ms"] = (statistics.median(lat) * 1e3, lat[-1] * 1e3)
        # the client's part, from its task events (wall clock): the first
        # registration to the task runner's "Received", then to "Started"
        marks = [{e.type: e.time for e in a.task_states["web"].events}
                 for j in jobs for a in allocs(j)]
        received = statistics.median(m["Received"] - wall0 for m in marks)
        started = statistics.median(m["Started"] - m["Received"]
                                    for m in marks)
        t_run = time.perf_counter() - t0
        stops = [s.job_deregister("default", j.id) for j in jobs]
        _wait_evals(s, stops, timeout=120.0)
        _until(lambda: all(a.client_status in ("complete", "failed", "lost")
                           for j in jobs for a in allocs(j)), 120.0,
               "phase 12 (b): allocs stopped")
        walls["b"] = time.perf_counter() - t0
        used = len({a.node_id for j in jobs for a in allocs(j)})
        print(f"phase 12 (b) service burst: {CLIENT_JOBS} jobs x "
              f"{CLIENT_COUNT} mock tasks on {used} clients: eval to running p50 {out['running_ms'][0]:.1f} ms, "
              f"max {out['running_ms'][1]:.1f} ms; every eval complete "
              f"{t_placed:.2f} s after the first registration, a task "
              f"received at {received:.2f} s and started "
              f"{started * 1e3:.1f} ms later (medians), all "
              f"running at {t_run:.2f} s, all stopped "
              f"{walls['b'] - t_run:.2f} s later; {card}")

        # ---- (c) a task that asks for the card sees exactly it
        t0 = time.perf_counter()
        gj = _client_job(mock, "gpu", "raw_exec", {
            "command": "/bin/sh", "args": [
                "-c", "echo CUDA_VISIBLE_DEVICES=$CUDA_VISIBLE_DEVICES; "
                      "echo NVIDIA_VISIBLE_DEVICES=$NVIDIA_VISIBLE_DEVICES; "
                      "nvidia-smi -L"]})
        gj.task_groups[0].tasks[0].resources.devices = [RequestedDevice(
            name="nvidia/gpu", count=1, constraints=[Constraint(
                "${device.model}", group.name, "=")])]
        (a,) = settle(gj, "phase 12 (c)")
        ts = a.task_states["web"]
        (dev,) = [d for tr in a.allocated_resources.tasks.values()
                  for d in tr.devices]
        log = _task_log(clients, a, "web", "stdout")
        uuid0 = cards[0][0]
        if (a.node_id != node.id or a.client_status != "complete"
                or ts.failed or dev.device_ids != [uuid0]
                or "Exit Code: 0" not in [e.message for e in ts.events]
                or f"CUDA_VISIBLE_DEVICES={uuid0}\n" not in log
                or f"NVIDIA_VISIBLE_DEVICES={uuid0}\n" not in log):
            raise AssertionError(f"phase 12 (c): alloc {a.client_status} on "
                                 f"{a.node_id}, devices {dev}, log {log!r}")
        walls["c"] = time.perf_counter() - t0
        print(f"phase 12 (c) GPU task: placed on the GPU client with "
              f"{dev.name} {dev.device_ids}; it printed "
              + " | ".join(line for line in log.splitlines() if line)
              + f"; exit 0; {card}")

        # ---- (d) exec tasks through the port's executor and taskinit
        t0 = time.perf_counter()
        parent = ("tr '\\0' ' ' < /proc/$PPID/cmdline; echo; "
                  "sleep 1")
        ej = _client_job(mock, "exec", "exec", {
            "command": "/bin/sh", "args": ["-c", parent]})
        s.job_register(ej)
        h = running_handle(ej, "phase 12 (d)")
        ex_pid = h.client.pid
        ex_argv = _cmdline(ex_pid)
        applied = dict(h.driver_state.get("applied") or {})
        pids["executor"].add(ex_pid)
        pids["task"].add(int(h.driver_state.get("task_pid") or 0))
        _until(lambda: allocs(ej)[0].client_status == "complete", 60.0,
               "phase 12 (d): exec task complete")
        ex_log = _task_log(clients, allocs(ej)[0], "web", "stdout")
        mj = _client_job(mock, "taskinit", "exec", {
            "command": "/nonexistent/phase12-task"})
        (ma,) = settle(mj, "phase 12 (d) missing command")
        init_err = _task_log(clients, ma, "web", "stderr")
        if (ex_argv[1:3] != ["-m", "nomad_tpu_torch.plugins.executor"]
                or "-m nomad_tpu_torch.plugins.executor" not in ex_log
                or ma.client_status != "failed"
                or "nomad_tpu_torch/plugins/taskinit.py" not in init_err
                or applied.get("cgroup") is not None
                or applied.get("namespaces")):
            raise AssertionError(f"phase 12 (d): executor {ex_argv}, task "
                                 f"saw {ex_log!r}, applied {applied}, "
                                 f"taskinit's stderr {init_err[-400:]!r}")
        walls["d"] = time.perf_counter() - t0
        print(f"phase 12 (d) exec: the executor child runs "
              f"{' '.join(ex_argv[1:])} (read from /proc while its task "
              f"ran, and by the task from its parent); taskinit is the "
              f"port's (the traceback of a missing command names "
              f"nomad_tpu_torch/plugins/taskinit.py); isolation applied "
              f"on this host {applied}; {card}")

        # ---- (e) a raw_exec task through the port's driver host
        t0 = time.perf_counter()
        oj = _client_job(mock, "oop", "raw_exec", {
            "command": "/bin/sh", "args": ["-c", parent]})
        oj.constraints.append(Constraint("${node.unique.id}",
                                         clients[1].node.id, "="))
        s.job_register(oj)
        h = running_handle(oj, "phase 12 (e)")
        host_pid = clients[1].driver_manager.dispense(
            "raw_exec")._client.pid
        host_argv = _cmdline(host_pid)
        pids["driver_host"].add(host_pid)
        pids["task"].add(int(h.driver_state.get("task_pid") or 0))
        _until(lambda: allocs(oj)[0].client_status == "complete", 60.0,
               "phase 12 (e): task complete")
        oop_log = _task_log(clients, allocs(oj)[0], "web", "stdout")
        if (host_argv[1:] != ["-m", "nomad_tpu_torch.plugins.driver_host",
                              "raw_exec"]
                or "-m nomad_tpu_torch.plugins.executor" not in oop_log):
            raise AssertionError(f"phase 12 (e): driver host {host_argv}, "
                                 f"task saw {oop_log!r}")
        walls["e"] = time.perf_counter() - t0
        print(f"phase 12 (e) out of process: the driver host runs "
              f"{' '.join(host_argv[1:])}; its task's parent runs "
              f"{oop_log.strip().split(' ', 1)[-1]}; {card}")

        # ---- (f) the launch contract, then nothing left behind
        t0 = time.perf_counter()
        out["window"] = win.close("phase 12 clients", on_card)
        if on_card:
            for k in ("chain", "insert", "k7"):
                if out["window"][k] == 0:
                    raise AssertionError(f"phase 12: no {k} launch in the "
                                         f"window: {out['window']}")
        done = True
    finally:
        # the driver host outlives a client that detaches (for reattach
        # after a restart): stopping it is the operator's part
        if len(clients) > 1:
            clients[1].driver_manager.dispense("raw_exec").close(
                kill_plugin=True)
        for c in clients:
            c.shutdown()
        s.shutdown()
        if not done:
            # a failed part may leave a task and its executor running
            for p in (p for v in pids.values() for p in v if p):
                try:
                    os.kill(p, 9)
                except OSError:
                    pass
        sys.path.remove(site)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    try:
        _until(lambda: not _alive(pids), 15.0, "children")
    except AssertionError:
        raise AssertionError(f"phase 12 (f): left alive {_alive(pids)}") \
            from None
    shutil.rmtree(root, ignore_errors=True)
    walls["f"] = time.perf_counter() - t0
    out["walls"] = walls
    w = out["window"]
    print(f"phase 12 (f): launch window K4 {w['chain']} chain dispatches "
          f"in {w['kernels']['chain']} kernel launches, K5 {w['wave']} "
          f"waves in {w['kernels']['wave']}, K8 {w['insert']} for "
          f"{w['inserts']} inserts, K7 {w['k7']} for {w['delta_uploads']} "
          f"delta refreshes; {sum(len(v) for v in pids.values())} children "
          f"seen, none left; walls " + ", ".join(
              f"({k}) {v:.2f} s" for k, v in walls.items())
          + f"; {card}")
    print(f"phase 12 took {time.perf_counter() - t_phase:.1f} s")
    return out


#: phase 13: the agent's node meta, which no synthetic node has
AGENT_META = {"phase13": "card-host"}
#: (a): `job run -detach` children started at once, and at most this
#: many such bursts until one fed the batched path (a chain dispatch):
#: an idle agent schedules a lone eval by itself, as one program
AGENT_BURST, AGENT_BURSTS = 8, 3
#: (a): the job run of CLIENT_COUNT mock tasks, and the job planned
AGENT_JOB_HCL = """
job "%(id)s" {
  datacenters = ["dc1"]
  %(constraint)s
  group "web" {
    count = %(count)d
    task "web" {
      driver = "mock_driver"
      config { run_for = 3600 }
      resources {
        cpu    = 100
        memory = 64
      }
    }
  }
}
"""


class _Recorded:
    """Every chain and wave launch in a stretch, with the inputs it read
    and the outputs it wrote (device copies taken at the launch), to hold
    against the plain versions afterwards, as phase 6 does."""

    NAMES = ("place_table_chain", "place_table_wave", "place_packed_chain")

    def __init__(self, torch, kp):
        self.torch, self.kp, self.records = torch, kp, []
        self.real = {n: getattr(kp, n) for n in self.NAMES}

    def __enter__(self):
        for name in self.NAMES:
            setattr(self.kp, name, self._recorder(name))
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.kp, name, fn)

    def _recorder(self, name):
        fn, torch = self.real[name], self.torch

        def rec(*args, **kw):
            snap = _snap(torch, args)
            res = fn(*args, **kw)
            self.records.append((name, snap, kw, _snap(torch, res)))
            return res
        return rec

    def check(self, what: str) -> float:
        err = 0.0
        for i, (name, args, kw, res) in enumerate(self.records):
            want = getattr(self.kp, name + "_plain")(*args, **kw)
            if name == "place_packed_chain":
                want, res = (want, ()), (res, ())
            err = max(err, _compare_flat(want, res, f"{what} launch {i} "
                                         f"({name})", kw.get("explain",
                                                             False)))
        return err


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _http_json(addr: str, path: str):
    import urllib.request

    with urllib.request.urlopen(addr + path, timeout=10) as r:
        return json.loads(r.read())


def _children_of(pid: int) -> list:
    out = []
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    if int(f.read().rsplit(")", 1)[1].split()[1]) == pid:
                        out.append(int(d))
            except (OSError, IndexError, ValueError):
                pass
    return out


def _exposition_sites(text: str, on_card: bool) -> list:
    """The `site` label values of a Prometheus exposition, sorted; raises
    unless every one is in the reference's `ALLOWED_SITES` and every
    label name in `ALLOWED_LABELS`, and (on the card, where lane
    dispatches book their argument tables there) unless the programs'
    upload site is among them."""
    from nomad_tpu_torch.analysis.vocab import ALLOWED_LABELS, ALLOWED_SITES

    labels, sites = set(), set()
    for line in text.splitlines():
        series = line.split(" ")[0]
        if line.startswith("#") or "{" not in series:
            continue
        for pair in series.split("{", 1)[1].rsplit("}", 1)[0].split(","):
            k, _, v = pair.partition("=")
            if k:
                labels.add(k)
            if k == "site":
                sites.add(v.strip('"'))
    if not labels <= ALLOWED_LABELS:
        raise AssertionError(f"labels outside ALLOWED_LABELS: "
                             f"{sorted(labels - ALLOWED_LABELS)}")
    if not sites <= ALLOWED_SITES:
        raise AssertionError(f"sites outside ALLOWED_SITES: "
                             f"{sorted(sites - ALLOWED_SITES)}")
    if on_card and "select_batch.pack_buffers" not in sites:
        raise AssertionError(f"no lane dispatch booked its argument table: "
                             f"sites {sorted(sites)}")
    return sorted(sites)


def _phase13_agent(torch, kp, kr, device=None, card=""):
    """The agent, its HTTP API and the CLI on the card. (a) An in-process
    `Agent(AgentConfig(http_port=0, data_dir=..., node_meta=AGENT_META),
    device=device)` over N_NODES synthetic nodes and PHASE11_ALLOCS + 64
    allocs ingested before it starts, driven only by `python -m
    nomad_tpu_torch -address ...` children: `job run` of CLIENT_COUNT mock
    tasks on the agent's own node (a chain dispatch, K4), `job plan` of a
    second job (K1 through the port's Harness), `job status`, `alloc
    status`, `eval placement`, `operator hbm`, `operator metrics -format
    prometheus`, `job stop`; phase 6's launch contract over the window,
    each chain or wave launch equal to its plain version on the inputs it
    read. (b) `python -m nomad_tpu_torch agent -dev` as a child at its
    default device (`-device cpu` when `device` is the CPU): start to
    HTTP ready, one `job run` to a running alloc, then SIGINT: exit 0
    and no child of it left."""
    import shutil
    import signal

    from nomad_tpu_torch.agent import Agent, AgentConfig

    t_phase = time.perf_counter()
    on_card = device is None or torch.device(device).type == "cuda"
    repo = os.path.dirname(os.path.abspath(__file__))
    root = _scratch_dir("agent-")
    srng = random.Random(SEED + 13)
    env = dict(os.environ)
    env.pop("NOMAD_ADDR", None)
    walls, out = {}, {}

    def spec(name, count, on_agent=True):
        # on the in-process agent's own node only
        constraint = ('constraint {\n    attribute = "${meta.phase13}"\n'
                      '    value     = "card-host"\n  }' if on_agent else "")
        path = os.path.join(root, f"{name}.nomad")
        with open(path, "w") as f:
            f.write(AGENT_JOB_HCL % {"id": name, "count": count,
                                     "constraint": constraint})
        return path

    def argv_of(addr, argv):
        return [sys.executable, "-m", "nomad_tpu_torch", "-address", addr,
                *argv]

    def cli(addr, *argv, what=""):
        t0 = time.perf_counter()
        proc = subprocess.run(argv_of(addr, argv), cwd=repo, env=env,
                              capture_output=True, text=True, timeout=120)
        wall = time.perf_counter() - t0
        walls[what or argv[0] + " " + argv[1]] = wall
        if proc.returncode != 0:
            raise AssertionError(f"phase 13: {' '.join(argv)} exited "
                                 f"{proc.returncode}: {proc.stderr[-2000:]}")
        return proc.stdout

    def burst(addr, k):
        """AGENT_BURST `job run -detach` children at once; the slowest
        child's wall."""
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            argv_of(addr, ["job", "run", "-detach",
                           spec(f"p13-burst{k}-{i}", 1)]), cwd=repo,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for i in range(AGENT_BURST)]
        for p in procs:
            _, err = p.communicate(timeout=120)
            if p.returncode != 0:
                raise AssertionError(f"phase 13: a burst's job run exited "
                                     f"{p.returncode}: {err[-2000:]}")
        return time.perf_counter() - t0

    # ---- (a) an in-process agent on the card, driven by CLI children
    threads0 = threading.active_count()
    agent = Agent(AgentConfig(
        http_port=0, data_dir=os.path.join(root, "data"),
        node_meta=dict(AGENT_META), node_name="card-host-agent",
        heartbeat_ttl=3600.0), device=device)
    if device is None and agent.server.device.type != "cuda":
        raise AssertionError(f"Agent default device is "
                             f"{agent.server.device}")
    try:
        _, t_ingest = _timed(lambda: _ingest(agent.server, srng,
                                             PHASE11_ALLOCS))
        print(f"phase 13 agent: {N_NODES} nodes, {PHASE11_ALLOCS + 64} "
              f"allocs ingested in {t_ingest:.1f} s before it starts")
        agent.start()
        s = agent.server
        addr = f"http://{agent.http_addr[0]}:{agent.http_addr[1]}"
        _until(lambda: getattr(s.state.node_by_id(agent.client.node.id),
                               "status", "") == "ready", 60.0,
               "phase 13 (a): the agent's node ready")
        win = _LaunchWindow(kp, kr)
        with _Recorded(torch, kp) as rec:
            t0 = time.perf_counter()
            run = cli(addr, "job", "run", spec("p13-web", CLIENT_COUNT))
            if "Evaluation status: complete" not in run:
                raise AssertionError(f"phase 13 (a): job run said {run!r}")

            def allocs():
                return s.state.allocs_by_job("default", "p13-web")

            _until(lambda: len(allocs()) == CLIENT_COUNT and all(
                a.client_status == "running" for a in allocs()), 120.0,
                "phase 13 (a): allocs running")
            out["run_to_running_s"] = time.perf_counter() - t0
            if {a.node_id for a in allocs()} != {agent.client.node.id}:
                raise AssertionError("phase 13 (a): an alloc left the "
                                     "agent's node")
            plan = cli(addr, "job", "plan", spec("p13-plan", 2))
            if "Placements: 2" not in plan:
                raise AssertionError(f"phase 13 (a): job plan said {plan!r}")
            status = cli(addr, "job", "status", "p13-web")
            if status.count(" running") < CLIENT_COUNT:
                raise AssertionError(f"phase 13 (a): job status {status!r}")
            a0 = allocs()[0]
            if "running" not in cli(addr, "alloc", "status", a0.id[:8]):
                raise AssertionError("phase 13 (a): alloc status")
            (ev,) = [e for e in s.state.evals_by_job("default", "p13-web")]
            placed = cli(addr, "eval", "placement", ev.id)
            if "card-host-agent" not in placed:
                raise AssertionError(f"phase 13 (a): eval placement does "
                                     f"not name the agent's node: {placed!r}")
            hbm = cli(addr, "operator", "hbm")
            if "stack.view" not in hbm:
                raise AssertionError(f"phase 13 (a): operator hbm {hbm!r}")
            prom = cli(addr, "operator", "metrics", "-format", "prometheus",
                       what="operator metrics")
            if "nomad_transfer_bytes_total" not in prom:
                raise AssertionError("phase 13 (a): no transfer series in "
                                     "the exposition")
            # many users at once: evals that queue together drain as one
            # batch, placed by one chain dispatch
            for k in range(AGENT_BURSTS):
                walls[f"burst {k} of {AGENT_BURST} job run -detach"] = \
                    burst(addr, k)
                jobs = [f"p13-burst{k}-{i}" for i in range(AGENT_BURST)]
                _until(lambda: all(
                    any(a.client_status == "running" for a in
                        s.state.allocs_by_job("default", j)) for j in jobs),
                    120.0, "phase 13 (a): the burst's allocs running")
                if any(r[0] != "place_task_group" for r in rec.records):
                    break
            out["bursts"] = k + 1
            # the exposition once more, now that lane and chain
            # dispatches ran on the card: every `site` value and every
            # label name in the reference's vocabulary
            prom = cli(addr, "operator", "metrics", "-format", "prometheus",
                       what="operator metrics after the bursts")
            out["sites"] = _exposition_sites(prom, on_card)
            cli(addr, "job", "stop", "p13-web")
            _until(lambda: all(a.client_status in ("complete", "failed",
                                                   "lost")
                               for a in allocs()), 120.0,
                   "phase 13 (a): allocs stopped")
        out["k1"] = kp.launch_count()
        out["window"] = w = win.close("phase 13 agent", on_card)
        if on_card and (w["chain"] < 1 or w["inserts"] < 1
                        or out["k1"] < 1):
            raise AssertionError(f"phase 13 (a): K4 {w['chain']}, K8 "
                                 f"inserts {w['inserts']}, K1 {out['k1']}: "
                                 "a kernel of the path never launched")
        out["err"] = rec.check("phase 13 agent")
        print(f"phase 13 (a): exposition after the bursts: sites "
              f"{', '.join(out['sites'])}, all in ALLOWED_SITES; {card}")
        print(f"phase 13 (a) agent on {s.device}: CLI children "
              + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in walls.items())
              + f"; job run to {CLIENT_COUNT} allocs running "
              f"{out['run_to_running_s'] * 1e3:.1f} ms; K1 {out['k1']} "
              f"programs (job plan and lone evals); {out['bursts']} "
              f"bursts to a chain dispatch; {len(rec.records)} chain/wave "
              f"launches equal to plain (max abs err {out['err']}); {card}")
    finally:
        agent.shutdown()
    # the client's long polls and the tasks' threads end on their own
    # after the shutdown: wait a little for them, then count
    deadline = time.perf_counter() + 10.0
    while (threading.active_count() > threads0 + 2
           and time.perf_counter() < deadline):
        time.sleep(0.1)
    left = collections.Counter(t.name.split("-")[0].split(" ")[0]
                               for t in threading.enumerate())
    print(f"phase 13 (a): threads {threads0} before the agent, "
          f"{threading.active_count()} after its shutdown "
          f"({dict(left.most_common(4))})")
    out["walls"] = dict(walls)

    # ---- (b) `agent -dev` as a child at its default device
    port = _free_port()
    addr = f"http://127.0.0.1:{port}"
    argv = [sys.executable, "-m", "nomad_tpu_torch", "agent", "-dev",
            "-http-port", str(port), "-data-dir", os.path.join(root, "dev")]
    if not on_card:
        argv += ["-device", "cpu"]
    log = open(os.path.join(root, "dev-agent.log"), "w")
    t0 = time.perf_counter()
    child = subprocess.Popen(argv, cwd=repo, env=env, stdout=log,
                             stderr=subprocess.STDOUT)
    kids = []
    try:
        def ready():
            if child.poll() is not None:
                raise AssertionError(f"phase 13 (b): the agent exited "
                                     f"{child.returncode}")
            try:
                return _http_json(addr, "/v1/agent/self")["server"]
            except OSError:
                return False
        t1 = time.perf_counter()
        _until(ready, 120.0, "phase 13 (b): HTTP ready")
        out["dev_ready_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        cli(addr, "job", "run", spec("p13-dev", 1, on_agent=False),
            what="dev job run")
        _until(lambda: any(
            a["client_status"] == "running" for a in _http_json(
                addr, "/v1/job/p13-dev/allocations")["data"]),
            120.0, "phase 13 (b): alloc running")
        out["dev_run_to_running_s"] = time.perf_counter() - t1
        kids = _children_of(child.pid)
    finally:
        child.send_signal(signal.SIGINT)
        try:
            rc = child.wait(timeout=60)
        except subprocess.TimeoutExpired:
            child.kill()
            rc = child.wait()
        log.close()
    with open(os.path.join(root, "dev-agent.log")) as f:
        dev_log = f.read()
    if rc != 0 or "==> shutting down" not in dev_log:
        raise AssertionError(f"phase 13 (b): the agent exited {rc}: "
                             f"{dev_log[-2000:]}")
    left = [k for k in kids if _pid_alive(k)]
    if left:
        raise AssertionError(f"phase 13 (b): children left {left}")
    print(f"phase 13 (b) agent -dev child: start to HTTP ready "
          f"{out['dev_ready_s'] * 1e3:.1f} ms, job run to running "
          f"{out['dev_run_to_running_s'] * 1e3:.1f} ms, SIGINT: exit 0, "
          f"{len(kids)} children seen, none left; {card}")
    shutil.rmtree(root, ignore_errors=True)
    print(f"phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return out


def _phase14_lint(card=""):
    """`python -m nomad_tpu_torch.analysis --fail-on-new --stats` as a
    child: exit 0 and a clean tree against `lint_baseline_torch.json`;
    prints its wall and CPU seconds."""
    import resource

    repo = os.path.dirname(os.path.abspath(__file__))
    argv = [sys.executable, "-m", "nomad_tpu_torch.analysis",
            "--fail-on-new", "--stats"]
    ru0 = resource.getrusage(resource.RUSAGE_CHILDREN)
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=repo, capture_output=True, text=True,
                          timeout=300)
    wall = time.perf_counter() - t0
    ru1 = resource.getrusage(resource.RUSAGE_CHILDREN)
    cpu = (ru1.ru_utime - ru0.ru_utime) + (ru1.ru_stime - ru0.ru_stime)
    if proc.returncode != 0 or "findings by rule: clean" not in proc.stdout:
        raise AssertionError(f"phase 14: the lint exited {proc.returncode}: "
                             f"{proc.stdout[-3000:]}{proc.stderr[-2000:]}")
    stats = [ln for ln in proc.stdout.splitlines()
             if ln.startswith(("files analyzed", "findings by rule",
                               "waivers:"))]
    print(f"phase 14: python -m nomad_tpu_torch.analysis --fail-on-new "
          f"--stats: exit 0, {'; '.join(stats)}; wall {wall:.3f} s, CPU "
          f"{cpu:.3f} s; {card}")


# ---- phase 15: the host core and the roofline ----

#: phase 15: allocs a select places (b), evals a mode of the throughput (c)
SELECT_COUNT = 10
HOST_EVALS = 256
#: the seven job variants of the reference's compiled-select test
SELECT_VARIANTS = (
    dict(), dict(with_affinity=True), dict(with_spread=True),
    dict(distinct_hosts=True),
    dict(with_affinity=True, with_spread=True, distinct_hosts=True),
    dict(distinct_property=True), "even_spread")
#: first_fit_ports against its plain version: shares of the dynamic
#: range in use, and counts asked
PORT_FILLS = (0.0, 0.5, 0.99, 1.0)
PORT_COUNTS = (1, 8, 64)


def _cpu_model() -> str:
    """The host CPU as /proc/cpuinfo gives it: its `model name` (which a
    virtual machine may report as "unknown"), vendor, family, model and
    clock, and the logical CPUs."""
    fields = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _sep, value = line.partition(":")
            fields.setdefault(key.strip(), value.strip())
    return (f"model name {fields.get('model name', 'absent')} "
            f"({fields.get('vendor_id', '?')}, family "
            f"{fields.get('cpu family', '?')}, model "
            f"{fields.get('model', '?')}, {fields.get('cpu MHz', '?')} MHz), "
            f"{os.cpu_count()} logical CPUs")


def _select_job(rng, variant, count):
    from nomad_tpu_torch.structs import Spread
    from nomad_tpu_torch.synth import synth_service_job

    if variant == "even_spread":
        job = synth_service_job(rng, count=count)
        job.spreads.append(Spread(attribute="${node.datacenter}",
                                  weight=100))
        return job
    return synth_service_job(rng, count=count, **variant)


def _phase15_host_core(torch, kp, kernels, device=None, card=""):
    """15. The host core and the roofline: (a) the native core's build
    (seconds, cached) and first_fit_ports against its plain version at
    PORT_FILLS of the dynamic range; (b) on a synthetic state of N_NODES
    nodes, the compiled select (exact) against `TorchStack.select` on the
    card (K1) for the seven job variants: the same node and scores within
    1e-4 where both place, neither placing where one does not; the
    sampled mode placing validly with a mean score no higher than the
    exact mode's; (c) the compiled select's evals/s, exact and sampled,
    beside the host CPU; (d) `roofline.summarize` of every timed kernel
    of `kernels`. Returns the numbers of (b) and (c)."""
    import numpy as np

    from nomad_tpu_torch import native
    from nomad_tpu_torch.lib import roofline
    from nomad_tpu_torch.scheduler.stack import TorchStack
    from nomad_tpu_torch.structs.network import (MAX_DYNAMIC_PORT,
                                                 MIN_DYNAMIC_PORT)
    from nomad_tpu_torch.synth import build_synthetic_state

    t0 = time.perf_counter()
    dev = torch.device(device or "cuda")
    on_card = dev.type == "cuda"
    cpu = _cpu_model()

    # (a) the build, and first-fit against its plain version
    native.available()
    info = dict(native.BUILD_INFO)
    lo, hi = MIN_DYNAMIC_PORT, MAX_DYNAMIC_PORT
    nrng = np.random.default_rng(SEED + 15)
    mismatches = checks = 0
    for fill in PORT_FILLS:
        used = np.zeros(65536, dtype=bool)
        used[lo + nrng.choice(hi - lo, int(round((hi - lo) * fill)),
                              replace=False)] = True
        reserved = [lo, lo + 7, hi - 1]
        for count in PORT_COUNTS:
            checks += 1
            got = native.first_fit_ports(used, lo, hi, reserved, count)
            if got != native._first_fit_py(used, lo, hi, reserved, count):
                mismatches += 1
    print(f"phase 15 (a) host core {os.path.basename(native.library_path())}"
          f": g++ {info['seconds']:.2f} s, cached {info['cached']}; "
          f"first_fit_ports == plain at fills "
          f"{', '.join(f'{100 * f:g}' for f in PORT_FILLS)} % of [{lo}, "
          f"{hi}), counts {PORT_COUNTS}: {mismatches} mismatches in "
          f"{checks}")
    if mismatches:
        raise AssertionError(f"first_fit_ports: {mismatches} mismatches")

    # (b) the compiled select against K1 on the card
    state, _nodes = build_synthetic_state(N_NODES, N_ALLOCS, seed=SEED + 15)
    cl = state.cluster
    rng = random.Random(SEED + 15)
    stack = TorchStack(cl, device=dev)
    order = np.random.default_rng(SEED).permutation(cl.n_cap).astype(
        np.int32)
    out = {"mismatches": 0, "compared": 0, "unplaced": 0, "err": 0.0}
    for variant in SELECT_VARIANTS:
        job = _select_job(rng, variant, SELECT_COUNT)
        state.upsert_job(job)
        tg = job.task_groups[0]
        k1 = stack.select(job, tg, SELECT_COUNT)
        route = kp.last_single_route() if on_card else None
        sel, score = native.compiled_select(stack, job, tg, SELECT_COUNT)
        for step in range(SELECT_COUNT):
            k_node = k1.node_ids[step]
            c_node = cl.node_of_row[sel[step]] if sel[step] >= 0 else None
            if k_node is None or c_node is None:
                out["unplaced"] += 1
                out["mismatches"] += not (k_node is None and c_node is None)
                continue
            d = abs(k1.scores[step] - float(score[step]))
            out["err"] = max(out["err"], d)
            out["compared"] += 1
            out["mismatches"] += not (k_node == c_node and d < 1e-4)
        s_sel, s_score = native.compiled_select(stack, job, tg, SELECT_COUNT,
                                                order=order)
        rows = s_sel[s_sel >= 0]
        distinct = isinstance(variant, dict) and variant.get("distinct_hosts")
        valid = (bool(cl.node_ok[rows].all())
                 and (not distinct or len(rows) == len(set(rows.tolist())))
                 and len(rows) == int((sel >= 0).sum()))
        placed = sel >= 0
        mean_e = float(score[placed].mean()) if placed.any() else 0.0
        mean_s = float(s_score[s_sel >= 0].mean()) if len(rows) else 0.0
        print(f"phase 15 (b) {str(variant):60s} K1 (route {route}) and the "
              f"compiled select placed {int(placed.sum())}/{SELECT_COUNT}; "
              f"sampled placed {len(rows)}, mean score {mean_s:.6f} against "
              f"exact {mean_e:.6f}")
        if not valid or mean_s > mean_e + 1e-6:
            raise AssertionError(f"{variant}: the sampled select placed "
                                 f"{s_sel.tolist()} (mean {mean_s} against "
                                 f"exact {mean_e})")
    print(f"phase 15 (b) compiled select (exact) against TorchStack.select "
          f"on {dev} (K1) at {N_NODES} nodes, {len(SELECT_VARIANTS)} "
          f"variants of count {SELECT_COUNT}: {out['mismatches']} "
          f"mismatches, {out['compared']} placements compared (max score "
          f"difference {out['err']:.3g}), {out['unplaced']} unplaced in both")
    if out["mismatches"]:
        raise AssertionError(f"compiled select against K1: "
                             f"{out['mismatches']} mismatches")

    # (c) the compiled select's throughput, exact and sampled
    jobs = _bench_jobs(state, random.Random(SEED + 16), HOST_EVALS,
                       SELECT_COUNT)
    orng = np.random.default_rng(SEED)
    for mode in ("exact", "sampled"):
        fresh = TorchStack(cl, device=dev)   # programs compiled in the loop
        placed = 0
        score_sum = 0.0
        t1 = time.perf_counter()
        for job in jobs:
            kw = ({} if mode == "exact" else
                  {"order": orng.permutation(cl.n_cap).astype(np.int32)})
            sel, score = native.compiled_select(
                fresh, job, job.task_groups[0], SELECT_COUNT, **kw)
            placed += int((sel >= 0).sum())
            score_sum += float(score[sel >= 0].sum())
        dt = time.perf_counter() - t1
        out[mode] = dict(evals_per_s=len(jobs) / dt, placed=placed,
                         mean_score=score_sum / max(placed, 1))
        print(f"phase 15 (c) compiled select {mode} at {N_NODES} nodes, "
              f"count {SELECT_COUNT}: {len(jobs)} evals of bench's mix in "
              f"{dt:.3f} s = {len(jobs) / dt:.1f} evals/s, placed "
              f"{placed}/{len(jobs) * SELECT_COUNT}, mean score "
              f"{score_sum / max(placed, 1):.6f}; host CPU {cpu}; {card}")

    # (d) the roofline of every kernel timed
    for k in kernels:
        if k.get("ms") is None or "cost" not in k:
            continue
        s = roofline.summarize(k["name"], k["cost"], k["ms"] / 1e3, dev)
        print(f"phase 15 (d) roofline {k['name']}: {s['bound']}-bound "
              f"(bound {k['bound_ms']:.7f} ms by {k['bound_by']}, "
              f"{s['flops_per_dispatch']:.0f} operations, "
              f"{s['bytes_per_dispatch']:.0f} bytes) against "
              f"{k['ms']:.4f} ms: pct_of_peak_hbm_bw "
              f"{s.get('pct_of_peak_hbm_bw')}, pct_of_peak_flops "
              f"{s.get('pct_of_peak_flops')}, headroom_x "
              f"{s.get('headroom_x')}; {card}")
    print(f"phase 15 took {time.perf_counter() - t0:.1f} s")
    return out


#: phase 16: the nodes the operator's jobs are constrained to, the job's
#: count, the nodes drained, the evals of the opt-out burst
PHASE16_NODES = 16
PHASE16_CLASS = "phase16"
PHASE16_COUNT = 64
PHASE16_DRAIN = 8
#: jobs that share the drained nodes with the phase's job, and their count
PHASE16_NEIGHBOURS = 3
PHASE16_NEIGHBOUR = 8
PHASE16_EVALS = 64


def _phase16_job(mock, Constraint, count, kind="service"):
    """A job of `count` small tasks (100 MHz, 64 MiB, no ports) held to
    the phase's nodes."""
    job = mock.batch_job() if kind == "batch" else mock.job()
    tg = job.task_groups[0]
    tg.count = count
    tg.networks = []
    for t in tg.tasks:
        t.resources.cpu, t.resources.memory_mb = 100, 64
        t.resources.networks = []
    job.constraints.append(Constraint("${node.class}", PHASE16_CLASS, "="))
    return job


def _phase16_ack(s, job_id):
    """The client side of a settle: stops acknowledged as complete, new
    allocs reported running. Returns the job's live allocs."""
    live = []
    for a in s.state.allocs_by_job("default", job_id):
        status = None
        if a.desired_status != "run" and a.client_status in ("pending",
                                                             "running"):
            status = "complete"
        elif a.desired_status == "run" and a.client_status == "pending":
            status = "running"
        if status is not None:
            upd = copy.copy(a)
            upd.client_status = status
            s.state.update_alloc_from_client(upd)
        if a.desired_status == "run" and not a.terminal_status():
            live.append(a)
    return live


def _phase16_deploy(s, job_id, dep, what, timeout=60.0):
    """Drive deployment `dep` to success as healthy clients would: every
    new alloc reported running and healthy, the canaries promoted once
    healthy. Returns the deployment's end state."""
    promoted = False

    def step():
        nonlocal promoted
        _phase16_ack(s, job_id)
        for a in s.state.allocs_by_job("default", job_id):
            if (a.deployment_id == dep and not a.terminal_status()
                    and (a.deployment_status is None
                         or a.deployment_status.healthy is None)):
                s.update_alloc_health(a.id, True)
        d = s.state.deployment_by_id(dep)
        if (not promoted and d.requires_promotion()
                and all(len(ds.placed_canaries) >= ds.desired_canaries
                        for ds in d.task_groups.values())):
            healthy = {a.id for a in s.state.allocs_by_job("default",
                                                           job_id)
                       if a.deployment_status is not None
                       and a.deployment_status.is_healthy()}
            if all(set(ds.placed_canaries) <= healthy
                   for ds in d.task_groups.values()):
                s.deployment_promote(dep)
                promoted = True
        return not d.active()

    _until(step, timeout, f"phase 16 {what}: deployment {dep} to end")
    return s.state.deployment_by_id(dep), promoted


def _attributed(metrics) -> bool:
    """Whether a placed alloc's AllocMetric carries the kernel's
    attribution: a top-K of nodes, score parts beside the normalized
    score, or filter and exhaustion counts. With explain off a placement
    records its own node's normalized score and nothing else."""
    return bool(len(metrics.score_meta) > 1
                or any(set(sm.scores) - {"normalized-score"}
                       for sm in metrics.score_meta)
                or metrics.constraint_filtered
                or metrics.dimension_exhausted)


def _phase16_burst(torch, kp, kr, device, card, explain_off):
    """(d): one burst of phase 6's mix, queued before the server starts,
    through a fresh server on the phase's state; the placements by (job
    position, alloc index) as (node name, score), and how many of them
    carry the kernel's attribution."""
    from nomad_tpu_torch.server import Server, ServerConfig

    what = "(d) opted out" if explain_off else "(d) explain on"
    saved = os.environ.pop("NOMAD_TPU_EXPLAIN", None)
    if explain_off:
        os.environ["NOMAD_TPU_EXPLAIN"] = "0"
    s = Server(ServerConfig(num_schedulers=1, heartbeat_ttl=3600.0,
                            gc_interval=3600.0, eval_batch=16),
               device=device)
    try:
        _ingest(s, random.Random(SEED + 161), PHASE11_ALLOCS)
        jobs, dh = _mix(random.Random(SEED + 162), PHASE16_EVALS)
        win = _LaunchWindow(kp, kr)
        t0 = time.perf_counter()
        evs = [s.job_register(j) for j in jobs]
        s.start()
        _wait_evals(s, evs)
        wall = time.perf_counter() - t0
        _placed(s, jobs, dh, f"phase 16 {what}")
        names = {nid: nd.name for nid, nd in s.state._nodes.items()}
        placements, attributed = {}, 0
        for ji, j in enumerate(jobs):
            for a in s.state.allocs_by_job("default", j.id):
                attributed += _attributed(a.metrics)
                score = next(sm.scores["normalized-score"]
                             for sm in a.metrics.score_meta
                             if sm.node_id == a.node_id)
                placements[(ji, a.name.rsplit("[", 1)[1])] = (
                    names[a.node_id], score)
        out = win.close(f"phase 16 {what}", device is None
                        or torch.device(device).type == "cuda")
        out.update(k1=kp.launch_count(),
                   k1_kernels=kp.single_kernel_launches(), wall_s=wall)
    finally:
        s.shutdown()
        os.environ.pop("NOMAD_TPU_EXPLAIN", None)
        if saved is not None:
            os.environ["NOMAD_TPU_EXPLAIN"] = saved
    print(f"phase 16 {what}: {len(evs)} evals, {len(placements)} allocs in "
          f"{wall:.2f} s ({len(evs) / wall:.2f} evals/s), {attributed} with "
          f"the kernel's attribution; K1 {out['k1']} programs, K4 "
          f"{out['chain']}, K5 {out['wave']}, K7 {out['k7']}, K8 "
          f"{out['insert']}; {card}")
    return placements, attributed, out


def _phase16_operator(torch, kp, kr, device=None, card=""):
    """The operator's lifecycle paths on the card (the docstring's
    phase 16): drain, deployment with canary and auto-revert, periodic
    launch and core GC, and the explain opt-out. Returns the steps'
    launch windows."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.server import Server, ServerConfig
    from nomad_tpu_torch.server.core_sched import TERMINAL_EVAL
    from nomad_tpu_torch.structs import Constraint
    from nomad_tpu_torch.structs.deployment import (
        DEPLOYMENT_STATUS_FAILED, DEPLOYMENT_STATUS_SUCCESSFUL)
    from nomad_tpu_torch.structs.job import (MigrateStrategy,
                                             PeriodicConfig, UpdateStrategy)
    from nomad_tpu_torch.structs.node import DrainStrategy

    t_phase = time.perf_counter()
    on_card = device is None or torch.device(device).type == "cuda"
    steps = {}

    def close(win, step, t0):
        out = win.close(f"phase 16 ({step})", on_card)
        out.update(k1=kp.launch_count(),
                   k1_kernels=kp.single_kernel_launches(),
                   wall_s=time.perf_counter() - t0)
        steps[step] = out
        print(f"phase 16 ({step}): {out['wall_s']:.2f} s; K1 {out['k1']} "
              f"programs in {out['k1_kernels']} kernel launches, K4 "
              f"{out['chain']}, K5 {out['wave']}, K7 {out['k7']}, K8 "
              f"{out['insert']}; {card}")
        if on_card and out["k1"] + out["chain"] + out["wave"] == 0:
            raise AssertionError(f"phase 16 ({step}): no placement kernel "
                                 "launched")

    s = Server(ServerConfig(num_schedulers=1, heartbeat_ttl=60.0,
                            gc_interval=3600.0, eval_batch=16),
               device=device)
    if device is None and s.device.type != "cuda":
        raise AssertionError(f"Server default device is {s.device}")
    try:
        s.start()
        _, t_ingest = _timed(lambda: _ingest(s, random.Random(SEED + 16),
                                             PHASE11_ALLOCS))
        ops = []
        for i in range(PHASE16_NODES):
            n = mock.node(name=f"{PHASE16_CLASS}-{i}",
                          node_class=PHASE16_CLASS)
            n.compute_class()
            s.node_register(n)
            ops.append(n.id)
        print(f"phase 16 server: {N_NODES} nodes, {PHASE11_ALLOCS + 64} "
              f"allocs ingested in {t_ingest:.1f} s, {PHASE16_NODES} "
              f"{PHASE16_CLASS} nodes registered")

        # ---- (a) drain
        win, t0 = _LaunchWindow(kp, kr), time.perf_counter()
        job = _phase16_job(mock, Constraint, PHASE16_COUNT)
        jobs = [job] + [_phase16_job(mock, Constraint, PHASE16_NEIGHBOUR)
                        for _ in range(PHASE16_NEIGHBOURS)]
        want = {j.id: j.task_groups[0].count for j in jobs}
        for j in jobs:
            j.task_groups[0].migrate_strategy = MigrateStrategy(
                max_parallel=want[j.id])
        _wait_evals(s, [s.job_register(j) for j in jobs], timeout=120.0)

        def lives():
            return {j.id: _phase16_ack(s, j.id) for j in jobs}

        _until(lambda: all(
            len(v) == want[k] and all(a.client_status == "running"
                                      for a in v)
            for k, v in lives().items()), 60.0, "phase 16 (a): jobs running")
        by_node = collections.Counter(
            a.node_id for a in _phase16_ack(s, job.id))
        drained = [nid for nid, _n in by_node.most_common(PHASE16_DRAIN)]
        before = {a.id for v in lives().values() for a in v}
        moved = {a.id for v in lives().values() for a in v
                 if a.node_id in drained}
        for nid in drained:
            s.node_update_drain(nid, DrainStrategy(deadline_s=30.0))

        def drained_clean():
            return all(len(v) == want[k]
                       and all(a.client_status == "running"
                               and a.node_id not in drained for a in v)
                       for k, v in lives().items())

        _until(drained_clean, 60.0, "phase 16 (a): allocs off the drain")
        _until(lambda: all(s.state.node_by_id(nid).drain is None
                           for nid in drained), 30.0,
               "phase 16 (a): drains complete")
        for nid in drained:
            node = s.state.node_by_id(nid)
            if node.scheduling_eligibility != "ineligible":
                raise AssertionError(f"phase 16 (a): node {nid} is "
                                     f"{node.scheduling_eligibility}")
        for aid in moved:
            if not s.state.alloc_by_id(aid).terminal_status():
                raise AssertionError(f"phase 16 (a): alloc {aid} on a "
                                     "drained node still live")
        live = {a.id for v in lives().values() for a in v}
        if (len(live - before) != len(moved)
                or live & before != before - moved):
            raise AssertionError(f"phase 16 (a): {len(live - before)} "
                                 f"replacements for {len(moved)} allocs, "
                                 f"{len(live & before)} of "
                                 f"{len(before - moved)} others kept")
        close(win, "a", t0)
        print(f"phase 16 (a): {len(moved)} allocs of {len(jobs)} jobs on "
              f"{len(drained)} drained nodes replaced on "
              f"{len(set(ops) - set(drained))} others; {len(live)} running")

        # ---- (b) deployment: canary, promotion, auto-revert
        win, t0 = _LaunchWindow(kp, kr), time.perf_counter()
        v1 = copy.deepcopy(s.state.job_by_id("default", job.id))
        tg = v1.task_groups[0]
        tg.update = UpdateStrategy(max_parallel=2, canary=1,
                                   min_healthy_time_s=0.0)
        v1.update = tg.update
        tg.tasks[0].env = {"v": "1"}
        s.job_register(v1)
        d1 = _until(lambda: s.state.latest_deployment_by_job(
            "default", job.id), 30.0, "phase 16 (b): v1 deployment")
        d1, promoted = _phase16_deploy(s, job.id, d1.id, "(b) v1")
        stable = s.state.latest_stable_job("default", job.id)
        if (d1.status != DEPLOYMENT_STATUS_SUCCESSFUL or not promoted
                or stable is None or stable.version != d1.job_version):
            raise AssertionError(f"phase 16 (b): v1 deployment {d1.status}"
                                 f" promoted {promoted}, stable "
                                 f"{stable and stable.version}")
        live = _phase16_ack(s, job.id)
        if (len(live) != PHASE16_COUNT
                or any(a.job_version != d1.job_version for a in live)):
            raise AssertionError(f"phase 16 (b): {len(live)} live allocs "
                                 "after the rollout, not all of "
                                 f"version {d1.job_version}")
        v2 = copy.deepcopy(s.state.job_by_id("default", job.id))
        tg = v2.task_groups[0]
        tg.update = UpdateStrategy(max_parallel=2, canary=1,
                                   min_healthy_time_s=0.0, auto_revert=True)
        v2.update = tg.update
        tg.tasks[0].env = {"v": "2"}
        s.job_register(v2)
        d2 = _until(lambda: (lambda d: d if d is not None
                                   and d.id != d1.id else None)(
            s.state.latest_deployment_by_job("default", job.id)), 30.0,
            "phase 16 (b): v2 deployment")
        canary = _until(lambda: [
            a for a in s.state.allocs_by_job("default", job.id)
            if a.deployment_id == d2.id and not a.terminal_status()], 30.0,
            "phase 16 (b): v2 canary")
        for a in canary:
            s.update_alloc_health(a.id, False)
        _until(lambda: s.state.deployment_by_id(d2.id).status
               == DEPLOYMENT_STATUS_FAILED, 30.0,
               "phase 16 (b): v2 deployment failed")
        reverted = _until(lambda: (lambda j: j if j.version
                                         > d2.job_version else None)(
            s.state.job_by_id("default", job.id)), 30.0,
            "phase 16 (b): auto-revert")
        if reverted.spec_changed(stable):
            raise AssertionError("phase 16 (b): the revert is not the "
                                 "stable version's spec")
        d3 = s.state.latest_deployment_by_job("default", job.id)
        if d3 is not None and d3.id not in (d1.id, d2.id) and d3.active():
            d3, _p = _phase16_deploy(s, job.id, d3.id, "(b) revert")
            if d3.status != DEPLOYMENT_STATUS_SUCCESSFUL:
                raise AssertionError(f"phase 16 (b): revert deployment "
                                     f"{d3.status}")
        _until(lambda: len(_phase16_ack(s, job.id)) == PHASE16_COUNT
               and not any(a.job_version == d2.job_version
                           for a in _phase16_ack(s, job.id)), 30.0,
               "phase 16 (b): the bad version's allocs gone")
        close(win, "b", t0)
        print(f"phase 16 (b): v{d1.job_version} rolled out (canary "
              f"promoted, stable), v{d2.job_version} failed and reverted "
              f"to v{stable.version}'s spec as v{reverted.version}")

        # ---- (c) periodic launch and core GC
        win, t0 = _LaunchWindow(kp, kr), time.perf_counter()
        pj = _phase16_job(mock, Constraint, 4, kind="batch")
        pj.periodic = PeriodicConfig(spec="0 0 1 1 *")
        if s.job_register(pj) is not None:
            raise AssertionError("phase 16 (c): a periodic job made an "
                                 "eval at register")
        ev = s.periodic.force(pj.namespace, pj.id)
        done = s.wait_for_eval(ev.id, timeout=60.0)
        child = s.state.job_by_id(pj.namespace, ev.job_id)
        kids = s.state.allocs_by_job("default", ev.job_id)
        if (done is None or done.status != "complete" or child is None
                or child.parent_id != pj.id or len(kids) != 4):
            raise AssertionError(f"phase 16 (c): child {ev.job_id}: eval "
                                 f"{done and done.status}, {len(kids)} of "
                                 "4 placed")
        for a in kids:
            upd = copy.copy(a)
            upd.client_status = "complete"
            s.state.update_alloc_from_client(upd)
        _phase16_ack(s, job.id)
        reap_evals, reap_allocs = set(), set()
        for e in s.state.evals():
            if e.status not in TERMINAL_EVAL:
                continue
            mine = [a for a in s.state.allocs_by_job(e.namespace, e.job_id)
                    if a.eval_id == e.id]
            if all(a.terminal_status() for a in mine):
                reap_evals.add(e.id)
                reap_allocs.update(a.id for a in mine)
        live = {a.id for a in s.state._allocs.values()
                if not a.terminal_status()}
        _, t_gc = _timed(lambda: s.run_gc("force-gc"))
        left = ([e for e in reap_evals if s.state.eval_by_id(e)]
                + [a for a in reap_allocs if s.state.alloc_by_id(a)])
        gone = [a for a in live if s.state.alloc_by_id(a) is None]
        if (left or gone or ev.id not in reap_evals
                or not {a.id for a in kids} <= reap_allocs):
            raise AssertionError(f"phase 16 (c): GC left {len(left)} of "
                                 f"{len(reap_evals)} evals and "
                                 f"{len(reap_allocs)} allocs, took "
                                 f"{len(gone)} live allocs")
        close(win, "c", t0)
        print(f"phase 16 (c): child {ev.job_id} placed 4 and completed; "
              f"force GC reaped {len(reap_evals)} evals and "
              f"{len(reap_allocs)} allocs in {t_gc * 1e3:.1f} ms, "
              f"{len(live)} live allocs kept")
    finally:
        s.shutdown()

    # ---- (d) the opt-out on the card
    t0 = time.perf_counter()
    on, on_attr, steps["d_on"] = _phase16_burst(torch, kp, kr, device,
                                                card, False)
    off, off_attr, steps["d_off"] = _phase16_burst(torch, kp, kr, device,
                                                   card, True)
    if set(on) != set(off):
        raise AssertionError("phase 16 (d): different allocs placed")
    # the opt-out took effect: attribution on every placement with
    # explain on, on none with NOMAD_TPU_EXPLAIN=0
    if on_attr != len(on) or off_attr:
        raise AssertionError(f"phase 16 (d): attribution on {on_attr} of "
                             f"{len(on)} placements with explain on, on "
                             f"{off_attr} of {len(off)} opted out")
    diffs = [k for k in on if on[k] != off[k]]
    if diffs:
        raise AssertionError(f"phase 16 (d): {len(diffs)} placements differ"
                             f" with the opt-out: {diffs[:4]}")
    print(f"phase 16 (d): {len(on)} placements, nodes and scores bitwise "
          f"equal with NOMAD_TPU_EXPLAIN unset and =0, the kernel's "
          f"attribution on all of them unset and on none at =0; "
          f"{time.perf_counter() - t0:.2f} s; {card}")

    total = {k: sum(w[k] for w in steps.values())
             for k in ("k1", "chain", "wave", "insert", "k7")}
    for k in ("chain", "wave"):
        total[f"{k}_kernels"] = sum(w["kernels"][k] for w in steps.values())
    missing = [k for k in ("k1", "chain", "insert", "k7") if not total[k]]
    if on_card and missing:
        raise AssertionError(f"phase 16: no {missing} launches: {total}")
    print(f"phase 16: launches {total}; took "
          f"{time.perf_counter() - t_phase:.1f} s; {card}")
    return {"steps": steps, "total": total}


#: phase 17: the bursts of phase 6's mix, the coverage the ledger must
#: reach of the allocator's growth, the cluster the planner predicts
#: (twice the phase's node count; few allocs: per-alloc residency is 0),
#: the prediction's tolerance, the sites one fused round books
PHASE17_BURSTS = 2
PHASE17_COVERAGE = 0.90
PHASE17_NODES = 20_000
PHASE17_ALLOCS = 2_000
PHASE17_PLAN_TOL = 0.15
PHASE17_SITES = ("stack.view_static", "stack.view_hot", "stack.view_ports",
                 "program_table.i32", "program_table.f32", "program_table.u8",
                 "select_batch.batch_out", "select_batch.carry")
#: the phases every eval's trace carries exactly once, in this order at its
#: ends (tests/test_telemetry.py TestE2ETrace)
EVAL_PHASES = ("queue_wait", "claim", "snapshot", "schedule", "plan_apply",
               "ack")


def _fresh_ledger(hbm):
    """Swap the process-global residency ledger for a fresh one (as the
    reference's tests do); returns (fresh, the one to put back)."""
    from nomad_tpu_torch.lib.metrics import MetricsRegistry

    saved = hbm._default_hbm
    hbm._default_hbm = hbm.HbmLedger(registry=MetricsRegistry())
    return hbm._default_hbm, saved


def _allocated(torch, on_card: bool):
    """The caching allocator's live bytes on the card, after a collection
    (None off the card)."""
    gc.collect()
    if not on_card:
        return None
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def _trace_ok(trace, what: str) -> bool:
    """One eval's trace complete and ordered: every phase of EVAL_PHASES
    once, queue_wait first and ack last, starts non-decreasing, plan apply
    inside schedule; a fused eval's pack inside its schedule. Returns
    whether the eval rode a fused dispatch (it carries a kernel span)."""
    if trace is None:
        raise AssertionError(f"{what}: no trace")
    spans = trace["spans"]
    phases = [sp["phase"] for sp in spans]
    for want in EVAL_PHASES:
        if phases.count(want) != 1:
            raise AssertionError(f"{what}: {want} {phases.count(want)} "
                                 f"times in {phases}")
    if phases[0] != "queue_wait" or phases[-1] != "ack":
        raise AssertionError(f"{what}: phases out of order {phases}")
    starts = [sp["start_s"] for sp in spans]
    if starts != sorted(starts):
        raise AssertionError(f"{what}: span starts out of order {starts}")
    by = {sp["phase"]: sp for sp in spans}
    sched, pa = by["schedule"], by["plan_apply"]
    if (pa["start_s"] < sched["start_s"]
            or pa["start_s"] + pa["duration_ms"] / 1e3
            > sched["start_s"] + sched["duration_ms"] / 1e3 + 1e-6):
        raise AssertionError(f"{what}: plan_apply outside schedule")
    fused = "kernel" in by
    if fused and ("pack" not in by
                  or by["pack"]["start_s"] < sched["start_s"]):
        raise AssertionError(f"{what}: a kernel span without its pack "
                             f"inside schedule: {phases}")
    return fused


def _phase17_residency(torch, kp, kr, device=None, card=""):
    """Residency and traces on the card (the docstring's phase 17): the
    ledger against the allocator, the planner against an upload of twice
    the nodes, the eval traces, timeline and instruments of two bursts.
    Returns the bursts' launch window and the phase's numbers."""
    from nomad_tpu_torch.analysis.vocab import ALLOWED_SITES
    from nomad_tpu_torch.lib import hbm
    from nomad_tpu_torch.scheduler.stack import TorchStack
    from nomad_tpu_torch.server import Server, ServerConfig
    from nomad_tpu_torch.synth import build_synthetic_state
    from nomad_tpu_torch.tensor.cluster import _bucket

    t_phase = time.perf_counter()
    on_card = device is None or torch.device(device).type == "cuda"
    out = {}
    led, saved = _fresh_ledger(hbm)
    try:
        # ---- (a) the ledger against the allocator's growth ----
        in_use0 = _allocated(torch, on_card)
        s = Server(ServerConfig(num_schedulers=1, heartbeat_ttl=3600.0,
                                gc_interval=3600.0, eval_batch=16),
                   device=device)
        try:
            _ingest(s, random.Random(SEED + 171), PHASE11_ALLOCS)
            s.start()
            rng = random.Random(SEED + 172)
            win = _LaunchWindow(kp, kr)
            seq0 = s.timeline.last_index()
            evs, t0 = [], time.perf_counter()
            for burst in range(PHASE17_BURSTS):
                jobs, dh = _mix(rng, 64)
                burst_evs = [s.job_register(j) for j in jobs]
                _wait_evals(s, burst_evs)
                _placed(s, jobs, dh, f"phase 17 burst {burst}")
                evs += burst_evs
            wall = time.perf_counter() - t0
            window = win.close("phase 17 (a) bursts", on_card)
            if on_card:
                torch.cuda.synchronize()
            rec = hbm.reconcile(led)
            snap = led.snapshot()
            sites = set(snap)
            growth = (None if in_use0 is None
                      else rec["device_bytes_in_use"] - in_use0)
            live = rec["ledger_live_bytes"]
            coverage = live / growth if growth else None
            for site, row in sorted(snap.items()):
                print(f"phase 17 (a) site {site}: live {row['live_bytes']} "
                      f"B, peak {row['peak_bytes']} B, {row['buffers']} "
                      f"buffers, rows {row['rows']}")
            print(f"phase 17 (a): {len(evs)} evals in {wall:.2f} s "
                  f"({len(evs) / wall:.2f} evals/s); the ledger's live "
                  f"bytes {live}, the allocator's growth {growth} "
                  f"(in use {rec['device_bytes_in_use']}), coverage "
                  + (f"{100.0 * coverage:.2f} %" if coverage is not None
                     else "not measured (no card)") + f"; {card}")
            missing = set(PHASE17_SITES) - sites
            if missing:
                raise AssertionError(f"phase 17 (a): sites not booked "
                                     f"{sorted(missing)}")
            if not sites <= ALLOWED_SITES:
                raise AssertionError(f"phase 17 (a): sites outside the "
                                     f"vocabulary {sites - ALLOWED_SITES}")
            if on_card and (coverage is None
                            or coverage < PHASE17_COVERAGE):
                raise AssertionError(
                    f"phase 17 (a): the ledger covers {live} B of "
                    f"{growth} B the allocator grew by, under "
                    f"{PHASE17_COVERAGE:.0%}")

            # ---- (c) traces, the timeline and the instruments ----
            fused = sum(_trace_ok(s.tracer.get(ev.id), f"eval {ev.id}")
                        for ev in evs)
            if not fused:
                raise AssertionError("phase 17 (c): no eval carried a "
                                     "kernel span")
            _i, recs = s.timeline.records_after(seq0)
            open_ = [r["seq"] for r in recs if r["kernel_ms"] is None]
            if not recs or open_:
                raise AssertionError(f"phase 17 (c): {len(recs)} dispatches,"
                                     f" not ended on the timeline {open_}")
            summ = s.timeline.summary()
            qs = s.broker.queue_stats()
            depths = {k: qs[k] for k in ("ready_total", "unacked",
                                         "pending_jobs", "delayed")}
            partial = s.metrics.snapshot()["gauges"].get(
                "plan_apply.partial_rate")
            if any(depths.values()) or partial != 0:
                raise AssertionError(f"phase 17 (c): broker depths {depths},"
                                     f" plan_apply.partial_rate {partial}")
            print(f"phase 17 (c): {len(evs)} traces complete and ordered, "
                  f"{fused} with pack and kernel spans; {len(recs)} "
                  f"dispatches committed and ended; timeline overlap "
                  f"{summ['overlap_ms_total']} ms ({summ['overlap_pct']} %), "
                  f"wasted {summ['spec']['wasted_kernel_ms']} ms, bubble "
                  f"{summ['bubble_ms_total']} ms, speculation {summ['spec']};"
                  f" broker depths {depths}, plan_apply.partial_rate "
                  f"{partial}; K4 {window['chain']} "
                  f"({window['kernels']['chain']} launches), K5 "
                  f"{window['wave']} ({window['kernels']['wave']}), K7 "
                  f"{window['k7']}, K8 {window['insert']}; {card}")

            # ---- (b) the planner against an upload of twice the nodes ----
            TorchStack(s.state.cluster, device=s.device).device_arrays()
            gc.collect()
            plan = hbm.plan_capacity(PHASE17_NODES, PHASE17_ALLOCS, led)
            big = hbm.plan_capacity(100_000, 1_000_000, led)
        finally:
            s.shutdown()
        if plan["projected_n_cap"] != _bucket(PHASE17_NODES):
            raise AssertionError(f"phase 17 (b): {plan}")
        state, _nodes = build_synthetic_state(PHASE17_NODES, PHASE17_ALLOCS,
                                              seed=SEED + 173)
        led_b, _ = _fresh_ledger(hbm)
        in_use1 = _allocated(torch, on_card)
        view = TorchStack(state.cluster, device=device).device_arrays()
        in_use2 = _allocated(torch, on_card)
        measured = led_b.totals()[0]
        predicted = plan["projected_bytes"]
        err = abs(predicted - measured) / measured
        grew = None if in_use1 is None else in_use2 - in_use1
        print(f"phase 17 (b): plan for {PHASE17_NODES} nodes: n_cap "
              f"{plan['projected_n_cap']}, {plan['per_node_bytes']} B a node "
              f"row, predicted {predicted} B; uploaded {measured} B "
              f"booked ({100.0 * err:.2f} % off), the allocator grew by "
              f"{grew} B; plan for 100000 nodes / 1000000 allocs: "
              f"{big['projected_bytes']} B of {big['device_limit_bytes']} "
              f"({big['limit_source']}), fits {big['fits']}, shards "
              f"{big['shards_needed']}; {card}")
        if err > PHASE17_PLAN_TOL:
            raise AssertionError(f"phase 17 (b): predicted {predicted} B, "
                                 f"measured {measured} B")
        if on_card and (big["limit_source"] != "memory_stats"
                        or not big["fits"]):
            raise AssertionError(f"phase 17 (b): {big}")
        del view
        out.update(window=window, coverage=coverage, growth=growth,
                   live=live, predicted=predicted, measured=measured,
                   plan_err=err, grew=grew, evals_per_s=len(evs) / wall,
                   overlap_ms=summ["overlap_ms_total"],
                   wasted_ms=summ["spec"]["wasted_kernel_ms"],
                   bubble_ms=summ["bubble_ms_total"])
    finally:
        hbm._default_hbm = saved
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 17 took {out['wall_s']:.1f} s")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; "
              "this script needs an NVIDIA card", file=sys.stderr)
        return 1

    from nomad_tpu_torch import mock, native
    from nomad_tpu_torch.convert import params_from_numpy, tensor_from_numpy
    from nomad_tpu_torch.kernels import _build
    from nomad_tpu_torch.kernels import placement as kp
    from nomad_tpu_torch.kernels import preemption as kpre
    from nomad_tpu_torch.kernels import rows as kr
    from nomad_tpu_torch.kernels import shard as ks
    from nomad_tpu_torch.lib import roofline
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
    global PEAKS
    peak_flops, peak_bw, _kind = roofline.device_peaks(torch.device("cuda", 0))
    if peak_flops is None:
        raise RuntimeError(f"{kind}: no published peaks in "
                           "nomad_tpu_torch/lib/roofline.py DEVICE_PEAKS; "
                           "every bound would be against another card's")
    PEAKS = (peak_flops, peak_bw)
    print(f"roofline peaks of {kind}: {peak_flops:.4g} fp32 FLOP/s, "
          f"{peak_bw:.4g} HBM bytes/s (datasheet)")

    # ---- 2. build ----
    t0 = time.perf_counter()
    sources = ("placement", "chain", "lanes", "batch", "rows", "system",
               "preempt", "shard")
    # the host core (g++) builds beside the kernels: later phases assign
    # dynamic ports through it
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        host_core = pool.submit(native.available)
        _build.build_all(sources)
        host_core.result()
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
    k1_cost = roofline.kernel_cost("place_task_group", cluster=arrays,
                                   program=p, m=m, sel=k1_res.sel_idx,
                                   explain=True)
    bound_ms, bound_by = _roof(k1_cost)
    print(f"timing (N={arrays.capacity.shape[0]}, M={m}, explain on; "
          f"{smi[0]}): lane route {kernel_ms:.4f} ms, placement.cu "
          f"{k1['placement.cu']['events']:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.6f} ms ({bound_by}); explain off: lane route "
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

    # ---- 11. persistence and consensus: the durable server, a region ----
    t0 = time.perf_counter()
    durable = _phase11_durable(torch, kp, kr, card=smi[0])
    region = _phase11_region(torch, kp, kr, card=smi[0])
    p11 = _sum_launches(durable["windows"] + region["windows"])
    print(f"phase 11: durable server {durable['evals_per_s']:.2f} evals/s "
          f"(plan apply share {durable['plan_apply_share']:.3f}), region "
          f"{region['evals_per_s']:.2f} evals/s through a follower (plan "
          f"apply share {region['plan_apply_share']:.3f}; new leader "
          f"{region['failover_evals_per_s']:.2f}); launches {p11}; "
          f"{smi[0]}; took {time.perf_counter() - t0:.1f} s")

    # ---- 12. the client and its plugins on the card's host ----
    p12 = _phase12_clients(torch, kp, kr, card=smi[0])["window"]

    # ---- 13. the agent, its HTTP API and the CLI ----
    agent13 = _phase13_agent(torch, kp, kr, card=smi[0])
    p13 = agent13["window"]

    # ---- 14. the lint engine over the port ----
    _phase14_lint(card=smi[0])

    kernels = [{
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
        "phase13_launches": agent13["k1"],
        "peak_mib": k1["lane"]["peak"],
        "placement_cu_ms": k1["placement.cu"]["events"],
        "placement_cu_span_ms": k1["placement.cu"]["span"],
        "placement_cu_explain_off_ms": k1_off["placement.cu"]["events"],
        "placement_cu_peak_mib": k1["placement.cu"]["peak"],
        "cost": k1_cost,
    }, {
        "name": "place_table_chain",
        "route": "cuda",
        "source": "nomad_tpu_torch/kernels/csrc/lanes.cu",
        "replaces": "nomad_tpu/kernels/placement.py:754",
        "calls": server["launches"]["chain"],
        "launches": server["kernels"]["chain"],
        "max_abs_err": max(k5["err"]["chain"], server["err"]["chain"]),
        **k5["chain"],
        "phase11_calls": p11["chain"],
        "phase11_launches": p11["chain_kernels"],
        "phase12_calls": p12["chain"],
        "phase12_launches": p12["kernels"]["chain"],
        "phase13_calls": p13["chain"],
        "phase13_launches": p13["kernels"]["chain"],
    }, {
        "name": "place_table_wave",
        "route": "cuda",
        "source": "nomad_tpu_torch/kernels/csrc/lanes.cu",
        "replaces": "nomad_tpu/kernels/placement.py:878",
        "calls": server["launches"]["wave"],
        "launches": server["kernels"]["wave"],
        "max_abs_err": max(k5["err"]["wave"], server["err"]["wave"]),
        **k5["wave"],
        "phase11_calls": p11["wave"],
        "phase11_launches": p11["wave_kernels"],
        "phase12_calls": p12["wave"],
        "phase12_launches": p12["kernels"]["wave"],
        "phase13_calls": p13["wave"],
        "phase13_launches": p13["kernels"]["wave"],
    }, {
        "name": "program_table_insert",
        "route": "cuda",
        "source": "nomad_tpu_torch/kernels/csrc/rows.cu",
        "replaces": "nomad_tpu/server/program_table.py:99",
        "launches": server["launches"]["insert"],
        "max_abs_err": k5["err"]["insert"],
        **k5["insert"],
        "phase11_launches": p11["insert"],
        "phase12_launches": p12["insert"],
        "phase13_launches": p13["insert"],
    }, {
        "name": "view_row_delta",
        "route": "cuda",
        "source": "nomad_tpu_torch/kernels/csrc/rows.cu",
        "replaces": "nomad_tpu/scheduler/stack.py:115",
        "launches": server["launches"]["k7"],
        "max_abs_err": slice_["k7_err"],
        **slice_["k7"],
        "phase11_launches": p11["k7"],
        "phase12_launches": p12["k7"],
        "phase13_launches": p13["k7"],
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
    }]

    # ---- 15. the host core and the roofline ----
    _phase15_host_core(torch, kp, kernels, card=smi[0])

    # ---- 16. the operator's lifecycle on the card ----
    p16 = _phase16_operator(torch, kp, kr, card=smi[0])["total"]
    kernels[0]["phase16_launches"] = p16["k1"]
    for entry, key in ((kernels[1], "chain"), (kernels[2], "wave")):
        entry["phase16_calls"] = p16[key]
        entry["phase16_launches"] = p16[f"{key}_kernels"]
    kernels[3]["phase16_launches"] = p16["insert"]
    kernels[4]["phase16_launches"] = p16["k7"]

    # ---- 17. residency and traces on the card ----
    p17 = _phase17_residency(torch, kp, kr, card=smi[0])["window"]
    for entry, key in ((kernels[1], "chain"), (kernels[2], "wave")):
        entry["phase17_calls"] = p17[key]
        entry["phase17_launches"] = p17["kernels"][key]
    kernels[3]["phase17_launches"] = p17["insert"]
    kernels[4]["phase17_launches"] = p17["k7"]

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
