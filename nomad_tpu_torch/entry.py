"""Entry points of the port, the counterparts of the repository's
`__graft_entry__.py`.

`entry(device=None)` — one forward of the flagship computation, the fused
feasibility + scoring + selection placement kernel
(`kernels/placement.py`, replacing the reference scheduler's hot loop
`scheduler/stack.go:116` → `rank.go:188` → `structs/funcs.go:103,175`):
returns (fn, args) on the 48-node problem.

`dryrun_multichip(n_devices, devices=None)` — one full scheduler step
(batched placement + snapshot advance) over an n-device ("batch", "nodes")
mesh at the BASELINE node count: `shard_cluster` and `scheduler_step`
(the K9 kernel on cards, its plain version on `cpu` devices).

    python -c "from nomad_tpu_torch import entry; entry.dryrun_multichip(4)"
"""
from __future__ import annotations

import functools
import random
import time
from typing import NamedTuple, Optional, Sequence

from .device import DeviceLike, resolve_device


def _build_problem(n_nodes: int, n_allocs: int, n_evals: int, count: int,
                   device: DeviceLike = None, seed: int = 7):
    """Synthetic state + per-eval compiled placement programs (numpy)."""
    from .scheduler.stack import TorchStack
    from .synth import build_synthetic_state, synth_service_job

    state, _nodes = build_synthetic_state(n_nodes, n_allocs, seed=seed)
    rng = random.Random(seed + 1)
    stack = TorchStack(state.cluster, device=device)
    params_list, m = [], 1
    for i in range(n_evals):
        job = synth_service_job(
            rng, count=count,
            with_affinity=(i % 2 == 0), with_spread=(i % 3 == 0),
        )
        state.upsert_job(job)
        p, m = stack.compile_tg(job, job.task_groups[0], count)
        params_list.append(p)
    return state, stack, params_list, m


def entry(device: DeviceLike = None):
    """Return (fn, example_args): one placement-kernel forward."""
    from .convert import params_from_numpy
    from .kernels.placement import place_task_group

    dev = resolve_device(device)
    _state, stack, params_list, m = _build_problem(
        n_nodes=48, n_allocs=96, n_evals=1, count=4, device=dev)
    fn = functools.partial(place_task_group, max_allocs=m)
    return fn, (stack.device_arrays(), params_from_numpy(params_list[0], dev))


class DryRun(NamedTuple):
    """What one dry-run step read and produced."""

    mesh: object
    cluster: object       # the sharded view the step read
    batch: object         # the stacked programs (numpy)
    max_allocs: int
    new_cluster: object   # the advanced sharded view
    result: object        # PlacementResult, [evals, ...]
    server_stats: dict    # the meshed server's worker batch stats


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None,
                     batch: Optional[int] = None) -> DryRun:
    """Run one sharded scheduler step on an n-device mesh over `devices`
    (default: the visible cards; `batch` as `make_mesh` takes it) and
    check it placed something; then the live server on the same mesh
    (broker → worker batch drain → coordinator → the sharded chain →
    plan apply): 32 nodes and 8 service jobs of count 2 must give 16
    allocs through the batch path. The mesh is uninstalled at the end."""
    import torch

    from .parallel import (make_mesh, scheduler_step, shard_cluster,
                           stack_params)

    mesh = make_mesh(n_devices, batch=batch, devices=devices)
    batch = mesh.devices.shape[0]
    lead = resolve_device(mesh.devices[0, 0])
    # REALISTIC SCALE: the BASELINE 10K-node axis (bucketed to 16384 rows)
    # split over the node shards, so that no device holds the whole
    # cluster; ≥ 64 evals so the batch axis does real work.
    _state, stack, params_list, m = _build_problem(
        n_nodes=10_000, n_allocs=5_000, n_evals=max(batch * 8, 64), count=4,
        device=lead)
    cluster = shard_cluster(stack.device_arrays(), mesh)
    batched, m = stack_params(params_list)

    step = scheduler_step(mesh, max_allocs=m)
    new_cluster, result = step(cluster, batched)
    if lead.type == "cuda":
        torch.cuda.synchronize()

    n_evals = len(params_list)
    placed = int((result.sel_idx >= 0).sum())
    assert tuple(result.sel_idx.shape) == (n_evals, m)
    assert placed > 0, "dry run placed nothing"
    print(f"dryrun_multichip: mesh={mesh.shape} evals={n_evals} "
          f"placed={placed}/{n_evals * m}")

    # ---- the server path: the live control plane on the mesh, its view
    # cache sharded because the Server installed the mesh
    from .parallel import set_active_mesh
    from .server import Server, ServerConfig
    from .synth import synth_node, synth_service_job

    rng = random.Random(23)
    srv = Server(ServerConfig(num_schedulers=1, heartbeat_ttl=3600.0,
                              eval_batch=8, mesh=mesh), device=lead)
    try:
        for i in range(32):
            srv.state.upsert_node(synth_node(rng, i))
        jobs = [synth_service_job(rng, count=2) for _ in range(8)]
        evs = [srv.job_register(j) for j in jobs]
        srv.start()
        for ev in evs:
            got = srv.wait_for_eval(
                ev.id, statuses=("complete", "failed", "blocked",
                                 "cancelled"), timeout=180.0)
            assert got is not None and got.status == "complete", got
        n_allocs = sum(1 for j in jobs
                       for _a in srv.state.allocs_by_job("default", j.id))
        assert n_allocs == 16, f"expected 16 allocs, got {n_allocs}"
        # the worker writes its batch counters after the batch's evals
        # complete
        deadline = time.time() + 10.0
        while not srv.workers[0].batch_stats.get("evals") \
                and time.time() < deadline:
            time.sleep(0.01)
        wstats = dict(srv.workers[0].batch_stats)
        assert wstats.get("batched", 0) > 0, (
            f"fused chain path did not engage: {wstats}")
        print(f"dryrun_multichip server path: 8 jobs -> {n_allocs} allocs, "
              f"worker batch stats {wstats}")
    finally:
        srv.shutdown()
        set_active_mesh(None)
    return DryRun(mesh, cluster, batched, m, new_cluster, result, wstats)
