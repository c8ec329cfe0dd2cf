"""The port's server on a device mesh: the server half of the sharded path.

A twin of the reference's `TestServerPathMesh` (`tests/test_parallel.py`):
the port's `Server` with `mesh=make_mesh(4, devices=["cpu"] * 4)` (a
(2, 2) mesh of CPU shards) keeps a node-sharded view and runs its
coordinator's packed chain (B10), single program (B11) and the system
scheduler's masks (B12) on the shards. It must place alloc by alloc as the
port's unsharded `Server` and the reference's unsharded `Server` do, with
the batch path engaged. After the service feed, a system job's eval and a
service preemption eval run on the same servers and must give the same
plans with and without the mesh; the preemption retry ranks on an
unsharded snapshot on the server's device, as the reference's does.

Plumbing: `mesh="env"` installs `mesh_from_env`'s mesh; shutdown removes
the mesh it installed but not a newer server's; a mesh whose lead device
is not the server's raises; `NOMAD_TPU_MESH` asks for cards and raises
without one. Under a mesh the table path and speculation stay off: no
dynamic-row upload, no `spec.*` launch. Every server here uninstalls its
mesh in `finally` (the active mesh is process-global).
"""
import random
import time

import numpy as np
import pytest

from nomad_tpu.structs.codec import to_wire
from nomad_tpu.synth import synth_node, synth_service_job, synth_system_job
from torch_chain_cases import one_torch_thread  # noqa: F401

from nomad_tpu_torch.kernels import shard as ks
from nomad_tpu_torch.kernels.placement import ClusterArrays
from nomad_tpu_torch.lib.transfer import default_ledger
from nomad_tpu_torch.parallel import (get_active_mesh, make_mesh,
                                      set_active_mesh)
from nomad_tpu_torch.scheduler import preemption as tpre
from nomad_tpu_torch.scheduler.util import SchedulerConfiguration
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.structs.codec import from_wire

FINAL = ("complete", "failed", "blocked", "cancelled")


def _port(obj):
    return from_wire(to_wire(obj))


def _feed(seed=11, n_nodes=32, n_jobs=10):
    """The reference test's feed: 32 synthetic nodes and ten service jobs
    of count 2, then a system job (both packages get these objects)."""
    rng = random.Random(seed)
    nodes = [synth_node(rng, i) for i in range(n_nodes)]
    jobs = [synth_service_job(rng, count=2) for _ in range(n_jobs)]
    return nodes, jobs, synth_system_job(rng)


def _placements(s, jobs):
    names = {nid: nd.name for nid, nd in s.state._nodes.items()}
    out = {}
    for ji, j in enumerate(jobs):
        for a in s.state.allocs_by_job("default", j.id):
            out[(ji, a.name.rsplit("[", 1)[1])] = names.get(a.node_id,
                                                            a.node_id)
    return out


def _wait(s, ev):
    got = s.wait_for_eval(ev.id, statuses=FINAL, timeout=120.0)
    assert got is not None and got.status == "complete", got


def _preempt_job(cl):
    """A priority-100 service job of one alloc asking one cpu more than
    the most free room of any node: it places only by eviction."""
    import numpy as np

    from nomad_tpu_torch.synth import synth_service_job as t_service_job

    live = np.asarray(cl.node_ok[:cl.n_cap], dtype=bool)
    free = cl.capacity[:cl.n_cap, 0] - cl.used[:cl.n_cap, 0]
    job = t_service_job(random.Random(5), count=1)
    job.id = job.name = "preemptor"
    job.priority = 100
    res = job.task_groups[0].tasks[0].resources
    res.cpu, res.memory_mb = int(free[live].max()) + 1, 64
    return job


def _port_run(mesh, system=True):
    """The feed through the port's Server (on `mesh`, or unsharded);
    returns (service placements, system placements, the preemption's
    (node, victims), worker batch stats, registry counters, ledger
    moves, sharded route calls, the retry's ranked views)."""
    with pytest.MonkeyPatch.context() as mp:
        return _run_counted(mesh, system, mp)


def _run_counted(mesh, system, monkeypatch):
    calls = {"packed": 0, "single": 0, "system": 0}
    for name, key in (("sharded_packed_chain", "packed"),
                      ("sharded_task_group", "single"),
                      ("sharded_system_feasibility", "system")):
        real = getattr(ks, name)

        def counted(*a, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(ks, name, counted)
    ranked = []
    real_ranked = tpre.ranked_snapshot

    def recording(cluster):
        out = real_ranked(cluster)
        ranked.append((out, cluster.n_cap))
        return out

    monkeypatch.setattr(tpre, "ranked_snapshot", recording)
    nodes, jobs, sys_job = _feed()
    led0 = default_ledger().snapshot()
    s = Server(ServerConfig(num_schedulers=1, heartbeat_ttl=3600.0,
                            eval_batch=8, mesh=mesh), device="cpu")
    try:
        assert get_active_mesh() is mesh
        for n in nodes:
            s.state.upsert_node(_port(n))
        jobs = [_port(j) for j in jobs]
        evs = [s.job_register(j) for j in jobs]
        s.start()
        for ev in evs:
            _wait(s, ev)
        service = _placements(s, jobs)
        deadline = time.time() + 10.0
        while time.time() < deadline \
                and not s.workers[0].batch_stats.get("evals"):
            time.sleep(0.05)   # finish_batch writes its counters last
        wstats = dict(s.workers[0].batch_stats)
        sys_out = preempt = None
        if system:
            sj = _port(sys_job)
            _wait(s, s.job_register(sj))
            sys_out = _placements(s, [sj])
            s.state.set_scheduler_config(
                SchedulerConfiguration(preemption_service_enabled=True))
            pj = _preempt_job(s.state.cluster)
            _wait(s, s.job_register(pj))
            (a,) = s.state.allocs_by_job("default", pj.id)
            # victims by job (its place in the feed; the job ids are fresh
            # each run) and alloc index
            label = {j.id: str(i) for i, j in enumerate(jobs)}
            label[sj.id] = "system"
            victims = sorted(
                (label[v.job_id], v.name.rsplit("[", 1)[1])
                for v in map(s.state.alloc_by_id, a.preempted_allocations))
            assert victims
            preempt = (s.state.node_by_id(a.node_id).name, victims)
        counters = s.metrics.counters()
    finally:
        s.shutdown()
        set_active_mesh(None)
    assert get_active_mesh() is None
    led = default_ledger().snapshot()
    moved = {site: led[site]["count"] - led0.get(site, {}).get("count", 0)
             for site in led}
    return (service, sys_out, preempt, wstats, counters, moved, calls,
            ranked)


def _ref_run():
    """The reference's unsharded Server on the same service feed."""
    from nomad_tpu.server import Server as RefServer
    from nomad_tpu.server import ServerConfig as RefConfig

    nodes, jobs, _sys = _feed()
    s = RefServer(RefConfig(num_schedulers=1, heartbeat_ttl=3600.0,
                            eval_batch=8))
    try:
        for n in nodes:
            s.state.upsert_node(n)
        evs = [s.job_register(j) for j in jobs]
        s.start()
        for ev in evs:
            _wait(s, ev)
        return _placements(s, jobs)
    finally:
        s.shutdown()


def _cpu_mesh():
    mesh = make_mesh(4, devices=["cpu"] * 4)
    assert mesh.devices.shape == (2, 2)
    return mesh


def test_server_sharded_equals_single_device():
    """The meshed port server places alloc by alloc as the unsharded port
    server and the reference's unsharded server; the batch path engaged
    on the sharded chain; the system and preemption evals give the same
    plans with and without the mesh."""
    base = _port_run(None)
    meshed = _port_run(_cpu_mesh())
    ref = _ref_run()
    assert base[0] and set(base[0]) == set(meshed[0]) == set(ref)
    for k in ref:
        assert base[0][k] == meshed[0][k] == ref[k], k
    assert meshed[3].get("batched", 0) > 0, meshed[3]
    assert base[1] == meshed[1] and meshed[1]
    assert base[2] == meshed[2]
    calls = meshed[6]
    assert all(calls.values()), calls
    assert base[6] == {"packed": 0, "single": 0, "system": 0}
    # the preemption retry ranked an unsharded snapshot: the host arrays
    # of every row of the cluster, not the sharded view
    assert meshed[7] and all(isinstance(r, ClusterArrays)
                             and isinstance(r.used, np.ndarray)
                             and r.used.shape[0] == n_cap
                             for r, n_cap in meshed[7])


def test_table_path_and_speculation_stay_off_under_a_mesh():
    """At the server's defaults the unsharded run dispatches through the
    program table (dynamic rows uploaded) and speculates; under the mesh
    neither engages: packed buffers only, no spec.* launch."""
    base = _port_run(None, system=False)
    meshed = _port_run(_cpu_mesh(), system=False)
    assert base[5].get("select_batch.dyn_rows", 0) > 0
    assert meshed[5].get("select_batch.dyn_rows", 0) == 0
    assert meshed[5].get("select_batch.pack_buffers", 0) > 0
    assert base[4].get("spec.launches", 0) > 0
    assert not any(v for k, v in meshed[4].items()
                   if k.startswith("spec.")), meshed[4]


def test_env_mesh_installs_and_shutdown_uninstalls(monkeypatch):
    """`mesh="env"` installs what `mesh_from_env` builds; shutdown
    removes it."""
    import nomad_tpu_torch.parallel.mesh as mesh_mod

    mesh = _cpu_mesh()
    monkeypatch.setattr(mesh_mod, "mesh_from_env", lambda: mesh)
    s = Server(ServerConfig(mesh="env"), device="cpu")
    try:
        assert get_active_mesh() is mesh
    finally:
        s.shutdown()
        set_active_mesh(None)
    assert get_active_mesh() is None


def test_env_mesh_unset_installs_nothing(monkeypatch):
    monkeypatch.delenv("NOMAD_TPU_MESH", raising=False)
    s = Server(ServerConfig(mesh="env"), device="cpu")
    try:
        assert get_active_mesh() is None
    finally:
        s.shutdown()


def test_env_mesh_without_a_card_raises(monkeypatch):
    """NOMAD_TPU_MESH asks for cards: without one it raises, it does not
    build a CPU mesh."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.setenv("NOMAD_TPU_MESH", "2")
    with pytest.raises(RuntimeError):
        Server(ServerConfig(mesh="env"), device="cpu")
    assert get_active_mesh() is None


def test_shutdown_keeps_a_newer_servers_mesh():
    first, second = _cpu_mesh(), _cpu_mesh()
    s1 = Server(ServerConfig(mesh=first), device="cpu")
    s2 = None
    try:
        s2 = Server(ServerConfig(mesh=second), device="cpu")
        s1.shutdown()
        assert get_active_mesh() is second
        s2.shutdown()
        assert get_active_mesh() is None
    finally:
        set_active_mesh(None)


def test_a_mesh_on_another_device_raises():
    mesh = make_mesh(2, devices=["meta", "meta"])
    with pytest.raises(ValueError, match="leads on"):
        Server(ServerConfig(mesh=mesh), device="cpu")
    assert get_active_mesh() is None


def _harness_run(mesh):
    """Three service evals through the port's Harness (the solo select:
    the sharded single program, B11, under a mesh); the placements by
    node name."""
    from nomad_tpu_torch.scheduler.harness import Harness
    from nomad_tpu_torch.structs import Evaluation

    nodes, jobs, _sys = _feed(seed=17, n_nodes=24, n_jobs=3)
    h = Harness(device="cpu")
    for n in nodes:
        h.state.upsert_node(_port(n))
    set_active_mesh(mesh)
    try:
        jobs = [_port(j) for j in jobs]
        for j in jobs:
            h.state.upsert_job(j)
            h.process(Evaluation(namespace="default", priority=j.priority,
                                 type="service", job_id=j.id,
                                 status="pending"))
    finally:
        set_active_mesh(None)
    names = {n.id: n.name for n in nodes}
    return sorted((j_i, names[nid])
                  for plan in h.plans
                  for nid, allocs in plan.node_allocation.items()
                  for a in allocs
                  for j_i, j in enumerate(jobs) if a.job_id == j.id)


def test_harness_select_under_a_mesh_places_as_unsharded():
    """The solo `TorchStack.select` reads the sharded view and takes the
    sharded single program (B11): the same placements as without a mesh."""
    with pytest.MonkeyPatch.context() as mp:
        calls = []
        real = ks.sharded_task_group
        mp.setattr(ks, "sharded_task_group",
                   lambda *a, **kw: calls.append(1) or real(*a, **kw))
        meshed = _harness_run(_cpu_mesh())
    assert calls
    assert meshed and meshed == _harness_run(None)
