"""The port stands alone: no JAX, no reference package, no silent CPU.

- An AST scan of `nomad_tpu_torch/**` and `chip_smoke.py` finds no import
  of `jax` or of `nomad_tpu` / `nomad_tpu.*`.
- With JAX made unimportable, a fresh interpreter imports the port and
  processes one eval on 16 nodes with device="cpu", a port `Server`
  schedules a batch of evals through the coordinator there, a Harness
  runs a system eval and a service eval whose placement takes the
  preemption retry, and `entry.dryrun_multichip` runs its sharded step on
  four CPU shards.
- Every entry point defaults to the card and raises without one.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "nomad_tpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


def test_port_imports_neither_jax_nor_the_reference_package():
    files = sorted((REPO / "nomad_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    bad = []
    for f in files:
        for line, mod in _imported_modules(f):
            if mod.split(".")[0] in FORBIDDEN:
                bad.append(f"{f.relative_to(REPO)}:{line}: {mod}")
    assert not bad, "\n".join(bad)


_NO_JAX_EVAL = r"""
import random, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
import nomad_tpu_torch
from nomad_tpu_torch import synth
from nomad_tpu_torch.scheduler.harness import Harness
from nomad_tpu_torch.structs import Evaluation

state, nodes = synth.build_synthetic_state(16, 48, seed=3)
job = synth.synth_service_job(random.Random(4), count=4, with_affinity=True,
                              with_spread=True, distinct_hosts=True)
state.upsert_job(job)
h = Harness(state, device="cpu")
h.process(Evaluation(namespace="default", priority=50, type="service",
                     job_id=job.id, status="pending"))
placed = [a for allocs in h.plans[0].node_allocation.values()
          for a in allocs]
assert len(placed) == 4, placed
assert len({a.node_id for a in placed}) == 4
assert h.evals[-1].status == "complete", h.evals[-1].status
assert not any(m.split(".")[0] in ("jax", "nomad_tpu")
               for m, mod in sys.modules.items() if mod is not None), \
    sorted(m for m in sys.modules if m.startswith(("jax", "nomad_tpu.")))
print("ok")
"""


def test_port_runs_an_eval_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_EVAL], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("ok")


_NO_JAX_SERVER = r"""
import random, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.synth import synth_node, synth_service_job

rng = random.Random(5)
s = Server(ServerConfig(num_schedulers=1, heartbeat_ttl=3600.0,
                        eval_batch=4), device="cpu")
try:
    for i in range(16):
        s.state.upsert_node(synth_node(rng, i))
    jobs = [synth_service_job(rng, count=2) for _ in range(4)]
    evs = [s.job_register(j) for j in jobs]
    s.start()
    for ev in evs:
        got = s.wait_for_eval(ev.id, statuses=("complete", "failed"),
                              timeout=60)
        assert got is not None and got.status == "complete", got
    assert sum(len(s.state.allocs_by_job("default", j.id))
               for j in jobs) == 8
finally:
    s.shutdown()
assert not any(m.split(".")[0] in ("jax", "nomad_tpu")
               for m, mod in sys.modules.items() if mod is not None), \
    sorted(m for m in sys.modules if m.startswith(("jax", "nomad_tpu.")))
print("ok")
"""


def test_port_server_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_SERVER], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("ok")


_NO_JAX_PREEMPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
from nomad_tpu_torch import mock
from nomad_tpu_torch.scheduler.harness import Harness
from nomad_tpu_torch.scheduler.util import SchedulerConfiguration

h = Harness(device="cpu")
h.state.set_scheduler_config(
    SchedulerConfiguration(preemption_service_enabled=True))
for _ in range(3):
    node = mock.node()
    h.state.upsert_node(node)
    low = mock.job(priority=1)
    h.state.upsert_job(low)
    a = mock.alloc(job=low, node_id=node.id, client_status="running",
                   allocated_resources=mock.alloc_resources(
                       cpu=3200, memory_mb=7256, disk_mb=10, networks=[]))
    a.task_group = low.task_groups[0].name
    h.state.upsert_alloc(a)

sys_job = mock.system_job(priority=50)
h.state.upsert_job(sys_job)
h.process(mock.eval_(job_id=sys_job.id, type="system", priority=50))
assert h.evals[-1].status == "complete", h.evals[-1].status
assert sum(len(v) for v in h.plans[-1].node_allocation.values()) == 3

job = mock.job(priority=100)
job.task_groups[0].count = 1
res = job.task_groups[0].tasks[0].resources
res.cpu, res.memory_mb, res.networks = 3000, 3000, []
job.task_groups[0].networks = []
h.state.upsert_job(job)
h.process(mock.eval_(job_id=job.id, type="service", priority=100))
plan = h.plans[-1]
placed = [a for v in plan.node_allocation.values() for a in v]
assert len(placed) == 1 and placed[0].preempted_allocations, placed
assert plan.carry_exact is False
assert not any(m.split(".")[0] in ("jax", "nomad_tpu")
               for m, mod in sys.modules.items() if mod is not None), \
    sorted(m for m in sys.modules if m.startswith(("jax", "nomad_tpu.")))
print("ok")
"""


def test_port_runs_system_and_preemption_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_PREEMPT], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("ok")


_NO_JAX_DRYRUN = r"""
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
import torch
torch.set_num_threads(2)
from nomad_tpu_torch import entry

run = entry.dryrun_multichip(4, devices=["cpu"] * 4)
assert run.mesh.shape == {"batch": 2, "nodes": 2}, run.mesh.shape
assert tuple(run.result.sel_idx.shape) == (64, run.max_allocs)
assert len(run.new_cluster.shards) == 2 and len(run.new_cluster.row0) == 2
assert bool((run.new_cluster.full().used >= run.cluster.full().used).all())
assert run.server_stats.get("batched", 0) > 0, run.server_stats
from nomad_tpu_torch.parallel import get_active_mesh
assert get_active_mesh() is None
assert not any(m.split(".")[0] in ("jax", "nomad_tpu")
               for m, mod in sys.modules.items() if mod is not None), \
    sorted(m for m in sys.modules if m.startswith(("jax", "nomad_tpu.")))
print("ok")
"""


def test_port_dryrun_multichip_without_jax():
    """The dry run's sharded step and its server half (the live server on
    the mesh) on four CPU shards, no JAX."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_DRYRUN], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "dryrun_multichip: mesh={'batch': 2, 'nodes': 2} evals=64" \
        in proc.stdout
    assert "dryrun_multichip server path: 8 jobs -> 16 allocs" in proc.stdout
    assert proc.stdout.strip().endswith("ok")


def _entry_points():
    from nomad_tpu_torch.convert import cluster_from_numpy, params_from_numpy
    from nomad_tpu_torch.entry import entry
    from nomad_tpu_torch.parallel import make_mesh
    from nomad_tpu_torch.scheduler.generic import GenericScheduler
    from nomad_tpu_torch.scheduler.harness import Harness, InMemState
    from nomad_tpu_torch.scheduler.preemption import ranked_cluster
    from nomad_tpu_torch.scheduler.stack import TorchStack
    from nomad_tpu_torch.scheduler.system import SystemScheduler
    from nomad_tpu_torch.server import Server
    from nomad_tpu_torch.server.program_table import DeviceProgramTable
    from nomad_tpu_torch.tensor.cluster import ClusterTensors

    cl = ClusterTensors()
    view = dict(capacity=cl.capacity, used=cl.used, node_ok=cl.node_ok,
                attrs=cl.attrs.astype(np.int16), ports_used=cl.ports_used,
                dyn_free=cl.dyn_free)
    state = InMemState()
    return {
        "Harness": lambda: Harness(),
        "GenericScheduler": lambda: GenericScheduler(state, None,
                                                     state.cluster),
        "SystemScheduler": lambda: SystemScheduler(state, None,
                                                   state.cluster),
        "ranked_cluster": lambda: ranked_cluster(cl),
        "TorchStack": lambda: TorchStack(cl),
        "cluster_from_numpy": lambda: cluster_from_numpy(view),
        "params_from_numpy": lambda: params_from_numpy({}),
        "Server": lambda: Server(),
        "DeviceProgramTable": lambda: DeviceProgramTable(),
        "entry": lambda: entry(),
        "make_mesh": lambda: make_mesh(),
    }


@pytest.mark.parametrize("name", ["Harness", "GenericScheduler",
                                  "SystemScheduler", "ranked_cluster",
                                  "TorchStack", "cluster_from_numpy",
                                  "params_from_numpy", "Server",
                                  "DeviceProgramTable", "entry",
                                  "make_mesh"])
def test_entry_points_default_to_cuda_and_raise_without_it(
        name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _entry_points()[name]()


def test_explicit_cpu_is_honoured():
    from nomad_tpu_torch.device import resolve_device
    from nomad_tpu_torch.scheduler.harness import Harness

    assert resolve_device("cpu") == torch.device("cpu")
    assert Harness(device="cpu").device == torch.device("cpu")
