"""The port stands alone: no JAX, no reference package, no silent CPU.

- An AST scan of `nomad_tpu_torch/**` and `chip_smoke.py` finds no import
  of `jax` or of `nomad_tpu` / `nomad_tpu.*`, and no string constant
  (docstrings aside) that names a `nomad_tpu.*` module or starts one with
  `-m nomad_tpu`: a child the port launches runs the port's modules.
- With JAX made unimportable, a fresh interpreter imports the port and
  processes one eval on 16 nodes with device="cpu", a port `Server`
  schedules a batch of evals through the coordinator there, a Harness
  runs a system eval and a service eval whose placement takes the
  preemption retry, `entry.dryrun_multichip` runs its sharded step on
  four CPU shards, a port `Server` with a `data_dir` places an eval,
  restarts and keeps it, and a single-voter `ClusterServer` places an
  eval through its Raft log, and a port `Client` runs a `raw_exec` and an
  `exec` task to completion through executor children that are the
  port's.
- Importing the port's agent, its CLI, `python -m nomad_tpu_torch`, its
  lint engine (`nomad_tpu_torch.analysis`), its host core
  (`nomad_tpu_torch.native`, also assigning a dynamic port through it)
  and its roofline (`nomad_tpu_torch.lib.roofline`) loads neither torch
  nor JAX nor a reference module, so a CLI call stays a fast child process;
  with JAX and the reference package made unimportable,
  `python -m nomad_tpu_torch agent -dev -device cpu` takes
  an HCL job from `job run` to a running alloc through
  `python -m nomad_tpu_torch` children, then exits 0 on SIGINT with no
  child left.
- Every entry point defaults to the card and raises without one, the
  agent and `agent -dev` included.
"""
import ast
import os
import re
import signal
import socket
import subprocess
import sys
import time
import urllib.request
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


#: a reference module named in a string: `nomad_tpu.x`, or `-m nomad_tpu`
_REFERENCE_NAME = re.compile(r"\bnomad_tpu\.|-m\s+nomad_tpu\b")


def _docstrings(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                yield body[0].value


def _reference_names(source: str, filename: str = "<source>"):
    tree = ast.parse(source, filename=filename)
    docs = {id(d) for d in _docstrings(tree)}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs
                and _REFERENCE_NAME.search(node.value)):
            yield node.lineno, node.value


def test_no_string_names_a_reference_module():
    files = sorted((REPO / "nomad_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    bad = [f"{f.relative_to(REPO)}:{line}: {text!r}"
           for f in files
           for line, text in _reference_names(f.read_text(), str(f))]
    assert not bad, "\n".join(bad)


@pytest.mark.parametrize("source, flagged", [
    ('argv = [sys.executable, "-m", "nomad_tpu.plugins.executor"]', True),
    ('log = logging.getLogger("nomad_tpu.client")', True),
    ('cmd = f"python -m nomad_tpu agent {x}"', True),
    ('argv = ["-m", "nomad_tpu_torch.plugins.executor"]', False),
    ('"""Run as: python -m nomad_tpu.plugins.executor"""', False),
    ('def f():\n    """-m nomad_tpu.x"""\n    return "nomad_tpu_torch.y"',
     False),
])
def test_the_scan_sees_a_reference_child(source, flagged):
    assert bool(list(_reference_names(source))) is flagged


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


_NO_JAX_DURABLE = r"""
import sys, time
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
from nomad_tpu_torch import mock
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.cluster import ClusterServer, ClusterServerConfig
from nomad_tpu_torch.server.fsm import state_fingerprint

data_dir = sys.argv[1]


def durable():
    s = Server(ServerConfig(num_schedulers=1, heartbeat_ttl=3600.0,
                            gc_interval=3600.0, data_dir=data_dir,
                            fsync=True), device="cpu")
    s.start()
    return s


s = durable()
try:
    for _ in range(3):
        s.node_register(mock.node())
    job = mock.job()
    job.task_groups[0].count = 3
    done = s.wait_for_eval(s.job_register(job).id, timeout=60)
    assert done is not None and done.status == "complete", done
    fp = state_fingerprint(s.state)
finally:
    s.shutdown()
s = durable()
try:
    assert state_fingerprint(s.state) == fp
    assert len(s.state.allocs_by_job("default", job.id)) == 3
finally:
    s.shutdown()

c = ClusterServer(ClusterServerConfig(node_id="solo", num_schedulers=1,
                                      heartbeat_ttl=3600.0,
                                      gc_interval=3600.0), device="cpu")
c.start()
try:
    deadline = time.time() + 60
    while not (c.is_leader() and c.server._running):
        assert time.time() < deadline, "no leader"
        time.sleep(0.02)
    for _ in range(2):
        c.call("node_register", mock.node())
    job = mock.job()
    job.task_groups[0].count = 2
    done = c.server.wait_for_eval(c.call("job_register", job).id, timeout=60)
    assert done is not None and done.status == "complete", done
    assert len(c.state.allocs_by_job("default", job.id)) == 2
    assert c.raft.commit_index > 0
finally:
    c.shutdown()
assert not any(m.split(".")[0] in ("jax", "nomad_tpu")
               for m, mod in sys.modules.items() if mod is not None), \
    sorted(m for m in sys.modules if m.startswith(("jax", "nomad_tpu.")))
print("ok")
"""


def test_port_durable_server_and_region_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_DURABLE,
                           str(tmp_path / "data")], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("ok")


#: holds the executors of the run below to unprivileged isolation, so the
#: exec task makes no cgroup, namespace or mount on the host running it
_UNPRIVILEGED_SITE = """
from nomad_tpu_torch.plugins import isolation
_caps = isolation.capabilities
isolation.capabilities = lambda: {**_caps(), "cgroup": None,
                                  "namespaces": False, "chroot": False}
"""

_NO_JAX_CLIENT = r"""
import sys, time
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
from nomad_tpu_torch import mock
from nomad_tpu_torch.client import Client, ClientConfig, InProcConn
from nomad_tpu_torch.server import Server, ServerConfig

data_dir = sys.argv[1]
s = Server(ServerConfig(num_schedulers=1, heartbeat_ttl=3600.0,
                        gc_interval=3600.0), device="cpu")
s.start()
c = Client(InProcConn(s), ClientConfig(data_dir=data_dir,
                                       heartbeat_interval=0.5))
c.start()
try:
    job = mock.job()
    job.type = "batch"
    tg = job.task_groups[0]
    tg.count = 1
    tg.networks = []
    tg.restart_policy.attempts = 0
    raw, ex = tg.tasks[0], mock.job().task_groups[0].tasks[0]
    raw.name, ex.name = "raw", "ex"
    for t, driver in ((raw, "raw_exec"), (ex, "exec")):
        t.driver = driver
        t.resources.networks = []
        t.config = {"command": "/bin/sh", "args": [
            "-c", "tr '\\0' ' ' < /proc/$PPID/cmdline; echo"]}
    tg.tasks = [raw, ex]
    done = s.wait_for_eval(s.job_register(job).id, timeout=60)
    assert done is not None and done.status == "complete", done
    deadline = time.time() + 90
    while time.time() < deadline:
        (a,) = s.state.allocs_by_job("default", job.id)
        if a.client_status in ("complete", "failed"):
            break
        time.sleep(0.1)
    assert a.client_status == "complete", (a.client_status, a.task_states)
    for name in ("raw", "ex"):
        ts = a.task_states[name]
        assert ts.state == "dead" and not ts.failed, ts
        runner = c.allocs[a.id].task_runners[name]
        with open(f"{runner.logs_dir}/{name}.stdout.0") as f:
            parent = f.read()
        assert "-m nomad_tpu_torch.plugins.executor" in parent, parent
finally:
    c.shutdown()
    s.shutdown()
assert not any(m.split(".")[0] in ("jax", "nomad_tpu")
               for m, mod in sys.modules.items() if mod is not None), \
    sorted(m for m in sys.modules if m.startswith(("jax", "nomad_tpu.")))
print("ok")
"""


def test_port_client_runs_tasks_without_jax(tmp_path):
    """A raw_exec and an exec task, each printing its parent's command
    line: the executor that runs them is the port's."""
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_UNPRIVILEGED_SITE)
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(site), str(REPO)]))
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_CLIENT,
                           str(tmp_path / "client")], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=150)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("ok")


_LIGHT_IMPORT = r"""
import runpy, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
what = sys.argv[1]
if what == "__main__":
    sys.argv = ["nomad_tpu_torch", "version"]
    try:
        runpy.run_module("nomad_tpu_torch", run_name="__main__")
    except SystemExit as e:
        assert e.code == 0, e.code
elif what == "ports":
    # port assignment through the host core (built with g++ at first use)
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs.network import NetworkIndex
    from nomad_tpu_torch.structs.resources import NetworkResource, Port
    idx = NetworkIndex()
    idx.set_node(mock.node())
    offer, err = idx.assign_network(NetworkResource(
        mbits=10, dynamic_ports=[Port(label="http")]))
    assert err == "" and 20000 <= offer.dynamic_ports[0].value < 32000
elif what == "decode":
    # what a CLI call does with an answer: structs through the codec
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs.codec import from_wire, to_wire
    for obj in (mock.job(), mock.alloc(), mock.node(), mock.eval_()):
        assert from_wire(to_wire(obj)) == obj
else:
    __import__(what)
heavy = sorted(m for m, mod in sys.modules.items() if mod is not None
               and m.split(".")[0] in ("torch", "jax", "jaxlib",
                                       "nomad_tpu"))
assert not heavy, heavy
print("ok")
"""


@pytest.mark.parametrize("module", ["nomad_tpu_torch.agent",
                                    "nomad_tpu_torch.cli", "__main__",
                                    "decode",
                                    "nomad_tpu_torch.analysis.__main__",
                                    "nomad_tpu_torch.native", "ports",
                                    "nomad_tpu_torch.lib.roofline"])
def test_agent_and_cli_import_neither_torch_nor_jax(module):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _LIGHT_IMPORT, module],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=60)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("ok")


#: a sitecustomize that makes JAX and the reference package unimportable
#: in every process started with it on PYTHONPATH
_NO_REFERENCE_SITE = """
import sys
for _m in ("jax", "jaxlib", "nomad_tpu"):
    sys.modules[_m] = None
"""

_AGENT_JOB = """
job "iso" {
  datacenters = ["dc1"]
  group "web" {
    count = 2
    task "t" {
      driver = "mock_driver"
      config { run_for = 600 }
      resources {
        cpu    = 100
        memory = 64
      }
    }
  }
}
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _children(pid):
    out = []
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            stat = (d / "stat").read_text()
        except OSError:
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
            out.append(int(d.name))
    return out


def test_agent_dev_on_cpu_runs_a_job_through_cli_children(tmp_path):
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_NO_REFERENCE_SITE)
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(site), str(REPO)]))
    env.pop("NOMAD_ADDR", None)
    spec = tmp_path / "iso.nomad"
    spec.write_text(_AGENT_JOB)
    port = _free_port()
    addr = f"http://127.0.0.1:{port}"
    agent = subprocess.Popen(
        [sys.executable, "-m", "nomad_tpu_torch", "agent", "-dev",
         "-device", "cpu", "-http-port", str(port),
         "-data-dir", str(tmp_path / "data")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)

    def cli(*argv):
        return subprocess.run(
            [sys.executable, "-m", "nomad_tpu_torch", "-address", addr,
             *argv], cwd=REPO, env=env, capture_output=True, text=True,
            timeout=60)

    try:
        deadline = time.time() + 60
        while True:
            assert agent.poll() is None, agent.communicate()[1][-4000:]
            try:
                with urllib.request.urlopen(f"{addr}/v1/agent/self",
                                            timeout=2) as r:
                    if r.status == 200:
                        break
            except OSError:
                pass
            assert time.time() < deadline, "agent HTTP never ready"
            time.sleep(0.1)
        run = cli("job", "run", str(spec))
        assert run.returncode == 0, run.stderr
        assert "Evaluation status: complete" in run.stdout, run.stdout
        deadline = time.time() + 60
        while True:
            status = cli("job", "status", "iso")
            assert status.returncode == 0, status.stderr
            rows = [ln.split() for ln in status.stdout.splitlines()
                    if ln.split()[-2:-1] == ["run"]]
            if len(rows) == 2 and all(r[-1] == "running" for r in rows):
                break
            assert time.time() < deadline, status.stdout
            time.sleep(0.2)
        alloc = cli("alloc", "status", rows[0][0])
        assert alloc.returncode == 0 and "running" in alloc.stdout, \
            alloc.stdout + alloc.stderr
        kids = _children(agent.pid)
    finally:
        agent.send_signal(signal.SIGINT)
        try:
            out, err = agent.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            agent.kill()
            out, err = agent.communicate()
    assert agent.returncode == 0, err[-4000:]
    assert "==> shutting down" in out, out
    left = [k for k in kids if Path(f"/proc/{k}").exists()]
    assert not left, left


def test_agent_dev_without_a_card_raises(tmp_path):
    """`agent -dev` at its default device, where torch sees no card:
    RuntimeError before anything is bound or written."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "nomad_tpu_torch", "agent", "-dev",
         "-http-port", str(_free_port()),
         "-data-dir", str(tmp_path / "data")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=60)
    assert proc.returncode != 0
    assert "RuntimeError" in proc.stderr and "CUDA" in proc.stderr, \
        proc.stderr[-4000:]
    assert "agent started" not in proc.stdout
    assert not (tmp_path / "data").exists()


def _entry_points(tmp):
    from nomad_tpu_torch.convert import cluster_from_numpy, params_from_numpy
    from nomad_tpu_torch.entry import entry
    from nomad_tpu_torch.parallel import make_mesh
    from nomad_tpu_torch.scheduler.generic import GenericScheduler
    from nomad_tpu_torch.scheduler.harness import Harness, InMemState
    from nomad_tpu_torch.scheduler.preemption import ranked_cluster
    from nomad_tpu_torch.scheduler.stack import TorchStack
    from nomad_tpu_torch.scheduler.system import SystemScheduler
    from nomad_tpu_torch.server import Server, ServerConfig
    from nomad_tpu_torch.server.cluster import (ClusterServer,
                                                ClusterServerConfig)
    from nomad_tpu_torch.server.program_table import DeviceProgramTable
    from nomad_tpu_torch.tensor.cluster import ClusterTensors

    cl = ClusterTensors()
    view = dict(capacity=cl.capacity, used=cl.used, node_ok=cl.node_ok,
                attrs=cl.attrs.astype(np.int16), ports_used=cl.ports_used,
                dyn_free=cl.dyn_free)
    state = InMemState()
    from nomad_tpu_torch.agent import Agent, AgentConfig

    return {
        "Agent": lambda: Agent(),
        "AgentDev": lambda: Agent(AgentConfig(data_dir=str(tmp))),
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
        "DurableServer": lambda: Server(ServerConfig(data_dir=str(tmp))),
        "ClusterServer": lambda: ClusterServer(ClusterServerConfig()),
        "DeviceProgramTable": lambda: DeviceProgramTable(),
        "entry": lambda: entry(),
        "make_mesh": lambda: make_mesh(),
    }


@pytest.mark.parametrize("name", ["Harness", "GenericScheduler",
                                  "SystemScheduler", "ranked_cluster",
                                  "TorchStack", "cluster_from_numpy",
                                  "params_from_numpy", "Server",
                                  "DurableServer", "ClusterServer",
                                  "DeviceProgramTable", "entry",
                                  "make_mesh", "Agent", "AgentDev"])
def test_entry_points_default_to_cuda_and_raise_without_it(
        name, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _entry_points(tmp_path / "data")[name]()
    # refused before anything is written or bound
    assert not (tmp_path / "data").exists()


def test_explicit_cpu_is_honoured():
    from nomad_tpu_torch.device import resolve_device
    from nomad_tpu_torch.scheduler.harness import Harness

    assert resolve_device("cpu") == torch.device("cpu")
    assert Harness(device="cpu").device == torch.device("cpu")
