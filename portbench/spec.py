"""The cell's inputs as plain data, drawn from the seed.

Frozen copy of the shapes of `nomad_tpu_torch/synth.py` (`synth_node`,
`synth_alloc`, `synth_service_job`, `build_synthetic_state`) as of commit
09e5296. Changes from the copy: every id is drawn from the seed (the
original draws `uuid4`); the cpu and memory asks of jobs and filler
allocs run through each of their pairs once a cycle, in an order drawn
from the seed, so that every seed gives the same set of sizes; the job's
stanzas are the configuration's; no node has devices. Plain Python: the port's objects are
built from this by `portbench/synth.py`, and the reference reads it as it
is.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from itertools import product
from typing import Dict, List, Optional, Tuple


@dataclass
class NodeSpec:
    index: int
    id: str
    name: str
    datacenter: str
    node_class: str
    cpu: int
    memory_mb: int
    disk_mb: int
    mbits: int
    rack: str

    def capacity(self, reserved: Dict[str, int]) -> Tuple[int, int, int]:
        """(cpu, memory MB, disk MB) left after the reserved part."""
        return (self.cpu - reserved["cpu"],
                self.memory_mb - reserved["memory_mb"],
                self.disk_mb - reserved["disk_mb"])


@dataclass
class JobSpec:
    index: int
    id: str
    type: str
    count: int
    cpu: int
    memory_mb: int
    disk_mb: int
    datacenters: Tuple[str, ...]
    constraints: Tuple[Tuple[str, str, str], ...]
    affinity: Optional[Dict] = None


@dataclass
class FillerAlloc:
    id: str
    node: int
    job: int
    cpu: int
    memory_mb: int
    disk_mb: int


@dataclass
class Spec:
    config: Dict
    workload: Dict
    seed: int
    nodes: List[NodeSpec]
    filler_jobs: List[JobSpec]
    filler_allocs: List[FillerAlloc]
    _job_rng: random.Random = field(repr=False, default=None)
    _asks: List[Tuple[int, int]] = field(repr=False, default_factory=list)
    jobs: List[JobSpec] = field(default_factory=list)

    @property
    def reserved(self) -> Dict[str, int]:
        return self.config["reserved"]

    def job(self, k: int) -> JobSpec:
        """The k-th job of the traffic (drawn in order, on first use)."""
        while len(self.jobs) <= k:
            self.jobs.append(self._draw_job(len(self.jobs)))
        return self.jobs[k]

    def _draw_job(self, k: int) -> JobSpec:
        cj = self.config["job"]
        if not self._asks:
            cycle = list(product(cj["cpu"], cj["memory_mb"]))
            self._job_rng.shuffle(cycle)
            self._asks = cycle
        cpu, mem = self._asks.pop()
        return JobSpec(
            index=k, id=f"pb-{self._job_rng.getrandbits(48):012x}-{k}",
            type=cj["type"], count=cj["count"], cpu=cpu, memory_mb=mem,
            disk_mb=cj["ephemeral_disk_mb"],
            datacenters=tuple(self.config["datacenters"]),
            constraints=tuple((c["ltarget"], c["operand"], c["rtarget"])
                              for c in cj["constraints"]),
            affinity=cj.get("affinity"))


def _uuid(rng: random.Random) -> str:
    h = f"{rng.getrandbits(128):032x}"
    return f"{h[:8]}-{h[8:12]}-4{h[13:16]}-{h[16:20]}-{h[20:]}"


def filler_count(config: Dict, workload: Dict) -> int:
    """Running allocs the cluster starts with, so that with the traffic's
    running jobs it holds the configuration's `running_allocs`."""
    return (config["running_allocs"]
            - workload["jobs_running"] * config["job"]["count"])


def make(config: Dict, workload: Dict, seed: int) -> Spec:
    """The nodes, the filler jobs and allocs, and the job stream of one
    cell and seed."""
    rng = random.Random(seed)
    dcs, classes = config["datacenters"], config["node_classes"]
    nodes = []
    for i in range(config["nodes"]):
        cls = classes[i % len(classes)]
        mult = config["class_multiplier"][cls]
        nodes.append(NodeSpec(
            index=i, id=_uuid(rng), name=f"node-{i}",
            datacenter=dcs[i % len(dcs)], node_class=cls,
            cpu=config["node_cpu_per_mult"] * mult,
            memory_mb=config["node_memory_mb_per_mult"] * mult,
            disk_mb=config["node_disk_mb"], mbits=config["node_mbits"],
            rack=f"r{i % 20}"))
    fill = config["filler"]
    n_allocs = filler_count(config, workload)
    filler_jobs = []
    for j in range(max(n_allocs // fill["allocs_per_job"], 1)):
        filler_jobs.append(JobSpec(
            index=j, id=f"svc-{rng.getrandbits(48):012x}", type="service",
            count=8, cpu=fill["cpu"][j % 3], memory_mb=fill["memory_mb"][j % 3],
            disk_mb=150, datacenters=tuple(dcs),
            constraints=(("${attr.kernel.name}", "=", "linux"),)))
    pairs = list(product(fill["cpu"], fill["memory_mb"]))
    filler_allocs = []
    n = len(nodes)
    for i in range(n_allocs):
        if i % len(pairs) == 0:
            rng.shuffle(pairs)
        cpu, mem = pairs[i % len(pairs)]
        filler_allocs.append(FillerAlloc(
            id=f"{rng.getrandbits(128):032x}", node=rng.randrange(n),
            job=i % len(filler_jobs), cpu=cpu, memory_mb=mem,
            disk_mb=fill["disk_mb"]))
    return Spec(config=config, workload=workload, seed=seed, nodes=nodes,
                filler_jobs=filler_jobs, filler_allocs=filler_allocs,
                _job_rng=random.Random(rng.getrandbits(64)))
