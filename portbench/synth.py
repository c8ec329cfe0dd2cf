"""The port's objects for a cell's plain inputs (`portbench/spec.py`).

Frozen copy of `nomad_tpu_torch/synth.py` at commit 09e5296: the node,
job and filler-alloc builders (`synth_node`, `synth_service_job`,
`synth_alloc`) and the ingest of `build_synthetic_state`, made to take the
drawn values from the spec instead of drawing them, so that the reference
reads the same values as the program.
"""
from __future__ import annotations

from typing import List

from .spec import FillerAlloc, JobSpec, NodeSpec, Spec


def node(ns: NodeSpec, reserved):
    from nomad_tpu_torch.structs import (NetworkResource, Node,
                                         NodeReservedResources, NodeResources)

    i = ns.index
    n = Node(
        id=ns.id, name=ns.name, datacenter=ns.datacenter,
        node_class=ns.node_class,
        attributes={
            "kernel.name": "linux", "arch": "amd64",
            "cpu.numcores": str(ns.cpu // 1000),
            "driver.exec": "1", "driver.docker": "1", "rack": ns.rack,
        },
        node_resources=NodeResources(
            cpu=ns.cpu, memory_mb=ns.memory_mb, disk_mb=ns.disk_mb,
            networks=[NetworkResource(
                device="eth0",
                ip=f"10.{(i >> 16) & 255}.{(i >> 8) & 255}.{i & 255}",
                cidr="10.0.0.0/8", mbits=ns.mbits)]),
        reserved_resources=NodeReservedResources(
            cpu=reserved["cpu"], memory_mb=reserved["memory_mb"],
            disk_mb=reserved["disk_mb"], reserved_ports="22"),
    )
    n.compute_class()
    return n


def job(js: JobSpec):
    from nomad_tpu_torch.structs import (EphemeralDisk, Job, Resources, Task,
                                         TaskGroup)
    from nomad_tpu_torch.structs.job import Affinity, Constraint

    constraints = [Constraint(ltarget=lt, rtarget=rt, operand=op)
                   for lt, op, rt in js.constraints]
    affinities = []
    if js.affinity:
        a = js.affinity
        affinities.append(Affinity(ltarget=a["ltarget"], rtarget=a["rtarget"],
                                   operand=a["operand"], weight=a["weight"]))
    return Job(
        id=js.id, name=js.id, type=js.type, priority=50,
        datacenters=list(js.datacenters), constraints=constraints,
        affinities=affinities,
        task_groups=[TaskGroup(
            name="web", count=js.count,
            ephemeral_disk=EphemeralDisk(size_mb=js.disk_mb),
            tasks=[Task(name="web", driver="exec", resources=Resources(
                cpu=js.cpu, memory_mb=js.memory_mb))])])


def filler_alloc(fa: FillerAlloc, node_id: str, fjob):
    from nomad_tpu_torch.mock import alloc_resources
    from nomad_tpu_torch.structs import Allocation

    return Allocation(
        id=fa.id, eval_id="synth", namespace="default",
        name=f"{fjob.id}.web[0]", node_id=node_id, job_id=fjob.id, job=fjob,
        task_group="web",
        allocated_resources=alloc_resources(
            cpu=fa.cpu, memory_mb=fa.memory_mb, disk_mb=fa.disk_mb),
        desired_status="run", client_status="running")


def ingest(state, spec: Spec) -> List:
    """Write the spec's nodes, filler jobs and filler allocs into a
    server's state store, as `build_synthetic_state` does."""
    nodes = [node(ns, spec.reserved) for ns in spec.nodes]
    for n in nodes:
        state.upsert_node(n)
    fjobs = [job(js) for js in spec.filler_jobs]
    for j in fjobs:
        state.upsert_job(j)
    for fa in spec.filler_allocs:
        state.upsert_alloc(filler_alloc(fa, nodes[fa.node].id, fjobs[fa.job]))
    return nodes
