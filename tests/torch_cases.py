"""Shared placement scenarios for the PyTorch port's parity tests.

Each case builds a cluster, a job and a plan context with the reference
package's own builders (`test_kernel_parity.make_cluster`/`seed_allocs`,
`nomad_tpu.mock`), from a fixed seed. The cluster records every
mutation as a wire tree, so `port_case` can replay the same nodes and
allocs, in the same order, into the port's `ClusterTensors`: vocabularies,
row order and versions then come out the same in both packages.
"""
from __future__ import annotations

import random
import types
from dataclasses import dataclass, field
from typing import Callable, List, Optional
from unittest import mock as umock

import numpy as np

import test_kernel_parity as tkp
from nomad_tpu import mock
from nomad_tpu.scheduler.stack import PlanContext
from nomad_tpu.structs import (Affinity, Constraint, NetworkResource, Port,
                               Spread, SpreadTarget)
from nomad_tpu.structs.codec import to_wire
from nomad_tpu.tensor.cluster import ClusterTensors

from nomad_tpu_torch import mock as torch_mock
from nomad_tpu_torch.scheduler.stack import PlanContext as TorchPlanContext
from nomad_tpu_torch.structs.codec import from_wire
from nomad_tpu_torch.tensor.cluster import (
    ClusterTensors as TorchClusterTensors)

SEED = tkp.SEED


class RecordingCluster(ClusterTensors):
    """The reference ClusterTensors, logging each mutation as wire data."""

    def __init__(self, *a, **kw) -> None:
        super().__init__(*a, **kw)
        self.log: List[tuple] = []

    def upsert_node(self, node):
        self.log.append(("upsert_node", to_wire(node)))
        return super().upsert_node(node)

    def remove_node(self, node_id):
        self.log.append(("remove_node", node_id))
        return super().remove_node(node_id)

    def upsert_alloc(self, alloc):
        self.log.append(("upsert_alloc", to_wire(alloc)))
        return super().upsert_alloc(alloc)

    def remove_alloc(self, alloc_id, job_id=""):
        self.log.append(("remove_alloc", alloc_id, job_id))
        return super().remove_alloc(alloc_id, job_id)


def make_cluster(n_nodes, rng, **kw):
    """`test_kernel_parity.make_cluster`, on a recording cluster."""
    with umock.patch.object(tkp, "ClusterTensors", RecordingCluster):
        return tkp.make_cluster(n_nodes, rng, **kw)


@dataclass
class Case:
    cluster: RecordingCluster
    nodes: list
    job: object
    n_place: int
    plan: Optional[PlanContext] = None
    sampled_rows: Optional[List[int]] = None
    algorithm: str = "binpack"


@dataclass
class TorchCase:
    cluster: TorchClusterTensors
    job: object
    plan: Optional[TorchPlanContext] = field(default=None)


def replay(cluster: RecordingCluster) -> TorchClusterTensors:
    """The port's ClusterTensors fed the recorded cluster's mutations, in
    order."""
    cl = TorchClusterTensors()
    for op, *args in cluster.log:
        if op in ("upsert_node", "upsert_alloc"):
            getattr(cl, op)(from_wire(args[0]))
        else:
            getattr(cl, op)(*args)
    return cl


def on_port(builder):
    """A `test_kernel_parity` builder (`make_cluster`, `seed_allocs`) with
    its globals bound to the port's mocks and ClusterTensors."""
    g = dict(builder.__globals__, mock=torch_mock,
             ClusterTensors=TorchClusterTensors)
    return types.FunctionType(builder.__code__, g, builder.__name__,
                              builder.__defaults__)


def port_case(case: Case) -> TorchCase:
    """Replay the case's cluster and carry its job and plan over the wire
    into the port's objects."""
    cl = replay(case.cluster)
    plan = None
    if case.plan is not None:
        p = case.plan
        fw = lambda allocs: [from_wire(to_wire(a)) for a in allocs]  # noqa: E731
        plan = TorchPlanContext(
            stopped_allocs=fw(p.stopped_allocs),
            preempted_allocs=fw(p.preempted_allocs),
            placed=[(nid, tg, np.array(u)) for nid, tg, u in p.placed],
            placed_allocs=fw(p.placed_allocs),
            penalty_node_ids=list(p.penalty_node_ids),
            preferred_node_ids=list(p.preferred_node_ids))
    return TorchCase(cluster=cl, job=from_wire(to_wire(case.job)), plan=plan)


# ---- scenario builders -------------------------------------------------------


def _base(job, n_nodes=40, n_seed=30, n_place=3, mutate=None, **kw) -> Case:
    """The `TestKernelParity._run_case` setup."""
    rng = random.Random(SEED)
    cl, nodes = make_cluster(n_nodes, rng)
    if mutate:
        mutate(nodes, cl)
    tkp.seed_allocs(cl, nodes, [job, mock.job()], rng, n_seed)
    return Case(cluster=cl, nodes=nodes, job=job, n_place=n_place, **kw)


def _job_with(*, constraints=(), affinities=(), spreads=()):
    job = mock.job()
    job.constraints.extend(constraints)
    job.affinities.extend(affinities)
    job.spreads.extend(spreads)
    return job


def _mutate_each(fn, sl=slice(None)):
    def mutate(nodes, cl):
        for i, n in list(enumerate(nodes))[sl]:
            fn(i, n)
            cl.upsert_node(n)
    return mutate


def _dp_case(constraint, n_place, tg_level=False, existing=False,
             stop_existing=False) -> Case:
    """The `TestDistinctProperty` setup: 12 nodes over 3 racks."""
    rng = random.Random(SEED)
    cl, nodes = make_cluster(12, rng)
    for i, n in enumerate(nodes):
        n.attributes["rack"] = f"r{i % 3}"
        cl.upsert_node(n)
    job = mock.job()
    (job.task_groups[0].constraints if tg_level
     else job.constraints).append(constraint)
    plan = None
    if existing or stop_existing:
        r0 = next(n for n in nodes if n.attributes["rack"] == "r0")
        a = mock.alloc(job=job)
        a.job_id, a.node_id = job.id, r0.id
        a.task_group = job.task_groups[0].name
        a.client_status = "running"
        cl.upsert_alloc(a)
        if stop_existing:
            plan = PlanContext(stopped_allocs=[a])
    return Case(cluster=cl, nodes=nodes, job=job, n_place=n_place, plan=plan)


def _port_job(port=8080):
    job = mock.job()
    job.task_groups[0].tasks[0].resources.networks = [NetworkResource(
        mbits=1, reserved_ports=[Port("http", port)])]
    return job


def _holding_alloc(job, node, port):
    a = mock.alloc(job=job)
    a.job_id, a.node_id = job.id, node.id
    a.client_status = "running"
    a.allocated_resources = mock.alloc_resources(networks=[NetworkResource(
        ip=node.node_resources.networks[0].ip, mbits=1,
        reserved_ports=[Port("http", port)])])
    return a


def _port_case(n_nodes, port, n_place, skip=None) -> Case:
    rng = random.Random(SEED)
    cl, nodes = make_cluster(n_nodes, rng)
    other = mock.job()
    for i, n in enumerate(nodes):
        if i != skip:
            cl.upsert_alloc(_holding_alloc(other, n, port))
    return Case(cluster=cl, nodes=nodes, job=_port_job(port),
                n_place=n_place)


def _same_group_ports() -> Case:
    rng = random.Random(SEED)
    cl, nodes = make_cluster(2, rng)
    return Case(cluster=cl, nodes=nodes, job=_port_job(7070), n_place=3)


def _dynamic_exhaustion() -> Case:
    rng = random.Random(SEED)
    cl, nodes = make_cluster(2, rng)
    nodes[0].reserved_resources.reserved_ports = "20000-32000"
    cl.upsert_node(nodes[0])
    job = mock.job()
    job.task_groups[0].tasks[0].resources.networks = [NetworkResource(
        mbits=1, dynamic_ports=[Port("rpc", 0)])]
    return Case(cluster=cl, nodes=nodes, job=job, n_place=2)


def _ports_released() -> Case:
    rng = random.Random(SEED)
    cl, nodes = make_cluster(1, rng)
    a = _holding_alloc(mock.job(), nodes[0], 8088)
    cl.upsert_alloc(a)
    a.client_status = "complete"
    cl.upsert_alloc(a)
    return Case(cluster=cl, nodes=nodes, job=_port_job(8088), n_place=1)


def _plan_case(kind: str) -> Case:
    """Plan-relative programs: in-plan stops (delta rows, released ports),
    in-plan placements (consumed resources and ports), reschedule
    penalties and preferred nodes."""
    job = _port_job(9090)
    job.task_groups[0].tasks[0].resources.networks[0].dynamic_ports = [
        Port("rpc", 0)]
    case = _base(job, n_nodes=24, n_seed=40, n_place=4)
    cl, nodes = case.cluster, case.nodes
    tg = job.task_groups[0]
    plan = PlanContext()
    if kind == "delta":
        mine = [a for a in _allocs_of(cl, job.id)][:3]
        for nid in (nodes[1].id, nodes[2].id):
            a = _holding_alloc(job, next(n for n in nodes if n.id == nid),
                               9090)
            a.task_group = tg.name
            a.allocated_resources.tasks["web"].networks[0].dynamic_ports = [
                Port("rpc", 20017)]
            cl.upsert_alloc(a)
            mine.append(a)
        plan.stopped_allocs = mine
        for nid in (nodes[3].id, nodes[3].id, nodes[5].id):
            pa = tkp.placed_alloc(job, tg, nid)
            pa.allocated_resources.shared.networks = [NetworkResource(
                ip=nodes[3].node_resources.networks[0].ip, mbits=1,
                reserved_ports=[Port("http", 9090)],
                dynamic_ports=[Port("rpc", 20001)])]
            plan.placed.append((nid, tg.name, cl.usage_row(pa)))
            plan.placed_allocs.append(pa)
    elif kind == "penalty":
        plan.penalty_node_ids = [frozenset({nodes[i].id, nodes[i + 7].id})
                                 for i in range(4)]
    elif kind == "preferred":
        plan.preferred_node_ids = [nodes[9].id, None, nodes[4].id,
                                   nodes[9].id]
    case.plan = plan
    return case


def _allocs_of(cl, job_id):
    """The recorded allocs of `job_id`, in upsert order."""
    from nomad_tpu.structs.codec import from_wire as ref_from_wire

    seen = {}
    for op, *args in cl.log:
        if op == "upsert_alloc" and args[0]["job_id"] == job_id:
            a = ref_from_wire(args[0])
            seen[a.id] = a
    return list(seen.values())


def _sampled() -> Case:
    case = _base(_job_with(affinities=[Affinity("${attr.rack}", "r1", "=",
                                                 50)]), n_place=2)
    rows = list(range(case.cluster.n_cap))
    random.Random(SEED + 1).shuffle(rows)
    case.sampled_rows = sorted(rows[:9])
    return case


def _all_infeasible() -> Case:
    return _base(_job_with(constraints=[Constraint("${attr.kernel.name}",
                                                   "windows", "=")]))


CASES: dict = {
    # tests/test_kernel_parity.py TestKernelParity
    "basic_binpack": lambda: _base(mock.job()),
    "equality_constraint": lambda: _base(_job_with(
        constraints=[Constraint("${attr.rack}", "r1", "=")])),
    "regexp_constraint": lambda: _base(_job_with(
        constraints=[Constraint("${attr.zone}", "z[01]", "regexp")])),
    "version_constraint": lambda: _base(_job_with(
        constraints=[Constraint("${attr.nomad.version}", ">= 0.4.0",
                                "version")])),
    "infeasible_constraint": lambda: _base(_job_with(
        constraints=[Constraint("${attr.zone}", "does-not-exist", "=")])),
    "all_infeasible": _all_infeasible,
    "datacenter_filter": lambda: _base(
        _dc2_job(), mutate=_mutate_each(
            lambda i, n: setattr(n, "datacenter", "dc2"), slice(0, 7))),
    "distinct_hosts": lambda: _base(_job_with(
        constraints=[Constraint("", "", "distinct_hosts")]),
        n_nodes=20, n_place=5),
    "affinity": lambda: _base(_job_with(affinities=[
        Affinity("${attr.rack}", "r2", "=", 70),
        Affinity("${attr.zone}", "z0", "=", -30)])),
    "spread_targets": lambda: _base(_job_with(spreads=[Spread(
        attribute="${attr.zone}", weight=100, spread_target=[
            SpreadTarget("z0", 50), SpreadTarget("z1", 30),
            SpreadTarget("z2", 20)])]), n_place=6),
    "even_spread": lambda: _base(_job_with(
        spreads=[Spread(attribute="${attr.rack}", weight=50)]), n_place=6),
    "node_ineligible": lambda: _base(mock.job(), mutate=_mutate_each(
        lambda i, n: setattr(n, "scheduling_eligibility", "ineligible"),
        slice(None, None, 3))),
    "resource_exhaustion": lambda: _base(
        _cpu_job(3500), n_place=4, mutate=_mutate_each(
            lambda i, n: setattr(n.node_resources, "cpu", 4000))),
    "lexical_constraint": lambda: _base(_job_with(
        constraints=[Constraint("${attr.rack}", "r2", "<")])),
    "set_contains": lambda: _base(
        _job_with(constraints=[Constraint("${attr.features}", "a,b",
                                          "set_contains")]),
        mutate=_mutate_each(lambda i, n: n.attributes.__setitem__(
            "features", "a,b,c" if i % 2 else "a,c"))),
    "is_set": lambda: _base(
        _job_with(constraints=[Constraint("${attr.special}", "", "is_set")]),
        mutate=_mutate_each(lambda i, n: n.attributes.__setitem__(
            "special", "yes"), slice(0, 11))),
    # TestDistinctProperty
    "dp_job_level": lambda: _dp_case(
        Constraint("${attr.rack}", "", "distinct_property"), 5),
    "dp_count_form": lambda: _dp_case(
        Constraint("${attr.rack}", "2", "distinct_property"), 8),
    "dp_existing": lambda: _dp_case(
        Constraint("${attr.rack}", "", "distinct_property"), 4,
        existing=True),
    "dp_tg_level": lambda: _dp_case(
        Constraint("${attr.rack}", "", "distinct_property"), 5,
        tg_level=True),
    "dp_missing": lambda: _dp_case(
        Constraint("${meta.nonexistent}", "", "distinct_property"), 2),
    "dp_invalid_rtarget": lambda: _dp_case(
        Constraint("${attr.rack}", "not-a-number", "distinct_property"), 2),
    "dp_literal": lambda: _dp_case(
        Constraint("fixed-value", "2", "distinct_property"), 5),
    "dp_plan_stop": lambda: _dp_case(
        Constraint("${attr.rack}", "", "distinct_property"), 3,
        stop_existing=True),
    # TestPortFeasibility
    "port_conflict": lambda: _port_case(4, 8080, 1, skip=2),
    "port_all_exhausted": lambda: _port_case(3, 9001, 1),
    "port_same_group": _same_group_ports,
    "port_dynamic_exhaustion": _dynamic_exhaustion,
    "port_released": _ports_released,
    # added for the port: plan-relative rows, sampling, algorithm, n=0
    "plan_delta_ports": lambda: _plan_case("delta"),
    "plan_penalty": lambda: _plan_case("penalty"),
    "plan_preferred": lambda: _plan_case("preferred"),
    "sampled": _sampled,
    "algorithm_spread": lambda: _with(_base(_job_with(affinities=[
        Affinity("${attr.zone}", "z1", "=", 40)])), algorithm="spread"),
    "n_place_zero": lambda: _base(mock.job(), n_place=0),
}


def _dc2_job():
    job = mock.job()
    job.datacenters = ["dc2"]
    return job


def _cpu_job(cpu):
    job = mock.job()
    job.task_groups[0].tasks[0].resources.cpu = cpu
    return job


def _with(case: Case, **kw) -> Case:
    for k, v in kw.items():
        setattr(case, k, v)
    return case


def build(name: str) -> Case:
    builder: Callable[[], Case] = CASES[name]
    return builder()
