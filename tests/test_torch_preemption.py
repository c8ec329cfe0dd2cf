"""Preemption in the port: the host half, the retry and K3's plain version.

- Every test of `tests/test_preemption.py`, on the port's imports: the
  scoring math, the grouping, `Preemptor` for task groups, networks and
  devices (the port's mocks), and, through both packages' Harnesses fed
  the same objects (`torch_sched_cases.Twins`), the service preemption
  retry, its distinct_property gates and the system scheduler's
  preemption. The port's plans must equal the reference's by content:
  placements by (node, group, name), victims by id, metric counts, the
  carry flag, and normalized scores within 1e-6.
- K3's plain version (`kernels/preemption.py` `preempt_rank_plain`)
  against the reference's `preempt_rank` on CPU XLA: the same numpy
  cluster, program and candidate table, over all-equal priorities, pads
  between real slots, A ∈ {1, 8, 32, 64}, rows with no eligible victim,
  no feasible node at all, plan deltas, distinct_hosts and
  distinct_property. `best_row`, `best_k`, `order` and `feasible` must be
  equal; `scores` and `best_score` within 1e-6 (XLA's exp against
  torch.exp: an ulp or two of a value in [0, 1]).
"""
import math
import zlib

import jax.numpy as jnp
import numpy as np
import pytest

import torch_cases as tc
from nomad_tpu import mock as ref_mock
from nomad_tpu.kernels.preemption import (PreemptionCandidates,
                                          preempt_rank_jit)
from nomad_tpu.scheduler.stack import TPUStack, _to_device
from torch_sched_cases import Twins, placed

from nomad_tpu_torch import mock
from nomad_tpu_torch.convert import (candidates_from_numpy,
                                     cluster_from_numpy, params_from_numpy)
from nomad_tpu_torch.kernels import preemption as kpre
from nomad_tpu_torch.scheduler.preemption import (
    Preemptor,
    basic_resource_distance,
    filter_and_group_preemptible,
    net_priority,
    preemption_score,
    score_for_task_group,
)
from nomad_tpu_torch.structs.resources import ComparableResources

ATOL = 1e-6


def lowprio_job(priority=1, cpu=3200, memory_mb=7256, mk=mock, **kw):
    j = mk.job(priority=priority, **kw)
    j.task_groups[0].count = 1
    j.task_groups[0].tasks[0].resources.cpu = cpu
    j.task_groups[0].tasks[0].resources.memory_mb = memory_mb
    j.task_groups[0].tasks[0].resources.networks = []
    j.task_groups[0].networks = []
    return j


def running_alloc(job, node, cpu=3200, memory_mb=7256, mk=mock):
    a = mk.alloc(
        job=job,
        node_id=node.id,
        allocated_resources=mk.alloc_resources(
            cpu=cpu, memory_mb=memory_mb, disk_mb=10, networks=[]
        ),
        client_status="running",
    )
    a.task_group = job.task_groups[0].name
    a.name = f"{job.id}.{a.task_group}[0]"
    return a


class TestScoringMath:
    def test_basic_resource_distance(self):
        ask = ComparableResources(cpu=2048, memory_mb=512, disk_mb=4096)
        used = ComparableResources(cpu=1024, memory_mb=256, disk_mb=1024)
        d = basic_resource_distance(ask, used)
        assert d == pytest.approx(math.sqrt(0.25 + 0.25 + 0.5625))

    def test_preemption_score_logistic(self):
        assert preemption_score(2048.0) == pytest.approx(0.5)
        assert preemption_score(0.0) > 0.99
        assert preemption_score(10000.0) < 0.01

    def test_net_priority(self):
        j1 = mock.job(priority=30)
        j2 = mock.job(priority=70)
        allocs = [mock.alloc(job=j1), mock.alloc(job=j2), mock.alloc(job=j1)]
        assert net_priority(allocs) == pytest.approx(70 + 130 / 70)

    def test_max_parallel_penalty(self):
        ask = ComparableResources(cpu=100, memory_mb=100, disk_mb=0)
        used = ComparableResources(cpu=100, memory_mb=100, disk_mb=0)
        base = score_for_task_group(ask, used, 0, 5)
        penalized = score_for_task_group(ask, used, 2, 2)
        assert penalized == pytest.approx(base + 50.0)


class TestFilterGroup:
    def test_priority_delta_10(self):
        mk = lambda p: mock.alloc(job=mock.job(priority=p))  # noqa: E731
        allocs = [mk(5), mk(40), mk(45), mk(50), mk(89), mk(95)]
        grouped = filter_and_group_preemptible(50, allocs)
        assert [p for p, _ in grouped] == [5, 40]

    def test_groups_sorted_ascending(self):
        mk = lambda p: mock.alloc(job=mock.job(priority=p))  # noqa: E731
        grouped = filter_and_group_preemptible(100, [mk(70), mk(10), mk(40)])
        assert [p for p, _ in grouped] == [10, 40, 70]


class TestPreemptorTaskGroup:
    def _preemptor(self, node, candidates, priority=100):
        p = Preemptor(priority, "default", "new-job")
        p.set_node(node)
        p.set_candidates(candidates)
        p.set_preemptions([])
        return p

    def _ask(self, cpu=2000, memory_mb=2000):
        return ComparableResources(cpu=cpu, memory_mb=memory_mb, disk_mb=10)

    def test_single_victim_frees_enough(self):
        node = mock.node()
        victim = running_alloc(lowprio_job(priority=1), node)
        out = self._preemptor(node, [victim]).preempt_for_task_group(
            self._ask())
        assert [a.id for a in out] == [victim.id]

    def test_no_eligible_victims(self):
        node = mock.node()
        victim = running_alloc(lowprio_job(priority=95), node)
        p = self._preemptor(node, [victim], priority=100)
        assert p.preempt_for_task_group(self._ask()) == []

    def test_insufficient_even_after_all(self):
        node = mock.node()
        victim = running_alloc(lowprio_job(priority=1), node,
                               cpu=100, memory_mb=100)
        p = self._preemptor(node, [victim])
        assert p.preempt_for_task_group(self._ask(100000, 100000)) == []

    def test_lowest_priority_preferred(self):
        node = mock.node()
        j_lo, j_hi = lowprio_job(priority=1), lowprio_job(priority=40)
        v1 = running_alloc(j_lo, node, cpu=1600, memory_mb=3600)
        v2 = running_alloc(j_hi, node, cpu=1600, memory_mb=3600)
        out = self._preemptor(node, [v1, v2]).preempt_for_task_group(
            self._ask(1000, 1000))
        assert [a.id for a in out] == [v1.id]

    def test_superset_filter_minimal_set(self):
        node = mock.node()
        small = running_alloc(lowprio_job(priority=1), node,
                              cpu=200, memory_mb=256)
        big = running_alloc(lowprio_job(priority=1), node,
                            cpu=3000, memory_mb=6000)
        out = self._preemptor(node, [small, big]).preempt_for_task_group(
            self._ask(2500, 2500))
        assert [a.id for a in out] == [big.id]

    def test_own_job_never_preempted(self):
        node = mock.node()
        j = lowprio_job(priority=1)
        mine = running_alloc(j, node)
        p = Preemptor(100, "default", j.id)
        p.set_node(node)
        p.set_candidates([mine])
        p.set_preemptions([])
        assert p.preempt_for_task_group(self._ask()) == []


class TestPreemptorNetwork:
    def _net_alloc(self, job, node, mbits, reserved=(), dynamic=()):
        from nomad_tpu_torch.structs import NetworkResource, Port

        net = NetworkResource(
            device="eth0", ip="192.168.0.100", mbits=mbits,
            reserved_ports=[Port(label=f"r{p}", value=p) for p in reserved],
            dynamic_ports=[Port(label=f"d{p}", value=p) for p in dynamic],
        )
        return mock.alloc(
            job=job, node_id=node.id,
            allocated_resources=mock.alloc_resources(
                cpu=200, memory_mb=256, disk_mb=10, networks=[net]),
            client_status="running",
        )

    def _setup(self, node, allocs):
        from nomad_tpu_torch.structs import NetworkIndex

        p = Preemptor(100, "default", "new-job")
        p.set_node(node)
        p.set_candidates(allocs)
        p.set_preemptions([])
        idx = NetworkIndex()
        idx.set_node(node)
        idx.add_allocs(allocs)
        return p, idx

    def test_preempt_for_bandwidth(self):
        from nomad_tpu_torch.structs import NetworkResource

        node = mock.node()
        hog = self._net_alloc(lowprio_job(priority=1), node, mbits=900)
        p, idx = self._setup(node, [hog])
        out = p.preempt_for_network(NetworkResource(mbits=500), idx)
        assert [a.id for a in out] == [hog.id]

    def test_reserved_port_held_by_high_priority_blocks(self):
        from nomad_tpu_torch.structs import NetworkResource, Port

        node = mock.node()
        holder = self._net_alloc(mock.job(priority=95), node, mbits=100,
                                 reserved=(8080,))
        hog = self._net_alloc(lowprio_job(priority=1), node, mbits=800)
        p, idx = self._setup(node, [holder, hog])
        ask = NetworkResource(mbits=500, reserved_ports=[
            Port(label="http", value=8080)])
        assert p.preempt_for_network(ask, idx) == []

    def test_reserved_port_released_by_victim(self):
        from nomad_tpu_torch.structs import NetworkResource, Port

        node = mock.node()
        hog = self._net_alloc(lowprio_job(priority=1), node, mbits=900,
                              reserved=(8080,))
        p, idx = self._setup(node, [hog])
        ask = NetworkResource(mbits=500, reserved_ports=[
            Port(label="http", value=8080)])
        assert [a.id for a in p.preempt_for_network(ask, idx)] == [hog.id]


class TestPreemptorDevice:
    def _gpu_alloc(self, job, node, n_gpus):
        from nomad_tpu_torch.structs import (
            AllocatedDeviceResource,
            AllocatedResources,
            AllocatedSharedResources,
            AllocatedTaskResources,
        )

        return mock.alloc(
            job=job, node_id=node.id,
            allocated_resources=AllocatedResources(
                tasks={"web": AllocatedTaskResources(
                    cpu=100, memory_mb=100,
                    devices=[AllocatedDeviceResource(
                        vendor="nvidia", type="gpu", name="1080ti",
                        device_ids=[f"g{i}" for i in range(n_gpus)])])},
                shared=AllocatedSharedResources(disk_mb=10)),
            client_status="running",
        )

    def _preemptor(self, node, allocs):
        p = Preemptor(100, "default", "new-job")
        p.set_node(node)
        p.set_candidates(allocs)
        p.set_preemptions([])
        return p

    def test_preempt_for_device_count(self):
        node = mock.nvidia_node()
        v1 = self._gpu_alloc(lowprio_job(priority=1), node, 1)
        v2 = self._gpu_alloc(lowprio_job(priority=1), node, 2)
        out = self._preemptor(node, [v1, v2]).preempt_for_device(
            "nvidia/gpu/1080ti", 2, 0)
        assert [a.id for a in out] == [v2.id]

    def test_device_insufficient(self):
        node = mock.nvidia_node()
        v1 = self._gpu_alloc(lowprio_job(priority=1), node, 1)
        assert self._preemptor(node, [v1]).preempt_for_device(
            "nvidia/gpu/1080ti", 4, 0) == []


# ---- end to end, through both packages' Harnesses ---------------------------


def _fill_cluster(t, n_nodes, victim_priority=1):
    """n nodes, each filled by one low-priority alloc (in both states)."""
    nodes, victims = [], []
    for _ in range(n_nodes):
        node = ref_mock.node()
        t.upsert_node(node)
        nodes.append(node)
        j = lowprio_job(priority=victim_priority, mk=ref_mock)
        t.upsert_job(j)
        a = running_alloc(j, node, mk=ref_mock)
        t.upsert_alloc(a)
        victims.append(a)
    return nodes, victims


def _big_job(count=1, **kw):
    job = ref_mock.job(priority=100, **kw)
    job.task_groups[0].count = count
    job.task_groups[0].tasks[0].resources.cpu = 2000
    job.task_groups[0].tasks[0].resources.memory_mb = 2000
    job.task_groups[0].tasks[0].resources.networks = []
    job.task_groups[0].networks = []
    return job


def _run(t, job, type_=None):
    t.upsert_job(job)
    t.process(ref_mock.eval_(job_id=job.id, type=type_ or job.type,
                             priority=job.priority))
    t.assert_same()


class TestServiceSchedPreemption:
    def test_disabled_by_default(self):
        t = Twins()
        _fill_cluster(t, 3)
        _run(t, _big_job())
        assert t.port.evals[-1].failed_tg_allocs

    def test_service_preemption_end_to_end(self):
        t = Twins()
        t.set_scheduler_config(preemption_service_enabled=True)
        _nodes, victims = _fill_cluster(t, 3)
        _run(t, _big_job())

        plan = t.port.plans[-1]
        got = placed(t.port)
        assert len(got) == 1 and got[0].preempted_allocations
        assert set(got[0].preempted_allocations) <= {v.id for v in victims}
        evicted = [a for allocs in plan.node_preemptions.values()
                   for a in allocs]
        assert {a.id for a in evicted} == set(got[0].preempted_allocations)
        assert all(a.desired_status == "evict" for a in evicted)
        assert all(a.preempted_by_allocation == got[0].id for a in evicted)
        assert t.port.state.alloc_by_id(evicted[0].id).desired_status \
            == "evict"
        # the retry placed where the kernel's run did not: the plan's
        # carry may not be adopted
        assert plan.carry_exact is False

    def test_distinct_property_gates_preemption(self):
        from nomad_tpu.structs.job import Constraint

        t = Twins()
        t.set_scheduler_config(preemption_service_enabled=True)
        job = _big_job(count=2)
        job.constraints.append(
            Constraint("${attr.rack}", "", "distinct_property"))

        node_c = ref_mock.node()
        node_c.attributes["rack"] = "r1"
        t.upsert_node(node_c)
        own = running_alloc(job, node_c, cpu=2000, memory_mb=2000,
                            mk=ref_mock)
        own.name = f"{job.id}.{job.task_groups[0].name}[0]"

        node_a = ref_mock.node()
        node_a.attributes["rack"] = "r1"
        t.upsert_node(node_a)
        ja = lowprio_job(priority=1, mk=ref_mock)
        t.upsert_job(ja)
        t.upsert_alloc(running_alloc(ja, node_a, mk=ref_mock))

        node_b = ref_mock.node()
        node_b.attributes["rack"] = "r2"
        t.upsert_node(node_b)
        jb = lowprio_job(priority=50, mk=ref_mock)
        t.upsert_job(jb)
        t.upsert_alloc(running_alloc(jb, node_b, mk=ref_mock))

        t.upsert_job(job)
        t.upsert_alloc(own)
        _run(t, job)
        got = placed(t.port)
        assert len(got) == 1
        assert got[0].node_id == node_b.id
        assert got[0].preempted_allocations

    def test_literal_dp_cap_not_bypassed_by_preemption(self):
        from nomad_tpu.structs.job import Constraint

        t = Twins()
        t.set_scheduler_config(preemption_service_enabled=True)
        job = _big_job(count=2)
        job.constraints.append(
            Constraint("literal-value", "1", "distinct_property"))

        node_c = ref_mock.node()
        t.upsert_node(node_c)
        own = running_alloc(job, node_c, cpu=2000, memory_mb=2000,
                            mk=ref_mock)
        own.name = f"{job.id}.{job.task_groups[0].name}[0]"

        node_a = ref_mock.node()
        t.upsert_node(node_a)
        ja = lowprio_job(priority=1, mk=ref_mock)
        t.upsert_job(ja)
        t.upsert_alloc(running_alloc(ja, node_a, mk=ref_mock))

        t.upsert_job(job)
        t.upsert_alloc(own)
        _run(t, job)
        assert t.port.evals[-1].failed_tg_allocs
        assert not placed(t.port)

    def test_higher_priority_not_preempted(self):
        t = Twins()
        t.set_scheduler_config(preemption_service_enabled=True)
        _fill_cluster(t, 3, victim_priority=95)
        _run(t, _big_job())
        assert t.port.evals[-1].failed_tg_allocs


class TestSystemSchedPreemption:
    def test_system_preempts_by_default(self):
        t = Twins()
        _fill_cluster(t, 2)
        job = ref_mock.system_job(priority=100)
        job.task_groups[0].tasks[0].resources.cpu = 2000
        job.task_groups[0].tasks[0].resources.memory_mb = 2000
        job.task_groups[0].tasks[0].resources.networks = []
        _run(t, job, "system")
        got = placed(t.port)
        assert len(got) == 2
        for a in got:
            assert a.preempted_allocations


# ---- K3: the plain version against the reference kernel ---------------------

#: candidate tables, each over the case's cluster; "ties" also makes
#: every row's capacity, use and candidates the first row's, so equal
#: scores are bitwise equal and the lowest row must win
TABLES = ("equal", "ties", "mixed_pads", "no_victim_rows")
#: cases of `torch_cases` (program and cluster): binpack, plan deltas with
#: released/consumed ports, distinct_hosts, distinct_property with an
#: existing alloc, a constraint no node meets
K3_CASES = ("basic_binpack", "plan_delta_ports", "distinct_hosts",
            "dp_existing", "infeasible_constraint")


def _k3_inputs(name, table, a):
    """(numpy cluster, numpy program, prio, usage): the case's program,
    its cluster with every node 70–100% used (integers), and a seeded
    candidate table of A slots (integer usages, f32-exact sums)."""
    case = tc.build(name)
    stack = TPUStack(case.cluster)
    params, _m = stack.compile_tg(case.job, case.job.task_groups[0],
                                  case.n_place, case.plan)
    arrays = {k: np.array(v) for k, v in stack.device_arrays()._asdict()
              .items()}
    rng = np.random.default_rng(zlib.crc32(f"{name}/{table}/{a}".encode()))
    n, r = arrays["capacity"].shape
    frac = rng.uniform(0.7, 1.0, size=(n, 2))
    arrays["used"][:, :2] = np.floor(arrays["capacity"][:, :2] * frac)
    if table in ("equal", "ties"):
        prio = np.full((n, a), 50, dtype=np.float32)
    else:
        prio = rng.choice([10, 20, 30, 50, 50], size=(n, a)).astype(
            np.float32)
    if table not in ("equal", "ties"):
        # pads between real slots: the stable sort must keep their order
        prio[rng.random((n, a)) < 0.25] = kpre.INF_PRIO
    if table == "no_victim_rows":
        prio[rng.random(n) < 0.5] = kpre.INF_PRIO
    usage = np.zeros((n, a, r), dtype=np.float32)
    usage[:, :, 0] = rng.integers(0, 700, size=(n, a))
    usage[:, :, 1] = rng.integers(0, 1200, size=(n, a))
    usage[:, :, 2] = rng.integers(0, 50, size=(n, a))
    if table == "ties":
        for k in ("capacity", "used"):
            arrays[k][:] = arrays[k][0]
        usage[:] = usage[0]
    return arrays, params, prio, usage


@pytest.mark.parametrize("a", [1, 8, 32, 64])
@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("name", K3_CASES)
def test_k3_plain_matches_reference(name, table, a):
    arrays, params, prio, usage = _k3_inputs(name, table, a)
    from nomad_tpu.kernels.placement import ClusterArrays as RefArrays

    ref = preempt_rank_jit(
        RefArrays(**{k: jnp.asarray(v) for k, v in arrays.items()}),
        _to_device(params),
        PreemptionCandidates(prio=jnp.asarray(prio),
                             usage=jnp.asarray(usage)))
    got = kpre.preempt_rank(cluster_from_numpy(arrays, "cpu"),
                            params_from_numpy(params, "cpu"),
                            candidates_from_numpy(prio, usage, "cpu"))
    for f in ("best_row", "best_k", "order", "feasible"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                      getattr(got, f).numpy(), err_msg=f)
    for f in ("scores", "best_score"):
        np.testing.assert_allclose(np.asarray(getattr(ref, f)),
                                   getattr(got, f).numpy(), rtol=0,
                                   atol=ATOL, err_msg=f)
    if name == "infeasible_constraint":
        assert int(got.best_row) == -1 and not got.feasible.any()


def test_k3_reads_no_port_bitmap():
    """The retry uploads four tensors: K3 runs with ports_used and
    dyn_free absent."""
    arrays, params, prio, usage = _k3_inputs("basic_binpack", "mixed_pads",
                                             8)
    full = cluster_from_numpy(arrays, "cpu")
    four = full._replace(ports_used=None, dyn_free=None)
    p = params_from_numpy(params, "cpu")
    cand = candidates_from_numpy(prio, usage, "cpu")
    want, got = kpre.preempt_rank(full, p, cand), kpre.preempt_rank(four, p,
                                                                     cand)
    for f in kpre.PreemptionResult._fields:
        assert (getattr(want, f) == getattr(got, f)).all(), f


def test_cpu_tensors_never_launch_the_kernel():
    arrays, params, prio, usage = _k3_inputs("basic_binpack", "equal", 8)
    before = kpre.launch_count()
    kpre.preempt_rank(cluster_from_numpy(arrays, "cpu"),
                      params_from_numpy(params, "cpu"),
                      candidates_from_numpy(prio, usage, "cpu"))
    assert kpre.launch_count() == before
