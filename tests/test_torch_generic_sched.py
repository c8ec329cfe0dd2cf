"""Twins of the reference's `tests/test_generic_sched.py`: end-to-end
scheduler tests through the Harness (reference
`scheduler/generic_sched_test.go` TestServiceSched_JobRegister*,
_JobModify, _NodeDown, … and `system_sched_test.go`).

Every test runs against `Dual`: the reference's Harness and the port's
`Harness(device="cpu")` fed the same objects (built by the reference's
mocks; the port's copies cross the wire codec, so ids are shared). The
test body reads and asserts on the port's side, as the reference test
does on its own; at the end `assert_same` holds the port's plans, evals
and allocs against the reference's: placements and stops by (node,
alloc name), failure metrics, eval statuses, the created evals, every
alloc's (name, node, desired and client status), and normalized scores
within f32 rounding.
"""
import pytest

from nomad_tpu import mock
from nomad_tpu.structs import Constraint
from nomad_tpu.structs.codec import from_wire as ref_from_wire
from nomad_tpu_torch.structs.codec import to_wire as port_to_wire

from torch_chain_cases import one_torch_thread  # noqa: F401
from torch_sched_cases import ATOL, Twins, failed_view, wire


def _is_port(obj) -> bool:
    return type(obj).__module__.startswith("nomad_tpu_torch")


class _DualState:
    """The port's state for reads; every write lands in both states (a
    port object is copied back to the reference over the codec)."""

    def __init__(self, tw: Twins):
        self._tw = tw

    def __getattr__(self, name):
        return getattr(self._tw.port.state, name)

    def _both(self, op, obj):
        if _is_port(obj):
            getattr(self._tw.port.state, op)(obj)
            getattr(self._tw.ref.state, op)(self._to_ref(obj))
        else:
            getattr(self._tw.ref.state, op)(obj)
            getattr(self._tw.port.state, op)(wire(obj))

    def _to_ref(self, obj):
        """The reference's copy of a port object. An alloc the port's
        scheduler made has an id of its own in each package: its twin is
        the reference's alloc of the same job, name and node, given the
        port's client and desired states."""
        import copy

        if type(obj).__name__ != "Allocation":
            return ref_from_wire(port_to_wire(obj))
        (twin,) = [a for a in self._tw.ref.state._allocs.values()
                   if (a.job_id, a.name, a.node_id)
                   == (obj.job_id, obj.name, obj.node_id)]
        twin = copy.copy(twin)
        for f in ("client_status", "desired_status", "desired_description"):
            setattr(twin, f, getattr(obj, f))
        return twin

    def upsert_node(self, node):
        self._both("upsert_node", node)

    def upsert_job(self, job):
        self._both("upsert_job", job)

    def upsert_alloc(self, alloc):
        self._both("upsert_alloc", alloc)


class Harness:
    """The reference's Harness and the port's, driven as one."""

    def __init__(self):
        self.tw = Twins()
        self.state = _DualState(self.tw)

    def process(self, ev):
        self.tw.process(ev)

    @property
    def plans(self):
        return self.tw.port.plans

    @property
    def evals(self):
        return self.tw.port.evals

    @property
    def create_evals(self):
        return self.tw.port.create_evals

    def assert_same(self):
        ref, port = self.tw.ref, self.tw.port
        assert len(port.plans) == len(ref.plans)
        for rp, pp in zip(ref.plans, port.plans):
            assert _plan_view(pp) == _plan_view(rp)
            rs, ps = _scores(rp), _scores(pp)
            assert set(ps) == set(rs)
            for k, want in rs.items():
                assert ps[k] == pytest.approx(want, abs=ATOL), k
        assert [(e.status, e.triggered_by) for e in port.evals] == \
            [(e.status, e.triggered_by) for e in ref.evals]
        assert [failed_view(e) for e in port.evals] == \
            [failed_view(e) for e in ref.evals]
        assert [(e.type, e.status, e.triggered_by)
                for e in port.create_evals] == \
            [(e.type, e.status, e.triggered_by) for e in ref.create_evals]
        assert _allocs(port.state) == _allocs(ref.state)


def _plan_view(plan):
    placed = sorted((nid, a.name, a.task_group,
                     a.metrics.nodes_evaluated, a.metrics.nodes_filtered,
                     a.metrics.nodes_exhausted)
                    for nid, v in plan.node_allocation.items() for a in v)
    stopped = sorted((nid, a.name, a.desired_status, a.desired_description)
                     for nid, v in plan.node_update.items() for a in v)
    ann = plan.annotations
    return placed, stopped, (None if ann is None else sorted(
        (tg, vars(u)) for tg, u in ann.desired_tg_updates.items()))


def _scores(plan):
    return {(nid, a.name): [sm.norm_score for sm in a.metrics.score_meta]
            for nid, v in plan.node_allocation.items() for a in v}


def _allocs(state):
    return sorted((a.name, a.node_id, a.desired_status, a.client_status)
                  for a in state._allocs.values())


def register_nodes(h, n, **overrides):
    nodes = []
    for _ in range(n):
        node = mock.node(**overrides)
        h.state.upsert_node(node)
        nodes.append(node)
    return nodes


def eval_for(job, **kw):
    e = mock.eval_(job_id=job.id, type=job.type, priority=job.priority, **kw)
    return e


class TestServiceSchedJobRegister:
    def test_place_all(self):
        h = Harness()
        register_nodes(h, 10)
        job = mock.job()
        h.state.upsert_job(job)
        ev = eval_for(job)
        h.process(ev)

        assert len(h.plans) == 1
        plan = h.plans[0]
        placed = [a for allocs in plan.node_allocation.values() for a in allocs]
        assert len(placed) == 10
        # status update marked complete
        assert h.evals[-1].status == "complete"
        # allocs landed in state
        out = h.state.allocs_by_job("default", job.id)
        assert len(out) == 10
        # names unique, indexes 0..9
        names = sorted(a.name for a in out)
        assert names == sorted(f"{job.id}.web[{i}]" for i in range(10))
        h.assert_same()

    def test_spread_across_nodes(self):
        """Default even distribution: with 10 nodes and 10 allocs, job
        anti-affinity should avoid stacking everything on one node."""
        h = Harness()
        register_nodes(h, 10)
        job = mock.job()
        h.state.upsert_job(job)
        h.process(eval_for(job))
        out = h.state.allocs_by_job("default", job.id)
        used_nodes = {a.node_id for a in out}
        assert len(used_nodes) > 1
        h.assert_same()

    def test_exhausted_creates_blocked_eval(self):
        h = Harness()
        register_nodes(h, 2)
        job = mock.job()
        job.task_groups[0].tasks[0].resources.cpu = 3000  # 2 nodes × 3900 usable
        h.state.upsert_job(job)
        h.process(eval_for(job))
        out = h.state.allocs_by_job("default", job.id)
        assert 0 < len(out) < 10
        # blocked eval created for the remainder
        assert len(h.create_evals) == 1
        assert h.create_evals[0].status == "blocked"
        # failed TG allocs recorded on the eval update
        assert h.evals[-1].failed_tg_allocs.get("web") is not None
        h.assert_same()

    def test_infeasible_constraint_blocks_all(self):
        h = Harness()
        register_nodes(h, 5)
        job = mock.job()
        job.constraints.append(Constraint("${attr.kernel.name}", "windows", "="))
        h.state.upsert_job(job)
        h.process(eval_for(job))
        out = h.state.allocs_by_job("default", job.id)
        assert len(out) == 0
        assert len(h.create_evals) == 1
        h.assert_same()

    def test_no_nodes(self):
        h = Harness()
        job = mock.job()
        h.state.upsert_job(job)
        h.process(eval_for(job))
        assert len(h.state.allocs_by_job("default", job.id)) == 0
        h.assert_same()

    def test_annotate_plan(self):
        h = Harness()
        register_nodes(h, 5)
        job = mock.job()
        h.state.upsert_job(job)
        ev = eval_for(job)
        ev.annotate_plan = True
        h.process(ev)
        plan = h.plans[0]
        assert plan.annotations is not None
        assert plan.annotations.desired_tg_updates["web"].place == 10
        h.assert_same()


class TestServiceSchedJobModify:
    def _setup_running(self, h, n_nodes=10):
        nodes = register_nodes(h, n_nodes)
        job = mock.job()
        h.state.upsert_job(job)
        h.process(eval_for(job))
        for a in h.state.allocs_by_job("default", job.id):
            a.client_status = "running"
            h.state.upsert_alloc(a)
        return job, nodes

    def test_count_up(self):
        h = Harness()
        job, _ = self._setup_running(h)
        job2 = mock.job(id=job.id)
        job2.task_groups[0].count = 15
        job2.version = job.version  # same spec, just scaled
        h.state.upsert_job(job2)
        h.process(eval_for(job2))
        live = [
            a for a in h.state.allocs_by_job("default", job.id)
            if not a.terminal_status()
        ]
        assert len(live) == 15
        h.assert_same()

    def test_count_down(self):
        h = Harness()
        job, _ = self._setup_running(h)
        job2 = mock.job(id=job.id)
        job2.task_groups[0].count = 4
        job2.version = job.version
        h.state.upsert_job(job2)
        h.process(eval_for(job2))
        live = [
            a for a in h.state.allocs_by_job("default", job.id)
            if not a.terminal_status()
        ]
        assert len(live) == 4
        # highest indexes removed first (reconcile_util.go Highest)
        names = sorted(a.name for a in live)
        assert names == sorted(f"{job.id}.web[{i}]" for i in range(4))
        h.assert_same()

    def test_destructive_update(self):
        h = Harness()
        job, _ = self._setup_running(h)
        job2 = mock.job(id=job.id)
        job2.version = job.version + 1
        job2.create_index = job.create_index
        job2.task_groups[0].tasks[0].config = {"command": "/bin/other"}
        h.state.upsert_job(job2)
        h.process(eval_for(job2))
        plan = h.plans[-1]
        stops = [a for allocs in plan.node_update.values() for a in allocs]
        places = [a for allocs in plan.node_allocation.values() for a in allocs]
        assert len(stops) == 10
        assert len(places) == 10
        h.assert_same()

    def test_job_deregister(self):
        h = Harness()
        job, _ = self._setup_running(h)
        job.stop = True
        h.state.upsert_job(job)
        h.process(eval_for(job, triggered_by="job-deregister"))
        live = [
            a for a in h.state.allocs_by_job("default", job.id)
            if not a.terminal_status()
        ]
        assert len(live) == 0
        h.assert_same()


class TestServiceSchedNodeDown:
    def test_node_down_reschedules(self):
        h = Harness()
        nodes = register_nodes(h, 5)
        job = mock.job()
        job.task_groups[0].count = 5
        h.state.upsert_job(job)
        h.process(eval_for(job))
        for a in h.state.allocs_by_job("default", job.id):
            a.client_status = "running"
            h.state.upsert_alloc(a)

        # Kill one node that has allocs
        victim_id = next(
            a.node_id for a in h.state.allocs_by_job("default", job.id)
        )
        victim = h.state.node_by_id(victim_id)
        victim.status = "down"
        h.state.upsert_node(victim)

        h.process(eval_for(job, triggered_by="node-update"))
        allocs = h.state.allocs_by_job("default", job.id)
        lost = [a for a in allocs if a.client_status == "lost"]
        assert len(lost) >= 1
        live = [a for a in allocs if not a.terminal_status()]
        assert len(live) == 5
        assert all(a.node_id != victim_id for a in live)
        h.assert_same()


class TestSystemSched:
    def test_place_on_all_nodes(self):
        h = Harness()
        register_nodes(h, 8)
        job = mock.system_job()
        h.state.upsert_job(job)
        h.process(eval_for(job))
        out = h.state.allocs_by_job("default", job.id)
        assert len(out) == 8
        assert len({a.node_id for a in out}) == 8
        h.assert_same()

    def test_new_node_gets_alloc(self):
        h = Harness()
        register_nodes(h, 4)
        job = mock.system_job()
        h.state.upsert_job(job)
        h.process(eval_for(job))
        assert len(h.state.allocs_by_job("default", job.id)) == 4

        register_nodes(h, 1)
        h.process(eval_for(job, triggered_by="node-update"))
        assert len(h.state.allocs_by_job("default", job.id)) == 5
        h.assert_same()

    def test_constraint_filters_nodes(self):
        h = Harness()
        register_nodes(h, 4)
        bad = mock.node()
        bad.attributes = dict(bad.attributes, **{"kernel.name": "darwin"})
        h.state.upsert_node(bad)
        job = mock.system_job()
        h.state.upsert_job(job)
        h.process(eval_for(job))
        out = h.state.allocs_by_job("default", job.id)
        assert len(out) == 4
        assert all(a.node_id != bad.id for a in out)
        h.assert_same()


    def test_distinct_property_limits_per_value(self):
        """System jobs honor distinct_property too (SystemStack includes
        the DistinctPropertyIterator, reference stack.go:248)."""
        from nomad_tpu.structs import Constraint

        h = Harness()
        nodes = register_nodes(h, 6)
        for i, n in enumerate(nodes):
            n.attributes = dict(n.attributes, rack=f"r{i % 3}")
            h.state.upsert_node(n)
        job = mock.system_job()
        job.constraints.append(
            Constraint("${attr.rack}", "", "distinct_property"))
        h.state.upsert_job(job)
        h.process(eval_for(job))
        out = h.state.allocs_by_job("default", job.id)
        assert len(out) == 3  # one per rack, not one per node
        racks = set()
        for a in out:
            node = h.state.node_by_id(a.node_id)
            racks.add(node.attributes["rack"])
        assert len(racks) == 3
        h.assert_same()


class TestBatchSched:
    def test_batch_complete_not_replaced(self):
        h = Harness()
        register_nodes(h, 3)
        job = mock.batch_job()
        job.task_groups[0].count = 2
        h.state.upsert_job(job)
        h.process(eval_for(job))
        allocs = h.state.allocs_by_job("default", job.id)
        assert len(allocs) == 2
        # complete batch allocs are not rescheduled
        for a in allocs:
            a.client_status = "complete"
            h.state.upsert_alloc(a)
        h.process(eval_for(job, triggered_by="job-register"))
        live = [
            a for a in h.state.allocs_by_job("default", job.id)
            if not a.client_terminal_status()
        ]
        assert len(live) == 0
        h.assert_same()


class TestPortExhaustionPlacement:
    """A node that cannot satisfy the group's port asks must FAIL the
    placement — an alloc is never placed with its ports silently dropped
    (reference rank.go:231-320 ranks such nodes out)."""

    def _port_job(self, count=1, port=8080):
        from nomad_tpu.structs import NetworkResource, Port

        job = mock.job()
        tg = job.task_groups[0]
        tg.count = count
        tg.tasks[0].resources.networks = [NetworkResource(
            mbits=1, reserved_ports=[Port("http", port)])]
        return job

    def test_networkless_node_fails_placement(self):
        h = Harness()
        node = mock.node()
        node.node_resources.networks = []  # no IP → no offer possible
        h.state.upsert_node(node)
        job = self._port_job()
        h.state.upsert_job(job)
        h.process(eval_for(job))
        placed = [a for p in h.plans for allocs in p.node_allocation.values()
                  for a in allocs]
        assert placed == []
        # blocked eval created for the failed group
        assert any(e.status == "blocked" for e in h.create_evals)
        h.assert_same()

    def test_placed_alloc_always_carries_its_ports(self):
        h = Harness()
        register_nodes(h, 2)
        job = self._port_job(count=2)
        h.state.upsert_job(job)
        h.process(eval_for(job))
        placed = [a for p in h.plans for allocs in p.node_allocation.values()
                  for a in allocs]
        assert len(placed) == 2
        for a in placed:
            ports = [pt.value
                     for tr in a.allocated_resources.tasks.values()
                     for nw in tr.networks for pt in nw.reserved_ports]
            assert ports == [8080]
        # and they land on distinct nodes (same static port)
        assert len({a.node_id for a in placed}) == 2
        h.assert_same()

    def test_destructive_update_reuses_ports_same_node(self):
        """In-plan stops release their ports for the replacement (the
        proposed-alloc NetworkIndex of rank.go:240; kernel pclr credit):
        a destructive update on a single node must not dead-lock on the
        static port the outgoing alloc still holds in state."""
        h = Harness()
        register_nodes(h, 1)
        job = self._port_job()
        h.state.upsert_job(job)
        h.process(eval_for(job))
        first = [a for p in h.plans for allocs in p.node_allocation.values()
                 for a in allocs]
        assert len(first) == 1

        import copy

        job2 = copy.deepcopy(job)
        job2.version = 1
        job2.task_groups[0].tasks[0].config = {"run_for": 9.9}  # destructive
        h.state.upsert_job(job2)
        h.process(eval_for(job2))
        last = h.plans[-1]
        stops = [a for allocs in last.node_update.values() for a in allocs]
        placed = [a for allocs in last.node_allocation.values()
                  for a in allocs]
        assert len(stops) == 1 and stops[0].id == first[0].id
        assert len(placed) == 1 and placed[0].node_id == first[0].node_id
        ports = [pt.value
                 for tr in placed[0].allocated_resources.tasks.values()
                 for nw in tr.networks for pt in nw.reserved_ports]
        assert ports == [8080]
        h.assert_same()
