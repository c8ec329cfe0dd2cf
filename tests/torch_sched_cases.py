"""Twin schedulers for the port's system-scheduler and preemption tests.

`Twins` holds the reference `Harness` (JAX on the CPU) and the port's
`Harness(device="cpu")`. Every node, job, alloc and eval is built once,
with the reference package's mocks or synthetic generator, and handed to
both: the port gets it over the wire codec, so ids, priorities and
resources are the same in both states. Plans are compared by content,
never by new alloc ids (`fast_uuid` makes those random in both packages):
each placement by (node, task group, name), its victims by their ids,
which come from the shared state.
"""
from __future__ import annotations

import pytest

from nomad_tpu.scheduler.harness import Harness, InMemState
from nomad_tpu.structs.codec import to_wire

from nomad_tpu_torch.scheduler.harness import (Harness as TorchHarness,
                                               InMemState as TorchState)
from nomad_tpu_torch.structs.codec import from_wire

#: normalized scores: XLA's exp and torch's differ by an ulp or two
ATOL = 1e-6


def wire(obj):
    """The port's copy of a reference object."""
    return from_wire(to_wire(obj))


def port_state(state: InMemState) -> TorchState:
    """The port's copy of a reference state: nodes, jobs, then allocs, in
    the reference's insertion order."""
    out = TorchState()
    for node in state.nodes():
        out.upsert_node(wire(node))
    for job in state.jobs():
        out.upsert_job(wire(job))
    for alloc in state._allocs.values():
        out.upsert_alloc(wire(alloc))
    return out


class Twins:
    """A reference Harness and the port's, fed the same objects."""

    def __init__(self, state: InMemState = None):
        state = state if state is not None else InMemState()
        self.ref = Harness(state)
        self.port = TorchHarness(port_state(state), device="cpu")

    def upsert_node(self, node):
        self.ref.state.upsert_node(node)
        self.port.state.upsert_node(wire(node))

    def upsert_job(self, job):
        self.ref.state.upsert_job(job)
        self.port.state.upsert_job(wire(job))

    def upsert_alloc(self, alloc):
        self.ref.state.upsert_alloc(alloc)
        self.port.state.upsert_alloc(wire(alloc))

    def set_scheduler_config(self, **kw):
        from nomad_tpu.scheduler.util import SchedulerConfiguration
        from nomad_tpu_torch.scheduler.util import (
            SchedulerConfiguration as TorchConfig)

        self.ref.state.set_scheduler_config(SchedulerConfiguration(**kw))
        self.port.state.set_scheduler_config(TorchConfig(**kw))

    def process(self, ev):
        self.ref.process(ev)
        self.port.process(wire(ev))

    def assert_same(self):
        """Equal plans (by content), eval statuses and failure metrics."""
        assert len(self.port.plans) == len(self.ref.plans)
        for ref_plan, plan in zip(self.ref.plans, self.port.plans):
            assert_same_plan(ref_plan, plan)
        assert [e.status for e in self.port.evals] == \
            [e.status for e in self.ref.evals]
        assert [failed_view(e) for e in self.port.evals] == \
            [failed_view(e) for e in self.ref.evals]
        assert [(e.type, e.status) for e in self.port.create_evals] == \
            [(e.type, e.status) for e in self.ref.create_evals]


def _metric_counts(m):
    return (m.nodes_evaluated, m.nodes_filtered, m.nodes_exhausted,
            dict(m.constraint_filtered), dict(m.dimension_exhausted),
            dict(m.nodes_available))


def plan_content(plan):
    """A plan as comparable data: placements (node, group, name, sorted
    victim ids, metric counts), their normalized scores, evictions and
    stops by (node, alloc id), and the carry flag."""
    placed, scores = [], {}
    for node_id, allocs in plan.node_allocation.items():
        for a in allocs:
            key = (node_id, a.task_group, a.name)
            placed.append(key + (tuple(sorted(a.preempted_allocations or ())),
                                 _metric_counts(a.metrics)))
            scores[key] = [s.norm_score for s in a.metrics.score_meta]
    evicted = sorted((nid, a.id) for nid, allocs
                     in plan.node_preemptions.items() for a in allocs)
    stopped = sorted((nid, a.id, a.desired_description) for nid, allocs
                     in plan.node_update.items() for a in allocs)
    return dict(placed=sorted(placed, key=repr), evicted=evicted,
                stopped=stopped, carry_exact=plan.carry_exact), scores


def assert_same_plan(ref_plan, plan):
    ref_c, ref_s = plan_content(ref_plan)
    got_c, got_s = plan_content(plan)
    assert got_c == ref_c
    assert set(got_s) == set(ref_s)
    for key, want in ref_s.items():
        assert got_s[key] == pytest.approx(want, abs=ATOL), key


def failed_view(ev):
    return {tg: (m.nodes_evaluated, m.nodes_filtered, m.nodes_exhausted,
                 dict(m.constraint_filtered), dict(m.dimension_exhausted),
                 m.coalesced_failures)
            for tg, m in ev.failed_tg_allocs.items()}


def placed(h):
    """Every alloc placed by the harness's plans."""
    return [a for p in h.plans for allocs in p.node_allocation.values()
            for a in allocs]
