"""The system scheduler in the port, against the reference package.

- K2's plain version (`kernels/placement.py` `system_feasibility_plain`)
  against the reference's `system_feasibility` on CPU XLA, on the same
  numpy cluster and program: the `torch_cases` programs (constraints, a
  datacenter filter, node eligibility, plan deltas with released and
  consumed ports, reserved and dynamic port asks, rows with no fit) and
  seeded fuzz programs (repeated and −1-padded delta rows, released and
  consumed ports in and out of the dynamic range, an `extra_mask` of one
  entry broadcast and one of N). Both masks must be equal exactly: they
  are booleans.
- Twins of `tests/test_generic_sched.py::TestSystemSched` through both
  packages' Harnesses (`torch_sched_cases.Twins`): equal plans by content.
- BASELINE config 4 at 300 nodes and 3,000 running allocs (the density
  of the 10,000-node cluster): two `synth_system_job` evals through both
  Harnesses, with system preemption on by default; the plans, victims
  included, must be equal by content.
- A `Server(device="cpu")` twin: a system job registered on both
  packages' `Server`s completes and places on the same nodes.
"""
import random
import zlib

import numpy as np
import pytest

import torch_cases as tc
from nomad_tpu import mock as ref_mock
from nomad_tpu.kernels.placement import system_feasibility as ref_system
from nomad_tpu.scheduler.stack import TPUStack, _to_device
from nomad_tpu.structs import Constraint
from nomad_tpu.synth import (build_synthetic_state, synth_node,
                             synth_system_job)
from torch_sched_cases import Twins, placed, wire

from nomad_tpu_torch.convert import cluster_from_numpy, params_from_numpy
from nomad_tpu_torch.kernels import placement as kp

#: programs of `torch_cases` that exercise K2's terms
K2_CASES = ("basic_binpack", "equality_constraint", "regexp_constraint",
            "infeasible_constraint", "datacenter_filter", "node_ineligible",
            "resource_exhaustion", "set_contains", "port_conflict",
            "port_all_exhausted", "port_dynamic_exhaustion",
            "port_released", "plan_delta_ports", "sampled")


def _program(name):
    case = tc.build(name)
    stack = TPUStack(case.cluster)
    params, _m = stack.compile_tg(case.job, case.job.task_groups[0],
                                  case.n_place, case.plan,
                                  sampled_rows=case.sampled_rows)
    arrays = {k: np.array(v) for k, v in stack.device_arrays()._asdict()
              .items()}
    return arrays, params


def _fuzz(extra: str):
    """The plan-delta program with seeded plan rows: 12 delta rows over
    few nodes (repeats) and −1 pads, released and consumed ports (the
    asked ports and others, in and out of 20000–32000), used near
    capacity, and port bits set at random."""
    arrays, params = _program("plan_delta_ports")
    rng = np.random.default_rng(zlib.crc32(extra.encode()))
    n, r = arrays["capacity"].shape
    frac = rng.uniform(0.8, 1.0, size=(n, 2))
    arrays["used"][:, :2] = np.floor(arrays["capacity"][:, :2] * frac)
    arrays["dyn_free"] = rng.integers(0, 3, size=n).astype(np.float32)
    asked = [int(x) for x in np.asarray(params.res_ports) if x >= 0]
    for port in asked:
        hit = rng.random(n) < 0.5
        arrays["ports_used"][hit, port >> 5] |= np.uint32(1 << (port & 31))
    delta_idx = rng.integers(0, 6, size=12).astype(np.int32)
    delta_idx[rng.random(12) < 0.25] = -1
    ports = np.array(asked + [20001, 20500, 31999, 32000, 32001, 8000],
                     dtype=np.int32)
    pc = rng.integers(-1, n, size=10).astype(np.int32)
    ps = rng.integers(-1, n, size=10).astype(np.int32)
    mask = (np.ones(1, dtype=bool) if extra == "broadcast"
            else rng.random(n) < 0.8)
    params = params._replace(
        delta_idx=delta_idx,
        delta_res=rng.integers(0, 400, size=(12, r)).astype(np.float32),
        pclr_idx=pc, pclr_port=rng.choice(ports, size=10),
        pset_idx=ps, pset_port=rng.choice(ports, size=10),
        n_dyn=np.float32(1.0), extra_mask=mask)
    return arrays, params


def _inputs(name):
    if name.startswith("fuzz_"):
        return _fuzz(name[5:])
    return _program(name)


@pytest.mark.parametrize(
    "name", K2_CASES + ("fuzz_broadcast", "fuzz_per_row"))
def test_k2_plain_matches_reference(name):
    arrays, params = _inputs(name)
    from nomad_tpu.kernels.placement import ClusterArrays as RefArrays
    import jax.numpy as jnp

    ref_feas, ref_fit = ref_system(
        RefArrays(**{k: jnp.asarray(v) for k, v in arrays.items()}),
        _to_device(params))
    feas, fit = kp.system_feasibility(cluster_from_numpy(arrays, "cpu"),
                                      params_from_numpy(params, "cpu"))
    np.testing.assert_array_equal(np.asarray(ref_feas), feas.numpy())
    np.testing.assert_array_equal(np.asarray(ref_fit), fit.numpy())
    assert feas.dtype == fit.dtype == kp.torch.bool
    if name.startswith("fuzz_"):
        # the fuzz reaches both sides of every term
        assert 0 < int(fit.sum()) < int(feas.sum())


def test_cpu_tensors_never_launch_the_kernel():
    arrays, params = _program("basic_binpack")
    before = kp.system_launch_count()
    kp.system_feasibility(cluster_from_numpy(arrays, "cpu"),
                          params_from_numpy(params, "cpu"))
    assert kp.system_launch_count() == before


# ---- twins of test_generic_sched.py TestSystemSched -------------------------


def _register(t, n, **overrides):
    nodes = []
    for _ in range(n):
        node = ref_mock.node(**overrides)
        t.upsert_node(node)
        nodes.append(node)
    return nodes


def _eval(job, **kw):
    return ref_mock.eval_(job_id=job.id, type=job.type,
                          priority=job.priority, **kw)


class TestSystemSched:
    def test_place_on_all_nodes(self):
        t = Twins()
        _register(t, 8)
        job = ref_mock.system_job()
        t.upsert_job(job)
        t.process(_eval(job))
        t.assert_same()
        out = t.port.state.allocs_by_job("default", job.id)
        assert len(out) == 8 and len({a.node_id for a in out}) == 8

    def test_new_node_gets_alloc(self):
        t = Twins()
        _register(t, 4)
        job = ref_mock.system_job()
        t.upsert_job(job)
        t.process(_eval(job))
        assert len(t.port.state.allocs_by_job("default", job.id)) == 4
        _register(t, 1)
        t.process(_eval(job, triggered_by="node-update"))
        t.assert_same()
        assert len(t.port.state.allocs_by_job("default", job.id)) == 5

    def test_constraint_filters_nodes(self):
        t = Twins()
        _register(t, 4)
        bad = ref_mock.node()
        bad.attributes = dict(bad.attributes, **{"kernel.name": "darwin"})
        t.upsert_node(bad)
        job = ref_mock.system_job()
        t.upsert_job(job)
        t.process(_eval(job))
        t.assert_same()
        out = t.port.state.allocs_by_job("default", job.id)
        assert len(out) == 4 and all(a.node_id != bad.id for a in out)

    def test_distinct_property_limits_per_value(self):
        t = Twins()
        nodes = _register(t, 6)
        for i, n in enumerate(nodes):
            n.attributes = dict(n.attributes, rack=f"r{i % 3}")
            t.upsert_node(n)
        job = ref_mock.system_job()
        job.constraints.append(
            Constraint("${attr.rack}", "", "distinct_property"))
        t.upsert_job(job)
        t.process(_eval(job))
        t.assert_same()
        out = t.port.state.allocs_by_job("default", job.id)
        racks = {t.port.state.node_by_id(a.node_id).attributes["rack"]
                 for a in out}
        assert len(out) == 3 and len(racks) == 3


# ---- BASELINE config 4, cut to 300 nodes -------------------------------------


def test_config4_plans_match_reference():
    state, _nodes = build_synthetic_state(300, 3000, seed=3)
    t = Twins(state)
    rng = random.Random(4)
    for _ in range(2):
        job = synth_system_job(rng)
        t.upsert_job(job)
        t.process(_eval(job))
    t.assert_same()
    got = placed(t.port)
    with_victims = [a for a in got if a.preempted_allocations]
    # one alloc per node and eval; full small nodes evict filler allocs
    assert len(got) == 600 and with_victims
    for a in with_victims:
        for vid in a.preempted_allocations:
            v = t.port.state.alloc_by_id(vid)
            assert v.desired_status == "evict"
            assert v.job.priority < 80


# ---- the Server twin ----------------------------------------------------------


def _server_nodes(server_mod, nodes, job, **kw):
    s = server_mod.Server(server_mod.ServerConfig(
        num_schedulers=1, heartbeat_ttl=3600.0, eval_batch=4), **kw)
    try:
        s.start()
        for n in nodes:
            s.state.upsert_node(n)
        ev = s.job_register(job)
        got = s.wait_for_eval(ev.id, statuses=(
            "complete", "failed", "blocked", "cancelled"), timeout=120.0)
        assert got is not None and got.status == "complete", got
        names = {nid: nd.name for nid, nd in s.state._nodes.items()}
        return sorted(names[a.node_id]
                      for a in s.state.allocs_by_job("default", job.id))
    finally:
        s.shutdown()


def test_server_system_eval_matches_reference(monkeypatch):
    from nomad_tpu import server as ref_server
    from nomad_tpu_torch import server as port_server

    monkeypatch.delenv("NOMAD_TPU_EVAL_BATCH", raising=False)
    rng = random.Random(21)
    nodes = [synth_node(rng, i) for i in range(24)]
    nodes[5].attributes["kernel.name"] = "darwin"   # constraint-filtered
    job = synth_system_job(rng)
    ref = _server_nodes(ref_server, nodes, job)
    got = _server_nodes(port_server, [wire(n) for n in nodes], wire(job),
                        device="cpu")
    assert got == ref and len(got) == 23
