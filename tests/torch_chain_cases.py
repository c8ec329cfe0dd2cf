"""Shared inputs for the port's chain, wave and program-table tests.

Programs are compiled by the reference package (`TPUStack.compile_tg`)
over a seeded synthetic cluster and laid out by the reference's own
device program table, then carried as numpy into the port
(`convert.py`), so both packages run on identical inputs.
"""
from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from nomad_tpu import mock
from nomad_tpu.lib.transfer import default_ledger
from nomad_tpu.scheduler.stack import PlanContext, TPUStack
from nomad_tpu.server.program_table import DeviceProgramTable
from nomad_tpu.synth import synth_node, synth_service_job
from nomad_tpu.tensor import ClusterTensors

from nomad_tpu_torch.convert import cluster_from_numpy, tensor_from_numpy

ATOL = 1e-6
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a module's plain versions on one intra-op thread: the suite
    runs in several worker processes at once, and torch's default (one
    thread per core in each) oversubscribes the host for the timing
    budgets other tests keep. Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_view(arrays) -> dict:
    return {k: np.asarray(v) for k, v in arrays._asdict().items()}


def port_cluster(arrays):
    """The reference view (jax arrays) as the port's CPU ClusterArrays."""
    return cluster_from_numpy(np_view(arrays), "cpu")


def port_bufs(*bufs):
    return tuple(tensor_from_numpy(np.asarray(b), CPU) for b in bufs)


def synth_cluster(n_nodes: int, n_allocs: int = 0, seed: int = 5):
    """A seeded synthetic cluster (reference ClusterTensors) with
    `n_allocs` running allocs spread over it."""
    rng = random.Random(seed)
    cl = ClusterTensors()
    nodes = [synth_node(rng, i) for i in range(n_nodes)]
    for n in nodes:
        cl.upsert_node(n)
    filler = synth_service_job(rng, count=1)
    allocs = []
    for k in range(n_allocs):
        a = mock.alloc(job=filler, node_id=nodes[k % n_nodes].id,
                       client_status="running")
        a.job_id = filler.id
        cl.upsert_alloc(a)
        allocs.append(a)
    return cl, nodes, rng, allocs


def mixed_programs(cl, nodes, rng, allocs, n_prog: int = 4,
                   n_place: int = 3):
    """Programs of mixed stanzas, one carrying plan-relative deltas
    (stopped allocs) and penalties."""
    stack = TPUStack(cl)
    kinds = [dict(with_affinity=True), dict(with_spread=True),
             dict(distinct_hosts=True), dict(distinct_property=True),
             dict(), dict(with_affinity=True, with_spread=True)]
    progs = []
    for i in range(n_prog):
        job = synth_service_job(rng, count=n_place, **kinds[i % len(kinds)])
        plan = None
        if i == 1:
            plan = PlanContext(
                stopped_allocs=allocs[:3],
                penalty_node_ids=[frozenset({nodes[0].id, nodes[1].id})])
        p, _m = stack.compile_tg(job, job.task_groups[0], n_place, plan)
        progs.append(p)
    return stack, progs


def table_prep(params_list):
    """The reference table's transport for `params_list`: (prep, ti, tf,
    tu) as numpy."""
    table = DeviceProgramTable()
    prep = table.prepare(params_list)
    assert prep is not None
    com = table.commit(prep, default_ledger())
    assert com is not None
    ti, tf, tu = (np.asarray(x) for x in com[:3])
    return prep, ti, tf, tu


def assert_outputs(ref, got, float_idx=(1,), explain=False, what=""):
    """Flat chain/wave outputs: (sel, score, feasible, fit[, explain
    leaves][, collisions]). Integer leaves equal, float leaves within
    ATOL."""
    from nomad_tpu_torch.kernels.placement import PlacementExplain

    floats = set(float_idx)
    if explain:
        names = PlacementExplain._fields
        floats |= {4 + names.index("topk_score"),
                   4 + names.index("topk_parts")}
    assert len(ref) == len(got), (what, len(ref), len(got))
    for i, (r, g) in enumerate(zip(ref, got)):
        r = np.asarray(r)
        g = g.numpy()
        assert r.shape == g.shape, (what, i, r.shape, g.shape)
        if i in floats:
            np.testing.assert_allclose(r, g, rtol=0, atol=ATOL,
                                       err_msg=f"{what} leaf {i}")
        else:
            np.testing.assert_array_equal(r, g, err_msg=f"{what} leaf {i}")


def assert_carry(ref, got, what=""):
    for r, g, name in zip(ref, got, ("used", "dyn_free")):
        np.testing.assert_allclose(np.asarray(r), g.numpy(), rtol=0,
                                   atol=ATOL, err_msg=f"{what} {name}")
