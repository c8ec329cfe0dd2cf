"""The port's device program table against the reference's.

One feed of compiled programs (the reference's `TPUStack.compile_tg`,
carried as numpy) goes through both `DeviceProgramTable`s: the port's on
CPU tensors (its insert is the plain `index_copy_` version of the row
scatter) and the reference's on CPU XLA. They must assign the same rows,
produce the same static/dynamic specs and dynamic rows, hold equal
tables after every commit, give up (`prepare` → None) at the same
ceilings, flush at the same cap growth, and report equal `stats`.
"""
import random

import numpy as np
import pytest
import torch

from nomad_tpu import mock
from torch_chain_cases import one_torch_thread  # noqa: F401
from nomad_tpu.lib.transfer import default_ledger as jax_ledger
from nomad_tpu.scheduler.stack import TPUStack
from nomad_tpu.server import program_table as jpt
from nomad_tpu.structs import Constraint, Spread, SpreadTarget
from nomad_tpu.tensor import ClusterTensors

from nomad_tpu_torch.kernels import rows as kr
from nomad_tpu_torch.lib.transfer import default_ledger
from nomad_tpu_torch.server import program_table as tpt


def _cluster(n_nodes=12):
    cl = ClusterTensors()
    for i in range(n_nodes):
        n = mock.node()
        n.id = f"node-{i}"
        n.node_resources.cpu = 4000
        n.node_resources.memory_mb = 8192
        cl.upsert_node(n)
    return cl


def _job(rng, i, extra_constraints=0):
    j = mock.job()
    j.task_groups[0].tasks[0].resources.cpu = rng.choice((100, 250, 400)) + i
    j.task_groups[0].tasks[0].resources.memory_mb = rng.choice((64, 128))
    j.task_groups[0].networks = []
    if i % 2 == 0:
        j.constraints.append(Constraint("${node.datacenter}", "dc1", "="))
    if i % 3 == 0:
        j.spreads.append(Spread(attribute="${node.datacenter}", weight=50,
                                spread_target=[SpreadTarget(value="dc1",
                                                            percent=60)]))
    if i % 5 == 0:
        j.constraints.append(Constraint(operand="distinct_hosts"))
    for k in range(extra_constraints):
        j.constraints.append(Constraint("${node.datacenter}", f"dc-{k}",
                                        "!="))
    return j


def _feed():
    """Rounds of programs: repeats (dedup), new content (inserts), a cap
    growth (flush) and an over-ceiling program (fallback)."""
    rng = random.Random(3)
    cl = _cluster()
    stack = TPUStack(cl)
    jobs = [_job(rng, i) for i in range(6)]

    def compile_(js, n_place=2):
        return [stack.compile_tg(j, j.task_groups[0], n_place, None)[0]
                for j in js]

    return [
        compile_(jobs[:3]),
        compile_(jobs[:3]),                      # steady state
        compile_(jobs[2:6]),                     # two new rows
        compile_([_job(rng, 7, extra_constraints=20)]),   # caps growth
        compile_([_job(rng, 8, extra_constraints=200)]),  # over ceiling
        compile_(jobs[:2], n_place=3),
    ]


def _assert_tables(ref_com, got_com):
    for r, g in zip(ref_com[:3], got_com[:3]):
        r = np.asarray(r)
        assert r.shape == tuple(g.shape) and r.dtype == g.numpy().dtype
        np.testing.assert_array_equal(r, g.numpy())


@pytest.mark.parametrize("capacity", [None, 4], ids=["roomy", "lru_4"])
def test_program_table_matches_reference(capacity):
    ref = jpt.DeviceProgramTable(capacity=capacity)
    got = tpt.DeviceProgramTable(capacity=capacity, device="cpu")
    launches = kr.launch_count()
    for i, progs in enumerate(_feed()):
        rp, gp = ref.prepare(progs), got.prepare(progs)
        assert (rp is None) == (gp is None), i
        if rp is None:
            continue
        np.testing.assert_array_equal(rp.rows, gp.rows, err_msg=str(i))
        assert rp.sspec == gp.sspec and rp.dspec == gp.dspec, i
        assert rp.m == gp.m and rp.gen == gp.gen, i
        for a, b in ((rp.dyn_i, gp.dyn_i), (rp.dyn_f, gp.dyn_f),
                     (rp.dyn_u, gp.dyn_u)):
            np.testing.assert_array_equal(a, b, err_msg=str(i))
        rc = ref.commit(rp, jax_ledger())
        gc = got.commit(gp, default_ledger())
        assert (rc is None) == (gc is None), i
        _assert_tables(rc, gc)
        assert ref.stats() == got.stats(), i
    assert got.flushes >= 2 and got.inserts > 3
    # CPU tables insert through the plain version, never the kernel
    assert kr.launch_count() == launches


def test_stale_generation_commit_rejected():
    rng = random.Random(3)
    stack = TPUStack(_cluster())
    j = _job(rng, 0)
    progs = [stack.compile_tg(j, j.task_groups[0], 2, None)[0]]
    table = tpt.DeviceProgramTable(device="cpu")
    prep = table.prepare(progs)
    with table._lock:
        table._flush_locked()   # a caps flush races the commit
    assert table.commit(prep, default_ledger()) is None


def test_insert_never_writes_committed_tables():
    """An insert copies the tables: handles an earlier commit returned
    keep their contents (a dispatch may still read them)."""
    rng = random.Random(5)
    stack = TPUStack(_cluster())
    table = tpt.DeviceProgramTable(device="cpu")
    jobs = [_job(rng, i) for i in range(3)]
    progs = [stack.compile_tg(j, j.task_groups[0], 2, None)[0]
             for j in jobs]
    first = table.commit(table.prepare(progs[:1]), default_ledger())
    before = [t.clone() for t in first[:3]]
    second = table.commit(table.prepare(progs[1:]), default_ledger())
    for old, snap, new in zip(first[:3], before, second[:3]):
        assert torch.equal(old, snap)
        assert old.data_ptr() != new.data_ptr()


def test_table_for_is_per_cluster_and_device():
    cl = _cluster(4)
    a = tpt.table_for(cl, "cpu")
    assert tpt.table_for(cl, "cpu") is a
    assert tpt.table_for(_cluster(4), "cpu") is not a
    assert a.device == torch.device("cpu")
