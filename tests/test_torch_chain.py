"""The port's chain transports (K4) against the reference package's.

`place_table_chain`, `place_task_group_chain` and `place_packed_chain` of
`nomad_tpu_torch.kernels.placement` run their plain PyTorch versions on
CPU tensors; the reference's run on CPU XLA. Inputs are the reference's
own compiled programs, program-table rows and packed buffers, carried as
numpy (`torch_chain_cases`). Indices, counts and carries must be equal;
scores and float carries within 1e-6 (values in [-2, 1]; XLA's exp2 and
torch.exp2 may differ by an ulp).

Also the twins of `tests/test_select_batch.py`'s chain cases on the port:
over-commit avoidance, chain == sequential singles with the carry folded,
and an inert pad program passing the carry through.
"""
import numpy as np
import pytest
import torch

import torch_chain_cases as cc
from torch_chain_cases import one_torch_thread  # noqa: F401
from nomad_tpu import mock
from nomad_tpu.kernels import placement as jp
from nomad_tpu.parallel.mesh import pad_params, stack_params
from nomad_tpu.scheduler.stack import TPUStack
from nomad_tpu.server.select_batch import _inert_program as jax_inert
from nomad_tpu.tensor import ClusterTensors

from nomad_tpu_torch.convert import params_from_numpy
from nomad_tpu_torch.kernels import placement as tp
from nomad_tpu_torch.server.select_batch import _inert_program


def _programs(n_prog=4, pad=False):
    cl, nodes, rng, allocs = cc.synth_cluster(24, n_allocs=40)
    stack, progs = cc.mixed_programs(cl, nodes, rng, allocs, n_prog=n_prog)
    if pad:
        progs = progs + [jax_inert(progs[0])]
    return stack, progs


@pytest.mark.parametrize("explain", [False, True], ids=["plain", "explain"])
@pytest.mark.parametrize("pad", [False, True], ids=["full", "inert_pad"])
def test_table_chain_matches_reference(explain, pad):
    stack, progs = _programs(pad=pad)
    prep, ti, tf, tu = cc.table_prep(progs)
    arrays = stack.device_arrays()
    ref, ref_carry = jp.place_table_chain(
        arrays, ti, tf, tu, prep.rows, prep.dyn_i, prep.dyn_f, prep.dyn_u,
        prep.sspec, prep.dspec, prep.m, explain=explain)
    got, got_carry = tp.place_table_chain(
        cc.port_cluster(arrays), *cc.port_bufs(ti, tf, tu), prep.rows,
        *cc.port_bufs(prep.dyn_i, prep.dyn_f, prep.dyn_u), prep.sspec,
        prep.dspec, prep.m, explain=explain)
    cc.assert_outputs(ref, got, explain=explain, what="table chain")
    cc.assert_carry(ref_carry, got_carry, "table chain")
    assert (np.asarray(ref[0]) >= 0).any(), "nothing placed: vacuous"
    if pad:
        assert (got[0][-1] == -1).all(), "the pad program placed"


@pytest.mark.parametrize("explain", [False, True], ids=["plain", "explain"])
def test_task_group_chain_matches_reference(explain):
    stack, progs = _programs()
    batched, m = stack_params(progs)
    arrays = stack.device_arrays()
    ref = jp.place_task_group_chain(arrays, batched, m, explain=explain)
    got = tp.place_task_group_chain(cc.port_cluster(arrays),
                                    params_from_numpy(batched, "cpu"), m,
                                    explain=explain)
    for f in ("sel_idx", "nodes_feasible", "nodes_fit"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                      getattr(got, f).numpy(), err_msg=f)
    for f in ("sel_score", "new_used", "final_scores0"):
        np.testing.assert_allclose(np.asarray(getattr(ref, f)),
                                   getattr(got, f).numpy(), rtol=0,
                                   atol=cc.ATOL, err_msg=f)
    if explain:
        cc.assert_outputs(tuple(ref.explain), tuple(got.explain),
                          float_idx=(10, 11), what="explain")


@pytest.mark.parametrize("explain", [False, True], ids=["plain", "explain"])
def test_packed_chain_matches_reference(explain):
    stack, progs = _programs()
    batched, m = stack_params(progs)
    ibuf, fbuf, ubuf, spec = jp.pack_params(batched)
    arrays = stack.device_arrays()
    ref = jp.place_packed_chain(arrays, ibuf, fbuf, ubuf, spec, m,
                                explain=explain)
    got = tp.place_packed_chain(cc.port_cluster(arrays),
                                *cc.port_bufs(ibuf, fbuf, ubuf), spec, m,
                                explain=explain)
    cc.assert_outputs(ref, got, explain=explain, what="packed chain")


def _mini_cluster(n_nodes, cpu=1000.0, mem=1024.0):
    cl = ClusterTensors()
    for i in range(n_nodes):
        n = mock.node()
        n.id = f"node-{i}"
        n.node_resources.cpu = int(cpu)
        n.node_resources.memory_mb = int(mem)
        cl.upsert_node(n)
    return cl


def _cpu_job(cpu):
    j = mock.job()
    j.task_groups[0].tasks[0].resources.cpu = cpu
    j.task_groups[0].tasks[0].resources.memory_mb = 64
    j.task_groups[0].networks = []
    return j


def test_chain_accounts_across_programs():
    """Two 600-cpu programs on 1000-cpu nodes: the second must move to
    another node, and the port agrees with the reference."""
    cl = _mini_cluster(4)
    stack = TPUStack(cl)
    progs = [stack.compile_tg(j, j.task_groups[0], 1, None)[0]
             for j in (_cpu_job(600), _cpu_job(600))]
    batched, m = stack_params(progs)
    arrays = stack.device_arrays()
    got = tp.place_task_group_chain(cc.port_cluster(arrays),
                                    params_from_numpy(batched, "cpu"), m)
    ref = jp.place_task_group_chain(arrays, batched, m)
    sel = got.sel_idx.numpy()
    assert sel[0][0] >= 0 and sel[1][0] >= 0
    assert sel[0][0] != sel[1][0], "chained programs over-committed a node"
    np.testing.assert_array_equal(np.asarray(ref.sel_idx), sel)


def test_chain_matches_sequential_singles():
    """The chain is sequential placement with (used, dyn_free) folded
    between programs, fused."""
    cl = _mini_cluster(8)
    stack = TPUStack(cl)
    progs = [stack.compile_tg(j, j.task_groups[0], 2, None)[0]
             for j in (_cpu_job(350), _cpu_job(450), _cpu_job(550))]
    batched, m = stack_params(progs)
    cluster = cc.port_cluster(stack.device_arrays())
    chain = tp.place_task_group_chain(
        cluster, params_from_numpy(batched, "cpu"), m).sel_idx.numpy()
    padded, m2 = pad_params(progs)
    cur, seq = cluster, []
    for p in padded:
        pt = params_from_numpy(p, "cpu")
        r = tp.place_task_group(cur, pt, m2)
        sel = r.sel_idx.numpy()
        seq.append(sel)
        dyn = cur.dyn_free.clone()
        for row in sel:
            if row >= 0:
                dyn[row] -= pt.n_dyn
        cur = cur._replace(used=r.new_used, dyn_free=dyn)
    for i in range(len(progs)):
        assert list(chain[i][:2]) == list(seq[i][:2]), i


def test_inert_pad_program_passes_carry_through():
    cl = _mini_cluster(4)
    stack = TPUStack(cl)
    p, _m = stack.compile_tg(_cpu_job(600), _cpu_job(600).task_groups[0], 1,
                             None)
    pad = _inert_program(p)
    batched, m = stack_params([p, pad, p])
    cluster = cc.port_cluster(stack.device_arrays())
    res = tp.place_task_group_chain(cluster,
                                    params_from_numpy(batched, "cpu"), m)
    sel = res.sel_idx.numpy()
    assert int(sel[1][0]) == -1, "pad program placed something"
    assert int(sel[0][0]) != int(sel[2][0])
    assert torch.equal(res.new_used[1], res.new_used[0])


def test_cpu_tensors_never_launch_the_chain_kernel():
    stack, progs = _programs(n_prog=2)
    prep, ti, tf, tu = cc.table_prep(progs)
    before = (tp.chain_launch_count(), tp.wave_launch_count())
    tp.place_table_chain(
        cc.port_cluster(stack.device_arrays()), *cc.port_bufs(ti, tf, tu),
        prep.rows, *cc.port_bufs(prep.dyn_i, prep.dyn_f, prep.dyn_u),
        prep.sspec, prep.dspec, prep.m)
    assert (tp.chain_launch_count(), tp.wave_launch_count()) == before
