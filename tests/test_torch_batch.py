"""The port's batched transport (K6) against the reference package's.

`place_task_group_batch` and `place_packed_batch` of
`nomad_tpu_torch.kernels.placement` run their plain PyTorch versions on CPU
tensors; the reference's run on CPU XLA. Programs are the reference's own
compiled programs carried as numpy (`torch_chain_cases`): the chain tests'
mix (deltas, penalties, every stanza), `bench.py`'s eval mix, one program
alone, and a batch holding a program no node can take. Indices, counts
and `new_used` must be equal; scores within 1e-6 (values in [-2, 1]; XLA's
exp2 and torch.exp2 may differ by an ulp).
"""
import ctypes

import numpy as np
import pytest
import torch

import torch_chain_cases as cc
from torch_chain_cases import one_torch_thread  # noqa: F401
from nomad_tpu import mock
from nomad_tpu.kernels import placement as jp
from nomad_tpu.parallel.mesh import stack_params
from nomad_tpu.scheduler.stack import TPUStack
from nomad_tpu.server.select_batch import _inert_program as jax_inert
from nomad_tpu.structs import Constraint
from nomad_tpu.synth import synth_service_job
from nomad_tpu.tensor import ClusterTensors

from nomad_tpu_torch.convert import params_from_numpy
from nomad_tpu_torch.kernels import placement as tp


def _bench_mix(cl, rng, n, count):
    """`bench.py` `build`'s eval mix (BASELINE configs 1, 2, 3 and 5)."""
    stack = TPUStack(cl)
    progs = []
    for i in range(n):
        job = synth_service_job(
            rng, count=count,
            with_affinity=(i % 2 == 0), with_spread=(i % 3 == 0),
            distinct_hosts=(i % 5 == 0), with_devices=(i % 4 == 0),
            distinct_property=(i % 7 == 0))
        progs.append(stack.compile_tg(job, job.task_groups[0], count)[0])
    return stack, progs


def _case(name):
    cl, nodes, rng, allocs = cc.synth_cluster(24, n_allocs=40)
    if name in ("chain_mix", "chain_mix_pad"):
        stack, progs = cc.mixed_programs(cl, nodes, rng, allocs, n_prog=5)
        if name == "chain_mix_pad":
            progs = progs + [jax_inert(progs[0])]
        return stack, progs
    if name == "bench_mix":
        return _bench_mix(cl, rng, 8, count=8)
    if name == "one_program":
        return _bench_mix(cl, rng, 1, count=4)
    if name == "all_infeasible":
        stack, progs = _bench_mix(cl, rng, 2, count=4)
        job = synth_service_job(rng, count=4)
        job.constraints.append(Constraint("${attr.kernel.name}", "windows",
                                          "="))
        progs.insert(1, stack.compile_tg(job, job.task_groups[0], 4)[0])
        return stack, progs
    raise KeyError(name)


CASES = ("chain_mix", "chain_mix_pad", "bench_mix", "one_program",
         "all_infeasible")


def _assert_batch(ref, got, explain):
    for f in ("sel_idx", "nodes_feasible", "nodes_fit", "new_used"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                      getattr(got, f).numpy(), err_msg=f)
    for f in ("sel_score", "final_scores0"):
        np.testing.assert_allclose(np.asarray(getattr(ref, f)),
                                   getattr(got, f).numpy(), rtol=0,
                                   atol=cc.ATOL, err_msg=f)
    assert (ref.explain is None) == (got.explain is None)
    if explain:
        cc.assert_outputs(tuple(ref.explain), tuple(got.explain),
                          float_idx=(10, 11), what="explain")


@pytest.mark.parametrize("explain", [False, True], ids=["plain", "explain"])
@pytest.mark.parametrize("case", CASES)
def test_task_group_batch_matches_reference(case, explain):
    stack, progs = _case(case)
    batched, m = stack_params(progs)
    arrays = stack.device_arrays()
    ref = jp.place_task_group_batch(arrays, batched, m, explain=explain)
    got = tp.place_task_group_batch(cc.port_cluster(arrays),
                                    params_from_numpy(batched, "cpu"), m,
                                    explain=explain)
    assert got.sel_idx.shape == (len(progs), m)
    assert got.new_used.shape == (len(progs),) + tuple(arrays.used.shape)
    _assert_batch(ref, got, explain)
    sel = got.sel_idx.numpy()
    assert (sel >= 0).any(), "nothing placed: vacuous"
    if case == "all_infeasible":
        assert (sel[1] == -1).all() and int(got.nodes_feasible[1]) == 0
        assert (sel[0] >= 0).any() and (sel[2] >= 0).any()
    if case == "chain_mix_pad":
        assert (sel[-1] == -1).all(), "the pad program placed"


@pytest.mark.parametrize("case", CASES)
def test_packed_batch_matches_reference(case):
    stack, progs = _case(case)
    batched, m = stack_params(progs)
    ibuf, fbuf, ubuf, spec = jp.pack_params(batched)
    arrays = stack.device_arrays()
    ref = jp.place_packed_batch(arrays, ibuf, fbuf, ubuf, spec, m)
    got = tp.place_packed_batch(cc.port_cluster(arrays),
                                *cc.port_bufs(ibuf, fbuf, ubuf), spec, m)
    assert len(got) == 2
    cc.assert_outputs(ref, got, what="packed batch")


def test_programs_do_not_see_each_other():
    """Two 600-cpu programs on 1000-cpu nodes both take the same node (no
    carry between them), where the chain moves the second one."""
    cl = ClusterTensors()
    for i in range(4):
        n = mock.node()
        n.id = f"node-{i}"
        n.node_resources.cpu, n.node_resources.memory_mb = 1000, 1024
        cl.upsert_node(n)
    job = mock.job()
    job.task_groups[0].tasks[0].resources.cpu = 600
    job.task_groups[0].tasks[0].resources.memory_mb = 64
    job.task_groups[0].networks = []
    stack = TPUStack(cl)
    prog = stack.compile_tg(job, job.task_groups[0], 1, None)[0]
    batched, m = stack_params([prog, prog])
    cluster = cc.port_cluster(stack.device_arrays())
    p = params_from_numpy(batched, "cpu")
    got = tp.place_task_group_batch(cluster, p, m)
    assert int(got.sel_idx[0][0]) >= 0
    assert int(got.sel_idx[0][0]) == int(got.sel_idx[1][0])
    assert (got.new_used[0] == got.new_used[1]).all()
    chain = tp.place_task_group_chain(cluster, p, m)
    assert int(chain.sel_idx[0][0]) == int(got.sel_idx[0][0])
    assert int(chain.sel_idx[1][0]) != int(got.sel_idx[1][0])


def test_cpu_tensors_never_launch_the_batch_kernel():
    stack, progs = _case("one_program")
    batched, m = stack_params(progs)
    before = tp.batch_launch_count()
    tp.place_task_group_batch(cc.port_cluster(stack.device_arrays()),
                              params_from_numpy(batched, "cpu"), m)
    assert tp.batch_launch_count() == before


def _bytes_at(ptr: int, t: torch.Tensor) -> bytes:
    """The bytes a kernel reads at `ptr` for a field shaped like `t`."""
    n = t.numel() * t.element_size()
    return ctypes.string_at(int(ptr), n)


@pytest.mark.parametrize("source", ["stacked", "packed", "table"])
def test_argument_blocks_point_at_each_programs_fields(source):
    """The PlaceArgs blocks a dispatch uploads (filled a field at a time
    for all programs): every program field points at that program's
    values, every scratch pointer at that program's (or lane's) row."""
    stack, progs = _case("chain_mix")
    cluster = cc.port_cluster(stack.device_arrays())
    batched, m = stack_params(progs)
    lanes, per_lane = len(progs), 1
    keep = []
    if source == "stacked":
        batch = params_from_numpy(batched, "cpu")
        b, shapes, ptrs_of = tp._stacked_source(cluster, batch)
    elif source == "packed":
        bufs = cc.port_bufs(*jp.pack_params(batched)[:3])
        spec = jp.pack_params(batched)[3]
        keep.append(bufs)
        b, shapes, ptrs_of = tp._packed_source(cluster, *bufs, spec)
        batch = tp._unpack_params(*bufs, spec)
    else:
        prep, ti, tf, tu = cc.table_prep(progs)
        tables = cc.port_bufs(ti, tf, tu)
        dyn = cc.port_bufs(prep.dyn_i, prep.dyn_f, prep.dyn_u)
        keep.append((tables, dyn))
        lanes, per_lane = 1, len(progs)
        b = len(progs)
        shapes, ptrs_of = tp._table_source(*tables, prep.rows, *dyn,
                                           prep.sspec, prep.dspec, b)
        batch = tp._assemble_table_batch(*tables, prep.rows, *dyn,
                                         prep.sspec, prep.dspec)
        m = prep.m
    dims, args, _dev, prog, lane, used_l = tp._lane_args(
        cluster, shapes, ptrs_of, lanes, per_lane, m, True)
    assert args.shape == (b,) and args.dtype.itemsize == ctypes.sizeof(
        tp._PlaceArgs)
    for k in range(b):
        p = tp._program(batch, k)
        for f in tp.TGParams._fields:
            want = getattr(p, f).to(tp.PARAM_TYPES[f]).contiguous()
            assert _bytes_at(args[f][k], want) == want.numpy().tobytes(), \
                (k, f)
        for name, t in prog.items():
            assert args[name][k] == t[k].data_ptr(), (k, name)
        for name, t in lane.items():
            assert args[name][k] == t[k // per_lane].data_ptr(), (k, name)
        assert args["new_used"][k] == used_l[k // per_lane].data_ptr()
        assert args["used"][k] == cluster.used.data_ptr()
        assert args["n"][k] == cluster.used.shape[0]
        for name, val in dims.items():
            assert args[name][k] == val, (k, name)
