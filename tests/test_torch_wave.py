"""The port's wave transport (K5) against the reference package's.

`place_table_wave` runs L lane chains and folds their carries by a
bitwise owner-lane select, counting rows more than one lane changed. The
port's plain version (CPU tensors) is held against the reference's on
CPU XLA on identical program-table inputs, and against the port's own
chain. Twins of `tests/test_drain.py`'s wave-kernel cases: disjoint lanes
bit-identical to the chain, uneven lanes with explain, and a
stale-footprint cross-lane collision whose count equals the reference's.
Indices, counts, carries and collision counts must be equal; scores
within 1e-6.
"""
import numpy as np
import pytest

import torch_chain_cases as cc
from torch_chain_cases import one_torch_thread  # noqa: F401
from nomad_tpu import mock
from nomad_tpu.kernels import placement as jp
from nomad_tpu.scheduler.stack import TPUStack
from nomad_tpu.server.select_batch import _inert_program
from nomad_tpu.tensor import ClusterTensors

from nomad_tpu_torch.kernels import placement as tp


def _dc_cluster(n_nodes, n_dcs):
    cl = ClusterTensors()
    for i in range(n_nodes):
        n = mock.node()
        n.id = f"node-{i}"
        n.datacenter = f"dc{1 + i % n_dcs}"
        n.node_resources.cpu = 1000
        n.node_resources.memory_mb = 2048
        cl.upsert_node(n)
    return cl


def _pinned(cl, dc, n_place=2, cpu=600):
    j = mock.job()
    j.datacenters = [dc]
    j.task_groups[0].tasks[0].resources.cpu = cpu
    j.task_groups[0].tasks[0].resources.memory_mb = 64
    j.task_groups[0].networks = []
    stack = TPUStack(cl)
    p, _m = stack.compile_tg(j, j.task_groups[0], n_place, None)
    return stack, p


def _both_waves(arrays, prep, ti, tf, tu, order, shape, explain=False):
    """The reference's and the port's wave over programs `order` of
    `prep`, laid out as [lanes, per_lane]."""
    rows = prep.rows[order].reshape(shape)
    dyn = [d[order].reshape(shape + (-1,))
           for d in (prep.dyn_i, prep.dyn_f, prep.dyn_u)]
    ref = jp.place_table_wave(arrays, ti, tf, tu, rows, *dyn, prep.sspec,
                              prep.dspec, prep.m, explain=explain)
    got = tp.place_table_wave(cc.port_cluster(arrays),
                              *cc.port_bufs(ti, tf, tu), rows,
                              *cc.port_bufs(*dyn), prep.sspec, prep.dspec,
                              prep.m, explain=explain)
    return ref, got


def _port_chain(arrays, prep, ti, tf, tu, n, explain=False):
    return tp.place_table_chain(
        cc.port_cluster(arrays), *cc.port_bufs(ti, tf, tu), prep.rows[:n],
        *cc.port_bufs(prep.dyn_i[:n], prep.dyn_f[:n], prep.dyn_u[:n]),
        prep.sspec, prep.dspec, prep.m, explain=explain)


def test_wave_bit_identical_to_chain_on_disjoint_lanes():
    cl = _dc_cluster(8, 2)
    stack, p1 = _pinned(cl, "dc1")
    _, p2 = _pinned(cl, "dc2")
    prep, ti, tf, tu = cc.table_prep([p1, p2])
    arrays = stack.device_arrays()
    (ref, ref_carry), (got, got_carry) = _both_waves(
        arrays, prep, ti, tf, tu, [0, 1], (2, 1))
    cc.assert_outputs(ref, got, what="wave")
    cc.assert_carry(ref_carry, got_carry, "wave")
    assert int(got[-1]) == 0, "disjoint lanes reported a collision"
    chain, chain_carry = _port_chain(arrays, prep, ti, tf, tu, 2)
    for c, w in zip(chain, got[:-1]):
        assert c.numpy().tobytes() == w.numpy().tobytes()
    for c, w in zip(chain_carry, got_carry):
        assert c.numpy().tobytes() == w.numpy().tobytes()
    assert (chain[0] >= 0).all(), "nothing placed: vacuous"


def test_wave_uneven_lanes_with_explain():
    cl = _dc_cluster(8, 2)
    stack, p1 = _pinned(cl, "dc1", cpu=600)
    _, p1b = _pinned(cl, "dc1", cpu=300)
    _, p2 = _pinned(cl, "dc2")
    pad = _inert_program(p1)
    prep, ti, tf, tu = cc.table_prep([p1, p1b, p2, pad])
    arrays = stack.device_arrays()
    (ref, ref_carry), (got, got_carry) = _both_waves(
        arrays, prep, ti, tf, tu, [0, 1, 2, 3], (2, 2), explain=True)
    cc.assert_outputs(ref, got, explain=True, what="wave/explain")
    cc.assert_carry(ref_carry, got_carry, "wave/explain")
    assert int(got[-1]) == 0
    chain, chain_carry = _port_chain(arrays, prep, ti, tf, tu, 3,
                                     explain=True)
    for c, w in zip(chain, got[:-1]):
        for prog in range(3):
            assert c[prog].numpy().tobytes() == w[prog].numpy().tobytes()
    for c, w in zip(chain_carry, got_carry):
        assert c.numpy().tobytes() == w.numpy().tobytes()


@pytest.mark.parametrize("lanes", [2, 3])
def test_cross_lane_collision_counted_like_the_reference(lanes):
    """Overlapping programs misplaced into separate lanes (a stale
    footprint) pick the same node; the count must be > 0 and equal the
    reference's."""
    cl = _dc_cluster(4, 1)
    stack, p1 = _pinned(cl, "dc1", n_place=1)
    progs = [p1] + [_pinned(cl, "dc1", n_place=1)[1]
                    for _ in range(lanes - 1)]
    prep, ti, tf, tu = cc.table_prep(progs)
    arrays = stack.device_arrays()
    (ref, ref_carry), (got, got_carry) = _both_waves(
        arrays, prep, ti, tf, tu, list(range(lanes)), (lanes, 1))
    cc.assert_outputs(ref, got, what="collision")
    cc.assert_carry(ref_carry, got_carry, "collision")
    sel = got[0].numpy()
    assert sel[0][0] == sel[1][0] >= 0
    assert int(got[-1]) >= 1 and int(got[-1]) == int(ref[-1])
