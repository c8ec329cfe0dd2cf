"""The launch structure of the port's sharded chain (B10) and single
program (B11), chosen from the shards' layout alone.

`kernels/shard.py` `chain_route` reads batch row 0's devices: CPU shards
take the plain version; CUDA shards that all lie on one card, at most
`MAX_CLUSTER` (8, the portable thread-block cluster size) of them, take
the cluster route (the static pass of every shard, then one cluster of S
blocks that runs every step); any other CUDA layout takes the steps route
(launches a step per shard, records copied to the lead device). The
choice is made from device lists here, without tensors; the card tests
(`tests/test_torch_cuda.py`) hold the two CUDA routes against each other
bitwise.
"""
import ctypes
import random

import pytest
import torch

from nomad_tpu_torch.convert import params_from_numpy
from nomad_tpu_torch.kernels import placement as kp
from nomad_tpu_torch.kernels import shard as ks
from nomad_tpu_torch.parallel import make_mesh, shard_cluster
from nomad_tpu_torch.parallel.pad import pad_params, stack_params
from nomad_tpu_torch.scheduler.stack import TorchStack
from nomad_tpu_torch.synth import build_synthetic_state, synth_service_job


def _cuda(*indices):
    return [torch.device("cuda", i) for i in indices]


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_one_card_takes_the_cluster_route(shards):
    assert ks.chain_route(_cuda(*[0] * shards)) == "cluster"
    assert ks.chain_route(["cuda:1"] * shards) == "cluster"


@pytest.mark.parametrize("devices", [
    _cuda(0, 1), _cuda(0, 0, 1, 1), _cuda(0, 1, 2, 3), _cuda(*[0] * 16),
    _cuda(*[0] * 9)], ids=["2-cards", "2x2-cards", "4-cards", "16-on-one",
                           "9-on-one"])
def test_spanning_or_wide_layouts_take_the_steps_route(devices):
    assert ks.chain_route(devices) == "steps"


@pytest.mark.parametrize("shards", [1, 4, 16])
def test_cpu_shards_take_the_plain_route(shards):
    assert ks.chain_route(["cpu"] * shards) == "plain"


@pytest.mark.parametrize("devices", [["cpu", "cuda:0"], ["cuda:0", "meta"],
                                     ["cpu", "meta"]])
def test_mixed_device_types_have_no_route(devices):
    with pytest.raises(ValueError, match="no sharded placement"):
        ks.chain_route(devices)


def test_cluster_limit_is_the_portable_cluster_size():
    assert ks.MAX_CLUSTER == 8
    assert ks.chain_route(_cuda(*[0] * ks.MAX_CLUSTER)) == "cluster"
    assert ks.chain_route(_cuda(*[0] * (ks.MAX_CLUSTER + 1))) == "steps"


def test_shard_chain_mirror_has_the_c_layout():
    """`_ShardChain` as csrc/shard.cu lays `ShardChain` out on x86-64: five
    ints, the pointer tables 8-byte aligned, the combine last."""
    m = ks.MAX_CLUSTER
    c = ks._ShardChain
    assert c.args.offset == 24
    assert c.row0.offset == 24 + 8 * m
    assert c.dyn_c.offset == 24 + 12 * m
    assert c.snap.offset == 24 + 20 * m
    assert c.out.offset == 32 + 20 * m
    assert ctypes.sizeof(c) == 32 + 20 * m + ctypes.sizeof(ks._ShardCombine)


@pytest.fixture(scope="module")
def cpu_chain():
    """A 64-row view on four CPU shards and three stacked programs."""
    torch.set_num_threads(1)
    state, _nodes = build_synthetic_state(48, 120, seed=4)
    stack = TorchStack(state.cluster, device="cpu")
    rng = random.Random(6)
    progs = []
    for _ in range(3):
        j = synth_service_job(rng, count=3)
        state.upsert_job(j)
        progs.append(stack.compile_tg(j, j.task_groups[0], 3)[0])
    batched, m = stack_params(progs)
    sc = shard_cluster(stack.device_arrays(),
                       make_mesh(4, batch=1, devices=["cpu"] * 4))
    return sc, batched, m


def test_cpu_dispatches_record_the_plain_route(cpu_chain):
    """The chain and single entry points on CPU shards run the plain
    version and say so."""
    sc, batched, m = cpu_chain
    ks._SHARD.last_route = None
    got = kp.place_task_group_chain(sc, params_from_numpy(batched, "cpu"), m)
    assert ks.last_chain_route() == "plain"
    want = ks.sharded_chain_plain(sc, batched, m)[0]
    assert torch.equal(got.sel_idx, want.sel_idx)
    ks._SHARD.last_route = None
    (p,), m1 = pad_params([kp._program(batched, 0)])
    kp.place_task_group(sc, params_from_numpy(p, "cpu"), m1)
    assert ks.last_chain_route() == "plain"


def test_cuda_routes_refuse_cpu_shards(cpu_chain):
    """Neither CUDA route runs on CPU shards: each raises before any
    launch."""
    sc, batched, m = cpu_chain
    for fn in (ks._chain_cluster, ks._chain_steps, ks.sharded_chain_cuda):
        with pytest.raises(ValueError, match="expected cuda"):
            fn(sc, batched, m)


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_cluster_route_builds_every_shard_as_rebase_does(cpu_chain, shards):
    """The cluster route builds all shards' program fields at once: each
    shard's rebased row fields and split extra_mask equal `rebase` of that
    shard, and every argument block points at its shard's rows (shared
    fields at the program's own)."""
    sc, batched, m = cpu_chain
    sc = shard_cluster(sc.full(), make_mesh(shards, batch=1,
                                            devices=["cpu"] * shards))
    batch = params_from_numpy(batched, "cpu")
    # row fields over the whole view (−1 pads among them), so that every
    # shard owns some rows of each
    gen = torch.Generator().manual_seed(shards)
    batch = batch._replace(**{
        name: torch.randint(-1, sc.n, getattr(batch, name).shape,
                            generator=gen, dtype=torch.int32)
        for name in ks.ROW_FIELDS})
    assert sum(int((getattr(batch, f) >= 0).sum())
               for f in ks.ROW_FIELDS) >= 2 * shards
    node_wide = batch.extra_mask.new_ones((batch.extra_mask.shape[0], sc.n))
    node_wide[:, ::3] = 0
    for b in (batch, batch._replace(extra_mask=node_wide)):
        bp, shapes, ptrs_of, own = ks._shards_source(sc.shards[0][0], b,
                                                     shards, sc.n)
        ns = sc.n // shards
        assert bp == 3
        for name in kp.TGParams._fields:
            ptrs = ptrs_of(name)
            assert ptrs.shape == (shards * bp,)
            for j in range(shards):
                want = getattr(ks.rebase(b, sc.row0[j], ns, sc.n), name)
                if name in own:
                    assert torch.equal(own[name][j], want), (name, j)
                    rows = [own[name][j, k].data_ptr() for k in range(bp)]
                else:
                    assert torch.equal(getattr(b, name), want), (name, j)
                    rows = [getattr(b, name)[k].data_ptr()
                            for k in range(bp)]
                assert list(ptrs[j * bp:(j + 1) * bp]) == rows, (name, j)
        assert ("extra_mask" in own) == (b is not batch)
        assert shapes["extra_mask"] == ((ns,) if b is not batch else (1,))
