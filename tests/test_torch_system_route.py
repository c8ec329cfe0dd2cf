"""K2 and B12 as one kernel (`csrc/system.cu` `system_rows`), decomposed
on the CPU.

On the card the system masks are one launch a card over every node shard
it holds (K2: one argument block at row 0). Each argument block is K1's
PlaceArgs with its shard's cluster pointers moved back by the shard's
first global row, so that global row g lies g rows past each of them;
the program's fields stay global (plan deltas, released and consumed
ports and a node-width extra_mask are indexed by global row), and every
block's thread writes its global row's two bytes into one bool [2, N].
For a numpy program (what `compile_tg` returns) the wrapper packs the
fields as `pack_params` packs them and sends them with the argument
blocks in one staged copy.

The model here stages exactly that on the host (`system_stage`,
`stage_offsets`, `fill_stage`, on CPU shards), then reads every
argument block back through its pointers the way the kernel does and
applies the kernel's row arithmetic (`place_core.cuh`: the LUT rows, the
deltas summed in delta order and subtracted once, the port credits and
debits, the reserved ports) in torch. Its [2, N] must be bitwise the
plain sharded version (`sharded_system_plain`) and equal to the JAX
package's `system_feasibility` (jitted on the CPU) at meshes (1, 1),
(1, 4), (2, 2) and (1, 8) — on these 64-row views (1, 4) is a shard of 16
rows and (1, 8) of 8 — for the programs `tests/test_torch_system.py`
and `tests/test_torch_sharded.py` use: constraint LUTs, plan deltas,
reserved and dynamic asks with released and consumed ports, seeded fuzz
with a broadcast and a node-width extra_mask, and the mixed service
programs (one with plan deltas and penalties). Masks are booleans: equal
exactly.

Also: the argument blocks against the shards they point at; the staged
pack's round trip; the route and the launch groups from the devices
alone; the numpy program straight into `system_feasibility` (the system
scheduler's hand-off); `SystemRun` and the wrapper's layout against
`csrc/system.cu`. Nothing here needs a card.
"""
import ctypes
import re
from functools import lru_cache
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_system import K2_CASES, _inputs
from torch_chain_cases import mixed_programs, one_torch_thread  # noqa: F401
from torch_chain_cases import np_view, synth_cluster
from nomad_tpu.kernels.placement import ClusterArrays as RefArrays
from nomad_tpu.kernels.placement import system_feasibility as ref_system
from nomad_tpu.parallel.mesh import pad_params
from nomad_tpu.scheduler.stack import _to_device

from nomad_tpu_torch.convert import cluster_from_numpy, params_from_numpy
from nomad_tpu_torch.kernels import placement as tp
from nomad_tpu_torch.kernels import shard as ks
from nomad_tpu_torch.parallel import make_mesh, shard_cluster

MESHES = ((1, 1), (1, 4), (2, 2), (1, 8))
CASES = K2_CASES + ("fuzz_broadcast", "fuzz_per_row", "mixed_0", "mixed_1",
                    "mixed_2", "mixed_3")


@lru_cache(maxsize=None)
def _mixed():
    cl, nodes, rng, allocs = synth_cluster(48, 96)
    stack, progs = mixed_programs(cl, nodes, rng, allocs, n_prog=4,
                                  n_place=3)
    return np_view(stack.device_arrays()), progs


@lru_cache(maxsize=None)
def _case(name):
    """(numpy view, numpy program, the JAX reference's two masks)."""
    if name.startswith("mixed_"):
        arrays, progs = _mixed()
        (params,), _m = pad_params([progs[int(name[6:])]])
    else:
        arrays, params = _inputs(name)
    want = ref_system(RefArrays(**{k: jnp.asarray(v)
                                   for k, v in arrays.items()}),
                      _to_device(params))
    return arrays, params, tuple(np.asarray(w) for w in want)


def _sharded(arrays, shape):
    n_dev = shape[0] * shape[1]
    return shard_cluster(cluster_from_numpy(arrays, "cpu"),
                         make_mesh(n_dev, batch=shape[0],
                                   devices=["cpu"] * n_dev))


# ---- the model: what the card reads, read back through the pointers ----------


def _read(addr, shape, dtype) -> torch.Tensor:
    """A copy of the `shape` elements of `dtype` at host address `addr`."""
    dtype = np.dtype(dtype)
    count = int(np.prod(shape))
    raw = ctypes.string_at(int(addr), count * dtype.itemsize) if count \
        else b""
    return torch.from_numpy(np.frombuffer(raw, dtype=dtype).reshape(
        shape).copy())


def _stage_on_host(shards, row0s, n, p, in_place):
    """The wrapper's staged copy laid out in host memory: (the buffer,
    the argument blocks as written into it)."""
    parts, blocks = tp.system_stage(shards, row0s, n, p)
    assert len(parts) == (2 if in_place else 3)
    offs, total = tp.stage_offsets(parts)
    host = np.zeros(total + 16, dtype=np.uint8)
    base = (host.ctypes.data + 15) & ~15
    h = host[base - host.ctypes.data:]
    args = blocks([base + o for o in offs])
    tp.fill_stage(h, offs, [args] + parts[1:])
    back = np.frombuffer(h[:args.nbytes].tobytes(), dtype=tp._ARGS_DTYPE)
    assert (back == args.view(tp._ARGS_DTYPE).reshape(-1)).all()
    return host, back, parts[1]


def _block_masks(a, r0, rows, out):
    """One argument block as `system_rows` runs it: global rows r0 ..
    r0 + rows, each g rows past every cluster pointer, the program's
    fields global; writes out[0, g] and out[1, g]."""
    n, r, kc, pw = (int(a[k]) for k in ("n", "r", "k_cols", "port_words"))
    c, v, e, d, pp, pc, ps = (int(a[k]) for k in
                              ("c", "v", "e", "d", "pp", "pc", "ps"))
    g = torch.arange(r0, r0 + rows)

    def rows_of(name, width, dtype):
        return _read(int(a[name]) + r0 * width * np.dtype(dtype).itemsize,
                     (rows, width), dtype)

    cap = rows_of("capacity", r, np.float32)
    used = rows_of("used", r, np.float32)
    node_ok = rows_of("node_ok", 1, np.uint8)[:, 0] != 0
    attrs = rows_of("attrs", kc, np.int32 if a["attrs_i32"] else np.int16)
    ports = rows_of("ports_used", pw, np.int32)
    dyn = rows_of("dyn_free", 1, np.float32)[:, 0]
    ask = _read(a["ask"], (r,), np.float32)
    n_dyn = _read(a["n_dyn"], (1,), np.float32)[0]
    key_idx = _read(a["key_idx"], (c,), np.int32)
    lut = _read(a["lut"], (c, v), np.uint8) != 0
    extra = _read(a["extra_mask"], (e,), np.uint8) != 0
    delta_idx = _read(a["delta_idx"], (d,), np.int32)
    delta_res = _read(a["delta_res"], (d, r), np.float32)
    res_ports = _read(a["res_ports"], (pp,), np.int32)
    pclr_idx = _read(a["pclr_idx"], (pc,), np.int32)
    pclr_port = _read(a["pclr_port"], (pc,), np.int32)
    pset_idx = _read(a["pset_idx"], (ps,), np.int32)
    pset_port = _read(a["pset_port"], (ps,), np.int32)

    # feas = node_ok & extra_mask[g] & every LUT row (lut_row_ok)
    feas = node_ok & (extra.expand(rows) if e == 1 else extra[g])
    for k in range(c):
        t = attrs[:, int(key_idx[k])].long()
        t = torch.where(t < 0, v - 1, torch.clamp(t, max=v - 1))
        feas = feas & lut[k][t]
    # used0 = used − Σ delta_res over the row's deltas, in delta order
    # (used0_of), then util ≤ cap for every resource
    used0 = used
    if d:
        dsum = torch.zeros((rows, r), dtype=torch.float32)
        for i in range(d):
            dsum = torch.where((delta_idx[i] == g)[:, None],
                               dsum + delta_res[i], dsum)
        used0 = used - dsum
    fits = torch.all(used0 + ask <= cap, dim=1)
    # adjusted_dyn: released in-range ports credited, consumed debited
    if pc:
        add = torch.zeros(rows, dtype=torch.float32)
        for q in range(pc):
            hit = (pclr_idx[q] == g) & (20000 <= pclr_port[q] <= 32000)
            add = torch.where(hit, add + 1.0, add)
        dyn = dyn + add
    if ps:
        sub = torch.zeros(rows, dtype=torch.float32)
        for q in range(ps):
            hit = (pset_idx[q] == g) & (20000 <= pset_port[q] <= 32000)
            sub = torch.where(hit, sub + 1.0, sub)
        dyn = dyn - sub
    fits = fits & (dyn >= n_dyn)
    # ports_free_row: the bit, a plan release frees, a plan placement takes
    for i in range(pp):
        port = int(res_ports[i])
        if port < 0:
            continue
        taken = ((ports[:, port >> 5] >> (port & 31)) & 1) != 0
        freed = (pclr_idx == g[:, None]) & (pclr_port == port)
        held = (pset_idx == g[:, None]) & (pset_port == port)
        taken = held.any(dim=1) | (taken & ~freed.any(dim=1))
        fits = fits & ~taken
    assert n == out.shape[1]
    out[0, g] = feas
    out[1, g] = feas & fits


def rows_model(sc, p, in_place=False) -> torch.Tensor:
    """The cards route on batch row 0's shards of `sc`: a launch a device
    group (`card_groups`), each staged on the host and run block by
    block. bool [2, N]."""
    shards = sc.shards[0]
    out = torch.zeros((2, sc.n), dtype=torch.bool)
    groups = ks.card_groups([sh.used.device for sh in shards])
    for _dev, js in groups.items():
        group = [shards[j] for j in js]
        row0s = [sc.row0[j] for j in js]
        host, args, row0 = _stage_on_host(group, row0s, sc.n, p, in_place)
        rows = group[0].capacity.shape[0]
        for a, r0 in zip(args, row0):
            _block_masks(a, int(r0), rows, out)
        del host
    return out


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", CASES)
def test_rows_model_matches_plain_and_reference(name, shape):
    arrays, params, want = _case(name)
    sc = _sharded(arrays, shape)
    got = rows_model(sc, params)
    plain = ks.sharded_system_plain(sc, params)
    assert got.dtype == plain.dtype == torch.bool
    assert got.shape == plain.shape == (2, sc.n)
    assert torch.equal(got, plain), f"{name} {shape}: model vs plain"
    for w, g, what in zip(want, got, ("feasible", "fits")):
        np.testing.assert_array_equal(w, g.numpy(),
                                      err_msg=f"{name} {shape} {what}")
    if name.startswith("fuzz_"):
        assert 0 < int(got[1].sum()) < int(got[0].sum())


@pytest.mark.parametrize("name", ["plan_delta_ports", "fuzz_per_row",
                                  "mixed_1"])
def test_rows_model_reads_a_program_in_place(name):
    """Tensors on the shards' device are read where they lie (no pack):
    the same masks."""
    arrays, params, want = _case(name)
    sc = _sharded(arrays, (1, 4))
    got = rows_model(sc, params_from_numpy(params, "cpu"), in_place=True)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g.numpy())


def test_k2_is_one_block_at_row_zero():
    """K2: the whole view as one argument block at row 0."""
    arrays, params, want = _case("fuzz_per_row")
    view = cluster_from_numpy(arrays, "cpu")
    n = view.capacity.shape[0]
    host, args, row0 = _stage_on_host([view], [0], n, params, False)
    assert args.shape == (1,) and list(row0) == [0]
    out = torch.zeros((2, n), dtype=torch.bool)
    _block_masks(args[0], 0, n, out)
    for w, g in zip(want, out):
        np.testing.assert_array_equal(w, g.numpy())


# ---- argument blocks, the staged pack, routes ----------------------------------


@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (1, 8)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_system_args_point_every_block_at_its_shard(shape):
    """Block k: the program's pointers, the global row count, the dims,
    and shard k's cluster fields moved back row0 rows."""
    arrays, params, _w = _case("plan_delta_ports")
    sc = _sharded(arrays, shape)
    shards = sc.shards[0]
    p = params_from_numpy(params, "cpu")
    ptrs = [getattr(p, f).data_ptr() for f in tp.SYSTEM_FIELDS]
    shapes = {f: tuple(t.shape) for f, t in p._asdict().items()}
    args = tp.system_args(shards, sc.row0, sc.n, ptrs, shapes).view(
        tp._ARGS_DTYPE).reshape(-1)
    assert args.shape == (shape[1],)
    assert (args["n"] == sc.n).all() and (args["explain"] == 0).all()
    assert (args["d"] == p.delta_idx.shape[0]).all()
    assert (args["e"] == p.extra_mask.shape[0]).all()
    for k, (sh, r0) in enumerate(zip(shards, sc.row0)):
        for f, ptr in zip(tp.SYSTEM_FIELDS, ptrs):
            assert args[k][f] == ptr, (k, f)
        for f in set(tp.TGParams._fields) - set(tp.SYSTEM_FIELDS):
            assert args[k][f] == 0, (k, f)    # never read: null
        for f in ("r", "k_cols", "port_words", "attrs_i32", "c", "v", "pc",
                  "ps", "pp", "cw"):
            assert args[k][f] == args[0][f]
        assert args[k]["r"] == sh.capacity.shape[1]
        assert args[k]["k_cols"] == sh.attrs.shape[1]
        assert args[k]["port_words"] == sh.ports_used.shape[1]
        assert (args[k]["c"], args[k]["v"]) == tuple(p.lut.shape)
        for f, t in sh._asdict().items():
            row = t.stride(0) * t.element_size()
            g = r0 + 3        # a global row of shard k
            assert int(args[k][f]) + g * row == t[3].data_ptr(), (k, f)


@pytest.mark.parametrize("name", ["plan_delta_ports", "fuzz_broadcast",
                                  "mixed_1"])
def test_staged_program_round_trips(name):
    """The fields the kernel reads, read back through the argument
    block's pointers into the staged bytes, equal the numpy program's,
    each in its kernel type; the fields it never reads are not staged
    (null pointers)."""
    arrays, params, _w = _case(name)
    view = cluster_from_numpy(arrays, "cpu")
    host, args, _r = _stage_on_host([view], [0], view.capacity.shape[0],
                                    params, False)
    for f in tp.TGParams._fields:
        if f not in tp.SYSTEM_FIELDS:
            assert args[0][f] == 0, f
            continue
        want = np.asarray(getattr(params, f))
        dt = {torch.float32: np.float32, torch.int32: np.int32,
              torch.bool: np.uint8}[tp.PARAM_TYPES[f]]
        got = _read(args[0][f], want.shape, dt).numpy()
        np.testing.assert_array_equal(want.astype(dt), got, err_msg=f)
    del host


def test_routes_follow_the_devices_alone():
    assert ks.system_route(["cpu"] * 4) == "plain"
    assert ks.system_route(["cuda:0"] * 8) == "cards"
    assert ks.system_route(["cuda:0", "cuda:1"]) == "cards"
    with pytest.raises(ValueError, match="no sharded placement"):
        ks.system_route(["cpu", "cuda:0"])
    groups = ks.card_groups(["cuda:0", "cuda:1", "cuda:0", "cuda:1"])
    assert list(groups.items()) == [(torch.device("cuda:0"), [0, 2]),
                                    (torch.device("cuda:1"), [1, 3])]
    assert ks.card_groups(["cuda:1"] * 4) == {torch.device("cuda:1"):
                                              [0, 1, 2, 3]}


def test_cpu_views_take_the_plain_route_with_a_numpy_program():
    """The system scheduler hands `compile_tg`'s numpy program straight
    to `system_feasibility`: on CPU tensors the plain version, the same
    [2, N] as from tensors, and no launch."""
    arrays, params, want = _case("port_released")
    view = cluster_from_numpy(arrays, "cpu")
    sc = _sharded(arrays, (1, 4))
    before = (tp.system_launch_count(), ks.route_launch_counts())
    for cluster in (view, sc):
        a = tp.system_feasibility(cluster, params)
        b = tp.system_feasibility(cluster, params_from_numpy(params, "cpu"))
        assert a.shape == (2, view.capacity.shape[0])
        assert torch.equal(a, b)
        feas, fit = a
        np.testing.assert_array_equal(want[0], feas.numpy())
        np.testing.assert_array_equal(want[1], fit.numpy())
    assert (tp.system_launch_count(), ks.route_launch_counts()) == before
    with pytest.raises(ValueError, match="sharded view"):
        tp.system_feasibility(view, params, route="shards")
    with pytest.raises(ValueError, match="on CPU shards"):
        tp.system_feasibility(sc, params, route="cards")
    with pytest.raises(ValueError, match="CUDA"):
        tp.system_masks_on(list(sc.shards[0]), list(sc.row0), sc.n, params)


def test_a_program_that_does_not_fit_the_view_is_refused():
    arrays, params, _w = _case("fuzz_per_row")
    view = cluster_from_numpy(arrays, "cpu")
    n = view.capacity.shape[0]
    with pytest.raises(ValueError, match="extra_mask"):
        tp.system_stage([view], [0], n,
                        params._replace(extra_mask=np.ones(n - 1, bool)))
    with pytest.raises(ValueError, match="ask"):
        tp.system_stage([view], [0], n, params._replace(
            ask=np.zeros(3, np.float32)))
    with pytest.raises(ValueError, match="disagree"):
        tp.system_stage([view], [0], n, params._replace(
            delta_res=np.zeros((len(params.delta_idx) + 1, 8), np.float32)))
    with pytest.raises(ValueError, match="disagree"):
        tp.system_stage([view], [0], n, params._replace(
            pclr_port=params.pclr_port[:-1]))


# ---- the layout against csrc/system.cu -----------------------------------------


def _struct_fields(path, name):
    src = path.read_text()
    body = re.search(r"struct %s \{(.*?)\n\};" % name, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            names += [re.sub(r"\[.*\]", "", x).strip(" *").split()[-1]
                      for x in decl.split(",")]
    return names


CSRC = Path(tp.__file__).parent / "csrc"


def test_mirrors_name_the_kernels_fields_in_order():
    """`_SystemRun` lists csrc/system.cu's SystemRun, `_PlaceArgs`
    place_core.cuh's PlaceArgs, member for member; the two sizes lead
    SystemRun, so the library checks them at every launch."""
    assert [f for f, _t in tp._SystemRun._fields_] == _struct_fields(
        CSRC / "system.cu", "SystemRun")
    assert [f for f, _t in tp._PlaceArgs._fields_] == _struct_fields(
        CSRC / "place_core.cuh", "PlaceArgs")
    assert tp._SystemRun._fields_[:2] == [("run_size", tp._INT),
                                          ("args_size", tp._INT)]
    assert ctypes.sizeof(tp._SystemRun) == 5 * 4 + 4 + 2 * 8


def test_the_library_exports_both_routes_and_its_sizes():
    src = (CSRC / "system.cu").read_text()
    assert '#include "place_core.cuh"' in src
    for fn in ("size_t nomad_system_args_size()",
               "size_t nomad_system_run_size()",
               "int nomad_system_masks(", "int nomad_system_feasibility(",
               "const char* nomad_system_error_string(int err)"):
        assert fn in src, fn
    # one kernel for K2 and B12, the old pass beside it
    assert len(re.findall(r"__global__", src)) == 2
