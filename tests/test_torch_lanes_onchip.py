"""K4 and K5's lane route (`csrc/lanes.cu`) decomposed, on the CPU.

A lane is one thread-block cluster of C blocks, block j keeping rows
[j·rows, (j + 1)·rows) of the view (rows = N / C rounded up to 32). Per
program each block computes its rows' entries once (the on-chip scan's:
`tests/torch_onchip_model.py`) from the lane's carry — the view, except
the overlay rows (a row a program held a delta for or placed on) whose
used and dyn_free come from the lane's carry buffer. A step's row loop
gives each block its best (score, global row), its fit count, with
explain its filter counts and its own top-5, and the preferred row's
ok and score if it keeps it; the combine takes the max score and the
lowest global row among equal scores, the preferred-row override, the
counts summed, and the blocks' top-5 lists merged in lax.top_k's order.
A step past n_place after a step that placed nothing, with the same
penalty rows, is idle: its outputs are the previous step's. After a
program its touched rows get their new carry and join the overlay; a
wave folds its lanes by value. `lane_chain_model` below is
that decomposition in torch.

It must be bitwise equal, as int32 views, to the plain versions the card
holds the kernel to (`place_table_chain_plain`, `place_packed_chain_plain`,
`place_table_wave_plain`), explain off and on, at C = 1, 2 and 8, and equal
the JAX package's: indices and counts exactly, scores and carries within
1e-6 (values in [-2, 1]; XLA's exp2 and torch.exp2 may differ by an ulp).

Also here: the route choice by shape (`lane_route`, `lane_layout`)
against the kernel's layout.
"""
import random
import re
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_chain_cases as cc
from torch_chain_cases import one_torch_thread  # noqa: F401
from torch_onchip_model import lane_chain_model, wave_model
from nomad_tpu.kernels import placement as jp
from nomad_tpu.parallel.mesh import stack_params
from nomad_tpu.scheduler.harness import InMemState
from nomad_tpu.scheduler.stack import PlanContext, TPUStack
from nomad_tpu.server.select_batch import _inert_program
from nomad_tpu.structs import Constraint
from nomad_tpu.structs.job import Spread
from nomad_tpu.synth import synth_alloc, synth_node, synth_service_job

from nomad_tpu_torch.convert import params_from_numpy
from nomad_tpu_torch.kernels import placement as tp

# ---- the cases -----------------------------------------------------------------


def _pinned(stack, rng, dc, count=3, plan=None, **kw):
    job = synth_service_job(rng, count=count, datacenter=dc, **kw)
    return stack.compile_tg(job, job.task_groups[0], count, plan)[0]


def _case(name):
    """(kind, view, programs as numpy: a list, or a list of lanes for a
    wave, extra facts to check). Clusters of 150 nodes (N = 256, so that
    C = 8 gives 8 blocks of 32 rows) or, for u16 tokens, 300 (N = 512)."""
    if name == "u16_tokens":
        rng = random.Random(12)
        state = InMemState()
        nodes = []
        for i in range(300):
            node = synth_node(rng, i)
            node.attributes["rack"] = f"r{i}"
            nodes.append(node)
            state.upsert_node(node)
        filler = synth_service_job(rng)
        state.upsert_job(filler)
        for node in nodes[200:240]:
            for _ in range(3):
                state.upsert_alloc(synth_alloc(rng, node, filler))
        stack = TPUStack(state.cluster)
        progs = []
        for spread, dp in ((True, False), (False, True), (True, True)):
            j = synth_service_job(rng, count=4, distinct_property=dp)
            if spread:
                j.spreads = [Spread(attribute="${attr.rack}", weight=100)]
            state.upsert_job(j)
            progs.append(stack.compile_tg(j, j.task_groups[0], 4)[0])
        return "table", stack, progs, {}
    cl, nodes, rng, allocs = cc.synth_cluster(150, n_allocs=450)
    stack = TPUStack(cl)
    by_node = {}
    for a in allocs:
        by_node.setdefault(a.node_id, []).append(a)
    hot = nodes[3]
    if name == "overlapping_overlays":
        # program 0 places on the hot node; program 1 holds a delta for
        # it (a stopped alloc there) and places there again; program 2
        # places there too
        prefer = PlanContext(preferred_node_ids=[hot.id])
        progs = [_pinned(stack, rng, None, plan=prefer),
                 _pinned(stack, rng, None, plan=PlanContext(
                     stopped_allocs=by_node[hot.id][:2],
                     preferred_node_ids=[hot.id])),
                 _pinned(stack, rng, None, plan=prefer, with_spread=True)]
        return "table", stack, progs, {"hot": True}
    if name == "penalty_on_overlay":
        prefer = PlanContext(preferred_node_ids=[hot.id])
        progs = [_pinned(stack, rng, None, plan=prefer),
                 _pinned(stack, rng, None, plan=PlanContext(
                     penalty_node_ids=[frozenset({hot.id}),
                                       frozenset({hot.id, nodes[4].id})]),
                     with_affinity=True),
                 _pinned(stack, rng, None, distinct_hosts=True)]
        return "packed", stack, progs, {"penalty": True}
    if name == "inert_pad":
        p0 = _pinned(stack, rng, None, plan=PlanContext(
            stopped_allocs=by_node[nodes[7].id][:1]))
        progs = [p0, _inert_program(p0),
                 _pinned(stack, rng, None, with_affinity=True)]
        return "table", stack, progs, {"pad": 1}
    if name == "all_floor":
        job = synth_service_job(rng, count=3)
        job.constraints.append(Constraint("${attr.kernel.name}", "windows",
                                          "="))
        progs = [_pinned(stack, rng, None),
                 stack.compile_tg(job, job.task_groups[0], 3)[0],
                 _pinned(stack, rng, None, with_spread=True)]
        return "table", stack, progs, {"floor": 1}
    if name == "cancel_fold":
        # lane 0 (pinned to dc1) stops an alloc on a dc2 node and plans
        # the same usage back onto it: its deltas cancel, the row joins
        # lane 0's overlay at the view's value; lane 1 (pinned to dc2)
        # places on that row — one lane changed it, no collision
        dc2 = next(nd for nd in nodes if nd.datacenter == "dc2")
        stopped = by_node[dc2.id][0]
        back = PlanContext(stopped_allocs=[stopped], placed=[
            (dc2.id, "web", cl.usage_row(stopped))])
        lanes = [[_pinned(stack, rng, "dc1", plan=back)],
                 [_pinned(stack, rng, "dc2", plan=PlanContext(
                     preferred_node_ids=[dc2.id]))]]
        return "wave", stack, lanes, {"cancel": True}
    if name == "stale_collision":
        progs = [_pinned(stack, rng, None), _pinned(stack, rng, None)]
        return "wave", stack, [progs, progs], {"collide": True}
    raise KeyError(name)


CASES = ("overlapping_overlays", "penalty_on_overlay", "inert_pad",
         "u16_tokens", "all_floor", "cancel_fold", "stale_collision")
SIZES = (1, 2, 8)


@lru_cache(maxsize=None)
def _inputs(case, explain):
    """The case's inputs on both packages, the port's plain outputs and
    the reference's, computed once a case."""
    kind, stack, progs, facts = _case(case)
    arrays = stack.device_arrays()
    cluster = cc.port_cluster(arrays)
    if kind == "wave":
        flat_progs = [p for lane in progs for p in lane]
        shape = (len(progs), len(progs[0]))
    else:
        flat_progs = progs
    prep, ti, tf, tu = cc.table_prep(flat_progs)
    port_tabs = cc.port_bufs(ti, tf, tu)
    if kind == "packed":
        batched, m = stack_params(progs)
        ibuf, fbuf, ubuf, spec = jp.pack_params(batched)
        ref = jp.place_packed_chain(arrays, ibuf, fbuf, ubuf, spec, m,
                                    explain=explain)
        bufs = cc.port_bufs(ibuf, fbuf, ubuf)
        plain = tp.place_packed_chain_plain(cluster, *bufs, spec, m, explain)
        lanes = [params_from_numpy(batched, "cpu")]
        return kind, cluster, lanes, m, plain, ref, None, None, facts
    m = prep.m
    if kind == "wave":
        rows = prep.rows.reshape(shape)
        dyn = [d.reshape(shape + (-1,)) for d in
               (prep.dyn_i, prep.dyn_f, prep.dyn_u)]
        ref, ref_carry = jp.place_table_wave(
            arrays, ti, tf, tu, rows, *dyn, prep.sspec, prep.dspec, m,
            explain=explain)
        plain, carry_ = tp.place_table_wave_plain(
            cluster, *port_tabs, rows, *cc.port_bufs(*dyn), prep.sspec,
            prep.dspec, m, explain)
        lanes = [tp._assemble_table_batch(
            *port_tabs, rows[lane], *cc.port_bufs(*(d[lane] for d in dyn)),
            prep.sspec, prep.dspec) for lane in range(shape[0])]
    else:
        dyn = (prep.dyn_i, prep.dyn_f, prep.dyn_u)
        ref, ref_carry = jp.place_table_chain(
            arrays, ti, tf, tu, prep.rows, *dyn, prep.sspec, prep.dspec, m,
            explain=explain)
        plain, carry_ = tp.place_table_chain_plain(
            cluster, *port_tabs, prep.rows, *cc.port_bufs(*dyn), prep.sspec,
            prep.dspec, m, explain)
        lanes = [tp._assemble_table_batch(
            *port_tabs, prep.rows, *cc.port_bufs(*dyn), prep.sspec,
            prep.dspec)]
    return kind, cluster, lanes, m, plain, ref, carry_, ref_carry, facts


def _assert_bitwise(want, got, what):
    assert len(want) == len(got), what
    for i, (a, b) in enumerate(zip(want, got)):
        assert a.shape == b.shape and a.dtype == b.dtype, (what, i, a.shape,
                                                           b.shape, a.dtype,
                                                           b.dtype)
        if a.dtype == torch.float32:
            a, b = a.contiguous().view(torch.int32), \
                b.contiguous().view(torch.int32)
        assert torch.equal(a, b), (what, i)


@pytest.mark.parametrize("clusters", SIZES, ids=lambda c: f"C{c}")
@pytest.mark.parametrize("explain", [False, True], ids=["plain", "explain"])
@pytest.mark.parametrize("case", CASES)
def test_model_matches_plain_and_reference(case, explain, clusters):
    kind, cluster, lanes, m, plain, ref, carry_, ref_carry, facts = \
        _inputs(case, explain)
    if kind == "wave":
        got, got_carry, overlays, changed = wave_model(cluster, lanes, m,
                                                       clusters, explain)
    else:
        got, got_carry, overlay = lane_chain_model(cluster, lanes[0], m,
                                                   clusters, explain)
        overlays = [overlay]
    _assert_bitwise(plain, got, f"{case} C={clusters}")
    cc.assert_outputs(ref, got, explain=explain, what=f"{case} ref")
    if carry_ is not None:
        _assert_bitwise(carry_, got_carry, f"{case} carry")
        cc.assert_carry(ref_carry, got_carry, f"{case} ref carry")
    sel = got[0].numpy()
    assert (sel >= 0).any(), "nothing placed: vacuous"
    batch = lanes[0]
    if facts.get("hot"):
        # the hot row: placed by programs 0 and 2, a delta row of program 1
        hot = int(sel[0, 0])
        assert hot >= 0 and int(sel[2, 0]) == hot
        assert hot in batch.delta_idx[1].tolist()
        assert bool(overlays[0][hot])
    if facts.get("penalty"):
        row = int(sel[0, 0])
        assert row >= 0 and row in batch.penalty_idx[1, 0].tolist()
        assert bool(overlays[0][row])
    if "pad" in facts:
        assert (sel[facts["pad"]] == -1).all()
    if "floor" in facts:
        assert (sel[facts["floor"]] == -1).all()
        assert int(got[2][facts["floor"]]) == 0
        if explain:
            top = got[4 + tp.PlacementExplain._fields.index("topk_idx")]
            assert top[facts["floor"]].tolist() == [[0, 1, 2, 3, 4]] * m
    if facts.get("cancel"):
        row = int(sel[1, 0])
        assert row >= 0 and bool(overlays[0][row]) and bool(overlays[1][row])
        assert not bool(changed[0][row]) and bool(changed[1][row])
        assert int(got[-1]) == 0 == int(np.asarray(ref[-1]))
    if facts.get("collide"):
        assert int(got[-1]) > 0 and int(got[-1]) == int(np.asarray(ref[-1]))


# ---- the route by shape --------------------------------------------------------

#: `_program_dims` of phase 6's mix at count 10 (M = 16), explain on
MIX_DIMS = dict(c=4, v=32, a=1, av=32, m=16, pn=1, e=1, j=1, j2=1, d=1,
                l=1, p=1, dv=32, pp=1, pc=1, ps=1, s=1, sv=32, cw=1,
                explain=1, topk=5)


def test_route_is_the_widest_resident_cluster_at_the_server_shape():
    # a chain, a wave of 3 and of 16 lanes at N = 16384 on 132 SMs: C = 8
    for lanes in (1, 3, 16):
        assert tp.lane_route(16384, lanes, MIX_DIMS, 8, 132) == 8
    # more lanes than clusters of 8 fit the card: C shrinks
    assert tp.lane_route(16384, 17, MIX_DIMS, 8, 132) == 4
    assert tp.lane_route(16384, 40, MIX_DIMS, 8, 132) == 2
    assert tp.lane_route(16384, 200, MIX_DIMS, 8, 132) == 1
    # fewer rows than LANE_SLICE_ROWS a block: fewer blocks
    assert tp.lane_route(4096, 1, MIX_DIMS, 8, 132) == 2
    assert tp.lane_route(2048, 1, MIX_DIMS, 8, 132) == 1
    assert tp.lane_route(256, 1, MIX_DIMS, 8, 132) == 1


def test_route_past_the_layout_takes_chain_cu():
    # the largest view a cluster of 8 holds, and the next one past it
    fits = [n for n in range(16384, 1 << 20, 4096)
            if tp.lane_layout(tp.lane_rows(n, 8), MIX_DIMS, 8,
                              8)["total"] <= tp.BLOCK_SMEM]
    last = fits[-1]
    assert tp.lane_route(last, 1, MIX_DIMS, 8, 132) == 8
    assert tp.lane_route(last + 4096, 1, MIX_DIMS, 8, 132) == 0
    # a layout too big at the residency's C grows C until it fits
    assert tp.lane_route(last, 200, MIX_DIMS, 8, 132) == 8
    # vocabularies past u16, and programs without a step, never go on chip
    assert tp.lane_route(256, 1, dict(MIX_DIMS, sv=70000), 8, 132) == 0
    assert tp.lane_route(256, 1, dict(MIX_DIMS, m=0), 8, 132) == 0


@pytest.mark.parametrize("lanes", [65535, 65536, 200_000])
def test_route_takes_any_lane_count(lanes):
    """A wave past gridDim.y's 65,535 lanes stays on the lane route: the
    launch's clusters run the lanes past it in turns (csrc/lanes.cu), so
    the route by shape never turns a wave away for its lane count and the
    library refuses none."""
    assert tp.lane_route(64, lanes, MIX_DIMS, 8, 132) == 1
    assert tp.lane_route(16384, lanes, MIX_DIMS, 8, 132) == 1
    src = (Path(tp.__file__).parent / "csrc" / "lanes.cu").read_text()
    assert "65535" not in src
    assert "lane_id += gridDim.y" in src
    assert "L.lanes < MAX_GRID_Y ? L.lanes : MAX_GRID_Y" in src


def test_lane_rows_are_words_of_the_overlay():
    for n in (64, 256, 300, 16384, 16385):
        for c in SIZES:
            rows = tp.lane_rows(n, c)
            assert rows % 32 == 0 and rows * c >= n and rows - 32 < -(-n // c)


def _regions_in_source():
    src = (Path(tp.__file__).parent / "csrc" / "lanes.cu").read_text()
    enum = re.search(r"enum LaneRegion \{([^}]*)\}", src).group(1)
    names = [x.strip()[2:].lower() for x in enum.split(",") if x.strip()]
    assert names[-1] == "end"
    return names[:-1]


@pytest.mark.parametrize("rows", [32, 2048, 16384])
@pytest.mark.parametrize("explain", [0, 1], ids=["plain", "explain"])
@pytest.mark.parametrize("wide", [False, True], ids=["u8", "u16"])
def test_layout_matches_the_kernel(rows, explain, wide):
    """`lane_layout` reckons the regions of `lane_offsets`
    (csrc/lanes.cu) in its order, each on a 16-byte boundary, none
    overlapping; per row 4 + 1 bytes (+ 1 with explain), an overlay bit
    and a token a spread row and a property (u8, or u16 past 256
    values); two sets of C record slots. The card checks the library's
    own total against it at every launch."""
    dims = dict(MIX_DIMS, s=2, sv=300 if wide else 32, p=1,
                dv=300 if wide else 32, explain=explain)
    lay = tp.lane_layout(rows, dims, 8, 8)
    names = [k for k in lay if k != "total"]
    assert names == _regions_in_source() == list(tp._LANE_REGIONS)
    end = 0
    for name in names:
        off, size = lay[name]
        assert off % 16 == 0 and off >= end, name
        end = off + size
    assert lay["total"] == (end + 15) & ~15
    tok = 2 if wide else 1
    assert lay["prefix"][1] == 4 * rows and lay["meta"][1] == rows
    assert lay["exh"][1] == (rows if explain else 0)
    assert lay["overlay"][1] == rows // 8
    assert lay["stok"][1] == 2 * rows * tok and lay["dtok"][1] == rows * tok
    words = tp.record_words(dims, 8)
    assert lay["slots"][1] == 2 * 8 * 4 * (-(-words // 4) * 4)
    assert lay["spec"][1] == 16
    assert lay["args"][1] == tp.ctypes.sizeof(tp._PlaceArgs)


def test_record_words_match_the_kernel():
    """`record_words` is `shard_rec_words` (csrc/cluster_core.cuh)."""
    src = (Path(tp.__file__).parent / "csrc" / "cluster_core.cuh").read_text()
    assert "7 + 2 * (A.s + A.p)" in src
    assert "4 + A.r + TOPK_WORDS * A.topk + 3 + A.c" in src
    assert tp.record_words(dict(MIX_DIMS, explain=0), 8) == 7 + 2 * 2
    assert tp.record_words(MIX_DIMS, 8) == 11 + 4 + 8 + 7 * 5 + 3 + 4


def test_cpu_tensors_never_launch_the_lane_kernel():
    _kind, stack, progs, _facts = _case("inert_pad")
    prep, ti, tf, tu = cc.table_prep(progs)
    before = (tp.chain_kernel_launches(), tp.chain_route_counts(),
              tp.last_chain_dispatch_route())
    out, _carry = tp.place_table_chain(
        cc.port_cluster(stack.device_arrays()), *cc.port_bufs(ti, tf, tu),
        prep.rows, *cc.port_bufs(prep.dyn_i, prep.dyn_f, prep.dyn_u),
        prep.sspec, prep.dspec, prep.m)
    assert (tp.chain_kernel_launches(), tp.chain_route_counts(),
            tp.last_chain_dispatch_route()) == before
    assert (out[0].numpy() >= 0).any()
