"""The port's roofline (`nomad_tpu_torch/lib/roofline.py`).

Twins of `tests/test_telemetry.py` `TestRoofline` on the H100's table;
the port's `summarize` key by key the reference's on the same cost,
seconds and peaks; `kernel_cost` reproducing the byte counts of the
view delta and the program-table insert at the card runs' shapes, and
one count a function whatever form its inputs take; `chip_smoke.py`
keeping no count or peak of its own.
"""
import ast
import random
from pathlib import Path

import pytest
import torch

from nomad_tpu.lib import roofline as ref_roofline
from nomad_tpu_torch.lib import roofline

REPO = Path(__file__).resolve().parent.parent
SXM = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def card(monkeypatch):
    """A CUDA device whose name the test sets: `card(name)`."""
    def named(name):
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda device=None: name)
        return torch.device("cuda", 0)
    return named


class TestRoofline:
    def test_device_peaks_table(self, card):
        f, bw, kind = roofline.device_peaks(card(SXM))
        assert (f, bw) == (67e12, 3.35e12) and kind == SXM
        f, bw, _ = roofline.device_peaks(card("NVIDIA H100 PCIe"))
        assert (f, bw) == (51e12, 2.0e12)
        f, bw, _ = roofline.device_peaks(card("NVIDIA H100 NVL"))
        assert (f, bw) == (60e12, 3.9e12)
        f, bw, kind = roofline.device_peaks(torch.device("cpu"))
        assert f is None and bw is None and kind == "cpu"
        f, bw, kind = roofline.device_peaks(card("NVIDIA A100-SXM4-80GB"))
        assert f is None and bw is None and kind == "NVIDIA A100-SXM4-80GB"

    def test_summarize_bound_and_headroom(self, card):
        dev = card(SXM)
        # intensity 0.5 FLOP/B << ridge (20): memory-bound; at exactly
        # peak bandwidth the headroom is 1.0
        cost = {"flops": 3.35e12 * 0.5, "bytes_accessed": 3.35e12}
        s = roofline.summarize("k", cost, seconds_per_call=1.0, device=dev)
        assert s["bound"] == "memory"
        assert s["pct_of_peak_hbm_bw"] == 100.0
        assert s["headroom_x"] == 1.0
        # compute-heavy kernel: intensity above the ridge point
        cost = {"flops": 67e12, "bytes_accessed": 1e6}
        s = roofline.summarize("k", cost, seconds_per_call=2.0, device=dev)
        assert s["bound"] == "compute"
        assert s["pct_of_peak_flops"] == 50.0
        assert s["headroom_x"] == 2.0

    def test_summarize_unknown_device(self):
        s = roofline.summarize("k", {"flops": 10.0, "bytes_accessed": 5.0},
                               seconds_per_call=0.1,
                               device=torch.device("cpu"))
        assert s["bound"] == "unknown"
        assert s["achieved_flops_per_sec"] == 100.0
        assert s["peak_flops_per_sec"] is None

    def test_kernel_cost_of_a_real_program(self, k1_case):
        arrays, p, m, sel = k1_case
        cost = roofline.kernel_cost("place_task_group", cluster=arrays,
                                    program=p, m=m, sel=sel)
        assert cost["flops"] > 0 and cost["bytes_accessed"] > 0


class _FakeTPU:
    platform = "tpu"
    device_kind = "TPU fake"


@pytest.mark.parametrize("cost, seconds", [
    ({"flops": 3.35e12 * 0.5, "bytes_accessed": 3.35e12}, 1.0),
    ({"flops": 67e12, "bytes_accessed": 1e6}, 2.0),
    ({"flops": 12345.0, "bytes_accessed": 137120.0}, 1.66e-5),
    ({"flops": 0.0, "bytes_accessed": 492296.0}, 2.71e-5),
    ({"flops": 10.0, "bytes_accessed": 0.0}, 0.1),
    ({"flops": 10.0, "bytes_accessed": 5.0}, 0.0),
])
def test_summarize_equals_the_reference_key_by_key(card, monkeypatch, cost,
                                                   seconds):
    peaks = dict(roofline.DEVICE_PEAKS)["H100 80GB HBM3"]
    monkeypatch.setattr(ref_roofline, "DEVICE_PEAKS",
                        (("tpu fake", peaks),))
    got = roofline.summarize("k", cost, seconds, card(SXM))
    want = ref_roofline.summarize("k", cost, seconds, _FakeTPU())
    assert got.keys() == want.keys()
    for key in want:
        if key != "device_kind":
            assert got[key] == want[key], key
    assert (got["device_kind"], want["device_kind"]) == (SXM, "TPU fake")


def test_bound_is_the_larger_roof():
    peaks = (67e12, 3.35e12)
    ms, by = roofline.bound_ms({"flops": 0.0, "bytes_accessed": 137120.0},
                               peaks)
    assert by == "bytes" and ms == 137120 / 3.35e12 * 1e3
    ms, by = roofline.bound_ms({"flops": 67e9, "bytes_accessed": 1.0}, peaks)
    assert by == "operations" and ms == 1.0


def test_time_compiled_on_the_cpu():
    calls = []
    s = roofline.time_compiled(lambda: calls.append(1), iters=5, warmup=2,
                               device="cpu")
    assert len(calls) == 7 and s >= 0.0


def test_view_delta_bytes_at_the_card_runs_shape(small_state):
    """K7's refresh of 64 hot rows, 8 port rows and 64 port words on the
    [N, 8] view and its u32[N, 2048] port bitmap: 137,120 B."""
    cl = small_state.cluster
    r, w = cl.used.shape[1], cl.ports_used.shape[1]
    assert (r, w) == (8, 2048)
    cost = roofline.kernel_cost("view_delta", hot_rows=64, r=r, port_rows=8,
                                port_words=64, words_per_row=w)
    assert cost == {"flops": 0.0, "bytes_accessed": 137120.0}


def test_table_insert_bytes_at_the_card_runs_shape():
    """K8: 8 rows into the three class tables of T = 512 rows, whose row
    widths for the phase-5 mix on the 10,000-node cluster are 9 i32, 77
    f32 and 133 u8: 492,296 B."""
    cost = roofline.kernel_cost("table_insert", table_rows=512, rows=8,
                                widths=(9, 77, 133))
    assert cost == {"flops": 0.0, "bytes_accessed": 492296.0}


def test_a_sharded_view_delta_is_the_same_function():
    """B13: 64 hot rows in each of a shard's two copies count as K7's
    128 hot rows."""
    one = roofline.kernel_cost("view_delta", hot_rows=128, r=8)
    row_in = 4 + 8 * 4 + 1 + 4
    assert one["bytes_accessed"] == 64 * 2 * (2 * row_in - 4)


def test_unknown_kernel_raises():
    with pytest.raises(ValueError):
        roofline.kernel_cost("place_everything")


@pytest.fixture(scope="module")
def small_state():
    from nomad_tpu_torch.synth import build_synthetic_state

    state, _nodes = build_synthetic_state(64, 100, seed=3)
    return state


@pytest.fixture(scope="module")
def k1_case(small_state):
    from nomad_tpu_torch.kernels import placement as kp
    from nomad_tpu_torch.parallel.pad import pad_params
    from nomad_tpu_torch.convert import params_from_numpy
    from nomad_tpu_torch.scheduler.stack import TorchStack
    from nomad_tpu_torch.synth import synth_service_job

    stack = TorchStack(small_state.cluster, device="cpu")
    job = synth_service_job(random.Random(4), count=4, with_affinity=True)
    params, m = stack.compile_tg(job, job.task_groups[0], 4, None)
    (padded,), _ = pad_params([params])
    arrays = stack.device_arrays()
    p = params_from_numpy(padded, "cpu")
    res = kp.place_task_group(arrays, p, m, True)
    return arrays, p, m, res.sel_idx


@pytest.fixture(scope="module")
def chain_forms(small_state):
    """Four programs through the program table (as the server's chain
    takes them) and through the packed buffers (as a packed chain takes
    them), with each form's selections."""
    from nomad_tpu_torch.convert import tensor_from_numpy
    from nomad_tpu_torch.kernels import placement as kp
    from nomad_tpu_torch.lib.transfer import default_ledger
    from nomad_tpu_torch.parallel.pad import stack_params
    from nomad_tpu_torch.scheduler.stack import TorchStack
    from nomad_tpu_torch.server.program_table import DeviceProgramTable
    from nomad_tpu_torch.synth import synth_service_job

    stack = TorchStack(small_state.cluster, device="cpu")
    rng = random.Random(4)
    jobs = [synth_service_job(rng, count=4, with_affinity=i % 2 == 0,
                              with_spread=i == 1, distinct_hosts=i == 2)
            for i in range(4)]
    progs = [stack.compile_tg(j, j.task_groups[0], 4, None)[0]
             for j in jobs]
    arrays = stack.device_arrays()
    table = DeviceProgramTable(device="cpu")
    prep = table.prepare(progs)
    ti, tf, tu, _nb, _count = table.commit(prep, default_ledger())
    dyn = tuple(tensor_from_numpy(d, torch.device("cpu"))
                for d in (prep.dyn_i, prep.dyn_f, prep.dyn_u))
    tables = kp._assemble_table_batch(
        ti, tf, tu, kp.host_rows(prep.rows).reshape(-1),
        *(d.reshape(-1, d.shape[-1]) for d in dyn), prep.sspec, prep.dspec)
    sel_t = kp.place_table_chain_plain(arrays, ti, tf, tu, prep.rows, *dyn,
                                       prep.sspec, prep.dspec, prep.m)[0][0]
    stacked, m = stack_params(progs)
    ibuf, fbuf, ubuf, spec = kp.pack_params(stacked)
    bufs = [torch.as_tensor(b) for b in (ibuf, fbuf, ubuf)]
    packed = kp._unpack_params(*bufs, spec)
    sel_p = kp.place_packed_chain(arrays, *bufs, spec, m, explain=True)[0]
    return arrays, (tables, prep.m, sel_t), (packed, m, sel_p)


@pytest.mark.parametrize("explain", [False, True])
def test_one_count_for_k4_whichever_inputs(chain_forms, explain):
    arrays, (tables, mt, sel_t), (packed, mp, sel_p) = chain_forms
    assert torch.equal(sel_t, sel_p)
    table_cost = roofline.kernel_cost(
        "place_table_chain", cluster=arrays, programs=tables, m=mt,
        sel=sel_t, explain=explain)
    packed_cost = roofline.kernel_cost(
        "place_packed_chain", cluster=arrays, programs=packed, m=mp,
        sel=sel_p, explain=explain)
    assert table_cost == packed_cost
    assert table_cost["flops"] > 0


def test_a_count_takes_no_route(chain_forms):
    arrays, (tables, m, sel), _packed = chain_forms
    for knob in ("clusters", "route"):
        with pytest.raises(TypeError):
            roofline.kernel_cost("place_table_chain", cluster=arrays,
                                 programs=tables, m=m, sel=sel,
                                 **{knob: 0})


def test_counts_read_this_runs_selections(chain_forms):
    """A step after one that placed nothing, with the same penalty rows,
    does no row work: fewer selections, fewer operations."""
    arrays, (tables, m, sel), _packed = chain_forms
    placed = roofline.kernel_cost("place_table_chain", cluster=arrays,
                                  programs=tables, m=m, sel=sel)
    none = roofline.kernel_cost("place_table_chain", cluster=arrays,
                                programs=tables, m=m,
                                sel=torch.full_like(sel, -1))
    assert none["bytes_accessed"] == placed["bytes_accessed"]
    assert none["flops"] <= placed["flops"]


def test_k6_and_k9_counts_of_one_batch(chain_forms):
    arrays, _tables, (packed, m, sel) = chain_forms
    k6 = roofline.kernel_cost("place_packed_batch", cluster=arrays,
                              programs=packed, m=m)
    k9 = roofline.kernel_cost("scheduler_step", cluster=arrays,
                              programs=packed, m=m, sel=sel)
    n, r = arrays.capacity.shape
    # K9 writes every program's new_used and final_scores0 beside the
    # selections K6 writes alone
    b = packed.n_place.shape[0]
    assert k9["bytes_accessed"] - k6["bytes_accessed"] == b * (
        4 + n * r * 4 + n * 4 + m * 4)


def test_system_count(small_state):
    from nomad_tpu_torch.convert import params_from_numpy
    from nomad_tpu_torch.parallel.pad import pad_params
    from nomad_tpu_torch.scheduler.stack import TorchStack
    from nomad_tpu_torch.synth import synth_system_job

    stack = TorchStack(small_state.cluster, device="cpu")
    job = synth_system_job(random.Random(3))
    (p,), _m = pad_params([stack.compile_tg(job, job.task_groups[0], 1)[0]])
    arrays = stack.device_arrays()
    cost = roofline.kernel_cost("system_feasibility", cluster=arrays,
                                program=params_from_numpy(p, "cpu"))
    n = arrays.capacity.shape[0]
    # two bool[N] masks are among the bytes; every row does work
    assert cost["bytes_accessed"] > 2 * n and cost["flops"] >= n


#: helpers and constants `chip_smoke.py` kept before the roofline module
_MOVED = ("_bound", "_bound_of", "_bound_ms", "_bound_parts", "_active_steps",
          "_lane_ops", "_chain_bound", "_k1_bound", "_k2_bound", "_k3_bound",
          "_k3_walk", "_batch_bound", "_onchip_ops", "_onchip_bound",
          "_k9_bound")


def test_chip_smoke_keeps_no_count_or_peak_of_its_own():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    defs = {n.name for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    assert not defs & set(_MOVED), sorted(defs & set(_MOVED))
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            names = {t.id for t in node.targets if isinstance(t, ast.Name)}
            if names & {"HBM_BYTES_PER_S", "FP32_OPS_PER_S"}:
                assert not isinstance(node.value, ast.Constant), names


def test_preempt_count_reads_the_walk(k1_case):
    """K3 on a dense table: every row's priorities and the usage rows the
    walk reaches; no slot walked when no victim is eligible."""
    from nomad_tpu_torch.kernels import preemption as kpre

    arrays, p, _m, _sel = k1_case
    n, r = arrays.capacity.shape
    a = 4
    gen = torch.Generator().manual_seed(5)
    prio = torch.randint(0, 100, (n, a), generator=gen).float()
    usage = torch.rand((n, a, r), generator=gen) * 100
    cand = kpre.PreemptionCandidates(prio, usage)
    got = kpre.preempt_rank_plain(arrays, p, cand)
    cost = roofline.kernel_cost("preempt_rank", cluster=arrays, program=p,
                                candidates=cand, order=got.order)
    assert 0 < cost["slots_walked"] <= n * a
    pads = kpre.PreemptionCandidates(torch.full_like(prio, kpre.INF_PRIO),
                                     usage)
    none = roofline.kernel_cost("preempt_rank", cluster=arrays, program=p,
                                candidates=pads, order=got.order)
    assert none["slots_walked"] == 0
    assert cost["bytes_accessed"] - none["bytes_accessed"] == \
        cost["slots_walked"] * r * 4
    compact = roofline.kernel_cost("preempt_rank", cluster=arrays,
                                   program=p, candidates=cand,
                                   order=got.order, entries=n * a)
    assert cost["bytes_accessed"] - compact["bytes_accessed"] == \
        n * a * 4 - (4 * (n + 1) + 8 * n * a)
