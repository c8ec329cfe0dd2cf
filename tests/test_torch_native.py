"""The port's host core (`nomad_tpu_torch/native`) against the reference's.

Twins of `tests/test_native.py` on the port (first-fit, fits / score /
scatter, NetworkIndex integration, the compiled select exact and sampled,
the log2 window); the port's compiled select bitwise the reference's on
the same synthetic state, and within 1e-4 of the port's TorchStack.select
on the CPU; the C++ first-fit against its plain version over seeded
fills; a missing compiler raises, and builds that race leave one whole
library.
"""
import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from nomad_tpu import native as ref_native
from nomad_tpu_torch import native

REPO = Path(__file__).resolve().parent.parent

#: the seven job variants of the reference's compiled-select test
VARIANTS = [
    dict(),
    dict(with_affinity=True),
    dict(with_spread=True),
    dict(distinct_hosts=True),
    dict(with_affinity=True, with_spread=True, distinct_hosts=True),
    dict(distinct_property=True),
    "even_spread",
]


@pytest.fixture(scope="module", autouse=True)
def native_built():
    assert native.available(), (
        "g++ is present in this image — the native core must build")


def _rand_used(rng, frac):
    used = np.zeros(65536, dtype=bool)
    n = int(65536 * frac)
    used[rng.choice(65536, size=n, replace=False)] = True
    return used


class TestFirstFitPorts:
    def test_matches_python_fallback(self):
        rng = np.random.default_rng(7)
        for frac in (0.0, 0.3, 0.9):
            used = _rand_used(rng, frac)
            reserved = [20000, 20001, 25000]
            got = native.first_fit_ports(used, 20000, 32000, reserved, 5)
            want = native._first_fit_py(used, 20000, 32000, reserved, 5)
            assert got == want

    @pytest.mark.parametrize("seed", range(4))
    def test_seeded_fills_match_the_plain_version(self, seed):
        rng = np.random.default_rng(seed)
        for _ in range(25):
            used = _rand_used(rng, float(rng.uniform(0.0, 1.0)))
            lo = int(rng.integers(0, 60000))
            hi = lo + int(rng.integers(1, 5536))
            reserved = [int(x) for x in rng.integers(lo - 10, hi + 10, 6)]
            count = int(rng.integers(1, 64))
            assert native.first_fit_ports(used, lo, hi, reserved, count) \
                == native._first_fit_py(used, lo, hi, reserved, count)

    def test_exhaustion_returns_empty(self):
        used = np.ones(65536, dtype=bool)
        assert native.first_fit_ports(used, 20000, 32000, [], 1) == []

    def test_skips_reserved(self):
        used = np.zeros(65536, dtype=bool)
        got = native.first_fit_ports(used, 20000, 32000, [20000, 20002], 3)
        assert got == [20001, 20003, 20004]

    def test_zero_count(self):
        used = np.zeros(65536, dtype=bool)
        assert native.first_fit_ports(used, 20000, 32000, [], 0) == []

    def test_equals_the_reference_core(self):
        rng = np.random.default_rng(11)
        for frac in (0.0, 0.5, 0.99, 1.0):
            used = _rand_used(rng, frac)
            for count in (1, 7, 120):
                assert native.first_fit_ports(used, 20000, 32000, [20003],
                                              count) \
                    == ref_native.first_fit_ports(used, 20000, 32000,
                                                  [20003], count)


class TestFitsAndScore:
    def test_fits_batch_parity(self):
        rng = np.random.default_rng(3)
        N, R = 64, 8
        capacity = rng.uniform(100, 4000, (N, R)).astype(np.float32)
        used = (capacity * rng.uniform(0, 1.2, (N, R))).astype(np.float32)
        ask = rng.uniform(0, 500, R).astype(np.float32)
        rows = np.arange(N, dtype=np.int32)
        got = native.fits_batch(capacity, used, ask, rows)
        want = np.all(capacity - used >= ask[None, :], axis=1)
        np.testing.assert_array_equal(got, want)

    def test_score_binpack_parity_with_reference_formula(self):
        capacity = np.array([[4000, 8192, 0, 0]], dtype=np.float32)
        used = np.array([[1000, 2048, 0, 0]], dtype=np.float32)
        ask = np.array([500, 1024, 0, 0], dtype=np.float32)
        rows = np.array([0], dtype=np.int32)
        got = float(native.score_binpack(capacity, used, ask, rows)[0])
        free_cpu = (4000 - 1000 - 500) / 4000
        free_mem = (8192 - 2048 - 1024) / 8192
        want = 20.0 - 10 ** free_cpu - 10 ** free_mem
        assert abs(got - want) < 1e-4

    def test_score_matches_structs_funcs(self):
        """Native score == the port's parity-anchor scorer (capacity rows
        = resources − reserved, funcs.go:150)."""
        from nomad_tpu_torch import mock
        from nomad_tpu_torch.structs.funcs import score_fit_binpack
        from nomad_tpu_torch.structs.resources import ComparableResources

        node = mock.node()
        util = ComparableResources(cpu=1500.0, memory_mb=3072.0)
        want = score_fit_binpack(node, util)
        res = node.comparable_resources()
        reserved = node.comparable_reserved_resources()
        cap = np.array([[res.cpu - reserved.cpu,
                         res.memory_mb - reserved.memory_mb]],
                       dtype=np.float32)
        used = np.array([[1500.0, 3072.0]], dtype=np.float32)
        got = float(native.score_binpack(
            cap, used, np.zeros(2, dtype=np.float32),
            np.array([0], dtype=np.int32))[0])
        assert abs(got - want) < 1e-3

    def test_scatter_add_roundtrip(self):
        used = np.zeros((8, 4), dtype=np.float32)
        rows = np.array([1, 3, 1], dtype=np.int32)
        usage = np.arange(12, dtype=np.float32).reshape(3, 4)
        native.scatter_add(used, rows, usage, 1.0)
        want = np.zeros((8, 4), dtype=np.float32)
        np.add.at(want, rows, usage)
        np.testing.assert_allclose(used, want)
        native.scatter_add(used, rows, usage, -1.0)
        np.testing.assert_allclose(used, np.zeros((8, 4)))

    def test_scatter_add_refuses_a_buffer_it_cannot_write(self):
        usage = np.ones((1, 4), dtype=np.float32)
        for used in (np.zeros((8, 4)), np.zeros((4, 8), np.float32).T):
            with pytest.raises(ValueError):
                native.scatter_add(used, np.array([0]), usage)

    def test_count_free_ports(self):
        used = np.zeros(65536, dtype=bool)
        used[20000:20010] = True
        assert native.count_free_ports(used, 20000, 20020) == 10


class TestNetworkIndexIntegration:
    def test_assign_network_uses_native_path(self):
        from nomad_tpu_torch import mock
        from nomad_tpu_torch.structs.network import NetworkIndex
        from nomad_tpu_torch.structs.resources import NetworkResource, Port

        node = mock.node()
        idx = NetworkIndex()
        idx.set_node(node)
        ask = NetworkResource(mbits=10, dynamic_ports=[
            Port(label="http"), Port(label="metrics")])
        offer, err = idx.assign_network(ask)
        assert err == "" and offer is not None
        vals = [p.value for p in offer.dynamic_ports]
        assert len(set(vals)) == 2
        assert all(20000 <= v < 32000 for v in vals)


def _variant_job(synth, structs, rng, variant, count=4):
    if variant == "even_spread":
        job = synth.synth_service_job(rng, count=count)
        job.spreads.append(structs.Spread(attribute="${node.datacenter}",
                                          weight=100))
        return job
    return synth.synth_service_job(rng, count=count, **variant)


def _twin_problem(n_nodes, n_allocs, seed):
    """The same synthetic state and job stream in both packages."""
    from nomad_tpu import structs as ref_structs
    from nomad_tpu import synth as ref_synth
    from nomad_tpu_torch import structs, synth

    port_state, _ = synth.build_synthetic_state(n_nodes, n_allocs, seed=seed)
    ref_state, _ = ref_synth.build_synthetic_state(n_nodes, n_allocs,
                                                   seed=seed)
    return ((synth, structs, port_state), (ref_synth, ref_structs, ref_state))


class TestCompiledSelect:
    """The C++ select loop must agree with the port's placement on node
    choice and normalized score, and with the reference's C++ loop bit
    for bit."""

    def test_agrees_with_kernel(self):
        from nomad_tpu_torch.scheduler.stack import TorchStack
        from nomad_tpu_torch.structs import Spread
        from nomad_tpu_torch.synth import (build_synthetic_state,
                                           synth_service_job)

        state, _nodes = build_synthetic_state(64, 100, seed=3)
        rng = random.Random(5)
        cl = state.cluster
        for i, variant in enumerate(VARIANTS):
            if variant == "even_spread":
                job = synth_service_job(rng, count=4)
                job.spreads.append(Spread(attribute="${node.datacenter}",
                                          weight=100))
            else:
                job = synth_service_job(rng, count=4, **variant)
            tg = job.task_groups[0]
            stack = TorchStack(cl, device="cpu")
            sel_k = stack.select(job, tg, 4)
            sel_c, score_c = native.compiled_select(stack, job, tg, 4)
            for step in range(4):
                k_node = sel_k.node_ids[step]
                c_node = (cl.node_of_row[sel_c[step]]
                          if sel_c[step] >= 0 else None)
                if k_node is None or c_node is None:
                    assert k_node is None and c_node is None, (i, step)
                    continue
                assert k_node == c_node, (i, step)
                assert abs(sel_k.scores[step] - score_c[step]) < 1e-4, (
                    i, step, k_node, c_node,
                    sel_k.scores[step], score_c[step])

    @pytest.mark.parametrize("variant", range(len(VARIANTS)))
    def test_bitwise_the_reference(self, variant):
        from nomad_tpu.scheduler.stack import TPUStack
        from nomad_tpu_torch.scheduler.stack import TorchStack

        (ps, pst, pstate), (rs, rst, rstate) = _twin_problem(64, 100, 3)
        pjob = _variant_job(ps, pst, random.Random(5 + variant),
                            VARIANTS[variant])
        rjob = _variant_job(rs, rst, random.Random(5 + variant),
                            VARIANTS[variant])
        got = native.compiled_select(
            TorchStack(pstate.cluster, device="cpu"), pjob,
            pjob.task_groups[0], 4)
        want = ref_native.compiled_select(
            TPUStack(rstate.cluster), rjob, rjob.task_groups[0], 4)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1].tobytes() == want[1].tobytes()

    def test_sampled_bitwise_the_reference(self):
        from nomad_tpu.scheduler.stack import TPUStack
        from nomad_tpu_torch.scheduler.stack import TorchStack

        (ps, _pst, pstate), (rs, _rst, rstate) = _twin_problem(512, 256, 5)
        pjob = ps.synth_service_job(random.Random(6), count=8,
                                    with_affinity=True)
        rjob = rs.synth_service_job(random.Random(6), count=8,
                                    with_affinity=True)
        pstate.upsert_job(pjob)
        rstate.upsert_job(rjob)
        order = np.random.default_rng(3).permutation(
            pstate.cluster.n_cap).astype(np.int32)
        got = native.compiled_select(
            TorchStack(pstate.cluster, device="cpu"), pjob,
            pjob.task_groups[0], 8, order=order)
        want = ref_native.compiled_select(
            TPUStack(rstate.cluster), rjob, rjob.task_groups[0], 8,
            order=order.copy())
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1].tobytes() == want[1].tobytes()


class TestCompiledSelectSampled:
    """The reference's select shape (scheduler/stack.go:10-18 +
    LimitIterator): log2(n) candidates from a shuffled walk, maxSkip 3.
    Placement quality may trail the exact scan; validity must not."""

    def _problem(self, n_nodes=512, seed=5):
        from nomad_tpu_torch.scheduler.stack import TorchStack
        from nomad_tpu_torch.synth import (build_synthetic_state,
                                           synth_service_job)

        state, _ = build_synthetic_state(n_nodes, n_nodes // 2, seed=seed)
        rng = random.Random(seed + 1)
        job = synth_service_job(rng, count=8, with_affinity=True)
        state.upsert_job(job)
        return state.cluster, TorchStack(state.cluster, device="cpu"), job

    def test_sampled_places_validly(self):
        cl, stack, job = self._problem()
        tg = job.task_groups[0]
        rng = np.random.default_rng(3)
        order = rng.permutation(cl.n_cap).astype(np.int32)
        sel, score = native.compiled_select(stack, job, tg, 8, order=order)
        assert (sel >= 0).all()  # everything placed
        # every selected row is a real, eligible node
        for row in sel:
            assert cl.node_ok[row]
        # scores are the same normalized scale the exact loop emits
        assert (score > 0).all() and (score <= 1.5).all()

    def test_sampled_quality_trails_exact_boundedly(self):
        cl, stack, job = self._problem()
        tg = job.task_groups[0]
        exact = native.compiled_select(stack, job, tg, 8)
        rng = np.random.default_rng(4)
        order = rng.permutation(cl.n_cap).astype(np.int32)
        sampled = native.compiled_select(stack, job, tg, 8, order=order)
        mean_exact = float(exact[1].mean())
        mean_sampled = float(sampled[1].mean())
        assert (sampled[0] >= 0).all()
        assert mean_exact >= mean_sampled - 1e-6, (
            mean_exact, mean_sampled)

    def test_limit_window_is_log2(self):
        """With a single feasible node hidden at the end of the order and
        limit defaulting to ceil(log2(n)), the sampled walk must still
        find it — infeasible nodes do not consume the window."""
        cl, stack, job = self._problem(n_nodes=64)
        tg = job.task_groups[0]
        order = np.arange(cl.n_cap, dtype=np.int32)[::-1].copy()
        out = native.compiled_select(stack, job, tg, 4, order=order,
                                     max_skip=0)
        assert (out[0] >= 0).all()


class TestBuild:
    def test_missing_compiler_raises(self, tmp_path, monkeypatch):
        """No g++ on PATH and nothing built: the first call raises, and
        nothing falls back to a Python loop."""
        (tmp_path / "bin").mkdir()
        monkeypatch.setenv("PATH", str(tmp_path / "bin"))
        monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
        monkeypatch.setattr(native, "_lib", None)
        used = np.zeros(65536, dtype=bool)
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            native.first_fit_ports(used, 20000, 32000, [], 1)
        with pytest.raises(RuntimeError):
            native.available()
        assert not list((tmp_path / "build").glob("*.so"))

    def test_no_switch_turns_the_core_off(self):
        src = (REPO / "nomad_tpu_torch" / "native" / "__init__.py")
        assert "NOMAD_TPU_NO_NATIVE" not in src.read_text()
        net = (REPO / "nomad_tpu_torch" / "structs" / "network.py")
        assert "_first_fit_py" not in net.read_text()

    def test_library_name_carries_the_source_hash(self):
        path = Path(native.library_path())
        assert path.parent == Path(native.BUILD_DIR)
        assert path.name.startswith("libnomad_core-") and path.is_file()

    def test_processes_building_at_once_load_one_whole_library(
            self, tmp_path):
        code = ("import sys, numpy as np\n"
                "import nomad_tpu_torch.native as n\n"
                "n.BUILD_DIR = sys.argv[1]\n"
                "assert n.available()\n"
                "print(n.first_fit_ports(np.zeros(65536, bool), 20000, "
                "32000, [20000], 2))\n")
        env = dict(os.environ, PYTHONPATH=str(REPO))
        procs = [subprocess.Popen([sys.executable, "-c", code,
                                   str(tmp_path)], env=env, cwd=REPO,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for _ in range(4)]
        outs = [p.communicate(timeout=120) for p in procs]
        for p, (out, err) in zip(procs, outs):
            assert p.returncode == 0, err[-2000:]
            assert out.strip() == "[20001, 20002]"
        assert [f.name for f in tmp_path.iterdir()] == [
            Path(native.library_path()).name]
