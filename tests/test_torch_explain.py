"""Twins of the reference's `tests/test_explain.py`, run on the port
(every stack, harness, server and agent the port's with `device="cpu"`).

Three contracts, as in the reference:

1. FREE — `sel_idx`/`sel_score` are bitwise equal with explain on and
   off, on the single-program and the packed-chain paths.
2. HONEST — the port's PlacementExplain counts agree with the port's
   scalar oracle (`oracle.explain_select`) and equal the reference's
   on the same cluster (`TestExplainAgainstReference`).
3. SURFACED — every placement and blocked eval carries an AllocMetric
   end to end.

And the opt-out: `NOMAD_TPU_EXPLAIN=0` turns explain off on the port as
it does in the reference (`TorchStack(explain=None)` defers to
`explain_enabled()`); the failed placement then carries only the coarse
counts, equal to the reference's (`TestOptOutAgainstReference`). The
agent cases keep the reference's `slow` marks.
"""
import random
import threading
import time

import numpy as np
import pytest
import torch

from nomad_tpu_torch import mock
from nomad_tpu_torch.scheduler.oracle import OracleContext, explain_select
from nomad_tpu_torch.scheduler.stack import TorchStack
from nomad_tpu.structs.codec import from_wire as ref_from_wire
from nomad_tpu_torch.structs import Constraint
from nomad_tpu_torch.structs.codec import to_wire
from nomad_tpu_torch.tensor.cluster import ClusterTensors

import test_kernel_parity as tkp
import torch_cases as tc
from torch_chain_cases import one_torch_thread  # noqa: F401
from torch_ops_cases import PORT, REF, as_pkg, mod
from torch_sched_cases import ATOL, Twins, failed_view, wire

SEED = 7


#: `tests/test_kernel_parity.py`'s builders, on the port's mocks and
#: ClusterTensors
make_cluster = tc.on_port(tkp.make_cluster)
seed_allocs = tc.on_port(tkp.seed_allocs)


def placed_alloc(job, tg, node_id):
    """`test_kernel_parity.placed_alloc` for a port job: built on the
    reference's copy of the job, carried back over the wire."""
    ref_job = ref_from_wire(to_wire(job))
    return wire(tkp.placed_alloc(ref_job, ref_job.lookup_task_group(tg.name),
                                 node_id))


def _on(arrays, x):
    """A host buffer or numpy program on the view's device."""
    return torch.as_tensor(np.asarray(x), device=arrays.used.device)


# ---- 1. free: bit-identity ------------------------------------------------


class TestBitIdentity:
    def _setup(self, n_nodes=24, n_place=3):
        rng = random.Random(SEED)
        cl, nodes = make_cluster(n_nodes, rng)
        job = mock.job()
        other = mock.job()
        seed_allocs(cl, nodes, [job, other], rng, 16)
        stack = TorchStack(cl, device="cpu")
        return cl, stack, job, n_place

    def _padded(self, stack, job, n_place):
        from nomad_tpu_torch.convert import params_from_numpy
        from nomad_tpu_torch.parallel.pad import pad_params

        params, m = stack.compile_tg(job, job.task_groups[0], n_place)
        (params,), _ = pad_params([params])
        arrays = stack.device_arrays()
        return arrays, params_from_numpy(params, arrays.used.device), m

    def test_direct_jit_bit_identical(self):
        from nomad_tpu_torch.kernels.placement import place_task_group

        cl, stack, job, n_place = self._setup()
        arrays, params, m = self._padded(stack, job, n_place)
        off = place_task_group(arrays, params, m)
        on = place_task_group(arrays, params, m, explain=True)
        assert np.array_equal(off.sel_idx.numpy(), on.sel_idx.numpy())
        # bit-identical, not allclose: same float words
        assert off.sel_score.numpy().tobytes() == \
            on.sel_score.numpy().tobytes()
        assert off.explain is None and on.explain is not None

    def test_packed_chain_bit_identical(self):
        from nomad_tpu_torch.kernels.placement import (pack_params,
                                                       place_packed_chain)
        from nomad_tpu_torch.parallel.pad import stack_params

        cl, stack, job, n_place = self._setup()
        jobs = [job, mock.job(), mock.job()]
        params = [stack.compile_tg(j, j.task_groups[0], n_place)[0]
                  for j in jobs]
        batched, m = stack_params(params)
        ibuf, fbuf, ubuf, spec = pack_params(batched)
        arrays = stack.device_arrays()
        bufs = [_on(arrays, b) for b in (ibuf, fbuf, ubuf)]
        off = place_packed_chain(arrays, *bufs, spec, m)
        on = place_packed_chain(arrays, *bufs, spec, m, explain=True)
        assert off[0].numpy().tobytes() == on[0].numpy().tobytes()
        assert off[1].numpy().tobytes() == on[1].numpy().tobytes()
        assert len(off) == 4 and len(on) > 4
        # explain leaves carry the chained program axis
        from nomad_tpu_torch.kernels.placement import PlacementExplain

        ex = PlacementExplain(*on[4:])
        assert ex.nodes_evaluated.shape[0] == len(jobs)

    def test_topk_matches_final_scores(self):
        """topk_score must be the descending top-K of the masked score
        vector the kernel already returns (final_scores0)."""
        from nomad_tpu_torch.kernels.placement import place_task_group

        cl, stack, job, n_place = self._setup()
        arrays, params, m = self._padded(stack, job, n_place)
        on = place_task_group(arrays, params, m, explain=True)
        finals = on.final_scores0.numpy()
        want = np.sort(finals)[::-1][: on.explain.topk_score.shape[1]]
        got = on.explain.topk_score.numpy()[0]
        np.testing.assert_allclose(got, want, atol=1e-6)


# ---- 2. honest: kernel vs oracle ------------------------------------------


def _oracle_ctx(cl, nodes, seeded):
    abn = {}
    for a in seeded:
        abn.setdefault(a.node_id, []).append(a)
    return OracleContext(nodes=nodes, allocs_by_node=abn)


class TestExplainOracleParity:
    """Kernel PlacementExplain vs oracle explain_select — same stage
    taxonomy, same counts (device-path AllocMetric == host oracle's)."""

    def _compare(self, ex_host, want, step=0):
        s = ex_host["steps"][step]
        assert ex_host["nodes_evaluated"] == want["nodes_evaluated"]
        assert ex_host["filtered_constraint"] == want["filtered_constraint"]
        assert ex_host["filtered_device_plugin"] == 0
        assert s["filtered_distinct_hosts"] == \
            want["filtered_distinct_hosts"]
        assert s["filtered_distinct_property"] == \
            want["filtered_distinct_property"]
        assert s["dimension_exhausted"] == want["dimension_exhausted"]
        assert s["nodes_exhausted"] == want["nodes_exhausted"]

    def _run(self, job, n_nodes=24, n_seed=16, n_place=1, mutate=None):
        rng = random.Random(SEED)
        cl, nodes = make_cluster(n_nodes, rng)
        if mutate:
            mutate(nodes, cl)
        other = mock.job()
        seeded = seed_allocs(cl, nodes, [job, other], rng, n_seed)
        stack = TorchStack(cl, device="cpu")
        tg = job.task_groups[0]
        res = stack.select(job, tg, n_place)
        assert res.explain is not None
        ctx = _oracle_ctx(cl, nodes, seeded)
        for i in range(n_place):
            want = explain_select(ctx, job, tg)
            self._compare(res.explain, want, step=i)
            # feed the kernel's choice so later steps see the same
            # evolving plan (the parity-suite idiom)
            got = res.node_ids[i]
            if got is not None:
                ctx.plan_node_alloc.setdefault(got, []).append(
                    placed_alloc(job, tg, got))
        return res

    def test_no_filtering(self):
        self._run(mock.job())

    def test_constraint_filtered(self):
        job = mock.job()
        job.constraints.append(Constraint("${attr.rack}", "r1", "="))
        self._run(job)

    def test_datacenter_filtered(self):
        job = mock.job()
        job.datacenters = ["dc2"]

        def mutate(nodes, cl):
            for n in nodes[:5]:
                n.datacenter = "dc2"
                cl.upsert_node(n)

        self._run(job, mutate=mutate)

    def test_cpu_exhaustion_multi_step(self):
        job = mock.job()
        job.task_groups[0].tasks[0].resources.cpu = 3500

        def mutate(nodes, cl):
            for n in nodes:
                n.node_resources.cpu = 4000
                cl.upsert_node(n)

        self._run(job, n_place=3, mutate=mutate)

    def test_memory_exhaustion(self):
        job = mock.job()
        job.task_groups[0].tasks[0].resources.memory_mb = 100_000
        self._run(job)

    def test_distinct_hosts_filtered(self):
        job = mock.job()
        job.constraints.append(Constraint("", "", "distinct_hosts"))
        self._run(job, n_nodes=8, n_seed=20, n_place=2)

    def test_distinct_property_filtered(self):
        job = mock.job()
        job.constraints.append(
            Constraint("${attr.rack}", "", "distinct_property"))
        self._run(job, n_nodes=12, n_seed=0, n_place=3)

    def test_reserved_port_exhaustion(self):
        cl, nodes, held, job = _reserved_port_case(PORT)
        tg = job.task_groups[0]
        res = TorchStack(cl, device="cpu").select(job, tg, 1)
        ctx = _oracle_ctx(cl, nodes, held)
        want = explain_select(ctx, job, tg)
        assert want["dimension_exhausted"] == {"reserved-ports": 3}
        self._compare(res.explain, want)

    def test_dynamic_port_exhaustion(self):
        cl, nodes, job = _dynamic_port_case(PORT)
        tg = job.task_groups[0]
        res = TorchStack(cl, device="cpu").select(job, tg, 1)
        ctx = _oracle_ctx(cl, nodes, [])
        want = explain_select(ctx, job, tg)
        assert want["dimension_exhausted"] == {"dynamic-ports": 1}
        self._compare(res.explain, want)

    def test_constraint_labels_name_the_filter(self):
        job = mock.job()
        job.constraints.append(Constraint("${attr.rack}", "r1", "="))
        res = self._run(job)
        labels = set(res.explain["constraint_filtered"])
        assert "${attr.rack} = r1" in labels
        total = sum(res.explain["constraint_filtered"].values())
        assert total >= res.explain["filtered_constraint"]


def _builders(pkg):
    """(make_cluster, the mocks, the structs) of `pkg`: the reference's
    cluster records its mutations for `tc.replay`."""
    return ((tc.make_cluster if pkg == REF else make_cluster),
            mod(pkg, "mock"), mod(pkg, "structs"))


def _reserved_port_case(pkg):
    """Three of four nodes hold port 8080; the job asks for it."""
    make, mock_, st = _builders(pkg)
    rng = random.Random(SEED)
    cl, nodes = make(4, rng)
    other = mock_.job()
    held = []
    for n in nodes[:3]:
        a = mock_.alloc(job=other)
        a.job_id = other.id
        a.node_id = n.id
        a.client_status = "running"
        a.allocated_resources = mock_.alloc_resources(
            networks=[st.NetworkResource(
                ip=n.node_resources.networks[0].ip, mbits=1,
                reserved_ports=[st.Port("http", 8080)])])
        cl.upsert_alloc(a)
        held.append(a)
    job = mock_.job()
    job.task_groups[0].tasks[0].resources.networks = [st.NetworkResource(
        mbits=1, reserved_ports=[st.Port("http", 8080)])]
    return cl, nodes, held, job


def _dynamic_port_case(pkg):
    """One of two nodes reserves the whole dynamic range."""
    make, mock_, st = _builders(pkg)
    rng = random.Random(SEED)
    cl, nodes = make(2, rng)
    nodes[0].reserved_resources.reserved_ports = "20000-32000"
    cl.upsert_node(nodes[0])
    job = mock_.job()
    job.task_groups[0].tasks[0].resources.networks = [st.NetworkResource(
        mbits=1, dynamic_ports=[st.Port("rpc", 0)])]
    return cl, nodes, job


def _parity_case(name, m, structs):
    """(job, n_nodes, n_seed, n_place, mutate) of a reference case in
    `TestExplainOracleParity`, built by the mocks `m`."""
    job = m.job()
    kw = dict(n_nodes=24, n_seed=16, n_place=1, mutate=None)
    if name == "constraint":
        job.constraints.append(structs.Constraint("${attr.rack}", "r1", "="))
    elif name == "datacenter":
        job.datacenters = ["dc2"]

        def mutate(nodes, cl):
            for n in nodes[:5]:
                n.datacenter = "dc2"
                cl.upsert_node(n)

        kw["mutate"] = mutate
    elif name == "cpu_multi_step":
        job.task_groups[0].tasks[0].resources.cpu = 3500

        def mutate(nodes, cl):
            for n in nodes:
                n.node_resources.cpu = 4000
                cl.upsert_node(n)

        kw.update(mutate=mutate, n_place=3)
    elif name == "memory":
        job.task_groups[0].tasks[0].resources.memory_mb = 100_000
    elif name == "distinct_hosts":
        job.constraints.append(structs.Constraint("", "", "distinct_hosts"))
        kw.update(n_nodes=8, n_seed=20, n_place=2)
    elif name == "distinct_property":
        job.constraints.append(
            structs.Constraint("${attr.rack}", "", "distinct_property"))
        kw.update(n_nodes=12, n_seed=0, n_place=3)
    return job, kw


def _stack(pkg, cl, **kw):
    if pkg == REF:
        return mod(REF, "scheduler.stack").TPUStack(cl, **kw)
    return TorchStack(cl, device="cpu", **kw)


def assert_same_tree(ref, got, path="explain"):
    """Equal nested dicts/lists; floats within ATOL."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and set(got) == set(ref), path
        for k in ref:
            assert_same_tree(ref[k], got[k], f"{path}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), path
        for i, (r, g) in enumerate(zip(ref, got)):
            assert_same_tree(r, g, f"{path}[{i}]")
    elif isinstance(ref, float):
        assert got == pytest.approx(ref, abs=ATOL), path
    else:
        assert got == ref, path


class TestExplainAgainstReference:
    """The same cluster and job through the reference's TPUStack and the
    port's TorchStack: the same nodes, scores within f32 rounding, and
    the same host-shaped attribution, count for count."""

    @pytest.mark.parametrize("case", [
        "no_filtering", "constraint", "datacenter", "cpu_multi_step",
        "memory", "distinct_hosts", "distinct_property",
        "reserved_ports", "dynamic_ports"])
    def test_select_and_explain_equal_reference(self, case):
        rm, rs = mod(REF, "mock"), mod(REF, "structs")
        if case == "reserved_ports":
            cl, _, _, job = _reserved_port_case(REF)
            n_place = 1
        elif case == "dynamic_ports":
            cl, _, job = _dynamic_port_case(REF)
            n_place = 1
        else:
            job, kw = _parity_case(case, rm, rs)
            rng = random.Random(SEED)
            cl, nodes = tc.make_cluster(kw["n_nodes"], rng)
            if kw["mutate"]:
                kw["mutate"](nodes, cl)
            tkp.seed_allocs(cl, nodes, [job, rm.job()], rng, kw["n_seed"])
            n_place = kw["n_place"]
        clusters = {REF: cl, PORT: tc.replay(cl)}
        out = {}
        for pkg in (REF, PORT):
            j = as_pkg(pkg, job)
            out[pkg] = _stack(pkg, clusters[pkg]).select(
                j, j.task_groups[0], n_place)
        ref, got = out[REF], out[PORT]
        assert got.node_ids == ref.node_ids
        assert got.nodes_feasible == ref.nodes_feasible
        assert list(got.nodes_fit) == list(ref.nodes_fit)
        np.testing.assert_allclose(got.scores, ref.scores, rtol=0,
                                   atol=ATOL)
        assert ref.explain is not None
        assert_same_tree(ref.explain, got.explain)


# ---- 2b. coordinator path -------------------------------------------------


class TestCoordinatorExplain:
    def test_fused_batch_carries_explain(self):
        """The batched SelectCoordinator dispatch returns per-program
        explain slices identical in shape/meaning to the direct path."""
        from nomad_tpu_torch.server.select_batch import SelectCoordinator

        rng = random.Random(SEED)
        cl, nodes = make_cluster(12, rng)
        jobs = [mock.job() for _ in range(3)]
        jobs[1].constraints.append(Constraint("${attr.rack}", "r1", "="))
        coord = SelectCoordinator()
        results = {}

        def one(i, job):
            stack = TorchStack(cl, device="cpu")
            stack.coordinator = coord
            stack.coordinator_order = i
            try:
                results[i] = stack.select(job, job.task_groups[0], 1)
            finally:
                coord.thread_done()

        threads = []
        for i, j in enumerate(jobs):
            coord.add_thread()
            threads.append(threading.Thread(target=one, args=(i, j),
                                            daemon=True))
        for t in threads:
            t.start()
        coord.run()
        for t in threads:
            t.join(30.0)
        assert coord.stats["batched"] == 3
        for i, job in enumerate(jobs):
            ex = results[i].explain
            assert ex is not None
            assert ex["nodes_evaluated"] == 12
        # the constrained program sees its own filtering, siblings none
        assert results[1].explain["filtered_constraint"] > 0
        assert results[0].explain["filtered_constraint"] == 0
        # and the batched counts agree with a solo dispatch of the same
        # program against the same snapshot
        solo = TorchStack(cl, device="cpu").select(
            jobs[1], jobs[1].task_groups[0], 1)
        assert solo.explain["filtered_constraint"] == \
            results[1].explain["filtered_constraint"]
        assert solo.explain["constraint_filtered"] == \
            results[1].explain["constraint_filtered"]

    def test_opted_out_program_gets_no_explain_in_mixed_batch(self):
        """A program that opted out must not receive attribution just
        because a batch-mate asked for it (its scheduler would record
        counters the caller explicitly disabled)."""
        from nomad_tpu_torch.server.select_batch import SelectCoordinator

        rng = random.Random(SEED)
        cl, nodes = make_cluster(8, rng)
        jobs = [mock.job(), mock.job()]
        coord = SelectCoordinator()
        results = {}

        def one(i, job, want):
            stack = TorchStack(cl, explain=want, device="cpu")
            stack.coordinator = coord
            stack.coordinator_order = i
            try:
                results[i] = stack.select(job, job.task_groups[0], 1)
            finally:
                coord.thread_done()

        threads = []
        for i, (j, want) in enumerate(zip(jobs, (True, False))):
            coord.add_thread()
            threads.append(threading.Thread(target=one, args=(i, j, want),
                                            daemon=True))
        for t in threads:
            t.start()
        coord.run()
        for t in threads:
            t.join(30.0)
        assert coord.stats["batched"] == 2
        assert results[0].explain is not None
        assert results[1].explain is None


# ---- 3. surfaced: AllocMetric end to end ----------------------------------


class TestAllocMetricPopulation:
    def _harness(self, n_nodes=8, n_allocs=4, seed=5):
        from nomad_tpu_torch.scheduler.harness import Harness
        from nomad_tpu_torch.synth import build_synthetic_state

        state, nodes = build_synthetic_state(n_nodes, n_allocs, seed=seed)
        return Harness(state=state, device="cpu"), state, nodes

    def _eval(self, job):
        from nomad_tpu_torch.structs import Evaluation

        return Evaluation(namespace=job.namespace, job_id=job.id,
                          type="service", triggered_by="job-register",
                          status="pending")

    def test_placed_alloc_carries_score_breakdown(self):
        import random as _r

        from nomad_tpu_torch.synth import synth_service_job

        h, state, nodes = self._harness()
        job = synth_service_job(_r.Random(1), count=2, with_affinity=True)
        state.upsert_job(job)
        h.process(self._eval(job))
        allocs = [a for v in h.plans[-1].node_allocation.values()
                  for a in v]
        assert allocs
        for a in allocs:
            m = a.metrics
            assert m.nodes_evaluated == 8
            assert m.score_meta, "top-K score breakdown missing"
            # descending, selected node present with normalized-score
            norms = [sm.norm_score for sm in m.score_meta]
            assert norms == sorted(norms, reverse=True)
            assert any("binpack" in sm.scores for sm in m.score_meta)

    def test_failed_placement_reports_dimension(self):
        import random as _r

        from nomad_tpu_torch.synth import synth_service_job

        h, state, nodes = self._harness()
        job = synth_service_job(_r.Random(2), count=1)
        job.task_groups[0].tasks[0].resources.cpu = 10**7
        state.upsert_job(job)
        h.process(self._eval(job))
        failed = {}
        for e in h.evals:
            failed.update(e.failed_tg_allocs or {})
        assert failed
        m = next(iter(failed.values()))
        assert m.nodes_exhausted == 8
        assert m.dimension_exhausted == {"cpu": 8}
        assert m.nodes_filtered == 0

    def test_scheduler_counters_recorded(self):
        import random as _r

        from nomad_tpu_torch.lib.metrics import default_registry
        from nomad_tpu_torch.synth import synth_service_job

        reg = default_registry()
        before = reg.counters(prefix="scheduler.exhausted.").get("cpu", 0)
        h, state, nodes = self._harness()
        job = synth_service_job(_r.Random(3), count=1)
        job.task_groups[0].tasks[0].resources.cpu = 10**7
        state.upsert_job(job)
        h.process(self._eval(job))
        after = reg.counters(prefix="scheduler.exhausted.").get("cpu", 0)
        assert after - before == 8

    def test_explain_off_keeps_legacy_counts(self, monkeypatch):
        import random as _r

        from nomad_tpu_torch.synth import synth_service_job

        monkeypatch.setenv("NOMAD_TPU_EXPLAIN", "0")
        h, state, nodes = self._harness()
        job = synth_service_job(_r.Random(4), count=1)
        job.task_groups[0].tasks[0].resources.cpu = 10**7
        state.upsert_job(job)
        h.process(self._eval(job))
        failed = {}
        for e in h.evals:
            failed.update(e.failed_tg_allocs or {})
        m = next(iter(failed.values()))
        # coarse counts survive the opt-out; attribution dicts are empty
        assert m.nodes_exhausted == 8
        assert not m.dimension_exhausted


# ---- 3b. the opt-out against the reference --------------------------------


def _failing_job(m, rng_seed=4):
    job = mod(m, "synth").synth_service_job(random.Random(rng_seed), count=1)
    job.task_groups[0].tasks[0].resources.cpu = 10**7
    return job


def _service_eval(job):
    from nomad_tpu.structs import Evaluation

    return Evaluation(namespace=job.namespace, job_id=job.id,
                      type="service", triggered_by="job-register",
                      status="pending")


class TestOptOutAgainstReference:
    """`NOMAD_TPU_EXPLAIN` read the same way by both packages, and the
    same job and cluster scheduled by the reference's Harness and the
    port's with the opt-out on and off."""

    @pytest.mark.parametrize("value,want", [
        (None, True), ("1", True), ("", True), ("on", True),
        ("0", False), ("off", False), ("false", False), (" OFF ", False),
        ("False", False)])
    def test_explain_enabled_reads_the_setting(self, monkeypatch, value,
                                               want):
        from nomad_tpu.scheduler.stack import explain_enabled as ref_enabled
        from nomad_tpu_torch.scheduler.stack import explain_enabled

        if value is None:
            monkeypatch.delenv("NOMAD_TPU_EXPLAIN", raising=False)
        else:
            monkeypatch.setenv("NOMAD_TPU_EXPLAIN", value)
        assert explain_enabled() is want
        assert explain_enabled() is ref_enabled()
        cl = ClusterTensors()
        assert TorchStack(cl, device="cpu").explain is want
        # an explicit flag still wins over the setting
        assert TorchStack(cl, explain=not want, device="cpu").explain \
            is (not want)

    @pytest.mark.parametrize("opt_out", [False, True],
                             ids=["explain_on", "opted_out"])
    def test_failed_placement_metrics_equal_reference(self, monkeypatch,
                                                      opt_out):
        if opt_out:
            monkeypatch.setenv("NOMAD_TPU_EXPLAIN", "0")
        else:
            monkeypatch.delenv("NOMAD_TPU_EXPLAIN", raising=False)
        from nomad_tpu.synth import build_synthetic_state

        state, _nodes = build_synthetic_state(8, 4, seed=5)
        tw = Twins(state)
        job = _failing_job(REF)
        tw.upsert_job(job)
        tw.process(_service_eval(job))
        tw.assert_same()
        for h in (tw.ref, tw.port):
            failed = {}
            for e in h.evals:
                failed.update(e.failed_tg_allocs or {})
            m = next(iter(failed.values()))
            assert (m.nodes_exhausted, m.nodes_filtered) == (8, 0)
            assert m.dimension_exhausted == ({} if opt_out else {"cpu": 8})
        assert [failed_view(e) for e in tw.port.evals] == \
            [failed_view(e) for e in tw.ref.evals]

    @pytest.mark.parametrize("opt_out", [False, True],
                             ids=["explain_on", "opted_out"])
    def test_placements_equal_reference(self, monkeypatch, opt_out):
        if opt_out:
            monkeypatch.setenv("NOMAD_TPU_EXPLAIN", "0")
        else:
            monkeypatch.delenv("NOMAD_TPU_EXPLAIN", raising=False)
        from nomad_tpu.synth import build_synthetic_state, synth_service_job

        state, _nodes = build_synthetic_state(8, 4, seed=5)
        tw = Twins(state)
        job = synth_service_job(random.Random(1), count=3,
                                with_affinity=True)
        tw.upsert_job(job)
        tw.process(_service_eval(job))
        tw.assert_same()
        placed = [a for p in tw.port.plans
                  for v in p.node_allocation.values() for a in v]
        assert len(placed) == 3

    def test_selection_bitwise_with_and_without_the_opt_out(self,
                                                            monkeypatch):
        """The opt-out changes what the run reports, never what it
        picks: sel_idx and sel_score bitwise, explain on against off."""
        rng = random.Random(SEED)
        cl, nodes = make_cluster(24, rng)
        job = mock.job()
        job.constraints.append(Constraint("${attr.rack}", "r1", "!="))
        seed_allocs(cl, nodes, [job, mock.job()], rng, 16)
        out = {}
        for value in ("1", "0"):
            monkeypatch.setenv("NOMAD_TPU_EXPLAIN", value)
            stack = TorchStack(cl, device="cpu")
            out[value] = stack.select(job, job.task_groups[0], 3)
        on, off = out["1"], out["0"]
        assert on.explain is not None and off.explain is None
        assert on.node_ids == off.node_ids
        assert on.raw.sel_idx.numpy().tobytes() == \
            off.raw.sel_idx.numpy().tobytes()
        assert on.raw.sel_score.numpy().tobytes() == \
            off.raw.sel_score.numpy().tobytes()

    def test_server_path_honours_the_opt_out(self, monkeypatch):
        """A server's worker (the batched path) under the opt-out: the
        blocked placement reports the coarse counts only, as the
        reference's server does, and the scheduler's exhaustion counter
        is not fed."""
        monkeypatch.setenv("NOMAD_TPU_EXPLAIN", "0")
        from torch_ops_cases import server, wait_for

        rm = mod(REF, "mock")
        nodes = [rm.node() for _ in range(3)]
        job = _failing_job(REF)

        def run(pkg):
            s = server(pkg, num_schedulers=1, heartbeat_ttl=60.0,
                       gc_interval=3600.0)
            s.start()
            try:
                for n in nodes:
                    s.node_register(as_pkg(pkg, n))
                ev = s.job_register(as_pkg(pkg, job))
                done = s.wait_for_eval(ev.id)
                assert done is not None and done.status == "complete"
                m = next(iter(done.failed_tg_allocs.values()))
                blocked = wait_for(lambda: s.state.eval_by_id(
                    done.blocked_eval))
                return ((m.nodes_evaluated, m.nodes_exhausted,
                         m.nodes_filtered, dict(m.dimension_exhausted),
                         dict(m.constraint_filtered)),
                        blocked is not None and blocked.status)
            finally:
                s.shutdown()

        ref, got = run(REF), run(PORT)
        assert got == ref
        assert got[0][1:4] == (3, 0, {}) and got[1] == "blocked"


def _wait(cond, timeout=15.0, every=0.05):
    dl = time.time() + timeout
    while time.time() < dl:
        if cond():
            return True
        time.sleep(every)
    return cond()


@pytest.fixture()
def agent(tmp_path):
    from nomad_tpu_torch.agent import Agent, AgentConfig
    from nomad_tpu_torch.api import NomadClient

    a = Agent(AgentConfig(data_dir=str(tmp_path / "data"),
                          heartbeat_ttl=60.0), device="cpu")
    a.start()
    api = NomadClient(a.http_addr[0], a.http_addr[1])
    assert _wait(lambda: len(api.nodes()) == 1)
    yield a, api
    a.shutdown()


def _mock_job(cpu=100, count=1):
    job = mock.job()
    tg = job.task_groups[0]
    tg.count = count
    t = tg.tasks[0]
    t.driver = "mock_driver"
    t.config = {"run_for": 0.05}
    t.resources.cpu = cpu
    return job


class TestBlockedEvalExhaustionE2E:
    """Satellite: a saturated cluster blocks an eval whose status
    reports the exhausted dimension end-to-end — broker → scheduler →
    blocked tracker → HTTP/SDK/CLI."""

    def test_blocked_eval_reports_dimension(self, agent):
        a, api = agent
        job = _mock_job(cpu=10**7)
        eval_id = api.register_job(job)
        ev = api.wait_for_eval(eval_id)
        assert ev.status == "complete"
        assert ev.failed_tg_allocs
        m = next(iter(ev.failed_tg_allocs.values()))
        assert m.dimension_exhausted.get("cpu") == 1
        assert ev.blocked_eval

        # blocked eval carries the attribution too (broker → blocked)
        blocked = api.evaluation(ev.blocked_eval)
        assert blocked.status == "blocked"
        bm = next(iter(blocked.failed_tg_allocs.values()))
        assert bm.dimension_exhausted.get("cpu") == 1

        # blocked tracker live diagnostics + metrics surface
        assert a.server.blocked.dimension_stats().get("cpu", 0) >= 1
        metrics = api.metrics()
        assert metrics["blocked_dimensions"].get("cpu", 0) >= 1
        # monotonic counter families with Prometheus exposition
        text = api.metrics_prometheus()
        assert "nomad_scheduler_exhausted_cpu" in text
        assert "nomad_scheduler_blocked_cpu" in text

        # /placement endpoint (SDK decode): failure attribution
        out = api.evaluation_placement(eval_id)
        fm = next(iter(out["failed_tg_allocs"].values()))
        assert fm.dimension_exhausted.get("cpu") == 1
        assert out["blocked_eval"] == ev.blocked_eval
        assert out["placements"] == []

    def test_placement_endpoint_for_successful_eval(self, agent):
        a, api = agent
        job = _mock_job(cpu=50, count=2)
        eval_id = api.register_job(job)
        ev = api.wait_for_eval(eval_id)
        assert ev.status == "complete"
        out = api.evaluation_placement(eval_id)
        assert len(out["placements"]) == 2
        for p in out["placements"]:
            m = p["metrics"]
            assert m.nodes_evaluated == 1
            assert m.score_meta
            assert m.score_meta[0].norm_score == pytest.approx(
                m.score_meta[0].scores["normalized-score"])

    def test_placement_endpoint_404(self, agent):
        from nomad_tpu_torch.api import ApiError

        a, api = agent
        with pytest.raises(ApiError):
            api.evaluation_placement("no-such-eval")


class TestCliRobustness:
    """Satellite: `eval trace`, `eval placement`, `operator timeline`
    exit 1 with a one-line error on unknown/missing ids or an
    unreachable agent — never a traceback."""

    def _run(self, addr, *argv):
        import io
        import sys as _sys

        from nomad_tpu_torch.cli import main

        out, err = io.StringIO(), io.StringIO()
        old = _sys.stdout, _sys.stderr
        _sys.stdout, _sys.stderr = out, err
        try:
            rc = main(["-address", addr, *argv])
        finally:
            _sys.stdout, _sys.stderr = old
        return rc, out.getvalue(), err.getvalue()

    def test_unknown_ids_exit_one(self, agent):
        a, api = agent
        addr = f"{a.http_addr[0]}:{a.http_addr[1]}"
        for argv in (("eval", "trace", "nope"),
                     ("eval", "placement", "nope")):
            rc, out, err = self._run(addr, *argv)
            assert rc == 1, argv
            assert err.startswith("Error:"), argv
            assert "Traceback" not in err

    def test_unreachable_agent_exits_one(self):
        # nothing listens on this port: connection errors must be a
        # one-line error, not an OSError traceback
        for argv in (("eval", "trace", "x"),
                     ("eval", "placement", "x"),
                     ("operator", "timeline"),
                     ("operator", "hbm")):
            rc, out, err = self._run("127.0.0.1:1", *argv)
            assert rc == 1, argv
            assert err.startswith("Error:"), argv

    def test_eval_placement_happy_path(self, agent):
        a, api = agent
        addr = f"{a.http_addr[0]}:{a.http_addr[1]}"
        job = _mock_job(cpu=10**7)
        eval_id = api.register_job(job)
        api.wait_for_eval(eval_id)
        rc, out, err = self._run(addr, "eval", "placement", eval_id)
        assert rc == 0, err
        assert "cpu=1" in out
        assert "Failed placements:" in out
