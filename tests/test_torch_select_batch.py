"""Twins of the reference's `tests/test_select_batch.py` (conflict-aware
eval batching), run on the port (`device="cpu"`; numpy programs go up
with `params_from_numpy` on the view's device).

Covers the three layers of the batched control plane:
- kernel: `place_task_group_chain` threads (used, dyn_free) across the
  program axis, so programs in one batch cannot over-commit a node
  (reference analog: the optimistic worker race of nomad/server.go:1419
  resolved at plan_apply.go:437 — here resolved BEFORE the plan exists).
- coordinator: concurrent selects fuse into one dispatch.
- server: a batched server places identically to a sequential one and
  meets plan-apply with zero partials when capacity suffices.

`TestAgainstReference` runs the chain and the server feeds through both
packages and compares the rows and node names chosen.
"""
import random
import threading
import time

import numpy as np
import pytest
import torch

from nomad_tpu_torch import mock
from nomad_tpu_torch.convert import params_from_numpy
from nomad_tpu_torch.kernels import placement as _kp
from nomad_tpu_torch.kernels.placement import place_task_group
from nomad_tpu_torch.parallel.mesh import stack_params
from nomad_tpu_torch.scheduler.stack import TorchStack
from nomad_tpu_torch.tensor import ClusterTensors

from torch_chain_cases import one_torch_thread  # noqa: F401
from torch_ops_cases import PORT, REF, as_pkg, dev, mod


def _mini_cluster(n_nodes=8, cpu=1000.0, mem=1024.0):
    cl = ClusterTensors()
    nodes = []
    for i in range(n_nodes):
        n = mock.node()
        n.id = f"node-{i}"
        n.node_resources.cpu = int(cpu)
        n.node_resources.memory_mb = int(mem)
        cl.upsert_node(n)
        nodes.append(n)
    return cl, nodes


def place_task_group_chain(arrays, batched, m):
    """The chain on a numpy batch, moved to the view's device."""
    return _kp.place_task_group_chain(
        arrays, params_from_numpy(batched, arrays.used.device), m)


def _compile_one(cl, job, n_place):
    stack = TorchStack(cl, device="cpu")
    params, m = stack.compile_tg(job, job.task_groups[0], n_place, None)
    return stack, params, m


class TestChainKernel:
    def test_chain_accounts_across_programs(self):
        """Two programs each placing one 600-cpu alloc on nodes with 1000
        cpu: vmap (racing workers) would stack both onto the same best
        node; the chain must move program 2 to a different node."""
        cl, _ = _mini_cluster(n_nodes=4, cpu=1000.0)
        job_a, job_b = mock.job(), mock.job()
        for j in (job_a, job_b):
            j.task_groups[0].tasks[0].resources.cpu = 600
            j.task_groups[0].tasks[0].resources.memory_mb = 64
            j.task_groups[0].networks = []
        stack, pa, _ = _compile_one(cl, job_a, 1)
        _, pb, _ = _compile_one(cl, job_b, 1)
        batched, m = stack_params([pa, pb])
        arrays = stack.device_arrays()
        res = place_task_group_chain(arrays, batched, m)
        sel = np.asarray(res.sel_idx)
        a_row, b_row = int(sel[0][0]), int(sel[1][0])
        assert a_row >= 0 and b_row >= 0
        assert a_row != b_row, "chained programs over-committed one node"

    def test_chain_matches_sequential_single_dispatches(self):
        """Chain(programs) == loop of single dispatches with used folded
        in between — the chain is exactly sequential placement, fused."""
        cl, _ = _mini_cluster(n_nodes=8)
        jobs = []
        for i in range(3):
            j = mock.job()
            j.task_groups[0].tasks[0].resources.cpu = 350 + 100 * i
            j.task_groups[0].tasks[0].resources.memory_mb = 64
            j.task_groups[0].networks = []
            jobs.append(j)
        stack = TorchStack(cl, device="cpu")
        progs = []
        for j in jobs:
            p, _ = stack.compile_tg(j, j.task_groups[0], 2, None)
            progs.append(p)
        batched, m = stack_params(progs)
        arrays = stack.device_arrays()
        chain = np.asarray(place_task_group_chain(arrays, batched, m).sel_idx)

        # sequential oracle: single dispatches, fold new_used forward
        from nomad_tpu_torch.parallel.mesh import pad_params

        padded, m2 = pad_params(progs)
        cur = arrays
        seq = []
        for p in padded:
            r = place_task_group(cur, params_from_numpy(p, "cpu"), m2)
            seq.append(np.asarray(r.sel_idx))
            placed = np.asarray(r.sel_idx)
            n = np.asarray(cur.used).shape[0]
            dyn_delta = np.zeros(n, np.float32)
            for row in placed:
                if row >= 0:
                    dyn_delta[row] += float(np.asarray(p.n_dyn))
            cur = cur._replace(used=r.new_used, dyn_free=cur.dyn_free
                               - torch.from_numpy(dyn_delta))
        for i in range(len(progs)):
            assert list(chain[i][:2]) == list(seq[i][:2]), (
                f"program {i}: chain {chain[i][:2]} != seq {seq[i][:2]}")

    def test_inert_pad_program_passes_carry_through(self):
        """Bucket padding appends n_place=0 programs; they must leave the
        (used, dyn) carry untouched so real programs after the pad (next
        dispatch reusing the compile) place exactly as unpadded."""
        from nomad_tpu_torch.server.select_batch import _inert_program

        cl, _ = _mini_cluster(n_nodes=4, cpu=1000.0)
        j = mock.job()
        j.task_groups[0].tasks[0].resources.cpu = 600
        j.task_groups[0].networks = []
        stack, p, _ = _compile_one(cl, j, 1)
        pad = _inert_program(p)
        batched, m = stack_params([p, pad, p])
        arrays = stack.device_arrays()
        res = place_task_group_chain(arrays, batched, m)
        sel = np.asarray(res.sel_idx)
        assert int(sel[1][0]) == -1, "pad program placed something"
        # program 3 (same ask) still accounts program 1's placement
        assert int(sel[0][0]) != int(sel[2][0])


class TestCoordinator:
    def test_concurrent_selects_fuse_into_one_dispatch(self):
        from nomad_tpu_torch.server.select_batch import SelectCoordinator

        cl, _ = _mini_cluster(n_nodes=8)
        jobs = []
        for i in range(4):
            j = mock.job()
            j.task_groups[0].tasks[0].resources.cpu = 400
            j.task_groups[0].tasks[0].resources.memory_mb = 64
            j.task_groups[0].networks = []
            jobs.append(j)
        coord = SelectCoordinator()
        results = {}

        def one(i, job):
            stack = TorchStack(cl, device="cpu")
            stack.coordinator = coord
            try:
                r = stack.select(job, job.task_groups[0], 1, None)
                results[i] = r.node_ids
            finally:
                coord.thread_done()

        threads = []
        for i, j in enumerate(jobs):
            coord.add_thread()
            t = threading.Thread(target=one, args=(i, j), daemon=True)
            threads.append(t)
        for t in threads:
            t.start()
        coord.run()
        for t in threads:
            t.join(5.0)
        assert len(results) == 4
        assert all(r[0] is not None for r in results.values())
        # everything fused: far fewer dispatches than programs
        assert coord.stats["programs"] == 4
        assert coord.stats["dispatches"] <= 2

    def test_error_propagates_to_waiter(self):
        from nomad_tpu_torch.server.select_batch import SelectCoordinator

        coord = SelectCoordinator()
        coord.add_thread()
        err = {}

        def one():
            try:
                coord.select(object(), "not-params", 1)
            except Exception as e:  # noqa: BLE001
                err["e"] = e
            finally:
                coord.thread_done()

        t = threading.Thread(target=one, daemon=True)
        t.start()
        coord.run()
        t.join(5.0)
        assert "e" in err


class TestServerBatchedPath:
    def _run_server(self, eval_batch, n_jobs=12, seed=7):
        from nomad_tpu_torch.server import Server, ServerConfig
        from nomad_tpu_torch.synth import synth_node, synth_service_job

        rng = random.Random(seed)
        s = Server(ServerConfig(num_schedulers=1, heartbeat_ttl=3600.0,
                                eval_batch=eval_batch), device="cpu")
        for i in range(32):
            s.state.upsert_node(synth_node(rng, i))
        jobs = [synth_service_job(rng, count=2) for _ in range(n_jobs)]
        # register BEFORE starting workers so the first drain sees a
        # deep queue and the batch path engages
        evs = [s.job_register(j) for j in jobs]
        s.start()
        try:
            for ev in evs:
                got = s.wait_for_eval(
                    ev.id, statuses=("complete", "failed", "blocked",
                                     "cancelled"), timeout=60.0)
                assert got is not None and got.status == "complete", got
            node_names = {n.id: n.name
                          for n in s.state.nodes_iter()} \
                if hasattr(s.state, "nodes_iter") else {}
            if not node_names:
                node_names = {nid: nd.name
                              for nid, nd in s.state._nodes.items()}
            placements = {}
            for ji, j in enumerate(jobs):
                for a in s.state.allocs_by_job("default", j.id):
                    # key by (job index, alloc index) and compare node
                    # NAMES: job/alloc ids are uuid-fresh per run, node
                    # names are deterministic from the seeded synth
                    placements[(ji, a.name.rsplit("[", 1)[1])] = \
                        node_names.get(a.node_id, a.node_id)
            stats = dict(s.planner.stats)
            wstats = dict(s.workers[0].batch_stats) if s.workers else {}
        finally:
            s.shutdown()
        return placements, stats, wstats

    def test_batched_equals_sequential_placements(self):
        seq, seq_stats, _ = self._run_server(eval_batch=1)
        bat, bat_stats, wstats = self._run_server(eval_batch=8)
        assert seq and set(seq) == set(bat)
        diffs = {k for k in seq if seq[k] != bat[k]}
        assert not diffs, f"{len(diffs)} placements differ: {sorted(diffs)[:5]}"
        # batch path actually engaged and fused programs
        assert wstats.get("batched", 0) > 0, wstats
        # ...with no optimistic-concurrency cost (roomy cluster)
        assert bat_stats.get("partial", 0) == 0

    def test_contended_batch_no_overcommit(self):
        """Jobs that collectively exceed one node's capacity must spread
        without partial plans: the chain resolves contention pre-plan."""
        from nomad_tpu_torch.server import Server, ServerConfig
        from nomad_tpu_torch.structs import Node

        s = Server(ServerConfig(num_schedulers=1, heartbeat_ttl=3600.0,
                                eval_batch=8), device="cpu")
        for i in range(6):
            n = mock.node()
            n.id = f"n-{i}"
            n.node_resources.cpu = 1000
            n.node_resources.memory_mb = 1024
            s.state.upsert_node(n)
        jobs = []
        for i in range(6):
            j = mock.job()
            j.id = f"contend-{i}"
            j.task_groups[0].count = 1
            j.task_groups[0].tasks[0].resources.cpu = 700
            j.task_groups[0].tasks[0].resources.memory_mb = 128
            j.task_groups[0].networks = []
            jobs.append(j)
        evs = [s.job_register(j) for j in jobs]
        s.start()
        try:
            for ev in evs:
                got = s.wait_for_eval(
                    ev.id, statuses=("complete", "failed", "blocked",
                                     "cancelled"), timeout=60.0)
                assert got is not None and got.status == "complete", got
            used_nodes = []
            for j in jobs:
                for a in s.state.allocs_by_job("default", j.id):
                    used_nodes.append(a.node_id)
            # 700-cpu allocs on 1000-cpu nodes: one per node, all placed
            assert len(used_nodes) == 6
            assert len(set(used_nodes)) == 6, used_nodes
            assert s.planner.stats.get("partial", 0) == 0
        finally:
            s.shutdown()

    def test_poisoned_eval_does_not_sink_its_batch(self, monkeypatch):
        """One scheduler crashing mid-batch must not stall the
        rendezvous: its thread dies before parking at the coordinator
        (live-count drops), the rest dispatch and complete, and the
        poisoned eval is nacked for redelivery (worker.go:105's
        per-eval error isolation, here across a fused batch)."""
        import nomad_tpu_torch.server.worker as worker_mod
        from nomad_tpu_torch.server import Server, ServerConfig
        from nomad_tpu_torch.synth import synth_node, synth_service_job

        real = worker_mod.GenericScheduler
        poison_jobs = set()

        class Exploding(real):
            def process(self, eval):
                if eval.job_id in poison_jobs:
                    raise RuntimeError("poisoned eval (test)")
                return real.process(self, eval)

        monkeypatch.setattr(worker_mod, "GenericScheduler", Exploding)
        # the env knob outranks ServerConfig.eval_batch — without this a
        # stray NOMAD_TPU_EVAL_BATCH=1 would green-light the test on the
        # single-eval path without ever touching the rendezvous
        monkeypatch.delenv("NOMAD_TPU_EVAL_BATCH", raising=False)
        # pin the drain hold window: the adaptive window (capped at
        # 50ms) can close before the restore loop finishes enqueuing on
        # a loaded machine, draining the 8 evals as singles — then the
        # batched>0 assertion below tests a rendezvous that never formed
        monkeypatch.setenv("NOMAD_TPU_DRAIN_WINDOW_MS", "300")
        rng = random.Random(11)
        s = Server(ServerConfig(num_schedulers=1, heartbeat_ttl=3600.0,
                                eval_batch=8), device="cpu")
        for i in range(16):
            s.state.upsert_node(synth_node(rng, i))
        jobs = [synth_service_job(rng, count=2) for _ in range(8)]
        poison_jobs.add(jobs[3].id)
        evs = [s.job_register(j) for j in jobs]
        s.start()
        try:
            for i, ev in enumerate(evs):
                if i == 3:
                    continue
                got = s.wait_for_eval(
                    ev.id, statuses=("complete", "failed", "blocked",
                                     "cancelled"), timeout=60.0)
                assert got is not None and got.status == "complete", \
                    (i, got)
            # every healthy job fully placed
            for i, j in enumerate(jobs):
                want = 0 if i == 3 else 2
                assert len(s.state.allocs_by_job("default", j.id)) == want
            # the poisoned eval was redelivered (nack -> dequeue again),
            # never completed
            deadline = time.time() + 30.0
            while time.time() < deadline:
                if s.broker._dequeues.get(evs[3].id, 0) >= 2:
                    break
                time.sleep(0.05)
            assert s.broker._dequeues.get(evs[3].id, 0) >= 2
            got = s.state.eval_by_id(evs[3].id)
            assert got is None or got.status != "complete"
            # the batch path actually engaged (fused programs ran).
            # Polled: evals flip to complete inside sched.process,
            # BEFORE finish_batch collects the futures and writes the
            # worker.*.batch.* counters — an immediate read here races
            # that write by a few milliseconds on a loaded machine
            deadline = time.time() + 10.0
            while time.time() < deadline:
                if s.workers[0].batch_stats.get("batched", 0) > 0:
                    break
                time.sleep(0.05)
            assert s.workers[0].batch_stats.get("batched", 0) > 0
        finally:
            s.shutdown()


# ---- the same programs and feeds through the reference and the port -------


def _chain_rows(pkg):
    """The chain's rows for three programs on an 8-node cluster of `pkg`
    (the reference's mocks, wired to the port)."""
    rm = mod(REF, "mock")
    cl = mod(pkg, "tensor").ClusterTensors()
    for i in range(8):
        n = rm.node()
        n.id = f"node-{i}"
        n.node_resources.cpu = 1000
        n.node_resources.memory_mb = 1024
        cl.upsert_node(as_pkg(pkg, n))
    st = mod(pkg, "scheduler.stack")
    stack = (st.TPUStack(cl) if pkg == REF
             else st.TorchStack(cl, device="cpu"))
    progs = []
    for i in range(3):
        j = rm.job()
        j.task_groups[0].tasks[0].resources.cpu = 350 + 100 * i
        j.task_groups[0].tasks[0].resources.memory_mb = 64
        j.task_groups[0].networks = []
        j = as_pkg(pkg, j)
        progs.append(stack.compile_tg(j, j.task_groups[0], 2, None)[0])
    batched, m = mod(pkg, "parallel.mesh").stack_params(progs)
    arrays = stack.device_arrays()
    if pkg == PORT:
        batched = params_from_numpy(batched, "cpu")
    res = mod(pkg, "kernels.placement").place_task_group_chain(
        arrays, batched, m)
    return np.asarray(res.sel_idx), np.asarray(res.sel_score)


def _server_feed(pkg, eval_batch, n_jobs=16, seed=7):
    """`TestServerBatchedPath._run_server` on `pkg`: placements by (job
    position, alloc index) as node names. 16 jobs, so that a batch of 8
    drains them as two full batches: one chain shape for the reference
    to compile, not two."""
    srv = mod(pkg, "server")
    synth = mod(pkg, "synth")
    rng = random.Random(seed)
    s = srv.Server(srv.ServerConfig(num_schedulers=1, heartbeat_ttl=3600.0,
                                    eval_batch=eval_batch), **dev(pkg))
    for i in range(32):
        s.state.upsert_node(synth.synth_node(rng, i))
    jobs = [synth.synth_service_job(rng, count=2) for _ in range(n_jobs)]
    evs = [s.job_register(j) for j in jobs]
    s.start()
    try:
        for ev in evs:
            got = s.wait_for_eval(ev.id, statuses=(
                "complete", "failed", "blocked", "cancelled"), timeout=60.0)
            assert got is not None and got.status == "complete", got
        names = {nid: nd.name for nid, nd in s.state._nodes.items()}
        return {(ji, a.name.rsplit("[", 1)[1]): names[a.node_id]
                for ji, j in enumerate(jobs)
                for a in s.state.allocs_by_job("default", j.id)}
    finally:
        s.shutdown()


class TestAgainstReference:
    def test_chain_equals_reference(self):
        (ref_sel, ref_score), (sel, score) = (_chain_rows(pkg)
                                              for pkg in (REF, PORT))
        np.testing.assert_array_equal(sel, ref_sel)
        np.testing.assert_allclose(score, ref_score, rtol=0, atol=1e-6)
        assert (sel[:, :2] >= 0).all()

    @pytest.mark.parametrize("eval_batch", [1, 8])
    def test_server_feed_equals_reference(self, eval_batch):
        ref, got = (_server_feed(pkg, eval_batch) for pkg in (REF, PORT))
        assert got == ref and len(got) == 32
