"""Twins of the reference's `tests/test_drain.py` (conflict-aware
drain-cadence mega-batching), run on the port (`device="cpu"`).

Covers the four layers of the mega-batch path:
- broker: `dequeue_batch` footprint partition, the fairness slots,
  per-job serialization across a batch, and the hold window;
- worker: the adaptive hold window sized from measured per-dispatch
  overhead (env override, cap, zero-until-measured);
- kernel: `place_table_wave` bitwise the sequential chain on disjoint
  lanes (outputs AND folded carry), cross-lane collision detection, and
  batch-pack row parity (the table's dynamic rows go up as tensors on
  the view's device);
- server: the 2000-node parity gate (eval_batch=1 against a mega-batch
  wave path) and the loaded-window acceptance counters with speculation
  on. The port has no transfer guard (`lib/transfer.py`), so the
  window's guard setting forbids nothing there. The reference's
  speculation-off window (`test_loaded_window_width_gate_no_spec`) has
  no twin: under a loaded host both packages re-upload hot rows in it
  (`stack.hot_delta` > 0), so it cannot be held steady here.

`TestAgainstReference` feeds the same evals and footprints to both
brokers, the same programs to both packages' wave kernels, and the same
2000-node feed to both servers, and compares the groups, outputs and
placements.
"""
import random
import threading
import time
import uuid

import numpy as np
import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.server.broker import EvalBroker
from nomad_tpu_torch.structs import Evaluation

from torch_chain_cases import one_torch_thread  # noqa: F401
import torch_cases as tc
from torch_ops_cases import PORT, REF, as_pkg, dev, mod
from torch_sched_cases import ATOL


def _ev(prio=50, job=None, typ="service"):
    return Evaluation(priority=prio, type=typ,
                      job_id=job or f"job-{uuid.uuid4().hex[:8]}")


def _mask(n, *rows):
    a = np.zeros(n, dtype=bool)
    for r in rows:
        a[r] = True
    return a


def _broker(fps=None, **kw):
    """Broker whose footprint estimate is a plain dict keyed by job id
    (absent → None → conflicts with everything)."""
    fn = None if fps is None else (lambda ev: fps.get(ev.job_id))
    kw.setdefault("nack_timeout", 0)
    b = EvalBroker(footprint_fn=fn, **kw)
    b.set_enabled(True)
    return b


def _ids(groups):
    return [[ev.job_id for ev, _tok in g] for g in groups]


class TestDequeueBatchPartition:
    def test_disjoint_footprints_split_overlapping_merge(self):
        fps = {"a": _mask(8, 0, 1), "b": _mask(8, 1, 2),
               "c": _mask(8, 5), "d": _mask(8, 6)}
        b = _broker(fps)
        for job, prio in (("a", 90), ("b", 80), ("c", 70), ("d", 60)):
            b.enqueue(_ev(prio=prio, job=job))
        groups = b.dequeue_batch(("service",), max_n=8, timeout=2.0)
        # a∩b on row 1 → one group; c and d each disjoint
        assert _ids(groups) == [["a", "b"], ["c"], ["d"]]

    def test_transitive_overlap_merges_through_chain(self):
        # a∩b, b∩c, a∦c: all three must still share one group (c would
        # otherwise be unordered w.r.t. b, which it conflicts with)
        fps = {"a": _mask(8, 0), "b": _mask(8, 0, 1), "c": _mask(8, 1)}
        b = _broker(fps)
        for job, prio in (("a", 90), ("b", 80), ("c", 70)):
            b.enqueue(_ev(prio=prio, job=job))
        groups = b.dequeue_batch(("service",), max_n=8, timeout=2.0)
        assert _ids(groups) == [["a", "b", "c"]]

    def test_unknown_footprint_conflicts_with_everything(self):
        fps = {"a": _mask(8, 0), "c": _mask(8, 5)}  # "x" unknown
        b = _broker(fps)
        for job, prio in (("a", 90), ("x", 80), ("c", 70)):
            b.enqueue(_ev(prio=prio, job=job))
        groups = b.dequeue_batch(("service",), max_n=8, timeout=2.0)
        assert _ids(groups) == [["a", "x", "c"]]

    def test_flatten_preserves_priority_order(self):
        fps = {f"j{i}": _mask(16, i) for i in range(6)}  # all disjoint
        b = _broker(fps)
        prios = [30, 90, 50, 70, 10, 60]
        for i, p in enumerate(prios):
            b.enqueue(_ev(prio=p, job=f"j{i}"))
        groups = b.dequeue_batch(("service",), max_n=8, timeout=2.0)
        flat = [ev.job_id for g in groups for ev, _ in g]
        want = [f"j{i}" for i in
                sorted(range(6), key=lambda i: -prios[i])]
        assert flat == want

    def test_per_job_serialization_across_batch(self):
        b = _broker({})
        e1, e2 = _ev(job="same"), _ev(job="same")
        b.enqueue(e1)
        b.enqueue(e2)
        groups = b.dequeue_batch(("service",), max_n=8, timeout=2.0)
        flat = [ev for g in groups for ev, _ in g]
        assert len(flat) == 1, "two evals of one job rode one batch"
        (ev, tok) = groups[0][0]
        b.ack(ev.id, tok)
        groups = b.dequeue_batch(("service",), max_n=8, timeout=2.0)
        assert [ev.id for g in groups for ev, _ in g] == \
            [e2.id if ev.id == e1.id else e1.id]

    def test_footprint_estimator_error_degrades_to_one_group(self):
        def boom(ev):
            raise RuntimeError("estimator broke")

        b = EvalBroker(nack_timeout=0, footprint_fn=boom)
        b.set_enabled(True)
        b.enqueue(_ev(job="a"))
        b.enqueue(_ev(job="b"))
        groups = b.dequeue_batch(("service",), max_n=8, timeout=2.0)
        assert len(groups) == 1 and len(groups[0]) == 2


class TestDequeueBatchFairness:
    def test_failed_queue_head_rides_every_batch(self):
        """Under a continuous healthy feed, a delivery-limited eval
        still progresses — one reserved slot per batch (rule 1 of the
        dequeue_batch eligibility contract)."""
        b = _broker({}, delivery_limit=2)
        poisoned = _ev(prio=10, job="poisoned")
        b.enqueue(poisoned)
        for _ in range(2):  # exhaust the delivery limit
            ev, tok = b.dequeue(("service",), timeout=2.0)
            assert ev.id == poisoned.id
            b.nack(ev.id, tok)
        # a deep high-priority feed that would fill every batch
        for i in range(16):
            b.enqueue(_ev(prio=90, job=f"hot-{i}"))
        groups = b.dequeue_batch(("service",), max_n=4, timeout=2.0)
        flat = [ev.id for g in groups for ev, _ in g]
        assert poisoned.id in flat, \
            "failed-queue eval starved by the high-priority feed"

    def test_oldest_ready_eval_never_starves(self):
        """Rule 2: the FIFO-aging slot — the globally oldest ready eval
        rides the next batch regardless of priority."""
        b = _broker({})
        old = _ev(prio=1, job="old-low")
        b.enqueue(old)
        for i in range(20):
            b.enqueue(_ev(prio=90, job=f"hot-{i}"))
        groups = b.dequeue_batch(("service",), max_n=4, timeout=2.0)
        flat = [ev.id for g in groups for ev, _ in g]
        assert old.id in flat, \
            "low-priority eval starved by the high-priority feed"
        # and the batch is still priority-led
        assert groups[0][0][0].priority == 90

    def test_fairness_slots_respect_type_filter_and_max_n(self):
        """The reserved slots live WITHIN max_n and never admit a
        non-batchable type: a failed-queue system eval must not ride a
        fused batch (it would demote the whole mega-batch to
        one-by-one processing), and max_n=2 must never yield 3."""
        b = _broker({}, delivery_limit=1)
        sysev = _ev(prio=10, job="sys-job", typ="system")
        b.enqueue(sysev)
        ev, tok = b.dequeue(("system",), timeout=2.0)
        b.nack(ev.id, tok)  # delivery limit hit → failed queue
        for i in range(4):
            b.enqueue(_ev(prio=90, job=f"hot-{i}"))
        groups = b.dequeue_batch(("service",), max_n=2, timeout=2.0,
                                 batch_types=("service", "batch"))
        flat = [ev for g in groups for ev, _ in g]
        assert len(flat) == 2, "fairness slots exceeded max_n"
        assert all(e.type in ("service", "batch") for e in flat), \
            "a non-batchable failed-queue eval rode the mega-batch"
        # the system eval is still served by an unrestricted dequeue
        ev2, tok2 = b.dequeue(("system",), timeout=2.0)
        assert ev2.id == sysev.id
        b.ack(ev2.id, tok2)


class TestDrainHoldWindow:
    def test_loaded_queue_merges_arrivals_within_window(self):
        b = _broker({})
        b.enqueue(_ev(job="a"))
        b.enqueue(_ev(job="b"))  # ≥2 ready = loaded → hold engages

        def late():
            time.sleep(0.05)
            for i in range(6):
                b.enqueue(_ev(job=f"late-{i}"))

        t = threading.Thread(target=late, daemon=True)
        t.start()
        groups = b.dequeue_batch(("service",), max_n=16, timeout=2.0,
                                 hold_s=1.0)
        t.join(2.0)
        flat = [ev for g in groups for ev, _ in g]
        assert len(flat) == 8, \
            f"hold window did not merge arrivals: {len(flat)}"

    def test_idle_queue_keeps_single_eval_latency(self):
        b = _broker({})
        b.enqueue(_ev(job="solo"))
        t0 = time.time()
        groups = b.dequeue_batch(("service",), max_n=16, timeout=2.0,
                                 hold_s=2.0)
        took = time.time() - t0
        assert sum(len(g) for g in groups) == 1
        assert took < 1.0, f"idle drain held for {took:.2f}s"

    def test_full_batch_returns_without_holding(self):
        b = _broker({})
        for i in range(4):
            b.enqueue(_ev(job=f"j{i}"))
        t0 = time.time()
        groups = b.dequeue_batch(("service",), max_n=4, timeout=2.0,
                                 hold_s=5.0)
        took = time.time() - t0
        assert sum(len(g) for g in groups) == 4
        assert took < 1.0, f"full batch held for {took:.2f}s"

    def test_drain_metrics_recorded(self):
        b = _broker({f"j{i}": _mask(8, i) for i in range(3)})
        for i in range(3):
            b.enqueue(_ev(job=f"j{i}"))
        b.dequeue_batch(("service",), max_n=8, timeout=2.0)
        snap = b.metrics.snapshot()
        assert snap["counters"].get("drain.drains") == 1
        assert snap["histograms"]["drain.batch_width"]["mean"] == 3.0
        assert snap["histograms"]["drain.groups"]["mean"] == 3.0


class TestWorkerHoldWindow:
    def _server(self, monkeypatch, **env):
        monkeypatch.delenv("NOMAD_TPU_DRAIN_WINDOW_MS", raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        from nomad_tpu_torch.server import Server, ServerConfig

        return Server(ServerConfig(num_schedulers=1,
                                   heartbeat_ttl=3600.0), device="cpu")

    def test_adaptive_window_tracks_measured_overhead(self, monkeypatch):
        s = self._server(monkeypatch)
        w = s.workers[0]
        assert w._hold_window() == 0.0  # unmeasured path never holds
        for _ in range(8):
            s.metrics.add_sample("pipeline.host_ms", 10.0)
        w._window_next = 0.0  # force refresh past the throttle
        assert w._hold_window() == pytest.approx(0.010)

    def test_adaptive_window_capped(self, monkeypatch):
        from nomad_tpu_torch.server.worker import DRAIN_WINDOW_CAP_MS

        s = self._server(monkeypatch)
        w = s.workers[0]
        for _ in range(8):
            s.metrics.add_sample("pipeline.host_ms", 5000.0)
        w._window_next = 0.0
        assert w._hold_window() == pytest.approx(
            DRAIN_WINDOW_CAP_MS / 1e3)

    def test_env_override_pins_window(self, monkeypatch):
        s = self._server(monkeypatch, NOMAD_TPU_DRAIN_WINDOW_MS="7.5")
        assert s.workers[0]._hold_window() == pytest.approx(0.0075)
        s2 = self._server(monkeypatch, NOMAD_TPU_DRAIN_WINDOW_MS="0")
        assert s2.workers[0]._hold_window() == 0.0


# ---- kernel: wave lanes vs sequential chain --------------------------------


def _dc_cluster(n_nodes=8, n_dcs=2, cpu=1000.0, mem=1024.0):
    from nomad_tpu_torch.tensor import ClusterTensors

    cl = ClusterTensors()
    for i in range(n_nodes):
        n = mock.node()
        n.id = f"node-{i}"
        n.datacenter = f"dc{1 + i % n_dcs}"
        n.node_resources.cpu = int(cpu)
        n.node_resources.memory_mb = int(mem)
        cl.upsert_node(n)
    return cl


def _pinned_params(cl, dc, n_place=2, cpu=600):
    from nomad_tpu_torch.scheduler.stack import TorchStack

    j = mock.job()
    j.datacenters = [dc]
    j.task_groups[0].tasks[0].resources.cpu = cpu
    j.task_groups[0].tasks[0].resources.memory_mb = 64
    j.task_groups[0].networks = []
    stack = TorchStack(cl, device="cpu")
    p, m = stack.compile_tg(j, j.task_groups[0], n_place, None)
    return stack, p, m


def _table_prep(cl, params_list):
    from nomad_tpu_torch.lib.transfer import default_ledger
    from nomad_tpu_torch.server.program_table import DeviceProgramTable

    import types

    import torch

    table = DeviceProgramTable(device="cpu")
    prep = table.prepare(params_list)
    assert prep is not None
    com = table.commit(prep, default_ledger())
    assert com is not None
    # the dynamic rows go up to the table's device; `rows` stays host
    fields = dict(vars(prep)) if hasattr(prep, "__dict__") else {
        k: getattr(prep, k) for k in prep.__slots__}
    for k in ("dyn_i", "dyn_f", "dyn_u"):
        fields[k] = torch.as_tensor(np.asarray(fields[k]),
                                    device=table.device)
    return types.SimpleNamespace(**fields), com[:3]


class TestWaveKernel:
    def test_wave_bit_identical_to_chain_on_disjoint_lanes(self):
        """Two dc-pinned programs with disjoint footprints: the wave
        (one program per lane) must reproduce the sequential chain's
        outputs AND carry bit-for-bit — the wave's parity contract."""
        from nomad_tpu_torch.kernels.placement import (place_table_chain,
                                                 place_table_wave)

        cl = _dc_cluster(n_nodes=8, n_dcs=2)
        stack, p1, m = _pinned_params(cl, "dc1")
        _, p2, _ = _pinned_params(cl, "dc2")
        prep, (ti, tf, tu) = _table_prep(cl, [p1, p2])
        arrays = stack.device_arrays()
        chain, chain_carry = place_table_chain(
            arrays, ti, tf, tu, prep.rows, prep.dyn_i, prep.dyn_f,
            prep.dyn_u, prep.sspec, prep.dspec, prep.m)
        rows2 = prep.rows.reshape(2, 1)
        wave, wave_carry = place_table_wave(
            arrays, ti, tf, tu, rows2,
            prep.dyn_i.reshape(2, 1, -1), prep.dyn_f.reshape(2, 1, -1),
            prep.dyn_u.reshape(2, 1, -1), prep.sspec, prep.dspec,
            prep.m)
        assert int(wave[-1]) == 0, "disjoint lanes reported a collision"
        for ci, wi in zip(chain, wave[:-1]):
            assert np.asarray(ci).tobytes() == np.asarray(wi).tobytes()
        # every placement actually landed (the parity is non-vacuous)
        assert (np.asarray(chain[0]) >= 0).all()
        for cc, wc in zip(chain_carry, wave_carry):
            assert np.asarray(cc).tobytes() == np.asarray(wc).tobytes()

    def test_wave_parity_with_explain_and_uneven_lanes(self):
        """3 programs over 2 lanes (one lane longer, inert-padded via
        the coordinator idiom) with explain on: flat outputs at the
        lane-major indices match the chain's program order."""
        from nomad_tpu_torch.kernels.placement import (PlacementExplain,
                                                 place_table_chain,
                                                 place_table_wave)
        from nomad_tpu_torch.server.select_batch import _inert_program

        cl = _dc_cluster(n_nodes=8, n_dcs=2)
        stack, p1, _ = _pinned_params(cl, "dc1", cpu=600)
        _, p1b, _ = _pinned_params(cl, "dc1", cpu=300)
        _, p2, _ = _pinned_params(cl, "dc2")
        pad = _inert_program(p1)
        # chain order: p1, p1b, p2 ; wave lanes: [p1, p1b], [p2, pad]
        prep_c, (ti, tf, tu) = _table_prep(cl, [p1, p1b, p2, pad])
        arrays = stack.device_arrays()
        chain, chain_carry = place_table_chain(
            arrays, ti, tf, tu, prep_c.rows[:3], prep_c.dyn_i[:3],
            prep_c.dyn_f[:3], prep_c.dyn_u[:3], prep_c.sspec,
            prep_c.dspec, prep_c.m, explain=True)
        order = [0, 1, 2, 3]  # lane-major: p1, p1b | p2, pad
        rows2 = prep_c.rows[order].reshape(2, 2)
        wave, wave_carry = place_table_wave(
            arrays, ti, tf, tu, rows2,
            prep_c.dyn_i[order].reshape(2, 2, -1),
            prep_c.dyn_f[order].reshape(2, 2, -1),
            prep_c.dyn_u[order].reshape(2, 2, -1),
            prep_c.sspec, prep_c.dspec, prep_c.m, explain=True)
        assert int(wave[-1]) == 0
        nf = len(PlacementExplain._fields)
        assert len(wave) == 4 + nf + 1
        # flat wave index of chain program i: p1→0, p1b→1, p2→2
        for leaf_c, leaf_w in zip(chain, wave[:-1]):
            lc, lw = np.asarray(leaf_c), np.asarray(leaf_w)
            for prog in range(3):
                assert lc[prog].tobytes() == lw[prog].tobytes(), \
                    f"program {prog} diverged"
        for cc, wc in zip(chain_carry, wave_carry):
            assert np.asarray(cc).tobytes() == np.asarray(wc).tobytes()

    def test_cross_lane_collision_detected(self):
        """Two OVERLAPPING programs misplaced into separate lanes (a
        stale footprint) must be counted so the host rejects the folded
        carry; both pick the same argmax node on an empty cluster."""
        from nomad_tpu_torch.kernels.placement import place_table_wave

        cl = _dc_cluster(n_nodes=4, n_dcs=1)
        stack, p1, _ = _pinned_params(cl, "dc1", n_place=1)
        _, p2, _ = _pinned_params(cl, "dc1", n_place=1)
        prep, (ti, tf, tu) = _table_prep(cl, [p1, p2])
        arrays = stack.device_arrays()
        wave, _carry = place_table_wave(
            arrays, ti, tf, tu, prep.rows.reshape(2, 1),
            prep.dyn_i.reshape(2, 1, -1), prep.dyn_f.reshape(2, 1, -1),
            prep.dyn_u.reshape(2, 1, -1), prep.sspec, prep.dspec,
            prep.m)
        sel = np.asarray(wave[0])
        assert int(sel[0][0]) == int(sel[1][0]) >= 0  # the actual race
        assert int(wave[-1]) >= 1, "cross-lane collision not counted"

    def test_batch_pack_rows_bit_identical_to_solo(self):
        """pack_param_rows_batch row i == pack_param_rows(program i) —
        the whole-batch pack must never change the table row format."""
        from nomad_tpu_torch.kernels.placement import (DYN_FIELDS,
                                                 STATIC_FIELDS,
                                                 pack_param_rows,
                                                 pack_param_rows_batch)
        from nomad_tpu_torch.parallel.mesh import pad_params

        cl = _dc_cluster(n_nodes=6, n_dcs=3)
        params = [_pinned_params(cl, f"dc{1 + i % 3}", n_place=1 + i % 2,
                                 cpu=100 * (1 + i))[1] for i in range(4)]
        padded, _m = pad_params(params)
        for fields in (STATIC_FIELDS, DYN_FIELDS):
            bi, bf, bu, bspec = pack_param_rows_batch(padded, fields)
            for i, p in enumerate(padded):
                si, sf, su, spec = pack_param_rows(p, fields)
                assert spec == bspec
                assert si.tobytes() == bi[i].tobytes()
                assert sf.tobytes() == bf[i].tobytes()
                assert su.tobytes() == bu[i].tobytes()


# ---- server: parity gate + loaded-window acceptance counters ---------------


def _pinned_job(rng, dc, count=2, cpu=None):
    from nomad_tpu_torch.synth import synth_service_job

    j = synth_service_job(rng, count=count, datacenter=dc)
    if cpu is not None:
        j.task_groups[0].tasks[0].resources.cpu = cpu
        j.task_groups[0].tasks[0].resources.memory_mb = 128
    return j


def _run_feed(n_nodes, jobs_fn, eval_batch, monkeypatch, seed=17):
    """One server run over a deterministic feed; returns placements
    {(job idx, alloc name suffix): (node NAME, norm score)} + planner
    stats. Node names are deterministic from the seeded synth; job ids
    are uuid-fresh, so keys use feed position."""
    from nomad_tpu_torch.server import Server, ServerConfig
    from nomad_tpu_torch.synth import synth_node

    monkeypatch.delenv("NOMAD_TPU_EVAL_BATCH", raising=False)
    rng = random.Random(seed)
    s = Server(ServerConfig(num_schedulers=1, heartbeat_ttl=3600.0,
                            eval_batch=eval_batch), device="cpu")
    for i in range(n_nodes):
        s.state.upsert_node(synth_node(rng, i))
    jobs = jobs_fn(rng)
    evs = [s.job_register(j) for j in jobs]
    s.start()
    try:
        for ev in evs:
            got = s.wait_for_eval(
                ev.id, statuses=("complete", "failed", "blocked",
                                 "cancelled"), timeout=300.0)
            assert got is not None and got.status == "complete", got
        node_names = {nid: nd.name for nid, nd in s.state._nodes.items()}
        placements = {}
        for ji, j in enumerate(jobs):
            for a in s.state.allocs_by_job("default", j.id):
                score = None
                for sm in a.metrics.score_meta:
                    if sm.node_id == a.node_id:
                        score = round(float(sm.norm_score), 6)
                placements[(ji, a.name.rsplit("[", 1)[1])] = (
                    node_names.get(a.node_id, a.node_id), score)
        stats = dict(s.planner.stats)
        wave = int(s.metrics.counters().get("wave.dispatches", 0))
    finally:
        s.shutdown()
    return placements, stats, wave


class TestWaveServerParity:
    def test_mega_batch_wave_parity_2000_nodes(self, monkeypatch):
        """The parity gate: one fixed 2000-node synthetic feed
        scheduled twice — eval_batch=1 (pure sequential, no coordinator)
        vs a mega-batch whose drain partitions the dc-pinned jobs into
        parallel wave lanes. Placements (node ids AND scores) must be
        identical, and the optimistic-concurrency counters flat."""

        def feed(rng):
            return [_pinned_job(rng, f"dc{1 + i % 3}", count=2)
                    for i in range(9)]

        seq, seq_stats, seq_wave = _run_feed(2000, feed, 1, monkeypatch)
        bat, bat_stats, bat_wave = _run_feed(2000, feed, 64, monkeypatch)
        assert seq_wave == 0 and bat_wave >= 1, \
            (seq_wave, bat_wave, "mega run never dispatched a wave")
        assert seq and set(seq) == set(bat)
        diffs = {k: (seq[k], bat[k]) for k in seq if seq[k] != bat[k]}
        assert not diffs, \
            f"{len(diffs)} placements differ: {sorted(diffs.items())[:4]}"
        # plan-conflict rate flat vs the sequential baseline
        assert bat_stats.get("partial", 0) == seq_stats.get("partial", 0)
        assert bat_stats.get("rejected_nodes", 0) == \
            seq_stats.get("rejected_nodes", 0)


class TestLoadedWindowCounters:
    def _loaded_window(self, monkeypatch, waves, wave_width, eval_batch,
                       min_mean_width, speculate=False):
        """Acceptance triplet for the mega-batch steady state: park
        `wave_width` evals per wave (broker disabled during
        registration), release each wave as one drain, and gate the
        measured window (everything after the warmup wave) on:
        mean fused-dispatch width ≥ min_mean_width, ZERO packed-program
        uploads, ZERO kernel-attributable hot-delta bytes, clean under
        transfer_guard("disallow"), with the wave path engaged.

        speculate=False pins the NON-speculative steady state
        (every dispatch refreshes the view and ADOPTS the
        predecessor carry → hot_delta == 0).

        speculate=True pins the SPECULATIVE steady state:
        wave_width exceeds eval_batch so each wave drains as two
        batches — the second launches speculatively against the
        chain's predicted view (no refresh at all) while the first's
        plans commit, and the NEXT wave's opening refresh adopts the
        certified chain HEAD carry. hot_delta stays ZERO anyway: the
        last host↔device byte stream of the loop is closed."""
        from nomad_tpu_torch.lib.metrics import default_registry
        from nomad_tpu_torch.lib.transfer import default_ledger
        from nomad_tpu_torch.server import Server, ServerConfig
        from nomad_tpu_torch.synth import synth_node

        monkeypatch.delenv("NOMAD_TPU_EVAL_BATCH", raising=False)
        # a pinned window makes each wave drain as one FULL batch (plus,
        # with speculate, the overflow successor batch): the hold
        # bridges the enqueue loop; jobs are identical-shaped so the
        # steady state has zero table inserts
        monkeypatch.setenv("NOMAD_TPU_DRAIN_WINDOW_MS", "300")
        monkeypatch.setenv("NOMAD_TPU_SPECULATE",
                           "1" if speculate else "0")
        if speculate:
            # generous rendezvous: the successor batch must park before
            # the predecessor's dispatch gives up on offering it a
            # speculative launch
            monkeypatch.setenv("NOMAD_TPU_SPEC_PARK_MS", "2000")
        rng = random.Random(29)
        s = Server(ServerConfig(num_schedulers=1, heartbeat_ttl=3600.0,
                                eval_batch=eval_batch), device="cpu")
        for i in range(48):
            s.state.upsert_node(synth_node(rng, i))
        s.start()
        try:
            led = default_ledger()
            led0 = hist0 = None
            adopts0 = 0
            for w in range(waves):
                s.broker.set_enabled(False)
                evs = []
                for i in range(wave_width):
                    j = _pinned_job(rng, f"dc{1 + i % 3}", count=1,
                                    cpu=50)
                    evs.append(s.job_register(j))
                s.broker.set_enabled(True)
                s._restore_evals()
                for ev in evs:
                    got = s.wait_for_eval(
                        ev.id, statuses=("complete", "failed", "blocked",
                                         "cancelled"), timeout=300.0)
                    assert got is not None and got.status == "complete",\
                        got
                if w == 0:
                    # warmup done: compiles, cold inserts, first carry.
                    # Snapshot counters and arm the guard — the whole
                    # measured window must be device-resident.
                    led0 = led.snapshot()
                    hist0 = s.metrics.histogram(
                        "drain.batch_width").summary()
                    # view.* counters live in the PROCESS registry
                    # (scheduler/stack.py), not the server's
                    adopts0 = default_registry().counters(
                        prefix="view.").get(
                        "chain_adopts" if speculate else "carry_adopts",
                        0)
                    monkeypatch.setenv("NOMAD_TPU_TRANSFER_GUARD",
                                       "disallow")
            led1 = led.snapshot()
            hist1 = s.metrics.histogram("drain.batch_width").summary()
            ctr = s.metrics.counters()
            adopts1 = default_registry().counters(
                prefix="view.").get(
                "chain_adopts" if speculate else "carry_adopts", 0)
        finally:
            s.shutdown()

        def delta(site):
            return (led1.get(site, {}).get("bytes", 0)
                    - led0.get(site, {}).get("bytes", 0))

        n = hist1["count"] - hist0["count"]
        mean_width = (hist1["sum"] - hist0["sum"]) / max(n, 1)
        assert mean_width >= min_mean_width, \
            (mean_width, n, "mega-batch drain width below the gate")
        assert delta("select_batch.pack_buffers") == 0, \
            "steady-state mega-batch shipped a packed program"
        assert delta("stack.hot_delta") == 0, \
            "kernel-committed rows re-uploaded from host"
        assert delta("stack.hot_full") == 0
        assert ctr.get("wave.dispatches", 0) >= waves - 1, ctr
        assert ctr.get("wave.collisions", 0) == 0
        if speculate:
            assert ctr.get("spec.launches", 0) >= 1, \
                (ctr, "loaded window never speculated")
            assert adopts1 > adopts0, \
                "measured window never adopted a chain carry"
        else:
            assert adopts1 > adopts0, \
                "measured window never adopted a carry"

    def test_loaded_window_width_gate(self, monkeypatch):
        # tier-1 sized: 3×192-eval waves drained as 128+64
        # batches — the second batch of every wave launches
        # speculatively, the next wave's refresh adopts the chain
        # carry, and hot-delta bytes stay ZERO end to end
        self._loaded_window(monkeypatch, waves=3, wave_width=192,
                            eval_batch=128, min_mean_width=64,
                            speculate=True)

    @pytest.mark.slow
    def test_loaded_1024_eval_window(self, monkeypatch):
        # the full acceptance window, speculation ON: 2048 evals
        # steady-state, every wave overflowing into a speculative
        # successor batch
        self._loaded_window(monkeypatch, waves=8, wave_width=256,
                            eval_batch=192, min_mean_width=64,
                            speculate=True)


# ---- the same feeds through the reference and the port --------------------


def _partition(pkg, feed, fps, max_n, batch_types=None):
    """Enqueue `feed` ((job, priority, type) triples) into a broker of
    `pkg` whose footprints are `fps`; the job ids of one drain by group,
    and the drain's counters."""
    structs = mod(pkg, "structs")
    fn = None if fps is None else (lambda ev: fps.get(ev.job_id))
    b = mod(pkg, "server.broker").EvalBroker(footprint_fn=fn,
                                             nack_timeout=0)
    b.set_enabled(True)
    for job, prio, typ in feed:
        b.enqueue(structs.Evaluation(priority=prio, type=typ, job_id=job))
    kw = {} if batch_types is None else {"batch_types": batch_types}
    groups = b.dequeue_batch(("service",), max_n=max_n, timeout=2.0, **kw)
    snap = b.metrics.snapshot()
    return ([[ev.job_id for ev, _tok in g] for g in groups],
            snap["counters"].get("drain.drains"),
            {k: snap["histograms"][k]["mean"]
             for k in ("drain.batch_width", "drain.groups")})


_FEEDS = {
    "split_merge": ([("a", 90, "service"), ("b", 80, "service"),
                     ("c", 70, "service"), ("d", 60, "service")],
                    {"a": (0, 1), "b": (1, 2), "c": (5,), "d": (6,)}, 8),
    "transitive": ([("a", 90, "service"), ("b", 80, "service"),
                    ("c", 70, "service")],
                   {"a": (0,), "b": (0, 1), "c": (1,)}, 8),
    "unknown": ([("a", 90, "service"), ("x", 80, "service"),
                 ("c", 70, "service")], {"a": (0,), "c": (5,)}, 8),
    "priorities": ([(f"j{i}", p, "service")
                    for i, p in enumerate([30, 90, 50, 70, 10, 60])],
                   {f"j{i}": (i,) for i in range(6)}, 8),
    "max_n": ([(f"j{i}", 50 + i % 3, "service") for i in range(12)],
              {f"j{i}": (i % 5,) for i in range(12)}, 5),
    "no_estimator": ([("a", 50, "service"), ("b", 40, "service")], None, 8),
    "same_job": ([("same", 50, "service"), ("same", 50, "service"),
                  ("other", 40, "service")], {}, 8),
}


class TestAgainstReference:
    @pytest.mark.parametrize("case", sorted(_FEEDS))
    def test_partition_equals_reference(self, case):
        feed, rows, max_n = _FEEDS[case]
        fps = None if rows is None else {
            j: _mask(16, *r) for j, r in rows.items()}
        ref, got = (_partition(pkg, feed, fps, max_n)
                    for pkg in (REF, PORT))
        assert got == ref

    @pytest.mark.parametrize("env,samples,want", [
        (None, (), 0.0), (None, (10.0,) * 8, 0.010),
        (None, (5000.0,) * 8, None), ("7.5", (), 0.0075), ("0", (), 0.0)])
    def test_hold_window_equals_reference(self, monkeypatch, env, samples,
                                          want):
        monkeypatch.delenv("NOMAD_TPU_DRAIN_WINDOW_MS", raising=False)
        if env is not None:
            monkeypatch.setenv("NOMAD_TPU_DRAIN_WINDOW_MS", env)
        got = {}
        for pkg in (REF, PORT):
            srv = mod(pkg, "server")
            s = srv.Server(srv.ServerConfig(num_schedulers=1,
                                            heartbeat_ttl=3600.0),
                           **dev(pkg))
            w = s.workers[0]
            for v in samples:
                s.metrics.add_sample("pipeline.host_ms", v)
            w._window_next = 0.0
            got[pkg] = w._hold_window()
        assert got[PORT] == got[REF]
        if want is not None:
            assert got[PORT] == pytest.approx(want)
        else:
            cap = mod(PORT, "server.worker").DRAIN_WINDOW_CAP_MS
            assert got[PORT] == pytest.approx(cap / 1e3)

    def test_wave_equals_reference(self):
        """Two dc-pinned lanes and a stale-footprint pair through the
        reference's `place_table_wave` and the port's, on one cluster."""
        import torch

        rm = mod(REF, "mock")
        cl = tc.RecordingCluster()
        for i in range(8):
            n = rm.node()
            n.id = f"node-{i}"
            n.datacenter = f"dc{1 + i % 2}"
            n.node_resources.cpu = 1000
            n.node_resources.memory_mb = 1024
            cl.upsert_node(n)
        clusters = {REF: cl, PORT: tc.replay(cl)}
        jobs = []
        for dc, cpu in (("dc1", 600), ("dc2", 600), ("dc1", 300)):
            j = rm.job()
            j.datacenters = [dc]
            j.task_groups[0].tasks[0].resources.cpu = cpu
            j.task_groups[0].tasks[0].resources.memory_mb = 64
            j.task_groups[0].networks = []
            jobs.append(j)
        out = {}
        for pkg in (REF, PORT):
            st = mod(pkg, "scheduler.stack")
            stack = (st.TPUStack(clusters[pkg]) if pkg == REF
                     else st.TorchStack(clusters[pkg], device="cpu"))
            progs = []
            for j in jobs:
                j = as_pkg(pkg, j)
                progs.append(stack.compile_tg(j, j.task_groups[0], 2,
                                              None)[0])
            pt = mod(pkg, "server.program_table")
            table = (pt.DeviceProgramTable() if pkg == REF
                     else pt.DeviceProgramTable(device="cpu"))
            prep = table.prepare(progs)
            ti, tf, tu = table.commit(
                prep, mod(pkg, "lib.transfer").default_ledger())[:3]
            arrays = stack.device_arrays()
            dyn = [prep.dyn_i, prep.dyn_f, prep.dyn_u]
            if pkg == PORT:
                dyn = [torch.as_tensor(np.asarray(d), device="cpu")
                       for d in dyn]
            # lanes: [p0, p2] in dc1 | [p1, p0 again] overlapping dc1
            order = [0, 2, 1, 0]
            rows = prep.rows[order].reshape(2, 2)
            wave, carry = mod(pkg, "kernels.placement").place_table_wave(
                arrays, ti, tf, tu, rows,
                *(d[order].reshape(2, 2, -1) for d in dyn),
                prep.sspec, prep.dspec, prep.m, explain=True)
            out[pkg] = ([np.asarray(x) for x in wave],
                        [np.asarray(c) for c in carry])
        (ref_w, ref_c), (got_w, got_c) = out[REF], out[PORT]
        assert len(got_w) == len(ref_w)
        floats = {1} | {4 + i for i, f in enumerate(
            mod(PORT, "kernels.placement").PlacementExplain._fields)
            if f in ("topk_score", "topk_parts")}
        for i, (r, g) in enumerate(zip(ref_w, got_w)):
            if i in floats:
                np.testing.assert_allclose(g, r, rtol=0, atol=ATOL)
            else:
                np.testing.assert_array_equal(g, r)
        for r, g in zip(ref_c, got_c):
            np.testing.assert_allclose(g, r, rtol=0, atol=ATOL)
        assert int(got_w[-1]) >= 1, "the overlapping lanes collided"

    def test_server_feed_equals_reference(self, monkeypatch):
        """The 2000-node parity feed through the reference's mega-batch
        server and the port's: the same node for every alloc and the
        same score within f32 rounding."""
        def feed(rng):
            return [_pinned_job(rng, f"dc{1 + i % 3}", count=2)
                    for i in range(9)]

        got, _stats, got_wave = _run_feed(2000, feed, 64, monkeypatch)
        ref, _ref_stats, ref_wave = _run_feed_ref(2000, feed, 64,
                                                  monkeypatch)
        assert got_wave >= 1 and ref_wave >= 1
        assert set(got) == set(ref)
        for k, (node, score) in ref.items():
            assert got[k][0] == node, k
            assert got[k][1] == pytest.approx(score, abs=2e-6), k


def _run_feed_ref(n_nodes, jobs_fn, eval_batch, monkeypatch, seed=17):
    """`_run_feed` on the reference's server and synth."""
    import random as _random

    srv = mod(REF, "server")
    synth = mod(REF, "synth")
    monkeypatch.delenv("NOMAD_TPU_EVAL_BATCH", raising=False)
    rng = _random.Random(seed)
    s = srv.Server(srv.ServerConfig(num_schedulers=1, heartbeat_ttl=3600.0,
                                    eval_batch=eval_batch))
    for i in range(n_nodes):
        s.state.upsert_node(synth.synth_node(rng, i))
    jobs = [mod(REF, "synth").synth_service_job(
        rng, count=2, datacenter=f"dc{1 + i % 3}") for i in range(9)]
    evs = [s.job_register(j) for j in jobs]
    s.start()
    try:
        for ev in evs:
            got = s.wait_for_eval(ev.id, statuses=(
                "complete", "failed", "blocked", "cancelled"), timeout=300.0)
            assert got is not None and got.status == "complete", got
        names = {nid: nd.name for nid, nd in s.state._nodes.items()}
        placements = {}
        for ji, j in enumerate(jobs):
            for a in s.state.allocs_by_job("default", j.id):
                score = next(round(float(sm.norm_score), 6)
                             for sm in a.metrics.score_meta
                             if sm.node_id == a.node_id)
                placements[(ji, a.name.rsplit("[", 1)[1])] = (
                    names[a.node_id], score)
        wave = int(s.metrics.counters().get("wave.dispatches", 0))
    finally:
        s.shutdown()
    return placements, None, wave
