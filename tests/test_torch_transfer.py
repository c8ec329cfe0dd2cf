"""Twins of the reference's `tests/test_transfer.py` (the transfer
ledger and the dispatch-pipeline timeline), run on the port.

Three layers under test:

- `TransferLedger` mechanics: per-site accounting, thread-local scopes,
  registry mirroring, labeled Prometheus exposition.
- `DispatchTimeline` mechanics: overlap/bubble math against synthetic
  intervals (both finalize orders), the ring bound, and the index
  long-poll (the event-broker idiom).
- The live dispatch path on the CPU: the fused batched coordinator path
  in steady state, and the ledger's per-site attribution reconciled
  with the independently-accumulated `view.*` counters and the
  coordinator's `pack_bytes`.

PyTorch has no transfer guard, so the port's `guard_scope` forbids
nothing: the reference's `test_guard_scope_catches_implicit_transfer`
(the disallow level raising) has no twin; `test_guard_scope_counts_*`
pins what the port's scope does instead. `TestAgainstReference` runs
the same ledger records and timeline intervals through both packages
and compares snapshots, totals, expositions, records and summaries.
"""
import random
import threading
import time
import uuid

import numpy as np
import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.lib.metrics import MetricsRegistry, default_registry
from nomad_tpu_torch.lib.transfer import (DispatchTimeline, TransferLedger,
                                    default_ledger)
from nomad_tpu_torch.mock import alloc_resources
from nomad_tpu_torch.scheduler.stack import TorchStack
from nomad_tpu_torch.server.select_batch import SelectCoordinator
from nomad_tpu_torch.structs import Allocation
from nomad_tpu_torch.tensor import ClusterTensors

from torch_chain_cases import one_torch_thread  # noqa: F401
from torch_ops_cases import PACKAGES, mod


# ---- ledger mechanics ------------------------------------------------------


class TestTransferLedger:
    def test_record_snapshot_totals_top(self):
        led = TransferLedger()
        led.record("a.site", 100, seconds=0.001)
        led.record("a.site", 50, seconds=0.002, count=3)
        led.record("b.site", 500)
        snap = led.snapshot()
        assert snap["a.site"] == {"bytes": 150, "count": 4, "ms": 3.0}
        assert snap["b.site"]["bytes"] == 500
        assert led.totals() == (650, 5, 3.0)
        assert [e["site"] for e in led.top_sites(1)] == ["b.site"]

    def test_registry_mirror(self):
        reg = MetricsRegistry()
        led = TransferLedger(registry=reg)
        led.record("x", 42, seconds=0.005, count=2)
        c = reg.counters(prefix="transfer.")
        assert c["bytes"] == 42 and c["count"] == 2
        assert c["ms"] == pytest.approx(5.0)

    def test_timed_records_wall_time(self):
        led = TransferLedger()
        with led.timed("t", 10):
            time.sleep(0.01)
        assert led.snapshot()["t"]["ms"] >= 5.0

    def test_scope_is_thread_local(self):
        led = TransferLedger()
        other_done = threading.Event()
        with led.scope() as acc:
            led.record("mine", 100)

            def other():
                led.record("theirs", 999)
                other_done.set()

            t = threading.Thread(target=other, daemon=True)
            t.start()
            t.join(5.0)
            assert other_done.is_set()
        assert acc == [100, 1], "scope leaked across threads"
        # both records still landed in the shared sites
        assert led.totals()[0] == 1099

    def test_nested_scopes_fold_outward(self):
        led = TransferLedger()
        with led.scope() as outer:
            led.record("a", 10)
            with led.scope() as inner:
                led.record("b", 5)
            assert inner == [5, 1]
        assert outer == [15, 2]

    def test_concurrent_records_exact(self):
        led = TransferLedger()
        n, per = 8, 200

        def pump(i):
            for _ in range(per):
                led.record(f"site.{i % 2}", 3)

        threads = [threading.Thread(target=pump, args=(i,), daemon=True)
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10.0)
        assert led.totals()[:2] == (3 * n * per, n * per)


# ---- timeline mechanics ----------------------------------------------------


def _mk_timeline(reg=None, capacity=256):
    return DispatchTimeline(registry=reg, capacity=capacity)


class TestDispatchTimeline:
    def test_overlap_and_bubble_exact(self):
        """Synthetic intervals: dispatch 2's pack [10,14] against
        dispatch 1's kernel [8,12] overlaps on [10,12] = 2000 ms; its
        kernel launches at 15 → bubble = 15-12 = 3000 ms."""
        reg = MetricsRegistry()
        tl = _mk_timeline(reg)
        b = tl.mono_anchor
        s1 = tl.commit(programs=4, batched=True, pack=(b + 1, b + 2),
                       view=(b + 2, b + 3), kernel_start=b + 8,
                       transfer_bytes=100, transfer_count=5)
        tl.kernel_end(s1, b + 12, fetch_bytes=7, fetch_count=1)
        s2 = tl.commit(programs=2, batched=True, pack=(b + 10, b + 14),
                       view=(b + 14, b + 14.5), kernel_start=b + 15,
                       transfer_bytes=50, transfer_count=3)
        tl.kernel_end(s2, b + 16)
        _, recs = tl.records_after(0)
        r1, r2 = recs
        assert r1["overlap_ms"] is None and r1["bubble_ms"] is None
        assert r2["overlap_ms"] == pytest.approx(2000.0)
        assert r2["bubble_ms"] == pytest.approx(3000.0)
        assert r1["transfer_bytes"] == 107  # fetch folded in
        assert r1["kernel_ms"] == pytest.approx(4000.0)
        # registry fed
        h = reg.snapshot()["histograms"]
        assert h["pipeline.overlap_ms"]["count"] == 1
        assert h["pipeline.overlap_ms"]["sum"] == pytest.approx(2000.0)
        assert h["pipeline.bubble_ms"]["sum"] == pytest.approx(3000.0)
        c = reg.counters(prefix="pipeline.")
        assert c["dispatches"] == 2 and c["programs"] == 6
        assert c["transfer_bytes"] == 157

    def test_finalize_when_kernel_end_arrives_after_successor_commit(self):
        """Waiters may resolve late: dispatch 2 commits while dispatch
        1's kernel is still in flight; the overlap must be computed when
        kernel_end(1) finally lands."""
        tl = _mk_timeline()
        b = tl.mono_anchor
        s1 = tl.commit(programs=1, batched=True, pack=(b, b + 1),
                       view=(b + 1, b + 1), kernel_start=b + 2,
                       transfer_bytes=0, transfer_count=0)
        tl.commit(programs=1, batched=True, pack=(b + 3, b + 5),
                  view=(b + 5, b + 5), kernel_start=b + 6,
                  transfer_bytes=0, transfer_count=0)
        _, recs = tl.records_after(0)
        assert recs[1]["overlap_ms"] is None  # pred kernel still open
        tl.kernel_end(s1, b + 4)
        _, recs = tl.records_after(0)
        assert recs[1]["overlap_ms"] == pytest.approx(1000.0)  # [3,4]
        assert recs[1]["bubble_ms"] == pytest.approx(2000.0)   # 6-4

    def test_disjoint_intervals_overlap_zero(self):
        tl = _mk_timeline()
        b = tl.mono_anchor
        s1 = tl.commit(programs=1, batched=False, pack=(b, b + 1),
                       view=(b + 1, b + 1), kernel_start=b + 1,
                       transfer_bytes=0, transfer_count=0)
        tl.kernel_end(s1, b + 2)
        tl.commit(programs=1, batched=False, pack=(b + 3, b + 4),
                  view=(b + 4, b + 4), kernel_start=b + 5,
                  transfer_bytes=0, transfer_count=0)
        _, recs = tl.records_after(0)
        assert recs[1]["overlap_ms"] == 0.0
        assert recs[1]["bubble_ms"] == pytest.approx(3000.0)

    def test_ring_bound_and_index_filter(self):
        tl = _mk_timeline(capacity=8)
        b = tl.mono_anchor
        for i in range(20):
            tl.commit(programs=1, batched=False,
                      pack=(b + i, b + i), view=(b + i, b + i),
                      kernel_start=b + i, transfer_bytes=1,
                      transfer_count=1)
        idx, recs = tl.records_after(0)
        assert idx == 20 and len(recs) == 8
        assert [r["seq"] for r in recs] == list(range(13, 21))
        _, tail = tl.records_after(18)
        assert [r["seq"] for r in tail] == [19, 20]
        assert tl.records_after(20)[1] == []
        # kernel_end on an evicted seq is a silent no-op
        tl.kernel_end(1, b + 100)

    def test_long_poll_wakes_on_commit(self):
        tl = _mk_timeline()

        def later():
            time.sleep(0.15)
            b = tl.mono_anchor
            tl.commit(programs=1, batched=False, pack=(b, b),
                      view=(b, b), kernel_start=b, transfer_bytes=0,
                      transfer_count=0)

        threading.Thread(target=later, daemon=True).start()
        t0 = time.time()
        idx, recs = tl.records_after(0, timeout=5.0)
        assert recs and time.time() - t0 < 2.0

    def test_summary_aggregates(self):
        tl = _mk_timeline()
        b = tl.mono_anchor
        s1 = tl.commit(programs=2, batched=True, pack=(b, b + 2),
                       view=(b + 2, b + 2), kernel_start=b + 2,
                       transfer_bytes=10, transfer_count=1)
        tl.kernel_end(s1, b + 6)
        s2 = tl.commit(programs=2, batched=True, pack=(b + 4, b + 6),
                       view=(b + 6, b + 6), kernel_start=b + 7,
                       transfer_bytes=30, transfer_count=3)
        tl.kernel_end(s2, b + 8)
        s = tl.summary()
        assert s["dispatches"] == 2 and s["last_seq"] == 2
        # paired record: pack 2000ms, overlap [4,6] = 2000ms → 100%
        assert s["overlap_pct"] == pytest.approx(100.0)
        assert s["bubble_ms_total"] == pytest.approx(1000.0)
        assert s["transfer_bytes_per_dispatch"] == pytest.approx(20.0)


# ---- live dispatch path ----------------------------------------------------


def _mini_cluster(n_nodes=8, cpu=2000.0, mem=4096.0):
    cl = ClusterTensors()
    for i in range(n_nodes):
        n = mock.node()
        n.id = f"node-{i}"
        n.node_resources.cpu = int(cpu)
        n.node_resources.memory_mb = int(mem)
        cl.upsert_node(n)
    return cl


def _jobs(n, cpu=150):
    out = []
    for i in range(n):
        j = mock.job()
        j.task_groups[0].tasks[0].resources.cpu = cpu
        j.task_groups[0].tasks[0].resources.memory_mb = 64
        j.task_groups[0].networks = []
        out.append(j)
    return out


def _churn(cl, rng, n=3):
    for _ in range(n):
        cl.upsert_alloc(Allocation(
            id=uuid.uuid4().hex, namespace="default",
            job_id=f"churn-{rng.randrange(4)}", task_group="web",
            node_id=f"node-{rng.randrange(8)}",
            allocated_resources=alloc_resources(
                cpu=rng.randrange(10, 60), memory_mb=32, disk_mb=10),
            desired_status="run", client_status="pending"))


def _run_round(cl, jobs, timeline=None):
    """One fused coordinator round: every job's select parks, the
    coordinator dispatches the batch, waiters materialize (so all
    fetches land before this returns)."""
    coord = SelectCoordinator(timeline=timeline)
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
        threads.append(threading.Thread(target=one, args=(i, j),
                                        daemon=True))
    for t in threads:
        t.start()
    coord.run()
    for t in threads:
        t.join(30.0)
    return coord, results


class TestGuardParity:
    """The steady-state fused batched path — delta-applied view refresh
    included — with the guard setting at "disallow": on the port the
    setting forbids nothing (torch has no transfer guard), so this pins
    that the path still fuses, places and completes under it."""

    def test_steady_state_batched_path_clean_under_disallow(
            self, monkeypatch):
        rng = random.Random(3)
        cl = _mini_cluster()
        # round 1: cold — compiles + full uploads, unguarded
        coord, res = _run_round(cl, _jobs(4))
        assert coord.stats["batched"] == 4
        # round 2: warm the DELTA kernels too (first delta apply
        # compiles them), still unguarded
        _churn(cl, rng)
        _run_round(cl, _jobs(4))
        # round 3: steady state under the hard-failure guard — an
        # implicit transfer anywhere in pack-transport, delta apply, or
        # kernel launch raises through the waiters and fails the test
        _churn(cl, rng)
        monkeypatch.setenv("NOMAD_TPU_TRANSFER_GUARD", "disallow")
        coord, res = _run_round(cl, _jobs(4))
        assert coord.stats["batched"] == 4
        assert len(res) == 4
        assert all(r[0] is not None for r in res.values())

    def test_guard_scope_counts_what_the_scope_books(self, monkeypatch):
        """The port's guard scope forbids nothing (torch has no transfer
        guard); it books what the calling thread records in the ledger
        while it is open into `transfer.guarded_*`, at any level."""
        from nomad_tpu_torch.lib.transfer import guard_scope

        reg = default_registry()
        led = default_ledger()
        for level in ("disallow", "bogus"):
            monkeypatch.setenv("NOMAD_TPU_TRANSFER_GUARD", level)
            before = reg.counters(prefix="transfer.guarded_")
            with guard_scope():
                led.record("stack.hot_delta", 64, count=2)
            after = reg.counters(prefix="transfer.guarded_")
            assert after.get("bytes", 0) - before.get("bytes", 0) == 64
            assert after.get("count", 0) - before.get("count", 0) == 2
        with guard_scope():
            pass        # nothing booked, nothing counted


class TestLedgerAttribution:
    """The ledger accounts what actually moved: its per-site deltas
    reconcile exactly with the independently-accumulated view.* byte
    counter (stack sites) and the coordinator's pack_bytes stat
    (packed-transport site), and the dispatch timeline's per-record
    transfer totals agree with the ledger's h2d+fetch sum."""

    def test_window_attribution_against_independent_counters(self):
        rng = random.Random(11)
        cl = _mini_cluster()
        _run_round(cl, _jobs(4))           # cold round outside window
        _churn(cl, rng)
        _run_round(cl, _jobs(4))           # delta kernels warm
        _churn(cl, rng)

        led = default_ledger()
        reg = default_registry()
        led0 = led.snapshot()
        v0 = reg.counters(prefix="view.").get("upload_bytes", 0)
        tl = DispatchTimeline()
        coord, res = _run_round(cl, _jobs(4), timeline=tl)
        assert len(res) == 4
        led1 = led.snapshot()
        v1 = reg.counters(prefix="view.").get("upload_bytes", 0)

        def site_delta(prefix):
            return sum(
                vals["bytes"] - led0.get(site, {}).get("bytes", 0)
                for site, vals in led1.items()
                if site.startswith(prefix))

        stack_bytes = site_delta("stack.")
        # program transport: table-row inserts + per-dispatch dynamic
        # rows (the device-resident path) plus the legacy packed buffers
        # (fallback dispatches) — all mirrored in coord pack_bytes
        pack_bytes = (site_delta("select_batch.pack_buffers")
                      + site_delta("select_batch.dyn_rows")
                      + site_delta("select_batch.table_insert"))
        fetch_bytes = site_delta("select_batch.fetch")
        # exact reconciliation vs the two independent accumulators
        assert stack_bytes == v1 - v0
        assert pack_bytes == coord.stats["pack_bytes"]
        # the acceptance shape: ledger attribution covers ≥95% of the
        # independently-known bytes moved (here it is exact)
        expected = (v1 - v0) + coord.stats["pack_bytes"]
        assert expected > 0
        ledger_h2d = stack_bytes + pack_bytes + site_delta("mesh.")
        assert ledger_h2d >= 0.95 * expected
        # timeline per-dispatch totals = ledger h2d + d2h fetch
        _, recs = tl.records_after(0)
        assert recs, "no timeline records for the window"
        assert sum(r["transfer_bytes"] for r in recs) == \
            ledger_h2d + fetch_bytes
        assert all(r["kernel_ms"] is not None for r in recs)


@pytest.mark.slow
class TestLedgerAttributionE2E:
    """Soak-length acceptance gate: a 1024-eval window through the REAL
    control plane (Server → broker → batched workers → plan apply) with
    the ledger attributing ≥95% of the bytes the independent counters
    say moved, and the timeline showing live pipelining the whole way."""

    def test_1024_eval_window_attribution(self):
        from nomad_tpu_torch.server import Server, ServerConfig
        from nomad_tpu_torch.synth import synth_node, synth_service_job

        rng = random.Random(23)
        s = Server(ServerConfig(num_schedulers=1, heartbeat_ttl=3600.0,
                                eval_batch=8), device="cpu")
        for i in range(64):
            s.state.upsert_node(synth_node(rng, i))
        n_evals, warm_n = 1024, 32
        jobs = [synth_service_job(rng, count=1)
                for _ in range(n_evals + warm_n)]
        evs = [s.job_register(j) for j in jobs[:warm_n]]
        s.start()
        try:
            for ev in evs:
                assert s.wait_for_eval(
                    ev.id, statuses=("complete", "failed", "blocked",
                                     "cancelled"), timeout=600.0)
            led = default_ledger()
            reg = default_registry()
            led0 = led.snapshot()
            v0 = reg.counters(prefix="view.").get("upload_bytes", 0)
            w0 = dict(s.workers[0].batch_stats)
            tl0 = s.timeline.last_index()
            evs = [s.job_register(j) for j in jobs[warm_n:]]
            done = 0
            for ev in evs:
                got = s.wait_for_eval(
                    ev.id, statuses=("complete", "failed", "blocked",
                                     "cancelled"), timeout=600.0)
                if got is not None:
                    done += 1
            assert done == n_evals
            led1 = led.snapshot()
            v1 = reg.counters(prefix="view.").get("upload_bytes", 0)
            w1 = dict(s.workers[0].batch_stats)
            summ = s.timeline.summary()
        finally:
            s.shutdown()

        def site_delta(prefix):
            return sum(
                vals["bytes"] - led0.get(site, {}).get("bytes", 0)
                for site, vals in led1.items()
                if site.startswith(prefix))

        ledger_h2d = (site_delta("stack.")
                      + site_delta("select_batch.pack_buffers")
                      + site_delta("select_batch.dyn_rows")
                      + site_delta("select_batch.table_insert")
                      + site_delta("mesh."))
        expected = ((v1 - v0)
                    + w1.get("pack_bytes", 0) - w0.get("pack_bytes", 0))
        assert expected > 0
        # ≥95% attribution across the 1024-eval window (exact in
        # practice; the band tolerates unledgered stragglers)
        assert ledger_h2d >= 0.95 * expected, (ledger_h2d, expected)
        assert ledger_h2d <= 1.05 * expected, (ledger_h2d, expected)
        # the pipeline instrument ran live across the window and the
        # ring stayed bounded
        assert s.timeline.last_index() > tl0
        assert summ["dispatches"] <= 256
        assert summ["transfer_bytes_per_dispatch"] > 0


# ---- the same records and intervals through the reference and the port ----


def _ledger(pkg):
    tr = mod(pkg, "lib.transfer")
    reg = mod(pkg, "lib.metrics").MetricsRegistry()
    led = tr.TransferLedger(registry=reg)
    led.record("stack.hot_delta", 100, seconds=0.001)
    led.record("stack.hot_delta", 50, seconds=0.002, count=3)
    with led.scope() as outer:
        led.record("select_batch.pack_buffers", 500)
        with led.scope() as inner:
            led.record("select_batch.fetch", 7, seconds=0.0005)
    led.record("view.upload", 12, count=4)
    return (led.snapshot(), led.totals(), led.top_sites(2),
            list(outer), list(inner), led.prometheus(),
            reg.counters(prefix="transfer."))


def _timeline(pkg, capacity):
    tr = mod(pkg, "lib.transfer")
    reg = mod(pkg, "lib.metrics").MetricsRegistry()
    tl = tr.DispatchTimeline(registry=reg, capacity=capacity)
    b = tl.mono_anchor
    seqs = []
    for i in range(12):
        s = tl.commit(programs=1 + i % 3, batched=i % 2 == 0,
                      pack=(b + 3 * i, b + 3 * i + 1.5),
                      view=(b + 3 * i + 1.5, b + 3 * i + 2),
                      kernel_start=b + 3 * i + 2.25,
                      transfer_bytes=10 * i, transfer_count=i % 4)
        seqs.append(s)
        if i % 3 != 1:
            tl.kernel_end(s, b + 3 * i + 4, fetch_bytes=i, fetch_count=1)
    for s in seqs[1::3]:
        tl.kernel_end(s, b + 40)      # late ends, after successors commit

    def rel(r):
        # wall-clock stamps differ between the two runs; the monotonic
        # ones are taken relative to the timeline's anchor
        return {k: (round(v - b, 9) if k.endswith(("_start", "_end", "_at"))
                    and isinstance(v, float) else v)
                for k, v in r.items() if not k.endswith("_unix")}

    idx, recs = tl.records_after(0)
    summary = tl.summary()
    return (idx, [rel(r) for r in recs], summary,
            reg.counters(prefix="pipeline."),
            {k: v for k, v in reg.snapshot()["histograms"].items()
             if k.startswith("pipeline.")})


class TestAgainstReference:
    def test_ledger_equals_reference(self):
        ref, got = (_ledger(pkg) for pkg in PACKAGES)
        assert got == ref

    @pytest.mark.parametrize("capacity", [4, 256])
    def test_timeline_equals_reference(self, capacity):
        ref, got = (_timeline(pkg, capacity) for pkg in PACKAGES)
        assert got[0] == ref[0]
        assert len(got[1]) == len(ref[1])
        for r, g in zip(ref[1], got[1]):
            assert set(g) == set(r)
            for k in r:
                if isinstance(r[k], float):
                    assert g[k] == pytest.approx(r[k], abs=1e-6), k
                else:
                    assert g[k] == r[k], k
        assert got[2:] == ref[2:]
