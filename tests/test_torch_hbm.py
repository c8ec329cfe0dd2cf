"""The port's residency ledger against the reference's
(`tests/test_hbm.py` TestLeases and TestLeakGate), twin by twin.

Leases: the same lease/release sequences through both packages'
`HbmLedger` give the same outstanding counts, high-water marks and stuck
verdicts. Leak gate: the same steady-state rounds — plain fused
dispatches, a speculative dispatch rolled back in full, a certified chain
whose head carry the next refresh adopts — through the reference
(`TPUStack`, JAX on the CPU) and the port (`TorchStack(device="cpu")`)
leave zero outstanding leases, zero unfreed carries or lazy outputs, and
per-site live bytes back at the warm baseline, in both. Live bytes are
compared per site within each package: the port's tensors are not the
reference's arrays (its port bitmap crosses as int32, its attrs keep
int16), but the set of sites and their return to baseline are the same.
The reference's `transfer_guard("disallow")` windows read as the port's
counting `guard_scope`.

Ledger mechanics, the planner, the planner against measurement and the
site taxonomy (the reference's `TestLedgerMechanics`, `TestPlannerMath`,
`TestPlannerAgainstMeasurement`, `TestSiteTaxonomy`): the same bookings
through both ledgers — numpy arrays into the reference's, torch tensors
of the same shapes into the port's — give equal snapshots, totals,
registry mirrors and expositions, byte for byte; the same ledgers give
equal plans, but for the fallback capacity: with no card visible the
port plans against an H100 80GB HBM3's total memory, the reference
against its TPU's. `TestReconciliation` skips on the CPU as the
reference's does (no allocator numbers); its card form is in
`tests/test_torch_cuda.py`.
"""
import gc
import time

import numpy as np
import pytest
import torch

from torch_chain_cases import one_torch_thread  # noqa: F401
from torch_view_cases import (BOTH, PORT, REF, dc_job, dc_nodes, mini_nodes,
                              mixed_job, seeded)


def _ledger_trace(p, monkeypatch, script):
    led = p.hbm.HbmLedger(registry=p.metrics.MetricsRegistry())
    out = []
    for op, arg in script:
        if op == "lease":
            led.lease(arg, "stack.view")
        elif op == "release":
            out.append(led.release_lease(arg) is not None)
        elif op == "watermark":
            monkeypatch.setenv("NOMAD_TPU_HBM_LEASE_WATERMARK_S", arg)
        elif op == "sleep":
            time.sleep(arg)
        elif op == "stuck":
            out.append([lease["stuck"] for lease in led.leases()])
        elif op == "scrape":
            led.prometheus()
        elif op == "count":
            out.append((led.outstanding_leases(), led.lease_high_water,
                        led.registry.counters().get("hbm.stuck_leases",
                                                    0)))
    return out


_LEASE_SCRIPTS = {
    "lifecycle_high_water": [
        ("lease", "tok-1"), ("lease", "tok-2"), ("count", None),
        ("release", "tok-1"), ("release", "tok-1"), ("release", "tok-2"),
        ("count", None)],
    "stuck_watermark": [
        ("watermark", "0.01"), ("lease", "wedged"), ("sleep", 0.03),
        ("stuck", None), ("count", None), ("stuck", None), ("count", None),
        ("release", "wedged"), ("lease", "fine"), ("stuck", None),
        ("release", "fine")],
    "scrape_runs_watermark": [
        ("watermark", "0.01"), ("lease", "wedged"), ("sleep", 0.03),
        ("scrape", None), ("count", None), ("release", "wedged")],
    "watermark_disabled": [
        ("watermark", "0"), ("lease", "t"), ("sleep", 0.01),
        ("stuck", None), ("release", "t")],
}

#: what the reference's TestLeases asserts for each script
_LEASE_EXPECT = {
    "lifecycle_high_water": [(2, 2, 0), True, False, True, (0, 2, 0)],
    "stuck_watermark": [[True], (1, 1, 1), [True], (1, 1, 1), True,
                        [False], True],
    "scrape_runs_watermark": [(1, 1, 1), True],
    "watermark_disabled": [[False], True],
}


class TestLeases:
    @pytest.mark.parametrize("name", sorted(_LEASE_SCRIPTS))
    def test_lease_tracking_matches_reference(self, name, monkeypatch):
        got = {p.name: _ledger_trace(p, monkeypatch, _LEASE_SCRIPTS[name])
               for p in BOTH}
        assert got["port"] == got["ref"] == _LEASE_EXPECT[name]


def _fresh_global_ledger(p, monkeypatch):
    """Swap the package's process-global ledger for a fresh one so prior
    tests' still-referenced clusters don't pollute measurements."""
    led = p.hbm.HbmLedger(registry=p.metrics.MetricsRegistry())
    monkeypatch.setattr(p.hbm, "_default_hbm", led)
    return led


def _quiesce(p, cl):
    """Consume any in-flight carry with a refresh and drop transients."""
    p.make_stack(cl).device_arrays()
    gc.collect()


def _assert_back_at_baseline(p, led, base, base_live, what):
    assert led.outstanding_leases() == 0, f"{p}: leaked {what} lease"
    snap = led.snapshot()
    assert snap.get("select_batch.carry", {}).get("live_bytes", 0) == 0, \
        f"{p}: unfreed {what} carry"
    assert snap.get("select_batch.batch_out", {}).get(
        "live_bytes", 0) == 0, f"{p}: unresolved {what} outputs"
    for site, row in sorted(snap.items()):
        assert row["live_bytes"] == base.get(site, {}).get(
            "live_bytes", 0), f"{p}: residency grew at {site}"
    assert led.totals()[0] == base_live
    return snap


def _steady_state(p, monkeypatch):
    led = _fresh_global_ledger(p, monkeypatch)
    rng = seeded(7)
    cl = p.cluster(mini_nodes())
    jobs = [mixed_job(rng, i) for i in range(4)]
    ids = [f"ev-{i}" for i in range(4)]
    for _ in range(2):   # warmup: cold uploads, table inserts, carries
        _c, res = p.run_round(cl, jobs, eval_ids=ids)
        p.commit_round(cl, res, ids)
    _quiesce(p, cl)
    base, base_live = led.snapshot(), led.totals()[0]
    assert base_live > 0 and led.outstanding_leases() == 0
    # the measured window, under the reference's guard-fatal policy
    monkeypatch.setenv("NOMAD_TPU_TRANSFER_GUARD", "disallow")
    _c, res = p.run_round(cl, jobs, eval_ids=ids)
    p.commit_round(cl, res, ids)
    monkeypatch.delenv("NOMAD_TPU_TRANSFER_GUARD")
    res = None
    _quiesce(p, cl)
    snap = _assert_back_at_baseline(p, led, base, base_live, "fused")
    # the window exercised the loop (not vacuous)
    assert snap["select_batch.batch_out"]["allocs"] > \
        base["select_batch.batch_out"]["allocs"]
    assert led.lease_high_water >= 1
    return sorted(snap)


def _rolled_back(p, monkeypatch):
    led = _fresh_global_ledger(p, monkeypatch)
    monkeypatch.setenv("NOMAD_TPU_SPEC_ROLLBACK_MAX", "1.0")
    cl = p.cluster(dc_nodes())
    reg = p.metrics.MetricsRegistry()
    _c0, res0 = p.run_round(cl, [dc_job("dc1"), dc_job("dc2")],
                            eval_ids=["w1", "w2"])
    p.commit_round(cl, res0, ["w1", "w2"])
    res0 = None
    _quiesce(p, cl)
    base, base_live = led.snapshot(), led.totals()[0]
    assert led.outstanding_leases() == 0
    _c1, res1 = p.run_round(cl, [dc_job("dc1"), dc_job("dc2")],
                            eval_ids=["a", "b"])
    # NO footprints: every program conflicts with any stale row — the
    # foreign commit below forces a FULL rollback
    coord2 = p.coordinator(reg, ["c", "d"], {0: 0, 1: 1})
    threads, res2 = p.start_parked(
        cl, [dc_job("dc1", cpu=250), dc_job("dc2", cpu=250)], coord2)
    assert coord2.try_spec_launch(cl)
    p.commit_round(cl, res1, ["a", "b"])
    dc1 = next(nid for nid in cl.row_of if cl.nodes[nid].datacenter == "dc1")
    cl.upsert_alloc(p.alloc(dc1, job_id="foreign", cpu=123))
    monkeypatch.setenv("NOMAD_TPU_TRANSFER_GUARD", "disallow")
    coord2.run()
    monkeypatch.delenv("NOMAD_TPU_TRANSFER_GUARD")
    for t in threads:
        t.join(30.0)
    c = reg.counters()
    assert c.get("spec.rolled_back") == 1
    assert c.get("spec.redispatch_programs") == 2
    assert all(res2[i][0][0] is not None for i in res2)
    p.commit_round(cl, res2, ["c", "d"])
    res1 = res2 = None
    _quiesce(p, cl)
    _assert_back_at_baseline(p, led, base, base_live, "speculative")
    assert p.stack_mod.spec_chain_head_token(cl) is None
    return c.get("spec.rolled_back"), c.get("spec.redispatch_programs")


def _chain_adoption(p, monkeypatch):
    led = _fresh_global_ledger(p, monkeypatch)
    cl = p.cluster(dc_nodes())
    _c0, res0 = p.run_round(cl, [dc_job("dc1"), dc_job("dc2")],
                            eval_ids=["w1", "w2"])
    p.commit_round(cl, res0, ["w1", "w2"])
    res0 = None
    _quiesce(p, cl)
    base, base_live = led.snapshot(), led.totals()[0]
    assert base_live > 0 and led.outstanding_leases() == 0
    _r, fin_res, fin_ids = p.drive_chain(cl, monkeypatch, k=3)
    p.commit_round(cl, fin_res, fin_ids)
    adopts0 = p.counter("chain_adopts")
    with p.transfer.guard_scope("disallow"):
        p.make_stack(cl).device_arrays()
    assert p.counter("chain_adopts") == adopts0 + 1
    fin_res = None
    gc.collect()
    _assert_back_at_baseline(p, led, base, base_live, "chain")
    return True


class TestLeakGate:
    @pytest.mark.parametrize("case", [_steady_state, _rolled_back,
                                      _chain_adoption],
                             ids=["steady_state_fused_window",
                                  "rolled_back_speculation",
                                  "chain_adoption_round"])
    def test_leaks_nothing_like_reference(self, case, monkeypatch):
        got = {}
        for p in BOTH:
            with monkeypatch.context() as m:
                got[p.name] = case(p, m)
        assert got["port"] == got["ref"]

    def test_unreleased_lease_is_visible(self, monkeypatch):
        """A caller that takes a view lease and never releases it shows
        up as outstanding and, past the watermark, stuck."""
        for p in BOTH:
            led = _fresh_global_ledger(p, monkeypatch)
            cl = p.cluster(mini_nodes())
            p.make_stack(cl).device_arrays(lease_token="wedged-token")
            assert led.outstanding_leases() == 1
            monkeypatch.setenv("NOMAD_TPU_HBM_LEASE_WATERMARK_S", "0.001")
            time.sleep(0.01)
            assert any(lease["stuck"] for lease in led.leases())
            p.stack_mod.release_view(cl, "wedged-token")
            assert led.outstanding_leases() == 0
            monkeypatch.delenv("NOMAD_TPU_HBM_LEASE_WATERMARK_S")

    def test_solo_select_returns_its_lease(self, monkeypatch):
        """The port's solo `select` leases its view for the launch (the
        reference's solo path takes none — donation covers it there) and
        returns the lease: nothing outstanding afterwards."""
        led = _fresh_global_ledger(PORT, monkeypatch)
        cl = PORT.cluster(mini_nodes())
        job = PORT.conv(dc_job("dc1"))
        r = PORT.make_stack(cl).select(job, job.task_groups[0], 2)
        assert r.node_ids[0] is not None
        assert led.outstanding_leases() == 0 and led.lease_high_water == 1


# ---- ledger mechanics: numpy into the reference, torch into the port -------


def _buf(p, shape, dtype):
    """A zeroed buffer of the package's own kind: a numpy array for the
    reference's ledger (as its tests book), a CPU tensor for the port's."""
    a = np.zeros(shape, dtype=dtype)
    return a if p.name == "ref" else torch.from_numpy(a)


def _track_and_gc(p):
    led = p.hbm.HbmLedger()
    a = _buf(p, (16, 8), np.float32)
    led.track("t.site", a, rows=16)
    out = [dict(led.snapshot()["t.site"])]
    del a
    gc.collect()
    out.append(dict(led.snapshot()["t.site"]))
    return out


def _idempotent(p):
    led = p.hbm.HbmLedger()
    a = _buf(p, 64, np.uint8)
    led.track("t.a", a)
    led.track("t.a", a)
    return dict(led.snapshot()["t.a"])


def _resite(p):
    led = p.hbm.HbmLedger()
    a = _buf(p, 256, np.uint8)
    led.track("t.carry", a)
    led.track("t.view", a)
    out = [led.snapshot(), led.totals()]
    del a
    gc.collect()
    return out + [led.totals()]


def _releases_on_gc(p):
    """The reference books a jax array, the port a torch tensor: each
    package's own device array type leaves the ledger with its object."""
    led = p.hbm.HbmLedger()
    if p.name == "ref":
        import jax.numpy as jnp

        a = jnp.zeros((32, 32), dtype=jnp.float32)
    else:
        a = torch.zeros((32, 32), dtype=torch.float32)
    led.track("t.dev", a)
    out = [led.totals()]
    del a
    gc.collect()
    return out + [led.totals()]


def _scalars(p):
    led = p.hbm.HbmLedger()
    led.track("t.x", 7)                 # no nbytes: ignored
    led.track("t.x", np.float64(3.0))   # no weakref: dropped
    return led.totals()[:2]


def _exposition(p):
    led = p.hbm.HbmLedger()
    a = _buf(p, 128, np.uint8)
    led.track("s.one", a)
    return led.prometheus()


def _registry_mirror(p):
    reg = p.metrics.MetricsRegistry()
    led = p.hbm.HbmLedger(registry=reg)
    a = _buf(p, 512, np.uint8)
    led.track("t.m", a)
    out = [reg.snapshot()]
    del a
    gc.collect()
    return out + [reg.snapshot()]


_MECHANICS = {
    "track_and_gc_release": (_track_and_gc, [
        {"live_bytes": 512, "buffers": 1, "peak_bytes": 512, "allocs": 1,
         "releases": 0, "rows": 16},
        {"live_bytes": 0, "buffers": 0, "peak_bytes": 512, "allocs": 1,
         "releases": 1, "rows": 16}]),
    "track_is_idempotent_per_site": (_idempotent, {
        "live_bytes": 64, "buffers": 1, "peak_bytes": 64, "allocs": 1,
        "releases": 0, "rows": 0}),
    "resite_moves_bytes_without_double_count": (_resite, None),
    "device_arrays_release_on_gc": (_releases_on_gc,
                                    [(4096, 1, 4096), (0, 0, 4096)]),
    "untracked_scalars_do_not_leak": (_scalars, (0, 0)),
    "prometheus_exposition_pinned": (_exposition, (
        "# TYPE nomad_hbm_live_bytes gauge\n"
        'nomad_hbm_live_bytes{shard="0",site="s.one"} 128\n'
        "# TYPE nomad_hbm_buffers gauge\n"
        'nomad_hbm_buffers{shard="0",site="s.one"} 1\n'
        "# TYPE nomad_hbm_peak_bytes gauge\n"
        'nomad_hbm_peak_bytes{shard="0",site="s.one"} 128\n')),
    "registry_mirror": (_registry_mirror, None),
}


class TestLedgerMechanics:
    @pytest.mark.parametrize("name", sorted(_MECHANICS))
    def test_mechanics_match_reference(self, name):
        fn, expect = _MECHANICS[name]
        got = {p.name: fn(p) for p in BOTH}
        assert got["port"] == got["ref"]
        if expect is not None:
            assert got["port"] == expect

    def test_resite_moves_bytes(self):
        """The reference's assertions on the carry-adoption shape."""
        snap, totals, after = _resite(PORT)
        assert snap["t.carry"]["live_bytes"] == 0
        assert snap["t.view"]["live_bytes"] == 256
        assert totals[:2] == (256, 1)
        assert after[0] == 0

    def test_registry_mirror_values(self):
        live, dead = _registry_mirror(PORT)
        assert live["gauges"]["hbm.live_bytes_total"] == 512
        assert live["gauges"]["hbm.buffers_total"] == 1
        assert live["counters"]["hbm.allocs"] == 1
        assert dead["gauges"]["hbm.live_bytes_total"] == 0
        assert dead["counters"]["hbm.releases"] == 1
        assert dead["gauges"]["hbm.peak_bytes_total"] == 512

    def test_card_tensor_books_its_index(self):
        """A tensor on card k books shard "k"; a host tensor "0", the
        reference's label for an array it cannot place (C8)."""
        class _Dev:
            type, index = "cuda", 3

        class _OnCard:
            nbytes, device = 64, _Dev()

        assert PORT.hbm.HbmLedger._shard_bookings(_OnCard()) == [("3", 64)]
        assert PORT.hbm.HbmLedger._shard_bookings(
            torch.zeros(4)) == [("0", 16)]


# ---- the capacity planner --------------------------------------------------


def _compare_plans(ref, port):
    """Plans equal key by key; with no card and no setting the two
    packages fall back to different capacities (the reference's TPU, the
    port's H100), so the limit and headroom are compared only when both
    read the same source other than the default."""
    keys = set(ref) | set(port)
    if ref["limit_source"] == "default" or port["limit_source"] == "default":
        keys -= {"device_limit_bytes", "headroom_bytes"}
    assert {k: port[k] for k in keys} == {k: ref[k] for k in keys}


def _planner_ledger(p, view_shape=(64, 16), table=1000, transient=300):
    led = p.hbm.HbmLedger()
    view = _buf(p, view_shape, np.float32)
    tab = _buf(p, table, np.uint8)
    led.track("stack.view_hot", view, rows=view_shape[0])
    led.track("program_table.i32", tab)
    if transient:
        t = _buf(p, transient, np.uint8)
        led.track("select_batch.batch_out", t)
        del t
        gc.collect()
    return led, (view, tab)


class TestPlannerMath:
    def test_invalid_args_raise(self):
        for p in BOTH:
            with pytest.raises(ValueError):
                p.hbm.plan_capacity(0, 10, p.hbm.HbmLedger())
            with pytest.raises(ValueError):
                p.hbm.plan_capacity(10, -1, p.hbm.HbmLedger())

    def test_projection_terms(self, monkeypatch):
        """The node term scales per measured row, the fixed term stays,
        the transient term projects at its peak; shards split only the
        node term. Then a tiny device: the node axis shards until it
        fits, in both packages alike."""
        monkeypatch.delenv("NOMAD_TPU_HBM_GB", raising=False)
        plans, keep = {}, []
        for p in BOTH:
            led, bufs = _planner_ledger(p)
            keep.append(bufs)
            plans[p.name] = p.hbm.plan_capacity(1000, 50_000, led)
        _compare_plans(plans["ref"], plans["port"])
        plan = plans["port"]
        assert plan["projected_n_cap"] == 1024
        assert plan["per_node_bytes"] == 64.0
        assert plan["node_bytes"] == 64 * 1024
        assert plan["fixed_bytes"] == 1000
        assert plan["transient_peak_bytes"] == 300
        assert plan["projected_bytes"] == 64 * 1024 + 1300
        assert plan["measured"] and plan["per_alloc_bytes"] == 0.0
        monkeypatch.setenv("NOMAD_TPU_HBM_GB", str(20_000 / (1 << 30)))
        plans = {}
        for p in BOTH:
            led, bufs = _planner_ledger(p)
            keep.append(bufs)
            plans[p.name] = p.hbm.plan_capacity(1000, 50_000, led)
        _compare_plans(plans["ref"], plans["port"])
        if plans["port"]["limit_source"] == "env":
            assert not plans["port"]["fits"]
            assert plans["port"]["shards_needed"] == 4

    def test_unmeasured_ledger_flagged(self):
        plans = {p.name: p.hbm.plan_capacity(100, 100, p.hbm.HbmLedger())
                 for p in BOTH}
        _compare_plans(plans["ref"], plans["port"])
        assert not plans["port"]["measured"]
        assert plans["port"]["node_bytes"] == 0

    def test_unshardable_fixed_footprint_reports_zero_shards(
            self, monkeypatch):
        monkeypatch.setenv("NOMAD_TPU_HBM_GB", str(4000 / (1 << 30)))
        plans, keep = {}, []
        for p in BOTH:
            led, bufs = _planner_ledger(p, table=5000, transient=0)
            keep.append(bufs)
            plans[p.name] = p.hbm.plan_capacity(1000, 10, led)
        _compare_plans(plans["ref"], plans["port"])
        if plans["port"]["limit_source"] == "env":
            assert not plans["port"]["fits"]
            assert plans["port"]["shards_needed"] == 0

    def test_nonpositive_env_limit_falls_back_to_default(
            self, monkeypatch):
        """C7: with no card visible and no positive setting, the port
        plans against the H100 80GB HBM3's total memory (the reference
        against its TPU's, which is no size of the port's card)."""
        monkeypatch.setenv("NOMAD_TPU_HBM_GB", "0")
        limit, src = PORT.hbm.device_limit_bytes()
        if src != "memory_stats":
            assert src == "default" and limit == 85_017_493_504
        assert PORT.hbm.DEFAULT_HBM_BYTES == 85_017_493_504
        ref_limit, ref_src = REF.hbm.device_limit_bytes()
        if ref_src != "memory_stats":
            assert ref_src == "default" and ref_limit == 16 * (1 << 30)
        # a positive setting wins in both, as the reference reads it
        monkeypatch.setenv("NOMAD_TPU_HBM_GB", "2")
        for p in BOTH:
            limit, src = p.hbm.device_limit_bytes()
            if src != "memory_stats":
                assert (limit, src) == (2 * (1 << 30), "env")
        monkeypatch.delenv("NOMAD_TPU_HBM_GB")
        if not torch.cuda.is_available():
            plan = PORT.hbm.plan_capacity(100_000, 1_000_000,
                                          PORT.hbm.HbmLedger())
            assert plan["device_limit_bytes"] == 85_017_493_504
            assert plan["limit_source"] == "default"

    def test_absurd_shard_width_reports_zero(self, monkeypatch):
        monkeypatch.setenv("NOMAD_TPU_HBM_GB", str(100_000 / (1 << 30)))
        plans, keep = {}, []
        for p in BOTH:
            led, bufs = _planner_ledger(p, view_shape=(64,), table=99_000,
                                        transient=0)
            keep.append(bufs)
            plans[p.name] = p.hbm.plan_capacity(1_000_000, 10, led)
        _compare_plans(plans["ref"], plans["port"])
        if plans["port"]["limit_source"] == "env":
            assert not plans["port"]["fits"]
            assert plans["port"]["shards_needed"] == 0


# ---- reconciliation, measurement, taxonomy on each package's own path ------


class TestReconciliation:
    def test_ledger_covers_allocator_growth(self, monkeypatch):
        """The plumbing in both packages; the coverage gate arms only
        where an allocator reports its numbers (the card: its twin is in
        tests/test_torch_cuda.py), so on the CPU it skips as the
        reference's does."""
        recs = {}
        for p in BOTH:
            led = _fresh_global_ledger(p, monkeypatch)
            devs0 = p.hbm.device_memory_stats()
            in_use0 = (sum(d["bytes_in_use"] for d in devs0)
                       if devs0 else None)
            rng = seeded(3)
            cl = p.cluster(mini_nodes())
            jobs = [mixed_job(rng, i) for i in range(3)]
            ids = [f"ev-{i}" for i in range(3)]
            for _ in range(2):
                _c, res = p.run_round(cl, jobs, eval_ids=ids)
                p.commit_round(cl, res, ids)
            rec = p.hbm.reconcile(led)
            assert rec["ledger_live_bytes"] == led.totals()[0] > 0
            recs[p.name] = (rec, in_use0)
        assert {k: v for k, v in recs["port"][0].items()
                if k != "ledger_live_bytes"} == \
            {k: v for k, v in recs["ref"][0].items()
             if k != "ledger_live_bytes"}
        rec, in_use0 = recs["port"]
        if in_use0 is None or rec["device_bytes_in_use"] is None:
            pytest.skip("backend exposes no memory_stats (CPU)")
        growth = rec["device_bytes_in_use"] - in_use0
        assert rec["ledger_live_bytes"] >= 0.9 * growth


class TestPlannerAgainstMeasurement:
    def test_2x_cluster_prediction_within_15pct(self, monkeypatch):
        """Project a 2x cluster from one cluster's measured per-row
        costs, then build and upload it: within 15 % in each package,
        and the two packages' plans and measurements equal."""
        got = {}
        for p in BOTH:
            led_a = _fresh_global_ledger(p, monkeypatch)
            cl_a = p.cluster(mini_nodes(48))     # n_cap 64
            p.make_stack(cl_a).device_arrays()
            assert led_a.totals()[0] > 0
            plan = p.hbm.plan_capacity(96, 1000, led_a)
            assert plan["measured"]
            led_b = _fresh_global_ledger(p, monkeypatch)
            cl_b = p.cluster(mini_nodes(96))     # n_cap 128
            p.make_stack(cl_b).device_arrays()
            gc.collect()
            measured = led_b.totals()[0]
            assert measured > 0
            predicted = plan["projected_bytes"]
            assert abs(predicted - measured) <= 0.15 * measured, \
                (p, predicted, measured)
            assert cl_a is not None and cl_b is not None
            got[p.name] = (plan, measured, led_b.snapshot())
        _compare_plans(got["ref"][0], got["port"][0])
        assert got["port"][1:] == got["ref"][1:]

    def test_100k_projection_shape(self, monkeypatch):
        plans = {}
        for p in BOTH:
            led = _fresh_global_ledger(p, monkeypatch)
            cl = p.cluster(mini_nodes())
            p.make_stack(cl).device_arrays()
            plans[p.name] = p.hbm.plan_capacity(100_000, 1_000_000, led)
        _compare_plans(plans["ref"], plans["port"])
        plan = plans["port"]
        assert plan["projected_n_cap"] == 131072
        assert plan["node_bytes"] > 0
        assert plan["shards_needed"] >= 1
        # the port bitmap (8 KB a row) dominates the per-node cost
        assert plan["per_node_bytes"] > 8192


#: the sites one fused round books (tests/test_hbm.py TestSiteTaxonomy)
TAXONOMY = {"stack.view_static", "stack.view_hot", "stack.view_ports",
            "program_table.i32", "program_table.f32", "program_table.u8",
            "select_batch.batch_out", "select_batch.carry"}


class TestSiteTaxonomy:
    def test_fused_loop_populates_expected_sites(self, monkeypatch):
        from nomad_tpu.analysis.vocab import ALLOWED_SITES as REF_SITES

        from nomad_tpu_torch.analysis.vocab import ALLOWED_SITES

        assert ALLOWED_SITES == REF_SITES
        sites = {}
        for p in BOTH:
            led = _fresh_global_ledger(p, monkeypatch)
            rng = seeded(11)
            cl = p.cluster(mini_nodes())
            jobs = [mixed_job(rng, i) for i in range(3)]
            _c, _res = p.run_round(cl, jobs,
                                   eval_ids=[f"e-{i}" for i in range(3)])
            sites[p.name] = set(led.snapshot())
        assert sites["port"] == sites["ref"]
        assert TAXONOMY <= sites["port"] <= ALLOWED_SITES
