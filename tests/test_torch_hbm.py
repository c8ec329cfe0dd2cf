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
"""
import gc
import time

import pytest

from torch_chain_cases import one_torch_thread  # noqa: F401
from torch_view_cases import (BOTH, PORT, dc_job, dc_nodes, mini_nodes,
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
