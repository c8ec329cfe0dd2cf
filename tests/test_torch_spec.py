"""Speculative dispatch and chain-carry adoption: the port against the
reference's `tests/test_spec.py`, twin by twin.

Every case runs the same cluster, rounds and commits through the
reference (`TPUStack`/`SelectCoordinator`, JAX on the CPU) and the port
(`TorchStack(device="cpu")`, its kernels' plain versions), asserts what
the reference's own test asserts on each, and holds the two to each
other: certification results, rolled-back and certified programs and the
`spec.*`/`view.*` counters exactly; node choices exactly and scores
within 1e-6; cached views bitwise, and equal to a cold upload. The
reference's `transfer_guard("disallow")` gate reads here as zero bytes at
the ledger's `stack.*` sites: the port's guard counts and forbids
nothing.

Covered: TestSpecGate, TestSpecChain, TestCertifyMapping,
TestSpecDispatchParity, TestChainCarryAdoption, TestDeltaLogWrap,
TestTimelineSpec (the same dispatch records through both packages'
`DispatchTimeline`: records and summaries equal) and TestSpecServerE2E
of the reference.
"""
import contextlib
import random

import numpy as np
import pytest
import torch

from nomad_tpu.synth import synth_node, synth_service_job
from torch_chain_cases import one_torch_thread  # noqa: F401
from torch_view_cases import (BOTH, PORT, REF, assert_same_placements,
                              assert_views_equal, dc_job, dc_mask, dc_nodes,
                              mini_nodes)

_SPEC_KEYS = ("spec.launches", "spec.certified", "spec.rolled_back",
              "spec.redispatch_programs")


def _twin(pkg_fn):
    """Run `pkg_fn(pkg)` for both packages; return {name: result}."""
    return {p.name: pkg_fn(p) for p in BOTH}


# ---- TestSpecGate -----------------------------------------------------------

class TestSpecGate:
    def test_enabled_env(self, monkeypatch):
        for p in BOTH:
            monkeypatch.delenv("NOMAD_TPU_SPECULATE", raising=False)
            assert p.sb.spec_enabled()
            monkeypatch.setenv("NOMAD_TPU_SPECULATE", "0")
            assert not p.sb.spec_enabled()
            monkeypatch.setenv("NOMAD_TPU_SPECULATE", "off")
            assert not p.sb.spec_enabled()

    @staticmethod
    def _trace(gate_cls, script):
        g = gate_cls(threshold=0.5)
        out = []
        for op in script:
            if op == "armed":
                out.append(g.armed())
            elif op == "miss":
                g.record_miss()
            else:
                g.record(op == "rolled")
        return out

    @pytest.mark.parametrize("script", [
        ["armed"] + ["rolled"] * 8 + ["armed"] * 10,          # storm
        ["ok", "armed"] * 64,                                 # healthy
        ["miss", "armed", "miss", "armed", "miss", "armed"],  # misses
        ["miss", "miss", "ok", "miss", "armed", "miss", "armed"],
    ], ids=["storm_cooldown", "healthy", "misses_disarm", "launch_clears"])
    def test_gate_decisions_match_reference(self, script):
        ref = self._trace(REF.sb.SpecGate, script)
        got = self._trace(PORT.sb.SpecGate, script)
        assert got == ref
        if script[1] == "rolled":
            # disarmed for COOLDOWN opportunities, then re-arms clean
            assert ref[1:] == [False] * (PORT.sb.SpecGate.COOLDOWN + 1) \
                + [True]

    def test_env_threshold(self, monkeypatch):
        monkeypatch.setenv("NOMAD_TPU_SPEC_ROLLBACK_MAX", "1.0")
        for p in BOTH:
            g = p.sb.SpecGate()
            for _ in range(32):
                g.record(True)
            assert g.armed()  # ratio can never exceed 1.0


# ---- TestSpecChain ----------------------------------------------------------

def _seed_chain(pkg, cl, token=9101, evals=("e1",), predicted=None,
                stops=()):
    """The device cache plus a carry note the chain can seed from; the
    carry tensors are copies of the view's (values are irrelevant to
    the bookkeeping under test)."""
    arrays = pkg.make_stack(cl).device_arrays()
    if pkg is REF:
        import jax.numpy as jnp

        u = jnp.asarray(np.asarray(arrays.used))
        d = jnp.asarray(np.asarray(arrays.dyn_free))
    else:
        u, d = arrays.used.clone(), arrays.dyn_free.clone()
    pkg.stack_mod.note_dispatch_carry(cl, token, arrays, list(evals),
                                      set(stops), u, d)
    if predicted is not None:
        pkg.stack_mod.carry_predicted(cl, token, predicted)
    return arrays, u, d


def _zeros(pkg):
    if pkg is REF:
        import jax.numpy as jnp

        return jnp.zeros(1)
    return torch.zeros(1)


def _commit_window(cl, eid, rows, token, clean=True, exact=True):
    v0 = cl.version
    if rows:
        cl._log_hot(*rows)
    cl.version += 1
    cl.mark_plan_window(eid, v0, cl.version, clean=clean, exact=exact,
                        token=token)


def _chain_case(name):
    """One TestSpecChain scenario for a package; returns what it
    observed (certify results, head tokens)."""

    def run(p):
        sm = p.stack_mod
        cl = p.cluster(mini_nodes())
        z = _zeros(p)
        out = []
        if name == "view_leased":
            arrays, u, d = _seed_chain(p, cl, predicted={"e1": {2}})
            view = sm.spec_chain_view(cl, lease_token=505)
            assert view is not None
            assert view.used is u and view.dyn_free is d
            assert view.capacity is arrays.capacity
            assert view.node_ok is arrays.node_ok
            with sm._DEV_CACHE_LOCK:
                assert 505 in p.cache_entry(cl)["leases"]
            sm.release_view(cl, 505)
            out.append(sm.spec_chain_head_token(cl))
            sm.spec_chain_reset(cl)
            return out
        if name == "no_carry":
            p.make_stack(cl).device_arrays()
            return [sm.spec_chain_view(cl, lease_token=1) is None]
        if name == "refresh_resets":
            _seed_chain(p, cl, predicted={"e1": set()})
            assert sm.spec_chain_view(cl, lease_token=1) is not None
            out.append(sm.spec_chain_head_token(cl))
            cl._log_hot(0)
            cl.version += 1
            sm.release_view(cl, 1)
            p.make_stack(cl).device_arrays()
            out.append(sm.spec_chain_view(cl, lease_token=2))
            out.append(sm.spec_chain_head_token(cl))
            sm.release_view(cl, 2)
            return out
        seeds = {"clean": ({"e1": {2}}, ()),
                 "foreign_ports_stops": ({"e1": {2}}, {7}),
                 "uncommitted": ({"e1": {5, 6}}, ()),
                 "inexact": ({"e1": {5}}, ()),
                 "unresolved": (None, ()),
                 "node_churn": ({"e1": set()}, ()),
                 "ring_wrap": ({"e1": {2}}, ())}
        predicted, stops = seeds[name]
        _seed_chain(p, cl, predicted=predicted, stops=stops)
        assert sm.spec_chain_view(cl, lease_token=1) is not None
        sm.spec_chain_advance(cl, 9202, ["e2"], set(), z, z)
        if name in ("clean", "foreign_ports_stops", "ring_wrap"):
            _commit_window(cl, "e1", {2}, 9101)
        if name == "inexact":
            _commit_window(cl, "e1", {5}, 9101, exact=False)
        if name == "node_churn":
            cl.node_version += 1
        if name == "foreign_ports_stops":
            cl._log_hot(3)
            cl.version += 1
            cl._log_ports(4, word=1)
            cl.ports_version += 1
        if name == "ring_wrap":
            for i in range(cl.PLAN_WINDOW_LEN + 8):
                cl.mark_plan_window(f"x{i}", cl.version, cl.version,
                                    clean=True, exact=False)
        out.append(sm.spec_chain_certify(cl))
        if name == "foreign_ports_stops":
            # stale is CUMULATIVE: a later certify still reports them
            sm.carry_predicted(cl, 9202, {"e2": set()})
            sm.spec_chain_advance(cl, 9303, ["e3"], set(), z, z)
            _commit_window(cl, "e2", set(), 9202)
            out.append(sm.spec_chain_certify(cl))
        sm.release_view(cl, 1)
        sm.spec_chain_reset(cl)
        out.append(cl.plan_window_observer is None)
        return out

    return run


#: what the reference's TestSpecChain asserts for each scenario
_CHAIN_EXPECT = {
    "view_leased": [9101],
    "no_carry": [True],
    "clean": [frozenset(), True],
    "foreign_ports_stops": [frozenset({3, 4, 7}), frozenset({3, 4, 7}),
                            True],
    "unresolved": [None, True],
    "node_churn": [None, True],
    "refresh_resets": [9101, None, None],
    "ring_wrap": [frozenset(), True],
}


class TestSpecChain:
    @pytest.mark.parametrize("name", sorted(_CHAIN_EXPECT) + [
        "uncommitted", "inexact"])
    def test_chain_bookkeeping_matches_reference(self, name):
        got = _twin(_chain_case(name))
        assert got["port"] == got["ref"]
        if name in _CHAIN_EXPECT:
            assert got["port"] == _CHAIN_EXPECT[name]
        elif name == "uncommitted":
            # e1's plan never committed: its predicted rows are phantom
            assert got["port"][0] is not None and {5, 6} <= got["port"][0]
        else:
            assert got["port"][0] is not None and 5 in got["port"][0]


# ---- TestCertifyMapping -----------------------------------------------------

class _FakeHolder:
    def __init__(self):
        self.resolved = 0

    def resolve(self):
        self.resolved += 1
        return ()


def _mask(n, *rows):
    m = np.zeros(n, dtype=bool)
    for r in rows:
        m[r] = True
    return m


def _certify_run(p, monkeypatch, stale, lanes, footprints, n=4):
    cl = p.cluster(mini_nodes(4))
    reg = p.metrics.MetricsRegistry()
    coord = p.sb.SelectCoordinator(registry=reg)
    coord.footprints = footprints
    reqs = [p.sb._SelectReq(None, None, 1, i) for i in range(n)]
    holder = _FakeHolder()
    spec = {"reqs": reqs, "idxs": None, "cluster": cl, "holder": holder,
            "token": 7, "lanes": lanes, "kernel_ms": 12.0, "seq": 1}
    monkeypatch.setattr(p.stack_mod, "spec_chain_certify",
                        lambda c: stale)
    redispatched = []
    monkeypatch.setattr(coord, "_dispatch",
                        lambda rs: redispatched.extend(rs))
    coord._certify_spec(spec)
    rolled = sorted(r.order for r in redispatched)
    certified = sorted(i for i, r in enumerate(reqs) if r.event.is_set())
    outs = [r.out for i, r in enumerate(reqs) if r.event.is_set()]
    assert all(o == (holder, i, 7) for o, i in zip(outs, certified))
    return rolled, certified, dict(reg.counters()), holder.resolved


_FP4 = {0: _mask(8, 0, 1), 1: _mask(8, 2, 3), 2: _mask(8, 4, 5),
        3: _mask(8, 6, 7)}

#: (stale, lanes, footprints, n) → the reference test's expected
#: (rolled, certified)
_MAPPING = {
    "lane_suffix": (frozenset({4}), [[0, 1], [2, 3]], _FP4, 4,
                    [2, 3], [0, 1]),
    "hit_position": (frozenset({2}), [[0, 1], [2, 3]],
                     {0: _mask(8, 0), 1: _mask(8, 2), 2: _mask(8, 4),
                      3: _mask(8, 6)}, 4, [1], [0, 2, 3]),
    "clean": (frozenset(), [[0, 1, 2, 3]], {i: None for i in range(4)}, 4,
              [], [0, 1, 2, 3]),
    "unknown_footprint": (frozenset({7}), [[0], [1]],
                          {0: _mask(8, 0), 1: None}, 2, [1], [0]),
    "unprovable": (None, [[0, 1], [2, 3]],
                   {i: _mask(8, i) for i in range(4)}, 4,
                   [0, 1, 2, 3], []),
}


class TestCertifyMapping:
    @pytest.mark.parametrize("name", sorted(_MAPPING))
    def test_rollback_mapping_matches_reference(self, name, monkeypatch):
        stale, lanes, fps, n, want_rolled, want_cert = _MAPPING[name]
        got = {p.name: _certify_run(p, monkeypatch, stale, lanes, fps, n)
               for p in BOTH}
        assert got["port"] == got["ref"]
        rolled, certified, c, resolved = got["port"]
        assert rolled == want_rolled and certified == want_cert
        if rolled:
            assert c["spec.rolled_back"] == 1
            assert c["spec.redispatch_programs"] == len(rolled)
            assert resolved == 1
            # wasted = the kernel share of the rolled programs
            assert c["spec.wasted_kernel_ms"] == pytest.approx(
                12.0 * len(rolled) / n)
        else:
            assert c["spec.certified"] == 1 and resolved == 0


# ---- TestSpecDispatchParity -------------------------------------------------

def _foreign(p, node_id):
    return p.alloc(node_id, job_id="foreign", cpu=123, memory_mb=64,
                   disk_mb=10)


def _round2(p, nodes, speculative, monkeypatch, foreign_dc=None):
    """Round 1 (dc-pinned pair) dispatch; then round 2 either
    SPECULATIVELY (launch against round 1's predicted carry, commit
    round 1, certify) or sequentially. `foreign_dc` injects a conflicting
    foreign commit on a node of that datacenter."""
    monkeypatch.setenv("NOMAD_TPU_SPEC_ROLLBACK_MAX", "1.0")
    cl = p.cluster(nodes)
    r1_ids = ["r1-a", "r1-b"]
    _c1, res1 = p.run_round(cl, [dc_job("dc1"), dc_job("dc2")],
                            eval_ids=r1_ids)
    r2_jobs = [dc_job("dc1", cpu=250), dc_job("dc2", cpu=250)]
    reg = p.metrics.MetricsRegistry()
    coord2 = p.coordinator(reg, ["r2-a", "r2-b"], {0: 0, 1: 1},
                           {0: dc_mask(cl, "dc1"), 1: dc_mask(cl, "dc2")})
    foreign = (next(nid for nid in cl.row_of
                    if cl.nodes[nid].datacenter == foreign_dc)
               if foreign_dc else None)
    if speculative:
        threads, res2 = p.start_parked(cl, r2_jobs, coord2)
        assert coord2.try_spec_launch(cl), "speculation never armed"
        p.commit_round(cl, res1, r1_ids)
        if foreign is not None:
            cl.upsert_alloc(_foreign(p, foreign))
        coord2.run()
    else:
        p.commit_round(cl, res1, r1_ids)
        if foreign is not None:
            cl.upsert_alloc(_foreign(p, foreign))
        threads, res2 = p.start_parked(cl, r2_jobs, coord2)
        coord2.run()
    for t in threads:
        t.join(30.0)
    p.stack_mod.spec_chain_reset(cl)
    c = reg.counters()
    return res2, {k: c.get(k, 0) for k in _SPEC_KEYS}, \
        c.get("spec.wasted_kernel_ms", 0)


class TestSpecDispatchParity:
    def test_certified_spec_bit_identical_to_sequential(self, monkeypatch):
        nodes = dc_nodes()
        out = {}
        for p in BOTH:
            spec_res, c, _w = _round2(p, nodes, True, monkeypatch)
            seq_res, _c, _w = _round2(p, nodes, False, monkeypatch)
            assert c["spec.launches"] == 1 and c["spec.certified"] == 1
            assert not c["spec.rolled_back"]
            for i in spec_res:   # node ids and scores, exactly
                assert spec_res[i][0] == seq_res[i][0], (p, i)
                assert spec_res[i][3] == seq_res[i][3], (p, i)
            out[p.name] = (spec_res, c)
        assert_same_placements(out["ref"][0], out["port"][0], "spec")
        assert out["ref"][1] == out["port"][1]

    def test_forced_conflict_rolls_back_only_affected_lane(self,
                                                           monkeypatch):
        nodes = dc_nodes()
        out = {}
        for p in BOTH:
            spec_res, c, wasted = _round2(p, nodes, True, monkeypatch,
                                          foreign_dc="dc1")
            seq_res, _c, _w = _round2(p, nodes, False, monkeypatch,
                                      foreign_dc="dc1")
            assert c["spec.launches"] == 1 and c["spec.rolled_back"] == 1
            # EXACT counting: only the dc1 program re-dispatched
            assert c["spec.redispatch_programs"] == 1
            assert wasted > 0
            for i in spec_res:
                assert spec_res[i][0] == seq_res[i][0], (p, i)
                assert spec_res[i][3] == seq_res[i][3], (p, i)
            out[p.name] = (spec_res, c)
        assert_same_placements(out["ref"][0], out["port"][0], "conflict")
        assert out["ref"][1] == out["port"][1]

    @pytest.mark.parametrize("blocker", ["env", "gate"])
    def test_opt_out_and_disarmed_gate_block_launch(self, blocker,
                                                    monkeypatch):
        nodes = dc_nodes()
        if blocker == "env":
            monkeypatch.setenv("NOMAD_TPU_SPECULATE", "0")
        placed = {}
        for p in BOTH:
            cl = p.cluster(nodes)
            if blocker == "gate":
                g = p.sb._gate_for(cl)
                for _ in range(p.sb.SpecGate.MIN_SAMPLES):
                    g.record(True)
            _c1, res1 = p.run_round(cl, [dc_job("dc1"), dc_job("dc2")],
                                    eval_ids=["a", "b"])
            coord2 = p.sb.SelectCoordinator(
                registry=p.metrics.MetricsRegistry())
            threads, res2 = p.start_parked(cl, [dc_job("dc1")], coord2)
            assert not coord2.try_spec_launch(cl)
            p.commit_round(cl, res1, ["a", "b"])
            coord2.run()
            for t in threads:
                t.join(30.0)
            assert res2[0][0][0] is not None
            placed[p.name] = res2
        assert_same_placements(placed["ref"], placed["port"], blocker)


# ---- TestChainCarryAdoption -------------------------------------------------

def _site_bytes(l0, l1, site):
    return (l1.get(site, {}).get("bytes", 0)
            - l0.get(site, {}).get("bytes", 0))


_HOT_SITES = ("stack.hot_full", "stack.hot_delta", "stack.static_full",
              "stack.ports_full")


def _adoption_case(name, p, monkeypatch, seed=3):
    """One TestChainCarryAdoption scenario; returns the observations to
    hold the packages to each other (view counters moved, ledger bytes
    per site, the refreshed view)."""
    nodes = dc_nodes()
    cl = p.cluster(nodes)
    if name == "adopt_opt_out":
        monkeypatch.setenv("NOMAD_TPU_SPEC_CHAIN_ADOPT", "0")
    rng = random.Random(seed)
    k = {"zero_resync": 3, "mid_chain": 3, "foreign_churn": 3,
         "node_growth": 2, "rebucket": 2, "partial_final": 2,
         "adopt_opt_out": 2, "randomized": rng.choice((1, 2, 3))}[name]
    reg, last_res, last_ids = p.drive_chain(cl, monkeypatch, k=k)
    c = reg.counters()
    assert c.get("spec.launches", 0) >= k
    assert c.get("spec.certified", 0) >= k
    assert not c.get("spec.rolled_back", 0)
    if name == "partial_final":
        p.commit_round(cl, last_res, last_ids, exact=False)
    elif name == "randomized":
        if rng.random() < 0.7:
            p.commit_round(cl, last_res, last_ids,
                           exact=rng.random() < 0.8,
                           clean=rng.random() < 0.8)
        for _ in range(rng.randrange(0, 4)):
            cl.upsert_alloc(_foreign(p, rng.choice(sorted(cl.row_of))))
        if rng.random() < 0.5:
            row = rng.choice(sorted(cl.row_of.values()))
            word = rng.randrange(0, 8)
            cl._log_ports(row, word=word)
            cl.ports_used[row, word] ^= np.uint32(1)
            cl.ports_version += 1
    elif name != "mid_chain":
        p.commit_round(cl, last_res, last_ids)
    if name == "foreign_churn":
        dc1 = next(nid for nid in sorted(cl.row_of)
                   if cl.nodes[nid].datacenter == "dc1")
        cl.upsert_alloc(_foreign(p, dc1))
        prow = cl.row_of[dc1]
        cl._log_ports(prow, word=3)
        cl.ports_used[prow, 3] ^= np.uint32(1)
        cl.ports_version += 1
    if name == "node_growth":
        from nomad_tpu import mock

        n = mock.node()
        n.id, n.datacenter = "grown-1", "dc1"
        cl.upsert_node(p.conv(n))
    if name == "rebucket":
        from nomad_tpu import mock

        n_cap0, i = cl.n_cap, 0
        while cl.n_cap == n_cap0:
            n = mock.node()
            n.id, n.datacenter = f"grown-{i}", "dc2"
            cl.upsert_node(p.conv(n))
            i += 1
    v0 = p.counters("view.")
    s0 = p.counters("spec.").get("resync_bytes_saved", 0)
    l0 = p.ledger()
    # the reference's zero-resync gate runs under transfer_guard
    # ("disallow"); the port's guard_scope only counts
    guard = (p.transfer.guard_scope("disallow") if name == "zero_resync"
             else contextlib.nullcontext())
    with guard:
        arrays = p.make_stack(cl).device_arrays()
    l1 = p.ledger()
    v1 = p.counters("view.")
    moved = {key: v1.get(key, 0) - v0.get(key, 0)
             for key in ("chain_adopts", "chain_rows", "chain_rejects",
                         "delta_rows", "full_uploads")}
    sites = {s: _site_bytes(l0, l1, s) for s in _HOT_SITES}
    saved = p.counters("spec.").get("resync_bytes_saved", 0) - s0
    view = p.view_np(arrays)
    assert_views_equal(view, p.cold_view(cl), f"{p} {name} vs cold")
    return moved, sites, saved, view


class TestChainCarryAdoption:
    @pytest.mark.parametrize("name", [
        "zero_resync", "mid_chain", "foreign_churn", "node_growth",
        "rebucket", "partial_final", "adopt_opt_out"])
    def test_adoption_matches_reference(self, name, monkeypatch):
        got = {p.name: _adoption_case(name, p, monkeypatch) for p in BOTH}
        (rm, rs, rsaved, rv), (pm, ps, psaved, pv) = got["ref"], got["port"]
        assert pm == rm
        assert_views_equal(rv, pv, f"{name} ref/port")
        assert (psaved > 0) == (rsaved > 0)
        if name == "zero_resync":
            # the chained steady state ships no hot or static bytes
            for site in _HOT_SITES:
                assert ps[site] == 0 and rs[site] == 0, site
            assert pm["chain_adopts"] == 1 and pm["chain_rows"] > 0
            assert psaved > 0
        elif name == "foreign_churn":
            assert pm["chain_adopts"] == 1
            assert ps["stack.hot_full"] == 0 and ps["stack.hot_delta"] > 0
        elif name == "rebucket":
            assert pm["chain_rejects"] == 1
        elif name == "adopt_opt_out":
            assert pm["chain_adopts"] == 0
            assert pm["chain_rejects"] == 0
        else:
            assert pm["chain_adopts"] == 1

    @pytest.mark.parametrize("seed", [3, 11, 23])
    def test_randomized_churn_parity(self, seed, monkeypatch):
        got = {p.name: _adoption_case("randomized", p, monkeypatch, seed)
               for p in BOTH}
        assert got["port"][0] == got["ref"][0]
        assert_views_equal(got["ref"][3], got["port"][3], f"seed {seed}")


# ---- TestDeltaLogWrap -------------------------------------------------------

class TestDeltaLogWrap:
    def test_env_knob_sizes_ring(self, monkeypatch):
        for p in BOTH:
            dll = p.cluster_mod.DELTA_LOG_LEN
            monkeypatch.setenv("NOMAD_TPU_DELTA_LOG", "16")
            cl = p.ClusterTensors()
            assert cl.delta_log_len == 16
            for i in range(40):
                cl._log_hot(i % 4)
                cl.version += 1
            assert len(cl._hot_log) == 16
            monkeypatch.setenv("NOMAD_TPU_DELTA_LOG", "not-a-number")
            assert p.ClusterTensors().delta_log_len == dll
            monkeypatch.setenv("NOMAD_TPU_DELTA_LOG", "3")
            assert p.ClusterTensors().delta_log_len == 8   # the floor
            monkeypatch.delenv("NOMAD_TPU_DELTA_LOG")
            assert p.ClusterTensors().delta_log_len == dll

    def test_wrap_mid_chain_counts_and_flight_records(self, monkeypatch):
        monkeypatch.setenv("NOMAD_TPU_DELTA_LOG", "8")
        details = {}
        for p in BOTH:
            from importlib import import_module

            flight = import_module(
                p.stack_mod.__name__.rsplit(".", 2)[0] + ".lib.flight")
            sm = p.stack_mod
            cl = p.cluster(dc_nodes())
            _seed_chain(p, cl, predicted={"e1": set()})
            assert sm.spec_chain_view(cl, lease_token=1) is not None
            z = _zeros(p)
            sm.spec_chain_advance(cl, 9202, ["e2"], set(), z, z)
            for i in range(12):   # wrap the 8-entry ring past the cursor
                cl._log_hot(i % 4)
                cl.version += 1
            w0 = p.counters("spec.").get("chain_unprovable_wrap", 0)
            idx0 = flight.default_flight().last_index()
            assert sm.spec_chain_certify(cl) is None
            assert p.counters("spec.").get(
                "chain_unprovable_wrap", 0) == w0 + 1
            _i, evs = flight.default_flight().records_after(idx0)
            recs = [e for e in evs if e["type"] == "spec.rollback"
                    and e.get("detail", {}).get("reason")
                    == "delta_log_wrap"]
            assert recs, f"{p}: wrap never flight-recorded"
            d = recs[0]["detail"]
            assert d["log"] == "hot" and d["log_len"] == 8
            assert "NOMAD_TPU_DELTA_LOG" in d["finding"]
            details[p.name] = {k: d[k] for k in ("log", "checked_version",
                                                 "version_now", "log_len")}
            sm.release_view(cl, 1)
            sm.spec_chain_reset(cl)
        assert details["port"] == details["ref"]


# ---- TestTimelineSpec -------------------------------------------------------


def _timeline_twin(script):
    """`script(DispatchTimeline, MetricsRegistry)` through both packages;
    returns the port's (records, summary), which must equal the
    reference's."""
    got = {p.name: script(p.transfer.DispatchTimeline,
                          p.metrics.MetricsRegistry) for p in BOTH}
    assert got["port"] == got["ref"]
    return got["port"]


def _commit(tl, pack, kernel_start, programs=1, speculative=False):
    return tl.commit(programs=programs, batched=True, pack=pack,
                     view=(pack[1], pack[1] + 0.001),
                     kernel_start=kernel_start, transfer_bytes=0,
                     transfer_count=0, speculative=speculative)


def _by_seq(tl):
    return {r["seq"]: {k: v for k, v in r.items()
                       if k not in ("start_s", "start_unix")}
            for r in tl.records_after(0)[1]}


class TestTimelineSpec:
    def test_rolled_back_kernel_is_wasted_not_overlap(self):
        def script(timeline, registry):
            tl = timeline(registry())
            s1 = _commit(tl, (0.0, 0.001), 0.002)
            tl.kernel_end(s1, 0.010)
            # speculative: host prep hidden under kernel 1
            s2 = _commit(tl, (0.003, 0.004), 0.005, speculative=True)
            tl.kernel_end(s2, 0.020)
            before = _by_seq(tl)[s2]
            tl.spec_resolve(s2, "rolled_back")
            after = _by_seq(tl)[s2]
            # a successor overlapping the wasted kernel: no win either
            s3 = _commit(tl, (0.006, 0.007), 0.021)
            tl.kernel_end(s3, 0.025)
            return before, after, _by_seq(tl)[s3], tl.summary()

        before, after, r3, summ = _timeline_twin(script)
        assert before["speculative"] and before["overlap_ms"] > 0
        assert after["spec_outcome"] == "rolled_back"
        assert after["overlap_ms"] == 0.0   # hiding bought nothing
        assert r3["overlap_ms"] == 0.0
        assert summ["spec"] == {"launched": 1, "certified": 0,
                                "rolled_back": 1,
                                "wasted_kernel_ms": pytest.approx(15.0)}

    def test_partial_rollback_wastes_only_its_share(self):
        def script(timeline, registry):
            tl = timeline(registry())
            s1 = _commit(tl, (0.0, 0.001), 0.002, programs=4)
            tl.kernel_end(s1, 0.010)
            s2 = _commit(tl, (0.003, 0.004), 0.005, programs=4,
                         speculative=True)
            tl.kernel_end(s2, 0.025)
            tl.spec_resolve(s2, "rolled_back", wasted_frac=0.25)
            return _by_seq(tl)[s2], tl.summary()

        r2, summ = _timeline_twin(script)
        assert r2["spec_outcome"] == "rolled_back"
        assert r2["spec_wasted_frac"] == 0.25
        assert r2["overlap_ms"] > 0   # its certified slices were real
        assert summ["spec"]["rolled_back"] == 1
        # a 20 ms kernel, a quarter of it rolled back
        assert summ["spec"]["wasted_kernel_ms"] == pytest.approx(5.0)
        assert summ["overlap_ms_total"] > 0

    def test_certified_spec_counts_as_real_overlap(self):
        def script(timeline, registry):
            tl = timeline(registry())
            s1 = _commit(tl, (0.0, 0.001), 0.002)
            tl.kernel_end(s1, 0.010)
            s2 = _commit(tl, (0.003, 0.004), 0.005, speculative=True)
            tl.spec_resolve(s2, "certified")
            tl.kernel_end(s2, 0.012)
            return _by_seq(tl)[s2], tl.summary()

        r2, summ = _timeline_twin(script)
        assert summ["spec"]["certified"] == 1
        assert summ["spec"]["wasted_kernel_ms"] == 0
        assert summ["overlap_ms_total"] > 0
        # no device idle between kernel 1 landing and the queued
        # speculative kernel: bubble_ms 0
        assert r2["bubble_ms"] == 0.0


# ---- TestSpecServerE2E ------------------------------------------------------

def _spec_feed(p, monkeypatch, speculate, n_jobs=24, eval_batch=8,
               seed=29, nodes=48, revoke_dc1=False):
    """One pipelined server run over a deterministic pre-enqueued
    dc-pinned feed (tests/test_spec.py `_spec_feed`); returns
    (placements {(job, alloc index): (node name, score)}, counters,
    planner stats, leases left)."""
    monkeypatch.delenv("NOMAD_TPU_EVAL_BATCH", raising=False)
    monkeypatch.setenv("NOMAD_TPU_DRAIN_WINDOW_MS", "50")
    monkeypatch.setenv("NOMAD_TPU_SPEC_PARK_MS", "2000")
    monkeypatch.setenv("NOMAD_TPU_SPEC_ROLLBACK_MAX", "1.0")
    monkeypatch.setenv("NOMAD_TPU_SPECULATE", "1" if speculate else "0")
    if revoke_dc1:
        gs = p.generic.GenericScheduler
        orig = gs._certify_carry_exact

        def revoke(self, alloc, ask):
            if list(getattr(self.job, "datacenters", ())) == ["dc1"]:
                self.plan.carry_exact = False
            else:
                orig(self, alloc, ask)

        monkeypatch.setattr(gs, "_certify_carry_exact", revoke)
    if p is REF:
        from nomad_tpu.server import Server, ServerConfig

        kw = {}
    else:
        from nomad_tpu_torch.server import Server, ServerConfig

        kw = {"device": "cpu"}
    rng = random.Random(seed)
    s = Server(ServerConfig(num_schedulers=1, heartbeat_ttl=3600.0,
                            eval_batch=eval_batch), **kw)
    leases0 = p.hbm.default_hbm().outstanding_leases()
    for i in range(nodes):
        s.state.upsert_node(p.conv(synth_node(rng, i)))
    s.broker.set_enabled(False)
    jobs, evs = [], []
    for i in range(n_jobs):
        j = synth_service_job(rng, count=1, datacenter=f"dc{1 + i % 3}")
        j.task_groups[0].tasks[0].resources.cpu = 50
        j.task_groups[0].tasks[0].resources.memory_mb = 64
        j = p.conv(j)
        jobs.append(j)
        evs.append(s.job_register(j))
    s.start()
    s._restore_evals()
    try:
        for ev in evs:
            got = s.wait_for_eval(
                ev.id, statuses=("complete", "failed", "blocked",
                                 "cancelled"), timeout=300.0)
            assert got is not None and got.status == "complete", got
        names = {nid: nd.name for nid, nd in s.state._nodes.items()}
        placements = {}
        for ji, j in enumerate(jobs):
            for a in s.state.allocs_by_job("default", j.id):
                score = None
                for sm in a.metrics.score_meta:
                    if sm.node_id == a.node_id:
                        score = float(sm.norm_score)
                placements[(ji, a.name.rsplit("[", 1)[1])] = (
                    names.get(a.node_id, a.node_id), score)
        counters = dict(s.metrics.counters())
        stats = dict(s.planner.stats)
        leases = p.hbm.default_hbm().outstanding_leases() - leases0
    finally:
        s.shutdown()
    return placements, counters, stats, leases


def _same_feed(a, b, what):
    assert a and set(a) == set(b), what
    for k in a:
        assert a[k][0] == b[k][0], (what, k)
        assert a[k][1] == pytest.approx(b[k][1], abs=1e-6), (what, k)


class TestSpecServerE2E:
    def test_parity_speculation_on_vs_off(self, monkeypatch):
        """The same pipelined feed with speculation on vs off, in both
        packages: placements identical across all four runs,
        speculation engaged, no leaked leases."""
        runs = {}
        for p in BOTH:
            on, c_on, st_on, leases_on = _spec_feed(p, monkeypatch, True)
            off, c_off, st_off, _l = _spec_feed(p, monkeypatch, False)
            assert c_on.get("spec.launches", 0) >= 1, \
                f"{p}: speculation never engaged"
            assert c_on.get("spec.certified", 0) >= 1
            assert not c_off.get("spec.launches", 0)
            _same_feed(on, off, f"{p} on/off")
            assert st_on.get("partial", 0) == st_off.get("partial", 0)
            assert leases_on == 0
            runs[p.name] = on
        _same_feed(runs["ref"], runs["port"], "ref/port")

    def test_forced_conflict_server_converges(self, monkeypatch):
        """Carry certification revoked for every dc1 plan in both runs:
        the speculative run rolls back affected programs only and still
        places exactly like the sequential run, in both packages."""
        runs = {}
        for p in BOTH:
            with monkeypatch.context() as m:
                on, c_on, _st, leases_on = _spec_feed(p, m, True,
                                                      revoke_dc1=True)
                off, _c, _st2, _l = _spec_feed(p, m, False, revoke_dc1=True)
            assert c_on.get("spec.launches", 0) >= 1
            assert c_on.get("spec.rolled_back", 0) >= 1, \
                f"{p}: forced conflict never rolled back"
            redisp = c_on.get("spec.redispatch_programs", 0)
            assert 1 <= redisp < 24, f"{p}: rollback not slice-granular"
            _same_feed(on, off, f"{p} on/off")
            assert leases_on == 0
            runs[p.name] = on
        _same_feed(runs["ref"], runs["port"], "ref/port")

    @pytest.mark.slow
    def test_loaded_window_soak_spec_steady_state(self, monkeypatch):
        """Soak (slow, as the reference's): a 192-eval pre-enqueued
        window keeps the port's speculation chain healthy."""
        on, c_on, st, leases = _spec_feed(PORT, monkeypatch, True,
                                          n_jobs=192, eval_batch=16)
        assert c_on.get("spec.launches", 0) >= 5
        assert c_on.get("spec.certified", 0) >= 5
        assert not c_on.get("spec.rolled_back", 0)
        assert st.get("partial", 0) == 0
        assert leases == 0
