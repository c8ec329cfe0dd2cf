"""Twins of the reference's `tests/test_trace_distributed.py`, run on the
port: every agent, server and harness is the port's with `device="cpu"`,
its HTTP port ephemeral and its data under `tmp_path`; the reference's
`slow` marks are kept.

The trace context, the span store's ring and long-poll, the SLO math and
the FSM's trace fields run through both packages on the same inputs and
compare what they return: a traceparent or wire context minted by one
package parses in the other to the same ids; the same spans recorded
give the same records, cursors and counts; the same observations against
the same injected clock give the same attainment, budget, burn rates and
flight events; the same raft log replayed gives the same fingerprint.
The three-server cases run the port's region (`tests/
test_torch_control_plane.py` `_make_cluster`) and hold it to the
reference's assertions: one parented tree across the forwarding hop,
nothing stamped with tracing off, the CLI's stitch.
"""
import threading
import time

import pytest

from nomad_tpu import mock as ref_mock
from nomad_tpu.lib import flight as ref_flight
from nomad_tpu.lib import metrics as ref_metrics
from nomad_tpu.lib import tracectx as ref_ctx
from nomad_tpu_torch import mock
from nomad_tpu_torch.analysis.vocab import SPAN_NAMES
from nomad_tpu_torch.api import NomadClient
from nomad_tpu_torch.lib import flight as port_flight
from nomad_tpu_torch.lib import metrics as port_metrics
from nomad_tpu_torch.lib import tracectx as port_ctx
from nomad_tpu_torch.lib.tracectx import (default_spans, format_traceparent,
                                          mint)
from torch_chain_cases import one_torch_thread  # noqa: F401

#: (name, tracectx, flight, metrics) of each package
PKGS = (("ref", ref_ctx, ref_flight, ref_metrics),
        ("port", port_ctx, port_flight, port_metrics))


def _wait(cond, timeout=20.0, every=0.05):
    dl = time.time() + timeout
    while time.time() < dl:
        if cond():
            return True
        time.sleep(every)
    return cond()


# ---- context + traceparent -------------------------------------------------


class TestTraceContext:
    def test_traceparent_round_trip(self):
        """A header minted by either package parses in both to the same
        ids."""
        for _n, a, _f, _m in PKGS:
            ctx = a.mint()
            header = a.format_traceparent(ctx)
            for _n2, b, _f2, _m2 in PKGS:
                back = b.parse_traceparent(header)
                assert back is not None
                assert (back.trace_id, back.span_id) == \
                    (ctx.trace_id, ctx.span_id)
            assert ref_ctx.format_traceparent(ctx) == header

    @pytest.mark.parametrize("bad", [
        None, 42, "", "garbage", "00-abc-def-01",
        "00-" + "a" * 31 + "-" + "b" * 16 + "-01",   # short trace id
        "00-" + "a" * 32 + "-" + "b" * 15 + "-01",   # short span id
        "00-" + "g" * 32 + "-" + "b" * 16 + "-01",   # non-hex
        "ff-" + "a" * 32 + "-" + "b" * 16 + "-01",   # forbidden version
        "00-" + "0" * 32 + "-" + "b" * 16 + "-01",   # all-zero trace
        "00-" + "a" * 32 + "-" + "0" * 16 + "-01",   # all-zero span
    ])
    def test_malformed_traceparent_is_none_never_raises(self, bad):
        assert port_ctx.parse_traceparent(bad) is None
        assert ref_ctx.parse_traceparent(bad) is None

    def test_mint_with_parent_continues_the_trace(self):
        for _n, a, _f, _m in PKGS:
            parent = a.mint()
            child = a.mint(parent)
            assert child.trace_id == parent.trace_id
            assert child.parent_span_id == parent.span_id
            assert child.span_id != parent.span_id
            assert (len(child.trace_id), len(child.span_id)) == (32, 16)

    def test_child_chain_keeps_one_trace_id(self):
        for _n, a, _f, _m in PKGS:
            root = a.mint()
            hop = root.child()
            leaf = hop.child()
            assert root.trace_id == hop.trace_id == leaf.trace_id
            assert leaf.parent_span_id == hop.span_id
            assert hop.parent_span_id == root.span_id

    def test_wire_round_trip_and_malformed_tolerance(self):
        """A context's wire form crosses between the packages intact;
        malformed wire input is None in both."""
        for _n, a, _f, _m in PKGS:
            ctx = a.mint().child()
            wire = ctx.to_wire()
            for _n2, b, _f2, _m2 in PKGS:
                back = b.TraceContext.from_wire(wire)
                assert back is not None and back.to_wire() == wire
            assert a.TraceContext.from_wire(wire) == ctx
        for bad in (None, [], "x", {}, {"t": "a"}, {"t": "", "s": ""},
                    {"t": 1, "s": 2}):
            for _n, a, _f, _m in PKGS:
                assert a.TraceContext.from_wire(bad) is None


# ---- SpanStore: the events.py ring/long-poll contract ----------------------


def _span(store, i, trace="t" * 32):
    return store.record("http.submit", trace_id=trace,
                        span_id=f"{i:016x}", start_unix=float(i),
                        end_unix=float(i) + 0.001)


def _ring_wrap(c):
    st = c.SpanStore(capacity=8)
    for i in range(20):
        _span(st, i)
    idx, out = st.spans_after(0)
    return idx, st.last_index(), out


def _cursor_past_wrap(c):
    st = c.SpanStore(capacity=8)
    for i in range(10):
        _span(st, i)
    _, first = st.spans_after(0)
    cursor = max(s["seq"] for s in first)
    for i in range(10, 26):
        _span(st, i)
    _, second = st.spans_after(cursor)
    return first, second


def _trace_filter(c):
    st = c.SpanStore(capacity=6)
    for i in range(12):
        _span(st, i, trace=("a" if i % 2 else "b") * 32)
    return st.spans_after(0, trace_id="a" * 32)[1]


def _counts(c):
    st = c.SpanStore(capacity=4)
    for i in range(10):
        _span(st, i)
    return st.counts(), st.snapshot()


def _both_stores(fn):
    got = {name: fn(c) for name, c, _f, _m in PKGS}
    assert got["port"] == got["ref"]
    return got["port"]


class TestSpanStoreRing:
    def test_wrap_keeps_newest_and_stays_monotonic(self):
        idx, last, out = _both_stores(_ring_wrap)
        assert [s["span_id"] for s in out] == [f"{i:016x}"
                                               for i in range(12, 20)]
        assert [s["seq"] for s in out] == list(range(13, 21))
        assert idx == 20 and last == 20

    def test_cursor_past_wrap_sees_no_duplicates(self):
        first, second = _both_stores(_cursor_past_wrap)
        seen = [s["seq"] for s in first] + [s["seq"] for s in second]
        assert len(seen) == len(set(seen)), "duplicate span seq"
        assert seen == sorted(seen), "spans out of seq order"

    def test_trace_filter_across_wrap(self):
        only = _both_stores(_trace_filter)
        assert only and all(s["trace_id"] == "a" * 32 for s in only)
        assert [s["seq"] for s in only] == sorted(s["seq"] for s in only)

    def test_long_poll_wakes_on_record(self):
        for _n, c, _f, _m in PKGS:
            st = c.SpanStore()
            _span(st, 0)
            idx = st.last_index()

            def later():
                time.sleep(0.15)
                _span(st, 1)

            threading.Thread(target=later, daemon=True).start()
            t0 = time.time()
            _, out = st.spans_after(idx, timeout=5.0)
            dt = time.time() - t0
            assert out and out[0]["span_id"] == f"{1:016x}"
            assert dt < 2.0, f"long-poll slept {dt:.2f}s past the record"

    def test_long_poll_times_out_empty(self):
        for _n, c, _f, _m in PKGS:
            st = c.SpanStore()
            t0 = time.time()
            idx, out = st.spans_after(0, timeout=0.2)
            assert out == [] and time.time() - t0 >= 0.15

    def test_unknown_span_name_rejected(self):
        assert port_ctx.SPAN_NAMES == ref_ctx.SPAN_NAMES
        for _n, c, _f, _m in PKGS:
            with pytest.raises(ValueError, match="unknown span name"):
                c.SpanStore().record("made.up", trace_id="t" * 32,
                                     span_id="s" * 16)

    def test_secret_shaped_detail_rejected(self):
        for _n, c, _f, _m in PKGS:
            with pytest.raises(ValueError, match="secret"):
                c.SpanStore().record(
                    "http.submit", trace_id="t" * 32, span_id="s" * 16,
                    detail={"node_secret_id": "hunter2"})

    def test_counts_survive_eviction(self):
        counts, snap = _both_stores(_counts)
        assert counts["http.submit"] == 10
        assert len(snap) == 4


# ---- SLO math, pinned against an injected clock ----------------------------


_SLO_ENV = {
    "NOMAD_TPU_SLO_OBJECTIVE": "0.9",
    "NOMAD_TPU_SLO_NORMAL_MS": "100",
    "NOMAD_TPU_SLO_HIGH_MS": "50",
    "NOMAD_TPU_SLO_LOW_MS": "1000",
    "NOMAD_TPU_SLO_FAST_S": "10",
    "NOMAD_TPU_SLO_SLOW_S": "100",
    "NOMAD_TPU_SLO_FAST_BURN": "5.0",
    "NOMAD_TPU_SLO_SLOW_BURN": "2.0",
}


def _slo_both(script):
    """`script(ctx module, FlightRecorder, MetricsRegistry)` through each
    package; the outputs must be equal."""
    got = {name: script(c, f.FlightRecorder, m.MetricsRegistry)
           for name, c, f, m in PKGS}
    assert got["port"] == got["ref"]
    return got["port"]


def _events(fl, idx0):
    _, evs = fl.records_after(idx0)
    return [(e["type"], e["key"], e["source"], e["severity"], e["detail"])
            for e in evs]


class TestSloMath:
    def test_priority_band_mapping_pinned(self):
        prios = (100, 70, 69, 50, 30, 29, 0)
        bands = _slo_both(lambda c, _f, _m: [c.slo_band(p) for p in prios])
        assert bands == ["high", "high", "normal", "normal", "normal",
                         "low", "low"]

    def test_env_knobs_and_band_targets(self):
        def script(c, _f, _m):
            t = c.SloTracker(env=_SLO_ENV)
            return (t.objective, t.target_ms,
                    t.observe(80, 60.0, now=0.0)["ok"],
                    t.observe(50, 60.0, now=0.0)["ok"])

        objective, targets, high_ok, normal_ok = _slo_both(script)
        assert objective == pytest.approx(0.9)
        assert targets == {"high": 50.0, "normal": 100.0, "low": 1000.0}
        assert high_ok is False and normal_ok is True

    def test_attainment_and_budget_exact(self):
        def script(c, _f, _m):
            t = c.SloTracker(env=_SLO_ENV)
            return (t.observe(50, 50.0, now=0.0),
                    t.observe(50, 200.0, now=1.0))

        first, miss = _slo_both(script)
        assert first["attainment"] == pytest.approx(1.0)
        assert first["budget_remaining"] == pytest.approx(1.0)
        assert miss["attainment"] == pytest.approx(0.5)
        assert miss["budget_remaining"] == pytest.approx(-4.0)
        assert miss["burn"]["fast"] == pytest.approx(5.0)
        assert miss["burn"]["slow"] == pytest.approx(5.0)

    def test_burn_edge_triggered_with_rearm(self):
        def script(c, flight_cls, _m):
            fl = flight_cls()
            t = c.SloTracker(flight=fl, source="s1", env=_SLO_ENV)
            idx0 = fl.last_index()
            outs = [t.observe(50, 50.0, now=0.0),
                    t.observe(50, 200.0, now=1.0),
                    t.observe(50, 200.0, now=2.0)]
            for i in range(3, 14):
                outs.append(t.observe(50, 50.0, now=float(i)))
            outs.append(t.observe(50, 200.0, now=40.0))
            return outs, _events(fl, idx0)

        outs, evs = _slo_both(script)
        assert {b["window"] for b in outs[1]["fired"]} == {"fast", "slow"}
        assert outs[2]["fired"] == [], "alert must be edge-triggered"
        assert outs[-2]["burn"]["fast"] < 5.0
        assert any(b["window"] == "fast" for b in outs[-1]["fired"])
        burns = [e for e in evs if e[0] == "slo.burn"]
        assert len(burns) >= 3 and all(e[1] == "normal" for e in burns)
        assert all(e[2] == "s1" for e in burns)
        assert {"window", "burn_rate", "threshold", "observations",
                "objective"} <= set(burns[0][4])

    def test_silent_at_baseline(self):
        def script(c, flight_cls, _m):
            fl = flight_cls()
            t = c.SloTracker(flight=fl, env=_SLO_ENV)
            idx0 = fl.last_index()
            outs = [t.observe(50, 50.0, now=float(i)) for i in range(100)]
            return outs, _events(fl, idx0)

        outs, evs = _slo_both(script)
        assert all(out["fired"] == [] for out in outs)
        assert outs[-1]["attainment"] == pytest.approx(1.0)
        assert outs[-1]["budget_remaining"] == pytest.approx(1.0)
        assert [e for e in evs if e[0] == "slo.burn"] == []

    def test_registry_series_update(self):
        def script(c, _f, registry_cls):
            reg = registry_cls()
            t = c.SloTracker(registry=reg, env=_SLO_ENV)
            before = reg.snapshot()
            t.observe(50, 50.0, now=0.0)
            t.observe(50, 200.0, now=1.0)
            after = reg.snapshot()
            return before["gauges"], after["counters"], after["gauges"], \
                after["histograms"]["slo.latency.normal_ms"]["count"]

        before, counters, gauges, n = _slo_both(script)
        for b in ("high", "normal", "low"):
            assert before["slo.attainment." + b] == 1.0
            assert before["slo.budget_remaining." + b] == 1.0
        assert counters["slo.observations"] == 2
        assert gauges["slo.attainment.normal"] == pytest.approx(0.5)
        assert n == 2


# ---- replica determinism: trace identity rides the raft entry --------------


class TestTraceReplicaDeterminism:
    """One log (the reference's structs, on the wire) replayed by both
    packages' FSMs under skewed clocks and seeds: equal fingerprints
    within and across the packages, and the trace fields covered."""

    def _log(self, alloc_span="aaaabbbbccccdddd"):
        from nomad_tpu.structs.codec import to_wire

        node = ref_mock.node()
        job = ref_mock.job()
        ev = ref_mock.eval_(job_id=job.id)
        ev.trace_id = "ab" * 16
        ev.trace_span_id = "cd" * 8
        ev.trace_parent_span_id = "ef" * 8
        alloc = ref_mock.alloc(job=job, node_id=node.id)
        alloc.eval_id = ev.id
        alloc.trace_id = ev.trace_id
        alloc.trace_span_id = alloc_span
        entries = [("upsert_node", [node]), ("upsert_job", [job]),
                   ("upsert_eval", [ev]), ("upsert_alloc", [alloc])]
        return [{"op": op, "args": [to_wire(a) for a in args]}
                for op, args in entries]

    def _replay(self, pkg, log, clock, seed):
        import random as _random
        from unittest import mock as um

        if pkg == "ref":
            from nomad_tpu.server.fsm import FSM, state_fingerprint
            from nomad_tpu.server.state import StateStore
        else:
            from nomad_tpu_torch.server.fsm import FSM, state_fingerprint
            from nomad_tpu_torch.server.state import StateStore

        state = StateStore()
        fsm = FSM(state)
        _random.seed(seed)
        with um.patch("time.time", lambda: clock):
            for entry in log:
                fsm.apply(entry)
        return state, state_fingerprint(state)

    def test_two_replicas_fingerprint_identical(self):
        log = self._log()
        fps = set()
        for pkg in ("ref", "port"):
            st1, fp1 = self._replay(pkg, log, 1.0e9, 1)
            _st2, fp2 = self._replay(pkg, log, 2.0e9, 2)
            assert fp1 == fp2, pkg
            evs = st1.evals()
            assert evs and evs[0].trace_id == "ab" * 16
            assert evs[0].trace_span_id == "cd" * 8
            allocs = list(st1._allocs.values())
            assert allocs and allocs[0].trace_id == "ab" * 16
            fps.add(fp1)
        assert len(fps) == 1, "the packages fingerprint one log apart"

    def test_fingerprint_covers_trace_identity(self):
        for pkg in ("ref", "port"):
            _, fp1 = self._replay(pkg, self._log(alloc_span="1" * 16),
                                  1.0e9, 1)
            _, fp2 = self._replay(pkg, self._log(alloc_span="2" * 16),
                                  1.0e9, 1)
            assert fp1 != fp2, \
                f"{pkg}: fingerprint gate is blind to alloc trace identity"


# ---- 3-server propagation: one tree across the forwarding hop --------------


@pytest.fixture()
def cluster3():
    from tests.test_torch_control_plane import _make_cluster

    agents, apis = _make_cluster(3)
    yield agents, apis
    for api in apis:
        api.shutdown()
    for a in agents:
        a.shutdown()


def _leader_of(agents):
    for a in agents:
        if a.is_leader():
            return a
    return None


class TestDistributedPropagation:
    def test_follower_submit_yields_one_parented_tree(self, cluster3):
        agents, apis = cluster3
        assert _wait(lambda: _leader_of(agents) is not None)
        leader = _leader_of(agents)
        fidx = next(i for i, a in enumerate(agents) if a is not leader)
        leader.call("node_register", mock.node())
        api = NomadClient(apis[fidx].addr[0], apis[fidx].addr[1])
        sdk = mint()  # the SDK caller's own context (traceparent header)
        out = api.register_job_traced(
            mock.job(), traceparent=format_traceparent(sdk))
        tid = out["trace_id"]
        assert tid == sdk.trace_id, \
            "ingress must continue the inbound traceparent"
        assert leader.server.wait_for_eval(out["eval_id"],
                                           timeout=30.0) is not None
        want = {"http.submit", "rpc.forward", "eval", "plan.apply"}
        store = default_spans()
        assert _wait(lambda: want <= {
            s["name"] for s in store.for_trace(tid)}), (
            want - {s["name"] for s in store.for_trace(tid)})
        recs = store.for_trace(tid)
        # ONE trace: every span reachable from the SDK root
        ids = {s["span_id"] for s in recs}
        orphans = [s for s in recs
                   if s["parent_span_id"] not in ids
                   and s["parent_span_id"] != sdk.span_id]
        assert not orphans, [(s["name"], s["parent_span_id"])
                             for s in orphans]
        by_name = {}
        for s in recs:
            by_name.setdefault(s["name"], []).append(s)
        sub = by_name["http.submit"][0]
        assert sub["parent_span_id"] == sdk.span_id
        assert sub["source"].startswith(agents[fidx].config.node_id + ".")
        ev = by_name["eval"][0]
        fwd = next(s for s in by_name["rpc.forward"]
                   if s["span_id"] == ev["parent_span_id"])
        assert fwd["parent_span_id"] == sub["span_id"]
        assert fwd["detail"]["method"] == "Server.job_register"
        assert ev["source"].startswith(leader.config.node_id + ".")
        phases = [s for s in recs if s["name"].startswith("eval.")]
        assert phases, "no scheduler phase spans mirrored"
        assert all(s["parent_span_id"] == ev["span_id"] for s in phases)
        pa = by_name["plan.apply"][0]
        assert pa["parent_span_id"] == ev["span_id"]
        assert pa["detail"]["placed"] >= 1
        assert {s["name"] for s in recs} <= SPAN_NAMES


    def test_trace_endpoint_and_cli_stitch(self, cluster3, capsys):
        from nomad_tpu_torch.cli import main as cli_main

        agents, apis = cluster3
        assert _wait(lambda: _leader_of(agents) is not None)
        leader = _leader_of(agents)
        fidx = next(i for i, a in enumerate(agents) if a is not leader)
        leader.call("node_register", mock.node())
        api = NomadClient(apis[fidx].addr[0], apis[fidx].addr[1])
        out = api.register_job_traced(mock.job())
        tid = out["trace_id"]
        assert leader.server.wait_for_eval(out["eval_id"],
                                           timeout=30.0) is not None
        # let the trace quiesce so the cursor check below can't race a
        # late span (the store is process-global, seq is global too)
        def _settled():
            n = len(api.trace(tid)["spans"])
            time.sleep(0.2)
            return len(api.trace(tid)["spans"]) == n

        assert _wait(_settled, timeout=10.0)
        # GET /v1/trace/:id on any server returns that trace's spans,
        # with the long-poll cursor shape of the event stream
        t = api.trace(tid)
        assert t["trace_id"] == tid and t["index"] >= len(t["spans"]) > 0
        assert all(s["trace_id"] == tid for s in t["spans"])
        # cursor past the end + no wait → empty, prompt
        t2 = api.trace(tid, index=t["index"])
        assert t2["spans"] == []
        # the CLI stitches across gossip-discovered servers: rc 0 and a
        # waterfall that names the hops
        addr = f"http://{apis[fidx].addr[0]}:{apis[fidx].addr[1]}"
        rc = cli_main(["-address", addr, "trace", tid])
        got = capsys.readouterr().out
        assert rc == 0
        for name in ("http.submit", "eval", "plan.apply"):
            assert name in got
        assert f"Trace {tid}" in got

    def test_cli_unknown_trace_exit_1_one_line(self, cluster3, capsys):
        from nomad_tpu_torch.cli import main as cli_main

        agents, apis = cluster3
        addr = f"http://{apis[0].addr[0]}:{apis[0].addr[1]}"
        rc = cli_main(["-address", addr, "trace", "f" * 32])
        cap = capsys.readouterr()
        assert rc == 1
        assert cap.err.startswith("Error:")
        assert "Traceback" not in cap.err



    def test_disabled_tracing_stamps_nothing(self, cluster3, monkeypatch):
        """NOMAD_TPU_TRACE=0: submits succeed, no trace id is returned,
        no span is recorded for the job."""
        monkeypatch.setenv("NOMAD_TPU_TRACE", "0")
        agents, apis = cluster3
        assert _wait(lambda: _leader_of(agents) is not None)
        leader = _leader_of(agents)
        api = NomadClient(apis[0].addr[0], apis[0].addr[1])
        before = default_spans().last_index()
        out = api.register_job_traced(mock.job())
        assert out["trace_id"] == ""
        assert leader.server.wait_for_eval(out["eval_id"],
                                           timeout=30.0) is not None
        _, recs = default_spans().spans_after(before)
        assert recs == [], [s["name"] for s in recs]


@pytest.mark.slow
class TestTraceSoak:
    """Sustained traced submits through the port's three-server region,
    every trace read back complete (a stitch rate of at least 0.99)."""

    def test_sustained_submits_stitch_rate(self, cluster3):
        agents, apis = cluster3
        assert _wait(lambda: _leader_of(agents) is not None)
        leader = _leader_of(agents)
        fidx = next(i for i, a in enumerate(agents) if a is not leader)
        leader.call("node_register", mock.node())
        api = NomadClient(apis[fidx].addr[0], apis[fidx].addr[1])
        outs = []
        for _ in range(40):
            out = api.register_job_traced(mock.job())
            assert out["trace_id"]
            outs.append(out)
        for out in outs:
            assert leader.server.wait_for_eval(out["eval_id"],
                                               timeout=60.0) is not None
        store = default_spans()
        stitched = 0
        for out in outs:
            tid = out["trace_id"]
            if not _wait(lambda t=tid: any(
                    s["name"] == "eval" for s in store.for_trace(t)),
                    timeout=10.0):
                continue
            recs = store.for_trace(tid)
            ids = {s["span_id"] for s in recs}
            roots = [s for s in recs if not s["parent_span_id"]]
            orphans = [s for s in recs
                       if s["parent_span_id"]
                       and s["parent_span_id"] not in ids]
            if len(roots) == 1 and not orphans:
                stitched += 1
        assert stitched / len(outs) >= 0.99, \
            f"stitch rate {stitched}/{len(outs)}"
