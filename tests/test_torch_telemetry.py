"""Twins of the reference's `tests/test_telemetry.py` `TestHttpSurfaces`
and the agent case of `TestLabeledExposition` (the telemetry routes and
the agent's labeled exposition), run on the port: every agent, server
and harness is the port's with `device="cpu"`, its HTTP port ephemeral
and its data under `tmp_path`; the reference's `slow` marks are kept.

And twins of `TestRegistry`, `TestTracer`, `TestE2ETrace`,
`TestStatsdRoundTrip` and the rest of `TestLabeledExposition`, each
running the same script through both packages' instruments and
comparing what they report: counts, sums, quantiles, expositions and
statsd lines exactly; traces by their phases and order (their times are
each run's own); the same evals through both packages' `Server`s (the
port's on the CPU), their traces' phases alike.
"""
import logging
import random
import socket
import threading
import time

import pytest

from nomad_tpu.lib import metrics as ref_metrics
from nomad_tpu.lib import trace as ref_trace
from nomad_tpu.lib import transfer as ref_transfer
from nomad_tpu.structs.codec import to_wire
from nomad_tpu_torch import mock
from nomad_tpu_torch.lib import metrics as port_metrics
from nomad_tpu_torch.lib import trace as port_trace
from nomad_tpu_torch.lib import transfer as port_transfer
from nomad_tpu_torch.structs.codec import from_wire
from torch_chain_cases import one_torch_thread  # noqa: F401

#: (name, metrics module, trace module, transfer module) of each package
PKGS = (("ref", ref_metrics, ref_trace, ref_transfer),
        ("port", port_metrics, port_trace, port_transfer))


def _both(fn):
    """`fn(metrics, trace, transfer)` through each package: {name: out}."""
    return {name: fn(m, t, x) for name, m, t, x in PKGS}


def _wait(cond, timeout=15.0, every=0.05):
    dl = time.time() + timeout
    while time.time() < dl:
        if cond():
            return True
        time.sleep(every)
    return cond()


class TestHttpSurfaces:
    @pytest.fixture()
    def agent(self, tmp_path):
        from nomad_tpu_torch.agent import Agent, AgentConfig
        from nomad_tpu_torch.api import NomadClient

        a = Agent(AgentConfig(data_dir=str(tmp_path / "data"),
                              heartbeat_ttl=60.0), device="cpu")
        a.start()
        api = NomadClient(a.http_addr[0], a.http_addr[1])
        assert _wait(lambda: len(api.nodes()) == 1)
        yield a, api
        a.shutdown()

    def _run_job(self, api):
        job = mock.job()
        t = job.task_groups[0].tasks[0]
        t.driver = "mock_driver"
        t.config = {"run_for": 0.05}
        eval_id = api.register_job(job)
        ev = api.wait_for_eval(eval_id)
        assert ev.status == "complete"
        return eval_id

    def test_trace_route_and_404(self, agent):
        from nomad_tpu_torch.api import ApiError

        a, api = agent
        eval_id = self._run_job(api)
        tr = api.evaluation_trace(eval_id)
        assert tr["eval_id"] == eval_id
        phases = [s["phase"] for s in tr["spans"]]
        for want in ("queue_wait", "schedule", "plan_apply", "ack"):
            assert want in phases
        assert phases[-1] == "ack"
        with pytest.raises(ApiError) as ei:
            api.evaluation_trace("does-not-exist")
        assert ei.value.code == 404

    def test_metrics_carries_phase_histograms(self, agent):
        a, api = agent
        self._run_job(api)
        m = api.metrics()
        assert m["broker"]["acked"] >= 1
        phases = m["eval_phases"]
        assert phases["queue_wait_ms"]["count"] >= 1
        for k in ("p50", "p95", "p99", "mean", "count"):
            assert k in phases["schedule_ms"]
        # registry snapshot is also exported wholesale
        assert "eval.phase.schedule_ms" in m["telemetry"]["histograms"]

    def test_metrics_prometheus_exposition(self, agent):
        a, api = agent
        self._run_job(api)
        text = api.metrics_prometheus()
        assert "# TYPE nomad_broker_acked counter" in text
        assert "# TYPE nomad_eval_phase_schedule_ms summary" in text
        assert 'nomad_eval_phase_schedule_ms{quantile="0.99"}' in text
        # every exposed line is well-formed: comment or `name value`
        for line in text.splitlines():
            assert line.startswith("# ") or len(line.split(" ")) == 2


class TestLabeledExposition:
    """Labeled Prometheus series for the transfer ledger + pipeline
    counters: label-value escaping lives in
    lib/metrics.py and is pinned here byte-for-byte."""


    def test_agent_exposition_carries_ledger_sites(self):
        """The agent's /v1/metrics?format=prometheus concatenation
        includes the process ledger's labeled family."""
        from nomad_tpu_torch.lib.transfer import default_ledger

        default_ledger().record("test.exposition_site", 11)
        from nomad_tpu_torch.agent import Agent, AgentConfig

        a = Agent(AgentConfig(client=False, heartbeat_ttl=60.0), device="cpu")
        a.start()
        try:
            text = a.metrics_prometheus()
        finally:
            a.shutdown()
        assert ('nomad_transfer_bytes_total{site="test.exposition_site"}'
                in text)


# ---- the registry ----------------------------------------------------------


def _concurrent(m, _t, _x):
    r = m.MetricsRegistry()
    n_threads, per = 8, 2000

    def work(tid):
        for k in range(per):
            r.inc("c")
            r.add_sample("h", k)
            r.set_gauge("g", k)
            r.counter(f"per.{tid}").inc()

    ts = [threading.Thread(target=work, args=(i,))
          for i in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    h = r.histogram("h")
    return (r.counter("c").value, h.count, h.sum,
            [r.counter(f"per.{i}").value for i in range(n_threads)])


def _quantiles(m, _t, _x):
    h = m.MetricsRegistry().histogram("h", window=2048)
    vals = list(range(1, 1001))
    random.Random(3).shuffle(vals)
    for v in vals:
        h.add(v)
    return h.summary()


def _window(m, _t, _x):
    h = m.MetricsRegistry().histogram("h", window=4)
    for v in range(1, 9):   # the window keeps 5, 6, 7, 8
        h.add(v)
    return h.summary(), h.quantile(1.0)


def _prefix_view(m, _t, _x):
    r = m.MetricsRegistry()
    r.inc("worker.0.batch.evals", 3)
    r.inc("worker.0.batch.kernel_ms", 1.5)
    r.inc("other", 9)
    view = r.counters(prefix="worker.0.batch.")
    return view, type(view["evals"]).__name__


def _exposition(m, _t, _x):
    r = m.MetricsRegistry()
    r.inc("broker.acked", 3)
    r.set_gauge("broker.ready", 2)
    for v in (1.0, 2.0, 3.0, 4.0):
        r.add_sample("eval.phase.kernel_ms", v)
    return r.prometheus()


class TestRegistry:
    def test_concurrent_writers_lose_nothing(self):
        got = _both(_concurrent)
        assert got["port"] == got["ref"] == (
            16000, 16000, 8 * sum(range(2000)), [2000] * 8)

    def test_histogram_quantiles_exact(self):
        got = _both(_quantiles)
        assert got["port"] == got["ref"]
        s = got["port"]
        assert (s["p50"], s["p95"], s["p99"]) == (500, 950, 990)
        assert s["min"] == 1 and s["max"] == 1000
        assert s["count"] == 1000 and s["sum"] == 500500
        assert s["mean"] == 500.5

    def test_histogram_window_slides(self):
        got = _both(_window)
        assert got["port"] == got["ref"]
        s, top = got["port"]
        assert s["count"] == 8 and s["min"] == 1 and s["max"] == 8
        assert s["p50"] == 6 and top == 8

    def test_counters_prefix_view(self):
        got = _both(_prefix_view)
        assert got["port"] == got["ref"] == (
            {"evals": 3, "kernel_ms": 1.5}, "int")

    def test_prometheus_exposition(self):
        got = _both(_exposition)
        assert got["port"] == got["ref"]
        lines = got["port"].splitlines()
        assert "# TYPE nomad_broker_acked counter" in lines
        assert "nomad_broker_acked 3" in lines
        assert "# TYPE nomad_broker_ready gauge" in lines
        assert "# TYPE nomad_eval_phase_kernel_ms summary" in lines
        assert 'nomad_eval_phase_kernel_ms{quantile="0.5"} 2' in lines
        assert 'nomad_eval_phase_kernel_ms{quantile="0.99"} 4' in lines
        assert "nomad_eval_phase_kernel_ms_sum 10" in lines
        assert "nomad_eval_phase_kernel_ms_count 4" in lines
        assert got["port"].endswith("\n")

    def test_error_streak_first_of_streak_warns(self, caplog):
        got = {}
        for name, m, _t, _x in PKGS:
            r = m.MetricsRegistry()
            es = m.ErrorStreak("unit.loop", registry=r)
            logger = ("nomad_tpu.loops" if name == "ref"
                      else "nomad_tpu_torch.loops")
            caplog.clear()
            with caplog.at_level(logging.DEBUG, logger=logger):
                es.record(ValueError("one"))
                es.record(ValueError("two"))
                es.ok()     # success re-arms the streak
                es.record(ValueError("three"))
            levels = [rec.levelno for rec in caplog.records
                      if rec.name == logger]
            got[name] = (levels.count(logging.WARNING),
                         levels.count(logging.DEBUG), es.count,
                         r.counter("loop_errors.unit.loop").value)
        assert got["port"] == got["ref"] == (2, 1, 3, 3)


# ---- the eval tracer -------------------------------------------------------


class TestTracer:
    def test_span_ordering_and_phase_histograms(self):
        got = {}
        for name, m, t, _x in PKGS:
            r = m.MetricsRegistry()
            tr = t.EvalTracer(r)
            tr.begin("e1")
            tr.span_from_mark("e1", "enqueue", "queue_wait")
            tr.mark("e1", "dequeue")
            with tr.span("e1", "schedule"):
                time.sleep(0.002)
            tr.record("e1", "ack")
            trace = tr.get("e1")
            starts = [sp["start_s"] for sp in trace["spans"]]
            assert starts == sorted(starts), name
            hist = r.snapshot()["histograms"]
            assert hist["eval.phase.schedule_ms"]["p50"] >= 2.0, name
            got[name] = ([sp["phase"] for sp in trace["spans"]],
                         sorted(trace), sorted(hist),
                         hist["eval.phase.schedule_ms"]["count"])
        assert got["port"] == got["ref"]
        assert got["port"][0] == ["queue_wait", "schedule", "ack"]

    def test_unknown_ids_are_noops(self):
        def ghost(m, t, _x):
            tr = t.EvalTracer(m.MetricsRegistry())
            tr.mark("ghost", "dequeue")
            tr.span_from_mark("ghost", "enqueue", "queue_wait")
            tr.record("ghost", "ack")
            return tr.get("ghost")

        assert _both(ghost) == {"ref": None, "port": None}

    def test_bounded_lru_evicts_oldest(self):
        def lru(m, t, _x):
            tr = t.EvalTracer(m.MetricsRegistry(), capacity=3)
            for i in range(5):
                tr.begin(f"e{i}")
                tr.record(f"e{i}", "ack")
            return ([tr.get(f"e{i}") is not None for i in range(5)],
                    sorted(tr.trace_ids()))

        got = _both(lru)
        assert got["port"] == got["ref"] == (
            [False, False, True, True, True], ["e2", "e3", "e4"])


# ---- one eval, then a batch, through both packages' servers ----------------

#: the phases every eval's trace carries once (tests/test_telemetry.py)
EVAL_PHASES = ("queue_wait", "claim", "snapshot", "schedule", "plan_apply",
               "ack")


def _server_traces(pkg, eval_batch, n_jobs):
    """The reference's TestE2ETrace run: 16 synthetic nodes, `n_jobs`
    service jobs of count 2, through `pkg`'s Server (the port's on the
    CPU); the same objects in both (the port's over the wire)."""
    from nomad_tpu.synth import synth_node, synth_service_job

    if pkg == "ref":
        from nomad_tpu.server import Server, ServerConfig

        conv, kw = (lambda o: o), {}
    else:
        from nomad_tpu_torch.server import Server, ServerConfig

        conv, kw = (lambda o: from_wire(to_wire(o))), {"device": "cpu"}
    rng = random.Random(11)
    s = Server(ServerConfig(num_schedulers=1, heartbeat_ttl=3600.0,
                            eval_batch=eval_batch), **kw)
    for i in range(16):
        s.state.upsert_node(conv(synth_node(rng, i)))
    jobs = [conv(synth_service_job(rng, count=2)) for _ in range(n_jobs)]
    evs = [s.job_register(j) for j in jobs]
    s.start()
    try:
        for ev in evs:
            got = s.wait_for_eval(
                ev.id, statuses=("complete", "failed", "blocked",
                                 "cancelled"), timeout=60.0)
            assert got is not None and got.status == "complete", got
        traces = [s.tracer.get(ev.id) for ev in evs]
        snap = s.metrics.snapshot()
        wstats = dict(s.workers[0].batch_stats)
    finally:
        s.shutdown()
    return traces, snap, wstats


def _assert_one_eval_trace(trace, snap):
    """test_single_eval_trace_complete_and_ordered's assertions."""
    assert trace is not None
    phases = [sp["phase"] for sp in trace["spans"]]
    for want in EVAL_PHASES:
        assert phases.count(want) == 1, (want, phases)
    assert phases[0] == "queue_wait" and phases[-1] == "ack"
    starts = [sp["start_s"] for sp in trace["spans"]]
    assert starts == sorted(starts)
    by = {sp["phase"]: sp for sp in trace["spans"]}
    sched, pa = by["schedule"], by["plan_apply"]
    assert sched["start_s"] <= pa["start_s"]
    assert (pa["start_s"] + pa["duration_ms"] / 1e3
            <= sched["start_s"] + sched["duration_ms"] / 1e3 + 1e-6)
    hists = snap["histograms"]
    for want in ("queue_wait", "schedule", "plan_apply", "ack"):
        assert hists[f"eval.phase.{want}_ms"]["count"] == 1


def _assert_batched_traces(traces, snap, wstats):
    """test_batched_evals_carry_pack_and_kernel_spans' assertions; returns
    the phase names the fused traces carry."""
    assert wstats.get("batched", 0) > 0, wstats
    fused = [t for t in traces if t is not None
             and "kernel" in [sp["phase"] for sp in t["spans"]]]
    assert fused, "no eval carried a kernel span despite batching"
    for t in fused:
        by = {sp["phase"]: sp for sp in t["spans"]}
        assert "pack" in by
        assert by["pack"]["start_s"] >= by["schedule"]["start_s"]
    hists = snap["histograms"]
    assert hists["eval.phase.kernel_ms"]["count"] >= len(fused)
    assert hists["eval.phase.pack_ms"]["count"] >= len(fused)
    return {sp["phase"] for t in fused for sp in t["spans"]}


class TestE2ETrace:
    def test_single_eval_trace_complete_and_ordered(self):
        got = {}
        for pkg in ("ref", "port"):
            (trace,), snap, _w = _server_traces(pkg, eval_batch=1, n_jobs=1)
            _assert_one_eval_trace(trace, snap)
            got[pkg] = [sp["phase"] for sp in trace["spans"]]
        assert got["port"] == got["ref"]

    def test_batched_evals_carry_pack_and_kernel_spans(self):
        """The batches form by timing in each server, so the twin holds
        each package to the reference's assertions and compares the
        phase names their fused traces carry."""
        got = {pkg: _assert_batched_traces(*_server_traces(
            pkg, eval_batch=8, n_jobs=12)) for pkg in ("ref", "port")}
        assert got["port"] == got["ref"]


# ---- statsd push and the labeled exposition --------------------------------


def _statsd(m, _t, _x):
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("127.0.0.1", 0))
    sock.settimeout(10.0)
    port = sock.getsockname()[1]
    reg = m.MetricsRegistry()
    reg.inc("broker.acked", 2)
    reg.add_sample("eval.phase.kernel_ms", 5.0)
    em = m.TelemetryEmitter(lambda: reg.snapshot(),
                            m.StatsdSink(f"127.0.0.1:{port}"),
                            interval=0.05)
    em.start()
    try:
        payload = sock.recv(65536).decode()
    finally:
        em.stop()
        sock.close()
    return sorted(payload.splitlines())


class TestStatsdRoundTrip:
    def test_registry_snapshot_reaches_statsd_socket(self):
        """registry → snapshot → flatten → UDP statsd gauge lines on a
        loopback socket: the same lines from both packages."""
        got = _both(_statsd)
        assert got["port"] == got["ref"]
        lines = got["port"]
        assert "nomad.counters.broker.acked:2|g" in lines
        assert "nomad.histograms.eval.phase.kernel_ms.count:1|g" in lines
        assert "nomad.histograms.eval.phase.kernel_ms.p50:5|g" in lines

    def test_flatten_skips_non_numeric(self):
        snap = {"a": {"b": 1, "s": "text"}, "ok": True}
        got = _both(lambda m, _t, _x: m.flatten(snap))
        assert got["port"] == got["ref"] == {"nomad.a.b": 1.0,
                                             "nomad.ok": 1.0}


class TestLabeledExpositionTwins:
    """Label escaping, the labeled line, the transfer ledger's family and
    the dispatch timeline's counters: byte for byte the reference's."""

    def test_escape_label_value(self):
        vals = ("plain.site", 'say "hi"', "a\\b", "line\nbreak", '\\"')
        got = _both(lambda m, _t, _x: [m.escape_label_value(v)
                                       for v in vals])
        assert got["port"] == got["ref"] == [
            "plain.site", 'say \\"hi\\"', "a\\\\b", "line\\nbreak",
            '\\\\\\"']

    def test_prometheus_line(self):
        def lines(m, _t, _x):
            return [m.prometheus_line("m", {}, 2.0),
                    m.prometheus_line("m", {"b": "2", "a": "1"}, 1.5),
                    m.prometheus_line("m", {"site": 'we"ird\\x'}, 3)]

        got = _both(lines)
        assert got["port"] == got["ref"] == [
            "m 2", 'm{a="1",b="2"} 1.5', 'm{site="we\\"ird\\\\x"} 3']

    def test_ledger_exposition_labels_and_escaping(self):
        def ledger(_m, _t, x):
            led = x.TransferLedger()
            led.record("stack.hot_delta", 100, seconds=0.001, count=2)
            led.record('odd"site\\n', 7)
            return led.prometheus(), x.TransferLedger().prometheus()

        got = _both(ledger)
        assert got["port"] == got["ref"]
        text, empty = got["port"]
        lines = text.splitlines()
        assert "# TYPE nomad_transfer_bytes_total counter" in lines
        assert 'nomad_transfer_bytes_total{site="stack.hot_delta"} 100' \
            in lines
        assert 'nomad_transfer_count_total{site="stack.hot_delta"} 2' \
            in lines
        assert 'nomad_transfer_ms_total{site="stack.hot_delta"} 1' in lines
        assert 'nomad_transfer_bytes_total{site="odd\\"site\\\\n"} 7' \
            in lines
        assert text.endswith("\n") and empty == ""

    def test_timeline_counters_reach_registry_exposition(self):
        def timeline(m, _t, x):
            reg = m.MetricsRegistry()
            tl = x.DispatchTimeline(registry=reg)
            b = tl.mono_anchor
            s1 = tl.commit(programs=2, batched=True, pack=(b, b + 0.001),
                           view=(b + 0.001, b + 0.002),
                           kernel_start=b + 0.002, transfer_bytes=64,
                           transfer_count=3)
            tl.kernel_end(s1, b + 0.004)
            return reg.prometheus()

        got = _both(timeline)
        assert got["port"] == got["ref"]
        text = got["port"]
        assert "# TYPE nomad_pipeline_dispatches counter" in text
        assert "nomad_pipeline_dispatches 1" in text
        assert "nomad_pipeline_transfer_bytes 64" in text
        assert "# TYPE nomad_pipeline_kernel_ms summary" in text
        assert "# TYPE nomad_pipeline_pack_ms summary" in text
