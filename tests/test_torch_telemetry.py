"""Twins of the reference's `tests/test_telemetry.py` `TestHttpSurfaces`
and the agent case of `TestLabeledExposition` (the telemetry routes and
the agent's labeled exposition), run on the port: every agent, server
and harness is the port's with `device="cpu"`, its HTTP port ephemeral
and its data under `tmp_path`; the reference's `slow` marks are kept.
"""
import logging
import random
import socket
import threading
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.lib.metrics import (ErrorStreak, MetricsRegistry,
                                   StatsdSink, TelemetryEmitter, flatten)
from nomad_tpu_torch.lib.trace import EvalTracer
from torch_chain_cases import one_torch_thread  # noqa: F401


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
