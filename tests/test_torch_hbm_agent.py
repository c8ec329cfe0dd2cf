"""Twins of the reference's `tests/test_hbm.py` `TestOperatorSurface` and
`TestCliHbm` (the residency ledger through the agent and the CLI), run
on the port: every agent, server and harness is the port's with
`device="cpu"`, its HTTP port ephemeral and its data under `tmp_path`;
the reference's `slow` marks are kept.
"""
import gc
import random
import time
import uuid

import numpy as np
import pytest

from nomad_tpu_torch.lib.hbm import (HbmLedger, default_hbm, device_memory_stats,
                               plan_capacity, reconcile)
from nomad_tpu_torch.lib.metrics import MetricsRegistry

from torch_chain_cases import one_torch_thread  # noqa: F401


def _view_stack(cl):
    from nomad_tpu_torch.scheduler.stack import TorchStack

    return TorchStack(cl, device="cpu")


def _fresh_global_ledger(monkeypatch):
    """Swap the process-global ledger for a fresh one so prior tests'
    still-referenced clusters don't pollute measurements (the stack
    resolves default_hbm() per call)."""
    import nomad_tpu_torch.lib.hbm as hbm_mod

    led = HbmLedger(registry=MetricsRegistry())
    monkeypatch.setattr(hbm_mod, "_default_hbm", led)
    return led


class TestOperatorSurface:
    """GET /v1/operator/hbm + SDK shape (the agent fixture idiom of
    test_agent_http.py, kept here so the whole residency surface tests
    in one file)."""

    @pytest.fixture()
    def agent(self, tmp_path):
        from nomad_tpu_torch.agent import Agent, AgentConfig
        from nomad_tpu_torch.api import NomadClient

        a = Agent(AgentConfig(data_dir=str(tmp_path / "data"),
                              heartbeat_ttl=60.0), device="cpu")
        a.start()
        api = NomadClient(a.http_addr[0], a.http_addr[1])
        yield a, api
        a.shutdown()

    def test_endpoint_shape(self, agent):
        a, api = agent
        out = api.operator_hbm()
        assert set(out) >= {"summary", "sites", "shards",
                            "reconciliation"}
        assert "leases" not in out
        summ = out["summary"]
        for k in ("live_bytes", "buffers", "peak_bytes",
                  "outstanding_leases", "lease_high_water",
                  "lease_watermark_s"):
            assert k in summ
        rec = out["reconciliation"]
        assert "ledger_live_bytes" in rec and "coverage_pct" in rec

    def test_watermarks_param(self, agent):
        a, api = agent
        out = api.operator_hbm(watermarks=True)
        assert isinstance(out["leases"], list)

    def test_plan_param_and_validation(self, agent):
        from nomad_tpu_torch.api import ApiError

        a, api = agent
        out = api.operator_hbm(plan=(2000, 10_000))
        plan = out["plan"]
        assert plan["nodes"] == 2000 and plan["allocs"] == 10_000
        assert {"projected_bytes", "fits", "shards_needed",
                "headroom_bytes"} <= set(plan)
        # malformed plan args are a 400, not a 500
        with pytest.raises(ApiError) as e:
            api.operator_hbm(plan=(0, 5))
        assert "400" in str(e.value) or "plan needs" in str(e.value)

    def test_metrics_carries_hbm_sections(self, agent):
        a, api = agent
        m = api.metrics()
        assert "hbm" in m and "hbm_sites" in m
        assert "outstanding_leases" in m["hbm"]


class TestCliHbm:
    """CLI `operator hbm` (the eval trace / operator timeline exit-1
    convention; the happy path is covered via the agent fixture)."""

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

    def test_malformed_plan_args_exit_one(self):
        # validated before any connection: no agent needed
        for argv in (("operator", "hbm", "-plan"),
                     ("operator", "hbm", "-plan", "-nodes", "100"),
                     ("operator", "hbm", "-plan", "-nodes", "0",
                      "-allocs", "5"),
                     ("operator", "hbm", "-plan", "-nodes", "10",
                      "-allocs", "-1")):
            rc, out, err = self._run("127.0.0.1:1", *argv)
            assert rc == 1, argv
            assert err.startswith("Error:"), argv
            assert "Traceback" not in err

    def test_unreachable_agent_exits_one(self):
        rc, out, err = self._run("127.0.0.1:1", "operator", "hbm")
        assert rc == 1
        assert err.startswith("Error:")

    def test_happy_path_with_plan(self, tmp_path):
        from nomad_tpu_torch.agent import Agent, AgentConfig

        a = Agent(AgentConfig(data_dir=str(tmp_path / "data"),
                              heartbeat_ttl=60.0), device="cpu")
        a.start()
        try:
            addr = f"{a.http_addr[0]}:{a.http_addr[1]}"
            rc, out, err = self._run(addr, "operator", "hbm",
                                     "-watermarks", "-plan",
                                     "-nodes", "100000",
                                     "-allocs", "1000000")
            assert rc == 0, err
            assert "Live" in out and "Leases" in out
            assert "Plan for 100000 nodes" in out
            rc, out, err = self._run(addr, "operator", "hbm", "-json")
            assert rc == 0 and '"summary"' in out
        finally:
            a.shutdown()
