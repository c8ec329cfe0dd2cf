"""Twins of the reference's `tests/test_explain.py`
`TestBlockedEvalExhaustionE2E` and `TestCliRobustness` (placement
explain through the agent and the CLI), run on the port: every agent,
server and harness is the port's with `device="cpu"`, its HTTP port
ephemeral and its data under `tmp_path`; the reference's `slow` marks
are kept.
"""
import random
import threading
import time

import numpy as np
import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.scheduler.oracle import (OracleContext, explain_select,
                                        select_option)
from nomad_tpu_torch.scheduler.stack import TorchStack
from nomad_tpu_torch.structs import Constraint, NetworkResource, Port

from test_kernel_parity import make_cluster, placed_alloc, seed_allocs
from torch_chain_cases import one_torch_thread  # noqa: F401

SEED = 7


# ---- 1. free: bit-identity ------------------------------------------------


# ---- 2. honest: kernel vs oracle ------------------------------------------


def _oracle_ctx(cl, nodes, seeded):
    abn = {}
    for a in seeded:
        abn.setdefault(a.node_id, []).append(a)
    return OracleContext(nodes=nodes, allocs_by_node=abn)


# ---- 2b. coordinator path -------------------------------------------------


# ---- 3. surfaced: AllocMetric end to end ----------------------------------


def _wait(cond, timeout=15.0, every=0.05):
    dl = time.time() + timeout
    while time.time() < dl:
        if cond():
            return True
        time.sleep(every)
    return cond()


@pytest.fixture()
def agent(tmp_path):
    from nomad_tpu_torch.agent import Agent, AgentConfig
    from nomad_tpu_torch.api import NomadClient

    a = Agent(AgentConfig(data_dir=str(tmp_path / "data"),
                          heartbeat_ttl=60.0), device="cpu")
    a.start()
    api = NomadClient(a.http_addr[0], a.http_addr[1])
    assert _wait(lambda: len(api.nodes()) == 1)
    yield a, api
    a.shutdown()


def _mock_job(cpu=100, count=1):
    job = mock.job()
    tg = job.task_groups[0]
    tg.count = count
    t = tg.tasks[0]
    t.driver = "mock_driver"
    t.config = {"run_for": 0.05}
    t.resources.cpu = cpu
    return job


class TestBlockedEvalExhaustionE2E:
    """Satellite: a saturated cluster blocks an eval whose status
    reports the exhausted dimension end-to-end — broker → scheduler →
    blocked tracker → HTTP/SDK/CLI."""

    def test_blocked_eval_reports_dimension(self, agent):
        a, api = agent
        job = _mock_job(cpu=10**7)
        eval_id = api.register_job(job)
        ev = api.wait_for_eval(eval_id)
        assert ev.status == "complete"
        assert ev.failed_tg_allocs
        m = next(iter(ev.failed_tg_allocs.values()))
        assert m.dimension_exhausted.get("cpu") == 1
        assert ev.blocked_eval

        # blocked eval carries the attribution too (broker → blocked)
        blocked = api.evaluation(ev.blocked_eval)
        assert blocked.status == "blocked"
        bm = next(iter(blocked.failed_tg_allocs.values()))
        assert bm.dimension_exhausted.get("cpu") == 1

        # blocked tracker live diagnostics + metrics surface
        assert a.server.blocked.dimension_stats().get("cpu", 0) >= 1
        metrics = api.metrics()
        assert metrics["blocked_dimensions"].get("cpu", 0) >= 1
        # monotonic counter families with Prometheus exposition
        text = api.metrics_prometheus()
        assert "nomad_scheduler_exhausted_cpu" in text
        assert "nomad_scheduler_blocked_cpu" in text

        # /placement endpoint (SDK decode): failure attribution
        out = api.evaluation_placement(eval_id)
        fm = next(iter(out["failed_tg_allocs"].values()))
        assert fm.dimension_exhausted.get("cpu") == 1
        assert out["blocked_eval"] == ev.blocked_eval
        assert out["placements"] == []

    def test_placement_endpoint_for_successful_eval(self, agent):
        a, api = agent
        job = _mock_job(cpu=50, count=2)
        eval_id = api.register_job(job)
        ev = api.wait_for_eval(eval_id)
        assert ev.status == "complete"
        out = api.evaluation_placement(eval_id)
        assert len(out["placements"]) == 2
        for p in out["placements"]:
            m = p["metrics"]
            assert m.nodes_evaluated == 1
            assert m.score_meta
            assert m.score_meta[0].norm_score == pytest.approx(
                m.score_meta[0].scores["normalized-score"])

    def test_placement_endpoint_404(self, agent):
        from nomad_tpu_torch.api import ApiError

        a, api = agent
        with pytest.raises(ApiError):
            api.evaluation_placement("no-such-eval")


class TestCliRobustness:
    """Satellite: `eval trace`, `eval placement`, `operator timeline`
    exit 1 with a one-line error on unknown/missing ids or an
    unreachable agent — never a traceback."""

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

    def test_unknown_ids_exit_one(self, agent):
        a, api = agent
        addr = f"{a.http_addr[0]}:{a.http_addr[1]}"
        for argv in (("eval", "trace", "nope"),
                     ("eval", "placement", "nope")):
            rc, out, err = self._run(addr, *argv)
            assert rc == 1, argv
            assert err.startswith("Error:"), argv
            assert "Traceback" not in err

    def test_unreachable_agent_exits_one(self):
        # nothing listens on this port: connection errors must be a
        # one-line error, not an OSError traceback
        for argv in (("eval", "trace", "x"),
                     ("eval", "placement", "x"),
                     ("operator", "timeline"),
                     ("operator", "hbm")):
            rc, out, err = self._run("127.0.0.1:1", *argv)
            assert rc == 1, argv
            assert err.startswith("Error:"), argv

    def test_eval_placement_happy_path(self, agent):
        a, api = agent
        addr = f"{a.http_addr[0]}:{a.http_addr[1]}"
        job = _mock_job(cpu=10**7)
        eval_id = api.register_job(job)
        api.wait_for_eval(eval_id)
        rc, out, err = self._run(addr, "eval", "placement", eval_id)
        assert rc == 0, err
        assert "cpu=1" in out
        assert "Failed placements:" in out
