"""Twins of the reference's `tests/test_trace_distributed.py` the CLI cases
of `TestDistributedPropagation` (`trace` against a three-server region),
run on the port: every agent, server and harness is the port's with
`device="cpu"`, its HTTP port ephemeral and its data under `tmp_path`;
the reference's `slow` marks are kept.
"""
import threading
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.analysis.vocab import SPAN_NAMES
from nomad_tpu_torch.api import NomadClient
from nomad_tpu_torch.lib.flight import FlightRecorder
from nomad_tpu_torch.lib.tracectx import (SloTracker, SpanStore, TraceContext,
                                    default_spans, format_traceparent,
                                    mint, parse_traceparent, slo_band)
from torch_chain_cases import one_torch_thread  # noqa: F401


def _wait(cond, timeout=20.0, every=0.05):
    dl = time.time() + timeout
    while time.time() < dl:
        if cond():
            return True
        time.sleep(every)
    return cond()


# ---- context + traceparent -------------------------------------------------


# ---- SpanStore: the events.py ring/long-poll contract ----------------------


def _span(store, i, trace="t" * 32):
    return store.record("http.submit", trace_id=trace,
                        span_id=f"{i:016x}", start_unix=float(i),
                        end_unix=float(i) + 0.001)


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


# ---- replica determinism: trace identity rides the raft entry --------------


# ---- 3-server propagation: one tree across the forwarding hop --------------


@pytest.fixture()
def cluster3():
    from tests.test_control_plane import _make_cluster

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


