"""The whole run on the CPU at a small size: the reference agrees with
the port, the lower-precision control and each planted fault
(`faults.py`) come out not correct, and the last line has the
contract's keys."""
from __future__ import annotations

import json

import pytest
import torch

from portbench import harness

from . import faults
from .small import run_small

LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_reference_agrees_with_the_port():
    out = run_small()
    assert out["correct"], out["checks"]
    for k in ("evals_incomplete", "alloc_count_err", "infeasible",
              "usage_gap", "overcommit", "rank_unjudged"):
        assert out["checks"][k]["value"] == 0.0, (k, out["checks"])
    assert out["checks"]["rank_gap"]["value"] < 1e-5, out["checks"]
    assert out["metrics"]["evals_per_s"]["value"] > 0


def test_lower_precision_control_is_not_correct():
    out = run_small(control=True)
    assert not out["correct"], out["checks"]
    for k in ("usage_gap", "rank_gap"):
        c = out["checks"][k]
        assert c["value"] > c["limit"], (k, c)


def test_last_line_keys():
    out = run_small()
    assert list(out) == LINE_KEYS
    assert list(out["metrics"]) == ["evals_per_s", "setup_s"]
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    traced = run_small(trace=True)
    assert list(traced)[-1] == "checks"
    bench = harness.manifest()
    layer = {m["name"] for m in bench["per_layer"]}
    assert set(traced["metrics"]) <= layer
    assert "gc_pause_ms" in traced["metrics"]


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "batch-5k.wide", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert not capsys.readouterr().out.strip()


@pytest.mark.parametrize("fault", faults.ALL, ids=lambda f: f.__name__)
def test_planted_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch.setattr)
    # a fault may leave evals that never finish: wait less for them
    monkeypatch.setattr(harness, "DRAIN_S", 10.0)
    out = run_small()
    assert not out["correct"], json.dumps(out["checks"])


def test_nothing_judged_is_not_correct(monkeypatch):
    # a dispatch route the harness cannot see leaves the ranking check
    # nothing to judge: the run does not pass for it
    monkeypatch.setattr(harness, "RANK_SAMPLE", 0)
    out = run_small()
    assert not out["correct"]
    assert out["checks"]["rank_unjudged"]["value"] > 0, out["checks"]
