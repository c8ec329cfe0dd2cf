"""BENCHMARK.json against the contract's rules, and every part of a cell
found by name."""
from __future__ import annotations

import ast
import importlib
import json
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(harness.ROOT)
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ONE_LINE = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_and_units(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e and section != "end_to_end" and section != "per_layer":
                assert ONE_LINE.match(e[k]), e[k]
        if section == "per_layer":
            assert ONE_LINE.match(e["layer"])
            assert e["moves"] in {m["name"] for m in BENCH["end_to_end"]}
            assert e["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
        if section == "end_to_end":
            assert e["source"] in ("host_clock", "device_trace")
            assert 0.01 <= e["bound"] <= 0.25


def test_setup_s_and_one_other_metric_in_every_cell():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(cell):
    entry, config, workload = harness.load_cell(cell)
    assert entry["chips"] == 1
    assert config["name"] == entry["config"]
    assert workload["traffic"] == entry["traffic"]
    conf = {c["name"]: c for c in BENCH["configs"]}[entry["config"]]
    assert conf["reduced"] == config["reduced"]
    assert NAME.match(entry["traffic"]) and NAME.match(entry["config"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    mod = importlib.import_module(f"portbench.metrics.{metric}")
    assert callable(mod.read)
    cells = {w["name"] for w in BENCH["workloads"]}
    m = {x["name"]: x for x in BENCH["per_layer"]}[metric]
    assert set(m["workloads"]) <= cells


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "portbench").rglob("*.py")))
def test_no_module_imports_jax_or_the_jax_package(path):
    # whole top-level names: nomad_tpu_torch begins with nomad_tpu
    names = set(_imports(ROOT / path))
    assert not names & {"jax", "jaxlib", "flax", "nomad_tpu"}, names


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT))
    for p in (ROOT / "portbench" / "reference").rglob("*.py")))
def test_reference_imports_nothing_of_the_port(path):
    names = set(_imports(ROOT / path))
    assert not names & {"jax", "jaxlib", "flax", "nomad_tpu",
                        "nomad_tpu_torch", "portbench"}, names


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "nomad_tpu_torch_x",
                        types.ModuleType("nomad_tpu_torch_x"))
    assert "nomad_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "nomad_tpu.sub",
                        types.ModuleType("nomad_tpu.sub"))
    assert "nomad_tpu" in harness.forbidden_modules()
