"""nomadlint on the port (`nomad_tpu_torch/analysis`) — its tier-1 gate
and the twins of `tests/test_lint.py` for every rule it ports.

- The rules copied as they stand (NLT01–06, NLR01–04, NLS01, NLV01,
  NLW00, NLP00) are held against the reference's engine: both engines
  read the reference's fixtures (`tests/lint_fixtures/`) under the same
  scope-relative paths and must give the same (rule, line, context).
- The torch rules (NLJ05, NLD01, NLD03, NLD04) are pinned on fixtures of
  their own (`tests/torch_lint_fixtures/`): exact (rule, line) pairs from
  the trailing `# NLxxx` markers, and silent near-miss fixtures.
- The port's tree is clean against the empty `lint_baseline_torch.json`,
  its waivers all active and reasoned, within 10 s of CPU, and the
  analyzer imports neither torch nor jax nor the reference package (one
  whole-tree run, in a child where none of them can be imported).
"""
import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from nomad_tpu.analysis.core import analyze_file as ref_analyze_file
from nomad_tpu_torch.analysis import (ALL_RULES, Finding, compare_to_baseline,
                                      load_baseline, write_baseline)
from nomad_tpu_torch.analysis.__main__ import main as lint_main
from nomad_tpu_torch.analysis.core import analyze_file, baseline_key

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "nomad_tpu_torch")
BASELINE = os.path.join(REPO, "lint_baseline_torch.json")
REF_FIXTURES = os.path.join(REPO, "tests", "lint_fixtures")
FIXTURES = os.path.join(REPO, "tests", "torch_lint_fixtures")

_MARKER = re.compile(r"#\s*(NL[A-Z]\d\d)\b")

#: the rules the port copies as they stand
COPIED = {"NLT01", "NLT02", "NLT03", "NLT04", "NLT05", "NLT06", "NLR01",
          "NLR02", "NLR03", "NLR04", "NLS01", "NLV01", "NLW00", "NLP00"}


def _scope_rel(*parts):
    """Synthetic repo-relative path mapping a fixture into a rule scope
    of the port — assembled at runtime so the citations checker does not
    read these as real repo paths."""
    return "/".join(("nomad_tpu_torch",) + parts)


def _expected_markers(path):
    out = set()
    with open(path) as f:
        for i, line in enumerate(f, start=1):
            for rule in _MARKER.findall(line):
                out.add((rule, i))
    return out


def _analyze_fixture(name, rel):
    path = os.path.join(FIXTURES, name)
    with open(path) as f:
        tree = ast.parse(f.read(), filename=rel)
    return analyze_file(path, rel, tree=tree)


#: the one whole-tree run of this module, in a child where torch, jax and
#: the reference package cannot be imported: run_tree over the port with
#: its CPU time, the ratchet, and the `--stats` text
_CHILD = r"""
import contextlib, io, json, sys, time
for m in ("torch", "jax", "jaxlib", "nomad_tpu"):
    sys.modules[m] = None  # any import of them now raises
import nomad_tpu_torch.lib.flight  # imports analysis.vocab on every start
flight_loads_engine = "nomad_tpu_torch.analysis.core" in sys.modules
from nomad_tpu_torch.analysis import compare_to_baseline, load_baseline
from nomad_tpu_torch.analysis import run_tree
from nomad_tpu_torch.analysis.__main__ import _print_stats
from nomad_tpu_torch.analysis.core import default_baseline_path, default_root
stats = {}
t0 = time.process_time()
findings = run_tree(default_root(), stats=stats)
cpu = time.process_time() - t0
new = compare_to_baseline(findings, load_baseline(default_baseline_path()))
text = io.StringIO()
with contextlib.redirect_stdout(text):
    _print_stats(findings, stats)
heavy = sorted(m for m, mod in sys.modules.items() if mod is not None
               and m.split(".")[0] in ("torch", "jax", "jaxlib", "nomad_tpu"))
print(json.dumps({
    "flight_loads_engine": flight_loads_engine, "cpu": cpu,
    "files": stats["files"], "heavy": heavy,
    "findings": [[f.rule, f.path, f.render()] for f in findings],
    "new": [f.render() for f in new],
    "waivers": [w.as_dict() for w in stats["waivers"]],
    "stats_text": text.getvalue()}))
"""


@pytest.fixture(scope="module")
def tree_run():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


# ---- held against the reference: the copied rules ----

#: (fixture, scope-relative path under either package)
REFERENCE_CASES = [
    ("fixture_thread_violations.py", ("server", "fixture.py")),
    ("fixture_thread_clean.py", ("server", "fixture_clean.py")),
    ("fixture_lock_violations.py", ("raft", "fixture.py")),
    ("fixture_lock_clean.py", ("raft", "fixture_clean.py")),
    ("fixture_replica_violations.py", ("raft", "fixture_replica.py")),
    ("fixture_replica_clean.py", ("raft", "fixture_replica_clean.py")),
    ("fixture_secret_violations.py", ("raft", "fixture_secret.py")),
    ("fixture_secret_clean.py", ("raft", "fixture_secret_clean.py")),
    ("fixture_vocab_violations.py", ("lib", "fixture.py")),
    ("fixture_vocab_clean.py", ("lib", "fixture_clean.py")),
    # the reference's device and jax fixtures under the port's scopes:
    # the copied rules must agree there too (silent, both)
    ("fixture_device_violations.py", ("scheduler", "stack.py")),
    ("fixture_jax_violations.py", ("kernels", "fixture.py")),
]


def _both_engines(name, parts):
    path = os.path.join(REF_FIXTURES, name)
    ref = ref_analyze_file(path, "/".join(("nomad_tpu",) + parts))
    port = analyze_file(path, _scope_rel(*parts))
    key = lambda fs: sorted((f.rule, f.line, f.context)  # noqa: E731
                            for f in fs if f.rule in COPIED)
    return key(ref), key(port)


@pytest.mark.parametrize("name, parts", REFERENCE_CASES,
                         ids=[c[0] for c in REFERENCE_CASES])
def test_copied_rules_equal_the_reference_on_its_fixtures(name, parts):
    ref, port = _both_engines(name, parts)
    assert port == ref
    if "violations" in name and name.split("_")[1] in (
            "thread", "lock", "replica", "secret", "vocab"):
        assert port, "non-vacuous: the reference's fixture has findings"
        want = _expected_markers(os.path.join(REF_FIXTURES, name))
        assert {(r, ln) for r, ln, _c in port} == want


@pytest.mark.parametrize("src, rule", [
    ("import threading\n"
     "class C:\n"
     "    def __init__(self, cb):\n"
     "        self.cb = cb\n"
     "        self._lk = threading.Lock()\n"
     "    def m(self):\n"
     "        with self._lk:\n"
     "            self.cb()  # nomadlint: ok NLT05\n", "NLW00"),
    ("def broken(:\n    pass\n", "NLP00"),
])
def test_waiver_and_parse_findings_equal_the_reference(tmp_path, src, rule):
    p = tmp_path / "mod.py"
    p.write_text(src)
    ref = ref_analyze_file(str(p), "/".join(("nomad_tpu", "raft",
                                             "mod.py")))
    port = analyze_file(str(p), _scope_rel("raft", "mod.py"))
    key = lambda fs: sorted((f.rule, f.line, f.context)  # noqa: E731
                            for f in fs)
    assert key(port) == key(ref)
    assert rule in {f.rule for f in port}


def test_the_copied_rule_tables_are_the_references():
    from nomad_tpu.analysis import ALL_RULES as REF_RULES

    assert {r: ALL_RULES[r] for r in COPIED} \
        == {r: REF_RULES[r] for r in COPIED}
    # the port's set: the copied rules and its torch counterparts only
    assert set(ALL_RULES) == COPIED | {"NLJ05", "NLD01", "NLD03", "NLD04"}


# ---- the torch rules on their own fixtures ----

TORCH_CASES = [
    ("fixture_torch_violations.py", ("kernels", "fixture.py")),
    ("fixture_device_violations.py", ("scheduler", "stack.py")),
]
CLEAN_CASES = [
    ("fixture_torch_clean.py", ("kernels", "fixture_clean.py")),
    ("fixture_device_clean.py", ("scheduler", "stack.py")),
]


@pytest.mark.parametrize("name, parts", TORCH_CASES,
                         ids=[c[0] for c in TORCH_CASES])
def test_torch_fixture_findings_exact(name, parts):
    found = _analyze_fixture(name, _scope_rel(*parts))
    want = _expected_markers(os.path.join(FIXTURES, name))
    assert want
    assert {(f.rule, f.line) for f in found} == want


@pytest.mark.parametrize("name, parts", CLEAN_CASES,
                         ids=[c[0] for c in CLEAN_CASES])
def test_torch_clean_fixtures_are_silent(name, parts):
    assert _analyze_fixture(name, _scope_rel(*parts)) == []


def test_device_rules_cover_every_torch_form():
    """Each form the rules name is caught at least once in the fixture:
    uploads, fetches, the wait, an unbooked allocation, the folds."""
    found = _analyze_fixture("fixture_device_violations.py",
                             _scope_rel("scheduler", "stack.py"))
    msgs = " ".join(f.message for f in found)
    for form in (".to(<device>)", ".cuda()", "torch.as_tensor(device=",
                 "to_device_async", ".copy_(<host tensor>)", ".cpu()",
                 ".item()", ".tolist()", ".to(cpu)",
                 "<host tensor>.copy_(<device tensor>)", ".numpy()",
                 "synchronize()", "self._ti = torch.zeros",
                 "torch.sum()", "torch.mean()", ".sum()", "arithmetic"):
        assert form in msgs, form


def test_rules_stay_out_of_their_scopes():
    """Outside the device path the torch rules are silent: the same
    violations under agent/ raise no NLD or NLJ."""
    found = _analyze_fixture("fixture_device_violations.py",
                             _scope_rel("agent", "fixture.py"))
    assert not [f for f in found if f.rule[:3] in ("NLD", "NLJ")]


def test_waiver_with_reason_suppresses_and_is_counted(tmp_path):
    src = ("import torch\n"
           "def f(ev):\n"
           "    ev.synchronize()  # nomadlint: ok NLJ05 a benchmark "
           "boundary, documented\n")
    p = tmp_path / "waived.py"
    p.write_text(src)
    stats = {}
    found = analyze_file(str(p), _scope_rel("kernels", "waived.py"),
                         stats=stats)
    assert found == []
    (w,) = stats["waivers"]
    assert w.rule == "NLJ05" and w.used and w.reason.startswith("a bench")


def test_waiver_without_reason_is_a_finding(tmp_path):
    src = ("import torch\n"
           "def f(ev):\n"
           "    ev.synchronize()  # nomadlint: ok NLJ05\n")
    p = tmp_path / "bad_waiver.py"
    p.write_text(src)
    found = analyze_file(str(p), _scope_rel("kernels", "bad_waiver.py"))
    assert sorted(f.rule for f in found) == ["NLJ05", "NLW00"]


def test_inline_suppression(tmp_path):
    src = ("import torch\n"
           "def f():\n"
           "    torch.cuda.synchronize()  # nomadlint: disable=NLJ05\n")
    p = tmp_path / "suppressed.py"
    p.write_text(src)
    assert analyze_file(str(p), _scope_rel("kernels", "supp.py")) == []


# ---- the port's tree: the tier-1 ratchet ----

def test_port_tree_has_no_new_findings(tree_run):
    assert tree_run["new"] == [], \
        "NEW lint findings over lint_baseline_torch.json:\n" \
        + "\n".join(tree_run["new"])
    assert tree_run["findings"] == []


def test_analyzer_imports_neither_torch_jax_nor_the_reference(tree_run):
    assert tree_run["heavy"] == []
    assert not tree_run["flight_loads_engine"], \
        "importing lib/flight.py loaded the rule engine"


def test_port_baseline_is_empty_and_its_own():
    with open(BASELINE) as f:
        data = json.load(f)
    assert data["findings"] == {}
    assert "python -m nomad_tpu_torch.analysis --write-baseline" \
        in data["comment"]
    from nomad_tpu_torch.analysis.core import default_baseline_path

    assert os.path.samefile(default_baseline_path(), BASELINE)


def test_port_waivers_are_all_active_and_reasoned(tree_run):
    waivers = tree_run["waivers"]
    assert waivers
    assert [w for w in waivers if not w["used"]] == []
    assert [w for w in waivers if not w["reason"]] == []


def test_stats_show_a_clean_tree_and_live_waivers(tree_run):
    out = tree_run["stats_text"]
    assert "findings by rule: clean" in out
    assert "0 stale" in out
    assert "NO REASON" not in out


def test_analyzer_cpu_budget(tree_run):
    """The whole analyzer stays under 10 s of CPU over the port. CPU
    time, not wall time: a loaded tier-1 run stretches the wall clock."""
    assert tree_run["files"] > 100
    assert tree_run["cpu"] < 10.0, tree_run["cpu"]


def test_ratchet_fails_on_new_violation(tmp_path):
    baseline = load_baseline(BASELINE)
    extra = Finding("nomad_tpu_torch/kernels/placement.py", 1, "NLJ05",
                    "injected", context="")
    assert compare_to_baseline([extra], baseline) == [extra]
    p = tmp_path / "bl.json"
    write_baseline(str(p), [extra])
    assert compare_to_baseline([extra], load_baseline(str(p))) == []
    assert compare_to_baseline([extra, extra],
                               load_baseline(str(p))) == [extra]
    assert baseline_key(extra) in load_baseline(str(p))
    with open(p) as f:
        assert "nomad_tpu_torch.analysis" in json.load(f)["comment"]


def test_transfer_sites_stay_in_the_vocabulary(tree_run):
    """C5: the lane routes' argument table books at a site of the
    reference's vocabulary — NLV01 silent on the port, and the rule still
    catches the pre-repair site."""
    assert not [f for f in tree_run["findings"] if f[0] == "NLV01"]
    src = ("from ..lib.transfer import default_ledger\n"
           "def _lane_args(raw, dev, up):\n"
           "    with default_ledger().timed(\"kernels.place_args\", 8):\n"
           "        return up(raw, dev)\n")
    tree = ast.parse(src)
    found = analyze_file("placement.py", _scope_rel("kernels",
                                                    "placement.py"),
                         tree=tree, source=src)
    assert [(f.rule, f.line) for f in found] == [("NLV01", 3)]


def test_wave_fold_stays_bitwise(tree_run):
    """The plain wave fold (kernels/placement.py place_table_wave_plain)
    folds by torch.where: NLD04 silent on the port's kernels, and the
    rule catches the arithmetic fold in the fixture."""
    assert not [f for f in tree_run["findings"] if f[0] == "NLD04"]
    with open(os.path.join(PKG, "kernels", "placement.py")) as f:
        src = f.read()
    assert "changed.to(torch.int32).sum(dim=0)" in src
    fixture = _analyze_fixture("fixture_device_violations.py",
                               _scope_rel("scheduler", "stack.py"))
    assert any(f.rule == "NLD04" and f.context == "arithmetic_lane_fold"
               for f in fixture)


_TRACING = ("torch.compile", "torch.jit", "torch.func", "torch.vmap",
            "torch._dynamo")


def test_the_port_traces_nothing():
    """torch_rules leaves NLJ01–04 and NLJ06–09 out because no code of
    the port runs under a trace: no torch.compile, torch.jit,
    torch.func or torch.vmap call or import exists in it."""
    from nomad_tpu_torch.analysis.core import dotted

    bad = []
    for dirpath, _dirs, files in os.walk(PKG):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            with open(path) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Attribute):
                    names.append(dotted(node))
                elif isinstance(node, ast.Import):
                    names += [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names += [f"{node.module}.{a.name}" for a in node.names]
                for d in names:
                    if d.startswith(_TRACING):
                        bad.append(f"{path}:{node.lineno}: {d}")
    assert not bad, bad


# ---- the CLI ----

def test_cli_fail_on_new_clean_then_dirty(tmp_path, capsys):
    """End-to-end CLI ratchet on a kernels-only copy (the copy root is
    still named nomad_tpu_torch, so the hot-path scope holds)."""
    dst = tmp_path / "nomad_tpu_torch"
    shutil.copytree(os.path.join(PKG, "kernels"), dst / "kernels",
                    ignore=shutil.ignore_patterns("__pycache__", "csrc"))
    argv = [str(dst), "--baseline", BASELINE, "--fail-on-new"]
    assert lint_main(argv) == 0
    assert lint_main([str(dst)]) == 0
    assert "finding(s)" in capsys.readouterr().out
    with open(dst / "kernels" / "placement.py", "a") as f:
        f.write("\n\ndef _lint_canary(x):\n"
                "    torch.cuda.synchronize()\n"
                "    return x\n")
    assert lint_main(argv) == 2
    assert "NLJ05" in capsys.readouterr().out


@pytest.mark.parametrize("rule, fixture", [
    ("NLD04", "torch_lint_fixtures/fixture_device_violations.py"),
    ("NLJ05", "torch_lint_fixtures/fixture_torch_violations.py"),
    ("NLT04", "lint_fixtures/fixture_lock_violations.py"),
])
def test_cli_explain_prints_rationale_and_fixture_example(capsys, rule,
                                                         fixture):
    assert lint_main(["--explain", rule]) == 0
    out = capsys.readouterr().out
    assert out.startswith(f"{rule}: {ALL_RULES[rule]}")
    assert "fix:" in out
    assert fixture in out


@pytest.mark.parametrize("rule", ["NLD02", "NLJ01", "NLJ09", "NLX99"])
def test_cli_explain_refuses_rules_left_out(capsys, rule):
    assert lint_main(["--explain", rule]) == 1


def test_cli_format_json_and_sarif(tmp_path, capsys):
    src = os.path.join(FIXTURES, "fixture_torch_violations.py")
    pkg = tmp_path / "nomad_tpu_torch" / "kernels"
    pkg.mkdir(parents=True)
    shutil.copy(src, pkg / "fixture.py")
    root = str(tmp_path / "nomad_tpu_torch")
    assert lint_main([root, "--format", "json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    got = {(f["rule"], f["line"]) for f in payload["findings"]}
    assert got == _expected_markers(src)
    assert all(f["file"] == "nomad_tpu_torch/kernels/fixture.py"
               for f in payload["findings"])
    assert lint_main([root, "--format", "sarif"]) == 0
    doc = json.loads(capsys.readouterr().out)
    (run,) = doc["runs"]
    assert {r["id"] for r in run["tool"]["driver"]["rules"]} \
        == set(ALL_RULES)
    assert {(r["ruleId"],
             r["locations"][0]["physicalLocation"]["region"]["startLine"])
            for r in run["results"]} == _expected_markers(src)


def test_cli_write_baseline_refuses_a_subtree(tmp_path, capsys):
    assert lint_main([os.path.join(PKG, "kernels"), "--write-baseline",
                      "--baseline", str(tmp_path / "bl.json")]) == 1
    assert not (tmp_path / "bl.json").exists()
