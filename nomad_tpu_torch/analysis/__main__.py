"""`python -m nomad_tpu_torch.analysis` — the nomadlint CLI on the port.

Modes:
  (default)        print every finding + summary; exit 0
  --fail-on-new    compare against the baseline; print only NEW
                   findings; exit 2 if any (cheap enough for
                   pre-commit: pure ast, no torch, no jax)
  --write-baseline regenerate lint_baseline_torch.json from the
                   current tree (never the reference's
                   lint_baseline.json)
  --format json    machine-readable findings (file/line/rule/context/
                   message) for PR annotation; --json is the legacy
                   spelling
  --stats          per-rule finding counts + the waiver ledger (every
                   `# nomadlint: ok RULE reason`, and whether it still
                   suppresses anything)
  --explain RULE   the rule's rationale, fix hint, and its marked
                   example lines from tests/torch_lint_fixtures/ (from
                   the reference's tests/lint_fixtures/ for a rule
                   copied as it stands)

Imports neither torch nor jax nor the analyzed modules, so it runs
anywhere in well under 10 s of CPU on the full tree (asserted by
tests/test_torch_lint.py).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import List

from . import ALL_RULES, RULE_HINTS
from .core import (Finding, compare_to_baseline, default_baseline_path,
                   default_root, load_baseline, run_tree, write_baseline)


def _sarif(findings: List[Finding]) -> dict:
    """SARIF 2.1.0 — one run, one result per finding; the NLR/NLS
    call-path hops ride as relatedLocations so CI annotators render
    the full apply-path, the way the text format does."""
    def loc(path: str, line: int, text: str = "") -> dict:
        out = {
            "physicalLocation": {
                "artifactLocation": {"uri": path},
                "region": {"startLine": max(int(line), 1)},
            },
        }
        if text:
            out["message"] = {"text": text}
        return out

    rules = [{"id": rid,
              "shortDescription": {"text": ALL_RULES[rid]},
              **({"help": {"text": RULE_HINTS[rid]}}
                 if RULE_HINTS.get(rid) else {})}
             for rid in sorted(ALL_RULES)]
    results = []
    for f in findings:
        res = {
            "ruleId": f.rule,
            "level": "error",
            "message": {"text": f.message
                        + (f" (fix: {f.hint})" if f.hint else "")},
            "locations": [loc(f.path, f.line, f.context)],
        }
        if f.related:
            res["relatedLocations"] = [loc(p, ln, txt)
                                       for p, ln, txt in f.related]
        results.append(res)
    return {
        "$schema": "https://json.schemastore.org/sarif-2.1.0.json",
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {"name": "nomadlint",
                                "rules": rules}},
            "results": results,
        }],
    }


def _emit(findings: List[Finding], fmt: str,
          stats: dict = None) -> None:
    if fmt == "sarif":
        print(json.dumps(_sarif(findings), indent=1))
        return
    if fmt == "json":
        payload = {
            "findings": [{
                "file": f.path, "line": f.line, "rule": f.rule,
                "context": f.context, "message": f.message,
                "hint": f.hint,
            } for f in findings],
        }
        if stats is not None:
            payload["stats"] = stats
        print(json.dumps(payload, indent=1))
        return
    for f in findings:
        print(f.render())


def _print_stats(findings: List[Finding], stats: dict) -> None:
    by_rule = {}
    for f in findings:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    print(f"files analyzed: {stats.get('files', 0)}")
    print("findings by rule: "
          + (", ".join(f"{r}×{n}" for r, n in sorted(by_rule.items()))
             or "clean"))
    waivers = stats.get("waivers", [])
    active = [w for w in waivers if w.used]
    stale = [w for w in waivers if not w.used and w.reason]
    print(f"waivers: {len(waivers)} total, {len(active)} active, "
          f"{len(stale)} stale (suppress nothing — remove them)")
    for w in waivers:
        state = "active" if w.used else ("stale" if w.reason
                                         else "NO REASON")
        print(f"  {w.path}:{w.line} {w.rule} [{state}] {w.reason}")


def _explain(rule: str) -> int:
    rule = rule.upper()
    if rule not in ALL_RULES:
        print(f"unknown rule {rule!r}; known: "
              + ", ".join(sorted(ALL_RULES)), file=sys.stderr)
        return 1
    print(f"{rule}: {ALL_RULES[rule]}")
    hint = RULE_HINTS.get(rule)
    if hint:
        print(f"fix: {hint}")
    # example from the fixture suite: lines marked `# <RULE>` in
    # tests/torch_lint_fixtures (positive fixtures pin exact rule+line);
    # a rule copied as it stands has its examples in the reference's
    # tests/lint_fixtures, which the port's engine is held against
    tests = os.path.join(os.path.dirname(default_root()), "tests")
    marker = re.compile(rf"#\s*{rule}\b")
    shown = False
    for fixtures in (os.path.join(tests, "torch_lint_fixtures"),
                     os.path.join(tests, "lint_fixtures")):
        if shown or not os.path.isdir(fixtures):
            continue
        for name in sorted(os.listdir(fixtures)):
            if not name.endswith(".py"):
                continue
            path = os.path.join(fixtures, name)
            with open(path, encoding="utf-8") as f:
                lines = f.read().splitlines()
            for i, ln in enumerate(lines):
                if marker.search(ln):
                    if not shown:
                        print("example (from the fixture suite):")
                        shown = True
                    lo = max(i - 2, 0)
                    print(f"  {os.path.basename(fixtures)}/{name}:")
                    for j in range(lo, i + 1):
                        print(f"    {j + 1}: {lines[j]}")
    if not shown:
        print("(no fixture example marked for this rule)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m nomad_tpu_torch.analysis",
        description="nomadlint on the port: host syncs, thread/lock "
                    "safety, device discipline and vocabulary analysis")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to analyze (default: the "
                         "nomad_tpu_torch package)")
    ap.add_argument("--baseline", default=None,
                    help="ratchet file (default: "
                         "lint_baseline_torch.json next to the package)")
    ap.add_argument("--fail-on-new", action="store_true",
                    help="exit 2 when findings exceed the baseline")
    ap.add_argument("--write-baseline", action="store_true",
                    help="freeze current findings into the baseline")
    ap.add_argument("--format", choices=("text", "json", "sarif"),
                    default="text", dest="fmt",
                    help="findings output format (sarif: SARIF 2.1.0 "
                         "with call paths as relatedLocations)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="legacy alias for --format json")
    ap.add_argument("--stats", action="store_true",
                    help="print per-rule counts + the waiver ledger")
    ap.add_argument("--explain", metavar="RULE", default=None,
                    help="print a rule's rationale and fixture example")
    args = ap.parse_args(argv)
    fmt = "json" if args.as_json else args.fmt

    if args.explain:
        return _explain(args.explain)

    roots = args.paths or [default_root()]
    stats: dict = {}
    findings: List[Finding] = []
    seen_files: set = set()
    for root in roots:
        sub_stats: dict = {}
        findings.extend(run_tree(root, stats=sub_stats))
        seen_files.update(sub_stats.get("file_paths", []))
        stats.setdefault("waivers", []).extend(
            sub_stats.get("waivers", []))
    stats["files"] = len(seen_files)
    # overlapping/duplicate path args must not double-count the waiver
    # ledger either: merge by site, OR-ing the used flag
    merged: dict = {}
    for w in stats.get("waivers", []):
        k = (w.path, w.line, w.rule)
        if k in merged:
            merged[k].used = merged[k].used or w.used
        else:
            merged[k] = w
    stats["waivers"] = sorted(
        merged.values(), key=lambda w: (w.path, w.line, w.rule))
    findings.sort()
    # overlapping/duplicate path args must not double-count a finding —
    # --fail-on-new would report baselined findings as NEW
    seen = set()
    unique: List[Finding] = []
    for f in findings:
        k = (f.path, f.line, f.rule, f.context, f.message)
        if k not in seen:
            seen.add(k)
            unique.append(f)
    findings = unique

    baseline_path = args.baseline or default_baseline_path()
    if args.write_baseline:
        if args.paths:
            # a subtree scan would silently WIPE every frozen entry
            # outside it and fail the next full-tree ratchet run
            print("--write-baseline requires a full-tree scan: drop "
                  "the explicit paths (the default root is the whole "
                  "package)", file=sys.stderr)
            return 1
        write_baseline(baseline_path, findings)
        print(f"wrote {len(findings)} finding(s) to {baseline_path}")
        return 0

    if args.stats:
        by_rule: dict = {}
        for f in findings:
            by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
        json_stats = {
            "files": stats.get("files", 0),
            "by_rule": by_rule,
            "waivers": [w.as_dict() for w in stats.get("waivers", [])],
        }
    else:
        json_stats = None

    if args.fail_on_new:
        baseline = load_baseline(baseline_path)
        new = compare_to_baseline(findings, baseline)
        _emit(new, fmt, stats=json_stats)
        if args.stats and fmt == "text":
            _print_stats(findings, stats)
        if new and fmt == "text":
            print(f"\n{len(new)} NEW finding(s) over baseline "
                  f"({len(findings)} total). Fix them, or if "
                  f"legitimately unavoidable, regenerate the baseline "
                  f"with --write-baseline and justify it in the PR.")
        return 2 if new else 0

    _emit(findings, fmt, stats=json_stats)
    if fmt == "text":
        if args.stats:
            _print_stats(findings, stats)
        else:
            by_rule = {}
            for f in findings:
                by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
            summary = ", ".join(f"{r}×{n}"
                                for r, n in sorted(by_rule.items()))
            print(f"\n{len(findings)} finding(s): {summary or 'clean'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
