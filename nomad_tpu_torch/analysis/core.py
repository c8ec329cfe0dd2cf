"""The analyzer's core: file walking, suppression, and the baseline ratchet.

The ratchet mirrors how mature codebases adopt a new checker without a
flag-day: `lint_baseline_torch.json` (the port's own, beside the
reference's `lint_baseline.json`, which the port never writes) records
every finding present at adoption (keyed by file + rule + syntactic
context, NOT line numbers, so unrelated edits don't shift the
baseline), and `--fail-on-new` fails only findings whose per-key count
exceeds the frozen count. Burning a baselined finding down is always
safe; regrowing one fails.
"""
from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

def dotted(node: ast.AST) -> str:
    """'torch.cuda.synchronize' for nested Attribute/Name chains, ''
    otherwise. Shared by both rule families."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


#: inline suppression: `# nomadlint: disable=NLJ04,NLT02`
_SUPPRESS_RE = re.compile(r"nomadlint:\s*disable=([A-Z0-9,\s]+)")
#: whole-file opt-out (first 5 lines): `# nomadlint: disable-file`
_SUPPRESS_FILE_RE = re.compile(r"nomadlint:\s*disable-file")
#: reviewed waiver: `# nomadlint: ok <RULE> <mandatory reason>` — one
#: rule per waiver so the reason stays attached to the decision. A
#: waiver WITHOUT a reason is itself a finding (NLW00): the reason is
#: the reviewable artifact, not the suppression. Waivers are counted
#: in `--stats` so accumulated debt stays visible.
_WAIVER_RE = re.compile(r"nomadlint:\s*ok\s+(NL[A-Z]\d\d)\b[ \t]*(.*)")


@dataclass(frozen=True, order=True)
class Finding:
    path: str      # repo-relative, posix separators
    line: int
    rule: str
    message: str = field(compare=False)
    hint: str = field(compare=False, default="")
    context: str = field(compare=False, default="")  # Class.method / func
    #: call-path hops as (path, line, text) — NLR/NLS findings carry
    #: the rendered apply-path here so --format sarif can emit them as
    #: relatedLocations; compare=False keeps baseline keys stable
    related: tuple = field(compare=False, default=())

    def render(self) -> str:
        ctx = f" [{self.context}]" if self.context else ""
        hint = f" (fix: {self.hint})" if self.hint else ""
        return f"{self.path}:{self.line}: {self.rule}{ctx} " \
               f"{self.message}{hint}"


def baseline_key(f: Finding) -> str:
    return f"{f.path}::{f.rule}::{f.context}"


class Waiver:
    """One `# nomadlint: ok RULE reason` comment."""

    __slots__ = ("path", "line", "rule", "reason", "used")

    def __init__(self, path: str, line: int, rule: str, reason: str):
        self.path = path
        self.line = line
        self.rule = rule
        self.reason = reason
        self.used = False

    def as_dict(self) -> dict:
        return {"path": self.path, "line": self.line, "rule": self.rule,
                "reason": self.reason, "used": self.used}


def _suppressions(source: str, rel: str = ""
                  ) -> Tuple[bool, Dict[int, set], List[Waiver]]:
    """(file-wide opt-out, {line: {rules}}, waivers) from magic
    comments. Waivers with an EMPTY reason still parse (so the finding
    below can point at them) but suppress nothing."""
    lines = source.splitlines()
    whole = any(_SUPPRESS_FILE_RE.search(ln) for ln in lines[:5])
    per_line: Dict[int, set] = {}
    waivers: List[Waiver] = []
    for i, ln in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(ln)
        if m:
            per_line[i] = {r.strip() for r in m.group(1).split(",")
                           if r.strip()}
        w = _WAIVER_RE.search(ln)
        if w:
            waivers.append(Waiver(rel, i, w.group(1),
                                  w.group(2).strip()))
    return whole, per_line, waivers


def apply_waivers(findings: List[Finding], waivers: List[Waiver],
                  emit_missing_reason: bool = True) -> List[Finding]:
    """Filter findings a reasoned waiver covers (same line + rule);
    mark those waivers used, and emit an NLW00 finding for every
    reason-less waiver — the reason IS the reviewable artifact.
    `emit_missing_reason=False` for a second pass over the same waiver
    objects (run_tree's whole-program findings)."""
    by_key: Dict[Tuple[str, int, str], Waiver] = {}
    out: List[Finding] = []
    for w in waivers:
        if w.reason:
            by_key[(w.path, w.line, w.rule)] = w
        elif emit_missing_reason:
            out.append(Finding(
                w.path, w.line, "NLW00",
                f"waiver for {w.rule} has no reason — "
                f"`# nomadlint: ok {w.rule} <why this is safe>`"))
    for f in findings:
        w = by_key.get((f.path, f.line, f.rule))
        if w is not None:
            w.used = True
            continue
        out.append(f)
    return out


def analyze_file(path: str, rel: str,
                 tree: Optional[ast.Module] = None,
                 source: Optional[str] = None,
                 interprocedural: bool = True,
                 stats: Optional[dict] = None,
                 suppressions: Optional[Tuple[bool, Dict[int, set],
                                              List["Waiver"]]] = None
                 ) -> List[Finding]:
    """All findings for one file. `rel` is the repo-relative path used in
    reports and baseline keys. Pass pre-read `source` / pre-parsed
    `tree` to skip re-work (run_tree's two passes share them).
    `interprocedural=False` skips the whole-program lock rules —
    run_tree runs those ONCE over the full tree instead of per file (a
    lone file still gets them, as its own one-module program). `stats`
    accumulates waiver bookkeeping for `--stats`."""
    from .device_rules import analyze_device
    from .thread_rules import analyze_threads
    from .torch_rules import analyze_torch
    from .vocab_rules import analyze_vocab

    if source is None:
        with open(path, encoding="utf-8") as f:
            source = f.read()
    if tree is None:
        try:
            tree = ast.parse(source, filename=rel)
        except SyntaxError as e:
            return [Finding(rel, e.lineno or 1, "NLP00",
                            f"syntax error: {e.msg}")]
    if suppressions is None:
        suppressions = _suppressions(source, rel)
    whole, per_line, waivers = suppressions
    if whole:
        return []
    findings = analyze_torch(tree, rel)
    findings += analyze_threads(tree, rel)
    findings += analyze_device(tree, rel)
    findings += analyze_vocab(tree, rel)
    if interprocedural:
        from .callgraph import Program
        from .lock_rules import analyze_locks
        from .replica_rules import analyze_replica
        from .secrets import analyze_secrets

        prog = Program.build({rel: tree})
        for analyze in (analyze_locks, analyze_replica,
                        analyze_secrets):
            findings += [f for f in analyze(prog) if f.path == rel]
    findings = [f for f in findings
                if f.rule not in per_line.get(f.line, ())]
    findings = apply_waivers(findings, waivers)
    if stats is not None:
        stats.setdefault("waivers", []).extend(waivers)
    return findings


def _repo_rel(path: str, fallback_root: str) -> str:
    """Repo-relative report path, anchored at the rightmost
    `nomad_tpu_torch` path component so scope prefixes and baseline
    keys match no matter which subpath the CLI was pointed at
    (`... nomad_tpu_torch/client` must not silently skip the thread
    rules)."""
    parts = os.path.abspath(path).split(os.sep)
    for i in range(len(parts) - 1, -1, -1):
        if parts[i] == "nomad_tpu_torch":
            return "/".join(parts[i:])
    return os.path.relpath(path, fallback_root).replace(os.sep, "/")


def iter_python_files(root: str):
    """Yield (abspath, repo-relative path) for every .py under root,
    deterministically ordered."""
    repo_root = os.path.dirname(os.path.abspath(root.rstrip(os.sep)))
    if os.path.isfile(root):
        yield root, _repo_rel(root, repo_root)
        return
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", ".git"))
        for name in sorted(filenames):
            if not name.endswith(".py"):
                continue
            p = os.path.join(dirpath, name)
            yield p, _repo_rel(p, repo_root)


def run_tree(root: str, stats: Optional[dict] = None) -> List[Finding]:
    """Analyze every .py under `root` (a package dir or a single file).

    Two passes: the first runs the per-file rules, the second builds
    the whole-program model ONCE and runs the interprocedural lock
    rules (NLT04–NLT06) over it — suppressions and waivers from each
    file apply to those findings too. (The reference's first pass,
    the jit registry of NLJ09, has nothing to collect here: the port
    traces nothing, see torch_rules.)
    """
    from .callgraph import Program
    from .lock_rules import analyze_locks
    from .replica_rules import analyze_replica
    from .secrets import analyze_secrets

    files = list(iter_python_files(root))
    parsed: Dict[str, Tuple[ast.Module, str]] = {}
    findings: List[Finding] = []
    for path, rel in files:
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
            parsed[path] = (ast.parse(source, filename=rel), source)
        except SyntaxError as e:
            findings.append(Finding(rel, e.lineno or 1, "NLP00",
                                    f"syntax error: {e.msg}"))
        except OSError:
            continue
    if stats is None:
        stats = {}
    #: rel -> (whole, per_line, waivers), computed ONCE per file and
    #: shared with the whole-program pass below
    suppress: Dict[str, Tuple[bool, Dict[int, set], List[Waiver]]] = {}
    for path, rel in files:
        if path in parsed:
            tree, source = parsed[path]
            suppress[rel] = _suppressions(source, rel)
            findings.extend(analyze_file(
                path, rel, tree=tree, source=source,
                interprocedural=False, stats=stats,
                suppressions=suppress[rel]))
    # whole-program pass (lock graph and the NLR/NLS taint scopes span
    # modules)
    waivers_by_rel: Dict[str, List[Waiver]] = {}
    for w in stats.get("waivers", []):
        waivers_by_rel.setdefault(w.path, []).append(w)
    prog = Program.build({rel: parsed[path][0]
                          for path, rel in files if path in parsed})
    lock_findings: List[Finding] = []
    for analyze in (analyze_locks, analyze_replica, analyze_secrets):
        for f in analyze(prog):
            whole, per_line, _w = suppress.get(f.path, (False, {}, []))
            if whole or f.rule in per_line.get(f.line, ()):
                continue
            lock_findings.append(f)
    by_rel: Dict[str, List[Finding]] = {}
    for f in lock_findings:
        by_rel.setdefault(f.path, []).append(f)
    for rel, fs in by_rel.items():
        findings.extend(apply_waivers(fs, waivers_by_rel.get(rel, []),
                                      emit_missing_reason=False))
    stats["files"] = len(parsed)
    #: absolute paths analyzed — the CLI unions these across its root
    #: args so overlapping/duplicate paths don't double-count files
    stats["file_paths"] = [os.path.abspath(p) for p in parsed]
    return sorted(findings)


# ---- baseline ratchet ----

def load_baseline(path: str) -> Dict[str, int]:
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    return {str(k): int(v) for k, v in data.get("findings", {}).items()}


def write_baseline(path: str, findings: List[Finding]) -> None:
    counts: Dict[str, int] = {}
    for f in findings:
        counts[baseline_key(f)] = counts.get(baseline_key(f), 0) + 1
    payload = {
        "comment": "nomadlint ratchet — frozen pre-existing findings. "
                   "Burn entries down freely; regrow them never. To "
                   "legitimately extend (new rule / unavoidable finding) "
                   "run: python -m nomad_tpu_torch.analysis "
                   "--write-baseline "
                   "and justify the diff in the PR.",
        "findings": dict(sorted(counts.items())),
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=1, sort_keys=False)
        f.write("\n")


def compare_to_baseline(findings: List[Finding],
                        baseline: Dict[str, int]) -> List[Finding]:
    """Findings in excess of the frozen per-key counts — the ones that
    fail `--fail-on-new`."""
    seen: Dict[str, int] = {}
    new: List[Finding] = []
    for f in findings:
        k = baseline_key(f)
        seen[k] = seen.get(k, 0) + 1
        if seen[k] > baseline.get(k, 0):
            new.append(f)
    return new


def default_root() -> str:
    """The nomad_tpu_torch package directory (analyzer's default
    target)."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(default_root()),
                        "lint_baseline_torch.json")
