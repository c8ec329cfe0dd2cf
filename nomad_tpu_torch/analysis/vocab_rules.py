"""NLV01 — the static vocabulary ratchet.

Three closed vocabularies are pinned by tests: Prometheus series
families (tests/test_metrics_names.py), flight-recorder event types
(lib/flight.py), and the transfer/HBM ledger site taxonomy. All three
now live in `analysis/vocab.py`; this rule extracts every LITERAL name
at its call site and diffs against them, so a rename or an unpinned new
series fails lint in seconds instead of failing the loaded-agent
exposition tests minutes later (or worse, shipping as a silent
dashboard outage).

Extracted call shapes (first literal-string argument unless noted):

* registry instruments — `<recv>.inc/set_gauge/add_sample/counter/
  gauge/histogram("a.b.c")`: the mangled series `nomad_a_b_c` must
  belong to an ALLOWED_PREFIXES family (or be a PROM/RAFT_REQUIRED
  name).
* flight events — `default_flight().record("type")` /
  `self._flight("type")` wrappers: the type must be in FLIGHT_TYPES.
* trace spans — `default_spans().record("name")` / `<spans>.record`:
  the span name must be in SPAN_NAMES.
* transfer sites — `<ledger>.timed/record("site", ...)`: the site must
  be in TRANSFER_SITES.
* residency sites — `<hbm>.track("site", ...)`: the site must be in
  RESIDENCY_SITES; `track_cluster`/`lease` may instead name a
  BOOKING_PREFIXES entry (expanded / lease-only, never a label value).

Dynamic names (f-strings, variables) are skipped — those are the
per-instance families (`worker.<id>.*`, `broker.ready.<type>`) whose
PREFIXES the exposition tests still pin at runtime. The rule is a
ratchet on what is statically knowable, not a proof.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from .core import Finding, dotted as _dotted
from .vocab import (ALLOWED_PREFIXES, BOOKING_PREFIXES, FLIGHT_TYPES,
                    PROM_REQUIRED, RAFT_REQUIRED, RESIDENCY_SITES,
                    SPAN_NAMES, TRANSFER_SITES)

VOCAB_RULES = {
    "NLV01": "name outside the pinned observability vocabulary",
}

_HINT = ("extend the vocabulary in analysis/vocab.py in this same PR "
         "(a conscious taxonomy act), or fix the name")

_METRIC_LEAVES = {"inc", "set_gauge", "add_sample", "counter", "gauge",
                  "histogram"}
_KNOWN_SERIES = PROM_REQUIRED | RAFT_REQUIRED


def _lit(node: Optional[ast.AST]) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _recv_text(func: ast.AST) -> str:
    """Lowercased description of a call's receiver chain, robust to
    calls in the chain (`default_flight().record` → 'default_flight')."""
    if not isinstance(func, ast.Attribute):
        return ""
    recv = func.value
    if isinstance(recv, ast.Call):
        return _dotted(recv.func).lower()
    return _dotted(recv).lower()


def _mangle(name: str) -> str:
    return "nomad_" + name.replace(".", "_")


def analyze_vocab(tree: ast.Module, rel: str) -> List[Finding]:
    findings: List[Finding] = []
    if rel.endswith("analysis/vocab.py"):
        return findings

    def flag(node, detail):
        findings.append(Finding(rel, node.lineno, "NLV01",
                                VOCAB_RULES["NLV01"] + ": " + detail,
                                _HINT, context=""))

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) \
                or not isinstance(node.func, ast.Attribute):
            continue
        leaf = node.func.attr
        recv = _recv_text(node.func)
        arg0 = _lit(node.args[0]) if node.args else None
        # flight event types
        if (leaf == "record" and "flight" in recv) or leaf == "_flight":
            if arg0 is not None and arg0 not in FLIGHT_TYPES:
                flag(node, f"flight event type {arg0!r} is not in "
                           f"FLIGHT_TYPES")
            continue
        # distributed-trace span names (lib/tracectx.py SpanStore)
        if leaf == "record" and "span" in recv:
            if arg0 is not None and arg0 not in SPAN_NAMES:
                flag(node, f"span name {arg0!r} is not in SPAN_NAMES")
            continue
        # transfer-ledger sites
        if leaf in ("timed", "record") and (
                "ledger" in recv or recv in ("led",)):
            if arg0 is not None and arg0 not in TRANSFER_SITES:
                flag(node, f"transfer site {arg0!r} is not in "
                           f"TRANSFER_SITES")
            continue
        # HBM residency sites: `track` books a literal site label;
        # `track_cluster` takes a BOOKING prefix it expands, and lease
        # sites never reach a labeled series — both may use the
        # lint-only BOOKING_PREFIXES names
        if leaf in ("track", "track_cluster") and (
                "hbm" in recv or "ledger" in recv):
            allowed = RESIDENCY_SITES if leaf == "track" \
                else RESIDENCY_SITES | BOOKING_PREFIXES
            if arg0 is not None and arg0 not in allowed:
                flag(node, f"residency site {arg0!r} is not in "
                           f"RESIDENCY_SITES")
            continue
        if leaf == "lease" and "hbm" in recv:
            site = _lit(node.args[1]) if len(node.args) > 1 else None
            for kw in node.keywords:
                if kw.arg == "site":
                    site = _lit(kw.value)
            if site is not None \
                    and site not in RESIDENCY_SITES | BOOKING_PREFIXES:
                flag(node, f"residency site {site!r} is not in "
                           f"RESIDENCY_SITES")
            continue
        # registry instruments
        if leaf in _METRIC_LEAVES and arg0 is not None:
            mangled = _mangle(arg0)
            if mangled in _KNOWN_SERIES:
                continue
            if not any(mangled.startswith(p) for p in ALLOWED_PREFIXES):
                flag(node, f"metric {arg0!r} → {mangled} matches no "
                           f"ALLOWED_PREFIXES family")
    return findings
