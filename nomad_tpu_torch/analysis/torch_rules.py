"""Host-sync rule on the port (NLJ05) — the counterpart of the
reference's `jax_rules.py`.

**NLJ05 — host sync in a hot-path module.** A wait for the device on
the serving path stalls the dispatch pipeline even from host code. The
reference flags `block_until_ready`, `device_get` and `jax.debug.*`;
on torch the waits are `torch.cuda.synchronize()` and `.synchronize()`
on a stream or an event, and those are flagged here. The counterparts
of `device_get` — `.cpu()`, `.numpy()`, `.tolist()`, `.item()` — are
fetches, and fetches are NLD01's (`device_rules`), as the reference's
`np.asarray(<device array>)` fetches are. `jax.debug.*` has no torch
counterpart.

**Left out: NLJ01–04 and NLJ06–09.** They judge code under a trace
(`jax.jit`, `vmap`, `lax.scan`: `.item()` or Python control flow on a
tracer, numpy materialization, mutation of captured state, static
arguments), and NLJ06/07 judge TPU scatters and gathers inside a traced
kernel. The port traces nothing — no `torch.compile`, `torch.jit`,
`torch.func` or `torch.vmap` call exists in it (pinned by
tests/test_torch_lint.py) — and its kernels are CUDA C++. If a traced
function lands in the port, its rules come with it.
"""
from __future__ import annotations

import ast
from typing import List

from .core import Finding, dotted as _dotted

TORCH_RULES = {
    "NLJ05": "host sync or debug output in a hot-path module",
}

_HINTS = {
    "NLJ05": "benchmarks may block; the serving path must not — move "
             "it behind the dispatch boundary",
}

#: hot-path scope for NLJ05, repo-relative prefixes/files
HOT_PATH_SCOPE = (
    "nomad_tpu_torch/kernels/",
    "nomad_tpu_torch/tensor/",
    "nomad_tpu_torch/parallel/",
    "nomad_tpu_torch/scheduler/",
    "nomad_tpu_torch/server/select_batch.py",
)

#: a host wait: `torch.cuda.synchronize()`, `stream.synchronize()`,
#: `event.synchronize()`
_SYNC_LEAVES = {"synchronize"}


def _check_hot_path(tree: ast.Module, rel: str,
                    findings: List[Finding]) -> None:
    in_scope = any(
        rel.startswith(p) if p.endswith("/") else rel == p
        for p in HOT_PATH_SCOPE)
    if not in_scope:
        return
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) \
                or not isinstance(node.func, ast.Attribute) \
                or node.func.attr not in _SYNC_LEAVES:
            continue
        d = _dotted(node.func)
        findings.append(Finding(
            rel, node.lineno, "NLJ05",
            TORCH_RULES["NLJ05"] + f": {d or node.func.attr}()",
            _HINTS["NLJ05"]))


def analyze_torch(tree: ast.Module, rel: str) -> List[Finding]:
    findings: List[Finding] = []
    _check_hot_path(tree, rel, findings)
    return findings
