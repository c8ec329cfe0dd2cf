"""nomadlint on the port — repo-native static analysis for host syncs,
thread/lock safety, device discipline, and observability vocabulary.

The control plane's failure domains are exactly the things generic
linters can't see:

* host syncs in a hot-path module (`torch.cuda.synchronize`, a stream
  or event `.synchronize()`): `torch_rules` NLJ05. The port traces
  nothing (no `torch.compile`, `torch.jit` or `torch.func`), so the
  reference's trace-purity rules NLJ01–04 and NLJ06–09 have nothing to
  judge and are left out (see `torch_rules`);
* unsynchronized shared state in the threaded server/client runtime:
  `thread_rules` NLT01–NLT03;
* lock-order inversions, re-entrancy under lock, and blocking under a
  device-view lease — interprocedural, over a whole-program lock
  graph (`callgraph` + `lock_rules` NLT04–NLT06);
* replica determinism on the apply path and secret egress
  (`replica_rules` NLR01–NLR04, `secrets` NLS01);
* device-lifetime discipline on the dispatch path — un-ledgered
  transfers, unbooked device residency, non-bitwise lane-carry folds
  (`device_rules` NLD01, NLD03, NLD04; torch has no buffer donation,
  so NLD02 is left out);
* the closed observability vocabularies — Prometheus families, flight
  event types, transfer/HBM sites — pinned in `vocab.py` and ratcheted
  statically (`vocab_rules` NLV01).

`lint_baseline_torch.json` at the repo root freezes pre-existing
findings so only *new* violations fail (`python -m
nomad_tpu_torch.analysis --fail-on-new`, and tests/test_torch_lint.py
under tier-1); it is EMPTY — any finding fails. Reviewed exceptions use
the waiver syntax `# nomadlint: ok RULE <mandatory reason>` (counted in
`--stats`; a reason-less waiver is itself a finding, NLW00). The
analyzer imports neither torch nor jax nor the analyzed modules — it
is pure `ast`, safe and fast (<10 s of CPU, asserted in tier-1)
anywhere.

This package `__init__` is LAZY (PEP 562): `lib/flight.py`,
`lib/tracectx.py` and `server/event_broker.py` import `analysis.vocab`
on every agent start for the shared vocabulary, and that import must
not drag the rule engine (core + the rule modules) into the
control-plane process. Attribute access on the package (as the CLI and
tests do) resolves on first use.
"""
from __future__ import annotations

_CORE = frozenset({
    "Finding", "Waiver", "apply_waivers", "baseline_key",
    "compare_to_baseline", "load_baseline", "run_tree",
    "write_baseline",
})
_TABLES = frozenset({
    "ALL_RULES", "DEVICE_RULES", "LOCK_RULES", "REPLICA_RULES",
    "RULE_HINTS", "SECRET_RULES", "THREAD_RULES", "TORCH_RULES",
    "VOCAB_RULES",
})

__all__ = sorted(_CORE | _TABLES)


def _load_tables() -> None:
    from .device_rules import DEVICE_RULES
    from .device_rules import _HINTS as _DEVICE_HINTS
    from .lock_rules import LOCK_RULES
    from .lock_rules import _HINTS as _LOCK_HINTS
    from .replica_rules import REPLICA_RULES
    from .replica_rules import _HINTS as _REPLICA_HINTS
    from .secrets import SECRET_RULES
    from .secrets import _HINTS as _SECRET_HINTS
    from .thread_rules import THREAD_RULES
    from .thread_rules import _HINTS as _THREAD_HINTS
    from .torch_rules import TORCH_RULES
    from .torch_rules import _HINTS as _TORCH_HINTS
    from .vocab_rules import VOCAB_RULES, _HINT as _VOCAB_HINT

    globals().update(
        TORCH_RULES=TORCH_RULES, THREAD_RULES=THREAD_RULES,
        LOCK_RULES=LOCK_RULES, DEVICE_RULES=DEVICE_RULES,
        VOCAB_RULES=VOCAB_RULES, REPLICA_RULES=REPLICA_RULES,
        SECRET_RULES=SECRET_RULES,
        ALL_RULES={
            **TORCH_RULES, **THREAD_RULES, **LOCK_RULES, **DEVICE_RULES,
            **VOCAB_RULES, **REPLICA_RULES, **SECRET_RULES,
            "NLW00": "waiver without a reason (the reason is the "
                     "reviewable artifact)",
            "NLP00": "file does not parse",
        },
        # fix hints per rule (the --explain feed)
        RULE_HINTS={
            **_TORCH_HINTS, **_THREAD_HINTS, **_LOCK_HINTS,
            **_DEVICE_HINTS, **_REPLICA_HINTS, **_SECRET_HINTS,
            "NLV01": _VOCAB_HINT,
            "NLW00": "add the reason: `# nomadlint: ok RULE <why this "
                     "is safe>`",
        },
    )


def __getattr__(name: str):
    if name in _CORE:
        from . import core
        return getattr(core, name)
    if name in _TABLES:
        _load_tables()
        return globals()[name]
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
