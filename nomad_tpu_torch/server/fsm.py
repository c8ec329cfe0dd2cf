"""FSM — typed log entries applied to the StateStore, plus full-state
snapshot encode/decode.

Behavioral reference: `nomad/fsm.go` (nomadFSM :74, Apply :180 dispatching
~40 message types to StateStore mutations, Snapshot :1242, Restore :1256).
The entry stream here is exactly the state-store write API: each server
endpoint records the operation it performs, and replaying the stream
through `FSM.apply` reproduces the state byte-for-byte (including the
index counter, which advances in the mutators themselves). The same entry
encoding rides the Raft transport for multi-server replication.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

from ..structs.codec import from_wire, to_wire

# Log-entry op names ARE the state-store write API (the fsm.go message-type
# table collapses to this whitelist; each op maps 1:1 onto a mutator).
ALLOWED_OPS = frozenset({
    "upsert_node", "delete_node",
    "upsert_job", "delete_job",
    "upsert_eval", "delete_eval",
    "upsert_alloc", "delete_alloc", "update_alloc_from_client",
    "upsert_deployment", "delete_deployment",
    "upsert_plan_results", "mark_job_stable", "set_scheduler_config",
    "set_autopilot_config",
    "upsert_acl_policy", "delete_acl_policy",
    "upsert_acl_token", "delete_acl_token", "acl_bootstrap",
    "upsert_csi_volume", "delete_csi_volume",
    "csi_volume_claim", "csi_volume_release",
    "csi_controller_request", "csi_controller_done",
    "upsert_service_registrations",
    "delete_service_registrations_by_alloc",
    "upsert_secret", "delete_secret",
    "upsert_namespace", "delete_namespace",
    "upsert_quota", "delete_quota",
})


def validate_op(state, op: str, args) -> None:
    """Reject an op BEFORE it is journaled/replicated. Mutators that can
    raise on bad input (the ACL ops validate policies/tokens) must fail
    here, while nothing has been written — an entry that raises during
    FSM apply would poison the log and break every replay/peer."""
    if op == "upsert_acl_policy":
        from ..acl.policy import parse_policy

        parse_policy(args[0].rules)
    elif op == "upsert_acl_token":
        from ..acl.tokens import TOKEN_TYPE_CLIENT, TOKEN_TYPE_MANAGEMENT

        t = args[0]
        if t.type not in (TOKEN_TYPE_CLIENT, TOKEN_TYPE_MANAGEMENT):
            raise ValueError(f"invalid token type {t.type!r}")
        if t.type == TOKEN_TYPE_CLIENT and not t.policies:
            raise ValueError("client token requires policies")
    elif op == "acl_bootstrap":
        if state.acl.bootstrapped:
            from ..acl import ACLError

            raise ACLError("ACL bootstrap already done")


class FSM:
    """Applies decoded log entries to a StateStore (fsm.go Apply :180).

    Apply is a PURE FUNCTION of the entry (the nomad/fsm.go contract):
    no clock, no RNG, no iteration-order dependence — nomadlint's NLR
    family ratchets this statically, and tests/test_control_plane.py's
    cross-replica fingerprint gate checks it end to end. Timestamps and
    port-draw seeds are minted leader-side and ride IN the entry."""

    def __init__(self, state, metrics=None) -> None:
        self.state = state
        self._ctr_applied = None
        self._ctr_skipped = None
        if metrics is not None:
            self.bind_metrics(metrics)

    def bind_metrics(self, metrics) -> None:
        """Counters registered eagerly so the series exist at value 0
        from startup (the closed-vocabulary contract: a scrape must
        never see a family appear mid-run)."""
        self._ctr_applied = metrics.counter("fsm.applied")
        self._ctr_skipped = metrics.counter("fsm.apply_skipped")

    def apply(self, entry: Dict[str, Any]) -> None:
        op = entry["op"]
        if op not in ALLOWED_OPS:
            raise ValueError(f"unknown FSM op {op!r}")
        args = [from_wire(a) for a in entry["args"]]
        getattr(self.state, op)(*args)
        if self._ctr_applied is not None:
            self._ctr_applied.inc()

    def apply_resilient(self, entry: Dict[str, Any]) -> None:
        """Replay/replication path: a bad entry is logged and skipped —
        identical (deterministic) on every replayer — never fatal."""
        try:
            self.apply(entry)
        except Exception:
            import traceback

            traceback.print_exc()
            if self._ctr_skipped is not None:
                self._ctr_skipped.inc()


# ---- snapshot (fsm.go Snapshot :1242 / Restore :1256) ----

def snapshot_state(state) -> Dict[str, Any]:
    """Full-state snapshot as a msgpack-ready tree. Caller must hold the
    store quiescent (the server pauses appends around this)."""
    return {
        "index": state.index.value,
        "nodes": [to_wire(n) for n in state.nodes()],
        "jobs": [to_wire(j) for j in state.jobs()],
        "job_versions": [
            [ns, jid, ver, to_wire(job)]
            for (ns, jid, ver), job in state._job_versions.items()
        ],
        "allocs": [to_wire(a) for a in state._allocs.values()],
        "evals": [to_wire(e) for e in state.evals()],
        "deployments": [to_wire(d) for d in state.deployments()],
        "scheduler_config": to_wire(state.scheduler_config()),
        "autopilot_config": to_wire(state.autopilot_config()),
        "csi_volumes": [to_wire(v) for v in state.csi_volumes()],
        "service_regs": [to_wire(r)
                         for r in state.service_registrations()],
        "secrets": [to_wire(e) for e in state.secret_entries()],
        "namespaces": [to_wire(n) for n in state.namespaces()],
        "quotas": [to_wire(q) for q in state.quotas()],
        "acl": {
            "bootstrapped": state.acl.bootstrapped,
            "policies": [to_wire(p) for p in state.acl.policies()],
            "tokens": [to_wire(t) for t in state.acl.tokens()],
        },
    }


def _canon(obj):
    """Canonical JSON-able form: dict keys sorted, floats via repr
    (bit-exact — 0.1+0.2 != 0.3 must NOT hash equal), bytes hexed.
    Nested list order is PRESERVED: an NLR03-class divergence (set
    order escaping into a stored list) must change the fingerprint."""
    if isinstance(obj, dict):
        return {str(k): _canon(obj[k])
                for k in sorted(obj, key=str)}
    if isinstance(obj, (list, tuple)):
        return [_canon(v) for v in obj]
    if isinstance(obj, float):
        return f"f:{obj!r}"
    if isinstance(obj, (bytes, bytearray)):
        return f"b:{bytes(obj).hex()}"
    return obj


def state_fingerprint(state) -> str:
    """sha256 over the canonicalized snapshot tree — the cross-replica
    equality check (tests/test_control_plane.py): identical raft logs
    MUST produce identical fingerprints on every replica and across a
    snapshot/restore round-trip.

    Top-level collections are sorted by their serialized elements so a
    restore that repopulates stores in a different ROW order (the
    mutators key by id; insertion order is not part of the state) still
    fingerprints equal, while any VALUE divergence — a replica-local
    timestamp, port draw, or uuid — changes the hash."""
    import hashlib
    import json

    snap = _canon(snapshot_state(state))
    for key, val in snap.items():
        if isinstance(val, list):
            snap[key] = sorted(
                val, key=lambda v: json.dumps(v, sort_keys=True))
    blob = json.dumps(snap, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def _upsert_preserving_indexes(mutator, obj) -> None:
    # The normal mutators stamp a fresh modify_index; a restore must keep
    # the persisted one (GC thresholds and blocking queries depend on it).
    ci, mi = obj.create_index, obj.modify_index
    mutator(obj)
    obj.create_index, obj.modify_index = ci, mi


def restore_state(state, snap: Dict[str, Any]) -> None:
    """Rebuild a StateStore from a snapshot tree. Runs through the normal
    mutators so derived structures (alloc indexes, cluster tensors) are
    rebuilt, then pins the index counter to the snapshot's value."""
    for tree in snap["nodes"]:
        _upsert_preserving_indexes(state.upsert_node, from_wire(tree))
    for tree in snap["jobs"]:
        _upsert_preserving_indexes(state.upsert_job, from_wire(tree))
    for ns, jid, ver, tree in snap.get("job_versions", []):
        job = from_wire(tree)
        state._job_versions[(ns, jid, ver)] = job
    for tree in snap["allocs"]:
        _upsert_preserving_indexes(state.upsert_alloc, from_wire(tree))
    for tree in snap["evals"]:
        _upsert_preserving_indexes(state.upsert_eval, from_wire(tree))
    for tree in snap["deployments"]:
        _upsert_preserving_indexes(state.upsert_deployment, from_wire(tree))
    cfg = snap.get("scheduler_config")
    if cfg is not None:
        state.set_scheduler_config(from_wire(cfg))
    ap = snap.get("autopilot_config")
    if ap is not None:
        state.set_autopilot_config(from_wire(ap))
    for tree in snap.get("csi_volumes", []):
        _upsert_preserving_indexes(state.upsert_csi_volume, from_wire(tree))
    for tree in snap.get("service_regs", []):
        reg = from_wire(tree)
        ci, mi = reg.create_index, reg.modify_index
        state.upsert_service_registrations([reg])
        # the upsert stores a defensive copy — re-stamp the STORED row
        # (blocking queries keyed on X-Nomad-Index depend on these),
        # mirroring _upsert_preserving_indexes semantics
        stored = state._services.get(reg.id)
        if stored is not None:
            stored.create_index, stored.modify_index = ci, mi
    for tree in snap.get("secrets", []):
        e = from_wire(tree)
        ci, mi, ver = e.create_index, e.modify_index, e.version
        state.upsert_secret(e)
        e.create_index, e.modify_index, e.version = ci, mi, ver
    for tree in snap.get("namespaces", []):
        _upsert_preserving_indexes(state.upsert_namespace,
                                   from_wire(tree))
    for tree in snap.get("quotas", []):
        _upsert_preserving_indexes(state.upsert_quota, from_wire(tree))
    acl = snap.get("acl")
    if acl is not None:
        for tree in acl.get("policies", []):
            state.upsert_acl_policy(from_wire(tree))
        for tree in acl.get("tokens", []):
            state.upsert_acl_token(from_wire(tree))
        state.acl.bootstrapped = bool(acl.get("bootstrapped"))
    state.index.value = snap["index"]
