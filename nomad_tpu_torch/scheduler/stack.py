"""TorchStack — the device-backed replacement for GenericStack.

Counterpart of the reference package's `TPUStack`
(`nomad_tpu/scheduler/stack.py`). Reference: `scheduler/stack.go:321`
builds the iterator chain once per scheduler invocation; `Select` (:116)
runs one alloc's placement. Here the per-(job, task-group) constraint/
affinity/spread programs compile to LUTs once (numpy, a copy of the
reference's compile half), and one kernel run places *all* allocs of the
group, full-width over the node axis.

`select` runs solo (one kernel run per task group) or, on the server's
batched path, parks its program at the select coordinator
(`server/select_batch.py`), which fuses the batch into chain and wave
dispatches. The device view is cached per (cluster, device) and refreshed
from the cluster's delta log by the row-delta kernels (`kernels/rows.py`,
K7), adopting a dispatch's (or a certified speculation chain's) device
carry where it can prove it equal to the committed host state.

Writes in place are safe by construction: every caller that launches
against a view holds a lease on it from the resolve until its outputs are
back on the host (the coordinator's dispatches, speculative ones through
`spec_chain_view`, and the solo `select`), and a refresh that finds any
lease writes into copies instead (the copy slot). PyTorch has no buffer
donation, so an unleased holder would otherwise see its tensors change
silently; with the rule above there is none.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
import weakref
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..convert import params_from_numpy, tensor_from_numpy
from ..device import DeviceLike, resolve_device
from ..kernels.placement import (EXPLAIN_SCORE_NAMES, ClusterArrays,
                                 PlacementExplain, PlacementResult, TGParams,
                                 place_task_group)
from ..kernels.rows import ViewDelta, apply_view_delta
from ..lib.metrics import default_registry
from ..parallel.pad import pad_params
from ..structs import Allocation, Job, TaskGroup
from ..structs.job import (CONSTRAINT_DISTINCT_HOSTS,
                           CONSTRAINT_DISTINCT_PROPERTY)
from ..tensor.cluster import DELTA_LOG_LEN, R_TOTAL, ClusterTensors
from ..tensor.constraints import (
    CompiledAffinities,
    CompiledConstraints,
    compile_affinities,
    compile_constraints,
)
from ..tensor.vocab import MISSING, target_to_key
from ..utils import bucket as _shared_bucket
from .oracle import meets_constraints


def _bucket(n: int, lo: int = 1) -> int:
    return _shared_bucket(n, lo)


@dataclass
class PlanContext:
    """Plan-relative inputs for one evaluation (mirrors what the reference
    threads through ctx.Plan(), scheduler/context.go:120)."""

    stopped_allocs: List[Allocation] = field(default_factory=list)
    preempted_allocs: List[Allocation] = field(default_factory=list)
    placed: List[Tuple[str, str, np.ndarray]] = field(default_factory=list)
    # (node_id, task_group, usage_row) for in-plan placements of this job
    placed_allocs: List[Allocation] = field(default_factory=list)
    # full in-plan placements (any job) — port consumption for the kernel's
    # plan-relative port mask (rank.go:240 proposed-alloc NetworkIndex)
    penalty_node_ids: List[frozenset] = field(default_factory=list)  # per step
    preferred_node_ids: List[Optional[str]] = field(default_factory=list)  # per step


@dataclass
class SelectResult:
    node_ids: List[Optional[str]]
    scores: List[float]
    nodes_feasible: int
    nodes_fit: List[int]
    raw: PlacementResult = None
    #: host-shaped attribution (see TorchStack._explain_host) — None when
    #: the run emitted no explain outputs
    explain: Optional[dict] = None
    #: the compiled ask vector (f32[R]) this selection placed against —
    #: the scheduler compares each committed placement's usage row to it
    #: to certify the plan carry-exact (device-resident plan deltas)
    ask: Optional[np.ndarray] = None
    #: fused-dispatch token (table path only): the scheduler stamps it
    #: on its plan (carry_token) so the commit window binds to the
    #: dispatch whose carry actually contains these placements
    carry_token: Optional[int] = None


def explain_enabled() -> bool:
    """Kernel-native placement attribution default: ON (the acceptance
    bar is that it is free — sel/score bit-identical, ≤5% dispatch
    overhead); NOMAD_TPU_EXPLAIN=0 opts a deployment out."""
    return os.environ.get("NOMAD_TPU_EXPLAIN", "1").strip().lower() \
        not in ("0", "off", "false")


#: base resource-dimension display names, column order of the cluster
#: tensors (tensor/cluster.py R_CPU..R_BW); device columns resolve by
#: pool name. The strings are AllocMetric.dimension_exhausted keys and
#: must stay stable — the bench attribution section and the blocked-eval
#: diagnostics aggregate on them.
DIMENSION_NAMES = ("cpu", "memory", "disk", "network")

#: process-unique dispatch tokens: view-lease keys AND the carry/plan
#: binding (structs.Plan.carry_token ↔ the carry notes below). One
#: counter for the coordinator's dispatches and the solo select's
#: leases, so no two holders share a token.
_DISPATCH_TOKENS = itertools.count(1)

#: cluster object → {device: last upload}, keyed per tensor group by
#: sub-version (see TorchStack.device_arrays); weak so dead clusters free
#: their device memory
_DEV_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_DEV_CACHE_LOCK = threading.Lock()


def _dev_key(device) -> torch.device:
    """Cache key of a device: `cuda` and `cuda:<current>` name one card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _entry(cluster, device=None) -> Optional[dict]:
    """The cache entry of `cluster` on `device` (None: its only entry);
    call under _DEV_CACHE_LOCK."""
    per_dev = _DEV_CACHE.get(cluster)
    if not per_dev:
        return None
    if device is None:
        return next(iter(per_dev.values())) if len(per_dev) == 1 else None
    return per_dev.get(_dev_key(device))


def _leased(ent: dict, token) -> ClusterArrays:
    """The entry's view, leased to `token` (if any); call under
    _DEV_CACHE_LOCK."""
    if token is not None:
        from ..lib.hbm import default_hbm

        ent.setdefault("leases", set()).add(token)
        default_hbm().lease(token, "stack.view")
    return ent["arrays"]


# ---- device-view delta refresh ---------------------------------------------
# The control plane's hot loop mutates a handful of node rows per plan
# apply; ports_used alone is u32[N, 2048] (128 MiB at 16K rows), so a
# whole-tensor re-upload per version bump dwarfs the placement kernel.
# The delta path ships only the rows the cluster's bounded delta log
# names and writes them with the row-delta kernel (kernels/rows.py, K7),
# one staged copy and one launch a refresh: in place on the cached tensors
# when no lease is held, else into copies (the copy slot — a leased view's
# tensors are never written).


def _delta_rows_host(rows, *arrays):
    """Sorted delta row indices (i32) and their CURRENT host values."""
    idx = np.fromiter(sorted(rows), dtype=np.int32, count=len(rows))
    return (idx,) + tuple(a[idx] for a in arrays)


def _clone(t):
    """A copy of a view tensor, or of every copy of a sharded field."""
    if isinstance(t, dict):
        return {k: v.clone() for k, v in t.items()}
    return t.clone()


# ---- view leases + dispatch carry (device-resident plan deltas) ------------
# The SelectCoordinator's fused dispatch produces, besides its fetchable
# outputs, the chain's final (used, dyn_free) carry — the post-placement
# cluster view, already ON DEVICE. Once the batch's plans commit, the
# next refresh can ADOPT that carry instead of re-uploading the rows the
# plans just touched: zero host→device traffic for kernel-committed
# placements. The adoption proof obligations live in device_arrays; the
# coordinator only notes the carry here.
#
# Leases implement the copy-slot half: a dispatch leases the view it
# launched against (registered ATOMICALLY with the resolve via
# device_arrays(lease_token=), keyed by the dispatch token) and releases
# once its outputs are on the host. A refresh that finds live leases must
# not write the leased tensors — it writes into copies instead.


def release_view(cluster, token) -> None:
    """End the view lease a caller took with
    `device_arrays(lease_token=token)` or `spec_chain_view` (idempotent:
    a failed launch releases defensively)."""
    from ..lib.hbm import default_hbm

    with _DEV_CACHE_LOCK:
        for ent in (_DEV_CACHE.get(cluster) or {}).values():
            ent.setdefault("leases", set()).discard(token)
    # residency ledger: the lease's owner-token lifetime ends here
    default_hbm().release_lease(token)


def note_dispatch_carry(cluster, token, base_arrays, evals, stop_rows,
                        used, dyn_free) -> None:
    """Attach a dispatch's device-resident carry to the view cache entry
    of the device it ran on. `base_arrays` is the exact ClusterArrays the
    chain consumed — adoption later requires the cached entry to STILL be
    that object (identity, not version: any interleaved refresh rebuilds
    the namedtuple and auto-invalidates the carry). `evals` are the eval
    ids chained (order-aligned with the dispatch); `stop_rows` the node
    rows the programs' plan-relative deltas touch (stops/preempts/in-plan
    placements) — their host commits adjust dyn_free/ports in ways the
    carry deliberately does not model, so they always re-upload."""
    with _DEV_CACHE_LOCK:
        ent = _entry(cluster, base_arrays.used.device)
        if ent is None or ent.get("arrays") is not base_arrays:
            return
        ent["carry"] = {
            "token": token, "base_arrays": base_arrays,
            "evals": set(evals), "stop_rows": set(stop_rows),
            "used": used, "dyn_free": dyn_free, "predicted": None,
        }


def carry_predicted(cluster, token, predicted: Dict[str, set]) -> None:
    """Second half of the carry note, filled when the dispatch's outputs
    land host-side (the first _BatchOut resolver): per-eval node rows
    the kernel actually selected. Until this arrives the carry is not
    adoptable — an unresolved dispatch has unprovable placements.

    The speculative-dispatch chain (below) holds its own carry records
    keyed by the same tokens; the fill reaches whichever bookkeeping
    still knows the token — a refresh may have popped the cache note
    while the chain still needs the prediction for certification."""
    with _DEV_CACHE_LOCK:
        for ent in (_DEV_CACHE.get(cluster) or {}).values():
            c = ent.get("carry")
            if c is not None and c["token"] == token:
                c["predicted"] = predicted
        with _SPEC_LOCK:
            chain = _SPEC_CHAINS.get(cluster)
            if chain is not None:
                rec = chain["expect"].get(token)
                if rec is None and chain["head"] is not None \
                        and chain["head"]["token"] == token:
                    rec = chain["head"]
                if rec is not None:
                    rec["predicted"] = predicted


# ---- speculative dispatch chain --------------------------------------------
# The SelectCoordinator can launch dispatch k+1 against the PREDICTED
# post-commit view while dispatch k's plans are still committing: the
# predicted view is the base view with (used, dyn_free) swapped for the
# predecessor's device-resident chain carry — a pure tensor recombination,
# zero transfer. Every launch goes to the device's default stream, so
# kernel k+1 queues right behind kernel k, whose carry it reads (the
# stream order takes the place of XLA's data dependency). The chain
# records, per cluster, WHAT the speculative view assumed (which dispatch
# tokens' carries it folded in, their per-eval predicted placement rows,
# their stop rows) and accumulates a STALE-ROW set: every row where the
# chained view may diverge from the committed host truth. Certification
# (select_batch.SelectCoordinator._certify_spec) then keeps a program's
# speculative result only when its node footprint avoids every stale row
# — which makes the result bit-identical to what a sequential dispatch
# against the committed view would have produced (the same superset
# argument the wave-lane partition rests on).
#
# The chain belongs to one device (`chain["device"]`, the device of the
# cache entry it seeded from): its base and carries are that entry's.
#
# Lock order: _DEV_CACHE_LOCK → _SPEC_LOCK. _SPEC_LOCK is otherwise a
# leaf (the plan-window observer takes it under the store's mutation
# lock and calls nothing further).

#: cluster → chain state dict; weak so dead clusters free their carries
_SPEC_CHAINS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_SPEC_LOCK = threading.Lock()


def _spec_carry_rec(token, evals, stop_rows, used, dyn_free,
                    predicted=None) -> dict:
    return {"token": token, "evals": set(evals),
            "stops": {int(r) for r in stop_rows},
            "used": used, "dyn_free": dyn_free, "predicted": predicted}


def spec_chain_view(cluster, lease_token,
                    device=None) -> Optional[ClusterArrays]:
    """Predicted post-commit view for a speculative dispatch on `device`
    (None: the cluster's only cached device), or None when nothing is
    predictable (no carry note, an interleaved refresh, a node-set
    change). The view is the chain head's (used, dyn_free) carry over the
    chain base's static/ports tensors. `lease_token` is registered on the
    cached entry ATOMICALLY with the read, so a concurrent refresh writes
    into a fresh copy instead of the tensors the speculative kernel reads.

    Does NOT advance the chain: a caller that aborts after this (table
    residency miss, caps flush race) only has to release the lease."""
    from ..lib.hbm import default_hbm

    with _DEV_CACHE_LOCK:
        ent = _entry(cluster, device)
        if ent is None:
            return None
        arrays = ent["arrays"]
        with _SPEC_LOCK:
            chain = _SPEC_CHAINS.get(cluster)
            if chain is not None and (
                    chain["base_arrays"] is not arrays
                    or chain["static_key"] != ent["static_key"]
                    or chain["node_version"] != cluster.node_version):
                # a real refresh (or node churn) interleaved: the chain's
                # base is gone — certification could no longer prove
                # anything against it
                _spec_reset_locked(cluster, chain)
                chain = None
            if chain is None:
                # seed from the live carry note of the last REAL
                # dispatch (note_dispatch_carry guarantees base
                # identity at write; any refresh since rebuilt arrays
                # and was caught above)
                c = ent.get("carry")
                if c is None or c["base_arrays"] is not arrays:
                    return None
                chain = {
                    "device": _dev_key(arrays.used.device),
                    "base_arrays": arrays,
                    "static_key": ent["static_key"],
                    "node_version": cluster.node_version,
                    "checked_version": ent["version"],
                    "checked_ports": ent["ports_version"],
                    "stale": set(),
                    "proven": set(),
                    "expect": {},
                    "windows": [],
                    "last_rejected": set(),
                    "head": _spec_carry_rec(
                        c["token"], c["evals"], c["stop_rows"],
                        c["used"], c["dyn_free"],
                        predicted=c["predicted"]),
                }
                _SPEC_CHAINS[cluster] = chain
                _install_window_observer(cluster)
            head = chain["head"]
            if head is None:
                return None
        ent.setdefault("leases", set()).add(lease_token)
        default_hbm().lease(lease_token, "stack.view")
        return ClusterArrays(
            capacity=arrays.capacity,
            used=head["used"],
            node_ok=arrays.node_ok,
            attrs=arrays.attrs,
            ports_used=arrays.ports_used,
            dyn_free=head["dyn_free"],
        )


def spec_chain_advance(cluster, token, evals, stop_rows, used,
                       dyn_free) -> None:
    """A speculative dispatch launched successfully against the chain
    view: fold the previous head into the EXPECTED set (its plans are
    now committing — certification will match their commit windows) and
    install the new dispatch's carry as the head. The folded head's
    stop rows go stale immediately: the chain view bakes their
    plan-relative delta subtraction into `used` but deliberately does
    not model their port credits (the same reason adoption always
    overlays them)."""
    with _SPEC_LOCK:
        chain = _SPEC_CHAINS.get(cluster)
        if chain is None:
            return
        head = chain["head"]
        if head is not None:
            chain["expect"][head["token"]] = head
            chain["stale"].update(head["stops"])
        chain["head"] = _spec_carry_rec(token, evals, stop_rows, used,
                                        dyn_free)


def spec_chain_certify(cluster) -> Optional[frozenset]:
    """Fold every commit since the last certification into the chain's
    stale-row set and return it (cumulative). Returns None when the
    chain cannot prove anything — an interleaved refresh, node churn,
    a delta-log window miss, or an expected dispatch whose outputs
    never resolved — in which case the caller must roll back every
    speculative result and reset the chain.

    Soundness: stale is a SUPERSET of the rows where the chain view may
    diverge from the committed host state. A row change is non-stale
    only when it happened inside a clean+exact plan window of an
    EXPECTED dispatch token, for an eval that dispatch chained, on a
    row that dispatch predicted (its kernel placement) — exactly the
    changes whose post-commit values the chain carry already holds
    bit-identically (structs.Plan.carry_exact). Everything else —
    foreign mutations, partial commits, retry plans under other
    tokens, phantom placements of uncommitted evals, any port-bitmap
    mutation (never modeled by the carry) — goes stale and stays
    stale for the life of the chain.

    Multi-token coverage (chain-carry adoption): besides the stale
    SUPERSET, certification accumulates the complement — `proven`, the
    rows every certified window vouched for (clean+exact commit of an
    expected token, predicted placement row). Across a chain of k
    dispatches under k commit windows those are exactly the rows whose
    values the folded HEAD carry holds bit-identically, which is what
    lets `spec_chain_publish_carry` hand the carry to the view cache
    for zero-transfer adoption (`TorchStack.device_arrays`)."""
    cl = cluster
    wrap = None
    result = None
    with _DEV_CACHE_LOCK:
        with _SPEC_LOCK:
            chain = _SPEC_CHAINS.get(cl)
            if chain is None:
                return None
            ent = _entry(cl, chain["device"])
            arrays = ent["arrays"] if ent is not None else None
            static_key = ent["static_key"] if ent is not None else None
            if (arrays is not chain["base_arrays"]
                    or static_key != chain["static_key"]
                    or cl.node_version != chain["node_version"]):
                return None
            # version-chain discipline (the device_arrays contract):
            # capture the version BEFORE reading the logs and advance
            # checked_* only to the CAPTURED values. Mutators append
            # their log entry before bumping, so every entry describing
            # a version ≤ the capture is in the copy below; a mutation
            # landing mid-certify has ver > v_now and is examined next
            # time — never silently skipped.
            v_now = cl.version
            p_now = cl.ports_version
            hot = cl.hot_entries_since(chain["checked_version"], cl.n_cap)
            ports = (cl.port_words_since(chain["checked_ports"], cl.n_cap)
                     if hot is not None else None)
            if hot is None or ports is None:
                # a delta-log ring wrap ate the interval's evidence:
                # unprovable, but NOT silently — note the details here
                # (under the locks, where the cursors are stable) and
                # emit the counter + flight event after release
                wrap = {
                    "log": "hot" if hot is None else "ports",
                    "checked_version": int(chain["checked_version"]
                                           if hot is None
                                           else chain["checked_ports"]),
                    "version_now": int(v_now if hot is None else p_now),
                    "log_len": int(getattr(cl, "delta_log_len", 0) or 0),
                }
            else:
                result = _certify_interval_locked(
                    cl, chain, hot, ports, v_now, p_now)
    if wrap is not None:
        _chain_wrap_unprovable(cl, wrap)
        return None
    return result


def _certify_interval_locked(cl, chain, hot, ports, v_now, p_now):
    """Certification interval fold (both locks held, delta-log reads
    already resolved — see spec_chain_certify for the soundness
    argument). Returns the cumulative stale frozenset."""
    hot = [(ver, rows) for ver, rows in hot if ver <= v_now]
    # windows: observer-captured ∪ ring — the observer survives
    # ring wrap, the ring covers windows marked before the
    # observer was installed
    seen = set()
    windows = []
    for w in (chain["windows"]
              + cl.plan_windows_since(chain["checked_version"])):
        k = (w[0], w[1], w[2], w[4])
        if k not in seen:
            seen.add(k)
            windows.append(w)
    chain["windows"] = []
    expect = chain["expect"]
    stale = chain["stale"]
    proven = chain.setdefault("proven", set())
    # optimistic-rejection diagnostics: the rows whose
    # placements verification dropped this interval — surfaced
    # in the spec.rollback flight detail (their staleness is
    # already covered by the predicted-uncovered rule)
    chain["last_rejected"] = {
        int(r) for w in windows if w[5] for r in w[5]}
    covered = set()   # (eval_id, token) committed clean+exact
    for _lo, _hi, eid, ok, tok, _rej in windows:
        if ok and tok in expect and eid in expect[tok]["evals"]:
            covered.add((eid, tok))
    allowed_rows: Dict[int, set] = {}
    for tok, rec in expect.items():
        pred = rec["predicted"]
        if pred is None:
            # expected dispatch never resolved its outputs: its
            # placements are unprovable
            return None
        rows_ok = set(rec["stops"])
        for eid, rows in pred.items():
            if rows and (eid, tok) not in covered:
                # phantom placements: the carry baked them in,
                # no clean+exact commit vouches for them
                stale.update(rows)
            else:
                rows_ok.update(rows)
        allowed_rows[tok] = rows_ok
    for ver, rows in hot:
        w = None
        for v_lo, v_hi, eid, ok, tok, _rej in windows:
            if v_lo < ver <= v_hi:
                w = (eid, ok, tok)
                break
        if w is None:
            stale.update(rows)      # foreign mutation
            continue
        eid, ok, tok = w
        if not (ok and tok in expect and (eid, tok) in covered):
            stale.update(rows)      # partial/inexact/other-token
            continue
        # the window's clean+exact commit vouches for its predicted
        # placement rows bit-identically — the PROVEN complement the
        # published chain carry adopts; anything else in the entry
        # (stops already went stale on fold) diverges
        for r in rows:
            if r in allowed_rows[tok]:
                proven.add(int(r))
            else:
                stale.add(r)
    # the carry never models the port bitmap: every touched
    # port row diverges from the chain view's base ports
    # (entries past the p_now capture are examined again next
    # certify — stale is a set, re-adding is idempotent)
    stale.update(int(r) for r in ports)
    chain["checked_version"] = v_now
    chain["checked_ports"] = p_now
    # expected tokens are single-shot: their plans all committed
    # before this certification ran (the worker finishes batch k
    # before it certifies batch k+1), so their windows were in
    # THIS interval and must not be re-judged against the next
    chain["expect"] = {}
    return frozenset(stale)


def _chain_wrap_unprovable(cluster, detail: dict) -> None:
    """A delta-log ring wrap mid-chain lost the certification evidence
    for the interval. Count it and leave an actionable trace: the fix is
    sizing `NOMAD_TPU_DELTA_LOG` above the per-interval mutation volume.
    Called OUTSIDE the cache/spec locks (flight sinks may fan out)."""
    default_registry().inc("spec.chain_unprovable_wrap")
    try:
        from ..lib.flight import default_flight

        default_flight().record(
            "spec.rollback",
            key="chain-wrap:%s" % detail.get("log"),
            severity="warn",
            detail=dict(
                detail,
                reason="delta_log_wrap",
                finding=(
                    "speculation chain unprovable: the %s delta-log ring "
                    "wrapped past the chain's certification cursor "
                    "(checked %d, now %d, ring %d entries) — every "
                    "speculative result rolls back. Raise "
                    "NOMAD_TPU_DELTA_LOG (default %d) above the mutation "
                    "volume of one commit interval, or certify more "
                    "often." % (detail.get("log"),
                                detail.get("checked_version", -1),
                                detail.get("version_now", -1),
                                detail.get("log_len", 0),
                                DELTA_LOG_LEN)),
            ))
    except Exception:  # noqa: BLE001 — telemetry only
        pass


def chain_adopt_enabled() -> bool:
    """Chain-carry adoption default: ON (a certified-clean chain's HEAD
    carry IS the post-commit view for the rows it proved — adopting it
    is a tensor swap, zero transfer); NOMAD_TPU_SPEC_CHAIN_ADOPT=0 opts
    out."""
    return os.environ.get("NOMAD_TPU_SPEC_CHAIN_ADOPT", "1") \
        .strip().lower() not in ("0", "off", "false")


def spec_chain_publish_carry(cluster) -> bool:
    """Hand the chain's certified HEAD carry to the view cache as an
    adoptable CHAIN carry — called by the coordinator on every CLEAN
    certification (select_batch._certify_spec), never on rollback.

    The published record extends the single-dispatch carry note with
    the chain's accumulated certification evidence: `adopt_rows` (the
    proven complement — every row some clean+exact window of an
    expected token vouched for), `stale` (the cumulative superset of
    divergence, always overlaid), and `proven_version` (the certify
    cursor — mutations PAST it are judged at adoption time against the
    head token's own windows, because the head's plans commit after
    the certify that published it). A refresh landing mid-chain or
    post-chain then pays only the genuinely-foreign delta
    (device_arrays._chain_carry_overlay), never a full resync of
    spec-committed rows.

    Overwrites any previous publication (each clean certify supersedes
    the last); survives spec_chain_reset — the evidence is already
    certified, the chain object is not needed to use it. Returns True
    when a carry was published."""
    if not chain_adopt_enabled():
        return False
    with _DEV_CACHE_LOCK:
        with _SPEC_LOCK:
            chain = _SPEC_CHAINS.get(cluster)
            if chain is None or chain["head"] is None:
                return False
            ent = _entry(cluster, chain["device"])
            if ent is None:
                return False
            if (ent.get("arrays") is not chain["base_arrays"]
                    or ent["static_key"] != chain["static_key"]
                    or cluster.node_version != chain["node_version"]):
                return False
            head = chain["head"]
            ent["carry"] = {
                "chain": True,
                "token": head["token"],
                "base_arrays": chain["base_arrays"],
                "evals": set(head["evals"]),
                "stop_rows": set(head["stops"]),
                "used": head["used"],
                "dyn_free": head["dyn_free"],
                # may still be None here — carry_predicted fills it by
                # token match when the head's outputs land host-side
                "predicted": head["predicted"],
                "proven_version": chain["checked_version"],
                "stale": set(chain["stale"]),
                "adopt_rows": set(chain.get("proven", ())),
            }
            return True


def spec_chain_reset(cluster) -> None:
    """Drop the chain (rollback, refresh, shutdown): carries are
    released with their last reference, the window observer detaches."""
    with _SPEC_LOCK:
        chain = _SPEC_CHAINS.get(cluster)
        if chain is not None:
            _spec_reset_locked(cluster, chain)


def spec_chain_head_token(cluster) -> Optional[int]:
    """Token of the chain's current head carry (None when no chain) —
    test/introspection surface."""
    with _SPEC_LOCK:
        chain = _SPEC_CHAINS.get(cluster)
        head = chain["head"] if chain is not None else None
        return head["token"] if head is not None else None


def spec_chain_last_rejected(cluster) -> frozenset:
    """Node rows whose placements optimistic verification dropped in
    the last certified interval (plan_apply's rejected_rows) — the
    rollback flight detail names the rows that caused the conflict."""
    with _SPEC_LOCK:
        chain = _SPEC_CHAINS.get(cluster)
        if chain is None:
            return frozenset()
        return frozenset(chain.get("last_rejected") or ())


def _spec_reset_locked(cluster, chain) -> None:
    chain["head"] = None
    chain["expect"] = {}
    chain["windows"] = []
    _SPEC_CHAINS.pop(cluster, None)
    if getattr(cluster, "plan_window_observer", None) is not None:
        cluster.plan_window_observer = None


def _install_window_observer(cluster) -> None:
    """Commit-window → certification callback (tensor/cluster.py):
    windows reach the chain as they are marked, under the commit lock,
    so certification never depends on the bounded ring retaining them."""
    ref = weakref.ref(cluster)

    def _obs(rec):
        cl = ref()
        if cl is None:
            return
        with _SPEC_LOCK:
            chain = _SPEC_CHAINS.get(cl)
            if chain is not None:
                chain["windows"].append(rec)

    cluster.plan_window_observer = _obs


class TorchStack:
    """Compiles placement programs and drives the placement kernel."""

    def __init__(self, cluster: ClusterTensors, algorithm: str = "binpack",
                 explain: Optional[bool] = None,
                 device: DeviceLike = None) -> None:
        self.cluster = cluster
        self.algorithm = algorithm
        #: emit kernel-native attribution with every run (the AllocMetric
        #: feed); None defers to NOMAD_TPU_EXPLAIN
        self.explain = explain_enabled() if explain is None else explain
        self.device = resolve_device(device)
        # (namespace, job.id, version, modify_index, tg, volumes) →
        # compiled static program; re-evaluating the same job spec skips
        # the LUT compile entirely. LRU: hits are refreshed.
        self._prog_cache: "OrderedDict[tuple, dict]" = OrderedDict()
        self._prog_cache_max = 1024
        #: the server's batched path sets these (scheduler/generic.py):
        #: `select` then parks at the coordinator instead of running solo
        self.coordinator = None
        self.coordinator_order = 0

    # ---- device snapshot management ----

    def device_arrays(self, lease_token=None) -> ClusterArrays:
        """Device copy of the cluster tensors, cached per cluster object
        and device, keyed per tensor group by sub-versions and refreshed
        INCREMENTALLY from the cluster's bounded delta log.

        `lease_token` (a dispatch's token) registers a view lease
        ATOMICALLY with the resolve, under the cache lock — a lease taken
        after returning would leave a window where a concurrent refresh
        writes the tensors this caller is about to launch against.

        Static tensors (capacity, attrs) re-upload only when nodes/attrs
        change (node_version, the row caps, the attrs dtype); the hot
        tensors (used/node_ok/dyn_free) and the port bitmap ship as ROW
        DELTAS when the cached entry's version sits inside the delta-log
        window (tensor/cluster.py hot_entries_since/port_words_since),
        written by the row-delta kernels (K7) — with window misses,
        row-bucket growth, or deltas of more than n_cap // 4 rows falling
        back to a full upload. Delta values are cast exactly as the full
        upload casts them, so the view is bit-identical to a cold upload.

        Concurrency contract (version-chain): all version keys are
        captured BEFORE the delta rows are read or anything is uploaded,
        and mutators append to the delta log BEFORE bumping the version
        they describe — so a mutation racing this refresh either ships
        with it or leaves the stored entry stale (its captured version
        predates the bump), and the NEXT refresh re-applies those rows
        from the log. A concurrent mutation can delay convergence by one
        refresh, never silently corrupt the cached view.

        Writes: in place on the cached tensors when the entry holds no
        lease; with any lease held, into copies (the copy slot,
        `view.copy_slots`), so a leased view's tensors are never written.
        All writes go to the device's current stream, behind every launch
        already queued there; pinned staging buffers of the delta values
        stay alive until their copies ran (PyTorch's caching host
        allocator records the stream use).

        When a control-plane mesh is active (parallel/mesh.py
        set_active_mesh), the view is node-sharded over the mesh: every
        upload is split into its node shards (`shard_tensor`, one copy per
        distinct device of a node column) and the result is a
        `ShardedCluster`; row deltas run K7 per shard on every copy
        (B13). The mesh is part of the static and ports keys and of delta
        eligibility, so a mesh flip is a full upload; carry adoption
        declines. A lease covers every shard and copy. The mesh's lead
        device must be this stack's device."""
        from ..lib.hbm import default_hbm
        from ..lib.transfer import default_ledger
        from ..parallel.mesh import (assemble, copy_fields, get_active_mesh,
                                     shard_copies, shard_tensor)

        reg = default_registry()
        led = default_ledger()
        hbm = default_hbm()
        cl = self.cluster
        dev = _dev_key(self.device)
        mesh = get_active_mesh()
        if mesh is not None and _dev_key(mesh.grid()[0][0]) != dev:
            raise ValueError(f"the active mesh leads on {mesh.grid()[0][0]}, "
                             f"this stack places on {dev}")

        def up(a, dtype=None):
            if mesh is None:
                return tensor_from_numpy(a, dev, dtype)
            return shard_tensor(tensor_from_numpy(a, torch.device("cpu"),
                                                  dtype), mesh)

        #: rows of a node shard under a mesh (None: the view is whole)
        shard_rows = (None if mesh is None
                      else cl.n_cap // mesh.devices.shape[1])

        with _DEV_CACHE_LOCK:
            # capture ALL keys BEFORE reading delta rows or uploading: a
            # concurrent mutation mid-refresh must make the stored entry
            # look stale (next caller re-applies), never current with
            # old data
            version = cl.version
            ports_version = cl.ports_version
            # attrs compaction: vocab tokens are small ints — int16
            # halves the second-largest static tensor (int32 once any
            # key's vocabulary approaches the i16 range); the dtype rides
            # the static key so the flip is a clean re-upload
            attr_dt = np.int16 if cl.vocab.max_vocab < 32000 else np.int32
            static_key = (cl.node_version, cl.n_cap, cl.k_cap, mesh,
                          attr_dt)
            ports_key = (ports_version, cl.n_cap, mesh)
            per_dev = _DEV_CACHE.setdefault(cl, {})
            ent = per_dev.get(dev)
            if ent is not None and ent["version"] == version \
                    and ent["static_key"] == static_key \
                    and ent["ports_key"] == ports_key:
                return _leased(ent, lease_token)
            #: live view leases (launches in flight against the cached
            #: tensors): with any held, updates must COPY into a second
            #: slot instead of writing in place. The set object is shared
            #: with device_arrays(lease_token=)/release_view and carries
            #: forward across refreshes.
            leases = ent.get("leases") if ent is not None else None
            if leases is None:
                leases = set()
            in_place = not leases
            if not in_place:
                reg.inc("view.copy_slots")
            carry = ent.pop("carry", None) if ent is not None else None
            if ent is not None and ent["static_key"] == static_key:
                capacity, attrs = ent["capacity"], ent["attrs"]
            else:
                nb = (cl.capacity.nbytes
                      + cl.attrs.size * np.dtype(attr_dt).itemsize)
                with led.timed("stack.static_full", nb, count=2):
                    capacity = up(cl.capacity, np.float32)
                    attrs = up(cl.attrs, attr_dt)
                reg.inc("view.upload_bytes", nb)
            # delta eligibility: the same mesh and row bucket — a grown
            # n_cap changes every tensor's shape, a mesh flip its
            # placement; neither is expressible as row writes
            can_delta = (ent is not None and ent["n_cap"] == cl.n_cap
                         and ent["mesh"] is mesh)
            limit = max(8, cl.n_cap // 4)
            prev = ent["arrays"] if ent is not None else None
            # the view's tensors by field: tensors, or under a mesh each
            # field's {(device, node shard): copy}
            prev_f = (copy_fields(prev)
                      if ent is not None and ent["mesh"] is not None
                      else prev)

            #: the refresh's row delta, gathered here and flushed once,
            #: and the ledger bookings (site, bytes, count) of its parts
            delta = ViewDelta()
            sites = []
            hot_entries = (cl.hot_entries_since(ent["version"], limit)
                           if can_delta else None)
            hot_rows = None
            if hot_entries is not None:
                hot_rows = set()
                for _ver, rs in hot_entries:
                    hot_rows.update(rs)
            skip: set = set()
            overlay: Optional[set] = None
            adopted = False
            if (carry is not None and carry.get("chain")
                    and not chain_adopt_enabled()):
                # opt-out mid-life (publish is gated too, but a carry
                # published before the flip may still be pending):
                # plain refresh, no adopt/reject accounting
                carry = None
            if carry is not None and carry.get("chain"):
                # certified speculation-chain HEAD carry
                # (spec_chain_publish_carry): its own evidence replaces
                # the small-limit hot_entries read — a long chain's row
                # set routinely exceeds it, and the proof lives in the
                # chain's certify cursor + the head token's windows
                res = (self._chain_carry_overlay(cl, ent, carry, prev,
                                                 mesh)
                       if can_delta else None)
                if res is not None:
                    skip, overlay = res
                    adopted = True
                    reg.inc("view.chain_adopts")
                    reg.inc("view.chain_rows", len(skip))
                    # the bytes a post-chain refresh would otherwise
                    # re-upload for the spec-committed rows: one delta
                    # row (idx + used + node_ok + dyn_free) per skip
                    row_nb = (4 + cl.used.shape[-1] * 4
                              + cl.node_ok.dtype.itemsize
                              + cl.dyn_free.nbytes
                              // max(cl.dyn_free.shape[0], 1))
                    reg.inc("spec.resync_bytes_saved",
                            row_nb * len(skip))
                else:
                    reg.inc("view.chain_rejects")
                    carry = None
            if not adopted and carry is not None and hot_rows:
                skip = self._carry_skip_rows(cl, ent, carry, prev,
                                             hot_entries, mesh)
                adopted = skip is not None
                if not adopted:
                    skip = set()
                    reg.inc("view.carry_rejects")
            elif not adopted and carry is not None:
                reg.inc("view.carry_rejects")
            if adopted:
                # D2D plan delta: the dispatch's own chain carry IS the
                # post-commit view for the rows its plans placed — adopt
                # it wholesale (a tensor swap, zero transfer) and
                # overlay only the rows something ELSE touched from
                # host. node_ok never changes via plan commits, so the
                # previous tensor rides along. stop_rows ALWAYS overlay,
                # even when unchanged host-side: the carry baked every
                # program's plan-relative delta subtraction into used0,
                # and a plan that never committed would otherwise leave
                # a phantom release on rows no hot entry names.
                used, dyn_free = carry["used"], carry["dyn_free"]
                node_ok = prev.node_ok
                if overlay is None:
                    overlay = (hot_rows - skip) | {
                        r for r in carry["stop_rows"] if r < cl.n_cap}
                    reg.inc("view.carry_adopts")
                    reg.inc("view.carry_rows", len(skip))
                if overlay:
                    used, node_ok, dyn_free = self._apply_hot_rows(
                        cl, (used, node_ok, dyn_free), overlay, in_place,
                        delta, sites)
                    reg.inc("view.delta_rows", len(overlay))
            elif hot_rows is not None:
                if hot_rows:
                    used, node_ok, dyn_free = self._apply_hot_rows(
                        cl, (prev_f.used, prev_f.node_ok, prev_f.dyn_free),
                        hot_rows, in_place, delta, sites)
                    reg.inc("view.delta_rows", len(hot_rows))
                else:
                    # version bumped without touching hot rows (job
                    # index churn, vocab growth): the tensors are current
                    used, node_ok, dyn_free = (prev_f.used, prev_f.node_ok,
                                               prev_f.dyn_free)
            else:
                nb = (cl.used.size * 4 + cl.node_ok.nbytes
                      + cl.dyn_free.nbytes)
                with led.timed("stack.hot_full", nb, count=3):
                    used = up(cl.used, np.float32)
                    node_ok = up(cl.node_ok, np.bool_)
                    dyn_free = up(cl.dyn_free, np.float32)
                reg.inc("view.full_uploads")
                reg.inc("view.upload_bytes", nb)

            if ent is not None and ent["ports_key"] == ports_key:
                ports_used = ent["ports_used"]
            else:
                port_words = (cl.port_words_since(ent["ports_version"],
                                                  limit)
                              if can_delta else None)
                if port_words:
                    ports_used = self._apply_port_words(
                        cl, ent["ports_used"], port_words, in_place, delta,
                        sites, reg)
                elif port_words is not None:
                    ports_used = ent["ports_used"]
                else:
                    nb = cl.ports_used.nbytes
                    with led.timed("stack.ports_full", nb):
                        ports_used = up(cl.ports_used)
                    reg.inc("view.ports_full_uploads")
                    reg.inc("view.upload_bytes", nb)
            if delta:
                # K7: every part of the delta in one packed buffer, one
                # staged copy and one launch (under a mesh one buffer a
                # device and one launch a shard copy with changes). The
                # parts book the bytes and counts of the arrays they
                # ship at their own sites; the flush's host time (pack,
                # copy, launch) books at the first of them, so every
                # site stays in the reference's vocabulary.
                t0 = time.perf_counter()
                apply_view_delta((used, node_ok, dyn_free, ports_used),
                                 delta, shard_rows)
                flush_s = time.perf_counter() - t0
                for i, (site, nb, count) in enumerate(sites):
                    led.record(site, nb, flush_s if i == 0 else 0.0, count)
                # one event per refresh that applied any row delta (hot
                # and/or ports) — pure port flips must not read as "no
                # delta activity"
                reg.inc("view.delta_uploads")
            st = cl.delta_stats()
            reg.set_gauge("view.hot_log_len", st["hot_log_len"])
            reg.set_gauge("view.ports_log_len", st["ports_log_len"])

            fields = ClusterArrays(
                capacity=capacity,
                used=used,
                node_ok=node_ok,
                attrs=attrs,
                ports_used=ports_used,
                dyn_free=dyn_free,
            )
            arrays = (fields if mesh is None
                      else assemble(mesh, cl.n_cap, fields))
            # residency ledger: book the refreshed view slots by site
            # class (each shard copy on its device). Tensors carried
            # forward are already booked (no-op); an adopted carry
            # RE-SITES from select_batch.carry to the view (the swap moves
            # ownership, not bytes); replaced tensors auto-release once
            # their last reference (an in-flight launch's lease, a copy
            # slot's source) drops.
            for view in ((arrays,) if mesh is None
                         else shard_copies(arrays).values()):
                hbm.track_cluster("stack.view", view, cl.n_cap)
            per_dev[dev] = {
                "version": version, "arrays": arrays, "mesh": mesh,
                "static_key": static_key, "capacity": capacity,
                "attrs": attrs, "ports_key": ports_key,
                "ports_version": ports_version,
                "ports_used": ports_used,
                "n_cap": cl.n_cap,
                "leases": leases, "carry": None,
            }
            # a chain anchored to the REPLACED arrays of this device can
            # never certify or publish again (the object-identity guard
            # fails), so it is dead weight that pins a full generation
            # of hot tensors — retire it with the rebuild. Its published
            # carry was snapshotted into the old entry and already
            # consumed (or rejected) above; in-flight dispatches observe
            # the same None-certify → rollback they would have anyway.
            with _SPEC_LOCK:
                chain = _SPEC_CHAINS.get(cl)
                if (chain is not None and chain["device"] == dev
                        and chain["base_arrays"] is not arrays):
                    _spec_reset_locked(cl, chain)
            return _leased(per_dev[dev], lease_token)

    @staticmethod
    def _apply_hot_rows(cl, bufs, rows, in_place, delta, sites):
        """Add the CURRENT host values of `rows` to the refresh's `delta`
        as its hot part (its ledger booking to `sites`), for the hot
        tensors `bufs` = (used, node_ok, dyn_free) — copies of them unless
        `in_place` — and return the tensors the flush writes."""
        idx, uvals, ovals, dvals = _delta_rows_host(
            rows, cl.used, cl.node_ok, cl.dyn_free)
        if not in_place:
            bufs = tuple(_clone(b) for b in bufs)
        nb = idx.nbytes + uvals.size * 4 + ovals.nbytes + dvals.nbytes
        delta.add_hot(idx, uvals, ovals, dvals)
        sites.append(("stack.hot_delta", nb, 4))
        default_registry().inc("view.upload_bytes", nb)
        return bufs

    @staticmethod
    def _carry_skip_rows(cl, ent, carry, prev, hot_entries, mesh):
        """Decide whether a dispatch carry is adoptable and which rows
        it covers. Returns the SKIP row set (rows whose device values
        the carry already holds — no upload needed), or None to reject.

        Proof obligations, all host-side and cheap:
        - the cached entry still holds the exact arrays the chain
          consumed (object identity — any interleaved refresh rebuilt
          the namedtuple and invalidates);
        - the dispatch's outputs have landed (predicted rows known);
        - every chained eval that predicted placements committed its
          plan CLEAN (full commit) and EXACT (scheduler certified
          usage == kernel ask, integral), and that plan's carry_token
          matches THIS dispatch — a later retry plan of the same eval
          (different dispatch, or no dispatch at all) can never vouch
          for this carry's placements. Otherwise a placement the carry
          contains might never have committed (phantom usage on a row
          no overlay would ever fix), so the whole carry is dropped;
        - a row only skips if EVERY change to it came from a covered
          plan window, it was a predicted placement row, and no
          program's plan-relative deltas (stops/preempts — their port
          credits adjust dyn_free in ways the chain carry deliberately
          does not model) touched it. Everything else overlays from
          host, which is always authoritative.

        Declines under a mesh (active now, or when the entry was built):
        no carry is adopted into a sharded view."""
        if mesh is not None or ent["mesh"] is not None:
            return None
        if carry["base_arrays"] is not prev:
            return None
        predicted = carry["predicted"]
        if predicted is None:
            return None
        windows = cl.plan_windows_since(ent["version"])
        token = carry["token"]
        covered_evals = {w[2] for w in windows
                         if w[3] and w[4] == token
                         and w[2] in carry["evals"]}
        for eid, rows in predicted.items():
            if rows and eid not in covered_evals:
                return None
        covered_rows: set = set()
        uncovered_rows: set = set()
        for ver, rs in hot_entries:
            cov = False
            for v_lo, v_hi, eid, ok, w_tok, _rej in windows:
                if v_lo < ver <= v_hi:
                    cov = (ok and w_tok == token
                           and eid in covered_evals)
                    break
            (covered_rows if cov else uncovered_rows).update(rs)
        pred_rows: set = set()
        for rows in predicted.values():
            pred_rows.update(rows)
        return ((covered_rows & pred_rows) - uncovered_rows
                - carry["stop_rows"])

    @staticmethod
    def _chain_carry_overlay(cl, ent, carry, prev, mesh):
        """Decide whether a certified CHAIN carry
        (spec_chain_publish_carry) is adoptable and split the rows into
        (skip, overlay), or return None to reject outright.

        Evidence layout: rows changed in [entry version,
        proven_version] were classified by chain certification into
        `adopt_rows` (proven: clean+exact window of an expected token,
        predicted placement row — the carry holds their committed
        values bit-identically) or `stale` (everything else); rows
        changed PAST proven_version (the head's own commits land after
        the certify that published the carry, and anything foreign can
        land too) are judged HERE against the head token's windows with
        exactly the single-dispatch `_carry_skip_rows` rules. The
        overlay — host-authoritative rewrite — is the union of stale,
        the head's stop rows, the unproven tail, and any head
        prediction no clean window vouches for (a refresh landing
        mid-chain: the in-flight dispatch's placements are phantoms
        until their windows commit — overlaying them keeps the proven
        prefix adoptable instead of rejecting the whole carry).
        Everything in neither set is unchanged since the entry's
        upload, and the carry equals the base there by construction.
        Declines under a mesh, as `_carry_skip_rows` does."""
        if mesh is not None or ent["mesh"] is not None:
            return None
        if carry["base_arrays"] is not prev:
            return None
        predicted = carry["predicted"]
        if predicted is None:
            # head outputs never landed: its placement rows are unknown
            # — nothing bounds the phantom set, reject
            return None
        tail = cl.hot_entries_since(carry["proven_version"], cl.n_cap)
        if tail is None:
            return None
        windows = cl.plan_windows_since(carry["proven_version"])
        token = carry["token"]
        covered_evals = {w[2] for w in windows
                         if w[3] and w[4] == token
                         and w[2] in carry["evals"]}
        phantom: set = set()
        for eid, rows in predicted.items():
            if rows and eid not in covered_evals:
                phantom.update(rows)
        covered_rows: set = set()
        uncovered_rows: set = set()
        for ver, rs in tail:
            cov = False
            for v_lo, v_hi, eid, ok, w_tok, _rej in windows:
                if v_lo < ver <= v_hi:
                    cov = (ok and w_tok == token
                           and eid in covered_evals)
                    break
            (covered_rows if cov else uncovered_rows).update(rs)
        pred_rows: set = set()
        for rows in predicted.values():
            pred_rows.update(rows)
        tail_skip = ((covered_rows & pred_rows) - uncovered_rows
                     - carry["stop_rows"])
        n = cl.n_cap
        overlay = {r for r in carry["stale"] if r < n}
        overlay.update(r for r in carry["stop_rows"] if r < n)
        overlay.update(r for r in uncovered_rows if r < n)
        overlay.update(r for r in phantom if r < n)
        skip = ((carry["adopt_rows"] | tail_skip) - overlay)
        return skip, overlay

    @staticmethod
    def _apply_port_words(cl, ports_buf, port_words, in_place, delta, sites,
                          reg):
        """Add a word-granular port delta to the refresh's `delta` (its
        ledger bookings to `sites`):
        whole rows for rebuilt rows (node upsert/remove), single u32 words
        for port flips — the steady-state case ships 4-byte words instead
        of 8 KiB rows (`stack.ports_word_delta`). A row is in one of the
        two parts, never both (the flush's one launch relies on it).
        Returns the bitmap the flush writes: a copy unless `in_place`."""
        full_rows = sorted(r for r, ws in port_words.items()
                           if ws is None)
        word_items = sorted((r, w) for r, ws in port_words.items()
                            if ws is not None for w in ws)
        if not in_place:
            ports_buf = _clone(ports_buf)
        if full_rows:
            pidx, pvals = _delta_rows_host(full_rows, cl.ports_used)
            nb = pidx.nbytes + pvals.nbytes
            delta.add_port_rows(pidx, pvals)
            sites.append(("stack.ports_delta", nb, 2))
            reg.inc("view.delta_rows", len(full_rows))
            reg.inc("view.upload_bytes", nb)
        if word_items:
            rows_a = np.fromiter((r for r, _ in word_items),
                                 dtype=np.int32, count=len(word_items))
            words_a = np.fromiter((w for _, w in word_items),
                                  dtype=np.int32, count=len(word_items))
            vals_a = cl.ports_used[rows_a, words_a]
            nb = rows_a.nbytes + words_a.nbytes + vals_a.nbytes
            delta.add_port_words(rows_a, words_a, vals_a)
            sites.append(("stack.ports_word_delta", nb, 3))
            reg.inc("view.ports_words", len(word_items))
            reg.inc("view.upload_bytes", nb)
        return ports_buf

    # ---- program compilation ----

    def compile_tg(
        self,
        job: Job,
        tg: TaskGroup,
        n_place: int,
        plan: Optional[PlanContext] = None,
        max_allocs: Optional[int] = None,
        volumes: Optional[list] = None,
        sampled_rows: Optional[Sequence[int]] = None,
    ) -> Tuple[TGParams, int]:
        """Build TGParams (numpy; converted on dispatch). `volumes` are
        pre-resolved feasibility entries from the scheduler (host/csi —
        the scheduler resolves CSI volume ids against state because the
        stack itself is stateless; see constraints.compile_constraints).
        `sampled_rows` restricts selection to those node rows (the log₂(n)
        limit-iterator analog, stack.go:77-89) — pass the same shuffled
        subset to the oracle's `sampled=` mode for strict parity."""
        plan = plan or PlanContext()
        cl = self.cluster

        prog = self._static_program(job, tg, volumes)
        cc: CompiledConstraints = prog["cc"]
        v: int = prog["v"]
        feas_lut = prog["feas_lut"]
        aff_lut = prog["aff_lut"]
        ca: CompiledAffinities = prog["ca"]
        spreads = prog["spreads"]
        dh_job = prog["dh_job"]
        distinct = prog["distinct"]
        extra = prog["extra"]
        if extra is None:
            # trivially all-true: ship one broadcastable element, not [N]
            extra = np.ones(1, dtype=bool)

        # per-eval count maps (state + plan adjustments), kept sparse: a job
        # touches few nodes, so these ship as (row, count) pairs and are
        # scattered to dense [N] on device (kernels/placement.py)
        jc: Dict[int, float] = {}
        jtc: Dict[int, float] = {}
        for row, tgname in cl.job_allocs.get(job.id, {}).values():
            jc[row] = jc.get(row, 0.0) + 1.0
            if tgname == tg.name:
                jtc[row] = jtc.get(row, 0.0) + 1.0
        for a in plan.stopped_allocs + plan.preempted_allocs:
            if a.job_id == job.id:
                row = cl.row_of.get(a.node_id)
                if row is not None:
                    jc[row] = max(jc.get(row, 0.0) - 1.0, 0.0)
                    if a.task_group == tg.name:
                        jtc[row] = max(jtc.get(row, 0.0) - 1.0, 0.0)
        for node_id, tgname, _usage in plan.placed:
            row = cl.row_of.get(node_id)
            if row is not None:
                jc[row] = jc.get(row, 0.0) + 1.0
                if tgname == tg.name:
                    jtc[row] = jtc.get(row, 0.0) + 1.0
        dh_counts = jc if dh_job else jtc
        jc_idx, jc_val = _sparse_counts(dh_counts)
        jtc_idx, jtc_val = _sparse_counts(jtc)

        # resource deltas: in-plan stops/preempts release, placements consume
        deltas: List[Tuple[int, np.ndarray]] = []
        for a in plan.stopped_allocs + plan.preempted_allocs:
            row_entry = cl.alloc_usage.get(a.id)
            if row_entry is not None:
                deltas.append(row_entry)
        for node_id, _tgname, usage in plan.placed:
            row = cl.row_of.get(node_id)
            if row is not None:
                deltas.append((row, -usage))
        d = _bucket(max(len(deltas), 1))
        delta_idx = np.full(d, -1, dtype=np.int32)
        delta_res = np.zeros((d, R_TOTAL), dtype=np.float32)
        for i, (row, usage) in enumerate(deltas):
            delta_idx[i] = row
            delta_res[i] = usage

        m = max_allocs if max_allocs is not None else _bucket(max(n_place, 1))

        # per-step penalty / preferred node rows
        p_max = max((len(s) for s in plan.penalty_node_ids), default=0)
        p_bucket = _bucket(max(p_max, 1))
        penalty_idx = np.full((m, p_bucket), -1, dtype=np.int32)
        for i, nids in enumerate(plan.penalty_node_ids[:m]):
            for j, nid in enumerate(sorted(nids)[:p_bucket]):
                row = cl.row_of.get(nid)
                if row is not None:
                    penalty_idx[i, j] = row
        preferred_idx = np.full(m, -1, dtype=np.int32)
        for i, nid in enumerate(plan.preferred_node_ids[:m]):
            if nid is not None:
                row = cl.row_of.get(nid)
                if row is not None:
                    preferred_idx[i] = row

        # plan-relative port deltas: stops/preempts release their ports,
        # in-plan placements consume theirs (proposed-alloc NetworkIndex,
        # rank.go:240); sparse (row, port) pairs, −1 padded
        pclr_pairs: List[Tuple[int, int]] = []
        for a in plan.stopped_allocs + plan.preempted_allocs:
            row = cl.row_of.get(a.node_id)
            if row is not None:
                for port in ClusterTensors._alloc_port_list(a):
                    pclr_pairs.append((row, port))
        pset_pairs: List[Tuple[int, int]] = []
        for a in plan.placed_allocs:
            row = cl.row_of.get(a.node_id)
            if row is not None:
                for port in ClusterTensors._alloc_port_list(a):
                    pset_pairs.append((row, port))

        def _pairs(pairs):
            b = _bucket(max(len(pairs), 1))
            idx = np.full(b, -1, dtype=np.int32)
            prt = np.full(b, -1, dtype=np.int32)
            for i, (row, port) in enumerate(pairs):
                idx[i], prt[i] = row, port
            return idx, prt

        pclr_idx, pclr_port = _pairs(pclr_pairs)
        pset_idx, pset_port = _pairs(pset_pairs)

        # sampled-candidate restriction
        if sampled_rows is not None:
            cand_idx = np.full(_bucket(max(len(sampled_rows), 1)), -1,
                               dtype=np.int32)
            for i, row in enumerate(sampled_rows):
                cand_idx[i] = row
            use_cand = np.bool_(True)
        else:
            cand_idx = np.full(1, -1, dtype=np.int32)
            use_cand = np.bool_(False)

        # spread program: cached static tables + per-eval counts
        sp = prog["sp_static"]
        sp_counts0 = self._spread_counts(job, tg, prog, plan)

        # distinct_property: per-constraint combined use counts
        # (propertyset.go:250 GetCombinedUseMap) + constant-LTarget clamp
        dp_key_idx, dp_allowed, dp_active, dp_counts0, n_place = \
            self._dp_program(job, tg, prog, plan, n_place)

        params = TGParams(
            ask=prog["ask"],
            n_place=np.int32(n_place),
            desired_count=np.float32(max(tg.count, 1)),
            algorithm=np.int32(1 if self.algorithm == "spread" else 0),
            key_idx=cc.key_idx,
            lut=feas_lut,
            aff_key_idx=ca.key_idx,
            aff_lut=aff_lut,
            aff_inv_sum=np.float32(ca.inv_sum_abs_weight),
            penalty_idx=penalty_idx,
            preferred_idx=preferred_idx,
            extra_mask=extra,
            distinct_hosts=np.bool_(distinct),
            jc_idx=jc_idx,
            jc_val=jc_val,
            jtc_idx=jtc_idx,
            jtc_val=jtc_val,
            delta_idx=delta_idx,
            delta_res=delta_res,
            cand_idx=cand_idx,
            use_cand=use_cand,
            res_ports=prog["res_ports"],
            n_dyn=np.float32(prog["n_dyn"]),
            pclr_idx=pclr_idx,
            pclr_port=pclr_port,
            pset_idx=pset_idx,
            pset_port=pset_port,
            dp_key_idx=dp_key_idx,
            dp_allowed=dp_allowed,
            dp_counts0=dp_counts0,
            dp_active=dp_active,
            spread_key_idx=sp[0],
            spread_weight=sp[1],
            spread_has_targets=sp[2],
            spread_desired=sp[3],
            spread_counts0=sp_counts0,
            spread_active=sp[4],
        )
        return params, m

    def _static_program(self, job: Job, tg: TaskGroup,
                        volumes: Optional[list]) -> dict:
        """Compile (or fetch) the plan-independent half of a placement
        program: constraint/affinity LUTs, width, host-check mask, spread
        statics, ask vector. Keyed by job identity+version; invalidated
        when a referenced key's vocabulary grows (new values would need new
        LUT columns) or — for host-evaluated constraints — when the node
        set changes. This is the `compile_tg` hot path killer: the scalar
        LUT build ran once per eval per batch before caching."""
        cl = self.cluster
        vocab = cl.vocab
        cache_key = (job.namespace, job.id, job.version, job.modify_index,
                     tg.name, tuple(volumes) if volumes else ())
        ent = self._prog_cache.get(cache_key)
        if ent is not None:
            sizes = tuple(len(vocab.key_vocabs[k]) for k in ent["used_keys"])
            fresh = (sizes == ent["vocab_sizes"]
                     and ent["n_devcols"] == len(cl.device_cols))
            if fresh and ent["host_dep"]:
                # node-only version: alloc churn must not evict host masks
                fresh = ent["node_version"] == cl.node_version
            if fresh:
                self._prog_cache.move_to_end(cache_key)
                return ent

        combined = list(job.constraints) + list(tg.constraints)
        for t in tg.tasks:
            combined.extend(t.constraints)
        drivers = sorted({t.driver for t in tg.tasks})
        cc = compile_constraints(
            combined, vocab, datacenters=job.datacenters, drivers=drivers,
            volumes=volumes,
        )
        affinities = list(job.affinities) + list(tg.affinities)
        for t in tg.tasks:
            affinities.extend(t.affinities)
        ca = compile_affinities(affinities, vocab)

        # LUT widths can differ between the compiles (each is sized to the
        # keys it references); normalize to a common per-program width so
        # the kernel sees one V. Spread keys take part: their desired/count
        # tables index by value token of their own keys.
        spreads = list(tg.spreads) + list(job.spreads)
        spread_keys = []
        spread_w = 2
        for s in spreads:
            skey = target_to_key(s.attribute) or s.attribute
            k = vocab.intern_key(skey)
            spread_keys.append(k)
            spread_w = max(spread_w, len(vocab.key_vocabs[k]) + 1)

        # distinct_property specs (feasible.go:588-622: job-level from
        # job.constraints, tg-level from tg.constraints; propertyset.go:82:
        # RTarget count, default 1, unparsable ⇒ nothing feasible).
        # Constant (non-interpolated) LTargets resolve to one shared value
        # for every node (resolveTarget on a literal), capping TOTAL
        # placements — handled as spec key None.
        dp_specs: List[Tuple[Optional[int], float, bool]] = []
        for c, tg_scope in ([(c, False) for c in job.constraints]
                            + [(c, True) for c in tg.constraints]):
            if c.operand != CONSTRAINT_DISTINCT_PROPERTY:
                continue
            allowed = 1.0
            valid = True
            if c.rtarget:
                try:
                    allowed = float(int(c.rtarget))
                    valid = allowed >= 0
                except ValueError:
                    valid = False
            key = target_to_key(c.ltarget)
            if not valid:
                # unparsable RTarget: every node fails the check
                dp_specs.append((vocab.intern_key("node.datacenter"),
                                 0.0, tg_scope))
            elif key is None or key == "__unresolvable__":
                lit = key is None  # literal resolves; unknown interp doesn't
                dp_specs.append((None if lit else
                                 vocab.intern_key("node.datacenter"),
                                 allowed if lit else 0.0, tg_scope))
            else:
                k = vocab.intern_key(key)
                dp_specs.append((k, allowed, tg_scope))
                spread_w = max(spread_w, len(vocab.key_vocabs[k]) + 1)

        v = max(cc.lut.shape[1] if cc.lut.size else 2,
                ca.lut.shape[1] if ca.lut.size else 2,
                _bucket(spread_w, 2))
        feas_lut = _pad_lut(cc.lut, v, fill=False, dtype=np.bool_)
        aff_lut = _pad_lut(ca.lut, v, fill=0.0, dtype=np.float32)
        # Keys interned during compilation must exist as attrs columns before
        # the device gather (token −1 everywhere for brand-new keys).
        while vocab.num_keys > cl.k_cap:
            cl._grow_keys()
            cl.version += 1

        # host-evaluated constraints (node-dependent RTarget) → extra mask;
        # None ⇒ trivially all-true (materialized per call at current n_cap).
        # Device asks host-check (DeviceChecker, feasible.go:1138) ONLY when
        # the pool columns can't express them: constrained asks,
        # model-specific (3-part) asks, or asks matching no registered pool
        # — unconstrained vendor/type asks are exactly the capacity column.
        dev_asks = [d for t in tg.tasks for d in t.resources.devices]
        dev_host = [d for d in dev_asks
                    if d.constraints or len(d.name.split("/")) == 3
                    or self._device_ask_col(d.name) is None]
        host_dep = bool(cc.needs_host or ca.needs_host) or bool(dev_host)
        extra = None
        if host_dep:
            from .device import node_devices_feasible

            extra = np.ones(cl.n_cap, dtype=bool)
            for node_id, row in cl.row_of.items():
                node = cl.nodes[node_id]
                if cc.needs_host and not meets_constraints(node, cc.needs_host):
                    extra[row] = False
                elif dev_host and not node_devices_feasible(node, dev_host):
                    extra[row] = False

        # distinct_hosts flags (feasible.go:494-500: job level vs tg level)
        dh_job = any(c.operand == CONSTRAINT_DISTINCT_HOSTS
                     for c in job.constraints)
        dh_tg = any(c.operand == CONSTRAINT_DISTINCT_HOSTS
                    for c in tg.constraints)
        # NB: tg-level distinct_hosts requires job+tg collision; job-level
        # only job collision. The kernel has one count vector; encode
        # tg-level by using the jobtg counts as the distinct counts.
        distinct = dh_job or dh_tg

        # ask vector (static: depends only on the job spec + device columns)
        ask = np.zeros(R_TOTAL, dtype=np.float32)
        res = job.combined_task_resources(tg)
        ask[0], ask[1], ask[2] = res.cpu, res.memory_mb, res.disk_mb
        ask[3] = sum(nw.mbits for nw in tg.networks) + sum(
            nw.mbits for t in tg.tasks for nw in t.resources.networks
        )
        for t in tg.tasks:
            for dev in t.resources.devices:
                col = self._device_ask_col(dev.name)
                if col is not None:
                    ask[col] += dev.count

        # static port asks (group + task networks): reserved host ports and
        # dynamic-port count feed the kernel's rank-time port mask
        res_asks = [pt.value
                    for nets in ([tg.networks]
                                 + [t.resources.networks for t in tg.tasks])
                    for nw in nets for pt in nw.reserved_ports
                    if 0 <= pt.value < 65536]
        res_ports = np.full(_bucket(max(len(res_asks), 1)), -1,
                            dtype=np.int32)
        for i, pt in enumerate(res_asks):
            res_ports[i] = pt
        n_dyn = float(sum(
            len(nw.dynamic_ports)
            for nets in ([tg.networks]
                         + [t.resources.networks for t in tg.tasks])
            for nw in nets))

        sp_static = self._compile_spreads_static(tg, spreads, spread_keys, v)

        used_keys = tuple(
            sorted({int(k) for k in cc.key_idx}
                   | {int(k) for k in ca.key_idx} | set(spread_keys)
                   | {k for k, _a, _s in dp_specs if k is not None}))
        ent = {
            "cc": cc, "ca": ca, "v": v,
            "feas_lut": feas_lut, "aff_lut": aff_lut,
            "spreads": spreads, "spread_keys": spread_keys,
            "sp_static": sp_static, "dp_specs": dp_specs,
            "dh_job": dh_job, "distinct": distinct,
            "extra": extra, "host_dep": host_dep,
            "ask": ask, "res_ports": res_ports, "n_dyn": n_dyn,
            "used_keys": used_keys,
            "vocab_sizes": tuple(len(vocab.key_vocabs[k])
                                 for k in used_keys),
            "n_devcols": len(cl.device_cols),
            "node_version": cl.node_version,
        }
        if cache_key in self._prog_cache:
            # stale-recompile replace: refresh recency, never evict others
            self._prog_cache[cache_key] = ent
            self._prog_cache.move_to_end(cache_key)
        else:
            if len(self._prog_cache) >= self._prog_cache_max:
                self._prog_cache.popitem(last=False)  # evict least-recent
            self._prog_cache[cache_key] = ent
        return ent

    def _device_ask_col(self, name: str) -> Optional[int]:
        # Match the ask against the registered vendor/type device pools
        # (structs.RequestedDevice.ID, structs.go:2552-2554: <type>,
        # <vendor>/<type>, <vendor>/<type>/<name>). Model-specific 3-part
        # asks charge their pool's column; the exact group is resolved
        # host-side (DeviceAllocator) with offer-retry on mismatch.
        for pool, col in self.cluster.device_cols.items():
            vendor, dtype = pool.split("/")
            parts = name.split("/")
            if (
                (len(parts) == 1 and parts[0] == dtype)
                or (len(parts) >= 2 and parts[0] == vendor
                    and parts[1] == dtype)
            ):
                return col
        return None

    def _dp_program(self, job, tg, prog: dict, plan: PlanContext,
                    n_place: int):
        """distinct_property dynamic state: combined use counts per value
        token (existing − plan stops + plan placements, with the
        propertyset.go:196-207 cleared-value adjustment). Constant-LTarget
        specs share one value across all nodes, so they clamp the number
        of placements instead of masking nodes."""
        cl = self.cluster
        v = prog["v"]
        specs = prog["dp_specs"]
        pb = _bucket(max(len(specs), 1))
        key_idx = np.zeros(pb, dtype=np.int32)
        allowed = np.zeros(pb, dtype=np.float32)
        active = np.zeros(pb, dtype=bool)
        counts0 = np.zeros((pb, v), dtype=np.float32)
        if not specs:
            return key_idx, allowed, active, counts0, n_place

        def use_counts(k: Optional[int], tg_scope: bool):
            existing: Dict[int, float] = {}
            proposed: Dict[int, float] = {}
            cleared: Dict[int, float] = {}

            def tok_of(row: Optional[int]):
                if k is None:   # constant property: one shared value
                    return 0
                if row is None:
                    return None
                t = int(cl.attrs[row, k])
                return None if t == MISSING else t

            for row, tgname in cl.job_allocs.get(job.id, {}).values():
                if tg_scope and tgname != tg.name:
                    continue
                t = tok_of(row)
                if t is not None:
                    existing[t] = existing.get(t, 0) + 1
            for node_id, tgname, _u in plan.placed:
                if tg_scope and tgname != tg.name:
                    continue
                t = tok_of(cl.row_of.get(node_id))
                if t is not None:
                    proposed[t] = proposed.get(t, 0) + 1
            # NB: stops only, NOT preemptions — the reference's propertyset
            # gathers cleared values from Plan().NodeUpdate alone
            # (propertyset.go:166-171), unlike ProposedAllocs/distinct_hosts
            # which also removes NodePreemptions (context.go:134-138)
            for a in plan.stopped_allocs:
                if a.job_id != job.id or (tg_scope
                                          and a.task_group != tg.name):
                    continue
                t = tok_of(cl.row_of.get(a.node_id))
                if t is not None:
                    cleared[t] = cleared.get(t, 0) + 1
            # proposed re-use discounts cleared (propertyset.go:196-207)
            for t in proposed:
                cur = cleared.get(t)
                if cur is None:
                    continue
                if cur == 0:
                    del cleared[t]
                elif cur > 1:
                    cleared[t] = cur - 1
            out: Dict[int, float] = {}
            for t in set(existing) | set(proposed):
                out[t] = max(existing.get(t, 0) + proposed.get(t, 0)
                             - cleared.get(t, 0), 0)
            return out

        i = 0
        for k, allow, tg_scope in specs:
            use = use_counts(k, tg_scope)
            if k is None:
                # constant value: cap total placements at allowed − used
                remaining = int(max(allow - use.get(0, 0), 0))
                n_place = min(n_place, remaining)
                continue
            key_idx[i] = k
            allowed[i] = allow
            active[i] = True
            for t, cnt in use.items():
                if t < v:
                    counts0[i, t] = cnt
            i += 1
        return key_idx, allowed, active, counts0, n_place

    def _compile_spreads_static(self, tg, spreads, spread_keys, v: int):
        """Plan-independent spread tables: key indices, normalized weights,
        per-token desired counts (spread.go target mode)."""
        cl = self.cluster
        s_n = _bucket(max(len(spreads), 1))
        key_idx = np.zeros(s_n, dtype=np.int32)
        weight = np.zeros(s_n, dtype=np.float32)
        has_targets = np.zeros(s_n, dtype=bool)
        desired = np.full((s_n, v), -1.0, dtype=np.float32)
        active = np.zeros(s_n, dtype=bool)
        if not spreads:
            return key_idx, weight, has_targets, desired, active
        sum_w = sum(s.weight for s in spreads) or 1
        for i, spread in enumerate(spreads):
            k = spread_keys[i]
            kv = cl.vocab.key_vocabs[k]
            key_idx[i] = k
            weight[i] = spread.weight / sum_w
            active[i] = True
            if spread.spread_target:
                has_targets[i] = True
                dc = {
                    st.value: (st.percent / 100.0) * tg.count
                    for st in spread.spread_target
                }
                total = sum(dc.values())
                implicit = None
                if 0 < total < tg.count:
                    implicit = float(tg.count) - total
                for tok, value in enumerate(kv.values):
                    dv = dc.get(value, implicit)
                    desired[i, tok] = dv if dv is not None else -1.0
                # missing slot stays −1 (⇒ −1 penalty)
        return key_idx, weight, has_targets, desired, active

    def _spread_counts(self, job, tg, prog: dict, plan: PlanContext):
        """Per-eval spread counts: allocs of (job, tg) per value token,
        adjusted by in-plan stops/preemptions/placements."""
        cl = self.cluster
        spreads = prog["spreads"]
        spread_keys = prog["spread_keys"]
        v = prog["v"]
        s_n = _bucket(max(len(spreads), 1))
        counts0 = np.zeros((s_n, v), dtype=np.float32)
        if not spreads:
            return counts0
        for i, _spread in enumerate(spreads):
            k = spread_keys[i]
            for _aid, (row, tgname) in cl.job_allocs.get(job.id, {}).items():
                if tgname != tg.name:
                    continue
                tok = cl.attrs[row, k]
                if tok != MISSING:
                    counts0[i, tok] += 1
            for a in plan.stopped_allocs + plan.preempted_allocs:
                if a.job_id == job.id and a.task_group == tg.name:
                    row = cl.row_of.get(a.node_id)
                    if row is not None:
                        tok = cl.attrs[row, k]
                        if tok != MISSING and counts0[i, tok] > 0:
                            counts0[i, tok] -= 1
            for node_id, tgname, _u in plan.placed:
                if tgname == tg.name:
                    row = cl.row_of.get(node_id)
                    if row is not None:
                        tok = cl.attrs[row, k]
                        if tok != MISSING:
                            counts0[i, tok] += 1
        return counts0


    # ---- selection ----

    def select(
        self,
        job: Job,
        tg: TaskGroup,
        n_place: int,
        plan: Optional[PlanContext] = None,
        volumes: Optional[list] = None,
        sampled_rows: Optional[Sequence[int]] = None,
        explain: Optional[bool] = None,
    ) -> SelectResult:
        """Place `n_place` allocs of one task group: one kernel run.

        `explain` (default: the stack's flag) makes the same run emit
        reduced attribution outputs; SelectResult.explain carries the
        host-shaped mapping (constraint labels, dimension names, top-K
        node ids) that AllocMetric population consumes."""
        want_ex = self.explain if explain is None else explain
        params, m = self.compile_tg(job, tg, n_place, plan, volumes=volumes,
                                    sampled_rows=sampled_rows)
        ex_np = None
        if self.coordinator is not None:
            # batched path: park the raw program; the coordinator pads,
            # stacks and runs one chain (or wave) for the whole eval
            # batch, in broker-drain order. The device view is resolved
            # by the coordinator at dispatch time, not here: the previous
            # batch's plans commit between this park and the dispatch.
            (sel, scores, n_feas, n_fit, ex_np,
             carry_token) = self.coordinator.select(
                self.device_arrays, params, n_place,
                order=self.coordinator_order, explain=want_ex)
            result = None
        else:
            carry_token = None
            # the solo run leases the view it launches against until its
            # outputs are on the host, like every dispatch: a refresh in
            # between writes copies, never these tensors
            token = next(_DISPATCH_TOKENS)
            try:
                arrays = self.device_arrays(lease_token=token)
                # bucket-pad the program (parallel/pad.py, the same inert
                # padding the batched transports use) so its shapes
                # repeat across jobs
                (params,), _ = pad_params([params])
                result = place_task_group(arrays,
                                          _to_device(params, self.device),
                                          m, explain=want_ex)
                # the solo fetch below is deliberately unledgered, like
                # the upload side (_to_device): the batched coordinator
                # path is the accounted one; this fallback serves
                # coordinator-less callers (oracle parity, unit tests)
                sel = result.sel_idx.cpu().numpy()  # nomadlint: ok NLD01 solo fallback, outside ledger/guard by design (_to_device)
                scores = result.sel_score.cpu().numpy()  # nomadlint: ok NLD01 solo fallback, outside ledger/guard by design (_to_device)
                n_feas = int(result.nodes_feasible)
                n_fit = result.nodes_fit.cpu().numpy()  # nomadlint: ok NLD01 solo fallback, outside ledger/guard by design (_to_device)
                if result.explain is not None:
                    ex_np = PlacementExplain(
                        *(x.cpu().numpy() for x in result.explain))  # nomadlint: ok NLD01 solo fallback, outside ledger/guard by design (_to_device)
            finally:
                release_view(self.cluster, token)
        snap_rows = self.cluster.node_of_row
        node_ids: List[Optional[str]] = []
        out_scores: List[float] = []
        for i in range(n_place):
            row = int(sel[i])
            node_ids.append(snap_rows[row] if row >= 0 else None)
            out_scores.append(float(scores[i]))
        explain_host = None
        if ex_np is not None:
            prog = self._static_program(job, tg, volumes)
            explain_host = self._explain_host(ex_np, prog["cc"].labels,
                                              n_place)
        return SelectResult(
            node_ids=node_ids,
            scores=out_scores,
            nodes_feasible=n_feas,
            nodes_fit=[int(x) for x in n_fit[:n_place]],
            raw=result,
            explain=explain_host,
            ask=np.asarray(params.ask, dtype=np.float32),
            carry_token=carry_token,
        )

    def _dimension_names(self) -> List[str]:
        """Resource-column display names (AllocMetric.dimension_exhausted
        keys): the base columns, then registered device pools by name."""
        names = list(DIMENSION_NAMES) + [
            f"resource[{i}]" for i in range(len(DIMENSION_NAMES), R_TOTAL)]
        for pool, col in self.cluster.device_cols.items():
            names[col] = f"devices: {pool}"
        return names

    def _explain_host(self, ex: PlacementExplain, labels: Sequence[str],
                      n_place: int) -> dict:
        """Numpy PlacementExplain → the host-shaped attribution dict.

        All counts become plain Python ints (the wire codec rejects
        numpy scalars). Constraint columns beyond `labels` are padding
        (all-true rows) and always count 0; top-K rows with scores at
        the mask floor are infeasible tail entries and are dropped."""
        dim_names = self._dimension_names()
        rows = self.cluster.node_of_row
        cfilt = {}
        for c, label in enumerate(labels):
            v = int(ex.filt_constraint[c])
            if v:
                cfilt[label] = cfilt.get(label, 0) + v
        steps = []
        for i in range(min(n_place, int(ex.filt_distinct.shape[0]))):
            dims = {}
            for r, name in enumerate(dim_names):
                v = int(ex.exh_dim[i, r])
                if v:
                    dims[name] = v
            if int(ex.exh_dyn_ports[i]):
                dims["dynamic-ports"] = int(ex.exh_dyn_ports[i])
            if int(ex.exh_res_ports[i]):
                dims["reserved-ports"] = int(ex.exh_res_ports[i])
            top = []
            for k in range(ex.topk_idx.shape[1]):
                score = float(ex.topk_score[i, k])
                row = int(ex.topk_idx[i, k])
                if score <= -1e29 or row < 0 or row >= len(rows):
                    continue  # infeasible tail of the top-K
                nid = rows[row]
                if nid is None:
                    continue
                top.append({
                    "node_id": nid,
                    "norm_score": score,
                    "scores": {name: float(ex.topk_parts[i, k, j])
                               for j, name in
                               enumerate(EXPLAIN_SCORE_NAMES)},
                })
            steps.append({
                "filtered_distinct_hosts": int(ex.filt_distinct[i]),
                "filtered_distinct_property": int(ex.filt_dp[i]),
                "nodes_exhausted": sum(dims.values()),
                "dimension_exhausted": dims,
                "top_nodes": top,
            })
        return {
            "nodes_evaluated": int(ex.nodes_evaluated),
            "filtered_constraint": int(ex.filt_lut),
            "filtered_device_plugin": int(ex.filt_extra),
            "nodes_filtered": int(ex.filt_lut) + int(ex.filt_extra),
            "constraint_filtered": cfilt,
            "steps": steps,
        }


def _sparse_counts(counts: Dict[int, float]) -> Tuple[np.ndarray, np.ndarray]:
    """(row → count) map → bucketed (idx, val) arrays, −1-padded."""
    b = _bucket(max(len(counts), 1))
    idx = np.full(b, -1, dtype=np.int32)
    val = np.zeros(b, dtype=np.float32)
    for i, (row, cnt) in enumerate(counts.items()):
        idx[i] = row
        val[i] = cnt
    return idx, val


def _pad_lut(lut: np.ndarray, v: int, fill, dtype) -> np.ndarray:
    """Widen LUT rows to v columns, keeping the missing slot in the LAST
    column (the kernel maps token −1 → V−1)."""
    if lut.size == 0:
        return np.zeros((lut.shape[0] if lut.ndim == 2 else 0, v), dtype=dtype)
    c, old_v = lut.shape
    if old_v == v:
        return lut.astype(dtype)
    out = np.full((c, v), fill, dtype=dtype)
    out[:, : old_v - 1] = lut[:, : old_v - 1]
    out[:, -1] = lut[:, -1]
    return out


def _to_device(params: TGParams, device: torch.device) -> TGParams:
    """numpy program → tensors on `device` (one copy per field)."""
    return params_from_numpy(params, device)
