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
dispatches. The device view re-uploads a whole tensor group when its key
changes, so a view a dispatch read is never written afterwards; view
leases are bookkeeping only (the row-delta refresh, carry adoption and
speculation are later work; the delta path only saves bytes, so
placements are identical).
"""
from __future__ import annotations

import threading
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
from ..lib.metrics import default_registry
from ..parallel.pad import pad_params
from ..structs import Allocation, Job, TaskGroup
from ..structs.job import (CONSTRAINT_DISTINCT_HOSTS,
                           CONSTRAINT_DISTINCT_PROPERTY)
from ..tensor.cluster import R_TOTAL, ClusterTensors
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
    #: the compiled ask vector (f32[R]) this selection placed against
    ask: Optional[np.ndarray] = None


#: base resource-dimension display names, column order of the cluster
#: tensors (tensor/cluster.py R_CPU..R_BW); device columns resolve by
#: pool name. The strings are AllocMetric.dimension_exhausted keys and
#: must stay stable — the bench attribution section and the blocked-eval
#: diagnostics aggregate on them.
DIMENSION_NAMES = ("cpu", "memory", "disk", "network")

#: cluster object → {device: last upload}, each tensor group keyed by its
#: sub-version (see TorchStack.device_arrays); weak so dead clusters free
#: their device memory
_DEV_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_DEV_CACHE_LOCK = threading.Lock()


def _leased(ent: dict, token) -> ClusterArrays:
    """The entry's view, leased to `token` (if any); call under
    _DEV_CACHE_LOCK."""
    if token is not None:
        from ..lib.hbm import default_hbm

        ent.setdefault("leases", set()).add(token)
        default_hbm().lease(token)
    return ent["arrays"]


def release_view(cluster, token) -> None:
    """End the view lease a dispatch took with
    `device_arrays(lease_token=token)` (idempotent: a failed launch
    releases defensively)."""
    from ..lib.hbm import default_hbm

    with _DEV_CACHE_LOCK:
        for ent in _DEV_CACHE.get(cluster, {}).values():
            ent.setdefault("leases", set()).discard(token)
    default_hbm().release_lease(token)


class TorchStack:
    """Compiles placement programs and drives the placement kernel."""

    def __init__(self, cluster: ClusterTensors, algorithm: str = "binpack",
                 explain: bool = True, device: DeviceLike = None) -> None:
        self.cluster = cluster
        self.algorithm = algorithm
        #: emit kernel-native attribution with every run (the AllocMetric
        #: feed)
        self.explain = explain
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
        #: the dispatch token of the last coordinated select (the carry
        #: binding the reference stamps on its plan)
        self.carry_token = None

    # ---- device snapshot management ----

    def device_arrays(self, lease_token=None) -> ClusterArrays:
        """Device copy of the cluster tensors, cached per cluster object
        and device. Three groups, each re-uploaded whole when its key
        changes: the static tensors (capacity, attrs) on `node_version`,
        the row caps and the attrs dtype; the port bitmap on
        `ports_version`; the hot tensors (used, node_ok, dyn_free) on the
        cluster `version`. Keys are captured before anything is read, so
        a mutation racing the refresh leaves the entry stale, never
        current with old data. A refresh allocates new tensors and never
        writes the ones it replaces.

        `lease_token` registers a view lease atomically with the resolve
        (released by `release_view`); with whole-group re-uploads a lease
        is bookkeeping only."""
        reg = default_registry()
        cl = self.cluster
        dev = self.device
        with _DEV_CACHE_LOCK:
            version = cl.version
            # vocab tokens are small ints: int16 halves the attrs tensor
            # (int32 once any key's vocabulary approaches the i16 range)
            attr_dt = np.int16 if cl.vocab.max_vocab < 32000 else np.int32
            static_key = (cl.node_version, cl.n_cap, cl.k_cap, attr_dt)
            ports_key = (cl.ports_version, cl.n_cap)
            per_dev = _DEV_CACHE.setdefault(cl, {})
            ent = per_dev.get(dev)
            if ent is not None and ent["version"] == version \
                    and ent["static_key"] == static_key \
                    and ent["ports_key"] == ports_key:
                return _leased(ent, lease_token)
            if ent is not None and ent["static_key"] == static_key:
                capacity, attrs = ent["arrays"].capacity, ent["arrays"].attrs
            else:
                capacity = tensor_from_numpy(cl.capacity, dev, np.float32)
                attrs = tensor_from_numpy(cl.attrs, dev, attr_dt)
                reg.inc("view.upload_bytes",
                        cl.capacity.nbytes + cl.attrs.size
                        * np.dtype(attr_dt).itemsize)
            if (ent is not None and ent["version"] == version
                    and ent["arrays"].used.shape[0] == cl.n_cap):
                used, node_ok, dyn_free = (ent["arrays"].used,
                                           ent["arrays"].node_ok,
                                           ent["arrays"].dyn_free)
            else:
                used = tensor_from_numpy(cl.used, dev, np.float32)
                node_ok = tensor_from_numpy(cl.node_ok, dev, np.bool_)
                dyn_free = tensor_from_numpy(cl.dyn_free, dev, np.float32)
                reg.inc("view.full_uploads")
                reg.inc("view.upload_bytes", cl.used.size * 4
                        + cl.node_ok.nbytes + cl.dyn_free.nbytes)
            if ent is not None and ent["ports_key"] == ports_key:
                ports_used = ent["arrays"].ports_used
            else:
                ports_used = tensor_from_numpy(cl.ports_used, dev)
                reg.inc("view.ports_full_uploads")
                reg.inc("view.upload_bytes", cl.ports_used.nbytes)
            arrays = ClusterArrays(capacity=capacity, used=used,
                                   node_ok=node_ok, attrs=attrs,
                                   ports_used=ports_used, dyn_free=dyn_free)
            per_dev[dev] = {"version": version, "static_key": static_key,
                            "ports_key": ports_key, "arrays": arrays,
                            "leases": (ent or {}).get("leases", set())}
            return _leased(per_dev[dev], lease_token)

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
             self.carry_token) = self.coordinator.select(
                self.device_arrays, params, n_place,
                order=self.coordinator_order, explain=want_ex)
            result = None
        else:
            arrays = self.device_arrays()
            # bucket-pad the program (parallel/pad.py, the same inert
            # padding the batched transports use) so its shapes repeat
            # across jobs
            (params,), _ = pad_params([params])
            result = place_task_group(arrays,
                                      _to_device(params, self.device),
                                      m, explain=want_ex)
            sel = result.sel_idx.cpu().numpy()
            scores = result.sel_score.cpu().numpy()
            n_feas = int(result.nodes_feasible)
            n_fit = result.nodes_fit.cpu().numpy()
            if result.explain is not None:
                ex_np = PlacementExplain(
                    *(x.cpu().numpy() for x in result.explain))
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
