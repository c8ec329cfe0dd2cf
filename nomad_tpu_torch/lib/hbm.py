"""HBM residency ledger — device-buffer lifetime accounting.

The transfer ledger (lib/transfer.py) accounts every byte that CROSSES
the host↔device link; this module accounts every byte that STAYS there.
The device-resident dispatch loop parked long-lived state in
HBM — content-addressed program-table rows under an LRU, double-buffered
view slots pinned by dispatch leases, D2D carry arrays alive until
adoption or reject — and none of that residency was observable: nothing
read the allocator's memory stats, a lease that never released would leak
silently, and the mesh scale-out question ("shard the [nodes] axis via
pjit when it exceeds one HBM", ROADMAP item 3 / SURVEY §7) had no
instrument to steer by.

Three pieces, the lib/transfer.py shape (site taxonomy + registry
mirror + labeled Prometheus exposition):

- `HbmLedger` — per-(site, shard) accounting of every long-lived device
  buffer. `track(site, arr)` books a buffer by object identity and
  registers a `weakref.finalize` that releases the booking when the
  array object dies — live-bytes is therefore "buffers still
  referenced", which is exactly when their HBM is still held. Re-siting
  is first-class: a dispatch carry adopted into the view moves its
  bytes from `select_batch.carry` to `stack.view_hot` instead of
  double-counting — and the certified chain HEAD carry
  follows the same discipline: the folded k-deep carry a clean certify
  publishes re-sites on adoption exactly like a single-dispatch carry,
  while a view rebuild retires the chain so the REPLACED generation's
  hot buffers (its `base_arrays`) actually die and release their
  booking instead of being pinned by a chain that can never certify
  again (the leak-gate round in tests/test_hbm.py pins both: adoption
  leaves per-site residency flat, retirement keeps exactly one
  generation live). Sites are dotted names (README's residency-site
  table); shards are device ids, split per-device for sharded arrays so
  mesh state reads per-chip.

- Lease lifetime tracking — `lease(token, site)` / `release_lease`
  mirror the view leases the coordinator takes per fused dispatch
  (scheduler/stack.py `device_arrays(lease_token=)` / `release_view`).
  Each lease records its coordinator token + monotonic age; a lease
  older than the age watermark (`NOMAD_TPU_HBM_LEASE_WATERMARK_S`)
  fires an `ErrorStreak`-style warning (first of a streak at WARNING,
  counter `hbm.stuck_leases`) — a wedged waiter that would pin a view
  slot forever leaves a visible trace instead of a silent leak.

- `plan_capacity` — the mesh capacity planner. Node-axis-shaped sites
  are tracked with their row count, so the ledger knows the MEASURED
  per-node-row cost of every view tensor class; projecting a target
  cluster is then per-row cost x the bucketed node capacity (the
  ClusterTensors doubling schedule) plus the fixed (program table) and
  transient-peak (in-flight dispatch) terms. The answer is the ROADMAP
  item-3 steering number: does 100k nodes fit one HBM, and if not, how
  many node-axis shards does it take.

Cross-check: `device_memory_stats()` reads `torch.cuda.memory_allocated`
and `torch.cuda.memory_stats` per card; on the CPU there are no device
numbers and only the ledger's own bookings count.
"""
from __future__ import annotations

import logging
import os
import threading
import time
import weakref
from typing import Dict, List, Optional, Tuple

from .metrics import MetricsRegistry, prometheus_line

#: age watermark (seconds) past which a still-outstanding view lease is
#: reported stuck; 0 disables the check
LEASE_WATERMARK_ENV = "NOMAD_TPU_HBM_LEASE_WATERMARK_S"

#: fallback device capacity for the planner when no card is visible (CPU
#: dev loops): NOMAD_TPU_HBM_GB gigabytes when set, else DEFAULT_HBM_BYTES
HBM_GB_ENV = "NOMAD_TPU_HBM_GB"
#: the card the port runs on: `torch.cuda.get_device_properties(0)
#: .total_memory` of an "NVIDIA H100 80GB HBM3, 700.00 W" (nvidia-smi's
#: name and power limit)
DEFAULT_HBM_BYTES = 85_017_493_504

#: transient sites: in-flight dispatch state (lazy outputs, held
#: carries) whose LIVE bytes oscillate around zero — the planner
#: projects their PEAK, everything else its live bytes
TRANSIENT_SITES_PREFIX = "select_batch."

#: widest node-axis split the planner will recommend (a generous pod
#: slice); needing more means replicated state dominates every shard —
#: an unactionable recommendation, reported as shards_needed=0 instead
_MAX_SANE_SHARDS = 1024


def lease_watermark_s() -> float:
    try:
        return float(os.environ.get(LEASE_WATERMARK_ENV, "120"))
    except ValueError:
        return 120.0


def _node_bucket(n: int) -> int:
    """ClusterTensors' OWN row-capacity schedule (tensor/cluster.py
    `_bucket`, powers of two from 64) — imported, not re-implemented,
    so a schedule change there can never silently misprice the
    projection here. Deferred import: tensor.cluster is jax-free but
    numpy-heavy, and this module must stay cheap to import."""
    from ..tensor.cluster import _bucket

    return _bucket(n)


class _SiteRow:
    __slots__ = ("live_bytes", "buffers", "peak_bytes", "allocs",
                 "releases", "rows")

    def __init__(self) -> None:
        self.live_bytes = 0
        self.buffers = 0
        self.peak_bytes = 0
        self.allocs = 0
        self.releases = 0
        #: node-axis length of the buffers booked here (0 = not
        #: node-proportional); the planner's per-row denominator
        self.rows = 0


class _Lease:
    __slots__ = ("token", "site", "t0", "stuck")

    def __init__(self, token, site: str, t0: float) -> None:
        self.token = token
        self.site = site
        self.t0 = t0
        self.stuck = False


class HbmLedger:
    """Thread-safe device-buffer residency accounting.

    Bookings are keyed by object identity: `track` registers a
    finalizer so a buffer's bytes leave the ledger exactly when the
    tensor object is garbage-collected (which is when its storage goes
    back to the caching allocator, unless a view still holds it). The
    ledger holds NO strong references — tracking a buffer never extends
    its life.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None) -> None:
        # RLock: a finalizer can fire on the thread currently inside a
        # ledger method if caller code interleaves a decref; reentrancy
        # is cheaper than auditing every GC edge
        self._lock = threading.RLock()
        #: (site, shard) → row
        self._sites: Dict[Tuple[str, str], _SiteRow] = {}
        #: id(arr) → [(site, shard, nbytes), ...] (sharded arrays book
        #: one entry per device)
        self._bookings: Dict[int, List[Tuple[str, str, int]]] = {}
        self._leases: Dict[object, _Lease] = {}
        self.lease_high_water = 0
        self.lease_age_high_water_s = 0.0
        self._stuck_streak = 0
        self._log = logging.getLogger("nomad_tpu_torch.hbm")
        self.registry = registry

    # -- internals --

    def _row(self, site: str, shard: str) -> _SiteRow:
        row = self._sites.get((site, shard))
        if row is None:
            row = self._sites[(site, shard)] = _SiteRow()
        return row

    def _mirror_locked(self) -> None:
        reg = self.registry
        if reg is None:
            return
        live = sum(r.live_bytes for r in self._sites.values())
        bufs = sum(r.buffers for r in self._sites.values())
        peak = sum(r.peak_bytes for r in self._sites.values())
        reg.set_gauge("hbm.live_bytes_total", live)
        reg.set_gauge("hbm.buffers_total", bufs)
        reg.set_gauge("hbm.peak_bytes_total", peak)
        reg.set_gauge("hbm.leases", len(self._leases))

    @staticmethod
    def _shard_bookings(arr) -> List[Tuple[str, int]]:
        """[(shard_label, nbytes)] for one tensor: its card's index, else
        "0", the reference's label for an array it cannot place (the port
        places no tensor on several cards yet)."""
        index = getattr(getattr(arr, "device", None), "index", None)
        return [(str(index if isinstance(index, int) else 0),
                 int(arr.nbytes))]

    # -- booking --

    def track(self, site: str, arr, rows: int = 0):
        """Book `arr`'s device bytes under `site` (per shard); returns
        `arr`. Idempotent for an object already booked at this site;
        RE-SITES an object booked elsewhere (ownership moved — e.g. a
        dispatch carry adopted as the view's hot buffer). `rows`
        declares the buffer's node-axis length for per-row capacity
        math (0 = not node-proportional). Objects without `nbytes` or
        weakref support are ignored — telemetry must never brick the
        dispatch path."""
        if arr is None or not hasattr(arr, "nbytes"):
            return arr
        key = id(arr)
        with self._lock:
            prev = self._bookings.get(key)
            if prev is not None:
                if prev and prev[0][0] == site:
                    return arr  # already booked here
                self._drop_locked(key)  # re-site: move the bytes
                fresh = False
            else:
                fresh = True
            booked: List[Tuple[str, str, int]] = []
            for shard, nb in self._shard_bookings(arr):
                row = self._row(site, shard)
                row.live_bytes += nb
                row.buffers += 1
                row.allocs += 1
                if row.live_bytes > row.peak_bytes:
                    row.peak_bytes = row.live_bytes
                if rows:
                    row.rows = int(rows)
                booked.append((site, shard, nb))
            self._bookings[key] = booked
            if fresh:
                try:
                    weakref.finalize(arr, self._on_dead, key)
                except TypeError:
                    # not weakref-able (plain scalars): a booking whose
                    # death we can never observe would read as a
                    # permanent leak — drop it instead
                    self._drop_locked(key)
                    self._mirror_locked()
                    return arr
            if self.registry is not None:
                self.registry.inc("hbm.allocs")
            self._mirror_locked()
        return arr

    def track_cluster(self, site_prefix: str, arrays, n_rows: int) -> None:
        """Book a ClusterArrays-shaped view under three site classes:
        `<prefix>_static` (capacity/attrs), `<prefix>_hot`
        (used/node_ok/dyn_free), `<prefix>_ports` (the port bitmap)."""
        self.track(f"{site_prefix}_static", arrays.capacity, rows=n_rows)
        self.track(f"{site_prefix}_static", arrays.attrs, rows=n_rows)
        self.track(f"{site_prefix}_hot", arrays.used, rows=n_rows)
        self.track(f"{site_prefix}_hot", arrays.node_ok, rows=n_rows)
        self.track(f"{site_prefix}_hot", arrays.dyn_free, rows=n_rows)
        self.track(f"{site_prefix}_ports", arrays.ports_used, rows=n_rows)

    def untrack(self, arr) -> None:
        """Explicit early release (the finalizer then no-ops)."""
        if arr is None:
            return
        with self._lock:
            self._drop_locked(id(arr))
            self._mirror_locked()

    def _on_dead(self, key: int) -> None:
        with self._lock:
            self._drop_locked(key)
            self._mirror_locked()

    def _drop_locked(self, key: int) -> None:
        booked = self._bookings.pop(key, None)
        if booked is None:
            return
        for site, shard, nb in booked:
            row = self._sites.get((site, shard))
            if row is None:
                continue
            row.live_bytes = max(row.live_bytes - nb, 0)
            row.buffers = max(row.buffers - 1, 0)
            row.releases += 1
        if self.registry is not None:
            self.registry.inc("hbm.releases")

    # -- lease lifetime tracking --

    def lease(self, token, site: str = "stack.view") -> None:
        """Record an owner token taking a view lease (a fused dispatch
        pinning the buffers it launched against)."""
        with self._lock:
            self._leases[token] = _Lease(token, site, time.monotonic())
            if len(self._leases) > self.lease_high_water:
                self.lease_high_water = len(self._leases)
            if self.registry is not None:
                self.registry.set_gauge("hbm.leases", len(self._leases))

    def release_lease(self, token) -> Optional[float]:
        """Release a lease; returns its age in seconds (None when the
        token was unknown — release is idempotent by design, the stack
        releases defensively on failed launches)."""
        with self._lock:
            lease = self._leases.pop(token, None)
            if lease is None:
                return None
            age = time.monotonic() - lease.t0
            if age > self.lease_age_high_water_s:
                self.lease_age_high_water_s = age
            if self.registry is not None:
                self.registry.set_gauge("hbm.leases", len(self._leases))
            return age

    def leases(self) -> List[Dict[str, object]]:
        self._check_watermark()
        now = time.monotonic()
        with self._lock:
            return [{"token": str(lease.token), "site": lease.site,
                     "age_s": round(now - lease.t0, 3),
                     "stuck": lease.stuck}
                    for lease in self._leases.values()]

    def outstanding_leases(self) -> int:
        with self._lock:
            return len(self._leases)

    def _check_watermark(self) -> None:
        """Flag leases older than the watermark, ErrorStreak-style: the
        FIRST stuck lease of a streak logs at WARNING (the rest at
        DEBUG) and each increments `hbm.stuck_leases`; the streak
        re-arms once no stuck lease remains."""
        wm = lease_watermark_s()
        if wm <= 0:
            return
        now = time.monotonic()
        newly_stuck: List[_Lease] = []
        with self._lock:
            for lease in self._leases.values():
                if lease.stuck or now - lease.t0 <= wm:
                    continue
                lease.stuck = True
                newly_stuck.append(lease)
            any_stuck = any(lease.stuck for lease in self._leases.values())
            for lease in newly_stuck:
                self._stuck_streak += 1
                first = self._stuck_streak == 1
                if self.registry is not None:
                    self.registry.inc("hbm.stuck_leases")
                (self._log.warning if first else self._log.debug)(
                    "hbm: view lease %s (%s) outstanding for %.1fs "
                    "(watermark %.1fs) — a wedged waiter is pinning a "
                    "view slot", lease.token, lease.site,
                    now - lease.t0, wm)
            if not any_stuck:
                self._stuck_streak = 0
        if newly_stuck:
            # flight events OUTSIDE the ledger lock (the recorder takes
            # its own condition; no reason to nest them)
            from .flight import default_flight

            for lease in newly_stuck:
                try:
                    default_flight().record(
                        "hbm.stuck_lease", key=str(lease.token),
                        source=lease.site, severity="warn",
                        detail={"age_s": round(now - lease.t0, 1),
                                "watermark_s": wm})
                except Exception:  # noqa: BLE001 — telemetry only
                    pass

    # -- export --

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """Per-site rollup (shards aggregated; per-shard detail in
        `shards()`)."""
        self._check_watermark()
        with self._lock:
            out: Dict[str, Dict[str, object]] = {}
            for (site, _shard), row in self._sites.items():
                agg = out.setdefault(site, {
                    "live_bytes": 0, "buffers": 0, "peak_bytes": 0,
                    "allocs": 0, "releases": 0, "rows": 0})
                agg["live_bytes"] += row.live_bytes
                agg["buffers"] += row.buffers
                agg["peak_bytes"] += row.peak_bytes
                agg["allocs"] += row.allocs
                agg["releases"] += row.releases
                agg["rows"] = max(agg["rows"], row.rows)
            return out

    def shards(self) -> Dict[str, Dict[str, Dict[str, int]]]:
        """shard → site → {live_bytes, buffers, peak_bytes}."""
        with self._lock:
            out: Dict[str, Dict[str, Dict[str, int]]] = {}
            for (site, shard), row in self._sites.items():
                out.setdefault(shard, {})[site] = {
                    "live_bytes": row.live_bytes,
                    "buffers": row.buffers,
                    "peak_bytes": row.peak_bytes,
                }
            return out

    def totals(self) -> Tuple[int, int, int]:
        """(live_bytes, buffers, peak_bytes) across every site."""
        with self._lock:
            return (sum(r.live_bytes for r in self._sites.values()),
                    sum(r.buffers for r in self._sites.values()),
                    sum(r.peak_bytes for r in self._sites.values()))

    def summary(self) -> Dict[str, object]:
        live, bufs, peak = self.totals()
        with self._lock:
            n_leases = len(self._leases)
        return {
            "live_bytes": live,
            "buffers": bufs,
            "peak_bytes": peak,
            "outstanding_leases": n_leases,
            "lease_high_water": self.lease_high_water,
            "lease_age_high_water_s": round(
                self.lease_age_high_water_s, 3),
            "lease_watermark_s": lease_watermark_s(),
        }

    def prometheus(self, prefix: str = "nomad") -> str:
        """Labeled text exposition, one series per (site, shard) per
        instrument (`nomad_hbm_live_bytes{shard="0",
        site="stack.view_hot"} 123`) — site/shard ride labels so
        dashboards aggregate with sum by(), the transfer-ledger
        precedent. Runs the stuck-lease watermark check first: a
        metrics-only deployment (Prometheus scrape, no /v1/operator/hbm
        reads) must still surface a wedged lease."""
        self._check_watermark()
        with self._lock:
            rows = {k: (r.live_bytes, r.buffers, r.peak_bytes)
                    for k, r in self._sites.items()}
        if not rows:
            return ""
        lines: List[str] = []
        for metric, idx in (("hbm_live_bytes", 0), ("hbm_buffers", 1),
                            ("hbm_peak_bytes", 2)):
            name = f"{prefix}_{metric}" if prefix else metric
            lines.append(f"# TYPE {name} gauge")
            for site, shard in sorted(rows):
                lines.append(prometheus_line(
                    name, {"site": site, "shard": shard},
                    float(rows[(site, shard)][idx])))
        return "\n".join(lines) + "\n"


_default_hbm = HbmLedger()


def default_hbm() -> HbmLedger:
    """Process-global ledger (the transfer-ledger precedent): residency
    sites live in per-eval stacks and module-level caches that carry no
    server reference. Registry mirroring attaches lazily so importing
    this module stays jax-free and cheap."""
    if _default_hbm.registry is None:
        from .metrics import default_registry

        _default_hbm.registry = default_registry()
    return _default_hbm


# ---- device cross-check -----------------------------------------------------


def device_memory_stats() -> List[Dict[str, object]]:
    """Per-card allocator numbers from `torch.cuda.memory_allocated` /
    `memory_stats`; empty without a card (the CPU has no device numbers).
    Exception-safe — an agent endpoint must answer even when the runtime
    is wedged."""
    out: List[Dict[str, object]] = []
    try:
        import torch

        if not torch.cuda.is_available():
            return out
        for i in range(torch.cuda.device_count()):
            ms = torch.cuda.memory_stats(i)
            out.append({
                "device": str(i),
                "platform": "gpu",
                "bytes_in_use": int(torch.cuda.memory_allocated(i)),
                "peak_bytes_in_use": int(
                    ms.get("allocated_bytes.all.peak", 0)),
                "bytes_limit": int(
                    torch.cuda.get_device_properties(i).total_memory),
            })
    except Exception:  # noqa: BLE001
        return []
    return out


def reconcile(ledger: Optional[HbmLedger] = None) -> Dict[str, object]:
    """Ledger live-bytes vs the allocator's bytes_in_use: the coverage
    number the acceptance gate reads (ledger accounts >= 90% of real
    growth on the steady-state fused path). `coverage_pct` is None when
    the backend exposes no stats (CPU)."""
    ledger = ledger or default_hbm()
    live, _bufs, _peak = ledger.totals()
    devs = device_memory_stats()
    in_use = sum(d["bytes_in_use"] for d in devs) if devs else None
    return {
        "ledger_live_bytes": live,
        "device_bytes_in_use": in_use,
        "coverage_pct": (round(100.0 * live / in_use, 2)
                         if in_use else None),
        "devices": devs,
    }


# ---- capacity planner -------------------------------------------------------


def device_limit_bytes() -> Tuple[int, str]:
    """(per-device HBM capacity, source): the card's total memory when
    one is visible, else NOMAD_TPU_HBM_GB, else an H100 80GB HBM3's
    (DEFAULT_HBM_BYTES)."""
    for d in device_memory_stats():
        if d["bytes_limit"]:
            return int(d["bytes_limit"]), "memory_stats"
    try:
        gb = float(os.environ.get(HBM_GB_ENV, ""))
        if gb > 0:
            return int(gb * (1 << 30)), "env"
    except ValueError:
        pass
    return DEFAULT_HBM_BYTES, "default"


def plan_capacity(nodes: int, allocs: int,
                  ledger: Optional[HbmLedger] = None) -> Dict[str, object]:
    """Project the device footprint of a `nodes`-node / `allocs`-alloc
    cluster from MEASURED per-row costs (ROADMAP item 3's instrument).

    Model: every node-axis-shaped site (tracked with `rows`) costs
    `live_bytes / rows` per node row and scales with the bucketed node
    capacity (ClusterTensors doubles from 64); non-node sites split into
    fixed residency (program table — projected at live bytes) and
    transient dispatch state (`select_batch.*` — projected at measured
    PEAK, since live oscillates around zero between dispatches). Alloc
    count is a values question, not a bytes one — allocations mutate the
    dense [n_cap, R] usage tensor in place, so per-alloc device
    residency is zero and `allocs` only contextualizes the transient
    term (in-flight dispatch width tracks eval churn, which tracks the
    alloc base). `shards_needed` is the smallest power-of-two node-axis
    split (parallel/mesh.py cluster_sharding) whose per-shard footprint
    fits one device — or 0 when sharding is not an actionable answer:
    the replicated fixed + transient state exhausts (or nearly
    exhausts — beyond any sane mesh width) every shard by itself."""
    if nodes <= 0 or allocs < 0:
        raise ValueError(
            f"plan needs nodes > 0 and allocs >= 0 (got nodes={nodes}, "
            f"allocs={allocs})")
    ledger = ledger or default_hbm()
    snap = ledger.snapshot()
    per_node = 0.0
    fixed = 0
    transient_peak = 0
    measured_sites = 0
    for site, row in snap.items():
        if row["rows"]:
            per_node += row["live_bytes"] / row["rows"]
            measured_sites += 1
        elif site.startswith(TRANSIENT_SITES_PREFIX):
            transient_peak += row["peak_bytes"]
        else:
            fixed += row["live_bytes"]
    n_cap = _node_bucket(nodes)
    node_bytes = int(per_node * n_cap)
    projected = node_bytes + fixed + transient_peak
    limit, limit_src = device_limit_bytes()
    # fixed + transient replicate per shard; only the node axis splits.
    # The per-shard budget for node rows is therefore limit − replicated
    # state: a non-positive budget means NO node-axis split can help,
    # and a split wider than any sane mesh (the replicated state eating
    # ~all of every shard) is equally unactionable — both report
    # shards_needed=0 and the CLI words it honestly.
    shards = 1
    budget = limit - fixed - transient_peak
    if projected > limit:
        if budget <= 0:
            shards = 0
        else:
            shards = 1
            while shards * budget < node_bytes:
                shards *= 2
            if shards > _MAX_SANE_SHARDS:
                shards = 0
    return {
        "nodes": int(nodes),
        "allocs": int(allocs),
        "projected_n_cap": n_cap,
        "measured": measured_sites > 0,
        "per_node_bytes": round(per_node, 1),
        "per_alloc_bytes": 0.0,
        "node_bytes": node_bytes,
        "fixed_bytes": fixed,
        "transient_peak_bytes": transient_peak,
        "projected_bytes": projected,
        "device_limit_bytes": limit,
        "limit_source": limit_src,
        "headroom_bytes": limit - projected,
        "fits": projected <= limit,
        "shards_needed": shards,
    }
