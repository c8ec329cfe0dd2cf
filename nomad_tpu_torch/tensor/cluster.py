"""Cluster state → dense tensors.

Encodes the scheduling-relevant view of the cluster (reference: what
`scheduler/stack.go` + `rank.go` read through the `State` snapshot) as arrays:

  capacity  f32[N, R]  node resources − reserved (cpu, memMB, diskMB, devices…)
  used      f32[N, R]  Σ non-terminal alloc utilization per node
  node_ok   bool[N]    ready() && real row
  attrs     i32[N, K]  value token per (node, interned key); −1 = missing

Rows are assigned per node and recycled; arrays grow by power-of-two buckets
so jitted kernel shapes stay stable. The `used` matrix is maintained
incrementally as allocations are upserted — the device never re-walks the
alloc table (the reference recomputes ProposedAllocs per node per eval,
`scheduler/context.go:120`; here plan-relative deltas are applied as sparse
scatters in the kernel instead).
"""
from __future__ import annotations

import os
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Set, Tuple

import numpy as np

from ..structs.alloc import Allocation
from ..structs.node import Node
from .vocab import MISSING, AttrVocab

R_CPU, R_MEM, R_DISK, R_BW = 0, 1, 2, 3
BASE_RESOURCES = 4
MAX_DEVICE_COLS = 4
R_TOTAL = BASE_RESOURCES + MAX_DEVICE_COLS

# Port-feasibility columns (reference structs.Bitmap over 65536 ports,
# nomad/structs/bitmap.go:6, indexed by NetworkIndex network.go:30):
# packed u32[N, 2048] used-port bitmap + free-dynamic-port count. The bitmap
# is the union across the node's IPs — slightly conservative vs the
# reference's per-IP maps; host-side assign_network stays the final
# authority at offer time.
PORT_WORDS = 2048                 # 65536 / 32
MIN_DYNAMIC_PORT = 20000          # reference network.go:12
MAX_DYNAMIC_PORT = 32000          # reference network.go:15
DYN_PORT_SPAN = MAX_DYNAMIC_PORT - MIN_DYNAMIC_PORT + 1

#: bounded length of the per-version delta logs (hot rows / port rows).
#: When a log wraps, caches older than the dropped entry fall back to a
#: full upload — the log is a window, not a journal.
DELTA_LOG_LEN = 1024


def _delta_log_len() -> int:
    """Per-cluster delta-log ring length: `NOMAD_TPU_DELTA_LOG`
    overrides DELTA_LOG_LEN (default 1024), read once at cluster
    construction. Size it above the mutation volume of one commit
    interval: a plain cache that lags past a wrap merely pays a full
    upload, but a wrap MID-SPECULATION-CHAIN destroys the certification
    evidence for the interval — every speculative result rolls back
    (`spec.chain_unprovable_wrap`, scheduler/stack.py)."""
    raw = os.environ.get("NOMAD_TPU_DELTA_LOG", "").strip()
    try:
        val = int(raw) if raw else DELTA_LOG_LEN
    except ValueError:
        return DELTA_LOG_LEN
    return max(8, val)


def _bucket(n: int, lo: int = 64) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


@dataclass
class ClusterSnapshot:
    """A consistent device-ready view (numpy; moved to device by the stack)."""

    capacity: np.ndarray   # f32[N, R]
    used: np.ndarray       # f32[N, R]
    node_ok: np.ndarray    # bool[N]
    attrs: np.ndarray      # i32[N, K]
    ports_used: np.ndarray  # u32[N, PORT_WORDS] packed used-port bitmap
    dyn_free: np.ndarray   # f32[N] free ports in the dynamic range
    n_rows: int            # live row count (≤ N)
    row_to_node_id: List[Optional[str]]


class ClusterTensors:
    """Incremental tensorization of nodes + allocations."""

    def __init__(self, n_cap: int = 64, k_cap: int = 64) -> None:
        self.vocab = AttrVocab()
        self.n_cap = n_cap
        self.k_cap = k_cap
        #: delta-log ring bound (NOMAD_TPU_DELTA_LOG, default
        #: DELTA_LOG_LEN) — pinned per instance so a mid-life env flip
        #: can't shrink a ring out from under its readers' floors
        self.delta_log_len = _delta_log_len()
        self.capacity = np.zeros((n_cap, R_TOTAL), dtype=np.float32)
        # float64: `used` is a long-lived INCREMENTAL accumulator (+=
        # on place, -= on release); float32 rounding residue from alloc
        # churn would random-walk past any fixed epsilon and poison the
        # plan applier's exact-boundary fit checks. The device copy
        # downcasts to f32 at upload — kernel behavior is unchanged.
        self.used = np.zeros((n_cap, R_TOTAL), dtype=np.float64)
        self.node_ok = np.zeros(n_cap, dtype=bool)
        self.attrs = np.full((n_cap, k_cap), MISSING, dtype=np.int32)
        self.ports_used = np.zeros((n_cap, PORT_WORDS), dtype=np.uint32)
        self.dyn_free = np.zeros(n_cap, dtype=np.float32)
        # per-row port refcounts from allocs + node-reserved base sets
        self.port_refs: List[Dict[int, int]] = [dict() for _ in range(n_cap)]
        self.base_ports: List[frozenset] = [frozenset()] * n_cap
        # alloc_id -> (row, port list) for release on update/removal
        self.alloc_ports: Dict[str, Tuple[int, List[int]]] = {}
        self.row_of: Dict[str, int] = {}
        self.node_of_row: List[Optional[str]] = [None] * n_cap
        self.nodes: Dict[str, Node] = {}
        # incremental ready-node counts per datacenter (readyNodesInDCs
        # fast path — a per-eval full node scan was ~15% of e2e time);
        # contributions tracked per node id so in-place object reuse by
        # in-proc callers can't corrupt the counters
        self.ready_by_dc: Dict[str, int] = {}
        self._ready_contrib: Dict[str, Tuple[str, bool]] = {}
        self.free_rows: List[int] = list(range(n_cap - 1, -1, -1))
        # device-type column registry: "vendor/type/name" -> column offset
        self.device_cols: Dict[str, int] = {}
        # alloc accounting: alloc_id -> (row, usage f32[R])
        self.alloc_usage: Dict[str, Tuple[int, np.ndarray]] = {}
        # job -> {alloc_id: (row, task_group)} for per-eval count vectors
        self.job_allocs: Dict[str, Dict[str, Tuple[int, str]]] = {}
        self.version = 0
        #: bumps ONLY on port-bitmap mutations — ports_used is by far
        #: the largest tensor (u32[N, 2048] ≈ 128 MB at 16K rows), so
        #: the device cache keys its upload separately (stack.py
        #: device_arrays)
        self.ports_version = 0
        # bumped only on node-set/attribute changes (not alloc churn) —
        # freshness oracle for cached host-evaluated constraint masks
        self.node_version = 0
        # ---- per-version delta logs (device-view incremental refresh) --
        # Each mutation that touches a hot tensor row (used/node_ok/
        # dyn_free) or a port-bitmap row appends (version-after-bump,
        # rows) BEFORE bumping the matching version counter — that
        # ordering lets a reader capture the version first and then read
        # a superset of the rows changed since its cached version (a
        # concurrent mutation is either fully visible or re-applied on
        # the next refresh; it can never be silently lost). Consumed by
        # TPUStack.device_arrays: instead of re-uploading whole tensors
        # per version bump, it ships only the touched rows.
        self._hot_log: Deque[Tuple[int, Tuple[int, ...]]] = deque()
        self._hot_floor = 0     # versions < floor are not reconstructible
        #: (ports_version-after-bump, row, word | None). `word` is the
        #: touched u32 word of the packed bitmap when the mutation was a
        #: single port flip — the device refresh then ships one word
        #: instead of the whole 8 KB row; None means the whole row
        #: changed (node upsert/remove rebuilds)
        self._ports_log: Deque[Tuple[int, int, Optional[int]]] = deque()
        self._ports_floor = 0
        # ---- plan-commit windows (device-view D2D plan deltas) --------
        # The plan applier marks each committed plan's (version-before,
        # version-after] range here (under the store's mutation lock, so
        # no foreign bump can land inside a window). The device-view
        # cache uses it to tell KERNEL-committed rows — already present
        # in the dispatch's device-resident carry — from every other
        # mutation, which must re-upload from host. `clean` = the plan
        # committed in full (no partial/rejections); `exact` = the
        # scheduler certified every placement's usage row equals the
        # kernel's ask vector bit-for-bit (structs.Plan.carry_exact);
        # `token` = the fused-dispatch token the plan's selection came
        # from (structs.Plan.carry_token) — a window only ever covers
        # the carry of the SAME dispatch, so a retry plan of an eval
        # whose earlier dispatch never committed can't whitewash that
        # dispatch's phantom placements into an adoption.
        self._plan_windows: Deque[Tuple[int, int, str, bool,
                                        Optional[int],
                                        Optional[frozenset]]] = deque()
        #: commit-window → certification callback (speculative
        #: dispatch): when set, every mark_plan_window call ALSO hands
        #: the full window record to this observer, synchronously and
        #: under the same commit lock. The speculative-dispatch chain
        #: (scheduler/stack.py spec_chain_*) installs it so commit
        #: verdicts reach certification even after the bounded ring
        #: wraps — the ring is a telemetry window, the observer is the
        #: certification feed. Must be cheap and non-blocking (it runs
        #: inside the store's mutation lock).
        self.plan_window_observer = None

    # ---- plan-commit windows ----

    PLAN_WINDOW_LEN = 256

    def mark_plan_window(self, eval_id: str, v_lo: int, v_hi: int,
                        clean: bool, exact: bool,
                        token: Optional[int] = None,
                        rejected_rows=None) -> None:
        """Record that versions (v_lo, v_hi] were one plan's commit.
        MUST be called under the same lock as the commit itself — a
        foreign mutation interleaving into the window would be
        mis-attributed as kernel-committed. `rejected_rows` names the
        node rows whose placements the optimistic verification dropped
        (partial commits): certification reports them in the rollback
        flight detail, so a speculation storm is attributable to the
        rows that caused it."""
        rej = (frozenset(rejected_rows) if rejected_rows else None)
        rec = (v_lo, v_hi, eval_id, bool(clean and exact), token, rej)
        log = self._plan_windows
        if len(log) >= self.PLAN_WINDOW_LEN:
            log.popleft()
        log.append(rec)
        obs = self.plan_window_observer
        if obs is not None:
            try:
                obs(rec)
            except Exception:  # noqa: BLE001 — certification bookkeeping
                pass           # must never fail a plan commit

    def plan_windows_since(self, v0: int):
        """[(v_lo, v_hi, eval_id, covered, token, rejected_rows)] for
        windows overlapping (v0, version]. `covered` folds clean+exact:
        True means every row change inside the window matches what the
        committing eval's kernel dispatch predicted; `token` names that
        dispatch."""
        return [w for w in list(self._plan_windows) if w[1] > v0]

    # ---- delta logs ----

    def _log_hot(self, *rows: int) -> None:
        """Record hot-tensor rows about to change at `version + 1`.
        MUST be called before the `self.version += 1` it describes.
        A bump that touches no hot rows needs no entry — readers union
        entries, so version gaps read as "nothing changed"."""
        if not rows:
            return
        log = self._hot_log
        if len(log) >= self.delta_log_len:
            # floor BEFORE pop: readers copy the log then check the
            # floor, so either they copied the doomed entry or they see
            # the raised floor — never an unflagged incomplete window
            self._hot_floor = log[0][0]
            log.popleft()
        log.append((self.version + 1, rows))

    def _log_ports(self, row: int, word: Optional[int] = None) -> None:
        """Record a port-bitmap row about to change at `ports_version +
        1`. MUST be called before the matching bump. `word` names the
        single touched u32 word for port flips; None means the whole
        row (rebuilds)."""
        log = self._ports_log
        if len(log) >= self.delta_log_len:
            self._ports_floor = log[0][0]   # floor BEFORE pop, see _log_hot
            log.popleft()
        log.append((self.ports_version + 1, row, word))

    def hot_rows_since(self, v0: int, limit: int) -> Optional[Set[int]]:
        """Rows whose used/node_ok/dyn_free changed in (v0, version] —
        a SUPERSET is fine (re-applying an unchanged row is a no-op).
        None when the window can't cover v0 or the delta would exceed
        `limit` rows (full upload is then cheaper). The floor is
        re-checked AFTER copying the log: a concurrent append can wrap
        the deque and drop a needed entry between an up-front check and
        the copy, which would silently yield an incomplete row set."""
        entries = self.hot_entries_since(v0, limit)
        if entries is None:
            return None
        rows: Set[int] = set()
        for _ver, rs in entries:
            rows.update(rs)
        return rows

    def hot_entries_since(self, v0: int, limit: int
                          ) -> Optional[list]:
        """Version-attributed form of hot_rows_since: [(version, rows)]
        for entries in (v0, version], None on window miss or when the
        row union exceeds `limit`. The versions let the device-view
        refresh classify each change against the plan-commit windows
        (kernel-committed → covered by the dispatch carry; anything
        else → host re-upload)."""
        out = []
        rows: Set[int] = set()
        entries = list(self._hot_log)
        if v0 < self._hot_floor:
            return None
        for ver, rs in entries:
            if ver > v0:
                out.append((ver, rs))
                rows.update(rs)
                if len(rows) > limit:
                    return None
        return out

    def port_words_since(self, pv0: int, limit: int
                         ) -> Optional[Dict[int, Optional[Set[int]]]]:
        """Word-granular port delta: {row: set of touched u32 words, or
        None for a whole-row rebuild} for changes in (pv0,
        ports_version]. None on window miss or row-count overflow (the
        hot_rows_since contract, including the copy-then-check floor
        ordering). A port flip names one word, so a steady-state
        refresh ships 4-byte words instead of 8 KB rows — the
        transfer-compaction half of the D2D plan-delta path."""
        out: Dict[int, Optional[Set[int]]] = {}
        entries = list(self._ports_log)
        if pv0 < self._ports_floor:
            return None
        for ver, row, word in entries:
            if ver <= pv0:
                continue
            if word is None:
                out[row] = None
            elif row not in out:
                out[row] = {word}
            elif out[row] is not None:
                out[row].add(word)
            if len(out) > limit:
                return None
        return out

    def delta_stats(self) -> Dict[str, int]:
        """Delta-log health for the observability surfaces (stack.py
        gauges these per refresh): log occupancy vs DELTA_LOG_LEN says
        how close the window is to wrapping (a wrap downgrades stale
        caches to full uploads), the floors say how far back a cache may
        lag and still refresh incrementally."""
        return {
            "hot_log_len": len(self._hot_log),
            "hot_floor": self._hot_floor,
            "ports_log_len": len(self._ports_log),
            "ports_floor": self._ports_floor,
            "version": self.version,
            "ports_version": self.ports_version,
        }

    # ---- nodes ----

    def _grow_rows(self) -> None:
        new_cap = self.n_cap * 2
        for name in ("capacity", "used"):
            arr = getattr(self, name)
            grown = np.zeros((new_cap, R_TOTAL), dtype=arr.dtype)
            grown[: self.n_cap] = arr
            setattr(self, name, grown)
        ok = np.zeros(new_cap, dtype=bool)
        ok[: self.n_cap] = self.node_ok
        self.node_ok = ok
        pw = np.zeros((new_cap, PORT_WORDS), dtype=np.uint32)
        pw[: self.n_cap] = self.ports_used
        self.ports_used = pw
        # shape change: no row delta can express it — force full uploads
        # for every cached view (the shape check in device_arrays catches
        # this too; the floors make it explicit)
        self._hot_floor = self.version + 1
        self._ports_floor = self.ports_version + 1
        self.ports_version += 1
        df = np.zeros(new_cap, dtype=np.float32)
        df[: self.n_cap] = self.dyn_free
        self.dyn_free = df
        self.port_refs.extend(dict() for _ in range(new_cap - self.n_cap))
        self.base_ports.extend([frozenset()] * (new_cap - self.n_cap))
        at = np.full((new_cap, self.k_cap), MISSING, dtype=np.int32)
        at[: self.n_cap] = self.attrs
        self.attrs = at
        self.free_rows = list(range(new_cap - 1, self.n_cap - 1, -1)) + self.free_rows
        self.node_of_row.extend([None] * (new_cap - self.n_cap))
        self.n_cap = new_cap

    def _grow_keys(self) -> None:
        new_k = self.k_cap * 2
        at = np.full((self.n_cap, new_k), MISSING, dtype=np.int32)
        at[:, : self.k_cap] = self.attrs
        self.attrs = at
        self.k_cap = new_k

    def _set_attr(self, row: int, key: str, value: str) -> None:
        k, tok = self.vocab.intern(key, value)
        while k >= self.k_cap:
            self._grow_keys()
        self.attrs[row, k] = tok

    # ---- port bitmap maintenance ----

    def _set_port(self, row: int, port: int) -> None:
        self.ports_used[row, port >> 5] |= np.uint32(1 << (port & 31))
        self._log_ports(row, port >> 5)
        self.ports_version += 1
        if MIN_DYNAMIC_PORT <= port <= MAX_DYNAMIC_PORT:
            self.dyn_free[row] -= 1.0

    def _clear_port(self, row: int, port: int) -> None:
        self.ports_used[row, port >> 5] &= np.uint32(
            ~(1 << (port & 31)) & 0xFFFFFFFF)
        self._log_ports(row, port >> 5)
        self.ports_version += 1
        if MIN_DYNAMIC_PORT <= port <= MAX_DYNAMIC_PORT:
            self.dyn_free[row] += 1.0

    def _add_alloc_ports(self, alloc_id: str, row: int,
                         ports: List[int]) -> None:
        refs = self.port_refs[row]
        for port in ports:
            prev = refs.get(port, 0)
            refs[port] = prev + 1
            if prev == 0 and port not in self.base_ports[row]:
                self._set_port(row, port)
        self.alloc_ports[alloc_id] = (row, ports)

    def _release_alloc_ports(self, alloc_id: str) -> None:
        entry = self.alloc_ports.pop(alloc_id, None)
        if entry is None:
            return
        row, ports = entry
        refs = self.port_refs[row]
        for port in ports:
            cur = refs.get(port, 0)
            if cur <= 1:
                refs.pop(port, None)
                if port not in self.base_ports[row]:
                    self._clear_port(row, port)
            else:
                refs[port] = cur - 1

    @staticmethod
    def _alloc_port_list(alloc: Allocation) -> List[int]:
        """Host ports held by an alloc's offers (reference
        NetworkIndex.AddAllocs walking AllocatedResources networks,
        network.go:144)."""
        out: List[int] = []
        ar = alloc.allocated_resources
        if ar is None:
            return out
        nets = [n for tr in ar.tasks.values() for n in tr.networks]
        nets += list(ar.shared.networks)
        for net in nets:
            for p in list(net.reserved_ports) + list(net.dynamic_ports):
                if 0 <= p.value < PORT_WORDS * 32:
                    out.append(p.value)
        return out

    def device_col(self, device_id: str) -> Optional[int]:
        """Column for a device *pool*, keyed by vendor/type (groups of the
        same vendor/type share a column — matches the 1-/2-part ask forms of
        RequestedDevice.ID, structs.go:2552-2554; model-specific 3-part or
        constrained asks are resolved host-side by DeviceAllocator with
        offer-retry)."""
        parts = device_id.split("/")
        pool = "/".join(parts[:2]) if len(parts) >= 2 else device_id
        col = self.device_cols.get(pool)
        if col is None:
            if len(self.device_cols) >= MAX_DEVICE_COLS:
                return None
            col = BASE_RESOURCES + len(self.device_cols)
            self.device_cols[pool] = col
        return col

    def upsert_node(self, node: Node) -> int:
        row = self.row_of.get(node.id)
        if row is None:
            if not self.free_rows:
                self._grow_rows()
            row = self.free_rows.pop()
            self.row_of[node.id] = row
            self.node_of_row[row] = node.id
        self.nodes[node.id] = node
        old = self._ready_contrib.get(node.id)
        if old is not None and old[1]:
            self.ready_by_dc[old[0]] -= 1
        contrib = (node.datacenter, bool(node.ready()))
        self._ready_contrib[node.id] = contrib
        if contrib[1]:
            self.ready_by_dc[contrib[0]] = \
                self.ready_by_dc.get(contrib[0], 0) + 1
        res = node.node_resources
        rsv = node.reserved_resources
        cap = np.zeros(R_TOTAL, dtype=np.float32)
        cap[R_CPU] = res.cpu - rsv.cpu
        cap[R_MEM] = res.memory_mb - rsv.memory_mb
        cap[R_DISK] = res.disk_mb - rsv.disk_mb
        # Bandwidth as a hard fit column (reference: NetworkIndex.Overcommitted
        # inside AllocsFit, structs/network.go:66)
        cap[R_BW] = sum(nw.mbits for nw in res.networks)
        for dev in res.devices:
            col = self.device_col(dev.id())
            if col is not None:
                # accumulate: same-pool groups (vendor/type) share a column
                cap[col] += sum(1 for i in dev.instances if i.healthy)
        self.capacity[row] = cap
        self.node_ok[row] = node.ready()
        # ports: rebuild the row bitmap from the node's reserved ports
        # (network.go:110-139) plus live alloc refcounts
        from ..structs.network import parse_port_ranges

        base = frozenset(p for p in parse_port_ranges(
            rsv.reserved_ports) if 0 <= p < PORT_WORDS * 32)
        self.base_ports[row] = base
        self.ports_used[row, :] = 0
        self._log_ports(row)
        self.ports_version += 1
        self.dyn_free[row] = DYN_PORT_SPAN
        for port in base:
            self._set_port(row, port)
        for port in self.port_refs[row]:
            if port not in base:
                self._set_port(row, port)
        # attributes
        self.attrs[row, :] = MISSING
        self._set_attr(row, "node.unique.id", node.id)
        self._set_attr(row, "node.unique.name", node.name)
        self._set_attr(row, "node.datacenter", node.datacenter)
        self._set_attr(row, "node.class", node.node_class)
        for k, v in node.attributes.items():
            self._set_attr(row, f"attr.{k}", v)
        for k, v in node.meta.items():
            self._set_attr(row, f"meta.{k}", v)
        # Driver health pseudo-attrs (reference DriverChecker, feasible.go:398:
        # DriverInfo detected+healthy, legacy fallback to attr truthiness)
        drivers = set()
        for name, info in node.drivers.items():
            drivers.add(name)
            healthy = "1" if (info.detected and info.healthy) else "0"
            self._set_attr(row, f"__driver.{name}", healthy)
        for k, v in node.attributes.items():
            if k.startswith("driver.") and "." not in k[len("driver."):]:
                name = k[len("driver."):]
                if name not in drivers:
                    truthy = "1" if v in ("1", "true") else "0"
                    self._set_attr(row, f"__driver.{name}", truthy)
        # Volume/plugin pseudo-attrs: host volumes (HostVolumeChecker,
        # feasible.go:117 — value encodes writability) and CSI node
        # plugins (CSIVolumeChecker's per-node plugin presence half,
        # feasible.go:194)
        for name, cfg in (node.host_volumes or {}).items():
            self._set_attr(row, f"__volume.host.{name}",
                           "ro" if cfg.read_only else "rw")
        for pid, info in (node.csi_node_plugins or {}).items():
            healthy = "1" if getattr(info, "healthy", True) else "0"
            self._set_attr(row, f"__plugin.csi.{pid}", healthy)
        self._log_hot(row)
        self.version += 1
        self.node_version += 1
        return row

    def remove_node(self, node_id: str) -> None:
        row = self.row_of.pop(node_id, None)
        if row is None:
            return
        self.nodes.pop(node_id, None)
        old = self._ready_contrib.pop(node_id, None)
        if old is not None and old[1]:
            self.ready_by_dc[old[0]] -= 1
        self.node_of_row[row] = None
        self.capacity[row] = 0
        self._log_ports(row)
        self.ports_version += 1
        self.used[row] = 0
        self.node_ok[row] = False
        self.attrs[row, :] = MISSING
        self.ports_used[row, :] = 0
        self.dyn_free[row] = 0.0
        self.base_ports[row] = frozenset()
        self.port_refs[row] = {}
        # Drop alloc accounting pointing at the freed row — otherwise a
        # later release would mutate whatever node reuses the row, and the
        # upsert_node rebuild would resurrect stale ports/usage.
        for aid in [a for a, (r, _p) in self.alloc_ports.items() if r == row]:
            del self.alloc_ports[aid]
        for aid in [a for a, (r, _u) in self.alloc_usage.items() if r == row]:
            del self.alloc_usage[aid]
        for japs in self.job_allocs.values():
            for aid in [a for a, (r, _tg) in japs.items() if r == row]:
                del japs[aid]
        self.free_rows.append(row)
        self._log_hot(row)
        self.version += 1
        self.node_version += 1

    # ---- allocations ----

    def usage_row(self, alloc: Allocation) -> np.ndarray:
        """Alloc utilization as a resource row (comparable form, reference
        `Allocation.ComparableResources`, structs.go:8958 + device counts)."""
        u = np.zeros(R_TOTAL, dtype=np.float64)
        cr = alloc.comparable_resources()
        u[R_CPU] = cr.cpu
        u[R_MEM] = cr.memory_mb
        u[R_DISK] = cr.disk_mb
        u[R_BW] = sum(nw.mbits for nw in cr.networks)
        if alloc.allocated_resources is not None:
            for tr in alloc.allocated_resources.tasks.values():
                for dev in tr.devices:
                    col = self.device_cols.get(f"{dev.vendor}/{dev.type}")
                    if col is not None:
                        u[col] += len(dev.device_ids)
        return u

    def upsert_alloc(self, alloc: Allocation) -> None:
        """Maintain `used` and the job index. Terminal allocs release usage
        (mirrors the reference's non-terminal filter in AllocsByNodeTerminal,
        state_store usage via context.go:122)."""
        touched = []
        prev = self.alloc_usage.pop(alloc.id, None)
        if prev is not None:
            row, usage = prev
            self.used[row] -= usage
            touched.append(row)
        pp = self.alloc_ports.get(alloc.id)
        if pp is not None:
            touched.append(pp[0])  # release flips that row's dyn_free
        self._release_alloc_ports(alloc.id)
        japs = self.job_allocs.setdefault(alloc.job_id, {})
        japs.pop(alloc.id, None)

        if alloc.terminal_status():
            if not japs:
                self.job_allocs.pop(alloc.job_id, None)
            self._log_hot(*touched)
            self.version += 1
            return

        row = self.row_of.get(alloc.node_id)
        if row is None:
            self._log_hot(*touched)
            self.version += 1
            return
        usage = self.usage_row(alloc)
        self.used[row] += usage
        self.alloc_usage[alloc.id] = (row, usage)
        self._add_alloc_ports(alloc.id, row, self._alloc_port_list(alloc))
        japs[alloc.id] = (row, alloc.task_group)
        touched.append(row)
        self._log_hot(*touched)
        self.version += 1

    def remove_alloc(self, alloc_id: str, job_id: str = "") -> None:
        touched = []
        prev = self.alloc_usage.pop(alloc_id, None)
        if prev is not None:
            row, usage = prev
            self.used[row] -= usage
            touched.append(row)
        pp = self.alloc_ports.get(alloc_id)
        if pp is not None:
            touched.append(pp[0])
        self._release_alloc_ports(alloc_id)
        if job_id and job_id in self.job_allocs:
            self.job_allocs[job_id].pop(alloc_id, None)
        else:
            for japs in self.job_allocs.values():
                if alloc_id in japs:
                    del japs[alloc_id]
                    break
        self._log_hot(*touched)
        self.version += 1

    # ---- per-eval vectors ----

    def rows_for_allocs(self, alloc_ids) -> List[Tuple[int, np.ndarray]]:
        out = []
        for aid in alloc_ids:
            entry = self.alloc_usage.get(aid)
            if entry is not None:
                out.append(entry)
        return out

    # ---- snapshot ----

    def snapshot(self) -> ClusterSnapshot:
        return ClusterSnapshot(
            capacity=self.capacity,
            used=self.used,
            node_ok=self.node_ok,
            attrs=self.attrs,
            ports_used=self.ports_used,
            dyn_free=self.dyn_free,
            n_rows=self.n_cap - len(self.free_rows),
            row_to_node_id=list(self.node_of_row),
        )
