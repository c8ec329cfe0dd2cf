"""Durable write-ahead log + snapshot files (checkpoint/resume).

Behavioral reference: the reference persists server state as a Raft log in
BoltDB plus FSM snapshots (`nomad/fsm.go:1242,1256`, raft-boltdb at
`go.mod:83-84`) restored on startup, with `operator snapshot save/restore`
(`helper/snapshot`). Here the log is a msgpack frame stream and snapshots
are msgpack trees — the same entry encoding the Raft transport replicates
in the multi-server build.

Files in `data_dir`:
- `wal.log`       — stream of {"s": seq, "op": ..., "args": [...]} frames
- `snapshot.mp`   — latest full-state snapshot (atomic tmp+rename), with
                    `wal_seq` = last entry folded in; log entries with
                    seq ≤ wal_seq are skipped on replay
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

import time

import msgpack

from ..lib.journal import load_journal
from ..lib.metrics import MetricsRegistry, default_registry
from ..structs.codec import to_wire
from .fsm import ALLOWED_OPS, FSM, snapshot_state
from .state import StateStore

WAL_FILE = "wal.log"
SNAPSHOT_FILE = "snapshot.mp"
DEFAULT_SNAPSHOT_THRESHOLD = 8192


class Wal:
    def __init__(self, data_dir: str, fsync: bool = False,
                 metrics: Optional[MetricsRegistry] = None) -> None:
        self.data_dir = data_dir
        self.fsync = fsync
        os.makedirs(data_dir, exist_ok=True)
        self._path = os.path.join(data_dir, WAL_FILE)
        self._snap_path = os.path.join(data_dir, SNAPSHOT_FILE)
        self._lock = threading.Lock()
        self._fh = None
        self._packer = msgpack.Packer(use_bin_type=True)
        self.seq = 0
        # durability instruments: append/fsync latency is the
        # write-path floor every acknowledged mutation pays; snapshot
        # duration + on-disk sizes are the compaction health read.
        # Created EAGERLY so the exposed series set is deterministic.
        self.metrics = metrics if metrics is not None \
            else default_registry()
        self._m_append_ms = self.metrics.histogram("wal.append_ms")
        self._m_fsync_ms = self.metrics.histogram("wal.fsync_ms")
        self._m_snapshot_ms = self.metrics.histogram("wal.snapshot_ms")
        self._ctr_appends = self.metrics.counter("wal.appends")
        self._ctr_snapshots = self.metrics.counter("wal.snapshots")
        self._g_log_bytes = self.metrics.gauge("wal.log_bytes")
        self._g_snap_bytes = self.metrics.gauge("wal.snapshot_bytes")
        self._log_bytes = 0
        if os.path.exists(self._path):
            self._log_bytes = os.path.getsize(self._path)
            self._g_log_bytes.set(self._log_bytes)
        if os.path.exists(self._snap_path):
            self._g_snap_bytes.set(os.path.getsize(self._snap_path))

    # ---- load (restore path) ----

    def load(self) -> Tuple[Optional[Dict[str, Any]], List[Dict[str, Any]]]:
        """Returns (snapshot_tree | None, log entries newer than it)."""
        snap = None
        if os.path.exists(self._snap_path):
            with open(self._snap_path, "rb") as fh:
                snap = msgpack.unpackb(fh.read(), raw=False,
                                       strict_map_key=False)
        after = snap["wal_seq"] if snap else 0
        entries: List[Dict[str, Any]] = []
        if os.path.exists(self._path):
            # load_journal truncates the torn/invalid tail in place so
            # future appends don't land after undecodable bytes — they'd
            # be lost on next load.
            for entry in load_journal(self._path,
                                      validate=lambda r: "s" in r):
                if entry["s"] > after:
                    entries.append(entry)
        last_seq = entries[-1]["s"] if entries else after
        self.seq = max(self.seq, last_seq)
        return snap, entries

    # ---- append path ----

    def _ensure_open(self):
        if self._fh is None:
            self._fh = open(self._path, "ab")
        return self._fh

    def append(self, op: str, args: List[Any]) -> int:
        t0 = time.perf_counter()
        with self._lock:
            self.seq += 1
            frame = self._packer.pack({"s": self.seq, "op": op, "args": args})
            fh = self._ensure_open()
            fh.write(frame)
            fh.flush()
            if self.fsync:
                tf = time.perf_counter()
                os.fsync(fh.fileno())
                self._m_fsync_ms.add_sample(
                    (time.perf_counter() - tf) * 1e3)
            self._log_bytes += len(frame)
            seq = self.seq
        self._ctr_appends.inc()
        self._g_log_bytes.set(self._log_bytes)
        self._m_append_ms.add_sample((time.perf_counter() - t0) * 1e3)
        return seq

    # ---- snapshot rotation ----

    def write_snapshot(self, tree: Dict[str, Any]) -> None:
        """Atomically persist a snapshot and truncate the log. Caller must
        guarantee no concurrent appends (the durable store holds its write
        lock across snapshot+rotate)."""
        t0 = time.perf_counter()
        with self._lock:
            tree = dict(tree)
            tree["wal_seq"] = self.seq
            tmp = self._snap_path + ".tmp"
            with open(tmp, "wb") as fh:
                fh.write(msgpack.packb(tree, use_bin_type=True))
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self._snap_path)
            if self._fh is not None:
                self._fh.close()
            self._fh = open(self._path, "wb")  # truncate
            self._log_bytes = 0
            snap_bytes = os.path.getsize(self._snap_path)
        self._ctr_snapshots.inc()
        self._g_log_bytes.set(0)
        self._g_snap_bytes.set(snap_bytes)
        # the whole rotation (serialize + fsync + truncate) counts: it
        # runs under the store's write lock, so this IS the write stall
        self._m_snapshot_ms.add_sample((time.perf_counter() - t0) * 1e3)

    def status(self) -> Dict[str, Any]:
        """Durability health view (the `operator debug` wal section)."""
        with self._lock:
            return {
                "seq": self.seq,
                "log_bytes": self._log_bytes,
                "snapshot_bytes": int(self._g_snap_bytes.value),
                "appends": int(self._ctr_appends.value),
                "snapshots": int(self._ctr_snapshots.value),
                "fsync": self.fsync,
                "data_dir": self.data_dir,
            }

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def _encode_args(op: str, args) -> List[Any]:
    """Wire-encode mutator args, stripping what replay never reads.

    `upsert_plan_results(plan, result)` replay only consumes `result`
    (harness.py upsert_plan_results), and embedded per-alloc Job trees are
    reattached from the jobs table on replay — journaling them would
    multiply the hottest log entry several-fold."""
    if op == "upsert_plan_results":
        wire = to_wire(args[1])
        for table in ("node_update", "node_preemptions", "node_allocation"):
            for allocs in (wire.get(table) or {}).values():
                for a in allocs:
                    a["job"] = None
        return [None, wire]
    if op == "update_alloc_from_client":
        # Replay copies only the client-status fields; the embedded Job
        # tree would bloat the hottest durable write for nothing.
        wire = to_wire(args[0])
        wire["job"] = None
        return [wire]
    return [to_wire(a) if not isinstance(
        a, (str, int, float, bool, bytes, type(None))) else a for a in args]


class DurableStateStore(StateStore):
    """StateStore whose write API journals every mutation to a WAL before
    acknowledging, with automatic snapshot rotation.

    Nested mutations (upsert_plan_results → upsert_alloc) journal only the
    outermost op — replay re-executes the nesting itself.
    """

    _LOGGED = ALLOWED_OPS

    def __init__(self, wal: Wal,
                 snapshot_threshold: int = DEFAULT_SNAPSHOT_THRESHOLD) -> None:
        super().__init__()
        self.wal = wal
        self.snapshot_threshold = snapshot_threshold
        self._local = threading.local()
        self._appends_since_snapshot = 0
        self._restoring = False

    # -- restore --

    def restore(self) -> int:
        """Load snapshot + replay log. Returns number of replayed entries."""
        from .fsm import restore_state

        snap, entries = self.wal.load()
        self._restoring = True
        try:
            # replayed history must not re-announce itself on the event
            # stream (the broker — attached by the Server after restore —
            # starts at the restored index; earlier ranges are a gap)
            with self.suspend_events():
                if snap is not None:
                    restore_state(self, snap)
                fsm = FSM(self)
                for entry in entries:
                    fsm.apply_resilient(entry)
        finally:
            self._restoring = False
        if self.event_broker is not None:
            self.event_broker.mark_restored(self.index.value)
        return len(entries)

    # -- journaling wrapper --

    def _journal(self, op: str, wire_args: List[Any]) -> None:
        self.wal.append(op, wire_args)
        self._appends_since_snapshot += 1

    def snapshot_save(self) -> None:
        """Fold the log into a fresh snapshot (operator snapshot save)."""
        with self._cv:
            self.wal.write_snapshot(snapshot_state(self))
            self._appends_since_snapshot = 0

    def _wrap(name):  # noqa: N805 — decorator factory over parent methods
        parent_unbound = getattr(StateStore, name)

        def method(self, *args):
            with self._cv:
                depth = getattr(self._local, "depth", 0)
                if depth == 0 and not self._restoring:
                    # Validate while holding the store lock, BEFORE the
                    # journal append — an op that would raise during apply
                    # must never reach the log (fsm.validate_op).
                    from .fsm import validate_op

                    validate_op(self, name, args)
                    # Write-AHEAD: journal before mutating so a failed append
                    # leaves memory and log consistent (the op is rejected,
                    # not half-recorded). Replay through the same mutators
                    # re-stamps identical indexes in append order.
                    self._journal(name, _encode_args(name, args))
                self._local.depth = depth + 1
                try:
                    out = parent_unbound(self, *args)
                finally:
                    self._local.depth = depth
                if (depth == 0 and not self._restoring
                        and self._appends_since_snapshot
                        >= self.snapshot_threshold):
                    # Rotate only AFTER the journaled op has been applied —
                    # the snapshot must contain every entry its wal_seq
                    # claims to fold in.
                    self.snapshot_save()
                return out

        method.__name__ = name
        return method

    for _name in sorted(_LOGGED):
        locals()[_name] = _wrap(_name)
    del _name, _wrap
