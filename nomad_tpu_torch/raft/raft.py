"""A compact, correct Raft: leader election, log replication, commit.

Behavioral reference: the reference embeds hashicorp/raft (consumed at
`nomad/server.go:1198-1360`; FSM contract `nomad/fsm.go:74`); this module
implements the protocol itself (Raft §5, Ongaro & Ousterhout) because no
consensus library is vendored here:

- RequestVote with the log-up-to-dateness check (§5.4.1)
- AppendEntries with prev-log matching + conflict truncation (§5.3)
- commitIndex advancement only for current-term entries (§5.4.2)
- randomized election timeouts, leader heartbeats
- optional on-disk persistence of (term, votedFor, log) — the raft-boltdb
  analog — via msgpack frames
- log compaction + InstallSnapshot (§7; fsm.go Snapshot :1242 / Restore
  :1256): when `snapshot_fn`/`restore_fn` are configured, the applier
  folds every `snapshot_threshold` applied entries into an FSM snapshot,
  truncates the log prefix (memory AND the on-disk journal), and serves
  the snapshot to followers whose next_index fell below the log base —
  a lagging or freshly-joined server catches up in one transfer instead
  of replaying history; restart restores the FSM from the latest
  snapshot and replays only the suffix.

Threading model: one ticker thread (election/heartbeat), one applier
thread (feeds committed entries to the FSM apply_fn in order; takes the
compaction snapshots, so they are consistent at exactly last_applied),
replication performed per-peer on heartbeat ticks and on demand after
an append. Membership changes ride the log (remove_peer/add_peer), and
the voter map at the snapshot point is stored inside the snapshot so
compacted conf entries survive installs.
"""
from __future__ import annotations

import os
import random
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import msgpack

from ..lib.flight import default_flight
from ..lib.journal import load_journal
from ..lib.metrics import MetricsRegistry

FOLLOWER = "follower"
CANDIDATE = "candidate"
LEADER = "leader"

#: raft.state gauge encoding (dashboards key on the number)
_STATE_CODE = {FOLLOWER: 0, CANDIDATE: 1, LEADER: 2}

HEARTBEAT_INTERVAL = 0.05
ELECTION_TIMEOUT = (0.15, 0.30)
MAX_APPEND_BATCH = 512


class NotLeaderError(Exception):
    def __init__(self, leader_id: Optional[str] = None) -> None:
        super().__init__(f"not leader (leader={leader_id})")
        self.leader_id = leader_id


class _Log:
    """1-indexed in-memory log with optional append-only file journal.

    Compaction support: the in-memory list holds only the SUFFIX
    `[base_index+1 .. last_index]`; everything at or below `base_index`
    has been folded into an FSM snapshot (base_term is the term of the
    entry at base_index, needed for AppendEntries prev-log matching at
    the boundary). A `{"op": "base"}` journal record marks a compaction
    point; the journal is rewritten (tmp + rename) on compact so it
    stays bounded on disk too."""

    def __init__(self, path: Optional[str] = None,
                 fsync: bool = False) -> None:
        self.entries: List[Dict[str, Any]] = []  # {"term": t, "data": ...}
        self.base_index = 0
        self.base_term = 0
        self._path = path
        self._fsync = fsync
        self._fh = None
        if path is not None and os.path.exists(path):
            # load_journal truncates any torn/invalid tail in place so the
            # append-mode reopen below can't land acknowledged entries
            # after undecodable bytes (Raft persisted-log safety).
            recs = load_journal(
                path,
                validate=lambda r: ("term" in r and "data" in r)
                or (r.get("op") == "trunc" and "from" in r)
                or (r.get("op") == "base" and "index" in r))
            for rec in recs:
                op = rec.get("op")
                if op == "trunc":
                    del self.entries[rec["from"] - self.base_index - 1:]
                elif op == "base":
                    self.entries = []
                    self.base_index = rec["index"]
                    self.base_term = rec.get("term", 0)
                else:
                    self.entries.append(rec)

    def _journal(self, rec: Dict[str, Any]) -> None:
        if self._path is None:
            return
        if self._fh is None:
            self._fh = open(self._path, "ab")
        self._fh.write(msgpack.packb(rec, use_bin_type=True))
        self._fh.flush()
        if self._fsync:
            os.fsync(self._fh.fileno())

    def _rewrite_journal(self) -> None:
        """Replace the on-disk journal with base marker + current suffix
        (atomic rename) — this is what keeps the disk log bounded."""
        if self._path is None:
            return
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        tmp = self._path + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(msgpack.packb(
                {"op": "base", "index": self.base_index,
                 "term": self.base_term}, use_bin_type=True))
            for e in self.entries:
                fh.write(msgpack.packb(e, use_bin_type=True))
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self._path)

    def last_index(self) -> int:
        return self.base_index + len(self.entries)

    def term_at(self, index: int) -> int:
        if index == 0:
            return 0
        if index == self.base_index:
            return self.base_term
        if index < self.base_index:
            # negative list indexing would silently return a WRONG
            # entry's term — compacted history is unknowable, say so
            raise KeyError(f"index {index} compacted (base "
                           f"{self.base_index})")
        return self.entries[index - self.base_index - 1]["term"]

    def append(self, term: int, data: Any) -> int:
        entry = {"term": term, "data": data}
        self.entries.append(entry)
        self._journal(entry)
        return self.last_index()

    def truncate_from(self, index: int) -> None:
        """Drop entries[index:] (1-indexed, inclusive)."""
        if index <= self.last_index():
            del self.entries[index - self.base_index - 1:]
            self._journal({"op": "trunc", "from": index})

    def compact_to(self, index: int, term: int) -> None:
        """Fold entries ≤ index into the (already-persisted) snapshot."""
        if index <= self.base_index:
            return
        del self.entries[: index - self.base_index]
        self.base_index = index
        self.base_term = term
        self._rewrite_journal()

    def reset_to(self, index: int, term: int) -> None:
        """InstallSnapshot on a follower: discard the whole log and start
        the suffix after the snapshot point."""
        self.entries = []
        self.base_index = index
        self.base_term = term
        self._rewrite_journal()

    def slice(self, start: int, limit: int = MAX_APPEND_BATCH
              ) -> List[Dict[str, Any]]:
        """Entries from 1-indexed `start` (start must be > base_index)."""
        off = start - self.base_index - 1
        return self.entries[off: off + limit]

    def disk_bytes(self) -> int:
        """Current on-disk journal size (0 for memory-only logs) — the
        bounded-log health read next to `compact_to`."""
        if self._path is None or not os.path.exists(self._path):
            return 0
        try:
            return os.path.getsize(self._path)
        except OSError:
            return 0

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class RaftNode:
    """One consensus participant.

    peers: {node_id: (host, port)} including self. `rpc_server` must be an
    RpcServer this node registers its Raft.* handlers on; `pool` a ConnPool
    for outbound calls. `apply_fn(data)` receives committed entries in log
    order on every node (leader and followers alike).
    """

    def __init__(self, node_id: str, peers: Dict[str, Tuple[str, int]],
                 rpc_server, pool, apply_fn: Callable[[Any], None],
                 data_dir: Optional[str] = None,
                 heartbeat_interval: float = HEARTBEAT_INTERVAL,
                 election_timeout: Tuple[float, float] = ELECTION_TIMEOUT,
                 on_leadership_change: Optional[Callable[[bool], None]] = None,
                 fsync: bool = False,
                 snapshot_fn: Optional[Callable[[], Any]] = None,
                 restore_fn: Optional[Callable[[Any], None]] = None,
                 snapshot_threshold: int = 8192,
                 metrics: Optional[MetricsRegistry] = None,
                 ) -> None:
        self.id = node_id
        self.peers = dict(peers)
        self.pool = pool
        self.apply_fn = apply_fn
        self.heartbeat_interval = heartbeat_interval
        self.election_timeout = election_timeout
        self.on_leadership_change = on_leadership_change
        #: FSM snapshot/restore hooks (fsm.go Snapshot :1242 / Restore
        #: :1256): snapshot_fn() returns a msgpack-able blob of the whole
        #: FSM state as of the entries applied so far; restore_fn(blob)
        #: rebuilds the FSM from one. Compaction is disabled without them.
        self.snapshot_fn = snapshot_fn
        self.restore_fn = restore_fn
        self.snapshot_threshold = snapshot_threshold
        #: per-node instrument registry (a node outlives the leadership-
        #: gated Server and its registry). Instruments are created
        #: EAGERLY so the exposed series set is deterministic — name
        #: pinning (tests/test_metrics_names.py) never depends on which
        #: code paths a test happened to drive.
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._m_commit_ms = self.metrics.histogram("raft.commit_ms")
        self._m_apply_ms = self.metrics.histogram("raft.apply_ms")
        self._m_append_ms = self.metrics.histogram("raft.append_ms")
        self._ctr_elections = self.metrics.counter("raft.elections")
        self._ctr_gained = self.metrics.counter("raft.leadership_gained")
        self._ctr_lost = self.metrics.counter("raft.leadership_lost")
        self._ctr_snapshots = self.metrics.counter("raft.snapshots")
        self._ctr_installs = self.metrics.counter("raft.snapshot_installs")
        self._g_term = self.metrics.gauge("raft.term")
        self._g_state = self.metrics.gauge("raft.state")
        self._g_commit = self.metrics.gauge("raft.commit_index")
        self._g_applied = self.metrics.gauge("raft.last_applied")
        self._g_log_last = self.metrics.gauge("raft.log_last_index")
        self._g_log_base = self.metrics.gauge("raft.log_base_index")
        self.metrics.gauge("raft.log_bytes")
        self.metrics.gauge("raft.peers")

        self._lock = threading.RLock()
        self._commit_cv = threading.Condition(self._lock)
        self._leadership_q: "deque[bool]" = deque()
        self._notify_lock = threading.Lock()
        self._notifier_running = False
        #: applier is outside the lock running apply_fn on a batch —
        #: InstallSnapshot must wait for it before swapping FSM state
        self._applying = False

        self._meta_path = None
        self._snap_path = None
        log_path = None
        if data_dir is not None:
            os.makedirs(data_dir, exist_ok=True)
            self._meta_path = os.path.join(data_dir, "raft_meta.mp")
            log_path = os.path.join(data_dir, "raft_log.mp")
            self._snap_path = os.path.join(data_dir, "raft_snap.mp")
        self.log = _Log(log_path, fsync=fsync)

        self.term = 0
        self.voted_for: Optional[str] = None
        self._load_meta()

        self.state = FOLLOWER
        self.leader_id: Optional[str] = None
        self.commit_index = 0
        self.last_applied = 0
        #: latest FSM snapshot {"index","term","peers","state"} — served
        #: to lagging followers whose next_index fell below the log base
        self._snapshot: Optional[Dict[str, Any]] = None
        self._load_snapshot()
        self._next_index: Dict[str, int] = {}
        self._match_index: Dict[str, int] = {}
        self._last_heard = time.monotonic()
        self._timeout = self._rand_timeout()
        self._stop = threading.Event()
        # futures: log index -> (event, [result])
        self._waiters: Dict[int, threading.Event] = {}

        rpc_server.register("Raft.RequestVote", self._handle_request_vote)
        rpc_server.register("Raft.AppendEntries", self._handle_append_entries)
        rpc_server.register("Raft.InstallSnapshot",
                            self._handle_install_snapshot)

        self._ticker = threading.Thread(target=self._run_ticker,
                                        name=f"raft-tick-{node_id}",
                                        daemon=True)
        self._applier = threading.Thread(target=self._run_applier,
                                         name=f"raft-apply-{node_id}",
                                         daemon=True)

    # ---- lifecycle ----

    def start(self) -> None:
        self._ticker.start()
        self._applier.start()

    def shutdown(self) -> None:
        self._stop.set()
        with self._commit_cv:
            self._commit_cv.notify_all()
        self.log.close()

    # ---- persistence of (term, votedFor) ----

    def _load_meta(self) -> None:
        if self._meta_path is None or not os.path.exists(self._meta_path):
            return
        with open(self._meta_path, "rb") as fh:
            meta = msgpack.unpackb(fh.read(), raw=False)
        self.term = meta.get("term", 0)
        self.voted_for = meta.get("voted_for")

    def _save_meta(self) -> None:
        if self._meta_path is None:
            return
        tmp = self._meta_path + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(msgpack.packb(
                {"term": self.term, "voted_for": self.voted_for}))
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self._meta_path)

    # ---- FSM snapshots (fsm.go Snapshot/Restore; raft log compaction) --

    def _load_snapshot(self) -> None:
        """Boot: restore the FSM from the latest persisted snapshot and
        start applying after it (replaces full-log replay)."""
        if self._snap_path is None or not os.path.exists(self._snap_path):
            return
        with open(self._snap_path, "rb") as fh:
            snap = msgpack.unpackb(fh.read(), raw=False,
                                   strict_map_key=False)
        self._install_snapshot_locked(snap, persist=False)

    def _persist_snapshot(self, snap: Dict[str, Any]) -> None:
        if self._snap_path is None:
            return
        tmp = self._snap_path + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(msgpack.packb(snap, use_bin_type=True))
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self._snap_path)

    def _install_snapshot_locked(self, snap: Dict[str, Any],
                                 persist: bool) -> None:
        """Swap FSM state + log bookkeeping to a snapshot. Caller holds
        the lock (or is the constructor, pre-threads)."""
        idx, term = snap["index"], snap["term"]
        if self.restore_fn is not None:
            self.restore_fn(snap["state"])
        if persist:
            # Persist AFTER the restore succeeds (a rejected snapshot must
            # not become the durable boot state) but BEFORE truncating the
            # journal (same ordering as _maybe_take_snapshot): a crash
            # between the two leaves an over-long log + durable snapshot
            # (harmless), never a journal whose base_index points past the
            # on-disk snapshot — that state would make the applier index
            # before the log base.
            self._persist_snapshot(snap)
        if idx > self.log.last_index() or self.log.base_index > idx \
                or self.log.term_at(idx) != term:
            # our log diverges from / predates the snapshot: discard it
            self.log.reset_to(idx, term)
        else:
            # snapshot covers a prefix we also have: just compact
            self.log.compact_to(idx, term)
        self.commit_index = max(self.commit_index, idx)
        self.last_applied = max(self.last_applied, idx)
        if snap.get("peers"):
            self.peers = {p: tuple(a) for p, a in snap["peers"].items()}
        self._snapshot = snap

    def _maybe_take_snapshot(self) -> None:
        """Applier-thread only: the FSM is exactly at last_applied here
        (all mutations ride the log), so the snapshot is consistent by
        construction — no store quiescing needed."""
        if self.snapshot_fn is None:
            return
        with self._lock:
            if self.last_applied - self.log.base_index \
                    < self.snapshot_threshold:
                return
            idx = self.last_applied
            term = self.log.term_at(idx)
            peers = {p: list(a) for p, a in self.peers.items()}
            # flag the FSM as busy so a concurrent InstallSnapshot can't
            # swap state underneath the serializer
            self._applying = True
        try:
            state = self.snapshot_fn()
        finally:
            with self._commit_cv:
                self._applying = False
                self._commit_cv.notify_all()
        snap = {"index": idx, "term": term, "peers": peers,
                "state": state}
        with self._lock:
            if self.log.base_index >= idx or (
                    self._snapshot is not None
                    and self._snapshot["index"] >= idx):
                # a concurrent InstallSnapshot published a newer one —
                # persisting ours would roll the on-disk snapshot (and
                # what we serve to lagging peers) backwards
                return
            # persist BEFORE compacting: a crash between the two leaves
            # an over-long log (harmless), never a hole. Held under the
            # lock so no newer install can interleave with the write.
            self._persist_snapshot(snap)
            self._snapshot = snap
            self.log.compact_to(idx, term)
            self._ctr_snapshots.inc()
            self._g_log_base.set(self.log.base_index)

    def force_snapshot(self) -> int:
        """Take a snapshot now regardless of threshold (operator path /
        tests). Returns the snapshot index (0 = nothing applied yet)."""
        if self.snapshot_fn is None:
            raise RuntimeError("no snapshot_fn configured")
        with self._lock:
            while self._applying:  # FSM mid-batch: wait for a stable point
                self._commit_cv.wait(0.1)
            idx = self.last_applied
            if idx == 0:
                return 0
            term = self.log.term_at(idx)
            peers = {p: list(a) for p, a in self.peers.items()}
            # snapshot under the lock: the applier can't start a new
            # batch (needs the lock) so the FSM stays at exactly idx
            state = self.snapshot_fn()  # nomadlint: ok NLT05 lock pins the FSM at idx by design; snapshot_fn reads FSM state only, never re-enters raft
        snap = {"index": idx, "term": term, "peers": peers,
                "state": state}
        with self._lock:
            if self.log.base_index >= idx or (
                    self._snapshot is not None
                    and self._snapshot["index"] >= idx):
                return idx  # a newer snapshot landed meanwhile
            self._persist_snapshot(snap)
            self._snapshot = snap
            self.log.compact_to(idx, term)
        return idx

    def _rand_timeout(self) -> float:
        return random.uniform(*self.election_timeout)

    def _flight(self, type_: str, severity: str = "info",
                **detail) -> None:
        """Record a flight event attributed to this node. Consensus
        correctness must never depend on telemetry — swallow."""
        try:
            default_flight().record(type_, key=self.id, source=self.id,
                                    severity=severity, detail=detail)
        except Exception:  # noqa: BLE001 — telemetry only
            pass

    # ---- role transitions (hold lock) ----

    def _become_follower(self, term: int, leader: Optional[str]) -> None:
        was_leader = self.state == LEADER
        if term > self.term:
            self.term = term
            self.voted_for = None
            self._save_meta()
        self.state = FOLLOWER
        if leader is not None:
            self.leader_id = leader
        self._last_heard = time.monotonic()
        self._timeout = self._rand_timeout()
        self._g_term.set(self.term)
        self._g_state.set(_STATE_CODE[FOLLOWER])
        if was_leader:
            # Fail in-flight apply() futures — their entries may be
            # overwritten by the new leader; apply() re-checks term+commit.
            waiters, self._waiters = self._waiters, {}
            for ev in waiters.values():
                ev.set()
            self._ctr_lost.inc()
            self._flight("leadership.lost", severity="warn",
                         term=self.term, new_leader=leader or "")
            self._notify_leadership(False)

    def _become_leader(self) -> None:
        self.state = LEADER
        self.leader_id = self.id
        nxt = self.log.last_index() + 1
        self._next_index = {p: nxt for p in self.peers if p != self.id}
        self._match_index = {p: 0 for p in self.peers if p != self.id}
        self._g_state.set(_STATE_CODE[LEADER])
        self._ctr_gained.inc()
        self._flight("leadership.gained", term=self.term,
                     last_index=self.log.last_index())
        self._notify_leadership(True)

    def _notify_leadership(self, is_leader: bool) -> None:
        # Deliver from a single serialized queue so a rapid loss→regain
        # (or regain→loss) can't reach the callback out of order on
        # unordered daemon threads, leaving subsystems running as a
        # follower or stopped while leader.
        if self.on_leadership_change is None:
            return
        self._leadership_q.append(is_leader)
        with self._notify_lock:
            if self._notifier_running:
                return
            self._notifier_running = True
        threading.Thread(target=self._drain_leadership_q,
                         daemon=True).start()

    def _drain_leadership_q(self) -> None:
        while True:
            try:
                is_leader = self._leadership_q.popleft()
            except IndexError:
                with self._notify_lock:
                    if not self._leadership_q:
                        self._notifier_running = False
                        return
                continue
            try:
                self.on_leadership_change(is_leader)
            except Exception:
                # callback errors must not kill delivery, but a silently
                # stalled leader (no subsystems running) is undebuggable
                import traceback

                traceback.print_exc()

    # ---- public API ----

    def is_leader(self) -> bool:
        with self._lock:
            return self.state == LEADER

    def leader(self) -> Optional[str]:
        with self._lock:
            return self.leader_id

    def peers_snapshot(self, with_match: bool = False):
        """Consistent copy of the peer map (and optionally the leader's
        match indexes): the applier thread mutates both when a committed
        __raft_conf__ entry applies, so observers (autopilot health, the
        operator raft-configuration endpoint) must not iterate the live
        dicts."""
        with self._lock:
            peers = dict(self.peers)
            if with_match:
                return peers, dict(self._match_index)
            return peers

    def status(self) -> Dict[str, Any]:
        """One-shot consensus health view (the `operator debug` bundle's
        raft section; refreshes the log-size gauges as a side effect so
        a scrape right after stays consistent with the report)."""
        with self._lock:
            out = {
                "id": self.id,
                "state": self.state,
                "term": self.term,
                "leader": self.leader_id,
                "commit_index": self.commit_index,
                "last_applied": self.last_applied,
                "log_base_index": self.log.base_index,
                "log_last_index": self.log.last_index(),
                "snapshot_index": (self._snapshot or {}).get("index", 0),
                "peers": {p: list(a) for p, a in self.peers.items()},
                "match_index": dict(self._match_index),
            }
        out["log_bytes"] = self.log.disk_bytes()
        self.metrics.set_gauge("raft.log_bytes", out["log_bytes"])
        self._g_log_last.set(out["log_last_index"])
        self._g_log_base.set(out["log_base_index"])
        self.metrics.set_gauge("raft.peers", len(out["peers"]))
        return out

    def apply(self, data: Any, timeout: float = 10.0) -> int:
        """Leader-only: append, replicate, wait for commit. Returns the
        entry's log index (hashicorp/raft Apply future)."""
        t0 = time.perf_counter()
        with self._lock:
            if self.state != LEADER:
                raise NotLeaderError(self.leader_id)
            append_term = self.term
            idx = self.log.append(append_term, data)
            self._g_log_last.set(self.log.last_index())
            ev = threading.Event()
            self._waiters[idx] = ev
            # single-voter clusters reach majority on append alone
            self._advance_commit()
        self._replicate_all()
        if not ev.wait(timeout):
            with self._lock:
                self._waiters.pop(idx, None)
            raise TimeoutError("raft apply timed out (no quorum?)")
        # append → woken: quorum replication + commit advancement (the
        # leader-side serialization cost the plan pipeline rides on)
        self._m_commit_ms.add_sample((time.perf_counter() - t0) * 1e3)
        with self._lock:
            ok = (self.commit_index >= idx
                  and self.log.last_index() >= idx)
            if ok:
                if idx > self.log.base_index:
                    ok = self.log.term_at(idx) == append_term
                else:
                    # our entry was applied AND compacted before we woke:
                    # its term is gone, but entries can't be overwritten
                    # while leadership is continuously held — still being
                    # leader in the append term proves it was ours
                    ok = (self.state == LEADER
                          and self.term == append_term)
            if ok:
                return idx
        raise NotLeaderError(self.leader_id)  # lost leadership mid-apply

    def barrier(self, timeout: float = 10.0) -> None:
        """Commit a no-op to flush the pipeline (hashicorp/raft Barrier)."""
        self.apply({"op": "__noop__"}, timeout=timeout)

    # ---- membership changes (hashicorp/raft AddVoter/RemoveServer:
    # configuration changes ride the log so every replica applies them at
    # the same point in the entry stream) ----

    def remove_peer(self, peer_id: str, timeout: float = 10.0) -> None:
        """Leader-only: commit a config entry removing `peer_id` from the
        voter set. The removed server stops being counted for quorum once
        the entry applies. Note: the static peer map given at construction
        is what a restarted process comes back with — operators removing a
        server permanently must also drop it from the boot config."""
        if peer_id == self.id:
            raise ValueError("cannot remove the leader itself; "
                             "transfer leadership first")
        if peer_id not in self.peers:
            raise ValueError(f"unknown peer {peer_id!r}")
        self.apply({"op": "__raft_conf__",
                    "action": "remove", "id": peer_id}, timeout=timeout)

    def add_peer(self, peer_id: str, addr) -> None:
        """Leader-only: commit a config entry adding a voter."""
        self.apply({"op": "__raft_conf__", "action": "add",
                    "id": peer_id, "addr": list(addr)})

    #: optional callback fired after a committed config change applies
    #: locally: on_conf_change(action, peer_id, addr_or_None)
    on_conf_change = None

    def _apply_conf(self, data: Dict[str, Any]) -> None:
        action, peer_id = data.get("action"), data.get("id")
        with self._lock:
            if action == "remove":
                self.peers.pop(peer_id, None)
                self._match_index.pop(peer_id, None)
                self._next_index.pop(peer_id, None)
            elif action == "add":
                self.peers[peer_id] = tuple(data.get("addr") or ())
                self._next_index.setdefault(peer_id,
                                            self.log.last_index() + 1)
                self._match_index.setdefault(peer_id, 0)
        cb = self.on_conf_change
        if cb is not None:
            try:
                cb(action, peer_id, data.get("addr"))
            except Exception:  # noqa: BLE001 — observer must not kill raft
                import traceback

                traceback.print_exc()

    # ---- ticker ----

    def _run_ticker(self) -> None:
        while not self._stop.wait(self.heartbeat_interval / 2):
            with self._lock:
                state = self.state
                overdue = (time.monotonic() - self._last_heard
                           > self._timeout)
            if state == LEADER:
                self._replicate_all()
            elif overdue:
                self._run_election()

    # ---- election ----

    def _run_election(self) -> None:
        with self._lock:
            self.state = CANDIDATE
            self.term += 1
            self.voted_for = self.id
            self._save_meta()
            term = self.term
            self._last_heard = time.monotonic()
            self._timeout = self._rand_timeout()
            last_idx = self.log.last_index()
            last_term = self.log.term_at(last_idx)
            self._ctr_elections.inc()
            self._g_term.set(term)
            self._g_state.set(_STATE_CODE[CANDIDATE])
        self._flight("raft.term", term=term)
        votes = {self.id}
        vote_lock = threading.Lock()
        with self._lock:
            peers = list(self.peers.items())
        majority = len(peers) // 2 + 1
        done = threading.Event()

        def ask(peer_id: str, addr) -> None:
            try:
                res = self.pool.call(addr, "Raft.RequestVote", term, self.id,
                                     last_idx, last_term, timeout=1.0)
            except Exception:
                return
            with self._lock:
                if res["term"] > self.term:
                    self._become_follower(res["term"], None)
                    done.set()
                    return
                if (self.state != CANDIDATE or self.term != term
                        or not res["granted"]):
                    return
            with vote_lock:
                votes.add(peer_id)
                if len(votes) >= majority:
                    done.set()

        threads = []
        for pid, addr in peers:
            if pid == self.id:
                continue
            t = threading.Thread(target=ask, args=(pid, addr), daemon=True)
            t.start()
            threads.append(t)
        done.wait(self.election_timeout[0])
        with self._lock:
            if (self.state == CANDIDATE and self.term == term
                    and len(votes) >= majority):
                self._become_leader()
        if self.is_leader():
            self._replicate_all()

    def _handle_request_vote(self, term: int, candidate: str,
                             last_log_index: int, last_log_term: int) -> dict:
        with self._lock:
            if term > self.term:
                self._become_follower(term, None)
            granted = False
            if term == self.term and self.voted_for in (None, candidate):
                my_last = self.log.last_index()
                my_term = self.log.term_at(my_last)
                up_to_date = (last_log_term, last_log_index) >= (my_term,
                                                                 my_last)
                if up_to_date:
                    granted = True
                    self.voted_for = candidate
                    self._save_meta()
                    self._last_heard = time.monotonic()
            return {"term": self.term, "granted": granted}

    # ---- replication ----

    def _replicate_all(self) -> None:
        with self._lock:
            # snapshot: committed config changes mutate self.peers from
            # the applier thread
            peers = list(self.peers.items())
        for pid, addr in peers:
            if pid != self.id:
                threading.Thread(target=self._replicate_one,
                                 args=(pid, addr), daemon=True).start()

    def _replicate_one(self, peer_id: str, addr) -> None:
        snap_to_send = None
        with self._lock:
            if self.state != LEADER:
                return
            term = self.term
            next_idx = self._next_index.get(peer_id, 1)
            if next_idx <= self.log.base_index:
                # the entries this peer needs were compacted away: ship
                # the snapshot instead (InstallSnapshot, Raft §7)
                snap_to_send = self._snapshot
                if snap_to_send is None:
                    return
            else:
                prev_idx = next_idx - 1
                prev_term = self.log.term_at(prev_idx)
                entries = self.log.slice(next_idx)
                commit = self.commit_index
        if snap_to_send is not None:
            self._send_snapshot(peer_id, addr, term, snap_to_send)
            return
        t0 = time.perf_counter()
        try:
            res = self.pool.call(addr, "Raft.AppendEntries", term, self.id,
                                 prev_idx, prev_term, entries, commit,
                                 timeout=2.0)
        except Exception:
            return
        self._m_append_ms.add_sample((time.perf_counter() - t0) * 1e3)
        with self._lock:
            if res["term"] > self.term:
                self._become_follower(res["term"], None)
                return
            if self.state != LEADER or self.term != term:
                return
            if res["success"]:
                match = prev_idx + len(entries)
                if match > self._match_index.get(peer_id, 0):
                    self._match_index[peer_id] = match
                self._next_index[peer_id] = match + 1
                self._advance_commit()
                # follower commit-index lag: how far behind this peer's
                # replicated prefix is — the failover-risk gauge (a
                # laggy majority stretches commit latency; a laggy
                # minority is the InstallSnapshot candidate)
                self.metrics.set_gauge(
                    f"raft.lag.{peer_id}",
                    max(self.commit_index
                        - self._match_index.get(peer_id, 0), 0))
            else:
                # back off (conflict hint if provided)
                hint = res.get("conflict_index")
                self._next_index[peer_id] = max(
                    1, hint if hint else next_idx - 1)

    def _send_snapshot(self, peer_id: str, addr, term: int,
                       snap: Dict[str, Any]) -> None:
        """Leader → lagging follower: replace its FSM + log wholesale."""
        try:
            res = self.pool.call(addr, "Raft.InstallSnapshot", term,
                                 self.id, snap, timeout=10.0)
        except Exception:
            return
        with self._lock:
            if res["term"] > self.term:
                self._become_follower(res["term"], None)
                return
            if self.state != LEADER or self.term != term:
                return
            if res.get("success"):
                idx = snap["index"]
                if idx > self._match_index.get(peer_id, 0):
                    self._match_index[peer_id] = idx
                self._next_index[peer_id] = idx + 1
                self._advance_commit()

    def _handle_install_snapshot(self, term: int, leader: str,
                                 snap: Dict[str, Any]) -> dict:
        with self._lock:
            if term < self.term:
                return {"term": self.term, "success": False}
            self._become_follower(term, leader)
            if snap["index"] <= self.commit_index:
                # we already have (and may have applied) past this point
                return {"term": self.term, "success": True}
            # park the applier: it mutates the FSM outside the lock and
            # must not race the wholesale state swap
            while self._applying:
                self._commit_cv.wait(0.1)
            if snap["index"] <= self.commit_index:
                # went stale while we waited (concurrent AppendEntries
                # advanced commit): installing now would rewind the FSM
                # below last_applied and silently drop applied entries
                return {"term": self.term, "success": True}
            try:
                self._install_snapshot_locked(snap, persist=True)
            except Exception:  # noqa: BLE001 — a failed restore must not
                # kill the RPC thread; the leader will retry
                import traceback

                traceback.print_exc()
                return {"term": self.term, "success": False}
            self._ctr_installs.inc()
            return {"term": self.term, "success": True}

    def _advance_commit(self) -> None:
        """Majority-match rule, current-term restriction (§5.4.2)."""
        for n in range(self.log.last_index(), self.commit_index, -1):
            if self.log.term_at(n) != self.term:
                break
            count = 1 + sum(1 for m in self._match_index.values() if m >= n)
            if count >= len(self.peers) // 2 + 1:
                self.commit_index = n
                self._g_commit.set(n)
                self._commit_cv.notify_all()
                break

    def _handle_append_entries(self, term: int, leader: str, prev_idx: int,
                               prev_term: int, entries: List[dict],
                               leader_commit: int) -> dict:
        with self._lock:
            if term < self.term:
                return {"term": self.term, "success": False}
            self._become_follower(term, leader)
            if prev_idx > self.log.last_index():
                return {"term": self.term, "success": False,
                        "conflict_index": self.log.last_index() + 1}
            if prev_idx < self.log.base_index:
                # we compacted past prev (snapshot installed): everything
                # ≤ base is committed here; ask the leader to resend from
                # the first index we still hold
                return {"term": self.term, "success": False,
                        "conflict_index": self.log.base_index + 1}
            if prev_idx > 0 and self.log.term_at(prev_idx) != prev_term:
                # walk back past the conflicting term (§5.3 fast backup);
                # never below the compaction boundary — those terms are
                # gone (and everything ≤ base is committed anyway)
                t = self.log.term_at(prev_idx)
                i = prev_idx
                floor = max(1, self.log.base_index + 1)
                while i > floor and self.log.term_at(i - 1) == t:
                    i -= 1
                return {"term": self.term, "success": False,
                        "conflict_index": i}
            # append/overwrite
            idx = prev_idx
            for e in entries:
                idx += 1
                if idx <= self.log.last_index():
                    if self.log.term_at(idx) == e["term"]:
                        continue
                    self.log.truncate_from(idx)
                self.log.append(e["term"], e["data"])
            if leader_commit > self.commit_index:
                self.commit_index = min(leader_commit, self.log.last_index())
                self._g_commit.set(self.commit_index)
                self._commit_cv.notify_all()
            self._g_log_last.set(self.log.last_index())
            return {"term": self.term, "success": True}

    # ---- applier ----

    def _run_applier(self) -> None:
        while not self._stop.is_set():
            with self._commit_cv:
                while (self.last_applied >= self.commit_index
                       and not self._stop.is_set()):
                    self._commit_cv.wait(0.5)
                if self._stop.is_set():
                    return
                start = self.last_applied + 1
                end = self.commit_index
                base = self.log.base_index
                if start <= base:
                    # The journal was compacted past our applied point with
                    # no snapshot covering it (e.g. disk corruption): a
                    # negative offset here would silently feed the FSM the
                    # wrong entries. Fail loudly instead.
                    raise RuntimeError(
                        f"raft applier: last_applied={start - 1} < "
                        f"log base_index={base} with no covering snapshot")
                batch = [(i, self.log.entries[i - base - 1]["data"])
                         for i in range(start, end + 1)]
                self.last_applied = end
                waiters = [self._waiters.pop(i) for i in range(start, end + 1)
                           if i in self._waiters]
                self._applying = True  # FSM mutation outside the lock —
                # InstallSnapshot/force_snapshot park on this flag
            t0 = time.perf_counter()
            try:
                for _, data in batch:
                    if isinstance(data, dict) \
                            and data.get("op") == "__noop__":
                        continue
                    if isinstance(data, dict) \
                            and data.get("op") == "__raft_conf__":
                        self._apply_conf(data)
                        continue
                    try:
                        self.apply_fn(data)
                    except Exception:
                        import traceback

                        traceback.print_exc()
            finally:
                with self._commit_cv:
                    self._applying = False
                    self._commit_cv.notify_all()
            self._m_apply_ms.add_sample((time.perf_counter() - t0) * 1e3)
            self._g_applied.set(end)
            for ev in waiters:
                ev.set()
            self._maybe_take_snapshot()
