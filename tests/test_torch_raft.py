"""The port's RPC fabric and Raft: `nomad_tpu_torch.rpc`, `.raft`.

Twins of the reference's `tests/test_raft.py` (RPC round trips, a
three-node Raft cluster, log durability, compaction and InstallSnapshot),
`tests/test_transport.py` (teardown, remote errors, the pool, the trace
envelope), `TestRaftInstruments` of `tests/test_control_plane.py` and the
mTLS round trip of `tests/test_tls.py`, each run on the port's modules.
And the two packages on one wire: a port pool calls a reference server
and the other way round, and a Raft journal written by one package's
node is read back by the other's.
"""
import os
import socket
import threading
import time

import pytest

from nomad_tpu_torch.lib.flight import default_flight
from nomad_tpu_torch.lib.tracectx import (current as trace_current,
                                          default_spans, mint, use)
from nomad_tpu_torch.raft import NotLeaderError, RaftNode
from nomad_tpu_torch.rpc import ConnPool, RpcError, RpcServer
from nomad_tpu_torch.rpc.transport import (RpcClient, read_frame,
                                           write_frame)


def _wait(cond, timeout=10.0, every=0.02):
    dl = time.time() + timeout
    while time.time() < dl:
        if cond():
            return True
        time.sleep(every)
    return cond()


class TestRpc:
    def test_call_round_trip(self):
        srv = RpcServer()
        srv.register("Math.add", lambda a, b: a + b)
        srv.start()
        pool = ConnPool()
        try:
            assert pool.call(srv.addr, "Math.add", 2, 3) == 5
        finally:
            pool.close()
            srv.shutdown()

    def test_remote_error_propagates(self):
        srv = RpcServer()

        def boom():
            raise ValueError("nope")

        srv.register("X.boom", boom)
        srv.start()
        pool = ConnPool()
        try:
            with pytest.raises(RpcError, match="nope"):
                pool.call(srv.addr, "X.boom")
            with pytest.raises(RpcError, match="unknown method"):
                pool.call(srv.addr, "X.missing")
        finally:
            pool.close()
            srv.shutdown()

    def test_concurrent_pipelining(self):
        srv = RpcServer()

        def slow(x):
            time.sleep(0.2)
            return x

        srv.register("X.slow", slow)
        srv.register("X.fast", lambda x: x)
        srv.start()
        pool = ConnPool()
        try:
            out = {}
            t = threading.Thread(
                target=lambda: out.setdefault(
                    "slow", pool.call(srv.addr, "X.slow", 1)))
            t.start()
            time.sleep(0.05)
            t0 = time.time()
            assert pool.call(srv.addr, "X.fast", 2) == 2
            assert time.time() - t0 < 0.15  # not blocked behind slow
            t.join()
            assert out["slow"] == 1
        finally:
            pool.close()
            srv.shutdown()

    def test_pool_reconnects(self):
        srv = RpcServer()
        srv.register("X.f", lambda: "ok")
        srv.start()
        pool = ConnPool()
        try:
            assert pool.call(srv.addr, "X.f") == "ok"
            # kill the pooled connection behind the pool's back
            pool._conns[tuple(srv.addr)]._sock.close()
            time.sleep(0.05)
            assert pool.call(srv.addr, "X.f") == "ok"
        finally:
            pool.close()
            srv.shutdown()


class Cluster:
    """In-process N-node raft cluster on localhost."""

    def __init__(self, n=3, data_dirs=None):
        self.servers = [RpcServer() for _ in range(n)]
        self.ids = [f"n{i}" for i in range(n)]
        self.peers = {self.ids[i]: self.servers[i].addr for i in range(n)}
        self.applied = {i: [] for i in range(n)}
        self.pools = [ConnPool() for _ in range(n)]
        self.nodes = []
        for i in range(n):
            node = RaftNode(
                self.ids[i], self.peers, self.servers[i], self.pools[i],
                apply_fn=(lambda i: lambda d: self.applied[i].append(d))(i),
                data_dir=data_dirs[i] if data_dirs else None,
            )
            self.nodes.append(node)
        for s in self.servers:
            s.start()
        for nd in self.nodes:
            nd.start()

    def leader(self):
        for nd in self.nodes:
            if nd.is_leader():
                return nd
        return None

    def wait_leader(self, timeout=10.0):
        assert _wait(lambda: self.leader() is not None, timeout), \
            "no leader elected"
        return self.leader()

    def shutdown(self):
        for nd in self.nodes:
            nd.shutdown()
        for s in self.servers:
            s.shutdown()
        for p in self.pools:
            p.close()


@pytest.fixture()
def cluster():
    c = Cluster(3)
    yield c
    c.shutdown()


class TestRaft:
    def test_elects_single_leader(self, cluster):
        cluster.wait_leader()
        time.sleep(0.3)
        leaders = [nd for nd in cluster.nodes if nd.is_leader()]
        assert len(leaders) == 1
        # followers agree on the leader id
        lid = leaders[0].id
        assert _wait(lambda: all(nd.leader() == lid
                                 for nd in cluster.nodes))

    def test_replicates_entries_in_order(self, cluster):
        leader = cluster.wait_leader()
        for i in range(20):
            leader.apply({"op": "set", "k": i})
        want = [{"op": "set", "k": i} for i in range(20)]
        for i in range(3):
            assert _wait(lambda i=i: cluster.applied[i] == want), \
                f"node {i} diverged: {cluster.applied[i][:3]}..."

    def test_apply_on_follower_raises(self, cluster):
        leader = cluster.wait_leader()
        follower = next(nd for nd in cluster.nodes if nd is not leader)
        with pytest.raises(NotLeaderError):
            follower.apply({"x": 1})

    def test_leader_failover_preserves_log(self, cluster):
        leader = cluster.wait_leader()
        for i in range(5):
            leader.apply({"v": i})
        # kill the leader
        leader.shutdown()
        idx = cluster.nodes.index(leader)
        cluster.servers[idx].shutdown()
        new_leader = None

        def have_new():
            nonlocal new_leader
            for nd in cluster.nodes:
                if nd is not leader and nd.is_leader():
                    new_leader = nd
                    return True
            return False

        assert _wait(have_new, 10.0), "no new leader after failover"
        new_leader.apply({"v": 99})
        want = [{"v": i} for i in range(5)] + [{"v": 99}]
        for i, nd in enumerate(cluster.nodes):
            if nd is leader:
                continue
            assert _wait(lambda i=i: cluster.applied[i] == want), \
                f"node {i}: {cluster.applied[i]}"

    def test_restart_recovers_from_disk(self, tmp_path):
        dirs = [str(tmp_path / f"n{i}") for i in range(3)]
        c = Cluster(3, data_dirs=dirs)
        try:
            leader = c.wait_leader()
            for i in range(7):
                leader.apply({"v": i})
            terms = [nd.term for nd in c.nodes]
        finally:
            c.shutdown()
        time.sleep(0.1)
        c2 = Cluster(3, data_dirs=dirs)
        try:
            leader2 = c2.wait_leader()
            # persisted term never regresses
            assert leader2.term >= max(terms)
            # log recovered: committing one more applies all 8 in order
            leader2.apply({"v": 7})
            want = [{"v": i} for i in range(8)]
            li = c2.nodes.index(leader2)
            assert _wait(lambda: c2.applied[li] == want), c2.applied[li]
        finally:
            c2.shutdown()

    def test_barrier(self, cluster):
        leader = cluster.wait_leader()
        leader.apply({"v": 1})
        leader.barrier()
        li = cluster.nodes.index(leader)
        assert cluster.applied[li] == [{"v": 1}]  # noop filtered


class TestLogDurability:
    """A torn/corrupt journal tail must be truncated on
    load — otherwise post-crash appends land after undecodable bytes and
    acknowledged entries silently vanish on the next load, violating
    Raft's persisted-log safety assumption (mirrors Wal.load)."""

    def test_torn_tail_then_append_survives_reload(self, tmp_path):
        from nomad_tpu_torch.raft.raft import _Log

        path = str(tmp_path / "raft_log.mp")
        log = _Log(path)
        for i in range(3):
            log.append(1, {"v": i})
        log.close()
        data = open(path, "rb").read()
        with open(path, "wb") as fh:  # corrupt tail: undecodable bytes
            fh.write(data + b"\xc1\xc1\xc1")
        log2 = _Log(path)
        assert len(log2.entries) == 3
        log2.append(2, {"v": 3})  # acknowledged post-crash entry
        log2.close()
        log3 = _Log(path)
        assert [e["data"]["v"] for e in log3.entries] == [0, 1, 2, 3]

    def test_partial_final_frame_truncated(self, tmp_path):
        from nomad_tpu_torch.raft.raft import _Log

        path = str(tmp_path / "raft_log.mp")
        log = _Log(path)
        for i in range(4):
            log.append(1, {"v": i})
        log.close()
        data = open(path, "rb").read()
        with open(path, "wb") as fh:
            fh.write(data[:-2])  # torn write mid-frame
        log2 = _Log(path)
        assert len(log2.entries) == 3
        log2.append(1, {"v": 99})
        log2.close()
        log3 = _Log(path)
        assert [e["data"]["v"] for e in log3.entries] == [0, 1, 2, 99]

    def test_fsync_option_accepted(self, tmp_path):
        from nomad_tpu_torch.raft.raft import _Log

        path = str(tmp_path / "raft_log.mp")
        log = _Log(path, fsync=True)
        log.append(1, {"v": 0})
        log.close()
        assert len(_Log(path).entries) == 1

    def test_decodable_garbage_tail_truncated(self, tmp_path):
        """A tail byte that decodes as a VALID msgpack value (positive
        fixint) must still be truncated — clean_end may only advance past
        frames that validate as journal records."""
        from nomad_tpu_torch.raft.raft import _Log

        path = str(tmp_path / "raft_log.mp")
        log = _Log(path)
        for i in range(3):
            log.append(1, {"v": i})
        log.close()
        with open(path, "ab") as fh:
            fh.write(b"\x05")  # decodes as int 5 — not a record
        log2 = _Log(path)
        assert len(log2.entries) == 3
        log2.append(2, {"v": 3})  # acknowledged post-crash entry
        log2.close()
        log3 = _Log(path)
        assert [e["data"]["v"] for e in log3.entries] == [0, 1, 2, 3]


class SnapCluster:
    """Raft cluster where each node carries a KV FSM with snapshot/restore
    hooks — exercises log compaction + InstallSnapshot (Raft §7)."""

    def __init__(self, n=3, data_dirs=None, threshold=50, peers=None,
                 only=None):
        ids = [f"n{i}" for i in range(n)]
        self.ids = ids
        self.data_dirs = (dict(zip(ids, data_dirs))
                          if data_dirs else None)
        self.threshold = threshold
        self.servers = {}
        self.pools = {}
        self.nodes = {}
        self.fsm = {i: {} for i in ids}
        self.apply_count = {i: 0 for i in ids}
        if peers is None:
            # two-phase: bind first, then share the map
            for i in ids:
                self.servers[i] = RpcServer()
            self.peers = {i: self.servers[i].addr for i in ids}
        else:
            self.peers = dict(peers)
        for i in ids:
            if only is not None and i not in only:
                continue
            self._boot(i)

    def _boot(self, i):
        if i not in self.servers:
            # rebinding a just-freed port can transiently fail
            for _ in range(40):
                try:
                    self.servers[i] = RpcServer(port=self.peers[i][1])
                    break
                except OSError:
                    time.sleep(0.25)
            else:
                raise OSError(f"could not rebind {self.peers[i]}")
        srv = self.servers[i]
        self.pools[i] = ConnPool()
        fsm = self.fsm[i]

        def apply_fn(d, i=i, fsm=fsm):
            self.apply_count[i] += 1
            fsm[d["k"]] = d["v"]

        def restore_fn(blob, fsm=fsm):
            fsm.clear()
            fsm.update(blob)

        node = RaftNode(
            i, self.peers, srv, self.pools[i], apply_fn=apply_fn,
            data_dir=(self.data_dirs[i] if self.data_dirs else None),
            snapshot_fn=lambda fsm=fsm: dict(fsm),
            restore_fn=restore_fn,
            snapshot_threshold=self.threshold,
        )
        self.nodes[i] = node
        srv.start()
        node.start()
        return node

    def kill(self, i):
        self.nodes[i].shutdown()
        self.servers[i].shutdown()
        self.pools[i].close()
        del self.nodes[i], self.servers[i], self.pools[i]

    def restart(self, i):
        self.fsm[i].clear()
        self.apply_count[i] = 0
        return self._boot(i)

    def leader(self):
        for nd in self.nodes.values():
            if nd.is_leader():
                return nd
        return None

    def wait_leader(self, timeout=10.0):
        assert _wait(lambda: self.leader() is not None, timeout)
        return self.leader()

    def shutdown(self):
        for i in list(self.nodes):
            try:
                self.kill(i)
            except Exception:
                pass


class TestSnapshotCompaction:
    """Log compaction + InstallSnapshot (raft §7; reference FSM
    snapshot/restore nomad/fsm.go:1242,1256 + hashicorp/raft snapshot
    store with log truncation)."""

    def test_applier_compacts_past_threshold(self, tmp_path):
        c = SnapCluster(n=1, data_dirs=[str(tmp_path / "n0")],
                        threshold=20)
        try:
            leader = c.wait_leader()
            for i in range(55):
                leader.apply({"k": f"k{i}", "v": i})
            assert _wait(lambda: leader.log.base_index > 0)
            # in-memory suffix stays bounded near the threshold
            assert len(leader.log.entries) <= 25
            assert leader.commit_index == leader.log.last_index()
            # the on-disk journal was rewritten: smaller than the full
            # history would be
            import os as _os

            assert _os.path.exists(str(tmp_path / "n0" / "raft_snap.mp"))
        finally:
            c.shutdown()

    def test_restart_restores_from_snapshot_not_replay(self, tmp_path):
        dirs = [str(tmp_path / "n0")]
        c = SnapCluster(n=1, data_dirs=dirs, threshold=20)
        try:
            leader = c.wait_leader()
            for i in range(50):
                leader.apply({"k": f"k{i}", "v": i})
            assert _wait(lambda: leader.log.base_index > 0)
            base = leader.log.base_index
            want = dict(c.fsm["n0"])
            peers = dict(c.peers)
        finally:
            c.shutdown()
        time.sleep(0.1)
        c2 = SnapCluster(n=1, data_dirs=dirs, threshold=20, peers=peers)
        try:
            leader2 = c2.wait_leader()
            # FSM restored from the snapshot at boot (the suffix past the
            # snapshot point re-applies when the commit re-advances)
            assert len(c2.fsm["n0"]) >= base
            assert set(c2.fsm["n0"]).issubset(set(want))
            # ...and committing one more entry replays ONLY the suffix
            leader2.apply({"k": "post", "v": 1})
            want["post"] = 1
            assert _wait(lambda: c2.fsm["n0"] == want)
            assert c2.apply_count["n0"] <= (50 - base) + 1
        finally:
            c2.shutdown()

    def test_lagging_follower_catches_up_via_snapshot(self, tmp_path):
        """The durability bar: kill a follower, write
        1k entries, compact, restart the follower — it must catch up via
        InstallSnapshot, not full replay."""
        dirs = [str(tmp_path / f"n{i}") for i in range(3)]
        c = SnapCluster(n=3, data_dirs=dirs, threshold=100)
        try:
            leader = c.wait_leader()
            leader.apply({"k": "seed", "v": 0})
            follower_id = next(i for i in c.ids
                               if i != leader.id and i in c.nodes)
            c.kill(follower_id)
            for i in range(1000):
                leader.apply({"k": f"k{i}", "v": i})
            assert _wait(lambda: leader.log.base_index >= 500), \
                leader.log.base_index
            want = dict(c.fsm[leader.id])

            f = c.restart(follower_id)
            # wait on base_index too: restore_fn fires mid-install (before
            # the log reset stamps base_index), so fsm equality alone can
            # be observed in that window
            assert _wait(lambda: c.fsm[follower_id] == want
                         and f.log.base_index >= 500, timeout=60.0)
            # caught up via snapshot: the follower's log starts at the
            # snapshot point and it applied far fewer than 1001 entries
            assert f.log.base_index >= 500
            assert c.apply_count[follower_id] <= 1001 - f.log.base_index
        finally:
            c.shutdown()

    def test_fresh_follower_joins_via_snapshot(self, tmp_path):
        """A server added mid-life gets state in one transfer."""
        dirs = [str(tmp_path / f"n{i}") for i in range(3)]
        c = SnapCluster(n=3, data_dirs=dirs, threshold=50, only=["n0", "n1"])
        # n2 not started; not in anyone's initial peer map either
        for nd in c.nodes.values():
            nd.peers.pop("n2", None)
        try:
            leader = c.wait_leader()
            for i in range(200):
                leader.apply({"k": f"k{i}", "v": i})
            assert _wait(lambda: leader.log.base_index >= 100, timeout=30.0)
            want = dict(c.fsm[leader.id])
            # boot n2 with itself only; then the leader adds it
            new = c._boot("n2")
            new.peers = {"n2": c.peers["n2"]}
            leader = c.leader() or c.wait_leader()
            leader.add_peer("n2", c.peers["n2"])
            # wait on base_index too: restore_fn fires mid-install (before
            # the log reset stamps base_index), so fsm equality alone can
            # be observed in that window
            assert _wait(lambda: c.fsm["n2"] == want
                         and c.nodes["n2"].log.base_index >= 100,
                         timeout=60.0)
            assert c.nodes["n2"].log.base_index >= 100
            assert c.apply_count["n2"] <= 201 - c.nodes["n2"].log.base_index
        finally:
            c.shutdown()

    def test_install_persists_snapshot_before_truncating_log(self,
                                                             tmp_path):
        """Round-4 advisor (medium): InstallSnapshot must persist the
        snapshot file BEFORE rewriting the journal with the new
        base_index — the reverse order leaves, after a crash between the
        two, a journal whose base points past any durable snapshot, and
        the applier would then index before the log base. Simulate the
        crash by making the snapshot write fail: the journal must be
        untouched."""
        c = SnapCluster(n=1, data_dirs=[str(tmp_path / "n0")],
                        threshold=10_000)  # no auto-compaction
        try:
            leader = c.wait_leader()
            for i in range(5):
                leader.apply({"k": f"k{i}", "v": i})
            assert leader.log.base_index == 0
            snap = {"index": 4, "term": leader.log.term_at(4),
                    "peers": {}, "state": {"k0": 0}}

            def boom(_snap):
                raise OSError("disk full")

            leader._persist_snapshot = boom
            with leader._lock:
                with pytest.raises(OSError):
                    leader._install_snapshot_locked(snap, persist=True)
            # crash point: snapshot never became durable → the journal
            # must still start at 0 with every entry present
            assert leader.log.base_index == 0
            assert leader.log.last_index() >= 5
        finally:
            c.shutdown()

    def test_rejected_restore_never_persists_snapshot(self, tmp_path):
        """The flip side of the ordering: a snapshot the FSM's restore
        rejects must not become the durable boot state (it would brick
        the node at the next start)."""
        c = SnapCluster(n=1, data_dirs=[str(tmp_path / "n0")],
                        threshold=10_000)
        try:
            leader = c.wait_leader()
            for i in range(5):
                leader.apply({"k": f"k{i}", "v": i})
            snap = {"index": 4, "term": leader.log.term_at(4),
                    "peers": {}, "state": {"bad": "blob"}}

            def reject(_state):
                raise ValueError("unrecognized snapshot format")

            leader.restore_fn = reject
            with leader._lock:
                with pytest.raises(ValueError):
                    leader._install_snapshot_locked(snap, persist=True)
            assert not os.path.exists(
                str(tmp_path / "n0" / "raft_snap.mp"))
            assert leader.log.base_index == 0
        finally:
            c.shutdown()

    def test_snapshot_preserves_membership(self, tmp_path):
        """Conf entries compacted into the snapshot must survive an
        install — the voter map rides inside the snapshot."""
        c = SnapCluster(n=3, threshold=30)
        try:
            leader = c.wait_leader()
            for i in range(100):
                leader.apply({"k": f"k{i}", "v": i})
            assert _wait(lambda: leader.log.base_index > 0)
            snap = leader._snapshot
            assert snap is not None
            assert set(snap["peers"]) == set(c.ids)
        finally:
            c.shutdown()


@pytest.fixture()
def server():
    srv = RpcServer()
    gate = threading.Event()
    seen = {}

    def echo(*args):
        seen["ctx"] = trace_current()
        return list(args)

    def block():
        gate.wait(10.0)
        return "unblocked"

    def boom():
        raise ValueError("kaput")

    srv.register("Test.echo", echo)
    srv.register("Test.block", block)
    srv.register("Test.boom", boom)
    srv.start()
    yield srv, gate, seen
    gate.set()
    srv.shutdown()


class TestTeardownPromptness:
    def test_inflight_call_fails_promptly_on_close(self, server):
        """The headline bug: an in-flight call with timeout=None must
        raise as soon as close() runs, not hang forever."""
        srv, gate, _ = server
        c = RpcClient(*srv.addr)
        errs, done = [], threading.Event()

        def go():
            try:
                c.call("Test.block", timeout=None)
            except Exception as e:  # noqa: BLE001 — the error IS the test
                errs.append(e)
            done.set()

        threading.Thread(target=go, daemon=True).start()
        time.sleep(0.2)  # let the request hit the wire
        t0 = time.time()
        c.close()
        assert done.wait(3.0), "in-flight call hung past close()"
        assert time.time() - t0 < 2.0
        assert errs and isinstance(errs[0], ConnectionError)

    def test_call_on_closed_client_raises_immediately(self, server):
        srv, _, _ = server
        c = RpcClient(*srv.addr)
        c.close()
        t0 = time.time()
        with pytest.raises(ConnectionError):
            c.call("Test.echo", 1, timeout=None)
        assert time.time() - t0 < 1.0, \
            "closed-client call slept instead of failing fast"

    def test_close_racing_many_calls_hangs_nobody(self, server):
        """Teardown concurrent with a burst of calls: every caller gets
        an exception (never a hang), pending map drains to empty."""
        srv, _, _ = server
        c = RpcClient(*srv.addr)
        results = []

        def go():
            try:
                results.append(("ok", c.call("Test.block", timeout=None)))
            except Exception as e:  # noqa: BLE001
                results.append(("err", type(e).__name__))

        threads = [threading.Thread(target=go, daemon=True)
                   for _ in range(8)]
        for t in threads:
            t.start()
        time.sleep(0.15)
        c.close()
        for t in threads:
            t.join(3.0)
        assert not any(t.is_alive() for t in threads), "caller hung"
        assert len(results) == 8
        assert all(kind == "err" for kind, _ in results)
        assert c._pending == {}

    def test_peer_death_fails_waiters(self, server):
        """The wire dying under us (peer crash, network cut) must fail
        the in-flight call via the reader thread, not let it sleep out
        its timeout."""
        srv, _, _ = server
        c = RpcClient(*srv.addr)
        errs, done = [], threading.Event()

        def go():
            try:
                c.call("Test.block", timeout=None)
            except Exception as e:  # noqa: BLE001
                errs.append(e)
            done.set()

        threading.Thread(target=go, daemon=True).start()
        time.sleep(0.2)
        c._sock.shutdown(socket.SHUT_RDWR)  # cut the wire
        assert done.wait(3.0), "caller hung past peer death"
        assert errs and isinstance(errs[0], ConnectionError)
        c.close()


class TestRemoteErrors:
    def test_unknown_method_is_rpc_error(self, server):
        srv, _, _ = server
        c = RpcClient(*srv.addr)
        with pytest.raises(RpcError, match="unknown method"):
            c.call("Test.nope")
        c.close()

    def test_handler_exception_crosses_the_wire(self, server):
        srv, _, _ = server
        c = RpcClient(*srv.addr)
        with pytest.raises(RpcError, match="ValueError: kaput"):
            c.call("Test.boom")
        # the connection survives a handler error (pipelined, not fatal)
        assert c.call("Test.echo", "still-alive") == ["still-alive"]
        c.close()


class TestConnPool:
    def test_evicts_dead_client_and_redials(self, server):
        srv, _, _ = server
        pool = ConnPool()
        addr = tuple(srv.addr)
        assert pool.call(addr, "Test.echo", 1) == [1]
        first = pool._conns[addr]
        first.close()  # simulate the peer connection dying
        # next call must not be handed the corpse: evict + redial
        assert pool.call(addr, "Test.echo", 2) == [2]
        assert pool._conns[addr] is not first
        pool.close()

    def test_dead_server_single_redial_then_raises(self, server):
        """When the peer is gone for good, the pool makes exactly one
        reconnect attempt and then surfaces the error — it must not
        hand the caller the dead cached client, and must not retry
        forever either."""
        srv, _, _ = server
        pool = ConnPool()
        addr = tuple(srv.addr)
        assert pool.call(addr, "Test.echo", 1) == [1]
        srv.shutdown()
        pool._conns[addr].close()  # cached conn learns of the death
        with pytest.raises((ConnectionError, OSError)):
            pool.call(addr, "Test.echo", 2)
        pool.close()
        assert pool._conns == {}


class TestCtxEnvelope:
    def test_ctx_injected_and_restored_handler_side(self, server):
        srv, _, seen = server
        c = RpcClient(*srv.addr)
        with use(mint()):
            caller = trace_current()
            idx0 = default_spans().last_index()
            c.call("Test.echo", "x")
        got = seen["ctx"]
        assert got is not None
        assert got.trace_id == caller.trace_id
        # the handler runs under the HOP's context, a child of the
        # caller's span — a forwarding handler's own pool.call then
        # parents the next hop correctly with no extra plumbing
        assert got.parent_span_id == caller.span_id
        assert got.span_id != caller.span_id
        # the client recorded the hop as an rpc.forward span
        _, recs = default_spans().spans_after(idx0)
        fwd = [s for s in recs if s["name"] == "rpc.forward"
               and s["trace_id"] == caller.trace_id]
        assert len(fwd) == 1
        assert fwd[0]["span_id"] == got.span_id
        assert fwd[0]["detail"]["method"] == "Test.echo"
        assert fwd[0]["detail"]["peer"].endswith(str(srv.addr[1]))
        c.close()

    def test_no_ctx_outside_a_trace(self, server):
        srv, _, seen = server
        c = RpcClient(*srv.addr)
        idx0 = default_spans().last_index()
        c.call("Test.echo", "x")
        assert seen["ctx"] is None
        _, recs = default_spans().spans_after(idx0)
        assert [s for s in recs if s["name"] == "rpc.forward"] == []
        c.close()

    def test_kill_switch_suppresses_injection(self, server, monkeypatch):
        monkeypatch.setenv("NOMAD_TPU_TRACE", "0")
        srv, _, seen = server
        c = RpcClient(*srv.addr)
        idx0 = default_spans().last_index()
        with use(mint()):
            c.call("Test.echo", "x")
        assert seen["ctx"] is None
        _, recs = default_spans().spans_after(idx0)
        assert [s for s in recs if s["name"] == "rpc.forward"] == []
        c.close()

    def test_malformed_ctx_from_peer_is_tolerated(self, server):
        """A hand-rolled frame with a garbage ctx slot (old or hostile
        peer) must neither kill the serve loop nor poison the handler —
        it is simply no trace."""
        srv, _, seen = server
        for bad in ("garbage", 42, ["t"], {"t": 7, "s": None}, {}):
            s = socket.create_connection(srv.addr, timeout=5.0)
            try:
                write_frame(s, {"t": "req", "seq": 1,
                                "method": "Test.echo", "args": ["ping"],
                                "ctx": bad})
                res = read_frame(s)
            finally:
                s.close()
            assert res["ok"] is True and res["result"] == ["ping"]
            assert seen["ctx"] is None


class _StubRpc:
    """RaftNode only registers handlers on it (single-voter node)."""

    def register(self, name, fn):
        pass


class TestRaftInstruments:
    def test_single_voter_lifecycle_metrics_and_flight(self, tmp_path):
        from nomad_tpu_torch.raft import RaftNode

        idx0 = default_flight().last_index()
        applied = []
        node = RaftNode("r1", {"r1": ("127.0.0.1", 0)}, _StubRpc(),
                        pool=None, apply_fn=applied.append,
                        data_dir=str(tmp_path / "raft"))
        node.start()
        try:
            assert _wait(node.is_leader, timeout=10.0)
            for i in range(3):
                node.apply({"op": "x", "i": i})
            assert _wait(lambda: len(applied) == 3, timeout=10.0)
            snap = node.metrics.snapshot()
            ctrs, gauges = snap["counters"], snap["gauges"]
            hists = snap["histograms"]
            assert ctrs["raft.elections"] >= 1
            assert ctrs["raft.leadership_gained"] == 1
            assert gauges["raft.state"] == 2  # leader
            assert gauges["raft.term"] >= 1
            assert gauges["raft.commit_index"] == 3
            assert gauges["raft.last_applied"] == 3
            assert hists["raft.commit_ms"]["count"] == 3
            assert hists["raft.apply_ms"]["count"] >= 1
            st = node.status()
            assert st["state"] == "leader" and st["commit_index"] == 3
            assert st["log_bytes"] > 0  # journaled to disk
            # flight: the election is a leadership transition
            _, evs = default_flight().records_after(idx0)
            mine = [e for e in evs if e["source"] == "r1"]
            assert {"raft.term", "leadership.gained"} <= {
                e["type"] for e in mine}
        finally:
            node.shutdown()


@pytest.fixture()
def pki(tmp_path):
    # the mini-CA is built on pyca/cryptography; without the package the
    # TLS twin reads as SKIPPED, as the reference's does
    pytest.importorskip("cryptography")
    from nomad_tpu_torch.lib.tlsutil import generate_ca, issue_cert

    ca_cert, ca_key = generate_ca(str(tmp_path / "pki"))
    srv_cert, srv_key = issue_cert(str(tmp_path / "pki"), ca_cert, ca_key,
                                   "server.global.nomad", name="server")
    cli_cert, cli_key = issue_cert(str(tmp_path / "pki"), ca_cert, ca_key,
                                   "cli.global.nomad", name="cli")
    return {"ca": ca_cert, "ca_key": ca_key,
            "srv_cert": srv_cert, "srv_key": srv_key,
            "cli_cert": cli_cert, "cli_key": cli_key}


class TestRpcTls:
    def test_mtls_rpc_round_trip(self, pki):
        from nomad_tpu_torch.lib.tlsutil import TLSConfig

        tls = TLSConfig(enabled=True, ca_file=pki["ca"],
                        cert_file=pki["srv_cert"],
                        key_file=pki["srv_key"], verify_incoming=True)
        srv = RpcServer("127.0.0.1", 0, tls=tls)
        srv.register("Test.echo", lambda x: x)
        srv.start()
        try:
            cli_tls = TLSConfig(enabled=True, ca_file=pki["ca"],
                                cert_file=pki["cli_cert"],
                                key_file=pki["cli_key"])
            pool = ConnPool(tls=cli_tls)
            assert pool.call(srv.addr, "Test.echo", "hi") == "hi"

            # plaintext dial against the TLS fabric fails
            plain = ConnPool()
            with pytest.raises(Exception):
                plain.call(srv.addr, "Test.echo", "nope", timeout=3.0)
        finally:
            srv.shutdown()


# ---- the two packages on one wire ----

def _packages():
    from nomad_tpu.raft import raft as ref_raft
    from nomad_tpu.rpc import transport as ref_transport

    from nomad_tpu_torch.raft import raft as port_raft
    from nomad_tpu_torch.rpc import transport as port_transport

    return {"port": (port_transport, port_raft),
            "reference": (ref_transport, ref_raft)}


@pytest.mark.parametrize("server_pkg,client_pkg",
                         [("port", "reference"), ("reference", "port")])
def test_rpc_frames_cross_packages(server_pkg, client_pkg):
    pkgs = _packages()
    srv = pkgs[server_pkg][0].RpcServer()
    srv.register("Test.echo", lambda *a: list(a))
    srv.register("Test.boom", lambda: 1 / 0)
    srv.start()
    pool = pkgs[client_pkg][0].ConnPool()
    try:
        tree = {"b": b"\x00\xff", "f": 0.1, "n": None, "l": [1, "x", True]}
        assert pool.call(srv.addr, "Test.echo", tree, 7) == [tree, 7]
        with pytest.raises(pkgs[client_pkg][0].RpcError,
                           match="ZeroDivisionError"):
            pool.call(srv.addr, "Test.boom")
    finally:
        pool.close()
        srv.shutdown()


@pytest.mark.parametrize("writer,reader",
                         [("port", "reference"), ("reference", "port")])
def test_raft_journal_cross_packages(tmp_path, writer, reader):
    """A journal with a truncation and a compaction point, written by one
    package's log, loads into the other's with the same suffix."""
    pkgs = _packages()
    path = str(tmp_path / "raft_log.mp")
    log = pkgs[writer][1]._Log(path)
    for i in range(6):
        log.append(1 + i // 3, {"op": "upsert_node", "args": [{"i": i}]})
    log.compact_to(2, 1)
    log.truncate_from(6)
    log.close()
    back = pkgs[reader][1]._Log(path)
    assert (back.base_index, back.base_term) == (2, 1)
    assert [e["data"]["args"][0]["i"] for e in back.entries] == [2, 3, 4]
    assert [e["term"] for e in back.entries] == [1, 2, 2]
    back.close()
