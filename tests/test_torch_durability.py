"""The port's durable server: `nomad_tpu_torch/server/wal.py`,
`lib/journal.py` and `Server(ServerConfig(data_dir=...), device="cpu")`.

Twins of the reference's `tests/test_durability.py` (codec round trips,
the WAL's torn tails and rotation, a server's checkpoint and resume) and
`TestWalInstruments` (`tests/test_control_plane.py`), run on the port.
Then the repaired codec registry: every ACL class round-trips through the
port's codec, and a reference tree decodes into the port's class. And the
two packages on one disk: the reference's op log journaled by a port
`DurableStateStore` replays to the reference's fingerprint, and a
`data_dir` written by either package's `Server` restores into the other's
with an equal fingerprint and goes on scheduling.
"""
import os

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.lib.metrics import MetricsRegistry
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.wal import DurableStateStore, Wal
from nomad_tpu_torch.structs import Evaluation
from nomad_tpu_torch.structs.codec import from_wire, to_wire
from nomad_tpu_torch.structs.node import DrainStrategy


class TestCodec:
    def test_node_round_trip(self):
        n = mock.node()
        n.drain = DrainStrategy(deadline_s=5.0, ignore_system_jobs=True)
        out = from_wire(to_wire(n))
        assert out == n and out is not n

    def test_job_round_trip(self):
        from nomad_tpu_torch.structs.job import (MigrateStrategy,
                                                 PeriodicConfig)

        j = mock.job()
        j.periodic = PeriodicConfig(spec="*/5 * * * *")
        j.task_groups[0].migrate_strategy = MigrateStrategy(max_parallel=2)
        j.meta["team"] = "infra"
        assert from_wire(to_wire(j)) == j

    def test_alloc_with_embedded_job(self):
        a = mock.alloc()
        out = from_wire(to_wire(a))
        assert out == a
        assert out.job == a.job

    def test_eval_and_deployment(self):
        e = Evaluation(id="e1", namespace="default", job_id="j",
                       type="service", priority=70, status="blocked",
                       wait_until=123.5)
        assert from_wire(to_wire(e)) == e
        from nomad_tpu_torch.structs.deployment import new_deployment

        d = new_deployment(mock.job())
        assert from_wire(to_wire(d)) == d

    def test_msgpack_safe(self):
        import msgpack

        j = mock.job()
        j.payload = b"\x00\x01binary"
        packed = msgpack.packb(to_wire(j), use_bin_type=True)
        out = from_wire(msgpack.unpackb(packed, raw=False,
                                        strict_map_key=False))
        assert out == j


class TestWal:
    def test_append_load(self, tmp_path):
        w = Wal(str(tmp_path))
        w.append("upsert_node", [to_wire(mock.node())])
        w.append("delete_node", ["abc"])
        w.close()
        w2 = Wal(str(tmp_path))
        snap, entries = w2.load()
        assert snap is None
        assert [e["op"] for e in entries] == ["upsert_node", "delete_node"]
        assert w2.seq == 2

    def test_torn_tail_recovery(self, tmp_path):
        w = Wal(str(tmp_path))
        w.append("delete_node", ["a"])
        w.append("delete_node", ["b"])
        w.close()
        path = os.path.join(str(tmp_path), "wal.log")
        data = open(path, "rb").read()
        open(path, "wb").write(data[:-3])  # torn final frame
        _, entries = Wal(str(tmp_path)).load()
        assert [e["args"][0] for e in entries] == ["a"]

    def test_torn_tail_then_append_survives_second_restart(self, tmp_path):
        w = Wal(str(tmp_path))
        w.append("delete_node", ["a"])
        w.append("delete_node", ["b"])
        w.close()
        path = os.path.join(str(tmp_path), "wal.log")
        data = open(path, "rb").read()
        open(path, "wb").write(data[:-3])  # crash mid-append
        w2 = Wal(str(tmp_path))
        _, entries = w2.load()  # truncates the torn frame
        assert len(entries) == 1
        w2.append("delete_node", ["c"])
        w2.close()
        _, entries = Wal(str(tmp_path)).load()
        assert [e["args"][0] for e in entries] == ["a", "c"]

    def test_snapshot_rotation(self, tmp_path):
        store = DurableStateStore(Wal(str(tmp_path)), snapshot_threshold=5)
        for i in range(7):
            store.upsert_node(mock.node())
        # threshold crossed → snapshot written, log truncated
        assert os.path.exists(os.path.join(str(tmp_path), "snapshot.mp"))
        store2 = DurableStateStore(Wal(str(tmp_path)))
        store2.restore()
        assert len(store2.nodes()) == 7
        assert store2.index.value == store.index.value


class TestServerResume:
    def _mk(self, tmp_path, **kw):
        s = Server(ServerConfig(num_schedulers=1, heartbeat_ttl=60.0,
                                data_dir=str(tmp_path), **kw),
                   device="cpu")
        s.start()
        return s

    def test_full_checkpoint_resume(self, tmp_path):
        s1 = self._mk(tmp_path)
        try:
            for _ in range(3):
                s1.node_register(mock.node())
            job = mock.job()
            job.task_groups[0].count = 4
            ev = s1.job_register(job)
            done = s1.wait_for_eval(ev.id)
            assert done.status == "complete"
            allocs1 = sorted(a.id for a in
                             s1.state.allocs_by_job("default", job.id))
            assert len(allocs1) == 4
            idx1 = s1.state.index.value
        finally:
            s1.shutdown()

        s2 = self._mk(tmp_path)
        try:
            assert len(s2.state.nodes()) == 3
            assert s2.state.job_by_id("default", job.id) is not None
            allocs2 = sorted(a.id for a in
                             s2.state.allocs_by_job("default", job.id))
            assert allocs2 == allocs1
            assert s2.state.index.value == idx1
            # cluster tensors rebuilt: a new job can still be placed
            job2 = mock.job()
            ev2 = s2.job_register(job2)
            done2 = s2.wait_for_eval(ev2.id)
            assert done2.status == "complete"
        finally:
            s2.shutdown()

    def test_pending_evals_requeued_on_restart(self, tmp_path):
        s1 = self._mk(tmp_path)
        try:
            # No nodes: eval completes but leaves a blocked eval; ALSO park a
            # pending eval directly in state to model a crash before dequeue.
            job = mock.job()
            ev = s1.job_register(job)
            s1.wait_for_eval(ev.id)
            assert s1.blocked.blocked_count() == 1
            parked = Evaluation(id="parked", namespace="default",
                                job_id=job.id, type="service",
                                priority=50, status="pending",
                                triggered_by="job-register")
            s1.state.upsert_eval(parked)
        finally:
            s1.shutdown()

        s2 = self._mk(tmp_path)
        try:
            # blocked eval restored into the blocked tracker
            assert s2.blocked.blocked_count() >= 1
            # the parked pending eval was re-enqueued and processed
            done = s2.wait_for_eval("parked", timeout=5.0)
            assert done is not None and done.status in ("complete", "blocked")
        finally:
            s2.shutdown()

    def test_operator_snapshot_save(self, tmp_path):
        s1 = self._mk(tmp_path)
        try:
            s1.node_register(mock.node())
            s1.snapshot_save()
            assert os.path.exists(os.path.join(str(tmp_path), "snapshot.mp"))
            # log truncated; state restorable from snapshot alone
        finally:
            s1.shutdown()
        s2 = self._mk(tmp_path)
        try:
            assert len(s2.state.nodes()) == 1
        finally:
            s2.shutdown()


def test_wal_decodable_garbage_tail_truncated(tmp_path):
    """Same defect class as the raft journal: garbage that decodes as a
    valid non-dict msgpack value must be truncated, not kept."""
    from nomad_tpu_torch.server.wal import Wal

    w = Wal(str(tmp_path))
    for i in range(3):
        w.append("op", [i])
    w.close()
    path = str(tmp_path / "wal.log")
    with open(path, "ab") as fh:
        fh.write(b"\x05")
    w2 = Wal(str(tmp_path))
    _, entries = w2.load()
    assert len(entries) == 3
    w2.append("op", [3])
    w2.close()
    w3 = Wal(str(tmp_path))
    _, entries = w3.load()
    assert [e["args"][0] for e in entries] == [0, 1, 2, 3]


class TestNewTablesDurability:
    """Namespaces, quotas, secrets, and service registrations ride the
    same WAL/snapshot machinery as the core tables — a restart must
    bring every one of them back (fsm.py snapshot_state/restore_state
    + ALLOWED_OPS journaling)."""

    def _mk(self, tmp_path):
        from nomad_tpu_torch.server import Server, ServerConfig

        s = Server(ServerConfig(num_schedulers=1, heartbeat_ttl=60.0,
                                gc_interval=3600.0,
                                data_dir=str(tmp_path / "d")),
                   device="cpu")
        s.start()
        return s

    def test_round3_tables_survive_restart(self, tmp_path):
        from nomad_tpu_torch.structs.operator import (AutopilotConfig,
                                                Namespace, QuotaSpec)
        from nomad_tpu_torch.structs.secrets import SecretEntry
        from nomad_tpu_torch.structs.service import ServiceRegistration

        s1 = self._mk(tmp_path)
        try:
            s1.quota_upsert(QuotaSpec(name="q", cpu=5000, memory_mb=4096))
            s1.namespace_upsert(Namespace(name="team-a", quota="q",
                                          description="desc"))
            s1.secret_upsert(SecretEntry(namespace="team-a",
                                         path="db/creds",
                                         data={"pass": "x"}))
            s1.state.upsert_service_registrations([ServiceRegistration(
                id="r1", service_name="svc", alloc_id="a1", port=8080)])
            reg_indexes = [(r.create_index, r.modify_index)
                           for r in s1.state.services_by_name(
                               "default", "svc")]
            s1.state.set_autopilot_config(
                AutopilotConfig(cleanup_dead_servers=False,
                                max_trailing_logs=999))
        finally:
            s1.shutdown()

        s2 = self._mk(tmp_path)
        try:
            assert [n.name for n in s2.state.namespaces()] \
                == ["default", "team-a"]
            ns = s2.state.namespace_by_name("team-a")
            assert ns.quota == "q" and ns.description == "desc"
            q = s2.state.quota_by_name("q")
            assert q.cpu == 5000 and q.memory_mb == 4096
            sec = s2.state.secret_get("team-a", "db/creds")
            assert sec.data == {"pass": "x"} and sec.version == 1
            regs = s2.state.services_by_name("default", "svc")
            assert len(regs) == 1 and regs[0].port == 8080
            # restore must preserve the persisted indexes on the STORED
            # row (the upsert keeps a copy: re-stamping only the local
            # object would lose them)
            assert [(r.create_index, r.modify_index) for r in regs] \
                == reg_indexes
            assert s2.state.autopilot_config().max_trailing_logs == 999
            assert s2.state.autopilot_config().cleanup_dead_servers \
                is False
            # enforcement still live post-restore
            import pytest as _pytest

            from nomad_tpu_torch import mock

            big = mock.job(namespace="team-a")
            big.task_groups[0].count = 100
            big.task_groups[0].tasks[0].resources.cpu = 500
            with _pytest.raises(ValueError, match="quota"):
                s2.job_register(big)
        finally:
            s2.shutdown()


class TestWalInstruments:
    def test_append_snapshot_accounting(self, tmp_path):
        from nomad_tpu_torch.server.wal import Wal

        reg = MetricsRegistry()
        wal = Wal(str(tmp_path / "wal"), fsync=True, metrics=reg)
        for i in range(5):
            wal.append("upsert_node", [{"i": i}])
        snap = reg.snapshot()
        assert snap["counters"]["wal.appends"] == 5
        assert snap["histograms"]["wal.append_ms"]["count"] == 5
        assert snap["histograms"]["wal.fsync_ms"]["count"] == 5
        assert snap["gauges"]["wal.log_bytes"] > 0
        wal.write_snapshot({"state": "tree"})
        snap = reg.snapshot()
        assert snap["counters"]["wal.snapshots"] == 1
        assert snap["histograms"]["wal.snapshot_ms"]["count"] == 1
        assert snap["gauges"]["wal.log_bytes"] == 0  # rotated
        assert snap["gauges"]["wal.snapshot_bytes"] > 0
        st = wal.status()
        assert st["seq"] == 5 and st["appends"] == 5 \
            and st["snapshots"] == 1
        wal.close()

    def test_existing_log_size_loaded(self, tmp_path):
        from nomad_tpu_torch.server.wal import Wal

        d = str(tmp_path / "wal")
        w1 = Wal(d)
        w1.append("upsert_node", [{}])
        w1.close()
        reg = MetricsRegistry()
        w2 = Wal(d, metrics=reg)
        assert reg.snapshot()["gauges"]["wal.log_bytes"] > 0
        w2.close()


# ---- the repaired codec registry (the ACL classes) ----

def _acl_objects(pkg):
    """One of each ACL class of `pkg`, with every field set."""
    policy_mod = __import__(f"{pkg}.acl.policy", fromlist=["Policy"])
    tokens_mod = __import__(f"{pkg}.acl.tokens", fromlist=["ACLToken"])
    ns = policy_mod.NamespaceRule(name="team-a", policy="write",
                                  capabilities=["submit-job", "read-job"])
    hv = policy_mod.HostVolumeRule(name="scratch", policy="read")
    return [
        ns, hv,
        policy_mod.Policy(namespaces=[ns], host_volumes=[hv], node="read",
                          agent="write", operator="read", quota="read",
                          plugin="list"),
        tokens_mod.ACLToken(accessor_id="acc", secret_id="sec", name="t",
                            type="client", policies=["p1", "p2"],
                            global_=True, create_time=1723.5),
        tokens_mod.ACLPolicy(name="p1", description="d",
                             rules='namespace "default" { policy = "read" }'),
    ]


@pytest.mark.parametrize("idx", range(5))
def test_acl_classes_round_trip_through_the_port_codec(idx):
    obj = _acl_objects("nomad_tpu_torch")[idx]
    out = from_wire(to_wire(obj))
    assert type(out) is type(obj) and out == obj and out is not obj


@pytest.mark.parametrize("idx", range(5))
def test_reference_acl_trees_decode_into_port_classes(idx):
    from nomad_tpu.structs.codec import to_wire as ref_to_wire

    ref = _acl_objects("nomad_tpu")[idx]
    port = _acl_objects("nomad_tpu_torch")[idx]
    out = from_wire(ref_to_wire(ref))
    assert type(out) is type(port) and out == port
    assert to_wire(out) == ref_to_wire(ref)


# ---- the two packages on one disk ----

def test_reference_log_journals_and_replays_through_the_port_wal(tmp_path):
    """Every op of the reference's log, ACL ones included, applied to a
    port `DurableStateStore` is journaled by the port's WAL; a restart
    replays it to the reference's fingerprint."""
    from torch_wire_cases import fingerprints, op_log, replay

    from nomad_tpu_torch.server.fsm import FSM, state_fingerprint

    log = op_log(str(tmp_path / "ref"))
    want = fingerprints("reference", replay("reference", log))[0]
    d = str(tmp_path / "port")
    store = DurableStateStore(Wal(d), snapshot_threshold=1 << 30)
    fsm = FSM(store)
    for entry in log:
        fsm.apply(entry)
    assert state_fingerprint(store) == want
    store.wal.close()
    _, entries = Wal(d).load()
    assert [e["op"] for e in entries] == [e["op"] for e in log]
    again = DurableStateStore(Wal(d))
    again.restore()
    assert state_fingerprint(again) == want
    assert again.acl.bootstrapped
    again.wal.close()


def _server_mod(pkg):
    return __import__(f"{pkg}.server", fromlist=["Server"])


def _start(pkg, data_dir):
    mod = _server_mod(pkg)
    kw = {"device": "cpu"} if pkg == "nomad_tpu_torch" else {}
    s = mod.Server(mod.ServerConfig(num_schedulers=1, heartbeat_ttl=60.0,
                                    gc_interval=3600.0, data_dir=data_dir,
                                    snapshot_threshold=10), **kw)
    s.start()
    return s


def _fingerprint(pkg, state):
    return __import__(f"{pkg}.server.fsm",
                      fromlist=["state_fingerprint"]).state_fingerprint(state)


@pytest.mark.parametrize("writer,reader", [
    ("nomad_tpu", "nomad_tpu_torch"), ("nomad_tpu_torch", "nomad_tpu")])
def test_data_dir_restores_across_packages(tmp_path, writer, reader):
    """A server of one package schedules, journals past a snapshot
    rotation and shuts down; a server of the other restores the same
    directory to an equal fingerprint, with its ACL tables, and places a
    new job on the restored nodes."""
    wmock = __import__(f"{writer}.mock", fromlist=["node"])
    rmock = __import__(f"{reader}.mock", fromlist=["node"])
    tokens = __import__(f"{writer}.acl.tokens", fromlist=["ACLToken"])
    d = str(tmp_path / "data")
    s1 = _start(writer, d)
    try:
        for _ in range(4):
            s1.node_register(wmock.node())
        s1.state.upsert_acl_policy(tokens.ACLPolicy(
            name="readonly", rules='namespace "default" { policy = "read" }'))
        s1.state.upsert_acl_token(tokens.ACLToken(
            accessor_id="acc", secret_id="sec", name="reader",
            policies=["readonly"], create_time=1723.5))
        for count in (3, 2):
            job = wmock.job()
            job.task_groups[0].count = count
            done = s1.wait_for_eval(s1.job_register(job).id)
            assert done.status == "complete"
        # past one rotation: the directory holds a snapshot and a tail
        assert s1.state.wal.status()["snapshots"] >= 1
        fp = _fingerprint(writer, s1.state)
        n_allocs = len(s1.state._allocs)
    finally:
        s1.shutdown()
    assert os.path.exists(os.path.join(d, "snapshot.mp"))

    s2 = _start(reader, d)
    try:
        assert _fingerprint(reader, s2.state) == fp
        assert len(s2.state._allocs) == n_allocs == 5
        assert [t.accessor_id for t in s2.state.acl.tokens()] == ["acc"]
        job = rmock.job()
        job.task_groups[0].count = 2
        done = s2.wait_for_eval(s2.job_register(job).id)
        assert done.status == "complete"
        assert len(s2.state.allocs_by_job("default", job.id)) == 2
    finally:
        s2.shutdown()
