"""The port's FSM (`nomad_tpu_torch/server/fsm.py`) against the reference's.

One seeded op log (`tests/torch_wire_cases.py`), journaled by the
reference's WAL as wire trees and touching every FSM op, ACL, CSI,
secret, namespace and quota ones included, is applied by both packages'
FSMs: the two stores give equal `state_fingerprint`s and equal
`events_fingerprint`s. A snapshot taken in either package restores into
the other with an equal fingerprint. An entry that raises is skipped the
same way by both `apply_resilient`s. Then twins of the reference's
`TestReplicaDeterminism` (`tests/test_control_plane.py`), run on the
port: replicas under skewed clocks and seeds agree, and the gate catches
a replica-local clock or an unseeded RNG.
"""
import pytest

from nomad_tpu.server.fsm import ALLOWED_OPS as REF_OPS
from torch_wire_cases import fingerprints, op_log, ops_of, replay

from nomad_tpu_torch import mock
from nomad_tpu_torch.server.fsm import ALLOWED_OPS

PKGS = ("port", "reference")


@pytest.fixture(scope="module")
def log(tmp_path_factory):
    return op_log(str(tmp_path_factory.mktemp("oplog")))


def test_the_log_covers_every_fsm_op(log):
    assert ALLOWED_OPS == REF_OPS
    assert ops_of(log) == ALLOWED_OPS


def test_port_fsm_replays_the_reference_log_equally(log):
    ref, port = replay("reference", log), replay("port", log)
    assert fingerprints("port", port) == fingerprints("reference", ref)
    # non-vacuous: both stores hold the log's tables and announced events
    assert len(port.nodes()) == 19 and len(port._allocs) == 30
    assert len(port.event_broker.buffered()) \
        == len(ref.event_broker.buffered()) > 0


def test_acl_ops_replay_into_the_ports_own_classes(log):
    from nomad_tpu_torch.acl.policy import Policy
    from nomad_tpu_torch.acl.tokens import ACLPolicy, ACLToken
    from nomad_tpu_torch.structs.codec import from_wire, to_wire

    state = replay("port", log)
    assert state.acl.bootstrapped
    assert [p.name for p in state.acl.policies()] == ["readonly"]
    assert sorted(t.accessor_id for t in state.acl.tokens()) \
        == ["acc-1", "acc-boot"]
    assert all(type(p) is ACLPolicy for p in state.acl.policies())
    assert all(type(t) is ACLToken for t in state.acl.tokens())
    acl = state.acl.resolve("sec-1")
    assert acl.allow_namespace_operation("default", "read-job")
    assert not acl.allow_namespace_operation("default", "submit-job")
    pol = state.acl._parse_cache.get("readonly")
    assert pol is None or type(pol) is Policy
    for t in state.acl.tokens():
        assert from_wire(to_wire(t)) == t


@pytest.mark.parametrize("src,dst", [("reference", "port"),
                                     ("port", "reference")])
def test_snapshot_restores_across_packages(log, src, dst):
    import nomad_tpu.server.fsm as ref_fsm
    import nomad_tpu.server.state as ref_state

    import nomad_tpu_torch.server.fsm as port_fsm
    import nomad_tpu_torch.server.state as port_state

    mods = {"port": (port_fsm, port_state),
            "reference": (ref_fsm, ref_state)}
    state = replay(src, log)
    blob = mods[src][0].snapshot_state(state)
    fresh = mods[dst][1].StateStore()
    mods[dst][0].restore_state(fresh, blob)
    assert mods[dst][0].state_fingerprint(fresh) \
        == mods[src][0].state_fingerprint(state)


def test_apply_path_mints_no_id(log, monkeypatch):
    """nomadlint's NLR02 reads `utils.fast_uuid` (os.urandom) as on the
    apply path, because `structs.evaluation.new_id` calls it. Replaying
    a log of every FSM op with fast_uuid raising shows that the apply
    never mints an id: replicated values carry theirs. Every binding of
    the function raises, and so does its generator, which a dataclass
    default factory bound at import also reaches."""
    import sys

    from nomad_tpu_torch import utils

    want = fingerprints("port", replay("port", log))

    def minted(*_a, **_k):
        raise AssertionError("the apply path minted an id")

    class _Rng:
        getrandbits = staticmethod(minted)

    bound = [m for name, m in list(sys.modules.items())
             if name.startswith("nomad_tpu_torch") and m is not None
             and getattr(m, "fast_uuid", None) is utils.fast_uuid]
    assert len(bound) > 3
    for m in bound:
        monkeypatch.setattr(m, "fast_uuid", minted)
    monkeypatch.setattr(utils, "_uuid_rng", _Rng())
    from nomad_tpu_torch.structs import Deployment, Evaluation

    for make in (Evaluation, Deployment):  # the patch bites where an id
        with pytest.raises(AssertionError, match="minted"):  # is minted
            make()
    assert fingerprints("port", replay("port", log)) == want


def test_a_raising_entry_is_skipped_alike(log):
    bad = {"op": "upsert_acl_token",
           "args": [{"__t": "ACLToken", "accessor_id": "x",
                     "secret_id": "y", "type": "bogus"}]}
    mixed = log[:10] + [bad] + log[10:]
    fps = {pkg: fingerprints(pkg, replay(pkg, mixed, resilient=True))
           for pkg in PKGS}
    assert fps["port"] == fps["reference"]
    assert fps["port"] == fingerprints("port", replay("port", log))


class TestReplicaDeterminism:
    """FSM.apply must be a pure function of the raft entry: identical
    logs produce identical canonical state fingerprints on every
    replica regardless of local clock/RNG state, and across a
    snapshot/restore round-trip. The divergence tests pin that the
    fingerprint gate CATCHES the pre-fix behaviors (apply-path
    `time.time()` / unseeded `random.Random()`) if reintroduced —
    nomadlint's NLR family ratchets the same invariant statically."""

    def _log(self):
        """An entry log exercising the burned-down paths: nodes, a
        job, a placed alloc, and blocked/follow-up evals whose
        timestamps were minted leader-side (`now` rides the entry)."""
        from nomad_tpu_torch.structs.codec import to_wire

        node_a, node_b = mock.node(), mock.node()
        job = mock.job()
        alloc = mock.alloc(job=job, node_id=node_a.id)
        ev = mock.eval_(job_id=job.id)
        blocked = ev.create_blocked_eval({}, True, "", now=1723.5)
        follow = ev.create_failed_follow_up_eval(30.0, now=1723.5)
        entries = [
            ("upsert_node", [node_a]), ("upsert_node", [node_b]),
            ("upsert_job", [job]), ("upsert_eval", [ev]),
            ("upsert_alloc", [alloc]), ("upsert_eval", [blocked]),
            ("upsert_eval", [follow]), ("delete_node", [node_b.id]),
        ]
        return [{"op": op, "args": [to_wire(a) for a in args]}
                for op, args in entries]

    def _replay(self, log, clock, seed, store_cls=None):
        """Apply `log` on a fresh store under a SKEWED local clock and
        RNG — a deterministic FSM must not notice either."""
        import random as _random
        from unittest import mock as um

        from nomad_tpu_torch.server.event_broker import ClusterEventBroker
        from nomad_tpu_torch.server.fsm import FSM, state_fingerprint
        from nomad_tpu_torch.server.state import StateStore

        state = (store_cls or StateStore)()
        # every replica derives its event stream from the same entries
        # — the broker rides every replay so the event-payload
        # fingerprint is checked under the same skew
        state.event_broker = ClusterEventBroker()
        fsm = FSM(state)
        _random.seed(seed)
        with um.patch("time.time", lambda: clock):
            for entry in log:
                fsm.apply(entry)
        return state, state_fingerprint(state)

    def test_three_replicas_fingerprint_identical(self):
        log = self._log()
        fps = [self._replay(log, clock, seed)[1]
               for clock, seed in ((1.0e9, 1), (2.0e9, 2), (3.0e9, 3))]
        assert fps[0] == fps[1] == fps[2]

    def test_snapshot_restore_round_trip_fingerprints_equal(self):
        from nomad_tpu_torch.server.fsm import (restore_state, snapshot_state,
                                          state_fingerprint)
        from nomad_tpu_torch.server.state import StateStore

        state, fp = self._replay(self._log(), 5.0e9, 7)
        fresh = StateStore()
        restore_state(fresh, snapshot_state(state))
        assert state_fingerprint(fresh) == fp

    def test_gate_catches_replica_local_clock(self):
        """Reintroducing the pre-fix eval-timestamp shape (apply-path
        time.time()) MUST diverge the fingerprints — this is the test
        that fails if someone undoes the leader-side mint."""
        import time as _time

        from nomad_tpu_torch.server.state import StateStore

        class PreFixClockStore(StateStore):
            def upsert_eval(self, e):
                e.create_time = _time.time()  # the pre-fix shape
                super().upsert_eval(e)

        log = self._log()
        _, fp1 = self._replay(log, 1.0e9, 1, store_cls=PreFixClockStore)
        _, fp2 = self._replay(log, 2.0e9, 1, store_cls=PreFixClockStore)
        assert fp1 != fp2, \
            "fingerprint gate is blind to apply-path wall-clock reads"

    def test_gate_catches_unseeded_rng(self):
        """Reintroducing per-replica entropy (the pre-fix port-RNG
        shape: zero-arg random.Random() on the apply path) MUST
        diverge the fingerprints."""
        import random as _random

        from nomad_tpu_torch.server.state import StateStore

        class PreFixRngStore(StateStore):
            def upsert_alloc(self, a):
                a.client_description = str(
                    _random.Random().random())  # OS-entropy seeded
                super().upsert_alloc(a)

        log = self._log()
        _, fp1 = self._replay(log, 1.0e9, 1, store_cls=PreFixRngStore)
        _, fp2 = self._replay(log, 1.0e9, 1, store_cls=PreFixRngStore)
        assert fp1 != fp2, \
            "fingerprint gate is blind to apply-path entropy"

    def test_replica_event_payloads_byte_identical(self):
        """The event stream is FSM-sourced, so
        every replica derives BYTE-IDENTICAL event payloads from the
        same entries — same indexes, same order, same trees — under
        skewed local clock and RNG."""
        from nomad_tpu_torch.server.event_broker import events_fingerprint

        log = self._log()
        replays = [self._replay(log, clock, seed)[0]
                   for clock, seed in ((1.0e9, 1), (2.0e9, 2),
                                       (3.0e9, 3))]
        fps = [events_fingerprint(s.event_broker.buffered())
               for s in replays]
        assert fps[0] == fps[1] == fps[2]
        # non-vacuous: the log actually announced typed events with
        # raft-apply indexes
        evs = replays[0].event_broker.buffered()
        assert {e.topic for e in evs} >= {"Node", "Job", "Eval",
                                          "Alloc"}
        assert all(e.index > 0 for e in evs)
        assert [e.index for e in evs] == sorted(e.index for e in evs)

    def test_event_fingerprint_identical_across_store_variants(
            self, tmp_path):
        """The in-memory and WAL-journaling stores announce the same
        entries identically — the emission hook lives in the shared
        mutators, not in any one store subclass."""
        from nomad_tpu_torch.server.event_broker import events_fingerprint
        from nomad_tpu_torch.server.wal import DurableStateStore, Wal

        log = self._log()
        mem, _ = self._replay(log, 1.0e9, 1)

        def durable():
            return DurableStateStore(Wal(str(tmp_path / "w")))

        dur, _ = self._replay(log, 2.0e9, 2, store_cls=durable)
        assert events_fingerprint(mem.event_broker.buffered()) \
            == events_fingerprint(dur.event_broker.buffered())

    def test_blocked_eval_timestamps_ride_the_entry(self):
        ev = mock.eval_()
        blocked = ev.create_blocked_eval({}, False, "", now=123.25)
        assert blocked.create_time == blocked.modify_time == 123.25
        follow = ev.create_failed_follow_up_eval(10.0, now=123.25)
        assert follow.wait_until == 133.25
        assert follow.create_time == follow.modify_time == 123.25

    def test_stochastic_ports_require_caller_seeded_rng(self):
        """assign_network(deterministic=False) without an rng is the
        pre-fix divergence shape — it must refuse; with the SAME seed
        two replicas draw the SAME ports."""
        import random as _random

        from nomad_tpu_torch.structs.network import NetworkIndex
        from nomad_tpu_torch.structs.resources import NetworkResource, Port

        ask = NetworkResource(mbits=10,
                              dynamic_ports=[Port(label="http"),
                                             Port(label="rpc")])

        def draw(rng):
            idx = NetworkIndex()
            idx.set_node(mock.node())
            offer, err = idx.assign_network(ask, deterministic=False,
                                            rng=rng)
            assert err == ""
            return [p.value for p in offer.dynamic_ports]

        idx = NetworkIndex()
        idx.set_node(mock.node())
        with pytest.raises(ValueError):
            idx.assign_network(ask, deterministic=False)
        assert draw(_random.Random(42)) == draw(_random.Random(42))
