"""The port's node TTL heartbeats: `nomad_tpu_torch/server/heartbeat.py`.

The port keeps every node's timer in one deadline heap served by one
thread, where the reference starts a `threading.Timer` thread a node.
Held here to the reference's `HeartbeatTracker` on the same script of
resets and removes (the same nodes expire, once each, and re-armed or
removed nodes do not), with 10,000 nodes armed on one thread, and through
twins of the reference's server cases (`tests/test_server.py`
`test_heartbeat_expiry_marks_down`, `TestHeartbeatExpiry` of
`tests/test_control_plane.py`) on a port `Server(device="cpu")`.
"""
import threading
import time

import pytest

from nomad_tpu.server.heartbeat import HeartbeatTracker as RefTracker

from nomad_tpu_torch import mock
from nomad_tpu_torch.lib.flight import default_flight
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.heartbeat import HeartbeatTracker
from nomad_tpu_torch.structs import NODE_STATUS_DOWN


def _wait(cond, timeout=10.0, every=0.01):
    dl = time.time() + timeout
    while time.time() < dl:
        if cond():
            return True
        time.sleep(every)
    return cond()


class _Expiries:
    def __init__(self):
        self.lock = threading.Lock()
        self.seen = []

    def __call__(self, node_id):
        with self.lock:
            self.seen.append(node_id)


def _script(cls, ttl=1.0):
    """Arm a..e, remove c, keep re-arming b past the others' deadline:
    a, d, e expire; then b stops heartbeating and a is re-armed late."""
    got = _Expiries()
    t = cls(ttl, got)
    t.reset("early")         # before start: ignored, as the reference does
    t.start()
    try:
        for n in "abcde":
            t.reset(n)
        t.remove("c")
        until = time.monotonic() + 1.5 * ttl
        while time.monotonic() < until:
            time.sleep(0.05)
            t.reset("b")
        assert _wait(lambda: len(got.seen) >= 3)
        first = sorted(got.seen)
        t.reset("a")
        assert _wait(lambda: len(got.seen) >= 5)
        return first, sorted(got.seen)
    finally:
        t.shutdown()


@pytest.mark.parametrize("cls", [HeartbeatTracker, RefTracker],
                         ids=["port", "reference"])
def test_expiries_follow_the_script(cls):
    first, final = _script(cls)
    assert first == ["a", "d", "e"]
    assert final == ["a", "a", "b", "d", "e"]


def test_ten_thousand_nodes_on_one_thread():
    got = _Expiries()
    t = HeartbeatTracker(3600.0, got)
    before = threading.active_count()
    t.start()
    try:
        for i in range(10_000):
            t.reset(f"n{i}")
        assert threading.active_count() == before + 1
        t.remove("n0")
        assert "n0" not in t._deadlines and len(t._deadlines) == 9_999
    finally:
        t.shutdown()
    assert threading.active_count() == before
    assert got.seen == []


def test_shutdown_cancels_and_disarms():
    got = _Expiries()
    t = HeartbeatTracker(0.1, got)
    t.start()
    t.reset("a")
    t.shutdown()
    t.reset("b")             # disabled: not armed
    time.sleep(0.3)
    assert got.seen == [] and len(t._deadlines) == 0


def test_an_expiry_that_raises_does_not_stop_the_others(capsys):
    seen = []

    def on_expire(node_id):
        seen.append(node_id)
        if node_id == "bad":
            raise RuntimeError("boom")

    t = HeartbeatTracker(0.05, on_expire)
    t.start()
    try:
        t.reset("bad")
        time.sleep(0.01)
        t.reset("good")
        assert _wait(lambda: "good" in seen)
        t.reset("again")
        assert _wait(lambda: "again" in seen)
    finally:
        t.shutdown()
    assert "RuntimeError: boom" in capsys.readouterr().err


def test_heartbeat_expiry_marks_down():
    s = Server(ServerConfig(num_schedulers=1, heartbeat_ttl=0.3),
               device="cpu")
    s.start()
    try:
        node = mock.node()
        s.node_register(node)
        assert s.state.node_by_id(node.id).status == "ready"
        assert _wait(lambda: s.state.node_by_id(node.id).status
                     == NODE_STATUS_DOWN)
        # Heartbeat after re-registration revives it
        node2 = mock.node()
        s.node_register(node2)
        assert s.node_heartbeat(node2.id)["ok"]
    finally:
        s.shutdown()


def test_ttl_miss_counted_and_flight_recorded():
    s = Server(ServerConfig(heartbeat_ttl=0.2, num_schedulers=0),
               device="cpu")
    s.start()
    try:
        idx0 = default_flight().last_index()
        node = mock.node()
        s.node_register(node)
        assert _wait(
            lambda: s.metrics.counter("heartbeat.expired").value >= 1,
            timeout=10.0)
        got = s.state.node_by_id(node.id)
        assert got.status == "down"
        _, evs = default_flight().records_after(
            idx0, types=["heartbeat.expired"])
        assert any(e["key"] == node.id for e in evs)
        assert s.control_plane_stats()["heartbeat_expired"] >= 1
    finally:
        s.shutdown()


def test_heartbeats_keep_a_node_up():
    s = Server(ServerConfig(num_schedulers=0, heartbeat_ttl=1.0),
               device="cpu")
    s.start()
    try:
        node = mock.node()
        s.node_register(node)
        for _ in range(15):
            time.sleep(0.1)
            assert s.node_heartbeat(node.id)["ok"]
        assert s.state.node_by_id(node.id).status == "ready"
        assert s.metrics.counter("heartbeat.expired").value == 0
    finally:
        s.shutdown()
