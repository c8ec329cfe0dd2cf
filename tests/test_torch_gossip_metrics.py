"""Twins of the reference's `tests/test_gossip_metrics.py` (gossip
membership and its metrics over the HTTP API), run on the port: every
agent, server and harness is the port's with `device="cpu"`, its HTTP
port ephemeral and its data under `tmp_path`; the reference's `slow`
marks are kept.
"""
import socket
import time

import pytest

from nomad_tpu_torch.lib.metrics import StatsdSink, TelemetryEmitter, flatten
from nomad_tpu_torch.server.gossip import (STATUS_ALIVE, STATUS_FAILED,
                                     STATUS_LEFT, STATUS_SUSPECT,
                                     Membership)
from nomad_tpu_torch.rpc.transport import ConnPool, RpcServer
from torch_chain_cases import one_torch_thread  # noqa: F401


def _wait(cond, timeout=20.0, every=0.05):
    dl = time.time() + timeout
    while time.time() < dl:
        if cond():
            return True
        time.sleep(every)
    return cond()


def _member(name, interval=0.1, suspect=0.5, failed=1.0):
    srv = RpcServer("127.0.0.1", 0)
    pool = ConnPool()
    m = Membership(name, srv.addr, pool, interval=interval,
                   suspect_after=suspect, failed_after=failed)
    srv.register("Gossip.exchange", m.exchange)
    srv.start()
    return srv, pool, m


class TestGossip:
    def test_join_propagates_transitively(self):
        parts = [_member(f"s{i}") for i in range(3)]
        try:
            # s1 joins via s0; s2 joins via s1 — everyone must learn s0
            parts[1][2].join([parts[0][0].addr])
            parts[2][2].join([parts[1][0].addr])
            for _s, _p, m in parts:
                m.start()
            assert _wait(lambda: all(
                len(m.members()) == 3 for _s, _p, m in parts))
            assert all(mm.status == STATUS_ALIVE
                       for _s, _p, m in parts for mm in m.members())
        finally:
            for s, p, m in parts:
                m.stop()
                s.shutdown()
                p.close()

    def test_failure_detection_and_rejoin(self):
        parts = [_member(f"s{i}") for i in range(3)]
        try:
            parts[1][2].join([parts[0][0].addr])
            parts[2][2].join([parts[0][0].addr])
            for _s, _p, m in parts:
                m.start()
            assert _wait(lambda: all(
                len(m.members()) == 3 for _s, _p, m in parts))
            # hard-kill s2 (no graceful leave)
            parts[2][2].stop()
            parts[2][0].shutdown()
            assert _wait(lambda: all(
                next(mm.status for mm in m.members()
                     if mm.name == "s2") in (STATUS_SUSPECT, STATUS_FAILED)
                for _s, _p, m in parts[:2]))
            assert _wait(lambda: all(
                next(mm.status for mm in m.members()
                     if mm.name == "s2") == STATUS_FAILED
                for _s, _p, m in parts[:2]), timeout=10.0)
        finally:
            for s, p, m in parts:
                m.stop()
                s.shutdown()
                p.close()

    def test_graceful_leave(self):
        parts = [_member(f"s{i}") for i in range(2)]
        try:
            parts[1][2].join([parts[0][0].addr])
            for _s, _p, m in parts:
                m.start()
            assert _wait(lambda: len(parts[0][2].members()) == 2)
            parts[1][2].leave()
            assert _wait(lambda: next(
                mm.status for mm in parts[0][2].members()
                if mm.name == "s1") == STATUS_LEFT)
        finally:
            for s, p, m in parts:
                m.stop()
                s.shutdown()
                p.close()

    def test_cluster_members_endpoint_shows_status(self, tmp_path):
        from tests.test_torch_cluster import leader_of, make_cluster

        agents = make_cluster(3, device="cpu")
        try:
            assert _wait(lambda: leader_of(agents) is not None)
            assert _wait(lambda: all(
                len(a.membership.members()) == 3 for a in agents))
            # exercise the HTTP serialization path with a cluster attached
            from nomad_tpu_torch.agent.http import HTTPApi

            leader = leader_of(agents)

            class _Facade:
                server = leader.server
                client = None
                cluster = leader

            api = HTTPApi(_Facade(), "127.0.0.1", 0)
            try:
                out = api.route("GET", "/v1/agent/members", {}, None)
                assert len(out["members"]) == 3
                assert all(m["status"] == "alive"
                           for m in out["members"])
            finally:
                api.httpd.server_close()
        finally:
            for a in agents:
                a.shutdown()


class TestTelemetry:
    def test_flatten(self):
        g = flatten({"broker": {"enqueued": 3}, "uptime_s": 1.5,
                     "leader": True, "name": "x"})
        assert g == {"nomad.broker.enqueued": 3.0, "nomad.uptime_s": 1.5,
                     "nomad.leader": 1.0}

    def test_statsd_emitter_ships_gauges(self):
        rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        rx.bind(("127.0.0.1", 0))
        rx.settimeout(5.0)
        port = rx.getsockname()[1]
        em = TelemetryEmitter(lambda: {"broker": {"ready": 2}},
                              StatsdSink(f"127.0.0.1:{port}"),
                              interval=0.1)
        em.start()
        try:
            data = rx.recv(65536)
            assert b"nomad.broker.ready:2|g" in data
        finally:
            em.stop()
            rx.close()

    def test_agent_telemetry_config(self, tmp_path):
        from nomad_tpu_torch.agent import Agent, AgentConfig

        rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        rx.bind(("127.0.0.1", 0))
        rx.settimeout(8.0)
        port = rx.getsockname()[1]
        cfg = AgentConfig(data_dir=str(tmp_path / "d"),
                          heartbeat_ttl=60.0)
        cfg.statsd_address = f"127.0.0.1:{port}"
        cfg.telemetry_interval = 0.1
        a = Agent(cfg, device="cpu")
        a.start()
        try:
            data = rx.recv(65536)
            assert b"nomad.state_index" in data
        finally:
            a.shutdown()
            rx.close()
