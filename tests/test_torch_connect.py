"""Twins of the reference's `tests/test_connect.py` (the native service
mesh), run on the port: every agent, server and harness is the port's
with `device="cpu"`, its HTTP port ephemeral and its data under
`tmp_path`; the reference's `slow` marks are kept.
"""
import socket
import ssl
import sys
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.agent import Agent, AgentConfig
from nomad_tpu_torch.api import NomadClient
from nomad_tpu_torch.client.task_runner import TaskRunner
from nomad_tpu_torch.structs.connect import inject_sidecars
from nomad_tpu_torch.structs.job import (Connect, ConnectProxy, ConnectUpstream,
                                   SidecarService)
from torch_chain_cases import one_torch_thread  # noqa: F401


def _wait(cond, timeout=30.0, step=0.1):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(step)
    return cond()


def _logs(api, alloc_id, task):
    try:
        return api.alloc_logs(alloc_id, task)
    except Exception:
        return b""


class TestInjection:
    def _job(self):
        job = mock.job()
        tg = job.task_groups[0]
        tg.count = 1
        from nomad_tpu_torch.structs.job import Service

        tg.services.append(Service(
            name="api", port_label="http",
            connect=Connect(sidecar_service=SidecarService(
                proxy=ConnectProxy(upstreams=[ConnectUpstream(
                    destination_name="db", local_bind_port=9191)])))))
        return job

    def test_sidecar_task_port_service_injected(self):
        job = self._job()
        inject_sidecars(job)
        tg = job.task_groups[0]
        proxy = next(t for t in tg.tasks
                     if t.name == "connect-proxy-api")
        assert proxy.driver == "connect_proxy"
        assert proxy.lifecycle is not None and proxy.lifecycle.sidecar
        labels = [p.label for n in proxy.resources.networks
                  for p in n.dynamic_ports]
        assert "connect_proxy_api" in labels
        assert any(s.name == "api-sidecar-proxy" and
                   s.port_label == "connect_proxy_api"
                   for s in tg.services)
        # upstream env on the app task, not the proxy
        app = next(t for t in tg.tasks if t.name != proxy.name)
        assert app.env["NOMAD_UPSTREAM_ADDR_DB"] == "127.0.0.1:9191"
        assert "NOMAD_UPSTREAM_ADDR_DB" not in proxy.env
        # discovery template over the destination's sidecar rows
        ups_t = next(t for t in proxy.templates
                     if t.dest_path == "local/upstreams.json")
        assert "${service.db-sidecar-proxy}" in ups_t.embedded_tmpl
        assert ups_t.change_mode == "noop"
        # inbound authorization feed
        int_t = next(t for t in proxy.templates
                     if t.dest_path == "local/intentions.json")
        assert "${connect.intentions.api}" in int_t.embedded_tmpl

    def test_injection_is_idempotent(self):
        job = self._job()
        inject_sidecars(job)
        before = [t.name for t in job.task_groups[0].tasks]
        inject_sidecars(job)
        inject_sidecars(job)
        assert [t.name for t in job.task_groups[0].tasks] == before
        assert sum(1 for s in job.task_groups[0].services
                   if s.name == "api-sidecar-proxy") == 1

    def test_reregister_rebuilds_proxy_upstreams(self):
        """Adding/rebinding an upstream on re-register must reach the
        proxy's listeners and discovery template, not just app env."""
        job = self._job()
        inject_sidecars(job)
        svc = next(s for s in job.task_groups[0].services
                   if s.name == "api")
        svc.connect.sidecar_service.proxy.upstreams.append(
            ConnectUpstream(destination_name="cache",
                            local_bind_port=9292))
        svc.connect.sidecar_service.proxy.upstreams[0] \
            .local_bind_port = 9199  # rebind db
        inject_sidecars(job)
        tg = job.task_groups[0]
        proxy = next(t for t in tg.tasks
                     if t.name == "connect-proxy-api")
        assert {"name": "cache", "bind": 9292} in proxy.config["upstreams"]
        assert {"name": "db", "bind": 9199} in proxy.config["upstreams"]
        ups_t = [t for t in proxy.templates
                 if t.dest_path == "local/upstreams.json"]
        assert len(ups_t) == 1
        assert "cache-sidecar-proxy" in ups_t[0].embedded_tmpl
        app = next(t for t in tg.tasks if t.name != proxy.name)
        assert app.env["NOMAD_UPSTREAM_ADDR_CACHE"] == "127.0.0.1:9292"
        assert app.env["NOMAD_UPSTREAM_ADDR_DB"] == "127.0.0.1:9199"
        # rebound local_bind_port must re-account as a scheduled port
        reserved = {p.value for n in proxy.resources.networks
                    for p in n.reserved_ports}
        assert reserved == {9199, 9292}

    def test_upstream_bind_is_a_scheduled_host_port(self):
        """The upstream listener binds the shared host
        loopback, so local_bind_port must ride the proxy's network as a
        reserved port the scheduler accounts."""
        job = self._job()
        inject_sidecars(job)
        proxy = next(t for t in job.task_groups[0].tasks
                     if t.name == "connect-proxy-api")
        reserved = [(p.label, p.value) for n in proxy.resources.networks
                    for p in n.reserved_ports]
        assert ("connect_upstream_db", 9191) in reserved


class TestUpstreamPortScheduling:
    """Two allocs of one upstream-consuming group must not co-place on
    a node: both sidecars would bind 127.0.0.1:local_bind_port (the
    collision used to surface as a zombie sidecar at runtime
    instead of a placement decision)."""

    def _consumer(self, count):
        from nomad_tpu_torch.structs.job import Service

        job = mock.job()
        tg = job.task_groups[0]
        tg.count = count
        tg.tasks[0].resources.cpu = 100
        tg.tasks[0].resources.memory_mb = 64
        tg.services.append(Service(
            name="web", port_label="http",
            connect=Connect(sidecar_service=SidecarService(
                proxy=ConnectProxy(upstreams=[ConnectUpstream(
                    destination_name="db", local_bind_port=29191)])))))
        return job

    def _run(self, n_nodes, count):
        from nomad_tpu_torch.server import Server, ServerConfig

        s = Server(ServerConfig(num_schedulers=1, heartbeat_ttl=3600.0), device="cpu")
        for i in range(n_nodes):
            n = mock.node()
            n.id = f"n-{i}"
            n.attributes["driver.connect_proxy"] = "1"
            s.state.upsert_node(n)
        s.start()
        try:
            job = self._consumer(count)
            ev = s.job_register(job)
            got = s.wait_for_eval(
                ev.id, statuses=("complete", "failed", "blocked",
                                 "cancelled"), timeout=60.0)
            assert got is not None
            allocs = [a for a in s.state.allocs_by_job("default", job.id)
                      if not a.terminal_status()]
        finally:
            s.shutdown()
        return got, allocs

    def test_two_allocs_spread_across_nodes(self):
        _, allocs = self._run(n_nodes=2, count=2)
        assert len(allocs) == 2
        assert len({a.node_id for a in allocs}) == 2, \
            "upstream binds co-placed on one loopback"

    def test_single_node_places_only_one(self):
        got, allocs = self._run(n_nodes=1, count=2)
        assert len(allocs) == 1
        assert got.status in ("complete", "blocked")


class TestParse:
    def test_connect_stanza_parses(self):
        from nomad_tpu_torch.jobspec import parse

        job = parse('''
        job "mesh" {
          group "g" {
            service {
              name = "api"
              port = "http"
              connect {
                sidecar_service {
                  proxy {
                    upstreams {
                      destination_name = "db"
                      local_bind_port  = 9191
                    }
                  }
                }
              }
            }
            task "t" {
              driver = "raw_exec"
              config { command = "/bin/true" }
            }
          }
        }
        ''')
        svc = job.task_groups[0].services[0]
        assert svc.connect is not None
        ups = svc.connect.sidecar_service.proxy.upstreams
        assert ups[0].destination_name == "db"
        assert ups[0].local_bind_port == 9191


@pytest.fixture()
def agent(tmp_path, monkeypatch):
    monkeypatch.setattr(TaskRunner, "TEMPLATE_POLL_S", 0.25)
    a = Agent(AgentConfig(data_dir=str(tmp_path / "data"),
                          heartbeat_ttl=60.0), device="cpu")
    a.start()
    api = NomadClient(a.http_addr[0], a.http_addr[1])
    assert _wait(lambda: len(api.nodes()) == 1)
    yield a, api
    # stop jobs BEFORE shutdown: agent shutdown detaches long-running
    # executor tasks for recovery, and this suite's never-exiting
    # servers would squat their dynamic ports for every later test
    try:
        alloc_ids = [al.id for j in api.jobs()
                     for al in api.job_allocations(j.id)]
        for j in api.jobs():
            api.deregister_job(j.id)
        _wait(lambda: all(
            api.allocation(aid).client_status
            in ("complete", "failed", "lost") for aid in alloc_ids),
            timeout=15)
        time.sleep(0.5)
    except Exception:
        pass
    a.shutdown()


def _run_service_alloc(server, node_id, *services):
    """Place a live server-side alloc on `node_id` whose job declares
    `services` — the binding `connect_issue` now requires (a
    verified node may only mint leaves for services its own live
    allocations run)."""
    from nomad_tpu_torch.structs.job import Service

    j = mock.job()
    j.task_groups[0].services = [Service(name=s) for s in services]
    # the agent's client WILL pull this alloc and run it — keep the
    # task a harmless long-lived mock so it doesn't flap to terminal
    # (a failed task would retract the binding mid-test)
    for t in j.task_groups[0].tasks:
        t.driver = "mock_driver"
        t.config = {"run_for": 300}
    a = mock.alloc(job=j, node_id=node_id)
    a.client_status = "running"
    server.state.upsert_job(j)
    server.state.upsert_alloc(a)
    return a


class TestConnectIssueIdentity:
    """`connect_issue` verifies the
    requesting node's identity secret against state BEFORE minting —
    a peer can no longer mint as an EXISTING node without its secret.
    A fabric peer that self-registers
    a fresh node id still can't mint, because issuance now also
    requires a live allocation of the named service on that node."""

    def test_wrong_secret_is_denied_and_counted(self, agent):
        a, api = agent
        n = a.client.node
        c0 = a.server.metrics.snapshot()["counters"]
        before = c0.get("connect.issue_denied", 0)
        before_id = c0.get("connect.issue_denied_identity", 0)
        with pytest.raises(PermissionError):
            a.server.connect_issue("svc-a", n.id, "not-the-secret")
        # non-ASCII presented secret: still a clean deny (str-mode
        # compare_digest would raise TypeError → a 500, not a deny)
        with pytest.raises(PermissionError):
            a.server.connect_issue("svc-a", n.id, "ü-non-ascii")
        # unknown node id: same rejection
        with pytest.raises(PermissionError):
            a.server.connect_issue("svc-a", "no-such-node",
                                   n.secret_id)
        # no identity at all (the pre-fix caller shape): rejected
        with pytest.raises(PermissionError):
            a.server.connect_issue("svc-a")
        counters = a.server.metrics.snapshot()["counters"]
        assert counters["connect.issue_denied"] == before + 4
        # every one of these is an IDENTITY deny — the distinct reason
        # series lets a dashboard tell credential probing apart from
        # mis-scheduled sidecars (no-alloc denials)
        assert counters["connect.issue_denied_identity"] == before_id + 4
        assert counters.get("connect.issue_denied_no_alloc", 0) == 0
        # denial happens BEFORE any CA/cert work — no mesh CA appears
        assert a.server.state.secret_get("nomad/connect", "ca") is None

    def test_no_alloc_binding_is_denied_and_counted(self, agent):
        """A node with a VALID identity but no live allocation of the
        named service must be denied with the distinct no_alloc reason
        (a self-registered fabric peer passes the identity check for
        its own fresh node id — the alloc binding is what stops it)."""
        a, api = agent
        n = a.client.node
        c0 = a.server.metrics.snapshot()["counters"]
        with pytest.raises(PermissionError) as ei:
            a.server.connect_issue("not-scheduled-here", n.id,
                                   n.secret_id)
        assert "no live allocation" in str(ei.value)
        # a TERMINAL alloc of the service must not satisfy the binding
        dead = _run_service_alloc(a.server, n.id, "not-scheduled-here")
        dead.client_status = "failed"
        a.server.state.upsert_alloc(dead)
        with pytest.raises(PermissionError):
            a.server.connect_issue("not-scheduled-here", n.id,
                                   n.secret_id)
        # a live alloc on a DIFFERENT node doesn't bind this one
        _run_service_alloc(a.server, "some-other-node",
                           "not-scheduled-here")
        with pytest.raises(PermissionError):
            a.server.connect_issue("not-scheduled-here", n.id,
                                   n.secret_id)
        c1 = a.server.metrics.snapshot()["counters"]
        assert c1["connect.issue_denied"] \
            == c0.get("connect.issue_denied", 0) + 3
        assert c1["connect.issue_denied_no_alloc"] \
            == c0.get("connect.issue_denied_no_alloc", 0) + 3
        assert c1.get("connect.issue_denied_identity", 0) \
            == c0.get("connect.issue_denied_identity", 0)
        assert a.server.state.secret_get("nomad/connect", "ca") is None

    def test_empty_stored_secret_is_denied(self, agent):
        """A node row with NO registered secret (e.g. restored from
        pre-upgrade state) must deny even an empty presented secret —
        an empty==empty match would let any peer mint a cert from a
        public node id."""
        from nomad_tpu_torch.structs.node import Node

        a, api = agent
        a.server.node_register(Node(id="bare-node", name="bare"))
        with pytest.raises(PermissionError):
            a.server.connect_issue("svc-a", "bare-node", "")

    def test_node_get_rpc_redacts_secret(self, agent):
        """node_get is a forwarded fabric RPC — serving secret_id there
        would hand any peer exactly the credential connect_issue
        verifies. The redaction is a copy: state keeps the secret."""
        a, api = agent
        n = a.client.node
        served = a.server.node_get(n.id)
        assert served is not None and served.id == n.id
        assert served.secret_id == ""
        assert a.server.state.node_by_id(n.id).secret_id == n.secret_id

    def test_registered_identity_is_accepted(self, agent):
        pytest.importorskip("cryptography")  # connect_issue mints X.509
        a, api = agent
        n = a.client.node
        assert n.secret_id  # client generated one at start
        # the registered node's view in state carries the same secret
        assert a.server.state.node_by_id(n.id).secret_id == n.secret_id
        _run_service_alloc(a.server, n.id, "svc-id")  # alloc binding
        pems = a.server.connect_issue("svc-id", n.id, n.secret_id)
        assert "BEGIN CERTIFICATE" in pems["cert"]

    def test_register_secret_is_write_once(self, agent):
        """Registration is itself an unauthenticated forwarded RPC: a
        re-register carrying a DIFFERENT secret must not overwrite the
        bound one (that would hijack the connect_issue identity, or
        deny the real node its next issuance) — it rejects and counts
        node.register_denied. A row with NO bound secret accepts one
        later (TOFU, reference node_endpoint.go Register)."""
        import dataclasses

        from nomad_tpu_torch.structs.node import Node

        a, api = agent
        n = a.client.node
        bound = a.server.state.node_by_id(n.id)
        assert bound.secret_id == n.secret_id
        before = a.server.metrics.snapshot()["counters"].get(
            "node.register_denied", 0)
        with pytest.raises(PermissionError):
            a.server.node_register(
                dataclasses.replace(bound, secret_id="attacker"))
        with pytest.raises(PermissionError):
            a.server.node_register(
                dataclasses.replace(bound, secret_id=""))
        # non-ASCII secret must be a deny, not a TypeError-500
        with pytest.raises(PermissionError):
            a.server.node_register(
                dataclasses.replace(bound, secret_id="ü-non-ascii"))
        after = a.server.metrics.snapshot()["counters"][
            "node.register_denied"]
        assert after == before + 3
        # the bound secret survives, and the real node re-registers
        assert a.server.state.node_by_id(n.id).secret_id == n.secret_id
        a.server.node_register(dataclasses.replace(bound))
        # TOFU: a pre-upgrade row with no secret binds on next register
        a.server.node_register(Node(id="tofu-node", name="tofu"))
        a.server.node_register(Node(id="tofu-node", name="tofu",
                                    secret_id="first-bind"))
        assert a.server.state.node_by_id(
            "tofu-node").secret_id == "first-bind"

    def test_first_registration_race_binds_exactly_once(self, agent):
        """Check+upsert are ONE atom: two racing first registrations
        for the same fresh node id (different secrets) must not both
        pass the write-once check — node_by_id and upsert_node lock
        the store separately, so without the identity lock both racers
        see no bound secret and the TOFU binding goes to whichever
        wins the upsert race, permanently locking the other out."""
        import threading as _threading

        from nomad_tpu_torch.structs.node import Node

        a, api = agent
        srv = a.server
        real = srv.state.node_by_id
        # meet inside the check→upsert window; under the fix the
        # second racer never reaches it concurrently, so the barrier
        # just times out (broken) and the threads serialize
        gate = _threading.Barrier(2, timeout=1.0)

        def slow_node_by_id(node_id):
            out = real(node_id)
            if node_id == "raced-node":
                try:
                    gate.wait()
                except _threading.BrokenBarrierError:
                    pass
                time.sleep(0.02)
            return out

        srv.state.node_by_id = slow_node_by_id
        denied = []

        def register(secret):
            try:
                srv.node_register(Node(id="raced-node", name="raced",
                                       secret_id=secret))
            except PermissionError:
                denied.append(secret)

        try:
            ts = [_threading.Thread(target=register, args=(s,))
                  for s in ("secret-one", "secret-two")]
            for t in ts:
                t.start()
            for t in ts:
                t.join(10.0)
        finally:
            srv.state.node_by_id = real
        assert len(denied) == 1, "exactly one racer must be denied"
        won = ({"secret-one", "secret-two"} - set(denied)).pop()
        assert srv.state.node_by_id("raced-node").secret_id == won

    def test_secret_is_redacted_from_http_node_api(self, agent):
        a, api = agent
        n = a.client.node
        import json
        import urllib.request

        base = f"http://{a.http_addr[0]}:{a.http_addr[1]}"
        for path in ("/v1/nodes", f"/v1/node/{n.id}"):
            with urllib.request.urlopen(base + path, timeout=5) as r:
                body = json.loads(r.read())
            tree = body[0] if isinstance(body, list) else body
            assert "secret_id" not in tree
            assert n.secret_id not in json.dumps(body)


class TestMeshCA:
    def test_ca_namespace_reserved_from_secrets_surface(self, agent):
        """The raft-replicated mesh CA key must not be readable,
        overwritable, or deletable through the public secrets API."""
        pytest.importorskip("cryptography")  # connect_issue mints X.509
        from nomad_tpu_torch.structs.secrets import SecretEntry

        a, api = agent
        n = a.client.node
        _run_service_alloc(a.server, n.id, "svc-a", "svc-b")
        pems = a.server.connect_issue("svc-a", n.id, n.secret_id)
        assert "BEGIN CERTIFICATE" in pems["cert"]
        # a second issue signs with the SAME root
        assert a.server.connect_issue("svc-b", n.id,
                                      n.secret_id)["ca"] == pems["ca"]
        for fn in (lambda: a.server.secret_get("nomad/connect", "ca"),
                   lambda: a.server.secret_delete("nomad/connect", "ca"),
                   lambda: a.server.secrets_list("nomad/connect"),
                   lambda: a.server.secret_upsert(SecretEntry(
                       namespace="nomad/connect", path="ca",
                       data={"cert": "x", "key": "y"}))):
            with pytest.raises(PermissionError):
                fn()


_BACKEND_PY = """
import os
from http.server import BaseHTTPRequestHandler, HTTPServer

class H(BaseHTTPRequestHandler):
    def do_GET(self):
        self.send_response(200)
        self.end_headers()
        self.wfile.write(b"mesh-ok")
    def log_message(self, *a):
        pass

print("backend up", flush=True)
HTTPServer(("127.0.0.1", int(os.environ["NOMAD_PORT_HTTP"])),
           H).serve_forever()
"""

_FRONTEND_PY = """
import os, time, urllib.request
addr = os.environ["NOMAD_UPSTREAM_ADDR_API"]
while True:
    try:
        with urllib.request.urlopen(f"http://{addr}/", timeout=3) as r:
            print("got:", r.read().decode(), flush=True)
    except Exception as e:
        print("retry:", e, flush=True)
    time.sleep(0.5)
"""


class TestMeshE2E:
    @pytest.mark.slow  # >20s on a cold host; tier-1 budget
    def test_traffic_traverses_mtls_mesh(self, agent):
        """frontend app → frontend sidecar (upstream) → TLS → backend
        sidecar → backend app, with catalog-driven discovery; and the
        backend sidecar refuses non-mesh (plaintext / certless) peers."""
        pytest.importorskip("cryptography")  # sidecar certs at task start
        from nomad_tpu_torch.structs.job import Service
        from nomad_tpu_torch.structs.resources import NetworkResource, Port

        a, api = agent

        be = mock.job()
        be.id = be.name = "mesh-backend"
        tg = be.task_groups[0]
        tg.count = 1
        # fast retry: a dynamic port picked by this agent can collide
        # with a dying orphan task from an earlier test's agent (shared
        # 20000+ range); the bind failure must not park the task in the
        # default long restart backoff
        tg.restart_policy.delay_s = 1.0
        t = tg.tasks[0]
        t.driver = "raw_exec"
        t.resources.networks = [NetworkResource(
            mbits=10, dynamic_ports=[Port(label="http")])]
        t.config = {"command": sys.executable,
                    "args": ["-c", _BACKEND_PY]}
        tg.services = [Service(
            name="api", port_label="http",
            connect=Connect(sidecar_service=SidecarService()))]
        api.wait_for_eval(api.register_job(be))

        fe = mock.job()
        fe.id = fe.name = "mesh-frontend"
        tg = fe.task_groups[0]
        tg.count = 1
        tg.restart_policy.delay_s = 1.0  # see backend note
        t = tg.tasks[0]
        t.driver = "raw_exec"
        t.resources.networks = [NetworkResource(
            mbits=10, dynamic_ports=[Port(label="fp")])]
        t.config = {"command": sys.executable,
                    "args": ["-c", _FRONTEND_PY]}
        tg.services = [Service(
            name="web", port_label="fp",
            connect=Connect(sidecar_service=SidecarService(
                proxy=ConnectProxy(upstreams=[ConnectUpstream(
                    destination_name="api",
                    local_bind_port=29391)])))) ]
        api.wait_for_eval(api.register_job(fe))

        fe_alloc = None

        def fe_running():
            nonlocal fe_alloc
            fe_alloc = next(
                (al for al in api.job_allocations(fe.id)
                 if al.client_status == "running"), None)
            return fe_alloc is not None
        assert _wait(fe_running, timeout=60)

        # the full mesh path delivers the backend's payload (90s: port
        # collisions with orphans of earlier tests' agents can hold a
        # task in 1s-retry for up to ~60s before the orphan exits)
        assert _wait(
            lambda: b"got: mesh-ok" in _logs(api, fe_alloc.id, "web"),
            timeout=90), _logs(api, fe_alloc.id, "web")

        # mTLS enforcement on the backend sidecar's public port
        regs = a.server.services_lookup("default", "api-sidecar-proxy")
        assert regs, "sidecar never registered"
        port = regs[0].port
        # plaintext HTTP straight at the mesh port: the TLS server must
        # not answer it
        try:
            import urllib.request

            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/", timeout=3) as r:
                body = r.read()
        except Exception:
            body = b""
        assert b"mesh-ok" not in body
        # TLS WITHOUT a client cert: handshake must fail (CERT_REQUIRED)
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
        with pytest.raises(ssl.SSLError):
            with socket.create_connection(("127.0.0.1", port),
                                          timeout=3) as raw:
                tls = ctx.wrap_socket(raw)
                tls.send(b"GET / HTTP/1.0\r\n\r\n")
                tls.recv(64)


class TestIngressGateway:
    """connect { gateway { ingress } }: a public mesh entry point
    (reference job_endpoint_hook_connect.go:41)."""

    def test_injection(self):
        from nomad_tpu_torch.structs.connect import inject_sidecars
        from nomad_tpu_torch.structs.job import (IngressGateway,
                                           IngressListener, Service)

        job = mock.job()
        tg = job.task_groups[0]
        tg.services.append(Service(
            name="edge",
            connect=Connect(gateway=IngressGateway(listeners=[
                IngressListener(port=28080, service="api")]))))
        inject_sidecars(job)
        gw = next(t for t in tg.tasks if t.name == "connect-ingress-edge")
        assert gw.driver == "connect_proxy"
        assert gw.config["public"] is True
        assert gw.config["upstreams"] == [{"name": "api", "bind": 28080}]
        ports = [p for n in gw.resources.networks
                 for p in n.reserved_ports]
        assert ports and ports[0].value == 28080
        assert "api-sidecar-proxy" in next(
            t for t in gw.templates
            if t.dest_path == "local/upstreams.json").embedded_tmpl
        # the declaring service advertises the first listener
        svc = next(s for s in tg.services if s.name == "edge")
        assert svc.port_label == "ingress_28080"
        # idempotent + listener rebuild on re-register
        inject_sidecars(job)
        assert sum(1 for t in tg.tasks
                   if t.name == "connect-ingress-edge") == 1

    def test_parse(self):
        from nomad_tpu_torch.jobspec import parse

        job = parse('''
        job "edge" {
          group "g" {
            service {
              name = "edge"
              connect {
                gateway {
                  ingress {
                    listener { port = 28080  service = "api" }
                    listener { port = 28081  service = "db" }
                  }
                }
              }
            }
            task "t" {
              driver = "raw_exec"
              config { command = "/bin/true" }
            }
          }
        }
        ''')
        gw = job.task_groups[0].services[0].connect.gateway
        assert [(ls.port, ls.service) for ls in gw.listeners] == [
            (28080, "api"), (28081, "db")]

    @pytest.mark.slow  # >20s on a cold host; tier-1 budget
    def test_external_client_reaches_mesh_service(self, agent):
        """A NON-mesh client hits the public ingress port and gets the
        backend's payload through the gateway's mTLS dial."""
        pytest.importorskip("cryptography")  # sidecar certs at task start
        import urllib.request

        from nomad_tpu_torch.structs.job import (IngressGateway,
                                           IngressListener, Service)
        from nomad_tpu_torch.structs.resources import NetworkResource, Port

        a, api = agent

        be = mock.job()
        be.id = be.name = "ing-backend"
        tg = be.task_groups[0]
        tg.count = 1
        tg.restart_policy.delay_s = 1.0
        t = tg.tasks[0]
        t.driver = "raw_exec"
        t.resources.networks = [NetworkResource(
            mbits=10, dynamic_ports=[Port(label="http")])]
        t.config = {"command": sys.executable,
                    "args": ["-c", _BACKEND_PY]}
        tg.services = [Service(
            name="api", port_label="http",
            connect=Connect(sidecar_service=SidecarService()))]
        api.wait_for_eval(api.register_job(be))

        gwj = mock.job()
        gwj.id = gwj.name = "ing-gateway"
        tg = gwj.task_groups[0]
        tg.count = 1
        tg.restart_policy.delay_s = 1.0
        t = tg.tasks[0]
        t.driver = "raw_exec"
        t.config = {"command": "/bin/sh", "args": ["-c", "sleep 120"]}
        tg.services = [Service(
            name="edge",
            connect=Connect(gateway=IngressGateway(listeners=[
                IngressListener(port=28085, service="api")])))]
        api.wait_for_eval(api.register_job(gwj))

        def fetch():
            try:
                with urllib.request.urlopen(
                        "http://127.0.0.1:28085/", timeout=3) as r:
                    return r.read()
            except Exception:
                return b""
        assert _wait(lambda: fetch() == b"mesh-ok", timeout=90), fetch()


class TestValidation:
    def test_portless_sidecar_rejected(self, agent):
        from nomad_tpu_torch.api.client import ApiError
        from nomad_tpu_torch.structs.job import Service

        a, api = agent
        job = mock.job()
        tg = job.task_groups[0]
        tg.services = [Service(
            name="api", connect=Connect(
                sidecar_service=SidecarService()))]
        with pytest.raises(ApiError) as ei:
            api.register_job(job)
        assert "needs a port" in str(ei.value)

    def test_unresolvable_sidecar_target_port_rejected(self, agent):
        """A sidecar target label that no group/task network declares
        would leave NOMAD_CONNECT_TARGET_PORT unresolved — the proxy
        would splice inbound to port 0 while registered as passing.
        Admission must reject it."""
        from nomad_tpu_torch.api.client import ApiError
        from nomad_tpu_torch.structs.job import Service

        a, api = agent
        job = mock.job()
        tg = job.task_groups[0]
        tg.services = [Service(
            name="api", port_label="no_such_label",
            connect=Connect(sidecar_service=SidecarService()))]
        with pytest.raises(ApiError) as ei:
            api.register_job(job)
        assert "not a port label" in str(ei.value)
        # the literal numeric form stays admissible (services.py
        # _resolve_port accepts it; the task runner resolves it too)
        from nomad_tpu_torch.structs.connect import validate_connect

        tg.services[0].port_label = "8080"
        assert validate_connect(job) == ""

    def test_proxy_exits_visibly_without_target_port(self):
        """Defense in depth behind the validator: a sidecar that DOES
        start with an inbound listener but no resolved target must die
        loudly (restart-loop visibility), not serve only upstreams."""
        import os
        import subprocess

        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        proc = subprocess.run(
            [sys.executable, "-m", "nomad_tpu_torch.connect_proxy",
             "--listen", "12345", "--upstream", "backend=0"],
            capture_output=True, text=True, timeout=30, cwd=repo)
        assert proc.returncode == 1
        assert "target port" in (proc.stderr + proc.stdout)

    def test_reserved_namespace_blocked_over_http(self, agent):
        pytest.importorskip("cryptography")  # connect_issue mints X.509
        from nomad_tpu_torch.api.client import ApiError

        a, api = agent
        n = a.client.node
        _run_service_alloc(a.server, n.id, "seed")  # alloc binding
        a.server.connect_issue("seed", n.id, n.secret_id)  # CA exists
        import urllib.error
        import urllib.request

        url = (f"http://{a.http_addr[0]}:{a.http_addr[1]}"
               f"/v1/secret/ca?namespace=nomad%2Fconnect")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(url, timeout=5)
        assert ei.value.code == 403


class TestPlan:
    def test_job_plan_reflects_injected_sidecar(self, agent):
        """`job plan` must count the proxy task's placement the real
        register would create (same admission mutation)."""
        from nomad_tpu_torch.structs.job import Service
        from nomad_tpu_torch.structs.resources import NetworkResource, Port

        a, api = agent
        job = mock.job()
        tg = job.task_groups[0]
        tg.count = 1
        t = tg.tasks[0]
        t.driver = "raw_exec"
        t.resources.networks = [NetworkResource(
            mbits=10, dynamic_ports=[Port(label="http")])]
        t.config = {"command": "/bin/true"}
        tg.services = [Service(
            name="api", port_label="http",
            connect=Connect(sidecar_service=SidecarService()))]
        out = api.plan_job(job)
        assert out["placements"] == 1  # one alloc (group), proxy inside
        assert not out["failed_tg_allocs"], out


class TestIntentions:
    """Mesh intentions (Consul intentions analog): source→destination
    allow/deny enforced by the destination sidecar against the peer's
    leaf-cert CN."""

    def test_matcher_precedence(self, tmp_path):
        import argparse

        from nomad_tpu_torch.connect_proxy import Proxy

        f = tmp_path / "intentions.json"

        class _Conn:
            def getpeercert(self):
                return {"subject": ((("commonName", "web"),),)}

        def allowed(rules):
            import json as _j
            f.write_text(_j.dumps(rules))
            p = Proxy(argparse.Namespace(
                listen=0, target=0, public=False,
                upstreams_file="", intentions_file=str(f),
                ca="", cert="", key=""))
            p.server_ctx = object()  # pretend TLS is on
            return p._peer_allowed(_Conn())

        assert allowed([])  # default allow
        assert not allowed([{"source": "web", "destination": "api",
                             "action": "deny"}])
        # exact source beats wildcard source
        assert allowed([{"source": "web", "destination": "api",
                         "action": "allow"},
                        {"source": "*", "destination": "api",
                         "action": "deny"}])
        assert not allowed([{"source": "other", "destination": "api",
                             "action": "allow"},
                            {"source": "*", "destination": "api",
                             "action": "deny"}])
        assert allowed([{"source": "*", "destination": "api",
                         "action": "allow"}])
        # exact destination beats wildcard destination: catch-all deny
        # with a specific allow must admit the peer
        assert allowed([{"source": "web", "destination": "api",
                         "action": "allow"},
                        {"source": "web", "destination": "*",
                         "action": "deny"}])
        assert not allowed([{"source": "web", "destination": "*",
                             "action": "deny"}])

    def test_crud_and_http(self, agent):
        a, api = agent
        api.connect_intention_upsert("web", "api", "deny")
        api.connect_intention_upsert("*", "db", "allow")
        rows = api.connect_intentions()
        assert {"Source": "web", "Destination": "api",
                "Action": "deny"} in rows
        # lookup scoped to a destination includes its wildcard rules
        assert a.server.connect_intentions_for("db") == [
            {"source": "*", "destination": "db", "action": "allow"}]
        api.connect_intention_delete("web", "api")
        assert all(r["Destination"] != "api"
                   for r in api.connect_intentions())

    @pytest.mark.slow  # >20s on a cold host; tier-1 budget
    def test_deny_blocks_live_mesh_traffic(self, agent):
        """Flip a deny intention on a WORKING mesh: new connections are
        refused; delete it and traffic resumes."""
        pytest.importorskip("cryptography")  # sidecar certs at task start
        from nomad_tpu_torch.structs.job import Service
        from nomad_tpu_torch.structs.resources import NetworkResource, Port

        a, api = agent

        be = mock.job()
        be.id = be.name = "int-backend"
        tg = be.task_groups[0]
        tg.count = 1
        tg.restart_policy.delay_s = 1.0
        t = tg.tasks[0]
        t.driver = "raw_exec"
        t.resources.networks = [NetworkResource(
            mbits=10, dynamic_ports=[Port(label="http")])]
        t.config = {"command": sys.executable,
                    "args": ["-c", _BACKEND_PY]}
        tg.services = [Service(
            name="api", port_label="http",
            connect=Connect(sidecar_service=SidecarService()))]
        api.wait_for_eval(api.register_job(be))

        fe = mock.job()
        fe.id = fe.name = "int-frontend"
        tg = fe.task_groups[0]
        tg.count = 1
        tg.restart_policy.delay_s = 1.0
        t = tg.tasks[0]
        t.driver = "raw_exec"
        t.resources.networks = [NetworkResource(
            mbits=10, dynamic_ports=[Port(label="fp")])]
        t.config = {"command": sys.executable,
                    "args": ["-c", _FRONTEND_PY]}
        tg.services = [Service(
            name="web", port_label="fp",
            connect=Connect(sidecar_service=SidecarService(
                proxy=ConnectProxy(upstreams=[ConnectUpstream(
                    destination_name="api",
                    local_bind_port=29395)])))) ]
        api.wait_for_eval(api.register_job(fe))

        fe_alloc = None

        def fe_running():
            nonlocal fe_alloc
            fe_alloc = next(
                (al for al in api.job_allocations(fe.id)
                 if al.client_status == "running"), None)
            return fe_alloc is not None
        assert _wait(fe_running, timeout=60)
        assert _wait(
            lambda: b"got: mesh-ok" in _logs(api, fe_alloc.id, "web"),
            timeout=90)

        # deny web -> api; the destination sidecar's intentions file
        # refreshes on the next watcher tick
        api.connect_intention_upsert("web", "api", "deny")
        time.sleep(1.5)
        mark = len(_logs(api, fe_alloc.id, "web"))
        time.sleep(3.0)
        tail = _logs(api, fe_alloc.id, "web")[mark:]
        assert b"got: mesh-ok" not in tail, tail

        # remove the deny: traffic resumes
        api.connect_intention_delete("web", "api")
        assert _wait(
            lambda: b"got: mesh-ok"
            in _logs(api, fe_alloc.id, "web")[mark:], timeout=30), \
            _logs(api, fe_alloc.id, "web")[mark:]
