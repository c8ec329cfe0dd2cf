"""HTTP API server — the `/v1/*` surface.

Behavioral reference: `command/agent/http.go` (route table :253-315, the
`wrap` helper :319 — JSON responses, error mapping, blocking-query params
`index`/`wait`, `stale` reads) and the per-noun handlers
(`command/agent/{job,node,alloc,eval,deployment,operator,...}_endpoint.go`).

JSON encoding: struct trees are serialized through the wire codec
(structs/codec.py) with `__t` type tags, and the Python SDK decodes them
back into structs — the reference's Go-SDK/CamelCase-JSON pairing mapped
onto this codebase's single data model (documented deviation: field names
are snake_case, not the reference's CamelCase).
"""
from __future__ import annotations

import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from ..structs.codec import from_json_tree, from_wire, to_json_tree, to_wire


class HttpError(Exception):
    def __init__(self, code: int, message: str) -> None:
        super().__init__(message)
        self.code = code


class PlainText:
    """Marker payload: serve `body` verbatim as text instead of JSON
    (Prometheus exposition on /v1/metrics?format=prometheus)."""

    def __init__(self, body: str,
                 content_type: str = "text/plain; version=0.0.4") -> None:
        self.body = body
        self.content_type = content_type


class JsonLineStream:
    """Marker payload: a push stream. `lines` is a generator of JSON
    strings; the handler writes each as one chunked-transfer frame and
    holds the connection open until the generator ends or the client
    disconnects (/v1/event/stream?stream=1)."""

    def __init__(self, lines) -> None:
        self.lines = lines


def _event_stream_lines(sub, heartbeat: float):
    """Push-stream body: event batches as they arrive, a heartbeat line
    (`{"index": N, "heartbeat": true}`) after `heartbeat` idle seconds
    so proxies and clients can tell a quiet cluster from a dead
    connection. Runs until the consumer disconnects; the finally drops
    the broker subscription."""
    try:
        last = sub.last_delivered
        next_beat = time.time() + heartbeat
        while True:
            batch = sub.poll(timeout=min(heartbeat, 1.0))
            if batch:
                last = sub.last_delivered
                yield json.dumps(
                    {"index": last,
                     "events": [to_json_tree(to_wire(e))
                                for e in batch]})
                next_beat = time.time() + heartbeat
            elif time.time() >= next_beat:
                yield json.dumps({"index": last, "heartbeat": True})
                next_beat = time.time() + heartbeat
    finally:
        sub.close()


class HTTPApi:
    """Routes /v1/* to server endpoints. `agent` carries .server (leader
    methods), optional .client, and optional .cluster (ClusterServer)."""

    def __init__(self, agent, host: str = "127.0.0.1", port: int = 0,
                 tls=None) -> None:
        self.agent = agent
        api = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet
                pass

            def _respond(self, code: int, payload: Any) -> None:
                if isinstance(payload, PlainText):
                    body = payload.body.encode()
                    ctype = payload.content_type
                else:
                    body = json.dumps(to_json_tree(payload)).encode()
                    ctype = "application/json"
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _stream(self, payload: JsonLineStream) -> None:
                """Chunked transfer encoding, one JSON line per chunk.
                The generator runs until the client hangs up (the write
                raises) — its finally-block drops the subscription, so a
                dead consumer can't pin broker state."""
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.send_header("X-Nomad-Event-Stream", "1")
                self.end_headers()
                try:
                    for line in payload.lines:
                        data = (line + "\n").encode()
                        self.wfile.write(
                            b"%x\r\n%s\r\n" % (len(data), data))
                        self.wfile.flush()
                    self.wfile.write(b"0\r\n\r\n")
                except Exception:  # noqa: BLE001 — client went away
                    pass
                finally:
                    payload.lines.close()
                    self.close_connection = True

            def _respond_html(self, code: int, html: str) -> None:
                body = html.encode()
                self.send_response(code)
                self.send_header("Content-Type",
                                 "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _handle(self, method: str) -> None:
                try:
                    parsed = urlparse(self.path)
                    # web console (ui/ in the reference; served from the
                    # agent at /ui like command/agent/http.go UIServer)
                    if method == "GET" and (
                            parsed.path == "/"
                            or parsed.path == "/ui"
                            or parsed.path.startswith("/ui/")):
                        from .ui import INDEX_HTML

                        self._respond_html(200, INDEX_HTML)
                        return
                    query = {k: v[0] for k, v in
                             parse_qs(parsed.query).items()}
                    length = int(self.headers.get("Content-Length") or 0)
                    raw = self.rfile.read(length) if length else b""
                    body = from_json_tree(json.loads(raw)) if raw else None
                    token = self.headers.get("X-Nomad-Token") \
                        or query.get("token")
                    out = api.route(method, parsed.path, query, body,
                                    token=token,
                                    traceparent=self.headers.get(
                                        "traceparent"))
                    if isinstance(out, JsonLineStream):
                        self._stream(out)
                        return
                    self._respond(200, out)
                except HttpError as e:
                    self._respond(e.code, {"error": str(e)})
                except Exception as e:  # noqa: BLE001
                    self._respond(500,
                                  {"error": f"{type(e).__name__}: {e}"})

            def do_GET(self):
                self._handle("GET")

            def do_PUT(self):
                self._handle("PUT")

            def do_POST(self):
                self._handle("PUT")  # reference treats POST as PUT

            def do_DELETE(self):
                self._handle("DELETE")

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        if tls is not None and tls.enabled:
            # HTTPS listener (helper/tlsutil via command/agent/http.go).
            # Deferred handshake: with do_handshake_on_connect the
            # handshake would run inside accept() on the single
            # serve_forever thread, letting one stalled client freeze the
            # whole API; deferring moves it to the per-connection handler
            # thread's first read.
            from ..lib.tlsutil import server_context

            self.httpd.socket = server_context(tls).wrap_socket(
                self.httpd.socket, server_side=True,
                do_handshake_on_connect=False)
        self.tls_enabled = bool(tls is not None and tls.enabled)
        self._tls_cfg = tls
        self.addr = self.httpd.server_address
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="http", daemon=True)
        self._thread.start()
        # advertise the HTTP base URL through gossip so other regions can
        # forward API requests here (serf tags carry addresses in the
        # reference; nomad/server.go:1380). A wildcard bind is not
        # connectable from remote hosts — fall back to the RPC fabric's
        # host, which peers already reach.
        cluster = getattr(self.agent, "cluster", None)
        if cluster is not None and hasattr(cluster, "membership"):
            host = self.addr[0]
            if host in ("0.0.0.0", "::", ""):
                host = cluster.addr[0]
            scheme = "https" if self.tls_enabled else "http"
            cluster.membership.set_tag(
                "http_addr", f"{scheme}://{host}:{self.addr[1]}")

    @staticmethod
    def _service_index(state, ns: str, ns_visible) -> list:
        """Grouped service listing: name + tag union + instance count per
        namespace (api: GET /v1/services)."""
        grouped: Dict[Tuple[str, str], dict] = {}
        for r in state.service_registrations():
            if not ns_visible(r.namespace, "read-job"):
                continue
            g = grouped.setdefault((r.namespace, r.service_name), {
                "namespace": r.namespace, "service_name": r.service_name,
                "tags": [], "count": 0, "passing": 0})
            g["count"] += 1
            if r.status == "passing":
                g["passing"] += 1
            for t in r.tags:
                if t not in g["tags"]:
                    g["tags"].append(t)
        return [grouped[k] for k in sorted(grouped)]

    def _trace_source(self) -> str:
        cluster = getattr(self.agent, "cluster", None)
        if cluster is not None:
            return f"{cluster.config.node_id}.{cluster.config.region}"
        return "self"

    def _traced_submit(self, op: Callable[[], Any],
                       traceparent: Optional[str] = None) -> Tuple[Any, str]:
        """The INGRESS edge of a distributed trace (ISSUE 17): mint the
        trace context — honoring a well-formed inbound W3C `traceparent`
        from the SDK, else a fresh root — bind it to this thread for the
        dynamic extent of the submit (RPC forwarding and the leader's
        `_create_eval` pick it up from the thread-local), and record the
        `http.submit` span. Returns (result, trace_id)."""
        from ..lib import tracectx

        if not tracectx.trace_enabled():
            return op(), ""
        ctx = tracectx.mint(tracectx.parse_traceparent(traceparent))
        t0 = time.time()
        try:
            with tracectx.use(ctx):
                return op(), ctx.trace_id
        finally:
            tracectx.default_spans().record(
                "http.submit", trace_id=ctx.trace_id,
                span_id=ctx.span_id, parent_span_id=ctx.parent_span_id,
                start_unix=t0, end_unix=time.time(),
                source=self._trace_source())

    def _submit_fn(self, server, method: str, *args) -> Callable[[], Any]:
        """Submit callable for the traced ingress endpoints: a clustered
        agent dispatches through `cluster.call`, which invokes locally
        on the leader and leader-forwards over the RPC fabric on a
        follower — the forwarding hop re-injects the trace context from
        the thread-local (rpc/transport.py `ctx` slot). A dev agent
        calls its in-process server directly."""
        cluster = getattr(self.agent, "cluster", None)
        if cluster is not None:
            return lambda: cluster.call(method, *args)
        return lambda: getattr(server, method)(*args)

    def _maybe_multiregion_register(self, server, job, local_region: str,
                                    token: Optional[str]) -> Optional[Any]:
        """Multiregion register decision, shared by both register routes
        (PUT /v1/jobs and PUT /v1/job/<id>). Returns None when the job is
        a plain single-region register.

        Semantics: a submitted multiregion job must leave `region` unset
        (the reference validates the two stanzas as mutually exclusive,
        nomad/structs/structs.go Job.Validate); a copy whose region names
        one of its own blocks is a fan-out product arriving from the
        originating region and registers plainly."""
        mr = job.multiregion
        if mr is None or not mr.regions:
            return None
        names = [r.get("name") for r in mr.regions]
        # a copy stamped with one of its own block names is a fan-out
        # product arriving from the originating region — this check comes
        # FIRST so a region literally named "global" can't re-trigger
        # fan-out (infinite cross-region ping-pong)
        if job.region in names:
            return None
        if job.region in ("", "global"):
            return self._register_multiregion(server, job, local_region,
                                              token)
        raise HttpError(
            400, "multiregion job must not set region "
            f"(got {job.region!r}; blocks: {names})")

    def _register_multiregion(self, server, job, local_region: str,
                              token: Optional[str]) -> Any:
        """Fan a multiregion job out: one region-stamped copy per
        `multiregion.region` block, registered in its region (the
        reference parses the stanza in OSS — jobspec/parse_multiregion.go
        — and deploys per-region copies in ent; this build always
        deploys). A block's count overrides every group count; its
        datacenters/meta override the job's.

        Fan-out is best-effort per region (every block is attempted):
        failures land in the `errors` map instead of aborting regions
        that already committed — the response always reports what
        actually happened where."""
        import copy as _copy

        results = {}
        errors = {}
        local_eval = ""
        for rb in job.multiregion.regions:
            rname = rb.get("name", "")
            jc = _copy.deepcopy(job)
            jc.region = rname
            if rb.get("count"):
                for tg in jc.task_groups:
                    tg.count = int(rb["count"])
            if rb.get("datacenters"):
                jc.datacenters = list(rb["datacenters"])
            if rb.get("meta"):
                jc.meta.update(rb["meta"])
            try:
                if rname == local_region:
                    ev = server.job_register(jc)
                    local_eval = ev.id if ev else ""
                    results[rname] = local_eval
                else:
                    out = self._forward_region(
                        rname, "PUT", "/v1/jobs",
                        {"region": rname, "namespace": jc.namespace},
                        {"job": to_wire(jc)}, token)
                    results[rname] = (out or {}).get("eval_id", "")
            except (HttpError, OSError, ValueError) as e:
                errors[rname] = str(e)
        out = {"eval_id": local_eval, "regions": results}
        if errors:
            out["errors"] = errors
        return out

    def _forward_region(self, region: str, method: str, path: str,
                        query: Dict[str, str], body: Any,
                        token: Optional[str]) -> Any:
        """Proxy the request to an alive server agent of `region`
        (nomad/rpc.go forwardRegion → here an HTTP hop, since the remote
        region's agent serves the identical API)."""
        import random
        import urllib.error
        import urllib.parse
        import urllib.request

        cluster = getattr(self.agent, "cluster", None)
        cands = []
        if cluster is not None:
            from ..server.gossip import STATUS_ALIVE

            cands = [m.tags["http_addr"]
                     for m in cluster.membership.members()
                     if m.region == region and m.status == STATUS_ALIVE
                     and m.tags.get("http_addr")]
        if not cands:
            raise HttpError(500, f"no path to region {region!r}")
        target = random.choice(cands)  # scheme-qualified base URL
        if "://" not in target:
            target = f"http://{target}"
        qs = urllib.parse.urlencode(query)
        url = f"{target}{path}" + (f"?{qs}" if qs else "")
        ssl_ctx = None
        if target.startswith("https://"):
            if self._tls_cfg is None or not self._tls_cfg.enabled:
                raise HttpError(
                    500, f"region {region!r} serves TLS but this agent "
                    "has no tls{} config to dial it with")
            from ..lib.tlsutil import client_context

            ssl_ctx = client_context(self._tls_cfg)
        data = json.dumps(to_json_tree(body)).encode() \
            if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Content-Type", "application/json")
        if token:
            req.add_header("X-Nomad-Token", token)
        try:
            with urllib.request.urlopen(req, timeout=15,
                                        context=ssl_ctx) as resp:
                return json.loads(resp.read() or b"null")
        except urllib.error.HTTPError as e:
            try:
                msg = json.loads(e.read()).get("error", str(e))
            except Exception:  # noqa: BLE001
                msg = str(e)
            raise HttpError(e.code, msg)

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()

    def _require_namespace_cap(self, token, namespace: str,
                               cap: str) -> None:
        """Namespace-capability ACL gate for agent-local client routes
        (enforced only when a token store / server is attached)."""
        if self.agent.server is None:
            return
        from ..acl import ACLError

        try:
            acl = self.agent.server.resolve_token(token)
        except ACLError as e:
            raise HttpError(403, str(e))
        if not acl.allow_namespace_operation(namespace, cap):
            raise HttpError(403, "Permission denied")

    def _require_local(self, token, cap: str) -> None:
        """ACL gate for agent-local routes: enforced when a token store
        (server) is attached; client-only dev agents stay open (the
        /v1/agent/self precedent)."""
        if self.agent.server is None:
            return
        from ..acl import ACLError

        try:
            acl = self.agent.server.resolve_token(token)
        except ACLError as e:
            raise HttpError(403, str(e))
        if not getattr(acl, f"allow_{cap}")():
            raise HttpError(403, "Permission denied")

    # ---- client allocation endpoints (client/alloc_endpoint.go) ----

    def _client_alloc_op(self, alloc_id: str, op: str,
                         query: Dict[str, str], body,
                         token: Optional[str] = None):
        client = self.agent.client
        if client is None:
            raise HttpError(501, "this agent is not running a client")
        runner = client.alloc_runner(alloc_id)
        if runner is None:
            raise HttpError(404, f"alloc {alloc_id!r} not on this agent")
        self._require_namespace_cap(
            token, runner.alloc.namespace,
            {"exec": "alloc-exec", "restart": "alloc-lifecycle",
             "signal": "alloc-lifecycle"}.get(op, "read-job"))
        if op == "stats":
            # Allocations.Stats: per-task driver/executor usage fan-in
            # via the dedicated stats contract (inspect_task is metadata
            # and must stay cheap — docker stats blocks a sample cycle)
            tasks = {}
            for name, tr in runner.task_runners.items():
                usage = {}
                if tr.handle is not None:
                    try:
                        usage = tr.driver.stats_task(tr.handle) or {}
                    except Exception:  # noqa: BLE001 — driver may be dead
                        usage = {}
                tasks[name] = {
                    "ResourceUsage": usage,
                    "Timestamp": int(time.time() * 1e9),
                }
            return {"Tasks": tasks}
        if op == "exec":
            cmd = (body or {}).get("Cmd") or []
            if not cmd:
                raise HttpError(400, "missing Cmd")
            task = query.get("task", "")
            if not task:
                if len(runner.task_runners) != 1:
                    raise HttpError(400, "multiple tasks; pass ?task=")
                task = next(iter(runner.task_runners))
            tr = runner.task_runners.get(task)
            if tr is None or tr.handle is None:
                raise HttpError(404, f"no running task {task!r}")
            try:
                return tr.driver.exec_task(
                    tr.handle, cmd[0], list(cmd[1:]),
                    timeout_s=float(query.get("timeout", 30)))
            except Exception as e:  # noqa: BLE001 — surface driver errors
                raise HttpError(500, f"exec failed: {e}")
        if op == "restart":
            # alloc_endpoint.go Restart (alloc-lifecycle, gated above)
            try:
                n = runner.restart_tasks(
                    (body or {}).get("TaskName", "")
                    or query.get("task", ""))
            except ValueError as e:
                raise HttpError(400, str(e))
            return {"restarted": n}
        if op == "signal":
            # alloc_endpoint.go Signal (alloc-lifecycle, gated above)
            sig = (body or {}).get("Signal") or query.get("signal") \
                or "SIGHUP"
            try:
                n = runner.signal_tasks(
                    sig, (body or {}).get("TaskName", "")
                    or query.get("task", ""))
            except ValueError as e:
                raise HttpError(400, str(e))
            except Exception as e:  # noqa: BLE001 — driver/unknown signal
                raise HttpError(500, f"signal failed: {e}")
            return {"signaled": n}
        raise HttpError(404, f"unknown allocation op {op!r}")

    # ---- client filesystem endpoints (client/fs_endpoint.go) ----

    def _client_fs(self, op: str, alloc_id: str, query: Dict[str, str],
                   token: Optional[str] = None):
        import os

        from ..client.fs import (FsError, fs_list, fs_read_at, fs_stat,
                                 logs_read)

        client = self.agent.client
        if client is None:
            raise HttpError(501, "this agent is not running a client")
        # alloc_id comes off the URL: confine it to one directory level
        # under the allocs root before any filesystem access
        if not re.fullmatch(r"[0-9a-zA-Z-]{1,64}", alloc_id):
            raise HttpError(400, f"invalid alloc id {alloc_id!r}")
        # resolve the alloc for its namespace (ACL scope); unknown allocs
        # are 404 even if a stray directory exists
        alloc = None
        runner = client.alloc_runner(alloc_id)
        if runner is not None:
            alloc = runner.alloc
        elif self.agent.server is not None:
            alloc = self.agent.server.state.alloc_by_id(alloc_id)
        if alloc is None:
            raise HttpError(404, f"alloc {alloc_id!r} not on this agent")
        # ACL: read-fs / read-logs in the ALLOC'S job namespace
        self._require_namespace_cap(
            token, alloc.namespace,
            "read-logs" if op == "logs" else "read-fs")
        root = os.path.join(client.alloc_dir_base, alloc_id)
        if not os.path.isdir(root):
            raise HttpError(404, f"alloc {alloc_id!r} not on this agent")
        path = query.get("path", "/")
        try:
            if op == "ls":
                return fs_list(root, path)
            if op == "stat":
                return fs_stat(root, path)
            if op in ("cat", "readat"):
                offset = int(query.get("offset", 0))
                limit = (int(query["limit"]) if "limit" in query else None)
                data, size = fs_read_at(root, path, offset, limit)
                return {"Data": data, "FileSize": size, "Offset": offset}
            if op == "logs":
                logs_dir = os.path.join(root, "alloc", "logs")
                limit = (int(query["limit"]) if "limit" in query else None)
                if "frame" in query:
                    # stable follow cursor (frames survive rotation reaps)
                    from ..client.fs import logs_read_from

                    data, frame, pos = logs_read_from(
                        logs_dir, task=query.get("task", ""),
                        logtype=query.get("type", "stdout"),
                        frame=int(query["frame"]),
                        pos=int(query.get("pos", 0)), limit=limit)
                    return {"Data": data, "Frame": frame, "Pos": pos}
                data, total = logs_read(
                    logs_dir,
                    task=query.get("task", ""),
                    logtype=query.get("type", "stdout"),
                    offset=int(query.get("offset", 0)),
                    origin=query.get("origin", "start"),
                    limit=limit,
                )
                return {"Data": data, "FileSize": total}
        except FsError as e:
            raise HttpError(e.code, str(e))
        raise HttpError(404, f"unknown fs op {op!r}")

    # ---- routing (http.go:253 registerHandlers) ----

    def route(self, method: str, path: str, query: Dict[str, str],
              body: Any, token: Optional[str] = None,
              traceparent: Optional[str] = None) -> Any:
        parts0 = [p for p in path.split("/") if p]
        if not parts0 or parts0[0] != "v1":
            raise HttpError(404, f"no handler for {path}")
        # agent-local routes work without a server (client-only agents)
        if parts0[1:] == ["agent", "self"]:
            return self.agent.self_info()
        if parts0[1:] == ["metrics"]:
            if query.get("format") == "prometheus":
                # the reference's `telemetry { prometheus_metrics }`
                # exposition, selected by query param like its
                # /v1/metrics?format=prometheus
                return PlainText(self.agent.metrics_prometheus())
            return self.agent.metrics()
        # /v1/client/fs/* — served by the agent hosting the alloc
        # (client/fs_endpoint.go; servers in the reference proxy to the
        # node — here the caller talks to the owning agent directly)
        if parts0[1:2] == ["client"] and parts0[2:3] == ["fs"] \
                and len(parts0) >= 5:
            return self._client_fs(parts0[3], parts0[4], query, token)
        # /v1/client/stats — host statistics (client/stats_endpoint.go;
        # node:read when a token store is attached)
        if parts0[1:] == ["client", "stats"]:
            if self.agent.client is None:
                raise HttpError(501, "this agent is not running a client")
            self._require_local(token, "node_read")
            return self.agent.client.host_stats()
        # /v1/client/allocation/<id>/{exec,stats} — on the hosting agent
        # (client/alloc_endpoint.go Allocations.Exec/Stats)
        if parts0[1:3] == ["client", "allocation"] and len(parts0) >= 5:
            return self._client_alloc_op(parts0[3], parts0[4], query, body,
                                         token)
        # /v1/agent/pprof — runtime profiling surface (agent_endpoint.go
        # AgentPprofRequest; the goroutine dump maps to Python thread
        # stacks here). agent:read like monitor.
        if parts0[1:] == ["agent", "pprof"]:
            self._require_local(token, "agent_read")
            import sys as _sys
            import traceback as _tb

            frames = _sys._current_frames()
            threads = {t.ident: t.name
                       for t in threading.enumerate()}
            dump = []
            for tid, frame in frames.items():
                dump.append({
                    "thread": threads.get(tid, str(tid)),
                    "stack": [ln.rstrip() for ln
                              in _tb.format_stack(frame)],
                })
            return {"threads": dump, "count": len(dump)}
        # /v1/agent/join — add a server to this agent's gossip pool
        # (agent_endpoint.go AgentJoinRequest; agent:write)
        if parts0[1:] == ["agent", "join"] and method in ("PUT", "POST"):
            self._require_local(token, "agent_write")
            cluster0 = getattr(self.agent, "cluster", None)
            if cluster0 is None or not hasattr(cluster0, "membership"):
                raise HttpError(501,
                                "this agent is not a gossiping server")
            address = query.get("address", "")
            # rpartition + bracket strip: "[::1]:4648" and "host:4648"
            host0, _, port0 = address.rpartition(":")
            host0 = host0.strip("[]")
            if not host0 or not port0.isdigit():
                raise HttpError(400, "address must be host:port")
            ok = cluster0.membership.join([(host0, int(port0))])
            return {"num_joined": 1 if ok else 0}
        # /v1/agent/force-leave — mark a gossip member left without
        # waiting for the failure detector (agent_endpoint.go
        # AgentForceLeaveRequest; agent:write)
        if parts0[1:] == ["agent", "force-leave"] \
                and method in ("PUT", "POST"):
            self._require_local(token, "agent_write")
            cluster0 = getattr(self.agent, "cluster", None)
            if cluster0 is None or not hasattr(cluster0, "membership"):
                raise HttpError(501,
                                "this agent is not a gossiping server")
            name = query.get("node", "")
            if not name:
                raise HttpError(400, "missing ?node=")
            try:
                cluster0.membership.force_leave(name)
            except KeyError:
                raise HttpError(404, f"unknown member {name!r}")
            except ValueError as e:
                raise HttpError(400, str(e))
            return {"left": name}
        # /v1/agent/monitor — agent-local log ring (agent_endpoint.go
        # Monitor; agent:read)
        if parts0[1:] == ["agent", "monitor"]:
            self._require_local(token, "agent_read")
            return self.agent.monitor_logs(
                since=float(query.get("since", 0) or 0),
                level=query.get("log_level", ""))
        # /v1/regions + cross-region forwarding (regions_endpoint.go;
        # http.go wrap() forwards any request whose ?region= differs from
        # the local one to a server of that region)
        cluster = getattr(self.agent, "cluster", None)
        local_region = (cluster.config.region if cluster is not None
                        else getattr(getattr(self.agent, "config", None),
                                     "region", "global"))
        if parts0[1:] == ["regions"]:
            return cluster.regions() if cluster is not None \
                else [local_region]
        req_region = query.get("region", "")
        if req_region and req_region != local_region:
            return self._forward_region(req_region, method, path, query,
                                        body, token)
        server = self.agent.server
        if server is None:
            raise HttpError(501,
                            "this agent is not running a server; "
                            "point the CLI/SDK at a server agent")
        state = server.state

        # ---- ACL resolution + enforcement helpers (every endpoint in the
        # reference resolves the token first; nomad/acl.go) ----
        from ..acl import ACLError

        ns_for_acl = query.get("namespace", "default")
        try:
            acl = server.resolve_token(token)
        except ACLError as e:
            raise HttpError(403, str(e))

        def require(ok: bool) -> None:
            if not ok:
                raise HttpError(403, "Permission denied")

        def ns_visible(item_ns: str, cap: str) -> bool:
            """List filter: ?namespace=* spans every namespace the token
            can read (reference wildcard-namespace lists)."""
            if ns_for_acl == "*":
                return acl.allow_namespace_operation(item_ns, cap)
            return item_ns == ns_for_acl

        def require_ns(cap: str) -> None:
            if ns_for_acl != "*":
                require(acl.allow_namespace_operation(ns_for_acl, cap))

        # /v1/acl/* management surface (acl_endpoint.go)
        if parts0[1:2] == ["acl"]:
            return self._acl_routes(server, method, parts0[2:], body, acl)

        def blocking(fetch: Callable) -> Any:
            """index/wait params (http.go parseWait + blocking queries)."""
            min_index = int(query.get("index", 0) or 0)
            wait = min(float(query.get("wait", 0) or 0), 60.0)
            if min_index and wait:
                idx, result = state.blocking_query(
                    lambda snap: fetch(snap), min_index=min_index,
                    timeout=wait)
                return {"index": idx, "data": result}
            idx, result = fetch(state.snapshot())
            return {"index": idx, "data": result}

        ns = query.get("namespace", "default")
        parts = parts0[1:]

        # /v1/jobs
        if parts == ["jobs"]:
            if method == "GET":
                require_ns("list-jobs")
                prefix = query.get("prefix", "")
                return blocking(lambda snap: (
                    snap.index_at,
                    [to_wire(j) for j in snap.jobs()
                     if ns_visible(j.namespace, "list-jobs")
                     and j.id.startswith(prefix)]))
            if method == "PUT":
                job = from_wire(body["job"] if "job" in body else body)
                require(acl.allow_namespace_operation(job.namespace,
                                                      "submit-job"))
                mr_out = self._maybe_multiregion_register(
                    server, job, local_region, token)
                if mr_out is not None:
                    return mr_out
                try:
                    ev, trace_id = self._traced_submit(
                        self._submit_fn(server, "job_register", job),
                        traceparent)
                except ValueError as e:
                    raise HttpError(400, str(e))
                return {"eval_id": ev.id if ev else "",
                        "job_modify_index": job.job_modify_index,
                        "trace_id": trace_id}
        # /v1/jobs/parse — server-side HCL parse (command/agent/
        # job_endpoint.go JobsParseRequest; capability-gated like the
        # reference post-1.2.4 — parsing arbitrary bodies is server CPU)
        if parts == ["jobs", "parse"] and method in ("PUT", "POST"):
            from ..jobspec import parse as parse_hcl_job

            require_ns("submit-job")
            src = (body or {}).get("JobHCL", "")
            if not isinstance(src, str) or not src.strip():
                raise HttpError(400, "missing JobHCL")
            try:
                return to_wire(parse_hcl_job(src))
            except Exception as e:  # noqa: BLE001 — parser raises
                # HclError for syntax but plain ValueError/TypeError/
                # AttributeError for structural mistakes; all are the
                # CLIENT's jobspec, never a server fault
                raise HttpError(400, f"jobspec parse failed: {e}")
        # /v1/job/<id>[/...] — job ids may CONTAIN slashes (dispatched
        # children "<parent>/dispatch-...", periodic children
        # "<parent>/periodic-<ts>"; structs.go:3995): the sub-route is
        # recognized from the path TAIL, everything before it is the id
        # (the reference's mux strips the known suffixes the same way,
        # command/agent/job_endpoint.go JobSpecificRequest)
        if parts and parts[0] == "job" and len(parts) >= 2:
            _job_subs = {"allocations", "evaluations", "deployments",
                         "summary", "plan", "scale", "dispatch",
                         "versions", "revert", "evaluate"}
            rest = parts[1:]
            if len(rest) >= 3 and rest[-2:] == ["periodic", "force"]:
                job_id, sub = "/".join(rest[:-2]), "periodic"
                parts = ["job", job_id, "periodic", "force"]
            elif len(rest) >= 2 and rest[-1] in _job_subs:
                job_id, sub = "/".join(rest[:-1]), rest[-1]
            else:
                job_id, sub = "/".join(rest), ""
            if not sub:
                if method == "GET":
                    require(acl.allow_namespace_operation(ns, "read-job"))
                    job = state.job_by_id(ns, job_id)
                    if job is None:
                        raise HttpError(404, f"job {job_id!r} not found")
                    return to_wire(job)
                if method == "DELETE":
                    require(acl.allow_namespace_operation(ns, "submit-job"))
                    ev = server.job_deregister(ns, job_id)
                    return {"eval_id": ev.id if ev else ""}
                if method == "PUT":  # register under this id
                    job = from_wire(body["job"] if "job" in body else body)
                    require(acl.allow_namespace_operation(job.namespace,
                                                          "submit-job"))
                    mr_out = self._maybe_multiregion_register(
                        server, job, local_region, token)
                    if mr_out is not None:
                        return mr_out
                    try:
                        ev, trace_id = self._traced_submit(
                            self._submit_fn(server, "job_register", job),
                            traceparent)
                    except ValueError as e:
                        raise HttpError(400, str(e))
                    return {"eval_id": ev.id if ev else "",
                            "trace_id": trace_id}
            if sub == "evaluate" and method in ("PUT", "POST"):
                # Job.Evaluate (job_endpoint.go:710) — `nomad job eval`
                require(acl.allow_namespace_operation(ns, "read-job"))
                try:
                    ev, trace_id = self._traced_submit(
                        self._submit_fn(server, "job_evaluate", ns,
                                        job_id),
                        traceparent)
                except ValueError as e:
                    raise HttpError(400, str(e))
                return {"eval_id": ev.id, "trace_id": trace_id}
            if sub == "allocations":
                require(acl.allow_namespace_operation(ns, "read-job"))
                return blocking(lambda snap: (
                    snap.index_at,
                    [to_wire(a) for a in snap.allocs_by_job(ns, job_id)]))
            if sub == "evaluations":
                require(acl.allow_namespace_operation(ns, "read-job"))
                return blocking(lambda snap: (
                    snap.index_at,
                    [to_wire(e) for e in snap.evals_by_job(ns, job_id)]))
            if sub == "deployments":
                require(acl.allow_namespace_operation(ns, "read-job"))
                return blocking(lambda snap: (
                    snap.index_at,
                    [to_wire(d) for d in snap.deployments()
                     if d.job_id == job_id and d.namespace == ns]))
            if sub == "summary":
                require(acl.allow_namespace_operation(ns, "read-job"))
                return self._job_summary(state, ns, job_id)
            if sub == "periodic" and len(parts) > 3 and parts[3] == "force":
                require(acl.allow_namespace_operation(ns, "submit-job"))
                ev = server.periodic.force(ns, job_id)
                if ev is None:
                    raise HttpError(404, "not a periodic job or overlapped")
                return {"eval_id": ev.id}
            if sub == "versions":
                # job history (job_endpoint.go GetJobVersions)
                require(acl.allow_namespace_operation(ns, "read-job"))
                return blocking(lambda snap: (
                    snap.index_at,
                    [to_wire(j) for j
                     in snap.job_versions_by_id(ns, job_id)]))
            if sub == "revert" and method in ("PUT", "POST"):
                # job revert (job_endpoint.go:1069 Revert)
                require(acl.allow_namespace_operation(ns, "submit-job"))
                if (body or {}).get("JobVersion") is None:
                    raise HttpError(400, "missing JobVersion")
                try:
                    ev = server.job_revert(ns, job_id,
                                           int(body["JobVersion"]))
                except ValueError as e:
                    raise HttpError(400, str(e))
                return {"eval_id": ev.id if ev else ""}
            if sub == "dispatch" and method in ("PUT", "POST"):
                # Job.Dispatch (job_endpoint.go:1634; HTTP route
                # command/agent/job_endpoint.go jobDispatchRequest)
                require(acl.allow_namespace_operation(ns, "dispatch-job")
                        or acl.allow_namespace_operation(ns, "submit-job"))
                payload = (body or {}).get("Payload") or b""
                if isinstance(payload, str):
                    import base64
                    import binascii

                    try:
                        payload = base64.b64decode(payload,
                                                   validate=True)
                    except binascii.Error as e:
                        raise HttpError(400, f"bad Payload base64: {e}")
                meta = dict((body or {}).get("Meta") or {})
                try:
                    child, ev = server.job_dispatch(ns, job_id, payload,
                                                    meta)
                except ValueError as e:
                    raise HttpError(400, str(e))
                return {"dispatched_job_id": child.id,
                        "eval_id": ev.id if ev else "",
                        "eval_create_index": state.index.value,
                        "job_create_index": state.index.value}
            if sub == "plan":
                job = from_wire(body["job"] if "job" in body else body)
                require(acl.allow_namespace_operation(job.namespace,
                                                      "submit-job"))
                return self._job_plan(server, job)
            if sub == "scale":
                # Reference: Job.Scale RPC (nomad/job_endpoint.go:969),
                # routed at command/agent/job_endpoint.go jobScale.
                if method == "GET":
                    require(acl.allow_namespace_operation(ns, "read-job")
                            or acl.allow_namespace_operation(
                                ns, "read-job-scaling"))
                    try:
                        return server.job_scale_status(ns, job_id)
                    except ValueError as e:
                        raise HttpError(404, str(e))
                if method in ("PUT", "POST"):
                    require(acl.allow_namespace_operation(ns, "scale-job")
                            or acl.allow_namespace_operation(
                                ns, "submit-job"))
                    target = body.get("Target", {}) or {}
                    group = target.get("Group", "")
                    if body.get("Count") is None:
                        raise HttpError(400, "missing Count")
                    try:
                        ev = server.job_scale(
                            ns, job_id, group, int(body["Count"]),
                            message=body.get("Message", ""))
                    except ValueError as e:
                        raise HttpError(400, str(e))
                    return {"eval_id": ev.id if ev else "",
                            "eval_create_index": state.index.value,
                            "job_modify_index": state.index.value}
        # /v1/nodes
        def node_wire(n):
            # the node identity secret authenticates node RPCs
            # (connect_issue) — never serve it on the read API (the
            # reference redacts structs.Node.SecretID the same way)
            tree = to_wire(n)
            tree.pop("secret_id", None)
            return tree

        if parts == ["nodes"]:
            require(acl.allow_node_read())
            return blocking(lambda snap: (
                snap.index_at, [node_wire(n) for n in snap.nodes()]))
        if parts and parts[0] == "node" and len(parts) >= 2:
            node_id = parts[1]
            sub = parts[2] if len(parts) > 2 else ""
            if not sub and method == "GET":
                require(acl.allow_node_read())
                node = state.node_by_id(node_id)
                if node is None:
                    raise HttpError(404, f"node {node_id!r} not found")
                tree = node_wire(node)
                # live heartbeat-carried device stats (devicemanager
                # stats stream; off-raft telemetry). Heartbeats land on
                # the LEADER, so any non-leader (follower OR ex-leader
                # holding a frozen pre-election map) must ask it; a
                # leadership change loses at most one heartbeat interval.
                if cluster is not None and not cluster.is_leader():
                    try:
                        ds = cluster.call("node_device_stats", node_id)
                    except Exception:  # noqa: BLE001 — telemetry only
                        ds = None
                else:
                    ds = server.node_device_stats(node_id)
                if ds is not None:
                    tree["device_stats"] = ds
                return tree
            if sub == "drain" and method == "PUT":
                require(acl.allow_node_write())
                drain = from_wire(body.get("drain_spec")) if body else None
                evals = server.node_update_drain(node_id, drain)
                return {"eval_ids": [e.id for e in evals]}
            if sub == "eligibility" and method == "PUT":
                require(acl.allow_node_write())
                server.node_update_eligibility(node_id,
                                               body.get("eligibility"))
                return {}
            if sub == "purge" and method in ("PUT", "POST"):
                # Node.Deregister (node_endpoint.go:388)
                require(acl.allow_node_write())
                try:
                    evals = server.node_purge(node_id)
                except ValueError as e:
                    raise HttpError(404, str(e))
                return {"eval_ids": [e.id for e in evals]}
            if sub == "allocations":
                require(acl.allow_node_read())
                return blocking(lambda snap: (
                    snap.index_at,
                    [to_wire(a) for a in snap.allocs_by_node(node_id)]))
        # /v1/allocations, /v1/allocation/<id>
        if parts == ["allocations"]:
            require_ns("read-job")
            return blocking(lambda snap: (
                snap.index_at,
                [to_wire(a) for a in snap._allocs.values()
                 if ns_visible(a.namespace, "read-job")]))
        if parts and parts[0] == "allocation" and len(parts) >= 2:
            require_ns("read-job")
            a = state.alloc_by_id(parts[1])
            if a is None or not acl.allow_namespace_operation(a.namespace,
                                                              "read-job"):
                # a denied id reads exactly like a missing one — no
                # cross-namespace existence oracle
                raise HttpError(404, "alloc not found")
            if len(parts) > 2 and parts[2] == "stop" \
                    and method in ("PUT", "POST"):
                # alloc_endpoint.go:220 Stop (alloc-lifecycle cap)
                require(acl.allow_namespace_operation(
                    a.namespace, "alloc-lifecycle")
                    or acl.allow_namespace_operation(
                        a.namespace, "submit-job"))
                try:
                    ev = server.alloc_stop(a.id)
                except ValueError as e:
                    raise HttpError(400, str(e))
                return {"eval_id": ev.id if ev else ""}
            return to_wire(a)
        # /v1/evaluations, /v1/evaluation/<id>
        if parts == ["evaluations"]:
            require_ns("read-job")
            return blocking(lambda snap: (
                snap.index_at, [to_wire(e) for e in snap.evals()
                                if ns_visible(e.namespace, "read-job")]))
        if parts and parts[0] == "evaluation" and len(parts) >= 2:
            require_ns("read-job")
            e = state.eval_by_id(parts[1])
            if e is None or not acl.allow_namespace_operation(e.namespace,
                                                              "read-job"):
                raise HttpError(404, "eval not found")
            if len(parts) > 2 and parts[2] == "allocations":
                return [to_wire(a) for a
                        in state.allocs_by_job(e.namespace, e.job_id)
                        if a.eval_id == e.id]
            if len(parts) > 2 and parts[2] == "trace":
                # eval-lifecycle spans (lib/trace.py): ordered phases
                # from broker enqueue through ack. Bounded LRU — an
                # evicted trace 404s even though the eval still exists.
                tracer = getattr(server, "tracer", None)
                trace = tracer.get(e.id) if tracer is not None else None
                if trace is None:
                    raise HttpError(
                        404, f"no trace retained for eval {e.id!r}")
                trace["eval_id"] = e.id
                trace["status"] = e.status
                return trace
            if len(parts) > 2 and parts[2] == "placement":
                # Placement explainability (kernel-native AllocMetric):
                # per-alloc attribution for everything this eval placed
                # plus the failed-TG metrics for what it couldn't — the
                # HTTP face of `structs.AllocMetric` (structs.go:9172),
                # state-backed (no LRU: metrics live on allocs/evals)
                placements = [
                    {"alloc_id": a.id, "task_group": a.task_group,
                     "node_id": a.node_id, "node_name": a.node_name,
                     "metrics": to_wire(a.metrics)}
                    for a in state.allocs_by_job(e.namespace, e.job_id)
                    if a.eval_id == e.id]
                return {
                    "eval_id": e.id,
                    "status": e.status,
                    "status_description": e.status_description,
                    "blocked_eval": e.blocked_eval,
                    "failed_tg_allocs": {
                        tg: to_wire(m)
                        for tg, m in (e.failed_tg_allocs or {}).items()},
                    "placements": placements,
                }
            return to_wire(e)
        # /v1/deployments, /v1/deployment/...
        if parts == ["deployments"]:
            require_ns("read-job")
            return blocking(lambda snap: (
                snap.index_at, [to_wire(d) for d in snap.deployments()
                                if ns_visible(d.namespace, "read-job")]))
        if parts and parts[0] == "deployment" and len(parts) >= 2:
            watcher = server.deployments_watcher
            if parts[1] in ("promote", "fail", "pause"):
                if len(parts) < 3:
                    raise HttpError(404, "deployment id required")
                require_ns("submit-job")
                target = state.deployment_by_id(parts[2])
                # authorize against the DEPLOYMENT's namespace, never a
                # caller-chosen query param; a denied id reads as missing
                if target is None or not acl.allow_namespace_operation(
                        target.namespace, "submit-job"):
                    raise HttpError(404, "deployment not found")
                if parts[1] == "pause":
                    watcher.pause(target.id,
                                  bool((body or {}).get("pause", True)))
                    return {}
                action = watcher.promote if parts[1] == "promote" \
                    else watcher.fail
                ev = action(target.id)
                return {"eval_id": ev.id if ev else ""}
            require_ns("read-job")
            d = state.deployment_by_id(parts[1])
            if d is None or not acl.allow_namespace_operation(d.namespace,
                                                              "read-job"):
                raise HttpError(404, "deployment not found")
            return to_wire(d)
        # /v1/status/*
        if parts == ["status", "leader"]:
            cluster = getattr(self.agent, "cluster", None)
            if cluster is not None:
                return cluster.raft.leader()
            return "self"
        if parts == ["status", "peers"]:
            cluster = getattr(self.agent, "cluster", None)
            if cluster is not None:
                return {pid: list(addr) for pid, addr
                        in cluster.peers_snapshot().items()}
            return {}
        # /v1/agent/*
        if parts == ["agent", "members"]:
            require(acl.allow_agent_read())
            cluster = getattr(self.agent, "cluster", None)
            if cluster is not None and hasattr(cluster, "membership"):
                # live gossip view: status + incarnation per member
                return {"members": [
                    {"name": m.name, "addr": list(m.addr),
                     "status": m.status, "incarnation": m.incarnation,
                     "tags": dict(m.tags)}
                    for m in cluster.membership.members()]}
            peers = (cluster.peers_snapshot()
                     if cluster is not None else {})
            return {"members": [{"name": pid, "addr": list(addr),
                                 "status": "alive"}
                                for pid, addr in peers.items()]}
        # /v1/system/gc
        if parts == ["system", "gc"] and method == "PUT":
            require(acl.allow_operator_write())
            server.run_gc("force-gc")
            return {}
        # /v1/operator/snapshot — full-state archive save/restore
        # (nomad/operator_endpoint.go SnapshotSave/SnapshotRestore,
        # helper/snapshot)
        if parts == ["operator", "snapshot"]:
            import msgpack

            from ..server.fsm import restore_state, snapshot_state

            if method == "GET":
                require(acl.allow_operator_read())
                with state.transact():  # quiescent store while serializing
                    blob = msgpack.packb(snapshot_state(state),
                                         use_bin_type=True)
                return {"Data": blob, "Index": state.index.value}
            if method == "PUT":
                require(acl.allow_operator_write())
                blob = body.get("Data") if isinstance(body, dict) else None
                if not blob:
                    raise HttpError(400, "missing Data")
                tree = msgpack.unpackb(blob, raw=False, strict_map_key=False)
                # flush broker/blocked queues BEFORE restore (SetEnabled
                # false→true, eval_broker.go precedent): pre-restore evals
                # must not be dispatched against the restored state
                server.broker.set_enabled(False)
                server.blocked.set_enabled(False)
                with state.transact():
                    restore_state(state, tree)
                server.broker.set_enabled(True)
                server.blocked.set_enabled(True)
                server._restore_evals()  # pending evals re-enter the broker
                return {"Index": state.index.value}
        # /v1/connect/intentions — mesh source→destination allow/deny
        # (Consul intentions analog; enforced by destination sidecars)
        if parts == ["connect", "intentions"]:
            if method == "GET":
                require(acl.allow_operator_read())
                # CamelCase like every other wire surface — GET output
                # must round-trip into PUT
                return [{"Source": r["source"],
                         "Destination": r["destination"],
                         "Action": r["action"]}
                        for r in server.connect_intentions_list()]
            if method in ("PUT", "POST"):
                require(acl.allow_operator_write())
                b = body or {}
                try:
                    server.connect_intention_upsert(
                        str(b.get("Source", b.get("source", ""))),
                        str(b.get("Destination",
                                  b.get("destination", ""))),
                        str(b.get("Action", b.get("action", ""))))
                except ValueError as e:
                    raise HttpError(400, str(e))
                return {"updated": True}
            if method == "DELETE":
                require(acl.allow_operator_write())
                try:
                    server.connect_intention_delete(
                        query.get("source", ""),
                        query.get("destination", ""))
                except ValueError as e:
                    raise HttpError(400, str(e))
                return {"deleted": True}
        # /v1/operator/scheduler/configuration
        if parts == ["operator", "scheduler", "configuration"]:
            if method == "GET":
                require(acl.allow_operator_read())
                return to_wire(state.scheduler_config())
            if method == "PUT":
                require(acl.allow_operator_write())
                state.set_scheduler_config(from_wire(body))
                return {"updated": True}
        # /v1/operator/autopilot/{configuration,health}
        # (operator_endpoint.go AutopilotGetConfiguration :240,
        # AutopilotSetConfiguration :270, ServerHealth :300)
        if parts == ["operator", "autopilot", "configuration"]:
            if method == "GET":
                require(acl.allow_operator_read())
                return to_wire(state.autopilot_config())
            if method == "PUT":
                require(acl.allow_operator_write())
                state.set_autopilot_config(from_wire(body))
                return {"updated": True}
        if parts == ["operator", "autopilot", "health"]:
            require(acl.allow_operator_read())
            if cluster is not None:
                return cluster.autopilot.server_health()
            # single-server dev agent: trivially healthy
            return {"healthy": True, "failure_tolerance": 0,
                    "servers": [{"id": "self", "address": "local",
                                 "leader": True, "voter": True,
                                 "healthy": True}]}
        # /v1/operator/raft/{configuration,peer}
        # (operator_endpoint.go RaftGetConfiguration :33,
        # RaftRemovePeerByID :120)
        if parts == ["operator", "raft", "configuration"]:
            require(acl.allow_operator_read())
            if cluster is None:
                return {"servers": [{"id": "self", "address": "local",
                                     "leader": True, "voter": True}],
                        "index": state.index.value}
            leader = cluster.raft.leader() or ""
            return {"servers": [
                {"id": pid, "address": f"{a[0]}:{a[1]}",
                 "leader": pid == leader, "voter": True}
                for pid, a in sorted(
                    cluster.raft.peers_snapshot().items())],
                "index": state.index.value}
        if parts == ["operator", "raft", "peer"] and method == "DELETE":
            require(acl.allow_operator_write())
            if cluster is None:
                raise HttpError(400, "not a raft cluster member")
            peer_id = query.get("id", "")
            if not peer_id:
                raise HttpError(400, "missing ?id=")
            from ..raft import NotLeaderError

            try:
                cluster.raft.remove_peer(peer_id)
            except ValueError as e:
                raise HttpError(400, str(e))
            except NotLeaderError as e:
                raise HttpError(400, f"not the leader: {e}")
            return {"removed": peer_id}
        # /v1/scaling/policies + /v1/scaling/policy/<id>
        # (command/agent/scaling_endpoint.go; state/schema.go:793)
        if parts == ["scaling", "policies"]:
            require(acl.allow_namespace_operation(ns, "list-scaling-policies")
                    or acl.allow_namespace_operation(ns, "read-job"))
            return blocking(lambda snap: (
                snap.index_at,
                [to_wire(sp) for sp in server.scaling_policies()
                 if ns_visible(sp.target.get("Namespace", "default"),
                               "read-job")]))
        if parts and parts[0] == "scaling" and len(parts) >= 3 \
                and parts[1] == "policy":
            sp = server.scaling_policy(parts[2])
            if sp is None:
                raise HttpError(404, f"scaling policy {parts[2]!r} not found")
            require(acl.allow_namespace_operation(
                sp.target.get("Namespace", "default"), "read-job"))
            return to_wire(sp)
        if parts == ["volumes"]:
            require_ns("csi-list-volume")
            return blocking(lambda snap: (
                snap.index_at,
                [to_wire(v) for v in snap.csi_volumes()
                 if ns_visible(v.namespace, "csi-list-volume")]))
        if parts and parts[0] == "volume" and len(parts) >= 3 \
                and parts[1] == "csi":
            vol_id = parts[2]
            if method == "GET":
                require_ns("csi-read-volume")
                vol = state.csi_volume(ns, vol_id)
                if vol is None:
                    raise HttpError(404, "volume not found")
                return to_wire(vol)
            if method == "PUT":
                if len(parts) > 3 and parts[3] == "claim":
                    require(acl.allow_namespace_operation(
                        ns, "csi-mount-volume"))
                    ok = server.csi_volume_claim(
                        ns, vol_id, body["alloc_id"], body.get("mode",
                                                               "write"))
                    if not ok:
                        raise HttpError(409, "claim rejected")
                    return {}
                require(acl.allow_namespace_operation(
                    ns, "csi-write-volume"))
                vol = from_wire(body)
                server.csi_volume_register(vol)
                return {}
            if method == "DELETE":
                require(acl.allow_namespace_operation(
                    ns, "csi-write-volume"))
                server.csi_volume_deregister(
                    ns, vol_id, force=query.get("force") == "true")
                return {}
        if parts == ["plugins"]:
            require(acl.allow_plugin_read() or acl.management)
            return [to_wire(p) for p in state.csi_plugins()]
        if parts == ["scaling", "policies"]:
            require_ns("list-scaling-policies")
            return [to_wire(p) for p in server.scaling_policies(
                None if ns_for_acl == "*" else ns_for_acl)]
        # /v1/namespaces + /v1/namespace[/<name>] (namespace_endpoint.go;
        # writes are management-token-only like the reference)
        if parts == ["namespaces"]:
            return blocking(lambda snap: (
                snap.index_at,
                [to_wire(n) for n in snap.namespaces()
                 if acl.management
                 or acl.allow_namespace_operation(n.name, "read-job")]))
        if parts and parts[0] == "namespace":
            if parts[1:] == [] and method in ("PUT", "POST"):
                require(acl.management)
                from ..structs.operator import Namespace

                if isinstance(body, dict) and "__t" in body:
                    try:
                        nsobj = from_wire(body)
                    except Exception as e:  # unknown tag / bad shape
                        raise HttpError(400, f"bad namespace body: {e}")
                    if not isinstance(nsobj, Namespace):
                        raise HttpError(
                            400, f"expected Namespace, got "
                            f"{type(nsobj).__name__}")
                else:
                    nsobj = Namespace(
                        name=str((body or {}).get("Name", "")),
                        description=str((body or {}).get(
                            "Description", "")),
                        quota=str((body or {}).get("Quota", "")),
                        meta=dict((body or {}).get("Meta") or {}))
                try:
                    server.namespace_upsert(nsobj)
                except ValueError as e:
                    raise HttpError(400, str(e))
                return {"updated": True}
            if len(parts) == 2:
                name = parts[1]
                if method == "GET":
                    require(acl.management
                            or acl.allow_namespace_operation(
                                name, "read-job"))
                    nsobj = state.namespace_by_name(name)
                    if nsobj is None:
                        raise HttpError(404,
                                        f"namespace {name!r} not found")
                    return to_wire(nsobj)
                if method == "DELETE":
                    require(acl.management)
                    try:
                        server.namespace_delete(name)
                    except ValueError as e:
                        raise HttpError(400, str(e))
                    return {"deleted": True}
        # /v1/validate/job (command/agent/job_endpoint.go ValidateJobRequest)
        if parts == ["validate", "job"] and method in ("PUT", "POST"):
            from ..structs.job import Job as _Job

            try:
                job = from_wire(body["job"] if "job" in (body or {})
                                else body)
            except Exception as e:  # unknown tag / bad shape
                raise HttpError(400, f"bad job body: {e}")
            if not isinstance(job, _Job):
                raise HttpError(400, f"expected Job, got "
                                f"{type(job).__name__}")
            # same capability as the register path (Job.Validate RPC)
            require(acl.allow_namespace_operation(job.namespace,
                                                  "submit-job"))
            err = job.validate()
            warnings = []
            if state.namespace_by_name(job.namespace) is None:
                warnings.append(
                    f"namespace {job.namespace!r} does not exist")
            return {"valid": not err, "error": err or "",
                    "warnings": warnings}
        # /v1/quotas + /v1/quota[/<name>] + /v1/quota/usage/<name>
        # (the ent reference's quota API shape; management-gated writes)
        if parts == ["quotas"]:
            # quota specs span namespaces: operator-read gated (vs the
            # per-namespace filtering of /v1/namespaces)
            require(acl.management or acl.allow_operator_read())
            return blocking(lambda snap: (
                snap.index_at, [to_wire(q) for q in snap.quotas()]))
        if parts and parts[0] == "quota":
            if parts[1:] == [] and method in ("PUT", "POST"):
                require(acl.management)
                from ..structs.operator import QuotaSpec

                try:
                    if isinstance(body, dict) and "__t" in body:
                        try:
                            qobj = from_wire(body)
                        except Exception as e:  # unknown tag/bad shape
                            raise HttpError(400,
                                            f"bad quota body: {e}")
                        if not isinstance(qobj, QuotaSpec):
                            raise HttpError(
                                400, f"expected QuotaSpec, got "
                                f"{type(qobj).__name__}")
                    else:
                        qobj = QuotaSpec(
                            name=str((body or {}).get("Name", "")),
                            description=str((body or {}).get(
                                "Description", "")),
                            cpu=int((body or {}).get("Cpu", 0) or 0),
                            memory_mb=int((body or {}).get(
                                "MemoryMB", 0) or 0))
                    server.quota_upsert(qobj)
                except ValueError as e:
                    raise HttpError(400, str(e))
                return {"updated": True}
            if len(parts) == 3 and parts[1] == "usage":
                require(acl.management or acl.allow_operator_read())
                if state.quota_by_name(parts[2]) is None:
                    raise HttpError(404, f"quota {parts[2]!r} not found")
                return server.quota_usage(parts[2])
            if len(parts) == 2:
                name = parts[1]
                if method == "GET":
                    require(acl.management or acl.allow_operator_read())
                    q = state.quota_by_name(name)
                    if q is None:
                        raise HttpError(404,
                                        f"quota {name!r} not found")
                    return to_wire(q)
                if method == "DELETE":
                    require(acl.management)
                    try:
                        server.quota_delete(name)
                    except ValueError as e:
                        raise HttpError(400, str(e))
                    return {"deleted": True}
        # /v1/secrets + /v1/secret/<path...> — built-in KV secrets engine
        # (the Vault analog; structs/secrets.py). Values only flow to
        # tokens holding the secrets capabilities.
        if parts == ["secrets"] or (parts and parts[0] == "secret"):
            # require_ns is a no-op for ?namespace=* (list routes filter
            # per item instead) — secrets have no per-item filter, so a
            # wildcard would bypass the ACL entirely; demand a concrete
            # namespace
            if ns == "*":
                raise HttpError(400,
                                "secrets require a concrete namespace")
            # reserved framework namespaces (the mesh CA key lives at
            # nomad/connect:ca) — the GET/list legs below read state
            # directly, so the server-method guard alone would not
            # cover them (Server._check_secret_ns)
            if ns.startswith("nomad/"):
                raise HttpError(403, f"namespace {ns!r} is reserved")
        if parts == ["secrets"]:
            require_ns("secrets-read")
            return blocking(lambda snap: (
                snap.index_at,
                [{"path": e.path, "version": e.version,
                  "keys": sorted(e.data)}
                 for e in snap.secrets_list(ns)]))
        if parts and parts[0] == "secret" and len(parts) >= 2:
            spath = "/".join(parts[1:])
            if method == "GET":
                require_ns("secrets-read")
                e = state.secret_get(ns, spath)
                if e is None:
                    raise HttpError(404, f"secret {spath!r} not found")
                return to_wire(e)
            if method in ("PUT", "POST"):
                require_ns("secrets-write")
                from ..structs.secrets import SecretEntry

                data = (body or {}).get("Data", body) or {}
                if not isinstance(data, dict) or not all(
                        isinstance(k, str) for k in data):
                    raise HttpError(400, "Data must be a string map")
                try:
                    server.secret_upsert(SecretEntry(
                        namespace=ns, path=spath,
                        data={k: str(v) for k, v in data.items()}))
                except ValueError as e:
                    raise HttpError(400, str(e))
                return {"updated": True}
            if method == "DELETE":
                require_ns("secrets-write")
                server.secret_delete(ns, spath)
                return {"deleted": True}
        # /v1/services + /v1/service/<name> — native service discovery
        # (the Consul catalog analog; Nomad's own later
        # service_registration HTTP API has the same shape)
        if parts == ["services"]:
            require_ns("read-job")
            return blocking(lambda snap: (
                snap.index_at,
                self._service_index(snap, ns, ns_visible)))
        if parts and parts[0] == "service" and len(parts) >= 2:
            require_ns("read-job")
            if method == "GET":
                return blocking(lambda snap: (
                    snap.index_at,
                    [to_wire(r) for r
                     in snap.services_by_name(ns, parts[1])]))
        if parts == ["search"] and method == "PUT":
            b = body or {}
            # per-context results are namespace-scoped reads
            require_ns("read-job")
            return server.search(b.get("prefix", ""),
                                 b.get("context", "all"), ns)
        # /v1/event/stream — the FSM-sourced cluster event stream
        # (nomad/stream/event_broker.go + event_endpoint.go). Two modes:
        # the long-poll compat shape (one {"index", "events"} response),
        # and ?stream=1 — chunked transfer, one JSON line per batch,
        # heartbeat keepalives while idle, resume via &index=N (a
        # lost-gap marker leads when N has been evicted).
        if parts == ["event", "stream"]:
            topics = [t for t in query.get("topic", "").split(",") if t]
            try:
                wait = min(float(query.get("wait", 0) or 0), 60.0)
                resume = (int(query["index"]) if "index" in query
                          else None)
            except ValueError as e:
                raise HttpError(400, f"index/wait must be numeric: {e}")
            if query.get("stream") == "1":
                try:
                    heartbeat = min(max(float(
                        query.get("heartbeat", 10) or 10), 0.2), 60.0)
                except ValueError as e:
                    raise HttpError(
                        400, f"heartbeat must be numeric: {e}")
                try:
                    sub = server.events.subscribe(
                        topics or None, from_index=resume)
                except ValueError as e:
                    raise HttpError(400, str(e))
                return JsonLineStream(
                    _event_stream_lines(sub, heartbeat))
            try:
                idx, events = server.events.events_after(
                    resume or 0, topics or None, timeout=wait)
            except ValueError as e:
                raise HttpError(400, str(e))
            return {"index": idx,
                    "events": [to_wire(e) for e in events]}
        # /v1/scheduler/timeline — dispatch-pipeline records
        # (lib/transfer.DispatchTimeline): index long-poll exactly like
        # /v1/event/stream; ?summary=1 returns the aggregate view only.
        # Operator-read gated like the other scheduler internals.
        if parts == ["scheduler", "timeline"]:
            require(acl.allow_operator_read())
            timeline = getattr(server, "timeline", None)
            if timeline is None:
                raise HttpError(501, "this server records no timeline")
            if query.get("summary") == "1":
                return {"index": timeline.last_index(),
                        "summary": timeline.summary()}
            index = int(query.get("index", 0) or 0)
            wait = min(float(query.get("wait", 0) or 0), 60.0)
            idx, recs = timeline.records_after(index, timeout=wait)
            return {"index": idx, "dispatches": recs}
        # /v1/operator/hbm — device-buffer residency (lib/hbm.py):
        # summary + per-site + per-shard breakdown, the allocator
        # cross-check, ?watermarks=1 for lease ages, and the mesh
        # capacity planner (?plan=1&nodes=N&allocs=M). Operator-read
        # gated like the other scheduler internals.
        if parts == ["operator", "hbm"]:
            require(acl.allow_operator_read())
            from ..lib import hbm as hbm_mod

            ledger = hbm_mod.default_hbm()
            out = {
                "summary": ledger.summary(),
                "sites": ledger.snapshot(),
                "shards": ledger.shards(),
                "reconciliation": hbm_mod.reconcile(ledger),
            }
            if query.get("watermarks") == "1":
                out["leases"] = ledger.leases()
            if query.get("plan") == "1":
                try:
                    nodes = int(query["nodes"])
                    allocs = int(query["allocs"])
                    out["plan"] = hbm_mod.plan_capacity(nodes, allocs,
                                                        ledger)
                except (KeyError, ValueError) as e:
                    raise HttpError(
                        400, f"plan needs integer nodes > 0 and "
                             f"allocs >= 0: {e}")
            return out
        # /v1/trace/<trace_id> — THIS process's retained spans of one
        # distributed trace (lib/tracectx.py SpanStore). Index long-poll
        # exactly like /v1/operator/flight; a single server only holds
        # its own hops — `nomad trace` stitches the full causal tree by
        # asking every gossip-discovered server.
        if parts and parts[0] == "trace":
            require(acl.allow_operator_read())
            if len(parts) != 2 or not parts[1]:
                raise HttpError(404, "trace id required")
            from ..lib.tracectx import default_spans

            spans = default_spans()
            try:
                index = int(query.get("index", 0) or 0)
                wait = min(float(query.get("wait", 0) or 0), 60.0)
            except ValueError as e:
                raise HttpError(400, f"index/wait must be numeric: {e}")
            idx, recs = spans.spans_after(index, trace_id=parts[1],
                                          timeout=wait)
            return {"trace_id": parts[1], "index": idx, "spans": recs}
        # /v1/operator/flight — the control-plane flight recorder
        # (lib/flight.py): leadership changes, plan rejections, error
        # streaks, stuck leases, wave-collision spikes, membership
        # churn, heartbeat losses. Index long-poll exactly like
        # /v1/event/stream; ?type= filters on the closed vocabulary.
        if parts == ["operator", "flight"]:
            require(acl.allow_operator_read())
            from ..lib.flight import default_flight

            fr = default_flight()
            try:
                index = int(query.get("index", 0) or 0)
                wait = min(float(query.get("wait", 0) or 0), 60.0)
            except ValueError as e:
                raise HttpError(400, f"index/wait must be numeric: {e}")
            types = [t for t in (query.get("type", "") or "").split(",")
                     if t] or None
            idx, events = fr.records_after(index, types=types,
                                           timeout=wait)
            return {"index": idx, "events": events,
                    "counts": fr.counts()}
        # /v1/operator/debug — one server's capture of EVERY diagnostic
        # surface in a single response (command/operator_debug.go's
        # per-agent capture half; the CLI aggregates this across the
        # reachable servers into the bundle)
        if parts == ["operator", "debug"]:
            require(acl.allow_operator_read())
            return self._operator_debug(server)
        raise HttpError(404, f"no handler for {method} {path}")

    def _operator_debug(self, server) -> Dict[str, Any]:
        """Assemble the per-server debug capture. Every key of
        api.client.DEBUG_SECTIONS must be present — the CLI writes one
        bundle file per section and the e2e capture test pins the set.
        Tolerates facade agents (a bare ClusterServer behind HTTPApi in
        tests) that lack the full Agent surface."""
        import time as _time

        from ..api.client import DEBUG_SECTIONS
        from ..lib.flight import default_flight
        from ..lib.hbm import default_hbm
        from ..lib.transfer import default_ledger

        agent = self.agent
        cluster = getattr(agent, "cluster", None)
        out: Dict[str, Any] = {"captured_unix": round(_time.time(), 3)}
        out["server"] = {
            "node_id": (cluster.config.node_id if cluster is not None
                        else "self"),
            "region": (cluster.config.region if cluster is not None
                       else getattr(getattr(agent, "config", None),
                                    "region", "global")),
            "leader": (cluster.is_leader() if cluster is not None
                       else True),
            "state_index": server.state.index.value,
        }
        metrics_fn = getattr(agent, "metrics", None)
        if callable(metrics_fn):
            # Agent.metrics() already computes the control rollup —
            # reuse it instead of re-scanning the broker queues (this
            # endpoint is read precisely when the control plane is
            # under pressure; don't triple the lock hold time)
            out["metrics"] = metrics_fn()
            out["control"] = (out["metrics"].get("control")
                              or server.control_plane_stats())
        else:
            out["metrics"] = {"telemetry": server.metrics.snapshot()}
            out["control"] = server.control_plane_stats()
        prom_fn = getattr(agent, "metrics_prometheus", None)
        out["prometheus"] = (prom_fn() if callable(prom_fn)
                             else server.metrics.prometheus())
        timeline = getattr(server, "timeline", None)
        if timeline is not None:
            _, recs = timeline.records_after(0)
            out["timeline"] = {"summary": timeline.summary(),
                               "dispatches": recs}
        else:
            out["timeline"] = {"summary": {}, "dispatches": []}
        out["transfer_sites"] = default_ledger().snapshot()
        hbm = default_hbm()
        out["hbm"] = {"summary": hbm.summary(), "sites": hbm.snapshot()}
        snap = server.metrics.snapshot()
        out["drain"] = {
            "counters": {k: v for k, v in
                         (snap.get("counters") or {}).items()
                         if k.startswith(("drain.", "wave."))},
            "histograms": {k: v for k, v in
                           (snap.get("histograms") or {}).items()
                           if k.startswith(("drain.", "wave."))},
        }
        fr = default_flight()
        out["flight"] = {"index": fr.last_index(),
                         "events": fr.snapshot(limit=256),
                         "counts": fr.counts()}
        if cluster is not None:
            out["raft"] = {"status": cluster.raft.status(),
                           "metrics": cluster.raft.metrics.snapshot()}
            out["wal"] = {"mode": "raft-journal",
                          "log_bytes": out["raft"]["status"]["log_bytes"],
                          "snapshot_index":
                              out["raft"]["status"]["snapshot_index"]}
        else:
            out["raft"] = {"mode": "single-server"}
            wal = getattr(server.state, "wal", None)
            out["wal"] = (wal.status() if wal is not None
                          else {"mode": "memory"})
        tracer = getattr(server, "tracer", None)
        traces: Dict[str, Any] = {}
        if tracer is not None:
            for tid in tracer.trace_ids()[-32:]:
                tr = tracer.get(tid)
                if tr is not None:
                    traces[tid] = tr
        out["eval_traces"] = traces
        # distributed-trace + SLO capture (ISSUE 17): this process's
        # span ring (flight-recorder shape) and the per-band SLO state,
        # so a bundle taken during an incident carries the causal
        # waterfalls AND the budget picture without a live cluster
        from ..lib.tracectx import default_spans

        sp = default_spans()
        slo = getattr(server, "slo", None)
        out["trace"] = {
            "index": sp.last_index(),
            "spans": sp.snapshot(limit=256),
            "counts": sp.counts(),
            "slo": (slo.snapshot() if slo is not None else {}),
        }
        # cluster event stream (ISSUE 18): broker health + the recent
        # tail, so a bundle shows WHAT the cluster just did (state
        # transitions) next to the flight recorder's WHY (operational
        # anomalies)
        ev = getattr(server, "events", None)
        if ev is not None and hasattr(ev, "stats"):
            out["events"] = {
                "stats": ev.stats(),
                "recent": [to_wire(e) for e in ev.buffered(limit=256)],
            }
        else:
            out["events"] = {"stats": {}, "recent": []}
        missing = [s for s in DEBUG_SECTIONS if s not in out]
        assert not missing, f"debug sections missing: {missing}"
        return out

    # ---- /v1/acl/* (acl_endpoint.go) ----

    @staticmethod
    def _acl_routes(server, method: str, parts: List[str], body: Any,
                    acl) -> Any:
        """Mutations go through the state-store write API (journaled /
        replicated); ids are generated HERE so replay indexes identical
        tokens. Client errors map to 400, not 500."""
        import time as _time
        import uuid as _uuid

        from ..acl import ACLError, ACLPolicy, ACLToken, new_management_token
        from ..jobspec.hcl import HclError

        state = server.state
        store = server.acl

        def require_mgmt() -> None:
            if not acl.management:
                raise HttpError(403, "Permission denied")

        try:
            if parts == ["bootstrap"] and method == "PUT":
                # one-shot, token-less (acl_endpoint.go:64)
                if store.bootstrapped:
                    raise HttpError(400, "ACL bootstrap already done")
                token = new_management_token("Bootstrap Token")
                state.acl_bootstrap(token)
                return to_wire(token)
            if parts == ["policies"] and method == "GET":
                require_mgmt()
                return [to_wire(p) for p in store.policies()]
            if parts and parts[0] == "policy" and len(parts) == 2:
                require_mgmt()
                name = parts[1]
                if method == "GET":
                    p = store.policy(name)
                    if p is None:
                        raise HttpError(404, f"policy {name!r} not found")
                    return to_wire(p)
                if method == "PUT":
                    state.upsert_acl_policy(ACLPolicy(
                        name=name,
                        description=(body or {}).get("description", ""),
                        rules=(body or {}).get("rules", "")))
                    return {}
                if method == "DELETE":
                    state.delete_acl_policy(name)
                    return {}
            if parts == ["tokens"] and method == "GET":
                require_mgmt()
                return [to_wire(t) for t in store.tokens()]
            if parts == ["token"] and method == "PUT":
                require_mgmt()
                b = body or {}
                token = from_wire(b) if b.get("__t") else ACLToken(
                    name=b.get("name", ""),
                    type=b.get("type", "client"),
                    policies=list(b.get("policies", [])))
                if not token.accessor_id:
                    token.accessor_id = str(_uuid.uuid4())
                if not token.secret_id:
                    token.secret_id = str(_uuid.uuid4())
                if not token.create_time:
                    token.create_time = _time.time()
                state.upsert_acl_token(token)
                return to_wire(token)
            if parts and parts[0] == "token" and len(parts) == 2:
                require_mgmt()
                if method == "GET":
                    t = store.token_by_accessor(parts[1])
                    if t is None:
                        raise HttpError(404, "token not found")
                    return to_wire(t)
                if method == "DELETE":
                    state.delete_acl_token(parts[1])
                    return {}
        except (ACLError, HclError) as e:
            raise HttpError(400, str(e))
        raise HttpError(404, f"no ACL handler for {method} {parts}")

    # ---- composed handlers ----

    @staticmethod
    def _job_summary(state, ns: str, job_id: str) -> Dict[str, Any]:
        """JobSummary (structs.JobSummary): per-group alloc status counts."""
        job = state.job_by_id(ns, job_id)
        if job is None:
            raise HttpError(404, f"job {job_id!r} not found")
        groups: Dict[str, Dict[str, int]] = {}
        for tg in job.task_groups:
            groups[tg.name] = {"queued": 0, "starting": 0, "running": 0,
                               "complete": 0, "failed": 0, "lost": 0}
        for a in state.allocs_by_job(ns, job_id):
            g = groups.setdefault(a.task_group, {})
            key = {"pending": "starting"}.get(a.client_status,
                                             a.client_status)
            g[key] = g.get(key, 0) + 1
        return {"job_id": job_id, "namespace": ns, "summary": groups}

    @staticmethod
    def _job_plan(server, job) -> Dict[str, Any]:
        """Dry-run scheduling (Job.Plan, nomad/job_endpoint.go:1626): run
        the scheduler against an ISOLATED snapshot — the harness applies
        the plan to the snapshot only, and the cluster tensors are copied
        so the live kernels never see the what-if placement."""
        from ..scheduler.harness import Harness
        from ..structs import Evaluation
        from ..structs.connect import inject_sidecars, validate_connect

        # same admission mutation as Register: the plan must reflect
        # the connect sidecar tasks/ports the real register would add
        cerr = validate_connect(job)
        if cerr:
            raise HttpError(400, cerr)
        inject_sidecars(job)
        snap = server.state.snapshot().detach_for_writes()
        # the what-if runs where the server places: the harness would
        # otherwise default to the card
        h = Harness(state=snap, device=server.device)
        snap.upsert_job(job)
        ev = Evaluation(namespace=job.namespace, job_id=job.id,
                        type=job.type, priority=job.priority,
                        triggered_by="job-register", status="pending")
        h.process(ev)
        plan = h.plans[-1] if h.plans else None
        failed = {}
        for e in h.evals:
            for tg, m in (e.failed_tg_allocs or {}).items():
                failed[tg] = {"nodes_evaluated": m.nodes_evaluated,
                              "nodes_filtered": m.nodes_filtered,
                              "nodes_exhausted": m.nodes_exhausted}
        old = server.state.job_by_id(job.namespace, job.id)
        return {
            "placements": 0 if plan is None else sum(
                len(v) for v in plan.node_allocation.values()),
            "stops": 0 if plan is None else sum(
                len(v) for v in plan.node_update.values()),
            "failed_tg_allocs": failed,
            "diff": _job_diff(old, job),
        }


def _scalar_diff(old, new, fields) -> list:
    """Changed plain fields between two structs (None-tolerant)."""
    out = []
    for f in fields:
        ov = getattr(old, f, None) if old is not None else None
        nv = getattr(new, f, None) if new is not None else None
        if ov != nv:
            out.append({"name": f, "old": ov, "new": nv})
    return out


def _job_diff(old, new) -> dict:
    """Structured spec diff for `job plan` output (the reference's
    nomad/structs/diff.go Job.Diff, rendered by command/job_plan.go).
    Three levels: job fields, task groups by name, tasks by name."""
    if old is None:
        return {"type": "Added", "fields": [],
                "groups": [{"name": tg.name, "type": "Added",
                            "fields": [], "tasks": []}
                           for tg in new.task_groups]}
    jf = _scalar_diff(old, new, ["type", "priority", "region",
                                 "datacenters", "all_at_once", "meta"])
    groups = []
    old_tgs = {tg.name: tg for tg in old.task_groups}
    new_tgs = {tg.name: tg for tg in new.task_groups}
    for name in sorted(set(old_tgs) | set(new_tgs)):
        og, ng = old_tgs.get(name), new_tgs.get(name)
        if og is None or ng is None:
            groups.append({"name": name,
                           "type": "Added" if og is None else "Deleted",
                           "fields": [], "tasks": []})
            continue
        gf = _scalar_diff(og, ng, ["count", "meta"])
        tasks = []
        old_ts = {t.name: t for t in og.tasks}
        new_ts = {t.name: t for t in ng.tasks}
        for tname in sorted(set(old_ts) | set(new_ts)):
            ot, nt = old_ts.get(tname), new_ts.get(tname)
            if ot is None or nt is None:
                tasks.append({"name": tname,
                              "type": "Added" if ot is None else "Deleted",
                              "fields": []})
                continue
            tf = _scalar_diff(ot, nt, ["driver", "config", "env", "meta",
                                       "user", "kill_timeout_s"])
            tf += [{"name": f"resources.{d['name']}", "old": d["old"],
                    "new": d["new"]}
                   for d in _scalar_diff(ot.resources, nt.resources,
                                         ["cpu", "memory_mb", "disk_mb"])]
            if tf:
                tasks.append({"name": tname, "type": "Edited",
                              "fields": tf})
        if gf or tasks:
            groups.append({"name": name, "type": "Edited", "fields": gf,
                           "tasks": tasks})
    kind = "Edited" if (jf or groups) else "None"
    return {"type": kind, "fields": jf, "groups": groups}
