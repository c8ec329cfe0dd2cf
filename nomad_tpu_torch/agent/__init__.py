"""Agent — one process running server and/or client plus the HTTP API.

Behavioral reference: `command/agent/agent.go` (Agent: setupServer,
setupClient; dev mode runs both — the reference's `nomad agent -dev`) and
`command/agent/http.go` for the API listener. Config mirrors the agent
HCL/JSON config surface (`command/agent/config.go`) at the fields this
build implements.

`Agent(config, device=None)` places on the card unless the caller asks
for the CPU; an agent with a server and no card raises RuntimeError. A
client-only agent places nothing, so it neither resolves a device nor
imports torch.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

from .http import HTTPApi


class _LogRingHandler:
    """Process-wide logging handler fanning records out to the live
    agents' monitor rings (attach once; agents register/unregister)."""

    _instance = None


def _ring_handler():
    import logging

    if _LogRingHandler._instance is None:
        class Handler(logging.Handler):
            def __init__(self):
                super().__init__(level=logging.INFO)
                self.rings = []

            def emit(self, record):
                try:
                    rec = {
                        "Time": record.created,
                        "Level": record.levelname,
                        "Name": record.name,
                        "Message": record.getMessage(),
                    }
                    for ring in list(self.rings):
                        ring.append(rec)
                except Exception:  # noqa: BLE001 — logging must not raise
                    pass

        handler = Handler()
        root = logging.getLogger("nomad_tpu_torch")
        root.addHandler(handler)
        if root.level == logging.NOTSET:
            # don't clobber an embedder's explicit level choice
            root.setLevel(logging.INFO)
        _LogRingHandler._instance = handler
    return _LogRingHandler._instance


class AgentConfig:
    def __init__(self, server: bool = True, client: bool = True,
                 http_host: str = "127.0.0.1", http_port: int = 0,
                 data_dir: Optional[str] = None,
                 num_schedulers: int = 1, heartbeat_ttl: float = 30.0,
                 node_name: str = "", datacenter: str = "dc1",
                 region: str = "global",
                 server_addrs=None, acl_enabled: bool = False,
                 host_volumes=None, node_meta=None, tls=None,
                 plugin_config=None) -> None:
        self.server = server
        self.client = client
        self.http_host = http_host
        self.http_port = http_port
        self.data_dir = data_dir
        self.num_schedulers = num_schedulers
        self.heartbeat_ttl = heartbeat_ttl
        self.node_name = node_name
        self.datacenter = datacenter
        self.region = region
        self.server_addrs = server_addrs or []  # client-only mode targets
        self.acl_enabled = acl_enabled
        #: name → {path, read_only} (agent config client.host_volume)
        self.host_volumes = host_volumes or {}
        self.node_meta = node_meta or {}
        self.tls = tls  # lib.tlsutil.TLSConfig | None
        self.statsd_address = ""  # telemetry{statsd_address}
        self.telemetry_interval = 10.0
        #: driver name → operator config dict (agent `plugin "<name>" {}`
        #: stanza; reference command/agent/config.go Plugins)
        self.plugin_config = plugin_config or {}

    @classmethod
    def from_hcl(cls, text: str) -> "AgentConfig":
        """Agent configuration file (reference command/agent/config.go +
        config_parse.go): top-level keys plus server{}, client{}, ports{}
        and acl{} blocks."""
        from ..jobspec.hcl import parse_hcl

        def one(v):
            return v[0] if isinstance(v, list) and v else (v or {})

        tree = parse_hcl(text)
        # modes are opt-in via their blocks (reference defaults: both
        # off); HTTP binds the documented default port unless ports{}
        # overrides (the constructor's 0 = ephemeral is a test affordance)
        cfg = cls(server=False, client=False, http_port=4646)
        for k in ("data_dir", "datacenter", "region"):
            if k in tree:
                setattr(cfg, k, tree[k])
        if "name" in tree:
            cfg.node_name = tree["name"]
        if "bind_addr" in tree:
            cfg.http_host = tree["bind_addr"]
        srv = one(tree.get("server"))
        if srv:
            cfg.server = bool(srv.get("enabled", True))
            if "num_schedulers" in srv:
                cfg.num_schedulers = int(srv["num_schedulers"])
            if "heartbeat_grace" in srv:
                from ..jobspec.parse import _seconds

                cfg.heartbeat_ttl = _seconds(srv["heartbeat_grace"])
        cl = one(tree.get("client"))
        if cl:
            cfg.client = bool(cl.get("enabled", True))
            if "servers" in cl:
                cfg.server_addrs = [
                    (h, int(p)) for h, _, p in
                    (s.partition(":") for s in cl["servers"])]
            for hv in (cl.get("host_volume") or []):
                (name, body), = hv.items()
                b = one(body)
                cfg.host_volumes[name] = {
                    "path": b.get("path", ""),
                    "read_only": bool(b.get("read_only", False))}
            cfg.node_meta.update(one(cl.get("meta", {})) or {})
        ports = one(tree.get("ports"))
        if ports and "http" in ports:
            cfg.http_port = int(ports["http"])
        acl = one(tree.get("acl"))
        if acl:
            cfg.acl_enabled = bool(acl.get("enabled", False))
        # plugin "docker" { config { volumes { enabled = true } } }
        # (reference command/agent/config.go Plugins / plugin stanza) —
        # the inner config{} wrapper is optional here
        for pl in (tree.get("plugin") or []):
            (pname, body), = pl.items()
            b = one(body)
            pcfg = dict(one(b.get("config")) or b)
            pcfg.pop("config", None)
            cfg.plugin_config[pname] = pcfg
        tel = one(tree.get("telemetry"))
        if tel:
            cfg.statsd_address = tel.get("statsd_address", "")
            if "collection_interval" in tel:
                from ..jobspec.parse import _seconds

                cfg.telemetry_interval = _seconds(
                    tel["collection_interval"])
        tls = one(tree.get("tls"))
        if tls:
            from ..lib.tlsutil import TLSConfig

            cfg.tls = TLSConfig(
                enabled=bool(tls.get("http", tls.get("enabled", True))),
                ca_file=tls.get("ca_file", ""),
                cert_file=tls.get("cert_file", ""),
                key_file=tls.get("key_file", ""),
                verify_incoming=bool(tls.get("verify_https_client",
                                             tls.get("verify_incoming",
                                                     False))),
                rpc=bool(tls.get("rpc", False)),
            )
        return cfg

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AgentConfig":
        known = {k: v for k, v in d.items()
                 if k in cls().__dict__}
        return cls(**known)


class Agent:
    """Composes Server + Client + HTTP API in one process."""

    def __init__(self, config: Optional[AgentConfig] = None,
                 device=None) -> None:
        self.config = config or AgentConfig()
        #: where the server places (the card unless the caller asks for
        #: the CPU), resolved before anything is bound or written
        self.device = device
        if self.config.server:
            from ..device import resolve_device

            self.device = resolve_device(device)
        self.server = None
        self.client = None
        self.cluster = None
        self._started_at = time.time()
        # agent log ring for /v1/agent/monitor (hclog → monitor stream):
        # one process-wide handler fans out to the live agents' rings
        import collections
        import logging

        self._log_ring = collections.deque(maxlen=2000)
        _ring_handler().rings.append(self._log_ring)
        logging.getLogger("nomad_tpu_torch.agent").info("agent starting")
        if self.config.server:
            from ..server import Server, ServerConfig

            self.server = Server(ServerConfig(
                num_schedulers=self.config.num_schedulers,
                heartbeat_ttl=self.config.heartbeat_ttl,
                data_dir=self.config.data_dir,
                acl_enabled=self.config.acl_enabled,
                mesh="env",
            ), device=self.device)
        if self.config.client:
            from ..client import Client, ClientConfig, InProcConn, RpcConn
            from ..structs import Node

            node = Node(name=self.config.node_name,
                        datacenter=self.config.datacenter)
            if self.config.node_meta:
                node.meta.update(self.config.node_meta)
            if self.config.host_volumes:
                from ..structs.node import ClientHostVolumeConfig

                node.host_volumes = {
                    name: ClientHostVolumeConfig(
                        name=name, path=hv.get("path", ""),
                        read_only=bool(hv.get("read_only", False)))
                    for name, hv in self.config.host_volumes.items()}
            if self.server is not None:
                conn = InProcConn(self.server)
            elif self.config.server_addrs:
                conn = RpcConn(self.config.server_addrs)
            else:
                raise ValueError(
                    "client-only agent needs server_addrs to join")
            client_dir = None
            if self.config.data_dir:
                import os

                client_dir = os.path.join(self.config.data_dir, "client")
            self.client = Client(conn, ClientConfig(
                data_dir=client_dir, node=node,
                heartbeat_interval=max(self.config.heartbeat_ttl / 3, 0.5),
                plugin_config=self.config.plugin_config,
                tls=self.config.tls))
        self.http = HTTPApi(self, self.config.http_host,
                            self.config.http_port, tls=self.config.tls)
        # telemetry push (command/agent/command.go:952 setupTelemetry):
        # statsd gauges from the same tree /v1/metrics serves
        self._telemetry = None
        if self.config.statsd_address:
            from ..lib.metrics import StatsdSink, TelemetryEmitter

            self._telemetry = TelemetryEmitter(
                self.metrics, StatsdSink(self.config.statsd_address),
                interval=self.config.telemetry_interval)

    @property
    def http_addr(self):
        return self.http.addr

    def start(self) -> None:
        if self.server is not None:
            self.server.start()
        if self.client is not None:
            # advertise this agent's HTTP endpoint on the node BEFORE
            # registration — remote ephemeral-disk migration dials the
            # previous node's FS API through it (the reference's
            # Node.HTTPAddr, structs.go:1708 field set by the agent).
            # A wildcard bind is not dialable from other hosts — resolve
            # it to this host's routable IP the same way http.start does
            # for the gossip http_addr tag
            from ..lib.netutil import routable_ip

            # index, don't unpack: an IPv6 bind makes http.server's
            # server_address a 4-tuple (host, port, flowinfo, scope_id)
            # and a 2-tuple unpack would crash agent startup — same
            # reason HTTPApi.start indexes addr[0]/addr[1]
            host, port = self.http.addr[0], self.http.addr[1]
            if host in ("0.0.0.0", "::", ""):
                host = routable_ip()
            scheme = "https" if self.http.tls_enabled else "http"
            self.client.node.attributes["unique.advertise.http"] = \
                f"{scheme}://{host}:{port}"
            self.client.start()
        self.http.start()
        if self._telemetry is not None:
            self._telemetry.start()

    def shutdown(self) -> None:
        if self._telemetry is not None:
            self._telemetry.stop()
        h = _ring_handler()
        if self._log_ring in h.rings:
            h.rings.remove(self._log_ring)
        self.http.shutdown()
        if self.client is not None:
            self.client.shutdown()
        if self.server is not None:
            self.server.shutdown()

    # ---- introspection (agent_endpoint.go) ----

    def monitor_logs(self, since: float = 0.0, level: str = "") -> list:
        """Recent agent log records (reference /v1/agent/monitor,
        command/agent/agent_endpoint.go Monitor — polling JSON frames
        instead of a chunked stream)."""
        import logging

        floor = 0
        if level:
            name = {"warn": "WARNING", "err": "ERROR"}.get(
                level.lower(), level.upper())
            lv = logging.getLevelName(name)
            floor = lv if isinstance(lv, int) else 0
        out = []
        for rec in list(self._log_ring):
            if rec["Time"] <= since:
                continue
            lv = logging.getLevelName(rec["Level"])
            # minimum severity, reference log_level semantics
            if floor and (not isinstance(lv, int) or lv < floor):
                continue
            out.append(rec)
        return out

    def self_info(self) -> Dict[str, Any]:
        from .. import __version__

        info = {"version": __version__,
                "server": self.server is not None,
                "client": self.client is not None,
                "uptime_s": time.time() - self._started_at}
        if self.client is not None:
            info["node_id"] = self.client.node.id
            info["node_name"] = self.client.node.name
        return info

    def metrics(self) -> Dict[str, Any]:
        """go-metrics /v1/metrics analog: subsystem counters, the
        server registry (counters/gauges/histograms incl. per-phase
        eval latency) and the process-global registry (RPC transport,
        client loop-error sinks)."""
        from ..lib.metrics import default_registry

        out: Dict[str, Any] = {"uptime_s": time.time() - self._started_at}
        if self.server is not None:
            out["broker"] = dict(self.server.broker.stats)
            out["broker_ready"] = self.server.broker.ready_count()
            out["broker_unacked"] = self.server.broker.unacked_count()
            out["blocked_evals"] = self.server.blocked.blocked_count()
            # live "what is the cluster short of" view: exhausted
            # dimensions across currently-blocked evals (kernel-native
            # attribution carried on their failed_tg_allocs)
            out["blocked_dimensions"] = self.server.blocked.dimension_stats()
            out["plan_apply"] = dict(self.server.planner.stats)
            out["state_index"] = self.server.state.index.value
            reg = getattr(self.server, "metrics", None)
            if reg is not None:
                snap = reg.snapshot()
                out["telemetry"] = snap
                # per-phase eval latency summaries, pulled up as a
                # first-class view (the observability headline)
                out["eval_phases"] = {
                    name[len("eval.phase."):]: s
                    for name, s in (snap.get("histograms") or {}).items()
                    if name.startswith("eval.phase.")}
            timeline = getattr(self.server, "timeline", None)
            if timeline is not None:
                # dispatch-pipeline rollup (overlap/bubble/transfer per
                # dispatch) — the quick answer to "is pipelining
                # actually overlapping pack with the kernel?"
                out["pipeline"] = timeline.summary()
            # control-plane rollup (ISSUE 13): broker queue depths/ages,
            # plan-apply queue/latency/partial-rate, heartbeat losses —
            # also refreshes the broker/plan gauges so the registry
            # snapshot above and this section agree on the next scrape
            out["control"] = self.server.control_plane_stats()
        out["process"] = default_registry().snapshot()
        # per-call-site host↔device transfer attribution (the ledger):
        # process-global like the registry it mirrors into
        from ..lib.transfer import default_ledger

        out["transfer_sites"] = default_ledger().snapshot()
        # device-buffer residency (lib/hbm.py): live/peak bytes per
        # site plus lease state — snapshot() also runs the stuck-lease
        # watermark check, so a scrape is enough to surface a leak
        from ..lib.hbm import default_hbm

        hbm = default_hbm()
        out["hbm_sites"] = hbm.snapshot()
        out["hbm"] = hbm.summary()
        if self.client is not None:
            out["client_allocs"] = self.client.num_allocs()
        return out

    def metrics_prometheus(self) -> str:
        """Prometheus text exposition across both registries plus the
        transfer ledger's labeled per-site series. Name sets are
        disjoint (server-owned vs process-global instruments vs the
        ledgers' labeled `nomad_transfer_*_total{site=...}` /
        `nomad_hbm_*{site=...,shard=...}` families), so plain
        concatenation is collision-free."""
        from ..lib.hbm import default_hbm
        from ..lib.metrics import default_registry
        from ..lib.transfer import default_ledger

        parts = []
        if self.server is not None:
            # refresh the queue-state gauges (broker depths/ages, plan
            # queue depth, blocked depth) so a bare Prometheus scrape
            # reads current values without a prior /v1/metrics call
            self.server.control_plane_stats()
            reg = getattr(self.server, "metrics", None)
            if reg is not None:
                parts.append(reg.prometheus())
        if self.cluster is not None:
            # the raft node's own registry (it outlives the leadership-
            # gated Server): nomad_raft_* series ride the same scrape
            self.cluster.raft.status()  # refresh log-size gauges
            parts.append(self.cluster.raft.metrics.prometheus())
        parts.append(default_registry().prometheus())
        parts.append(default_ledger().prometheus())
        parts.append(default_hbm().prometheus())
        return "".join(parts)


__all__ = ["Agent", "AgentConfig", "HTTPApi"]
