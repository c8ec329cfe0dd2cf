"""Map parsed HCL trees onto `structs.Job` (jobspec/parse_*.go)."""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..structs.job import (Affinity, Connect, ConnectProxy,
                           ConnectUpstream, Constraint, EphemeralDisk,
                           IngressGateway, IngressListener, Job,
                           LogConfig, MigrateStrategy,
                           ParameterizedJobConfig, PeriodicConfig,
                           ReschedulePolicy, RestartPolicy, ScalingPolicy,
                           Service, SidecarService, Spread, SpreadTarget,
                           Task, TaskArtifact,
                           TaskGroup, TaskLifecycle, Template,
                           UpdateStrategy, VolumeMount, VolumeRequest)
from ..structs.resources import (NetworkResource, Port, RequestedDevice,
                                 Resources)
from .hcl import HclError, parse_hcl


def parse(src: str) -> Job:
    """jobspec text → Job (jobspec/parse.go:26)."""
    tree = parse_hcl(src)
    jobs = tree.get("job")
    if not jobs:
        raise HclError("jobspec requires a job block")
    block = _one(jobs)
    (job_id, body), = block.items()
    return _parse_job(job_id, body)


def parse_file(path: str) -> Job:
    with open(path) as fh:
        return parse(fh.read())


def _one(v):
    """hcl accumulates repeated blocks into lists; most stanzas allow one."""
    return v[0] if isinstance(v, list) else v


def _many(v) -> List[Any]:
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


def _seconds(v) -> float:
    """Duration literals: "30s", "5m", "1h30m", bare numbers = seconds
    (parse.go parseDuration via time.ParseDuration)."""
    if isinstance(v, (int, float)):
        return float(v)
    import re

    total, rest = 0.0, str(v).strip()
    for num, unit in re.findall(r"(\d+(?:\.\d+)?)(ms|s|m|h|d)", rest):
        total += float(num) * {"ms": 0.001, "s": 1, "m": 60, "h": 3600,
                               "d": 86400}[unit]
    if total == 0.0 and rest and rest not in ("0",):
        try:
            total = float(rest)
        except ValueError:
            raise HclError(f"bad duration {v!r}")
    return total


def _parse_job(job_id: str, body: Dict[str, Any]) -> Job:
    job = Job(id=job_id, name=body.get("name", job_id))
    for key in ("type", "region", "namespace", "priority"):
        if key in body:
            setattr(job, key, body[key])
    job.datacenters = list(body.get("datacenters", ["dc1"]))
    job.all_at_once = bool(body.get("all_at_once", False))
    job.meta = dict(_one(body.get("meta", {})) or {})
    job.constraints = [_parse_constraint(c)
                       for c in _many(body.get("constraint"))]
    job.affinities = [_parse_affinity(a) for a in _many(body.get("affinity"))]
    job.spreads = [_parse_spread(s) for s in _many(body.get("spread"))]
    if "update" in body:
        job.update = _parse_update(_one(body["update"]))
    if "periodic" in body:
        p = _one(body["periodic"])
        job.periodic = PeriodicConfig(
            enabled=bool(p.get("enabled", True)),
            spec=p.get("cron", p.get("spec", "")),
            prohibit_overlap=bool(p.get("prohibit_overlap", False)),
            time_zone=p.get("time_zone", "UTC"),
        )
    if "parameterized" in body:
        p = _one(body["parameterized"])
        job.parameterized = ParameterizedJobConfig(
            payload=p.get("payload", "optional"),
            meta_required=list(p.get("meta_required", [])),
            meta_optional=list(p.get("meta_optional", [])),
        )
    if "multiregion" in body:
        # reference jobspec/parse_multiregion.go: strategy{} + region
        # blocks with count/datacenters/meta overrides
        from ..structs.job import Multiregion

        mr = _one(body["multiregion"])
        strategy = None
        if "strategy" in mr:
            s = _one(mr["strategy"])
            strategy = {"max_parallel": int(s.get("max_parallel", 0)),
                        "on_failure": s.get("on_failure", "")}
        regions = []
        for r in _many(mr.get("region")):
            (rname, rbody), = r.items()
            rb = _one(rbody)
            regions.append({
                "name": rname,
                "count": int(rb.get("count", 0)),
                "datacenters": list(rb.get("datacenters", [])),
                "meta": dict(_one(rb.get("meta", {})) or {}),
            })
        job.multiregion = Multiregion(strategy=strategy, regions=regions)
    groups = body.get("group")
    if not groups:
        raise HclError(f"job {job_id!r} needs at least one group")
    for g in _many(groups):
        (name, gbody), = g.items()
        job.task_groups.append(_parse_group(name, gbody, job))
    return job


def _parse_group(name: str, body: Dict[str, Any], job: Job) -> TaskGroup:
    tg = TaskGroup(name=name, count=int(body.get("count", 1)))
    tg.meta = dict(_one(body.get("meta", {})) or {})
    tg.constraints = [_parse_constraint(c)
                      for c in _many(body.get("constraint"))]
    tg.affinities = [_parse_affinity(a) for a in _many(body.get("affinity"))]
    tg.spreads = [_parse_spread(s) for s in _many(body.get("spread"))]
    if "restart" in body:
        r = _one(body["restart"])
        tg.restart_policy = RestartPolicy(
            attempts=int(r.get("attempts", 2)),
            interval_s=_seconds(r.get("interval", 1800)),
            delay_s=_seconds(r.get("delay", 15)),
            mode=r.get("mode", "fail"),
        )
    if "reschedule" in body:
        r = _one(body["reschedule"])
        tg.reschedule_policy = ReschedulePolicy(
            attempts=int(r.get("attempts", 0)),
            interval_s=_seconds(r.get("interval", 0)),
            delay_s=_seconds(r.get("delay", 30)),
            delay_function=r.get("delay_function", "exponential"),
            max_delay_s=_seconds(r.get("max_delay", 3600)),
            unlimited=bool(r.get("unlimited", True)),
        )
    if "migrate" in body:
        m = _one(body["migrate"])
        tg.migrate_strategy = MigrateStrategy(
            max_parallel=int(m.get("max_parallel", 1)),
            health_check=m.get("health_check", "checks"),
            min_healthy_time_s=_seconds(m.get("min_healthy_time", 10)),
            healthy_deadline_s=_seconds(m.get("healthy_deadline", 300)),
        )
    if "update" in body:
        tg.update = _parse_update(_one(body["update"]))
    if "ephemeral_disk" in body:
        e = _one(body["ephemeral_disk"])
        tg.ephemeral_disk = EphemeralDisk(
            sticky=bool(e.get("sticky", False)),
            size_mb=int(e.get("size", 300)),
            migrate=bool(e.get("migrate", False)),
        )
    for net in _many(body.get("network")):
        tg.networks.append(_parse_network(net))
    for vol in _many(body.get("volume")):
        (vname, vbody), = vol.items()
        tg.volumes[vname] = VolumeRequest(
            name=vname, type=vbody.get("type", "host"),
            source=vbody.get("source", ""),
            read_only=bool(vbody.get("read_only", False)),
        )
    for svc in _many(body.get("service")):
        tg.services.append(_parse_service(svc))
    if "stop_after_client_disconnect" in body:
        tg.stop_after_client_disconnect_s = _seconds(
            body["stop_after_client_disconnect"])
    if "scaling" in body:
        # Reference jobspec group scaling stanza (jobspec/parse_group.go
        # parseScalingPolicy); min defaults to the group count.
        s = _one(body["scaling"])
        job.scaling_policies.append(ScalingPolicy(
            target={"Namespace": job.namespace, "Job": job.id,
                    "Group": name},
            policy=dict(_one(s.get("policy", {})) or {}),
            min=int(s.get("min", tg.count)),
            max=int(s.get("max", tg.count)),
            enabled=bool(s.get("enabled", True)),
        ))
    tasks = body.get("task")
    for t in _many(tasks):
        (tname, tbody), = t.items()
        tg.tasks.append(_parse_task(tname, tbody))
    return tg


def _parse_task(name: str, body: Dict[str, Any]) -> Task:
    task = Task(name=name, driver=body.get("driver", "exec"))
    task.user = body.get("user", "")
    task.config = dict(_one(body.get("config", {})) or {})
    task.env = {k: str(v)
                for k, v in (_one(body.get("env", {})) or {}).items()}
    task.meta = dict(_one(body.get("meta", {})) or {})
    task.constraints = [_parse_constraint(c)
                        for c in _many(body.get("constraint"))]
    task.affinities = [_parse_affinity(a)
                       for a in _many(body.get("affinity"))]
    task.leader = bool(body.get("leader", False))
    if "kill_timeout" in body:
        task.kill_timeout_s = _seconds(body["kill_timeout"])
    if "shutdown_delay" in body:
        task.shutdown_delay_s = _seconds(body["shutdown_delay"])
    task.kill_signal = body.get("kill_signal", "")
    if "lifecycle" in body:
        lc = _one(body["lifecycle"])
        task.lifecycle = TaskLifecycle(
            hook=lc.get("hook", ""), sidecar=bool(lc.get("sidecar", False)))
    if "dispatch_payload" in body:
        # jobspec/parse_task.go parseDispatchPayload
        from ..structs.job import DispatchPayloadConfig

        dp = _one(body["dispatch_payload"])
        task.dispatch_payload = DispatchPayloadConfig(
            file=dp.get("file", ""))
    if "secrets" in body:
        # built-in secrets engine (the vault{} stanza analog,
        # jobspec/parse_task.go parseVault)
        sc = _one(body["secrets"])
        task.secrets = [str(p) for p in sc.get("paths", [])]
    if "logs" in body:
        lg = _one(body["logs"])
        task.log_config = LogConfig(
            max_files=int(lg.get("max_files", 10)),
            max_file_size_mb=int(lg.get("max_file_size", 10)),
        )
    if "resources" in body:
        task.resources = _parse_resources(_one(body["resources"]))
    for art in _many(body.get("artifact")):
        task.artifacts.append(TaskArtifact(
            getter_source=art.get("source", ""),
            getter_options=dict(_one(art.get("options", {})) or {}),
            relative_dest=art.get("destination", "local/"),
        ))
    for tm in _many(body.get("template")):
        task.templates.append(Template(
            source_path=tm.get("source", ""),
            dest_path=tm.get("destination", ""),
            embedded_tmpl=tm.get("data", ""),
            change_mode=tm.get("change_mode", "restart"),
            change_signal=tm.get("change_signal", ""),
        ))
    for vm in _many(body.get("volume_mount")):
        task.volume_mounts.append(VolumeMount(
            volume=vm.get("volume", ""),
            destination=vm.get("destination", ""),
            read_only=bool(vm.get("read_only", False)),
        ))
    for svc in _many(body.get("service")):
        task.services.append(_parse_service(svc))
    return task


def _parse_resources(body: Dict[str, Any]) -> Resources:
    r = Resources(cpu=int(body.get("cpu", 100)),
                  memory_mb=int(body.get("memory", 300)))
    if "disk" in body:
        r.disk_mb = int(body["disk"])
    for net in _many(body.get("network")):
        r.networks.append(_parse_network(net))
    for dev in _many(body.get("device")):
        if isinstance(dev, dict) and len(dev) == 1 \
                and isinstance(next(iter(dev.values())), dict):
            (dname, dbody), = dev.items()
        else:
            dname, dbody = "", dev
        r.devices.append(RequestedDevice(
            name=dbody.get("name", dname),
            count=int(dbody.get("count", 1)),
            constraints=[_parse_constraint(c)
                         for c in _many(dbody.get("constraint"))],
            affinities=[_parse_affinity(a)
                        for a in _many(dbody.get("affinity"))],
        ))
    return r


def _parse_network(body: Dict[str, Any]) -> NetworkResource:
    net = NetworkResource(mbits=int(body.get("mbits", 0)))
    if "mode" in body:
        net.mode = body["mode"]
    for p in _many(body.get("port")):
        if isinstance(p, dict):
            (label, pbody), = p.items()
            port = Port(label=label)
            if pbody.get("static"):
                port.value = int(pbody["static"])
                net.reserved_ports.append(port)
            else:
                if pbody.get("to"):
                    port.to = int(pbody["to"])
                net.dynamic_ports.append(port)
        else:
            net.dynamic_ports.append(Port(label=str(p)))
    return net


def _parse_service(body: Dict[str, Any]) -> Service:
    # jobspec/parse_service.go parseChecks: check{} blocks become the
    # client-side health probes behind registration status
    checks = []
    for c in _many(body.get("check")):
        cb = _one(c)
        checks.append({
            "name": cb.get("name", ""),
            "type": cb.get("type", "tcp"),
            "path": cb.get("path", ""),
            "port": str(cb.get("port", "")),
            "interval_s": _seconds(cb.get("interval", 10)),
            "timeout_s": _seconds(cb.get("timeout", 2)),
            # script checks (parse_service.go parseChecks: command/args;
            # `task` names the exec target for group-level services)
            "command": cb.get("command", ""),
            "args": list(cb.get("args", [])),
            "task": cb.get("task", ""),
        })
    # connect { sidecar_service { proxy { upstreams { ... } } } }
    # (jobspec/parse_service.go parseConnect); the native mesh injects
    # its proxy at admission — structs/connect.py
    conn = None
    cb = _one(body.get("connect")) if body.get("connect") else None
    if cb is not None:
        sb = _one(cb.get("sidecar_service")) \
            if cb.get("sidecar_service") is not None else None
        sidecar = None
        if sb is not None:
            ups = []
            pb = _one(sb.get("proxy")) if sb.get("proxy") else {}
            for u in _many((pb or {}).get("upstreams")):
                ub = _one(u)
                ups.append(ConnectUpstream(
                    destination_name=ub.get("destination_name", ""),
                    local_bind_port=int(ub.get("local_bind_port", 0)),
                ))
            sidecar = SidecarService(
                port_label=str(sb.get("port", "")),
                proxy=ConnectProxy(upstreams=ups),
            )
        # gateway { ingress { listener { port service } } }
        gateway = None
        gb = _one(cb.get("gateway")) if cb.get("gateway") else None
        if gb is not None:
            ib = _one(gb.get("ingress")) if gb.get("ingress") else {}
            listeners = []
            for ls in _many((ib or {}).get("listener")):
                lsb = _one(ls)
                listeners.append(IngressListener(
                    port=int(lsb.get("port", 0)),
                    service=str(lsb.get("service", "")),
                ))
            gateway = IngressGateway(listeners=listeners)
        conn = Connect(sidecar_service=sidecar, gateway=gateway)
    return Service(
        name=body.get("name", ""),
        port_label=str(body.get("port", "")),
        tags=list(body.get("tags", [])),
        address_mode=body.get("address_mode", "auto"),
        checks=checks,
        connect=conn,
    )


def _parse_update(body: Dict[str, Any]) -> UpdateStrategy:
    return UpdateStrategy(
        stagger_s=_seconds(body.get("stagger", 30)),
        max_parallel=int(body.get("max_parallel", 1)),
        health_check=body.get("health_check", "checks"),
        min_healthy_time_s=_seconds(body.get("min_healthy_time", 10)),
        healthy_deadline_s=_seconds(body.get("healthy_deadline", 300)),
        progress_deadline_s=_seconds(body.get("progress_deadline", 600)),
        auto_revert=bool(body.get("auto_revert", False)),
        auto_promote=bool(body.get("auto_promote", False)),
        canary=int(body.get("canary", 0)),
    )


def _parse_constraint(body: Dict[str, Any]) -> Constraint:
    c = Constraint(
        ltarget=body.get("attribute", ""),
        rtarget=str(body.get("value", "")),
        operand=body.get("operator", "="),
    )
    # sugar forms (parse.go parseConstraints): distinct_hosts,
    # distinct_property, version, regexp, set_contains
    for sugar in ("version", "regexp", "set_contains", "semver"):
        if sugar in body:
            c.operand = sugar
            c.rtarget = str(body[sugar])
    if body.get("distinct_hosts"):
        c.operand = "distinct_hosts"
    if "distinct_property" in body:
        c.operand = "distinct_property"
        c.ltarget = body["distinct_property"]
        c.rtarget = str(body.get("value", ""))
    return c


def _parse_affinity(body: Dict[str, Any]) -> Affinity:
    a = Affinity(
        ltarget=body.get("attribute", ""),
        rtarget=str(body.get("value", "")),
        operand=body.get("operator", "="),
        weight=int(body.get("weight", 50)),
    )
    for sugar in ("version", "regexp", "set_contains",
                  "set_contains_any", "set_contains_all"):
        if sugar in body:
            a.operand = sugar
            a.rtarget = str(body[sugar])
    return a


def _parse_spread(body: Dict[str, Any]) -> Spread:
    targets = []
    for t in _many(body.get("target")):
        (value, tbody), = t.items()
        targets.append(SpreadTarget(
            value=value, percent=int(tbody.get("percent", 0))))
    return Spread(
        attribute=body.get("attribute", ""),
        weight=int(body.get("weight", 50)),
        spread_target=targets,
    )
