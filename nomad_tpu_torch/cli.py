"""CLI — the `nomad <subcommand>` surface.

Behavioral reference: `command/commands.go:142-661` registry and the
individual command files (`command/job_run.go`, `job_status.go`,
`node_status.go`, `alloc_status.go`, `node_drain.go`, `eval_status.go`,
`deployment_*.go`, `operator_*.go`, `agent/command.go`). Implemented
subcommands cover the core operator loop: agent, job
run/status/stop/plan/inspect/periodic-force, node
status/drain/eligibility, alloc status, eval status, deployment
list/status/promote/fail, server members, operator scheduler-config,
system gc, status, version.

Usage: `python -m nomad_tpu_torch <subcommand> ...`; server address from
`-address` or `$NOMAD_ADDR` (default http://127.0.0.1:4646).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

from .api import ApiError, NomadClient


def _client(args) -> NomadClient:
    addr = args.address or os.environ.get("NOMAD_ADDR",
                                          "http://127.0.0.1:4646")
    import re

    m = re.match(r"^(?:(?P<scheme>https?)://)?(?P<host>[^:/]+)"
                 r"(?::(?P<port>\d+))?/?$", addr)
    if m is None:
        print(f"Error: malformed address {addr!r} "
              "(expected [http://]host[:port])", file=sys.stderr)
        raise SystemExit(1)
    ca_cert = (getattr(args, "ca_cert", None)
               or os.environ.get("NOMAD_CACERT"))
    if m.group("scheme") == "https" and not ca_cert:
        print("Error: https address needs -ca-cert or $NOMAD_CACERT",
              file=sys.stderr)
        raise SystemExit(1)
    return NomadClient(
        m.group("host"), int(m.group("port") or 4646),
        token=os.environ.get("NOMAD_TOKEN"),
        ca_cert=ca_cert if m.group("scheme") == "https" else None,
        client_cert=(getattr(args, "client_cert", None)
                     or os.environ.get("NOMAD_CLIENT_CERT")),
        client_key=(getattr(args, "client_key", None)
                    or os.environ.get("NOMAD_CLIENT_KEY")),
        region=(getattr(args, "region", None)
                or os.environ.get("NOMAD_REGION")))


def _columns(rows: List[List[str]], header: List[str]) -> str:
    rows = [header] + rows
    widths = [max(len(str(r[i])) for r in rows) for i in range(len(header))]
    return "\n".join(
        "  ".join(str(c).ljust(w) for c, w in zip(r, widths)).rstrip()
        for r in rows)


def _monitor(api: NomadClient, eval_id: str) -> int:
    """Eval monitor (command/monitor.go): follow the eval to completion."""
    print(f"==> Monitoring evaluation {eval_id[:8]}")
    ev = api.wait_for_eval(eval_id, timeout=30.0)
    print(f"    Evaluation status: {ev.status}")
    if ev.status != "complete":
        print(f"    {ev.status_description}")
        return 1
    for tg, m in (ev.failed_tg_allocs or {}).items():
        print(f"    Task group {tg!r} failed placement: "
              f"{m.nodes_evaluated} evaluated, {m.nodes_filtered} filtered, "
              f"{m.nodes_exhausted} exhausted")
    if ev.blocked_eval_id if hasattr(ev, "blocked_eval_id") else None:
        print(f"    Blocked eval created: {ev.blocked_eval_id[:8]}")
    return 0


# ---- job ----

def cmd_job_run(args) -> int:
    from .jobspec import parse_file

    api = _client(args)
    job = parse_file(args.spec)
    eval_id = api.register_job(job)
    if not eval_id:
        print(f'Job "{job.id}" registered (no evaluation: '
              f'periodic/parameterized)')
        return 0
    print(f'Job "{job.id}" registered; evaluation {eval_id[:8]}')
    if args.detach:
        return 0
    return _monitor(api, eval_id)


def cmd_job_status(args) -> int:
    api = _client(args)
    if not args.job_id:
        jobs = api.jobs()
        print(_columns(
            [[j.id, j.type, str(j.priority),
              "dead" if j.stop else j.status or "running"] for j in jobs],
            ["ID", "Type", "Priority", "Status"]))
        return 0
    job = api.job(args.job_id, namespace=args.namespace)
    print(f"ID            = {job.id}")
    print(f"Name          = {job.name}")
    print(f"Type          = {job.type}")
    print(f"Priority      = {job.priority}")
    print(f"Datacenters   = {','.join(job.datacenters)}")
    print(f"Status        = {'dead (stopped)' if job.stop else job.status}")
    summary = api.job_summary(args.job_id, namespace=args.namespace)
    print("\nSummary")
    rows = [[tg] + [str(counts.get(k, 0)) for k in
                    ("queued", "starting", "running", "complete",
                     "failed", "lost")]
            for tg, counts in summary["summary"].items()]
    print(_columns(rows, ["Task Group", "Queued", "Starting", "Running",
                          "Complete", "Failed", "Lost"]))
    allocs = api.job_allocations(args.job_id, namespace=args.namespace)
    if allocs:
        print("\nAllocations")
        print(_columns(
            [[a.id[:8], a.node_id[:8], a.task_group, a.desired_status,
              a.client_status] for a in allocs],
            ["ID", "Node ID", "Task Group", "Desired", "Status"]))
    return 0


def cmd_job_stop(args) -> int:
    api = _client(args)
    eval_id = api.deregister_job(args.job_id, namespace=args.namespace)
    print(f'Job "{args.job_id}" deregistered')
    if eval_id and not args.detach:
        return _monitor(api, eval_id)
    return 0


def cmd_job_plan(args) -> int:
    from .jobspec import parse_file

    api = _client(args)
    job = parse_file(args.spec)
    out = api.plan_job(job)
    diff = out.get("diff") or {}
    sym = {"Added": "+", "Deleted": "-", "Edited": "+/-",
           "None": ""}.get(diff.get("type", "None"), "")
    print(f"{sym or '='} Job: {job.id!r}")
    for f in diff.get("fields", []):
        print(f"  ~ {f['name']}: {f['old']!r} => {f['new']!r}")
    for g in diff.get("groups", []):
        gs = {"Added": "+", "Deleted": "-"}.get(g["type"], "+/-")
        print(f"  {gs} group {g['name']!r}")
        for f in g.get("fields", []):
            print(f"      ~ {f['name']}: {f['old']!r} => {f['new']!r}")
        for t in g.get("tasks", []):
            ts = {"Added": "+", "Deleted": "-"}.get(t["type"], "+/-")
            print(f"    {ts} task {t['name']!r}")
            for f in t.get("fields", []):
                print(f"        ~ {f['name']}: "
                      f"{f['old']!r} => {f['new']!r}")
    print(f"Placements: {out['placements']}  Stops: {out['stops']}")
    for tg, m in out.get("failed_tg_allocs", {}).items():
        print(f"WARNING: group {tg!r} would fail placement "
              f"({m['nodes_evaluated']} evaluated, "
              f"{m['nodes_filtered']} filtered)")
    return 0


def cmd_job_scale(args) -> int:
    api = _client(args)
    if args.count is None:
        try:
            group, count = None, int(args.group_or_count)
        except ValueError:
            print("error: missing count (usage: job scale <job> "
                  "[group] <count>)", file=sys.stderr)
            return 1
    else:
        group, count = args.group_or_count, args.count
    if group is None:
        # Single-group jobs may omit the group (command/job_scale.go).
        job = api.job(args.job_id, namespace=args.namespace)
        if len(job.task_groups) != 1:
            print("error: job has multiple groups; specify one",
                  file=sys.stderr)
            return 1
        group = job.task_groups[0].name
    try:
        eval_id = api.job_scale(args.job_id, group, count,
                                namespace=args.namespace)
    except Exception as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(f'Scaled group "{group}" of job "{args.job_id}" to {count}')
    if eval_id and not args.detach:
        return _monitor(api, eval_id)
    return 0


def cmd_job_inspect(args) -> int:
    from .structs.codec import to_wire

    api = _client(args)
    job = api.job(args.job_id, namespace=args.namespace)
    print(json.dumps(to_wire(job), indent=2, default=str))
    return 0


def cmd_job_validate(args) -> int:
    """`nomad-tpu job validate <spec>` (command/job_validate.go):
    HCL parse + server-side spec validation without registering."""
    from .jobspec import HclError, parse_file

    try:
        job = parse_file(args.spec)
    except (HclError, OSError) as e:
        print(f"Error parsing jobspec: {e}", file=sys.stderr)
        return 1
    from .structs.codec import to_wire

    out = _client(args)._request("PUT", "/v1/validate/job",
                                 body={"job": to_wire(job)})
    for w in out.get("warnings", []):
        print(f"Warning: {w}")
    if not out.get("valid", False):
        print(f"Error: {out.get('error', 'invalid job')}",
              file=sys.stderr)
        return 1
    print("Job validation successful")
    return 0


def cmd_ui(args) -> int:
    """`nomad-tpu ui` (command/ui.go): print the web console URL."""
    addr = args.address or os.environ.get("NOMAD_ADDR",
                                          "http://127.0.0.1:4646")
    print(f"Web console: {addr.rstrip('/')}/ui")
    return 0


def cmd_job_history(args) -> int:
    """`nomad-tpu job history <job>` (command/job_history.go)."""
    api = _client(args)
    versions = api.job_versions(args.job_id, namespace=args.namespace)
    if not versions:
        print(f"No versions for job {args.job_id!r}", file=sys.stderr)
        return 1
    for j in versions:
        print(f"Version     = {j.version}")
        print(f"Stable      = {str(j.stable).lower()}")
        print(f"Status      = {j.status}")
        print(f"Groups      = "
              f"{', '.join(f'{g.name}x{g.count}' for g in j.task_groups)}")
        print()
    return 0


def cmd_job_revert(args) -> int:
    """`nomad-tpu job revert <job> <version>` (command/job_revert.go)."""
    api = _client(args)
    eval_id = api.job_revert(args.job_id, args.version,
                             namespace=args.namespace)
    print(f"Job {args.job_id!r} reverted to version {args.version}")
    if eval_id and not args.detach:
        return _monitor(api, eval_id)
    return 0


def cmd_alloc_stop(args) -> int:
    """`nomad-tpu alloc stop <alloc>` (command/alloc_stop.go)."""
    api = _client(args)
    a = _resolve_alloc(api, args.alloc_id)
    if a is None:
        return 1
    eval_id = api.alloc_stop(a.id)
    print(f"Alloc {a.id[:8]} stop requested")
    if eval_id and not args.detach:
        return _monitor(api, eval_id)
    return 0


def cmd_alloc_restart(args) -> int:
    """`nomad-tpu alloc restart <alloc> [task]`
    (command/alloc_restart.go)."""
    api = _client(args)
    a = _resolve_alloc(api, args.alloc_id)
    if a is None:
        return 1
    out = api.alloc_restart(a.id, task=args.task)
    print(f"Restarted {out['restarted']} task(s) in alloc {a.id[:8]}")
    return 0 if out["restarted"] else 1


def cmd_alloc_signal(args) -> int:
    """`nomad-tpu alloc signal -s SIGHUP <alloc> [task]`
    (command/alloc_signal.go)."""
    api = _client(args)
    a = _resolve_alloc(api, args.alloc_id)
    if a is None:
        return 1
    out = api.alloc_signal(a.id, signal=args.signal, task=args.task)
    print(f"Signaled {out['signaled']} task(s) in alloc {a.id[:8]}")
    return 0 if out["signaled"] else 1


def cmd_eval_list(args) -> int:
    """`nomad-tpu eval list` (command/eval_list.go)."""
    evals = _client(args).evaluations()
    print(_columns(
        [[e.id[:8], e.job_id, e.type, e.triggered_by, str(e.priority),
          e.status] for e in evals],
        ["ID", "Job", "Type", "Triggered By", "Priority", "Status"]))
    return 0


def cmd_acl(args) -> int:
    """`nomad-tpu acl bootstrap|policy ...|token ...`
    (command/acl_*.go)."""
    api = _client(args)
    if args.sub == "bootstrap":
        tok = api.acl_bootstrap()
        print(f"Accessor ID  = {tok.accessor_id}")
        print(f"Secret ID    = {tok.secret_id}")  # nomadlint: ok NLS01 bootstrap hands the fresh token to the invoking operator's own terminal — this IS the credential delivery channel (command/acl_bootstrap.go)
        print(f"Type         = {tok.type}")
        return 0
    if args.sub == "policy-apply":
        with open(args.rules_file) as f:
            rules = f.read()
        api.acl_upsert_policy(args.name, rules,
                              description=args.description or "")
        print(f"Successfully wrote policy {args.name!r}")
        return 0
    if args.sub == "policy-list":
        print(_columns(
            [[p.name, p.description or "<none>"]
             for p in api.acl_policies()],
            ["Name", "Description"]))
        return 0
    if args.sub == "policy-delete":
        api.acl_delete_policy(args.name)
        print(f"Deleted policy {args.name!r}")
        return 0
    if args.sub == "token-create":
        tok = api.acl_create_token(
            name=args.name or "", type=args.type,
            policies=args.policy or [])
        print(f"Accessor ID  = {tok.accessor_id}")
        print(f"Secret ID    = {tok.secret_id}")  # nomadlint: ok NLS01 token-create prints the new secret once, to the creating operator's terminal — the delivery channel
        print(f"Policies     = {', '.join(tok.policies) or '<none>'}")
        return 0
    if args.sub == "token-list":
        print(_columns(
            [[t.accessor_id[:8], t.name or "<none>", t.type,
              ", ".join(t.policies) or "<all>"]
             for t in api.acl_tokens()],
            ["Accessor", "Name", "Type", "Policies"]))
        return 0
    if args.sub == "token-delete":
        api.acl_delete_token(args.accessor_id)
        print(f"Deleted token {args.accessor_id!r}")
        return 0
    print(f"unknown acl subcommand {args.sub!r}", file=sys.stderr)
    return 1


def cmd_job_dispatch(args) -> int:
    """`nomad-tpu job dispatch [-meta k=v]... <job> [payload-file]`
    (command/job_dispatch.go; '-' reads the payload from stdin)."""
    api = _client(args)
    payload = b""
    if args.payload_file == "-":
        payload = sys.stdin.buffer.read()
    elif args.payload_file:
        with open(args.payload_file, "rb") as f:
            payload = f.read()
    meta = {}
    for kv in args.meta or []:
        k, sep, v = kv.partition("=")
        if not sep:
            print(f"Error: -meta expects key=value, got {kv!r}",
                  file=sys.stderr)
            return 1
        meta[k] = v
    out = api.job_dispatch(args.job_id, payload, meta,
                           namespace=args.namespace)
    print(f"Dispatched job {out['dispatched_job_id']!r}")
    ev = out.get("eval_id", "")
    if ev:
        print(f"Evaluation ID: {ev[:8]}")
        if not args.detach:
            return _monitor(api, ev)
    return 0


def cmd_job_periodic_force(args) -> int:
    api = _client(args)
    eval_id = api.periodic_force(args.job_id, namespace=args.namespace)
    print(f"Forced periodic launch; evaluation {eval_id[:8]}")
    return _monitor(api, eval_id) if not args.detach else 0


# ---- node ----

def cmd_node_status(args) -> int:
    api = _client(args)
    if not args.node_id:
        print(_columns(
            [[n.id[:8], n.name, n.datacenter, n.node_class or "<none>",
              n.scheduling_eligibility, n.status] for n in api.nodes()],
            ["ID", "Name", "DC", "Class", "Eligibility", "Status"]))
        return 0
    n = _resolve_node(api, args.node_id)
    if n is None:
        return 1
    node = api.node(n.id)
    print(f"ID          = {node.id}")
    print(f"Name        = {node.name}")
    print(f"DC          = {node.datacenter}")
    print(f"Status      = {node.status}")
    print(f"Eligibility = {node.scheduling_eligibility}")
    print(f"Drain       = {node.drain is not None}")
    allocs = api.node_allocations(node.id)
    if allocs:
        print("\nAllocations")
        print(_columns(
            [[a.id[:8], a.job_id, a.desired_status, a.client_status]
             for a in allocs],
            ["ID", "Job", "Desired", "Status"]))
    return 0


def _resolve_node(api, prefix: str):
    matches = [n for n in api.nodes() if n.id.startswith(prefix)]
    if len(matches) != 1:
        print(f"{len(matches)} nodes match {prefix!r}", file=sys.stderr)
        return None
    return matches[0]


def cmd_node_purge(args) -> int:
    """`nomad-tpu node purge <id>` — deregister a node entirely; its
    allocs get replacement evals (API PUT /v1/node/:id/purge)."""
    api = _client(args)
    n = _resolve_node(api, args.node_id)
    if n is None:
        return 1
    evals = api.node_purge(n.id)
    print(f"Node {n.id[:8]} purged ({len(evals)} reschedule eval(s))")
    return 0


def cmd_node_drain(args) -> int:
    from .structs.node import DrainStrategy

    api = _client(args)
    if args.enable:
        spec = DrainStrategy(deadline_s=args.deadline,
                             ignore_system_jobs=args.ignore_system)
        api.drain_node(args.node_id, spec)
        print(f"Node {args.node_id[:8]} drain strategy set")
    else:
        api.drain_node(args.node_id, None)
        print(f"Node {args.node_id[:8]} drain disabled")
    return 0


def cmd_node_eligibility(args) -> int:
    api = _client(args)
    elig = "eligible" if args.enable else "ineligible"
    api.node_eligibility(args.node_id, elig)
    print(f"Node {args.node_id[:8]} scheduling eligibility: {elig}")
    return 0


# ---- alloc / eval ----

def cmd_alloc_status(args) -> int:
    api = _client(args)
    matches = [a for a in api.allocations()
               if a.id.startswith(args.alloc_id)]
    if len(matches) != 1:
        print(f"{len(matches)} allocations match {args.alloc_id!r}",
              file=sys.stderr)
        return 1
    a = api.allocation(matches[0].id)
    print(f"ID            = {a.id}")
    print(f"Name          = {a.name}")
    print(f"Node ID       = {a.node_id}")
    print(f"Job ID        = {a.job_id}")
    print(f"Desired       = {a.desired_status}")
    print(f"Client Status = {a.client_status}")
    for task, ts in (a.task_states or {}).items():
        print(f"\nTask {task!r} is {ts.state} "
              f"(failed={ts.failed}, restarts={ts.restarts})")
        for e in ts.events[-8:]:
            stamp = time.strftime("%H:%M:%S", time.localtime(e.time))
            print(f"  {stamp}  {e.type:<16} {e.message}")
    return 0


def _resolve_alloc(api, prefix: str):
    matches = [a for a in api.allocations() if a.id.startswith(prefix)]
    if len(matches) != 1:
        print(f"{len(matches)} allocations match {prefix!r}",
              file=sys.stderr)
        return None
    return matches[0]


def cmd_alloc_logs(args) -> int:
    """Reference `nomad alloc logs` (command/alloc_logs.go): print a task's
    stdout/stderr; -f tails by polling the log endpoint."""
    api = _client(args)
    a = _resolve_alloc(api, args.alloc_id)
    if a is None:
        return 1
    task = args.task
    if not task:
        tasks = list((a.task_states or {}).keys()) or (
            [t.name for tg in (a.job.task_groups if a.job else [])
             if tg.name == a.task_group for t in tg.tasks])
        if len(tasks) != 1:
            print("error: allocation has multiple tasks; specify one",
                  file=sys.stderr)
            return 1
        task = tasks[0]
    logtype = "stderr" if args.stderr else "stdout"
    try:
        data, frame, pos = api.alloc_logs_from(a.id, task, type=logtype)
    except ApiError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    sys.stdout.write(data.decode(errors="replace"))
    while args.follow:
        # (frame, pos) cursor survives log rotation reaps, unlike
        # concatenation offsets
        time.sleep(1.0)
        try:
            data, frame, pos = api.alloc_logs_from(
                a.id, task, type=logtype, frame=frame, pos=pos)
        except ApiError:
            break
        if data:
            sys.stdout.write(data.decode(errors="replace"))
            sys.stdout.flush()
    return 0


def cmd_alloc_exec(args) -> int:
    """Reference `nomad alloc exec` (command/alloc_exec.go),
    non-streaming: run, print output, propagate the exit code."""
    api = _client(args)
    a = _resolve_alloc(api, args.alloc_id)
    if a is None:
        return 1
    cmd = [c for c in args.cmd if c != "--"]
    if not cmd:
        print("error: no command given", file=sys.stderr)
        return 1
    try:
        out = api.alloc_exec(a.id, cmd, task=args.task)
    except ApiError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if out.get("stdout"):
        sys.stdout.write(out["stdout"])
    if out.get("stderr"):
        sys.stderr.write(out["stderr"])
    return int(out.get("exit_code", 0))


def cmd_alloc_fs(args) -> int:
    """Reference `nomad alloc fs` (command/alloc_fs.go): ls/cat inside the
    alloc dir."""
    api = _client(args)
    a = _resolve_alloc(api, args.alloc_id)
    if a is None:
        return 1
    path = args.path or "/"
    try:
        st = api.alloc_fs_stat(a.id, path)
        if st["IsDir"]:
            entries = api.alloc_fs_list(a.id, path)
            rows = [[("d" if e["IsDir"] else "-"), str(e["Size"]),
                     e["Name"]] for e in entries]
            print(_columns(rows, ["Mode", "Size", "Name"]))
        else:
            sys.stdout.write(
                api.alloc_fs_cat(a.id, path).decode(errors="replace"))
    except ApiError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


def cmd_operator_snapshot(args) -> int:
    """Reference `nomad operator snapshot save|restore`
    (command/operator_snapshot_*.go)."""
    api = _client(args)
    if args.action == "save":
        data = api.operator_snapshot_save()
        with open(args.file, "wb") as f:
            f.write(data)
        print(f"Snapshot written to {args.file} ({len(data)} bytes)")
        return 0
    with open(args.file, "rb") as f:
        api.operator_snapshot_restore(f.read())
    print(f"Snapshot restored from {args.file}")
    return 0


def cmd_monitor(args) -> int:
    """Reference `nomad monitor` (command/monitor.go): tail agent logs."""
    api = _client(args)
    since = 0.0
    try:
        while True:
            for rec in api.agent_monitor(since=since,
                                         log_level=args.log_level):
                stamp = time.strftime("%H:%M:%S",
                                      time.localtime(rec["Time"]))
                print(f"{stamp} [{rec['Level']}] {rec['Name']}: "
                      f"{rec['Message']}")
                since = max(since, rec["Time"])
            if not args.follow:
                return 0
            time.sleep(1.0)
    except KeyboardInterrupt:
        return 0


def cmd_eval_status(args) -> int:
    api = _client(args)
    ev = api.evaluation(args.eval_id)
    print(f"ID          = {ev.id}")
    print(f"Status      = {ev.status}")
    print(f"Type        = {ev.type}")
    print(f"TriggeredBy = {ev.triggered_by}")
    print(f"Job ID      = {ev.job_id}")
    if ev.status_description:
        print(f"Description = {ev.status_description}")
    return 0


def cmd_eval_trace(args) -> int:
    """`nomad-tpu eval trace <id>`: ordered lifecycle spans for one
    evaluation (lib/trace.py span taxonomy; no reference analog — the
    observability counterpart of `eval status -verbose`)."""
    from .api import ApiError

    api = _client(args)
    try:
        tr = api.evaluation_trace(args.eval_id)
    except (ApiError, OSError) as e:
        # unknown/evicted id (404) or unreachable agent: one-line
        # error + exit 1, never a traceback
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(f"Eval   = {tr.get('eval_id', args.eval_id)}")
    print(f"Status = {tr.get('status', '')}")
    rows = [[s["phase"], f"{s['start_s'] * 1e3:.3f}",
             f"{s['duration_ms']:.3f}"] for s in tr.get("spans", [])]
    print(_columns(rows, ["Phase", "Start (ms)", "Duration (ms)"]))
    return 0


def _fmt_counts(d: dict) -> str:
    return ", ".join(f"{k}={int(v)}" for k, v in sorted((d or {}).items()))


def _print_metric_detail(m, indent: str) -> None:
    """Shared AllocMetric detail block: filter/exhaustion counts + the
    ranked top-K score breakdown (one formatter so the failed-placement
    and -verbose views cannot drift)."""
    if m.constraint_filtered:
        print(f"{indent}Filtered by: {_fmt_counts(m.constraint_filtered)}")
    if m.dimension_exhausted:
        print(f"{indent}Exhausted dimensions: "
              f"{_fmt_counts(m.dimension_exhausted)}")
    for rank, sm in enumerate(m.score_meta):
        print(f"{indent}#{rank + 1} {sm.node_id[:8]}  "
              f"norm={sm.norm_score:.4f}  "
              + " ".join(f"{k}={v:.3f}"
                         for k, v in sorted(sm.scores.items())
                         if k != "normalized-score"))


def cmd_eval_placement(args) -> int:
    """`nomad-tpu eval placement <id>`: placement explainability for one
    evaluation — the kernel-native AllocMetric (nodes evaluated /
    filtered / exhausted, per-constraint and per-dimension counts, top-K
    score breakdown) for everything the eval placed or failed to place
    (the `nomad alloc status -verbose` metrics block, eval-wide)."""
    from .api import ApiError

    api = _client(args)
    try:
        out = api.evaluation_placement(args.eval_id)
    except (ApiError, OSError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(f"Eval    = {out.get('eval_id', args.eval_id)}")
    print(f"Status  = {out.get('status', '')}")
    if out.get("status_description"):
        print(f"Desc    = {out['status_description']}")
    if out.get("blocked_eval"):
        print(f"Blocked = {out['blocked_eval']}")
    failed = out.get("failed_tg_allocs") or {}
    if failed:
        print("\nFailed placements:")
        for tg, m in sorted(failed.items()):
            print(f"  Group {tg!r}: {m.nodes_evaluated} evaluated, "
                  f"{m.nodes_filtered} filtered, "
                  f"{m.nodes_exhausted} exhausted"
                  + (f", {m.coalesced_failures} more failures coalesced"
                     if m.coalesced_failures else ""))
            _print_metric_detail(m, "    ")
    placements = out.get("placements") or []
    if placements:
        rows = []
        for p in placements:
            m = p["metrics"]
            rows.append([p["alloc_id"][:8], p["task_group"],
                         (p.get("node_name") or p["node_id"][:8]),
                         str(m.nodes_evaluated), str(m.nodes_filtered),
                         str(m.nodes_exhausted),
                         f"{m.score_meta[0].norm_score:.4f}"
                         if m.score_meta else "-"])
        print()
        print(_columns(rows, ["Alloc", "Group", "Node", "Evaluated",
                              "Filtered", "Exhausted", "Score"]))
        if getattr(args, "verbose", False):
            for p in placements:
                m = p["metrics"]
                if not (m.score_meta or m.dimension_exhausted
                        or m.constraint_filtered):
                    continue
                print(f"\nAlloc {p['alloc_id'][:8]} "
                      f"(group {p['task_group']!r}):")
                _print_metric_detail(m, "  ")
    if not failed and not placements:
        print("\nNo placements and no failed task groups recorded "
              "(no-op eval, or the eval predates explainability)")
    return 0


def cmd_operator_metrics(args) -> int:
    """`nomad-tpu operator metrics [-format prometheus]` — dump the
    agent's telemetry (command/operator_metrics.go analog: the raw
    /v1/metrics surface, or Prometheus exposition text)."""
    api = _client(args)
    if args.format == "prometheus":
        sys.stdout.write(api.metrics_prometheus())
        return 0
    m = api.metrics()
    if args.json:
        print(json.dumps(m, indent=2, default=str))
        return 0
    for k in ("uptime_s", "state_index", "broker_ready", "broker_unacked",
              "blocked_evals", "client_allocs"):
        if k in m:
            print(f"{k:20} = {m[k]}")
    for section in ("broker", "plan_apply"):
        for k, v in sorted((m.get(section) or {}).items()):
            print(f"{section}.{k:20} = {v}")
    phases = m.get("eval_phases") or {}
    if phases:
        print()
        rows = [[name, str(s["count"]), f"{s['p50']:.3f}",
                 f"{s['p95']:.3f}", f"{s['p99']:.3f}", f"{s['max']:.3f}"]
                for name, s in sorted(phases.items())]
        print(_columns(rows, ["Eval Phase", "Count", "p50 (ms)",
                              "p95 (ms)", "p99 (ms)", "max (ms)"]))
    return 0


# ---- deployment ----

def cmd_deployment_list(args) -> int:
    api = _client(args)
    print(_columns(
        [[d.id[:8], d.job_id, d.status, d.status_description]
         for d in api.deployments()],
        ["ID", "Job ID", "Status", "Description"]))
    return 0


def cmd_deployment_status(args) -> int:
    api = _client(args)
    d = api.deployment(args.deployment_id)
    print(f"ID     = {d.id}")
    print(f"Job ID = {d.job_id}")
    print(f"Status = {d.status}")
    rows = []
    for tg, s in d.task_groups.items():
        rows.append([tg, str(s.desired_total), str(s.placed_allocs),
                     str(s.healthy_allocs), str(s.unhealthy_allocs),
                     str(s.promoted)])
    print(_columns(rows, ["Group", "Desired", "Placed", "Healthy",
                          "Unhealthy", "Promoted"]))
    return 0


def cmd_deployment_promote(args) -> int:
    api = _client(args)
    api.promote_deployment(args.deployment_id)
    print(f"Deployment {args.deployment_id[:8]} promoted")
    return 0


def cmd_deployment_fail(args) -> int:
    api = _client(args)
    api.fail_deployment(args.deployment_id)
    print(f"Deployment {args.deployment_id[:8]} marked failed")
    return 0


def cmd_operator_timeline(args) -> int:
    """`nomad-tpu operator timeline` — per-dispatch pipeline records
    (/v1/scheduler/timeline): pack/view/kernel intervals plus how much
    of each dispatch's pack hid under the predecessor's kernel
    (overlap) and the device idle between kernels (bubble). The summary
    line is the quick read; `-json` dumps raw records for tooling."""
    from .api import ApiError

    api = _client(args)
    try:
        tl = api.scheduler_timeline(index=args.index, wait=args.wait)
        summ = api.scheduler_timeline_summary().get("summary", {})
    except (ApiError, OSError) as e:
        # timeline-less server (501), bad args, or unreachable agent:
        # one-line error + exit 1, never a traceback
        print(f"Error: {e}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps({"summary": summ, **tl}, indent=2, default=str))
        return 0
    print(f"Index        = {tl.get('index', 0)}")
    print(f"Dispatches   = {summ.get('dispatches', 0)} retained")
    print(f"Overlap      = {summ.get('overlap_pct', 0.0):.1f}% of pack "
          f"hidden under the in-flight kernel")
    print(f"Bubble       = {summ.get('bubble_ms_mean', 0.0):.3f} ms mean "
          f"device idle between kernels")
    print(f"Transfer     = {summ.get('transfer_bytes_per_dispatch', 0.0):.0f}"
          f" B / {summ.get('transfer_count_per_dispatch', 0.0):.1f} "
          f"transfers per dispatch")
    recs = tl.get("dispatches", [])
    if recs:
        print()

        def fmt(v, nd=2):
            return "-" if v is None else f"{v:.{nd}f}"

        rows = [[str(r["seq"]), str(r["programs"]),
                 "yes" if r["batched"] else "no",
                 fmt(r["pack_ms"]), fmt(r.get("upload_ms")),
                 fmt(r["view_ms"]), fmt(r["kernel_ms"]),
                 fmt(r["overlap_ms"]), fmt(r["bubble_ms"]),
                 str(r["transfer_bytes"])]
                for r in recs]
        print(_columns(rows, ["Seq", "Progs", "Fused", "Pack (ms)",
                              "Upload (ms)", "View (ms)", "Kernel (ms)",
                              "Overlap (ms)", "Bubble (ms)", "Bytes"]))
    return 0


def _fmt_bytes(n) -> str:
    n = float(n)
    for unit in ("B", "KB", "MB", "GB"):
        if abs(n) < 1024.0 or unit == "GB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    return f"{n:.1f} GB"


def cmd_operator_hbm(args) -> int:
    """`nomad-tpu operator hbm [-watermarks] [-plan -nodes N -allocs M]`
    — device-buffer residency (/v1/operator/hbm): what is living in HBM
    per site and shard, whether any view lease is stuck past the age
    watermark, and — with `-plan` — whether a target cluster size fits
    one device or how many node-axis shards it needs (the ROADMAP
    item-3 "will it fit / when to shard" read)."""
    from .api import ApiError

    plan = None
    if args.plan:
        # malformed -plan args: one-line error + exit 1, the eval
        # trace / operator timeline convention
        if args.nodes is None or args.allocs is None:
            print("Error: -plan requires -nodes and -allocs",
                  file=sys.stderr)
            return 1
        if args.nodes <= 0 or args.allocs < 0:
            print(f"Error: -plan needs nodes > 0 and allocs >= 0 "
                  f"(got nodes={args.nodes}, allocs={args.allocs})",
                  file=sys.stderr)
            return 1
        plan = (args.nodes, args.allocs)
    api = _client(args)
    try:
        out = api.operator_hbm(watermarks=args.watermarks, plan=plan)
    except (ApiError, OSError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(out, indent=2, default=str))
        return 0
    summ = out.get("summary", {})
    rec = out.get("reconciliation", {})
    print(f"Live         = {_fmt_bytes(summ.get('live_bytes', 0))} in "
          f"{summ.get('buffers', 0)} device buffers")
    print(f"Peak         = {_fmt_bytes(summ.get('peak_bytes', 0))}")
    print(f"Leases       = {summ.get('outstanding_leases', 0)} "
          f"outstanding (high water {summ.get('lease_high_water', 0)}, "
          f"oldest ever {summ.get('lease_age_high_water_s', 0.0):.1f}s, "
          f"watermark {summ.get('lease_watermark_s', 0.0):.0f}s)")
    cov = rec.get("coverage_pct")
    if cov is not None:
        print(f"Coverage     = {cov:.1f}% of allocator bytes_in_use "
              f"({_fmt_bytes(rec.get('device_bytes_in_use') or 0)}) "
              f"is ledger-attributed")
    else:
        print("Coverage     = n/a (backend exposes no memory_stats)")
    sites = out.get("sites", {})
    if sites:
        print()
        rows = [[site, _fmt_bytes(v["live_bytes"]), str(v["buffers"]),
                 _fmt_bytes(v["peak_bytes"])]
                for site, v in sorted(
                    sites.items(),
                    key=lambda kv: -kv[1]["live_bytes"])]
        print(_columns(rows, ["Site", "Live", "Buffers", "Peak"]))
    if args.watermarks:
        leases = out.get("leases", [])
        print()
        if leases:
            rows = [[str(l["token"]), l["site"], f"{l['age_s']:.1f}",
                     "STUCK" if l["stuck"] else "ok"]
                    for l in leases]
            print(_columns(rows, ["Token", "Site", "Age (s)", "State"]))
        else:
            print("No outstanding leases")
    p = out.get("plan")
    if p:
        print()
        print(f"Plan for {p['nodes']} nodes / {p['allocs']} allocs "
              f"(row capacity {p['projected_n_cap']}):")
        if not p.get("measured"):
            print("  WARNING: no node-axis residency measured yet — "
                  "projection covers fixed/transient state only")
        print(f"  projected  = {_fmt_bytes(p['projected_bytes'])} "
              f"({_fmt_bytes(p['per_node_bytes'])}/node x "
              f"{p['projected_n_cap']} + "
              f"{_fmt_bytes(p['fixed_bytes'])} fixed + "
              f"{_fmt_bytes(p['transient_peak_bytes'])} transient)")
        print(f"  device     = {_fmt_bytes(p['device_limit_bytes'])} "
              f"({p['limit_source']})")
        if p["fits"]:
            print(f"  fits: yes — headroom "
                  f"{_fmt_bytes(p['headroom_bytes'])}")
        elif p["shards_needed"]:
            print(f"  fits: NO — short {_fmt_bytes(-p['headroom_bytes'])}"
                  f"; shard the node axis over {p['shards_needed']} "
                  f"devices (parallel/mesh.py cluster_sharding)")
        else:
            print(f"  fits: NO — short {_fmt_bytes(-p['headroom_bytes'])}"
                  f", and the replicated per-shard state (fixed + "
                  f"transient) leaves no workable node budget on any "
                  f"sane mesh — node-axis sharding cannot help; shrink "
                  f"the program table / dispatch width first")
    return 0


# ---- operator / misc ----

def cmd_quota(args) -> int:
    """`nomad-tpu quota apply|list|delete|status` (the reference's ent
    quota commands)."""
    api = _client(args)
    if args.sub == "list":
        print(_columns(
            [[q.name, str(q.cpu) if q.cpu else "∞",
              str(q.memory_mb) if q.memory_mb else "∞"]
             for q in api.quotas()],
            ["Name", "CPU(MHz)", "Memory(MB)"]))
        return 0
    if args.sub == "apply":
        api.quota_apply(args.name, cpu=args.cpu,
                        memory_mb=args.memory,
                        description=args.description or "")
        print(f"Successfully applied quota {args.name!r}")
        return 0
    if args.sub == "delete":
        api.quota_delete(args.name)
        print(f"Successfully deleted quota {args.name!r}")
        return 0
    u = api.quota_usage(args.name)
    print(f"Name       = {u['quota']}")
    print(f"CPU        = {u['cpu_used']:.0f} / "
          f"{u['cpu_limit'] or '∞'} MHz")
    print(f"Memory     = {u['memory_mb_used']:.0f} / "
          f"{u['memory_mb_limit'] or '∞'} MB")
    print(f"Namespaces = {', '.join(u['namespaces']) or '<none>'}")
    return 0


def cmd_namespace(args) -> int:
    """`nomad-tpu namespace list|apply|delete|status`
    (command/namespace_*.go)."""
    api = _client(args)
    if args.sub == "list":
        print(_columns(
            [[n.name, n.description or "<none>"]
             for n in api.namespaces()],
            ["Name", "Description"]))
        return 0
    if args.sub == "apply":
        api.namespace_apply(args.name,
                            description=args.description or "",
                            quota=getattr(args, "quota", "") or "")
        print(f"Successfully applied namespace {args.name!r}")
        return 0
    if args.sub == "delete":
        api.namespace_delete(args.name)
        print(f"Successfully deleted namespace {args.name!r}")
        return 0
    n = api.namespace(args.name)
    print(f"Name        = {n.name}")
    print(f"Description = {n.description or '<none>'}")
    return 0


def cmd_secret(args) -> int:
    """`nomad-tpu secret put|get|list|delete` — built-in KV engine."""
    api = _client(args)
    if args.sub == "list":
        for e in api.secrets_list(namespace=args.namespace):
            print(f"{e['path']}  v{e['version']}  "
                  f"keys={','.join(e['keys'])}")
        return 0
    if args.sub == "get":
        entry = api.secret_get(args.path, namespace=args.namespace)
        for k in sorted(entry.data):
            print(f"{k}={entry.data[k]}")
        return 0
    if args.sub == "delete":
        api.secret_delete(args.path, namespace=args.namespace)
        print(f"Deleted secret {args.path!r}")
        return 0
    data = {}
    for kv in args.kv:
        k, sep, v = kv.partition("=")
        if not sep:
            print(f"Error: expected key=value, got {kv!r}",
                  file=sys.stderr)
            return 1
        data[k] = v
    api.secret_put(args.path, data, namespace=args.namespace)
    print(f"Wrote secret {args.path!r} ({len(data)} keys)")
    return 0


def cmd_service_list(args) -> int:
    """`nomad-tpu service list` (native service discovery)."""
    rows = _client(args).services(namespace=args.namespace)
    print(_columns(
        [[s["service_name"], ",".join(s["tags"]) or "<none>",
          f'{s["passing"]}/{s["count"]}'] for s in rows],
        ["Service", "Tags", "Healthy"]))
    return 0


def cmd_service_info(args) -> int:
    regs = _client(args).service(args.name, namespace=args.namespace)
    if not regs:
        print(f"No instances of service {args.name!r}", file=sys.stderr)
        return 1
    print(_columns(
        [[r.id[-20:], f"{r.address}:{r.port}", r.status, r.alloc_id[:8],
          r.node_id[:8]] for r in regs],
        ["ID", "Address", "Status", "Alloc", "Node"]))
    return 0


_EXAMPLE_SPEC = '''\
# Example job specification (`nomad-tpu job init`; reference
# command/job_init.go). Run with: nomad-tpu job run example.nomad
job "example" {
  datacenters = ["dc1"]
  type        = "service"

  group "cache" {
    count = 1

    service {
      name = "redis-cache"
      port = "db"
      check {
        type     = "tcp"
        interval = "10s"
        timeout  = "2s"
      }
      # uncomment for the native service mesh:
      # connect { sidecar_service {} }
    }

    task "redis" {
      driver = "raw_exec"

      config {
        command = "/bin/sh"
        args    = ["-c", "echo serving on $NOMAD_PORT_DB; sleep 3600"]
      }

      resources {
        cpu    = 500
        memory = 256
        network {
          mbits = 10
          port "db" {}
        }
      }
    }
  }
}
'''


def cmd_job_init(args) -> int:
    """`nomad-tpu job init` (command/job_init.go): write example.nomad."""
    dest = args.filename
    try:
        with open(dest, "x") as f:  # exclusive: never clobber
            f.write(_EXAMPLE_SPEC)
    except FileExistsError:
        print(f"error: {dest!r} already exists", file=sys.stderr)
        return 1
    print(f"Example job file written to {dest}")
    return 0


def cmd_job_eval(args) -> int:
    """`nomad-tpu job eval` — force a new evaluation without changes."""
    api = _client(args)
    try:
        eval_id = api.job_evaluate(args.job_id, namespace=args.namespace)
    except ApiError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(f'Created evaluation {eval_id[:8]} for job "{args.job_id}"')
    if args.detach:
        return 0
    return _monitor(api, eval_id)


def cmd_intention_list(args) -> int:
    """`nomad-tpu connect intention-list` (mesh authorization rules)."""
    rows = _client(args).connect_intentions()
    if not rows:
        print("No intentions (default: allow)")
        return 0
    print(_columns(
        [[r["Source"], r["Destination"], r["Action"]] for r in rows],
        ["Source", "Destination", "Action"]))
    return 0


def cmd_intention_create(args) -> int:
    _client(args).connect_intention_upsert(
        args.source, args.destination, args.action)
    print(f"Intention {args.source} -> {args.destination}: {args.action}")
    return 0


def cmd_intention_delete(args) -> int:
    _client(args).connect_intention_delete(args.source, args.destination)
    print(f"Deleted intention {args.source} -> {args.destination}")
    return 0


def cmd_agent_info(args) -> int:
    """`nomad-tpu agent-info` (command/agent_info.go)."""
    info = _client(args).agent_self()
    for k in sorted(info):
        print(f"{k} = {info[k]}")
    return 0


def cmd_server_join(args) -> int:
    """`nomad-tpu server join <host:port>` (command/server_join.go)."""
    out = _client(args).agent_join(args.join_address)
    n = out.get("num_joined", 0)
    print(f"Joined {n} server(s)")
    return 0 if n else 1


def cmd_server_force_leave(args) -> int:
    """`nomad-tpu server force-leave <name>`
    (command/server_force_leave.go)."""
    out = _client(args).agent_force_leave(args.node)
    print(f"Member {out['left']!r} marked left")
    return 0


def cmd_volume(args) -> int:
    """`nomad-tpu volume register|deregister|status`
    (command/volume_*.go)."""
    api = _client(args)
    if args.sub == "register":
        from .jobspec.hcl import parse_hcl
        from .structs.csi import CSIVolume

        with open(args.spec) as f:
            tree = parse_hcl(f.read())

        def one(v):
            return v[0] if isinstance(v, list) and v else (v or {})

        body = one(tree.get("volume")) or tree
        if isinstance(body, dict) and len(body) == 1 \
                and isinstance(next(iter(body.values())), (list, dict)):
            (vid, vbody), = body.items()
            body = dict(one(vbody), id=vid)
        vol = CSIVolume(
            id=str(body.get("id", "")),
            name=str(body.get("name", body.get("id", ""))),
            namespace=str(body.get("namespace", "default")),
            plugin_id=str(body.get("plugin_id", "")),
            access_mode=str(body.get("access_mode",
                                     "single-node-writer")),
            attachment_mode=str(body.get("attachment_mode",
                                         "file-system")),
            controller_required=bool(body.get("controller_required",
                                              False)))
        if not vol.id or not vol.plugin_id:
            print("Error: volume spec needs id and plugin_id",
                  file=sys.stderr)
            return 1
        api.csi_volume_register(vol)
        print(f"Registered volume {vol.id!r}")
        return 0
    if args.sub == "deregister":
        api.csi_volume_deregister(args.volume_id,
                                  namespace=args.namespace)
        print(f"Deregistered volume {args.volume_id!r}")
        return 0
    vols = api.csi_volumes()
    if getattr(args, "volume_id", ""):
        vols = [v for v in vols if v.id.startswith(args.volume_id)]
        if not vols:
            print(f"No volume matches {args.volume_id!r}",
                  file=sys.stderr)
            return 1
    print(_columns(
        [[v.id, v.plugin_id, v.access_mode,
          "yes" if v.schedulable else "no",
          str(len(v.read_claims) + len(v.write_claims))]
         for v in vols],
        ["ID", "Plugin", "Access", "Schedulable", "Claims"]))
    return 0


def cmd_plugin_status(args) -> int:
    """`nomad-tpu plugin status` (command/plugin_status.go)."""
    rows = _client(args).plugins()
    print(_columns(
        [[p.id, p.provider or "csi",
          f"{p.nodes_healthy}/{p.nodes_expected}",
          f"{p.controllers_healthy}/{p.controllers_expected}"]
         for p in rows],
        ["ID", "Provider", "Nodes", "Controllers"]))
    return 0


def cmd_scaling(args) -> int:
    """`nomad-tpu scaling policies|policy <id>`
    (command/scaling_policy_*.go)."""
    api = _client(args)
    if args.sub == "policies":
        print(_columns(
            [[sp.id[:8], sp.target.get("Job", ""),
              sp.target.get("Group", ""), str(sp.min), str(sp.max),
              str(sp.enabled).lower()] for sp in api.scaling_policies()],
            ["ID", "Job", "Group", "Min", "Max", "Enabled"]))
        return 0
    sp = api.scaling_policy(args.policy_id)
    print(f"ID      = {sp.id}")
    print(f"Target  = {sp.target}")
    print(f"Min/Max = {sp.min}/{sp.max}")
    print(f"Enabled = {sp.enabled}")
    return 0


def cmd_deployment_pause(args) -> int:
    _client(args).pause_deployment(args.deployment_id, pause=True)
    print(f"Deployment {args.deployment_id[:8]} paused")
    return 0


def cmd_deployment_resume(args) -> int:
    _client(args).pause_deployment(args.deployment_id, pause=False)
    print(f"Deployment {args.deployment_id[:8]} resumed")
    return 0


def cmd_regions_list(args) -> int:
    """`nomad-tpu regions list` (command/regions.go)."""
    for r in _client(args).regions():
        print(r)
    return 0


def cmd_server_members(args) -> int:
    api = _client(args)
    out = api._request("GET", "/v1/agent/members")
    print(_columns([[m["name"], str(m["addr"])]
                    for m in out.get("members", [])],
                   ["Name", "Addr"]))
    return 0


def cmd_operator_raft_list(args) -> int:
    """`operator raft list-peers` (command/operator_raft_list.go)."""
    cfg = _client(args).raft_configuration()
    print(_columns(
        [[s["id"], s["address"], "leader" if s["leader"] else "follower",
          str(s["voter"]).lower()] for s in cfg["servers"]],
        ["Node", "Address", "State", "Voter"]))
    return 0


def cmd_operator_raft_remove(args) -> int:
    """`operator raft remove-peer` (command/operator_raft_remove.go)."""
    out = _client(args).raft_remove_peer(args.peer_id)
    print(f"Removed peer {out['removed']} from the Raft configuration")
    return 0


def cmd_operator_autopilot_get(args) -> int:
    cfg = _client(args).autopilot_config()
    print(f"CleanupDeadServers      = {cfg.cleanup_dead_servers}")
    print(f"LastContactThreshold    = {cfg.last_contact_threshold_s}s")
    print(f"MaxTrailingLogs         = {cfg.max_trailing_logs}")
    print(f"ServerStabilizationTime = {cfg.server_stabilization_time_s}s")
    return 0


def cmd_operator_autopilot_set(args) -> int:
    api = _client(args)
    cfg = api.autopilot_config()
    if args.cleanup_dead_servers is not None:
        cfg.cleanup_dead_servers = args.cleanup_dead_servers == "true"
    if args.max_trailing_logs is not None:
        cfg.max_trailing_logs = args.max_trailing_logs
    if args.last_contact_threshold is not None:
        cfg.last_contact_threshold_s = args.last_contact_threshold
    api.set_autopilot_config(cfg)
    print("Autopilot configuration updated!")
    return 0


def cmd_operator_autopilot_health(args) -> int:
    h = _client(args).autopilot_health()
    print(f"Healthy            = {h['healthy']}")
    print(f"FailureTolerance   = {h['failure_tolerance']}")
    print(_columns(
        [[s["id"], s["address"],
          "leader" if s.get("leader") else "follower",
          str(s["healthy"]).lower()] for s in h["servers"]],
        ["Node", "Address", "State", "Healthy"]))
    return 0


def _client_for_base(args, base: str):
    """NomadClient for a scheme-qualified base URL (a gossip member's
    `http_addr` tag), inheriting the invocation's token/TLS settings."""
    import re as _re

    m = _re.match(r"^(?P<scheme>https?)://(?P<host>\[[^\]]+\]|[^:/]+)"
                  r":(?P<port>\d+)/?$", base)
    if m is None:
        raise ValueError(f"malformed http_addr {base!r}")
    host = m.group("host").strip("[]")
    https = m.group("scheme") == "https"
    ca = (getattr(args, "ca_cert", None)
          or os.environ.get("NOMAD_CACERT")) if https else None
    if https and not ca:
        raise ValueError(f"{base}: https member needs -ca-cert")
    return NomadClient(
        host, int(m.group("port")),
        token=os.environ.get("NOMAD_TOKEN"), ca_cert=ca,
        client_cert=(getattr(args, "client_cert", None)
                     or os.environ.get("NOMAD_CLIENT_CERT")),
        client_key=(getattr(args, "client_key", None)
                    or os.environ.get("NOMAD_CLIENT_KEY")))


def cmd_operator_debug(args) -> int:
    """`nomad-tpu operator debug` (command/operator_debug.go): capture a
    support bundle into a tar.gz — cluster-wide state dumps from the
    addressed agent, plus EVERY advertised debug section
    (api.DEBUG_SECTIONS: metrics + Prometheus text, dispatch timeline,
    transfer/HBM ledgers, drain stats, flight events, raft/WAL status,
    eval traces) from EVERY reachable server, discovered through the
    gossip members' `http_addr` tags."""
    import io
    import tarfile
    import time as _time

    from .api import DEBUG_SECTIONS, ApiError

    api = _client(args)
    try:
        api.agent_self()  # reachability probe: one-line error + exit 1
    except (ApiError, OSError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    # cluster-wide state from the addressed agent (the reference's
    # one-shot API captures)
    captures = {
        "agent-self.json": lambda: api.agent_self(),
        "members.json": lambda: api._request("GET", "/v1/agent/members"),
        "leader.json": lambda: api.status_leader(),
        "regions.json": lambda: api.regions(),
        "jobs.json": lambda: api._request(
            "GET", "/v1/jobs", params={"namespace": "*"}),
        "nodes.json": lambda: api._request("GET", "/v1/nodes"),
        "allocations.json": lambda: api._request(
            "GET", "/v1/allocations", params={"namespace": "*"}),
        "evaluations.json": lambda: api._request(
            "GET", "/v1/evaluations", params={"namespace": "*"}),
        "deployments.json": lambda: api._request(
            "GET", "/v1/deployments", params={"namespace": "*"}),
        "pprof-threads.json": lambda: api._request(
            "GET", "/v1/agent/pprof"),
        "raft-configuration.json": lambda: api.raft_configuration(),
        "autopilot-health.json": lambda: api.autopilot_health(),
        "monitor.json": lambda: api._request(
            "GET", "/v1/agent/monitor"),
    }
    # per-server debug targets: every alive member advertising an
    # http_addr, falling back to just the addressed agent
    targets = {}
    try:
        members = api._request("GET", "/v1/agent/members") \
            .get("members", [])
    except (ApiError, OSError):
        members = []
    for m in members:
        base = (m.get("tags") or {}).get("http_addr")
        if not base or m.get("status") not in (None, "alive"):
            continue
        try:
            # key by the FULL member name ("<node>.<region>"): bare node
            # ids may collide across federated regions, and a collision
            # here would silently drop a server's capture from the bundle
            targets[m["name"]] = _client_for_base(args, base)
        except ValueError as e:
            print(f"  skipping member {m.get('name')}: {e}",
                  file=sys.stderr)
    if not targets:
        targets = {"self": api}
    out_path = args.output or \
        f"nomad-debug-{_time.strftime('%Y%m%d-%H%M%S')}.tar.gz"
    ok = server_ok = 0
    try:
        tar_cm = tarfile.open(out_path, "w:gz")
    except OSError as e:
        print(f"Error: cannot write bundle {out_path!r}: {e}",
              file=sys.stderr)
        return 1
    with tar_cm as tar:
        def add(name: str, data: bytes) -> None:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            info.mtime = int(_time.time())
            tar.addfile(info, io.BytesIO(data))

        for name, fetch in captures.items():
            try:
                data = json.dumps(fetch(), indent=2, default=str).encode()
                ok += 1
                print(f"  captured {name}")
            except Exception as e:  # noqa: BLE001 — partial bundle is
                data = json.dumps({"error": str(e)}).encode()  # useful
                print(f"  FAILED  {name}: {e}", file=sys.stderr)
            add(name, data)
        for sname, sapi in sorted(targets.items()):
            try:
                dbg = sapi.operator_debug()
            except Exception as e:  # noqa: BLE001 — other servers still
                add(f"server-{sname}/error.json",  # worth capturing
                    json.dumps({"error": str(e)}).encode())
                print(f"  FAILED  server {sname}: {e}", file=sys.stderr)
                continue
            for section in DEBUG_SECTIONS:
                body = dbg.get(section)
                if section == "prometheus":
                    add(f"server-{sname}/prometheus.prom",
                        str(body or "").encode())
                else:
                    add(f"server-{sname}/{section}.json",
                        json.dumps(body, indent=2, default=str).encode())
            server_ok += 1
            print(f"  captured server {sname} "
                  f"({len(DEBUG_SECTIONS)} sections)")
    if server_ok == 0:
        print(f"Error: every server capture failed — is the agent "
              f"reachable? (bundle of error stubs left at {out_path})",
              file=sys.stderr)
        return 1
    print(f"Created debug bundle: {out_path} "
          f"({ok}/{len(captures)} captures, "
          f"{server_ok}/{len(targets)} servers)")
    return 0


def cmd_operator_flight(args) -> int:
    """`nomad-tpu operator flight` — the control-plane flight recorder
    (/v1/operator/flight): leadership changes, plan rejections, error
    streaks, stuck leases, wave-collision spikes, membership churn,
    heartbeat losses, in arrival order with a long-poll cursor."""
    from .api import ApiError

    if args.wait < 0 or args.index < 0:
        print("Error: -index and -wait must be >= 0", file=sys.stderr)
        return 1
    api = _client(args)
    try:
        out = api.operator_flight(
            index=args.index, wait=args.wait,
            types=args.type.split(",") if args.type else None)
    except (ApiError, OSError) as e:
        # unreachable agent or bad args: one-line error + exit 1,
        # never a traceback (the eval trace / operator hbm convention)
        print(f"Error: {e}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(out, indent=2, default=str))
        return 0
    print(f"Index  = {out.get('index', 0)}")
    counts = out.get("counts") or {}
    if counts:
        print("Totals = " + ", ".join(f"{k}={v}"
                                      for k, v in sorted(counts.items())))
    events = out.get("events") or []
    if not events:
        print("\nNo flight events recorded")
        return 0
    rows = []
    for e in events:
        stamp = time.strftime("%H:%M:%S",
                              time.localtime(e.get("time_unix", 0)))
        detail = ", ".join(f"{k}={v}" for k, v in
                           sorted((e.get("detail") or {}).items()))
        rows.append([str(e.get("seq", "")), stamp, e.get("type", ""),
                     e.get("severity", ""), e.get("source", "") or "-",
                     (e.get("key", "") or "-")[:20], detail[:48]])
    print()
    print(_columns(rows, ["Seq", "Time", "Type", "Sev", "Source", "Key",
                          "Detail"]))
    return 0


def cmd_event_stream(args) -> int:
    """`nomad-tpu event stream` — follow the FSM-sourced cluster event
    stream (/v1/event/stream?stream=1, chunked push). `-topic`
    (repeatable, Topic / Topic:key / Topic:*) filters server-side;
    `-index N` resumes past index N (a gap line appears when N predates
    the broker's window); `-json` prints one JSON doc per event.
    Ctrl-C flushes the last delivered index to stderr and exits 0 so
    the cursor survives for the next invocation."""
    from .api import ApiError

    if args.index is not None and args.index < 0:
        print("Error: -index must be >= 0", file=sys.stderr)
        return 1
    api = _client(args)
    last = args.index
    gen = api.event_stream(topics=args.topic or None, index=args.index)
    try:
        for batch in gen:
            last = batch.get("index", last)
            for e in batch.get("events") or []:
                if args.json:
                    print(json.dumps(e, default=str), flush=True)
                elif e.get("type") == "lost-gap":
                    pay = e.get("payload") or {}
                    print(f"[gap] events through index "
                          f"{pay.get('lost_through', e.get('index'))} "
                          f"were evicted; resuming from "
                          f"{pay.get('resume_from')}", flush=True)
                else:
                    print(f"{e.get('index', ''):>8}  "
                          f"{e.get('topic', ''):<10} "
                          f"{e.get('type', ''):<20} "
                          f"{e.get('namespace') or '-':<10} "
                          f"{e.get('key', '')}", flush=True)
    except KeyboardInterrupt:
        # resumable cursor: rerun with `-index <this>` to continue
        if last is not None:
            print(f"last index: {last}", file=sys.stderr)
        return 0
    except (ApiError, OSError) as e:
        # unreachable agent or unknown topic (400): one-line error +
        # exit 1, never a traceback (the operator flight convention)
        print(f"Error: {e}", file=sys.stderr)
        return 1
    finally:
        gen.close()
    return 0


def cmd_trace(args) -> int:
    """`nomad-tpu trace <trace-id>` — stitch one distributed trace back
    together from every gossip-discovered server (each process only
    holds the spans IT emitted) and render the span tree as a
    waterfall. Unreachable servers degrade to a `missing-server`
    annotation under the partial stitch instead of failing the
    command; no spans anywhere is the error case (one line, exit 1)."""
    from .api import ApiError

    if not args.trace_id.strip():
        print("Error: trace id required", file=sys.stderr)
        return 1
    api = _client(args)
    try:
        api.agent_self()  # reachability probe: one-line error + exit 1
    except (ApiError, OSError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    # per-server targets through the gossip members' http_addr tags —
    # the operator-debug discovery idiom
    targets = {}
    try:
        members = api._request("GET", "/v1/agent/members") \
            .get("members", [])
    except (ApiError, OSError):
        members = []
    for m in members:
        base = (m.get("tags") or {}).get("http_addr")
        if not base or m.get("status") not in (None, "alive"):
            continue
        try:
            targets[m["name"]] = _client_for_base(args, base)
        except ValueError as e:
            print(f"  skipping member {m.get('name')}: {e}",
                  file=sys.stderr)
    if not targets:
        targets = {"self": api}
    spans, missing = {}, []
    for sname, sapi in sorted(targets.items()):
        try:
            out = sapi.trace(args.trace_id)
        except Exception as e:  # noqa: BLE001 — partial stitch renders
            missing.append((sname, str(e)))
            continue
        for s in out.get("spans", []):
            # dedup by span id: in-process multi-server tests share one
            # store, and a member can be reachable via two addresses
            spans.setdefault(s.get("span_id", ""), s)
    spans.pop("", None)
    if not spans:
        msg = f"Error: no spans found for trace {args.trace_id!r}"
        if missing:
            msg += f" ({len(missing)} server(s) unreachable)"
        print(msg, file=sys.stderr)
        return 1
    recs = sorted(spans.values(),
                  key=lambda s: (s.get("start_unix", 0.0),
                                 s.get("span_id", "")))
    if args.json:
        print(json.dumps({"trace_id": args.trace_id, "spans": recs,
                          "missing_servers": [m for m, _ in missing]},
                         indent=2, default=str))
        return 0
    t0 = min(s.get("start_unix", 0.0) for s in recs)
    t1 = max(s.get("start_unix", 0.0) + s.get("duration_ms", 0.0) / 1e3
             for s in recs)
    total_ms = max((t1 - t0) * 1e3, 1e-6)
    ids = set(spans)
    kids, roots = {}, []
    for s in recs:
        p = s.get("parent_span_id") or ""
        if p and p in ids:
            kids.setdefault(p, []).append(s)
        else:
            roots.append(s)  # root or remote parent (SDK traceparent)
    print(f"Trace {args.trace_id} — {len(recs)} spans, "
          f"{len(targets) - len(missing)}/{len(targets)} servers, "
          f"{total_ms:.1f}ms")
    width = 32
    rows = []

    def walk(s, depth):
        off = (s.get("start_unix", 0.0) - t0) * 1e3
        dur = s.get("duration_ms", 0.0)
        lo = min(int(off / total_ms * width), width - 1)
        ln = max(min(int(round(dur / total_ms * width)), width - lo), 1)
        bar = " " * lo + "#" * ln
        rows.append(["  " * depth + s.get("name", "?"),
                     s.get("source") or "-", f"[{bar:<{width}}]",
                     f"+{off:.1f}ms", f"{dur:.2f}ms"])
        for c in kids.get(s.get("span_id", ""), []):
            walk(c, depth + 1)

    for r in roots:
        walk(r, 0)
    print(_columns(rows, ["Span", "Source", "Waterfall", "Start",
                          "Duration"]))
    for sname, err in missing:
        print(f"  missing-server: {sname} ({err})")
    return 0


def cmd_operator_scheduler_get(args) -> int:
    api = _client(args)
    cfg = api.scheduler_config()
    print(f"Algorithm          = {cfg.scheduler_algorithm}")
    print(f"Preemption(system) = {cfg.preemption_system_enabled}")
    print(f"Preemption(service)= {cfg.preemption_service_enabled}")
    print(f"Preemption(batch)  = {cfg.preemption_batch_enabled}")
    return 0


def cmd_operator_scheduler_set(args) -> int:
    api = _client(args)
    cfg = api.scheduler_config()
    if args.algorithm:
        cfg.scheduler_algorithm = args.algorithm
    api.set_scheduler_config(cfg)
    print("Scheduler configuration updated")
    return 0


def cmd_system_gc(args) -> int:
    _client(args).system_gc()
    print("System GC triggered")
    return 0


def cmd_status(args) -> int:
    api = _client(args)
    print(f"Leader: {api.status_leader()}")
    info = api.agent_self()
    print(f"Version: {info['version']}")
    return 0


def cmd_version(args) -> int:
    from . import __version__

    print(f"nomad-tpu v{__version__}")
    return 0


def cmd_agent(args) -> int:
    from .agent import Agent, AgentConfig

    if not (args.dev or args.server or args.client or args.config):
        print("Error: must have at least client or server mode enabled "
              "(-dev | -server | -client | -config)", file=sys.stderr)
        return 1
    if args.config:
        # HCL agent configuration file (command/agent/config_parse.go);
        # explicit flags override file values
        with open(args.config) as fh:
            cfg = AgentConfig.from_hcl(fh.read())
        if args.dev or args.server:
            cfg.server = True
        if args.dev or args.client:
            cfg.client = True
        if args.bind is not None:
            cfg.http_host = args.bind
        if args.http_port is not None:
            cfg.http_port = args.http_port
        if args.data_dir:
            cfg.data_dir = args.data_dir
        if not (cfg.server or cfg.client):
            print("Error: config enables neither server nor client",
                  file=sys.stderr)
            return 1
    else:
        cfg = AgentConfig(
            server=args.dev or args.server,
            client=args.dev or args.client,
            http_host=args.bind if args.bind is not None else "127.0.0.1",
            http_port=(args.http_port if args.http_port is not None
                       else 4646),
            data_dir=args.data_dir,
        )
    # the card unless `-device cpu` asks for the CPU; no card raises
    agent = Agent(cfg, device=args.device)
    agent.start()
    # index, don't unpack: IPv6 server_address is a 4-tuple
    host, port = agent.http_addr[0], agent.http_addr[1]
    mode = "+".join(m for m, on in (("server", cfg.server),
                                    ("client", cfg.client)) if on)
    scheme = "https" if agent.http.tls_enabled else "http"
    print(f"==> nomad-tpu agent started ({mode}); "
          f"HTTP on {scheme}://{host}:{port}")
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        print("==> shutting down")
        agent.shutdown()
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="nomad-tpu")
    p.add_argument("-address", default=None,
                   help="HTTP API address (default $NOMAD_ADDR)")
    p.add_argument("-ca-cert", dest="ca_cert", default=None,
                   help="CA certificate for https ($NOMAD_CACERT)")
    p.add_argument("-client-cert", dest="client_cert", default=None,
                   help="client certificate ($NOMAD_CLIENT_CERT)")
    p.add_argument("-client-key", dest="client_key", default=None,
                   help="client key ($NOMAD_CLIENT_KEY)")
    p.add_argument("-region", default=None,
                   help="route to this federated region ($NOMAD_REGION)")
    sub = p.add_subparsers(dest="cmd", required=True)

    rg = sub.add_parser("regions", help="region commands").add_subparsers(
        dest="sub", required=True)
    rgl = rg.add_parser("list")
    rgl.set_defaults(fn=cmd_regions_list)

    nsp = sub.add_parser("namespace",
                         help="namespace commands").add_subparsers(
        dest="sub", required=True)
    nsl = nsp.add_parser("list")
    nsl.set_defaults(fn=cmd_namespace)
    nsa = nsp.add_parser("apply")
    nsa.add_argument("name")
    nsa.add_argument("-description", default="")
    nsa.add_argument("-quota", default="")
    nsa.set_defaults(fn=cmd_namespace)

    qa = sub.add_parser("quota", help="resource quotas").add_subparsers(
        dest="sub", required=True)
    qal = qa.add_parser("list")
    qal.set_defaults(fn=cmd_quota)
    qaa = qa.add_parser("apply")
    qaa.add_argument("name")
    qaa.add_argument("-cpu", type=int, default=0)
    qaa.add_argument("-memory", type=int, default=0)
    qaa.add_argument("-description", default="")
    qaa.set_defaults(fn=cmd_quota)
    qad = qa.add_parser("delete")
    qad.add_argument("name")
    qad.set_defaults(fn=cmd_quota)
    qas = qa.add_parser("status")
    qas.add_argument("name")
    qas.set_defaults(fn=cmd_quota)
    nsd = nsp.add_parser("delete")
    nsd.add_argument("name")
    nsd.set_defaults(fn=cmd_namespace)
    nst = nsp.add_parser("status")
    nst.add_argument("name")
    nst.set_defaults(fn=cmd_namespace)

    sec = sub.add_parser("secret",
                         help="built-in KV secrets").add_subparsers(
        dest="sub", required=True)
    spt = sec.add_parser("put")
    spt.add_argument("path")
    spt.add_argument("kv", nargs="+")
    spt.add_argument("-namespace", default="default")
    spt.set_defaults(fn=cmd_secret)
    sgt = sec.add_parser("get")
    sgt.add_argument("path")
    sgt.add_argument("-namespace", default="default")
    sgt.set_defaults(fn=cmd_secret)
    sls = sec.add_parser("list")
    sls.add_argument("-namespace", default="default")
    sls.set_defaults(fn=cmd_secret)
    sdl = sec.add_parser("delete")
    sdl.add_argument("path")
    sdl.add_argument("-namespace", default="default")
    sdl.set_defaults(fn=cmd_secret)

    svc = sub.add_parser("service",
                         help="service discovery").add_subparsers(
        dest="sub", required=True)
    svl = svc.add_parser("list")
    svl.add_argument("-namespace", default="default")
    svl.set_defaults(fn=cmd_service_list)
    svi = svc.add_parser("info")
    svi.add_argument("name")
    svi.add_argument("-namespace", default="default")
    svi.set_defaults(fn=cmd_service_info)

    conn = sub.add_parser("connect",
                          help="service mesh").add_subparsers(
        dest="sub", required=True)
    cil = conn.add_parser("intention-list")
    cil.set_defaults(fn=cmd_intention_list)
    cic = conn.add_parser("intention-create")
    cic.add_argument("action", choices=["allow", "deny"])
    cic.add_argument("source")
    cic.add_argument("destination")
    cic.set_defaults(fn=cmd_intention_create)
    cid = conn.add_parser("intention-delete")
    cid.add_argument("source")
    cid.add_argument("destination")
    cid.set_defaults(fn=cmd_intention_delete)

    ag = sub.add_parser("agent", help="run an agent")
    ag.add_argument("-dev", action="store_true")
    ag.add_argument("-server", action="store_true")
    ag.add_argument("-client", action="store_true")
    ag.add_argument("-bind", default=None)
    ag.add_argument("-http-port", type=int, default=None)
    ag.add_argument("-data-dir", default=None)
    ag.add_argument("-config", default=None)
    ag.add_argument("-device", default=None,
                    help="where the server places: the card (default) or "
                         "cpu")
    ag.set_defaults(fn=cmd_agent)

    job = sub.add_parser("job", help="job commands").add_subparsers(
        dest="sub", required=True)
    jr = job.add_parser("run")
    jr.add_argument("spec")
    jr.add_argument("-detach", action="store_true")
    jr.set_defaults(fn=cmd_job_run)
    js = job.add_parser("status")
    js.add_argument("job_id", nargs="?")
    js.add_argument("-namespace", default="default")
    js.set_defaults(fn=cmd_job_status)
    jst = job.add_parser("stop")
    jst.add_argument("job_id")
    jst.add_argument("-namespace", default="default")
    jst.add_argument("-detach", action="store_true")
    jst.set_defaults(fn=cmd_job_stop)
    jp = job.add_parser("plan")
    jp.add_argument("spec")
    jp.set_defaults(fn=cmd_job_plan)
    jsc = job.add_parser("scale")
    jsc.add_argument("job_id")
    jsc.add_argument("group_or_count")
    jsc.add_argument("count", nargs="?", type=int, default=None)
    jsc.add_argument("-namespace", default="default")
    jsc.add_argument("-detach", action="store_true")
    jsc.set_defaults(fn=cmd_job_scale)
    ji = job.add_parser("inspect")
    ji.add_argument("job_id")
    ji.add_argument("-namespace", default="default")
    ji.set_defaults(fn=cmd_job_inspect)
    jv = job.add_parser("validate")
    jv.add_argument("spec")
    jv.set_defaults(fn=cmd_job_validate)
    ji = job.add_parser("init")
    ji.add_argument("filename", nargs="?", default="example.nomad")
    ji.set_defaults(fn=cmd_job_init)
    je = job.add_parser("eval")
    je.add_argument("job_id")
    je.add_argument("-namespace", default="default")
    je.add_argument("-detach", action="store_true")
    je.set_defaults(fn=cmd_job_eval)
    jh = job.add_parser("history")
    jh.add_argument("job_id")
    jh.add_argument("-namespace", default="default")
    jh.set_defaults(fn=cmd_job_history)
    jrv = job.add_parser("revert")
    jrv.add_argument("job_id")
    jrv.add_argument("version", type=int)
    jrv.add_argument("-namespace", default="default")
    jrv.add_argument("-detach", action="store_true")
    jrv.set_defaults(fn=cmd_job_revert)
    jd = job.add_parser("dispatch")
    jd.add_argument("job_id")
    jd.add_argument("payload_file", nargs="?", default="")
    jd.add_argument("-meta", action="append", default=[])
    jd.add_argument("-namespace", default="default")
    jd.add_argument("-detach", action="store_true")
    jd.set_defaults(fn=cmd_job_dispatch)
    jpf = job.add_parser("periodic-force")
    jpf.add_argument("job_id")
    jpf.add_argument("-namespace", default="default")
    jpf.add_argument("-detach", action="store_true")
    jpf.set_defaults(fn=cmd_job_periodic_force)

    node = sub.add_parser("node", help="node commands").add_subparsers(
        dest="sub", required=True)
    ns_ = node.add_parser("status")
    ns_.add_argument("node_id", nargs="?")
    ns_.set_defaults(fn=cmd_node_status)
    nd = node.add_parser("drain")
    nd.add_argument("node_id")
    g = nd.add_mutually_exclusive_group(required=True)
    g.add_argument("-enable", action="store_true")
    g.add_argument("-disable", action="store_true")
    nd.add_argument("-deadline", type=float, default=3600.0)
    nd.add_argument("-ignore-system", action="store_true")
    nd.set_defaults(fn=cmd_node_drain)
    np_ = node.add_parser("purge")
    np_.add_argument("node_id")
    np_.set_defaults(fn=cmd_node_purge)
    ne = node.add_parser("eligibility")
    ne.add_argument("node_id")
    g = ne.add_mutually_exclusive_group(required=True)
    g.add_argument("-enable", action="store_true")
    g.add_argument("-disable", action="store_true")
    ne.set_defaults(fn=cmd_node_eligibility)

    al = sub.add_parser("alloc", help="alloc commands").add_subparsers(
        dest="sub", required=True)
    als = al.add_parser("status")
    als.add_argument("alloc_id")
    als.set_defaults(fn=cmd_alloc_status)
    all_ = al.add_parser("logs")
    all_.add_argument("alloc_id")
    all_.add_argument("task", nargs="?", default="")
    all_.add_argument("-stderr", action="store_true")
    all_.add_argument("-f", dest="follow", action="store_true")
    all_.set_defaults(fn=cmd_alloc_logs)
    alf = al.add_parser("fs")
    alf.add_argument("alloc_id")
    alf.add_argument("path", nargs="?", default="/")
    alf.set_defaults(fn=cmd_alloc_fs)
    alst = al.add_parser("stop")
    alst.add_argument("alloc_id")
    alst.add_argument("-detach", action="store_true")
    alst.set_defaults(fn=cmd_alloc_stop)
    alr = al.add_parser("restart")
    alr.add_argument("alloc_id")
    alr.add_argument("task", nargs="?", default="")
    alr.set_defaults(fn=cmd_alloc_restart)
    alsg = al.add_parser("signal")
    alsg.add_argument("-s", dest="signal", default="SIGHUP")
    alsg.add_argument("alloc_id")
    alsg.add_argument("task", nargs="?", default="")
    alsg.set_defaults(fn=cmd_alloc_signal)
    alx = al.add_parser("exec")
    alx.add_argument("-task", default="")
    alx.add_argument("alloc_id")
    # REMAINDER so commands with their own flags pass through unparsed
    # (`alloc exec <id> /bin/sh -c '...'`)
    alx.add_argument("cmd", nargs=argparse.REMAINDER)
    alx.set_defaults(fn=cmd_alloc_exec)

    ev = sub.add_parser("eval", help="eval commands").add_subparsers(
        dest="sub", required=True)
    evs = ev.add_parser("status")
    evs.add_argument("eval_id")
    evs.set_defaults(fn=cmd_eval_status)
    evl = ev.add_parser("list")
    evl.set_defaults(fn=cmd_eval_list)
    evt = ev.add_parser("trace", help="lifecycle spans for one eval")
    evt.add_argument("eval_id")
    evt.set_defaults(fn=cmd_eval_trace)
    evp = ev.add_parser("placement",
                        help="placement explainability for one eval")
    evp.add_argument("eval_id")
    evp.add_argument("-verbose", action="store_true")
    evp.set_defaults(fn=cmd_eval_placement)

    evst = sub.add_parser(
        "event", help="cluster event stream").add_subparsers(
        dest="sub", required=True)
    es = evst.add_parser("stream",
                         help="follow the FSM-sourced event stream")
    es.add_argument("-topic", action="append", default=[],
                    help="Topic / Topic:key / Topic:* filter "
                         "(repeatable)")
    es.add_argument("-index", type=int, default=None,
                    help="resume past this raft index")
    es.add_argument("-json", action="store_true",
                    help="one JSON doc per event")
    es.set_defaults(fn=cmd_event_stream)

    aclp = sub.add_parser("acl", help="ACL commands").add_subparsers(
        dest="sub", required=True)
    ab = aclp.add_parser("bootstrap")
    ab.set_defaults(fn=cmd_acl)
    apa = aclp.add_parser("policy-apply")
    apa.add_argument("name")
    apa.add_argument("rules_file")
    apa.add_argument("-description", default="")
    apa.set_defaults(fn=cmd_acl)
    apl = aclp.add_parser("policy-list")
    apl.set_defaults(fn=cmd_acl)
    apd = aclp.add_parser("policy-delete")
    apd.add_argument("name")
    apd.set_defaults(fn=cmd_acl)
    atc = aclp.add_parser("token-create")
    atc.add_argument("-name", default="")
    atc.add_argument("-type", default="client",
                     choices=["client", "management"])
    atc.add_argument("-policy", action="append", default=[])
    atc.set_defaults(fn=cmd_acl)
    atl = aclp.add_parser("token-list")
    atl.set_defaults(fn=cmd_acl)
    atd = aclp.add_parser("token-delete")
    atd.add_argument("accessor_id")
    atd.set_defaults(fn=cmd_acl)

    dep = sub.add_parser("deployment",
                         help="deployment commands").add_subparsers(
        dest="sub", required=True)
    dl = dep.add_parser("list")
    dl.set_defaults(fn=cmd_deployment_list)
    ds = dep.add_parser("status")
    ds.add_argument("deployment_id")
    ds.set_defaults(fn=cmd_deployment_status)
    dp = dep.add_parser("promote")
    dp.add_argument("deployment_id")
    dp.set_defaults(fn=cmd_deployment_promote)
    df = dep.add_parser("fail")
    df.add_argument("deployment_id")
    df.set_defaults(fn=cmd_deployment_fail)
    dpa = dep.add_parser("pause")
    dpa.add_argument("deployment_id")
    dpa.set_defaults(fn=cmd_deployment_pause)
    dre = dep.add_parser("resume")
    dre.add_argument("deployment_id")
    dre.set_defaults(fn=cmd_deployment_resume)

    srv = sub.add_parser("server", help="server commands").add_subparsers(
        dest="sub", required=True)
    sm = srv.add_parser("members")
    sm.set_defaults(fn=cmd_server_members)
    sj = srv.add_parser("join")
    # NOT named "address": that would clobber the global -address flag
    sj.add_argument("join_address", help="host:port of a server to join")
    sj.set_defaults(fn=cmd_server_join)
    sfl = srv.add_parser("force-leave")
    sfl.add_argument("node", help="gossip member name (node.region)")
    sfl.set_defaults(fn=cmd_server_force_leave)

    ai = sub.add_parser("agent-info", help="agent diagnostics")
    ai.set_defaults(fn=cmd_agent_info)

    vol = sub.add_parser("volume", help="CSI volumes").add_subparsers(
        dest="sub", required=True)
    vs = vol.add_parser("status")
    vs.add_argument("volume_id", nargs="?", default="")
    vs.set_defaults(fn=cmd_volume)
    vr = vol.add_parser("register")
    vr.add_argument("spec")
    vr.set_defaults(fn=cmd_volume)
    vd = vol.add_parser("deregister")
    vd.add_argument("volume_id")
    vd.add_argument("-namespace", default="default")
    vd.set_defaults(fn=cmd_volume)

    plg = sub.add_parser("plugin", help="CSI plugins").add_subparsers(
        dest="sub", required=True)
    ps = plg.add_parser("status")
    ps.set_defaults(fn=cmd_plugin_status)

    sca = sub.add_parser("scaling",
                         help="scaling policies").add_subparsers(
        dest="sub", required=True)
    scp = sca.add_parser("policies")
    scp.set_defaults(fn=cmd_scaling)
    sci = sca.add_parser("policy")
    sci.add_argument("policy_id")
    sci.set_defaults(fn=cmd_scaling)

    tr = sub.add_parser("trace", help="stitch one distributed trace "
                                      "across all servers")
    tr.add_argument("trace_id")
    tr.add_argument("-json", action="store_true")
    tr.set_defaults(fn=cmd_trace)
    op = sub.add_parser("operator", help="operator commands").add_subparsers(
        dest="sub", required=True)
    osn = op.add_parser("snapshot")
    osn.add_argument("action", choices=["save", "restore"])
    osn.add_argument("file")
    osn.set_defaults(fn=cmd_operator_snapshot)
    odb = op.add_parser("debug")
    odb.add_argument("-output", default="")
    odb.set_defaults(fn=cmd_operator_debug)
    orl = op.add_parser("raft-list-peers")
    orl.set_defaults(fn=cmd_operator_raft_list)
    orr = op.add_parser("raft-remove-peer")
    orr.add_argument("-peer-id", dest="peer_id", required=True)
    orr.set_defaults(fn=cmd_operator_raft_remove)
    oag = op.add_parser("autopilot-get-config")
    oag.set_defaults(fn=cmd_operator_autopilot_get)
    oas = op.add_parser("autopilot-set-config")
    oas.add_argument("-cleanup-dead-servers", dest="cleanup_dead_servers",
                     choices=["true", "false"], default=None)
    oas.add_argument("-max-trailing-logs", dest="max_trailing_logs",
                     type=int, default=None)
    oas.add_argument("-last-contact-threshold",
                     dest="last_contact_threshold", type=float,
                     default=None)
    oas.set_defaults(fn=cmd_operator_autopilot_set)
    oah = op.add_parser("autopilot-health")
    oah.set_defaults(fn=cmd_operator_autopilot_health)
    osg = op.add_parser("scheduler-get-config")
    osg.set_defaults(fn=cmd_operator_scheduler_get)
    oss = op.add_parser("scheduler-set-config")
    oss.add_argument("-algorithm", choices=["binpack", "spread"])
    oss.set_defaults(fn=cmd_operator_scheduler_set)
    omt = op.add_parser("metrics", help="agent telemetry dump")
    omt.add_argument("-format", choices=["pretty", "prometheus"],
                     default="pretty")
    omt.add_argument("-json", action="store_true")
    omt.set_defaults(fn=cmd_operator_metrics)
    otl = op.add_parser("timeline",
                        help="dispatch-pipeline timeline (overlap/bubble)")
    otl.add_argument("-index", type=int, default=0,
                     help="only records past this seq (long-poll cursor)")
    otl.add_argument("-wait", type=float, default=0.0,
                     help="block up to this many seconds for new records")
    otl.add_argument("-json", action="store_true")
    otl.set_defaults(fn=cmd_operator_timeline)
    ofl = op.add_parser("flight",
                        help="control-plane flight recorder events")
    ofl.add_argument("-index", type=int, default=0,
                     help="only events past this seq (long-poll cursor)")
    ofl.add_argument("-wait", type=float, default=0.0,
                     help="block up to this many seconds for new events")
    ofl.add_argument("-type", default="",
                     help="comma-separated event-type filter")
    ofl.add_argument("-json", action="store_true")
    ofl.set_defaults(fn=cmd_operator_flight)
    ohb = op.add_parser("hbm",
                        help="device-buffer residency + capacity planner")
    ohb.add_argument("-watermarks", action="store_true",
                     help="list outstanding view leases with ages")
    ohb.add_argument("-plan", action="store_true",
                     help="project a target cluster's device footprint")
    ohb.add_argument("-nodes", type=int, default=None,
                     help="target node count for -plan")
    ohb.add_argument("-allocs", type=int, default=None,
                     help="target allocation count for -plan")
    ohb.add_argument("-json", action="store_true")
    ohb.set_defaults(fn=cmd_operator_hbm)

    sysp = sub.add_parser("system", help="system commands").add_subparsers(
        dest="sub", required=True)
    sg = sysp.add_parser("gc")
    sg.set_defaults(fn=cmd_system_gc)

    st = sub.add_parser("status", help="cluster status")
    st.set_defaults(fn=cmd_status)
    uip = sub.add_parser("ui", help="print the web console URL")
    uip.set_defaults(fn=cmd_ui)
    mon = sub.add_parser("monitor", help="stream agent logs")
    mon.add_argument("-log-level", default="", dest="log_level")
    mon.add_argument("-f", dest="follow", action="store_true")
    mon.set_defaults(fn=cmd_monitor)
    vp = sub.add_parser("version")
    vp.set_defaults(fn=cmd_version)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except ApiError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    except ConnectionRefusedError:
        print("Error: cannot reach the agent HTTP API "
              "(is `nomad-tpu agent` running? set -address/$NOMAD_ADDR)",
              file=sys.stderr)
        return 1
    except BrokenPipeError:
        return 0  # output piped into a closed reader (e.g. `| head`)


if __name__ == "__main__":
    sys.exit(main())
