"""Web console — a single-file reimplementation of the reference UI.

Behavioral reference: `ui/` (an Ember app served from the agent at /ui,
command/agent/http.go UIServer). SURVEY.md scopes it as "thin
reimplementation optional": this page covers the operator read loop —
jobs, nodes, allocations, evaluations, deployments, services, regions —
over the same /v1 JSON API the CLI uses, with drill-down detail panes
and auto-refresh. No external assets: one HTML string, served by the
agent, works against any agent in the cluster."""

INDEX_HTML = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>nomad-tpu</title>
<meta name="viewport" content="width=device-width, initial-scale=1">
<style>
:root {
  --bg: #0f1419; --panel: #171d24; --line: #2a333d; --text: #d8dee6;
  --dim: #8a95a1; --accent: #5ba4cf; --ok: #4caf7d; --warn: #d9a13c;
  --bad: #d96c5f;
}
* { box-sizing: border-box; }
body { margin: 0; background: var(--bg); color: var(--text);
  font: 14px/1.45 -apple-system, "Segoe UI", Roboto, sans-serif; }
header { display: flex; align-items: baseline; gap: 18px;
  padding: 10px 20px; background: var(--panel);
  border-bottom: 1px solid var(--line); }
header h1 { font-size: 16px; margin: 0; color: var(--accent); }
header .crumb { color: var(--dim); font-size: 12px; }
nav { display: flex; gap: 2px; padding: 0 12px; background: var(--panel);
  border-bottom: 1px solid var(--line); }
nav a { padding: 8px 12px; color: var(--dim); text-decoration: none;
  border-bottom: 2px solid transparent; cursor: pointer; }
nav a.active { color: var(--text); border-bottom-color: var(--accent); }
main { padding: 16px 20px; }
table { border-collapse: collapse; width: 100%; }
th, td { text-align: left; padding: 6px 10px;
  border-bottom: 1px solid var(--line); }
th { color: var(--dim); font-weight: 500; font-size: 12px;
  text-transform: uppercase; letter-spacing: .04em; }
tr.row:hover { background: #1c242d; cursor: pointer; }
.pill { display: inline-block; padding: 1px 8px; border-radius: 9px;
  font-size: 12px; }
.ok { background: #173527; color: var(--ok); }
.warn { background: #36290f; color: var(--warn); }
.bad { background: #3a1f1b; color: var(--bad); }
.dim { color: var(--dim); }
pre { background: var(--panel); border: 1px solid var(--line);
  padding: 12px; border-radius: 6px; overflow: auto; font-size: 12px; }
.detail h2 { font-size: 15px; margin: 4px 0 12px; }
.kv { display: grid; grid-template-columns: 180px 1fr; gap: 4px 14px;
  margin-bottom: 14px; }
.kv .k { color: var(--dim); }
.back { color: var(--accent); cursor: pointer; margin-bottom: 10px;
  display: inline-block; }
.err { color: var(--bad); padding: 12px; }
.refresh { margin-left: auto; color: var(--dim); font-size: 12px; }
</style>
</head>
<body>
<header>
  <h1>nomad-tpu</h1>
  <span class="crumb" id="crumb"></span>
  <span class="refresh" id="refresh"></span>
</header>
<nav id="nav"></nav>
<main id="main">loading…</main>
<script>
"use strict";
const TABS = ["jobs", "nodes", "allocations", "evaluations",
              "deployments", "services", "mesh", "servers"];
let tab = "jobs", detail = null, timer = null;

const $ = (id) => document.getElementById(id);
const esc = (s) => String(s ?? "").replace(/[&<>"]/g,
  c => ({"&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;"}[c]));
const short = (id) => esc(String(id || "").slice(0, 8));

async function api(path) {
  const r = await fetch(path);
  if (!r.ok) throw new Error(`${r.status} ${path}`);
  const body = await r.json();
  return (body && body.data !== undefined) ? body.data : body;
}

function pill(status) {
  const ok = ["running", "complete", "ready", "passing", "successful",
              "alive", "true", "allow"];
  const warn = ["pending", "paused", "initializing", "suspect"];
  const cls = ok.includes(String(status)) ? "ok"
    : warn.includes(String(status)) ? "warn" : "bad";
  return `<span class="pill ${cls}">${esc(status)}</span>`;
}

let tableSeq = 0;
function table(headers, rows, onclick) {
  // scope the deferred click binding to THIS table: a view can render
  // several tables and a global selector would rebind them all to the
  // last table's rows/handler
  const tid = `tbl-${tableSeq++}`;
  const h = headers.map(x => `<th>${x}</th>`).join("");
  const b = rows.map((r, i) =>
    `<tr class="row" data-i="${i}">${
      r.cells.map(c => `<td>${c}</td>`).join("")}</tr>`).join("");
  setTimeout(() => {
    document.querySelectorAll(`#${tid} tr.row`).forEach(tr =>
      tr.onclick = () => onclick(rows[+tr.dataset.i]));
  }, 0);
  return `<table id="${tid}"><thead><tr>${h}</tr></thead>` +
    `<tbody>${b}</tbody></table>`;
}

const VIEWS = {
  async jobs() {
    const jobs = await api("/v1/jobs?namespace=*");
    return table(["ID", "Namespace", "Type", "Priority", "Status"],
      jobs.map(j => ({cells: [esc(j.id), esc(j.namespace), esc(j.type),
                              j.priority, pill(j.status)],
                      go: () => show("job", j.namespace, j.id)})),
      r => r.go());
  },
  async nodes() {
    const nodes = await api("/v1/nodes");
    return table(["ID", "Name", "DC", "Class", "Eligibility", "Status"],
      nodes.map(n => ({cells: [short(n.id), esc(n.name), esc(n.datacenter),
                               esc(n.node_class || "—"),
                               esc(n.scheduling_eligibility),
                               pill(n.status)],
                       go: () => show("node", n.id)})),
      r => r.go());
  },
  async allocations() {
    const allocs = await api("/v1/allocations?namespace=*");
    return table(["ID", "Job", "Group", "Node", "Desired", "Status"],
      allocs.map(a => ({cells: [short(a.id), esc(a.job_id),
                                esc(a.task_group), short(a.node_id),
                                esc(a.desired_status),
                                pill(a.client_status)],
                        go: () => show("allocation", a.id)})),
      r => r.go());
  },
  async evaluations() {
    const evals = await api("/v1/evaluations?namespace=*");
    return table(["ID", "Job", "Triggered By", "Priority", "Status"],
      evals.map(e => ({cells: [short(e.id), esc(e.job_id),
                               esc(e.triggered_by), e.priority,
                               pill(e.status)],
                       go: () => show("evaluation", e.id)})),
      r => r.go());
  },
  async deployments() {
    const deps = await api("/v1/deployments?namespace=*");
    return table(["ID", "Job", "Status", "Description"],
      deps.map(d => ({cells: [short(d.id), esc(d.job_id), pill(d.status),
                              esc(d.status_description || "")],
                      go: () => show("deployment", d.id)})),
      r => r.go());
  },
  async services() {
    const svcs = await api("/v1/services?namespace=*");
    return table(["Service", "Namespace", "Tags", "Healthy"],
      svcs.map(s => ({cells: [esc(s.service_name), esc(s.namespace),
                              esc((s.tags || []).join(", ") || "—"),
                              `${s.passing}/${s.count}`],
                      go: () => show("service", s.namespace,
                                     s.service_name)})),
      r => r.go());
  },
  async mesh() {
    const [intentions, svcs] = await Promise.all([
      api("/v1/connect/intentions").catch(() => null),
      api("/v1/services?namespace=*").catch(() => null),
    ]);
    const sidecars = (svcs || []).filter(s =>
      (s.tags || []).includes("connect-proxy"));
    let html = "<h3>Intentions</h3>";
    if (intentions === null) {
      // fetch failure must NOT read as "open mesh" — denies may exist
      html += `<p class="dim">intentions unavailable ` +
              `(insufficient token or server error)</p>`;
    } else html += intentions.length
      ? table(["Source", "Destination", "Action"],
              intentions.map(i => ({cells: [esc(i.Source),
                                            esc(i.Destination),
                                            pill(i.Action)]})), () => {})
      : `<p class="dim">no intentions (default: allow)</p>`;
    html += "<h3>Sidecar proxies</h3>";
    if (svcs === null) {
      html += `<p class="dim">services unavailable ` +
              `(insufficient token or server error)</p>`;
    } else html += sidecars.length
      ? table(["Service", "Namespace", "Healthy"],
              sidecars.map(s => ({cells: [esc(s.service_name),
                                          esc(s.namespace),
                                          `${s.passing}/${s.count}`]})),
              () => {})
      : `<p class="dim">no connect-enabled services</p>`;
    return html;
  },
  async servers() {
    const [leader, members, regions] = await Promise.all([
      api("/v1/status/leader").catch(() => null),
      api("/v1/agent/members").catch(() => ({members: []})),
      api("/v1/regions").catch(() => []),
    ]);
    let html = `<div class="kv"><span class="k">Leader</span>` +
      `<span>${esc(JSON.stringify(leader))}</span>` +
      `<span class="k">Regions</span><span>${
        regions.map(esc).join(", ")}</span></div>`;
    const rows = (members.members || []).map(m => ({cells: [
      esc(m.name), esc((m.addr || []).join(":")),
      esc((m.tags && m.tags.region) || "global"), pill(m.status)]}));
    html += rows.length
      ? table(["Name", "Address", "Region", "Status"], rows, () => {})
      : `<p class="dim">single-server agent (no gossip pool)</p>`;
    return html;
  },
};

async function detailView() {
  const [kind, ...args] = detail;
  const back = `<span class="back" onclick="closeDetail()">← back</span>`;
  if (kind === "job") {
    const [ns, id] = args;
    const [job, allocs, evals] = await Promise.all([
      api(`/v1/job/${id}?namespace=${ns}`),
      api(`/v1/job/${id}/allocations?namespace=${ns}`),
      api(`/v1/job/${id}/evaluations?namespace=${ns}`),
    ]);
    return `${back}<div class="detail"><h2>job ${esc(id)}</h2>
      <div class="kv">
        <span class="k">Type</span><span>${esc(job.type)}</span>
        <span class="k">Status</span><span>${pill(job.status)}</span>
        <span class="k">Priority</span><span>${job.priority}</span>
        <span class="k">Datacenters</span><span>${
          esc((job.datacenters || []).join(", "))}</span>
        <span class="k">Groups</span><span>${
          (job.task_groups || []).map(g =>
            `${esc(g.name)}×${g.count}`).join(", ")}</span>
      </div>
      <h2>allocations</h2>${table(["ID", "Group", "Node", "Status"],
        allocs.map(a => ({cells: [short(a.id), esc(a.task_group),
                                  short(a.node_id),
                                  pill(a.client_status)],
                          go: () => show("allocation", a.id)})),
        r => r.go())}
      <h2>evaluations</h2>${table(["ID", "Triggered", "Status"],
        evals.map(e => ({cells: [short(e.id), esc(e.triggered_by),
                                 pill(e.status)]})), () => {})}
      </div>`;
  }
  if (kind === "service") {
    const [ns, name] = args;
    const regs = await api(`/v1/service/${name}?namespace=${ns}`);
    return `${back}<div class="detail"><h2>service ${esc(name)}</h2>${
      table(["Address", "Port", "Status", "Alloc", "Node"],
        regs.map(r => ({cells: [esc(r.address), r.port, pill(r.status),
                                short(r.alloc_id), short(r.node_id)]})),
        () => {})}</div>`;
  }
  const paths = {node: `/v1/node/${args[0]}`,
                 allocation: `/v1/allocation/${args[0]}`,
                 evaluation: `/v1/evaluation/${args[0]}`,
                 deployment: `/v1/deployment/${args[0]}`};
  const obj = await api(paths[kind]);
  return `${back}<div class="detail"><h2>${kind} ${short(args[0])}</h2>
    <pre>${esc(JSON.stringify(obj, null, 2))}</pre></div>`;
}

function show(...d) { detail = d; render(); }
function closeDetail() { detail = null; render(); }

function drawNav() {
  $("nav").innerHTML = TABS.map(t =>
    `<a class="${t === tab ? "active" : ""}" data-t="${t}">${t}</a>`)
    .join("");
  document.querySelectorAll("nav a").forEach(a =>
    a.onclick = () => { tab = a.dataset.t; detail = null; render(); });
}

async function render() {
  drawNav();
  $("crumb").textContent = detail ? detail.join(" / ") : tab;
  try {
    $("main").innerHTML = detail ? await detailView()
                                 : await VIEWS[tab]();
    $("refresh").textContent =
      `updated ${new Date().toLocaleTimeString()}`;
  } catch (e) {
    $("main").innerHTML = `<div class="err">${esc(e.message)}</div>`;
  }
}

render();
timer = setInterval(() => { if (!detail) render(); }, 5000);
</script>
</body>
</html>
"""
