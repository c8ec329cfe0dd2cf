"""One run of one cell: set-up, the measured window, the check, the line.

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` prints, as the last line of its standard output, one JSON
object: `correct`, `attempted`, `failed`, `metrics`, `device`, with
`--trace 1` `breakdown`, and last `checks`, each number compared beside
its limit. The same numbers close standard error.

Everything a cell is made of is found by name: `BENCHMARK.json` names the
cell's configuration (`portbench/configs/<config>.json`) and traffic
(`portbench/workloads/<cell>.json`), and each per-layer metric is read
by `portbench/metrics/<metric>.py`.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import random
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: kernel and build caches of the program, at fixed paths in the checkout
CACHE = ROOT / "build" / "portbench-cache"
#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "nomad_tpu")
#: how long after the window closes the run waits for its pending evals
DRAIN_S = 60.0
#: chain dispatches of the window the ranking check judges, drawn from
#: the seed
RANK_SAMPLE = 8


class NoCard(RuntimeError):
    """The run needs cards this machine does not have."""


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def manifest() -> Dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_cell(name: str, bench: Optional[Dict] = None):
    """(cell entry, configuration, traffic) of the cell `name`."""
    bench = bench or manifest()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"portbench: no cell {name!r} in BENCHMARK.json; "
                         f"cells: {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    workload = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    if (workload["config"], workload["traffic"]) != (cell["config"],
                                                     cell["traffic"]):
        raise SystemExit(f"portbench: workloads/{name}.json is for "
                         f"{workload['config']}.{workload['traffic']}")
    return cell, config, workload


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def _cards(torch, chips: int) -> None:
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: this benchmark "
                     "measures the port on an NVIDIA card and has no CPU "
                     "fallback")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} cards, torch sees "
                     f"{torch.cuda.device_count()}")


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def _alloc_row(a):
    cr = a.comparable_resources()
    devs = []
    if a.allocated_resources is not None:
        for tr in a.allocated_resources.tasks.values():
            for d in tr.devices:
                devs.extend(d.device_ids)
    return (a.id, a.node_id, a.job_id, cr.cpu, cr.memory_mb, cr.disk_mb,
            tuple(devs))


class ChainTap:
    """Keeps, for each chain dispatch while `on`, the use the kernel read
    (copied to the host in the kernel's stream order, before it), the
    rows it chose and the evals it chained, for the ranking check. Wraps
    the port's `place_table_chain`, which the select coordinator looks up
    at each dispatch, and the carry notes that follow it in the same
    thread (`note_dispatch_carry`, `spec_chain_advance`), which name the
    dispatch's evals in chain order."""

    def __init__(self, placement, stack):
        self.mods = ((placement, "place_table_chain", self.chain),
                     (stack, "note_dispatch_carry", self.note),
                     (stack, "spec_chain_advance", self.advance))
        self.real = {name: getattr(mod, name) for mod, name, _f in self.mods}
        for mod, name, f in self.mods:
            setattr(mod, name, f)
        self.on = False
        #: [used, chosen rows, eval ids] a dispatch
        self.taps: List[list] = []
        self.open = threading.local()

    def chain(self, cluster, *args, **kw):
        used = None
        if self.on:
            u = cluster.used
            used = (u.to("cpu", non_blocking=True) if u.is_cuda
                    else u.clone())
        flat, carry = self.real["place_table_chain"](cluster, *args, **kw)
        self.open.tap = None
        if used is not None:
            self.open.tap = [used, flat[0], None]
            self.taps.append(self.open.tap)
        return flat, carry

    def _evals(self, evals) -> None:
        tap = getattr(self.open, "tap", None)
        self.open.tap = None
        if tap is not None:
            tap[2] = list(evals)

    def note(self, cluster, token, base_arrays, evals, *args, **kw):
        self._evals(evals)
        return self.real["note_dispatch_carry"](cluster, token, base_arrays,
                                                evals, *args, **kw)

    def advance(self, cluster, token, evals, *args, **kw):
        self._evals(evals)
        return self.real["spec_chain_advance"](cluster, token, evals, *args,
                                               **kw)

    def remove(self) -> None:
        for mod, name, _f in self.mods:
            setattr(mod, name, self.real[name])

    def sample(self, seed: int, k: int, job_of: Dict[str, int]) -> List:
        """k of the taps that name their evals, drawn from the seed, in
        dispatch order: (use, chosen rows) as numpy arrays and the job of
        each program (None for an eval the loop did not submit)."""
        named = [t for t in self.taps if t[2] is not None]
        pick = sorted(random.Random(seed).sample(range(len(named)),
                                                 min(k, len(named))))
        return [(named[i][0].numpy(), named[i][1].cpu().numpy(),
                 [job_of.get(e) for e in named[i][2]]) for i in pick]


def readback(server, spec, loop) -> Dict:
    """The program's state after the run, as plain data for the
    reference: every non-terminal alloc on the cell's nodes; every alloc,
    terminal or not, of each job the loop registered; each node's use as
    the program accounts it; every eval's status; and the node of each
    row of the cluster view."""
    cl = server.state.cluster
    allocs, used = [], {}
    for ns in spec.nodes:
        for a in server.state.allocs_by_node(ns.id):
            if not a.terminal_status():
                allocs.append(_alloc_row(a))
        row = cl.row_of.get(ns.id)
        if row is not None:
            u = cl.used[row]
            used[ns.id] = (u[0], u[1], u[2])
    jobs = {}
    for k in sorted({k for _kind, k in loop.actions}):
        jid = spec.job(k).id
        jobs[jid] = [_alloc_row(a) + (a.terminal_status(),)
                     for a in server.state.allocs_by_job("default", jid)]
    evals = {}
    for eid in list(loop.done) + list(loop.pending):
        ev = server.state.eval_by_id(eid)
        evals[eid] = ev.status if ev is not None else "missing"
    return {"allocs": allocs, "jobs": jobs, "used": used, "evals": evals,
            "rows": list(cl.node_of_row)}


def _span_record(server, eid: str) -> List:
    tr = server.tracer.get(eid)
    if tr is None:
        return []
    a = tr["anchor_unix"]
    return [(s["phase"], a + s["start_s"],
             a + s["start_s"] + s["duration_ms"] / 1e3) for s in tr["spans"]]


def _ledger_bytes(snap: Dict) -> float:
    return sum(v["bytes"] for k, v in snap.items()
               if k.startswith("stack.") or k == "select_batch.table_insert")


def read_metric(name: str, ctx) -> Optional[float]:
    mod = importlib.import_module(f"portbench.metrics.{name}")
    return mod.read(ctx)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             t_start: Optional[float] = None, device=None,
             config: Optional[Dict] = None, workload: Optional[Dict] = None,
             control: bool = False, need_card: bool = True) -> Dict:
    """Run cell `name` once and return its result line as a dict.
    `device`, `config`, `workload` and `need_card` are for the tests,
    which drive the whole run on the CPU at a small size."""
    t_start = time.time() if t_start is None else t_start
    bench = manifest()
    cell, conf0, work0 = load_cell(name, bench)
    config = config or conf0
    workload = workload or work0
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_ext"))
    import torch

    if need_card:
        _cards(torch, cell["chips"])
    from nomad_tpu_torch.kernels import placement
    from nomad_tpu_torch.scheduler import stack
    from nomad_tpu_torch.server import Server, ServerConfig

    from . import spec as spec_mod
    from . import synth
    from .loop import ClosedLoop
    from .reference import check as ref

    sc = ServerConfig()
    stated = config["server"]
    got = {"eval_batch": sc.eval_batch, "num_schedulers": sc.num_schedulers,
           "mesh": sc.mesh, "data_dir": sc.data_dir, "fsync": sc.fsync}
    if got != stated:
        raise SystemExit(f"portbench: ServerConfig() is {got}, the "
                         f"configuration states {stated}")
    spec = spec_mod.make(config, workload, seed)
    server = Server(sc, device=device)
    on_card = server.device.type == "cuda"
    if on_card:
        from nomad_tpu_torch.kernels import _build

        _build.build_all(("lanes", "rows", "placement", "chain"))
    server.start()
    loop = ClosedLoop(server, spec)
    tap = ChainTap(placement, stack)
    try:
        synth.ingest(server.state, spec)
        log(f"set-up: {len(spec.nodes)} nodes, {len(spec.filler_allocs)} "
            f"filler allocs ingested at {time.time() - t_start:.1f} s")
        warm = int(workload["warmup_evals"])
        loop.run_until(lambda: len(loop.done) >= warm)
        gc.collect()

        spans: Dict[str, List] = {}
        gc_pauses: List = []
        gc_open: List = []
        prof = None
        if trace:
            from .devtrace import DeviceTrace

            def on_gc(phase, info):
                if phase == "start":
                    gc_open.append(time.time())
                elif gc_open:
                    gc_pauses.append((info["generation"], gc_open.pop(),
                                      time.time()))

            loop.on_done = lambda eid, rec: spans.__setitem__(
                eid, _span_record(server, eid))
            prof = DeviceTrace(torch) if on_card else None
            if prof is not None:
                prof.start()
            gc.callbacks.append(on_gc)
        # the window opens once the loop has caught up with what the
        # server did during the collection (and the profiler's start),
        # the backlog is full again, and one more batch has completed
        settled = len(loop.done) + config["server"]["eval_batch"]
        loop.run_until(lambda: len(loop.done) >= settled)
        loop.poll()
        loop.top_up()
        m0 = server.metrics.counters()
        from nomad_tpu_torch.lib.transfer import default_ledger

        led0 = default_ledger().snapshot()
        seq0 = server.timeline.last_index()
        t0 = time.time()
        setup_s = t0 - t_start
        occ0 = loop.live_allocs()
        occ = [occ0]
        t1 = t0 + seconds
        tap.on = True

        def stop() -> bool:
            occ.append(loop.live_allocs())
            return time.time() >= t1

        loop.run_until(stop)
        tap.on = False
        occ1 = loop.live_allocs()
        m1 = server.metrics.counters()
        led1 = default_ledger().snapshot()
        _seq, dispatches = server.timeline.records_after(seq0)
        if trace:
            gc.callbacks.remove(on_gc)
        devt = prof.stop(t0, t1) if prof is not None else None
        log(f"window: {seconds:g} s; running allocs at its start {occ0}, "
            f"at its end {occ1} (least {min(occ)}, most {max(occ)}; "
            f"the configuration's {config['running_allocs']})")
        loop.drain(DRAIN_S)
        peak = (torch.cuda.max_memory_allocated() if on_card
                else 0)
        if on_card:
            torch.cuda.synchronize()
        rb = readback(server, spec, loop)
        job_of = {e: r["job"] for e, r in
                  list(loop.done.items()) + list(loop.pending.items())}
        rb["taps"] = tap.sample(seed, RANK_SAMPLE, job_of)
    finally:
        tap.remove()
        server.shutdown()
    window = [r for r in loop.done.values() if t0 <= r["modify"] <= t1]
    evals_per_s = len(window) / seconds

    t_ref = time.time()
    notes: Dict = {}
    checks = ref.check(spec, loop.actions, rb,
                       low_dtype=torch.bfloat16 if control else None,
                       notes=notes)
    checks["occupancy_drift"] = float(max(occ) - min(occ))
    limits = {k: ref.LIMITS.get(k, 0.0) for k in checks}
    log(f"the window's pending evals done {t_ref - t1:.1f} s after it "
        f"closed; the reference took {time.time() - t_ref:.1f} s and "
        f"judged {notes['rank_judged']} placements in {len(rb['taps'])} "
        f"of the window's {len(tap.taps)} chain dispatches")
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"portbench: the run loaded {bad}: the benchmark "
                         "measures the port alone")

    correct = all(checks[k] <= limits[k] for k in limits)
    failed = sum(1 for st in rb["evals"].values() if st != "complete")
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    out: Dict = {"correct": correct, "attempted": len(rb["evals"]),
                 "failed": failed}
    if not trace:
        out["metrics"] = {
            "evals_per_s": {"value": evals_per_s, "unit": "evals/s"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    else:
        from . import roofline

        ctx = SimpleNamespace(
            window=(t0, t1), window_s=float(seconds), evals=window,
            spans={e: spans[e] for e in spans
                   if t0 <= loop.done[e]["modify"] <= t1},
            all_spans=spans, dispatches=dispatches, counters0=m0,
            counters1=m1, ledger_bytes=_ledger_bytes(led1)
            - _ledger_bytes(led0), device=devt, gc=gc_pauses,
            config=config, workload=workload,
            n_rows=server.state.cluster.n_cap,
            peaks=roofline.peaks(dev["kind"]))
        metrics = {}
        for m in bench["per_layer"]:
            if name not in m.get("workloads", [name]):
                continue
            v = read_metric(m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out["metrics"] = metrics
        if devt is not None:
            log(f"device trace: {len(devt.events)} events; kernels "
                f"{sorted(devt.raw_names)[:8]}")
            dev["busy_s"] = devt.busy_s
            dev["window_s"] = devt.window_s
            out["breakdown"] = devt.breakdown(ctx)
        log(f"card: {_power_limit() if on_card else 'cpu'}")
    out["device"] = dev
    out["checks"] = {k: {"value": checks[k], "limit": limits[k]}
                     for k in checks}
    log(f"{len(window)} evals reached a terminal status in the window: "
        f"{evals_per_s:.3f} evals/s; set-up {setup_s:.3f} s")
    return out


def main(argv=None, t_start: Optional[float] = None) -> int:
    ap = argparse.ArgumentParser(prog="portbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="put the reference, computed in bfloat16, in the "
                    "program's place (its tallies and its choices): the "
                    "control, which has to come out not correct")
    args = ap.parse_args(argv)
    try:
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace), t_start=t_start,
                       control=bool(args.control))
    except NoCard as e:
        log(str(e))
        return 2
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
