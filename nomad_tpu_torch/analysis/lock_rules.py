"""Interprocedural lock-discipline rules (NLT04–NLT06).

PRs 3–9 grew ~15 locks with no ordering discipline (broker lock, store
mutation lock, `_handle_lock`, `_detach_lock`, per-manager locks) plus
device-buffer leases on the hot path. The per-function NLT01–NLT03
rules cannot see a deadlock that needs TWO stack frames to exist; these
rules run over the whole-program model (`analysis/callgraph.Program`):

* **NLT04 — lock-order inversion.** Build the lock-acquisition graph
  (edge A→B when some code path acquires B while holding A, through the
  resolved call tree) and report every cycle, with the FULL cycle path
  and the witness call site of each edge. Two threads walking a cycle's
  edges in opposite order is the textbook ABBA deadlock; a cycle is a
  hazard even while single-threaded callers happen to serialize.

* **NLT05 — re-entrancy under lock.** (a) a call path that re-acquires
  a lock already held (non-reentrant `Lock`/`Condition`: self-deadlock;
  the PR 8 broker hazard was exactly this shape — the footprint
  estimator reads state whose mutators re-enter `enqueue`, so calling
  it under the broker lock wedges the broker); (b) invoking a STORED
  callable attribute (`self.footprint_fn(...)`, a callback injected at
  construction) while holding a lock — the callee is unresolvable by
  construction and may re-enter any locked entry point of the owning
  object. Fix: copy state under the lock, release, then call out (the
  `_group_picks` discipline), or document the contract with a waiver.

* **NLT06 — blocking under a view lease.** Extends NLT02's blocking
  taxonomy to the PR 6 lease machinery: between acquiring a view lease
  (`device_arrays(lease_token=...)` / `lease_view(...)`) and releasing
  it (`release_view`/`release_lease`), the fused dispatch path must not
  sleep, RPC, or synchronize on the device (`block_until_ready`,
  `device_get`, `.item()`). A lease pins the double-buffered view slot:
  blocking while holding it starves refreshes into copy-slot mode and
  stretches the HBM lease watermark (lib/hbm.py stuck-lease flights).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from .callgraph import FuncInfo, Program
from .core import Finding

LOCK_RULES = {
    "NLT04": "lock-order inversion (cycle in the lock-acquisition "
             "graph)",
    "NLT05": "re-entrancy under lock into a mutating entry point",
    "NLT06": "blocking or device-sync call while holding a view lease",
}

_HINTS = {
    "NLT04": "pick one global acquisition order for these locks and "
             "acquire in that order on every path",
    "NLT05": "copy state under the lock, release, then call out (the "
             "broker _group_picks discipline)",
    "NLT06": "launch, release the lease at kernel end, and do the "
             "blocking work outside the lease window",
}


def _lock_display(prog: Program, lock_id: str) -> str:
    lk = prog.locks.get(lock_id)
    return lk.display if lk else lock_id


# ---- NLT04: cycles ---------------------------------------------------------


def _sccs(nodes: Set[str],
          adj: Dict[str, Set[str]]) -> List[List[str]]:
    """Tarjan SCCs, iterative (analysis runs on arbitrary user trees)."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    out: List[List[str]] = []
    counter = [0]

    for root in sorted(nodes):
        if root in index:
            continue
        work = [(root, iter(sorted(adj.get(root, ()))))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(adj.get(w, ())))))
                    advanced = True
                    break
                if w in on_stack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                out.append(comp)
    return out


def _cycle_path(start: str, comp: Set[str],
                adj: Dict[str, Set[str]]) -> List[str]:
    """Shortest cycle through `start` inside one SCC (BFS)."""
    prev: Dict[str, Optional[str]] = {start: None}
    frontier = [start]
    while frontier:
        nxt = []
        for v in frontier:
            for w in sorted(adj.get(v, ())):
                if w not in comp:
                    continue
                if w == start:
                    path = [v]
                    while prev[path[-1]] is not None:
                        path.append(prev[path[-1]])
                    path.reverse()
                    return path + [start]
                if w not in prev:
                    prev[w] = v
                    nxt.append(w)
        frontier = nxt
    return [start]  # unreachable for a real SCC


def _check_cycles(prog: Program, edges, findings: List[Finding]) -> None:
    adj: Dict[str, Set[str]] = {}
    nodes: Set[str] = set()
    for (a, b) in edges:
        adj.setdefault(a, set()).add(b)
        nodes.add(a)
        nodes.add(b)
    for comp in _sccs(nodes, adj):
        if len(comp) < 2:
            continue
        comp_set = set(comp)
        start = min(comp)
        cycle = _cycle_path(start, comp_set, adj)
        # cycle is [start, ..., start]; render each edge with its
        # witness so the report reads as a walkable deadlock scenario
        hops = []
        first_witness: Optional[Tuple[FuncInfo, int, str]] = None
        for a, b in zip(cycle, cycle[1:]):
            fi, line, via = edges[(a, b)]
            if first_witness is None:
                first_witness = (fi, line, via)
            hops.append(
                f"{_lock_display(prog, a)} -> {_lock_display(prog, b)} "
                f"[{fi.qual} at {fi.rel}:{line} {via}]")
        fi, line, _via = first_witness
        names = [_lock_display(prog, l) for l in cycle]
        findings.append(Finding(
            fi.rel, line, "NLT04",
            LOCK_RULES["NLT04"] + ": " + " -> ".join(names)
            + "; " + "; ".join(hops),
            _HINTS["NLT04"],
            context="cycle:" + "->".join(sorted(set(names)))))


# ---- NLT05: re-entrancy ----------------------------------------------------


def _check_reentry(prog: Program, reentries,
                   findings: List[Finding]) -> None:
    seen = set()
    for lock, fi, line, via in reentries:
        key = (fi.rel, line, lock)
        if key in seen:
            continue
        seen.add(key)
        findings.append(Finding(
            fi.rel, line, "NLT05",
            LOCK_RULES["NLT05"]
            + f": {_lock_display(prog, lock)} is already held and is "
              f"re-acquired {via} (non-reentrant: this deadlocks)",
            _HINTS["NLT05"], context=fi.qual))
    for fi in prog.funcs:
        for attr, line, held in fi.attr_calls:
            if not held:
                continue
            # the hazard needs the callback to be able to re-enter a
            # locked entry point of the SAME object: only flag while
            # holding one of the owning class's own locks
            own = [h for h in held
                   if fi.cls is not None
                   and h in fi.cls.lock_attrs.values()]
            if not own:
                continue
            findings.append(Finding(
                fi.rel, line, "NLT05",
                LOCK_RULES["NLT05"]
                + f": stored callback self.{attr}() invoked while "
                  f"holding {_lock_display(prog, own[0])} — the callee "
                  f"may re-enter a locked entry point",
                _HINTS["NLT05"], context=fi.qual))


# ---- NLT06: blocking under a view lease ------------------------------------


def _net_releasers(prog: Program) -> set:
    """Functions that release a lease their CALLER owns: a 'release'
    event (own, or via a resolved callee — fixpoint) with no lease
    opened locally before it. A helper that merely balances its own
    lease/release pair is not a net releaser."""
    net: set = set()
    changed = True
    while changed:
        changed = False
        for fi in prog.funcs:
            if fi in net:
                continue
            events = [(line, kind) for line, kind, _ in fi.lease_events
                      if kind in ("lease", "release")]
            events += [(cs.line, "release")
                       for cs, callee in zip(fi.calls, fi.resolved)
                       if callee is not None and callee is not fi
                       and callee in net]
            opens = 0
            for _line, kind in sorted(events):
                if kind == "lease":
                    opens += 1
                elif opens:
                    opens -= 1
                else:
                    net.add(fi)
                    changed = True
                    break
    return net


def _check_leases(prog: Program, findings: List[Finding]) -> None:
    net = _net_releasers(prog)
    for fi in prog.funcs:
        events = list(fi.lease_events)
        # a call to a net-releasing helper closes the interval at the
        # call site — release_view refactored into a helper must not
        # leave an open-ended lease (false NLT06 on everything after)
        events += [(cs.line, "release", f"{callee.qual}()")
                   for cs, callee in zip(fi.calls, fi.resolved)
                   if callee is not None and callee is not fi
                   and callee in net]
        events.sort()
        if not any(k == "lease" for _, k, _ in events):
            continue
        # lease-active line intervals within this function
        intervals: List[Tuple[int, int]] = []
        open_at: Optional[int] = None
        for line, kind, _what in events:
            if kind == "lease" and open_at is None:
                open_at = line
            elif kind == "release" and open_at is not None:
                intervals.append((open_at, line))
                open_at = None
        if open_at is not None:
            intervals.append((open_at, 10 ** 9))

        def active(line: int) -> bool:
            return any(a < line <= b for a, b in intervals)

        for line, kind, what in events:
            if kind in ("blocking", "devsync") and active(line):
                findings.append(Finding(
                    fi.rel, line, "NLT06",
                    LOCK_RULES["NLT06"] + f": {what}()",
                    _HINTS["NLT06"], context=fi.qual))
        for cs, callee in zip(fi.calls, fi.resolved):
            if callee is None or callee is fi:
                continue
            if callee.may_block and active(cs.line):
                findings.append(Finding(
                    fi.rel, cs.line, "NLT06",
                    LOCK_RULES["NLT06"]
                    + f": {callee.qual}() may block",
                    _HINTS["NLT06"], context=fi.qual))


def analyze_locks(prog: Program) -> List[Finding]:
    findings: List[Finding] = []
    edges, reentries = prog.lock_graph()
    _check_cycles(prog, edges, findings)
    _check_reentry(prog, reentries, findings)
    _check_leases(prog, findings)
    return findings
