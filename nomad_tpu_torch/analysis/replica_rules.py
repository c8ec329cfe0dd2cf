"""NLR01–NLR04 — replica determinism on the raft apply path.

ROADMAP item 4 (HA control plane) is only sound if every replica's FSM
computes bit-identical state from the same raft log — the reference
treats `nomad/fsm.go` Apply as a pure function of the entry for exactly
this reason. These rules make that invariant a ratchet, the way
lock-order (NLT04) and device discipline (NLD) became ratchets in v2:

* **NLR01** — a wall-clock read (`time.time`/`monotonic`,
  `datetime.now`) reachable from the apply path. Two replicas applying
  the same entry at different instants store different values; the
  divergence is silent until a failover compares states. The full call
  path from the apply root is rendered, NLT04-style.
* **NLR02** — a nondeterministic source on the apply path: module-
  global `random.*`, a ZERO-ARG `random.Random()` (seeded from OS
  entropy), `uuid.uuid1/uuid4`, `os.urandom`, stdlib `secrets.*`.
  Calls on a caller-supplied rng PARAMETER are exempt automatically
  (the receiver is a variable, not the random module): determinism is
  the caller's obligation, discharged leader-side.
* **NLR03** — iteration over an unordered `set` whose ORDER escapes
  into stored or marshalled values under apply (appends, subscript
  stores, yields, bare `list(s)`). `sorted(...)` and order-insensitive
  folds (`sum`/`min`/`max`/`any`/`all`/`len`/`set`) are exempt. Dict
  iteration is NOT flagged: insertion order is itself deterministic
  once NLR01/NLR02 hold.
* **NLR04** — version-capture discipline for `tensor/cluster.py`
  delta-log readers (the PR 11 review bug, now a rule): capture
  `cluster.version`/`ports_version` BEFORE reading the logs, and
  advance `checked_*` cursors only to the captured values. Advancing
  from a live read (or a capture taken after the first read) silently
  skips any mutation that lands mid-scan.

Scope ("the apply path") is computed from the program, not hardcoded:
roots are `apply`/`apply_resilient`/`restore` on classes named
`FSM`/`Fsm`, the module-level snapshot/restore/validate functions next
to them, and — because `FSM.apply` dispatches `getattr(state, op)` over
the `ALLOWED_OPS` frozenset, which no call resolver can see — every
method whose name is in the AST-parsed `ALLOWED_OPS` literal, on any
class defining at least two of them (the state-store duck type). The
BFS closure over resolved calls from those roots, plus every function
under `structs/` (the replicated-value domain any mutator may construct
or serialize), is the scope. Under-approximating, like the callgraph:
every report names a real path.
"""
from __future__ import annotations

import ast
from collections import deque
from typing import Dict, List, Optional, Set, Tuple

from .callgraph import FuncInfo, ModuleInfo, Program
from .core import Finding

REPLICA_RULES = {
    "NLR01": "wall-clock read reachable from the raft apply path "
             "(replicas applying the same entry store different "
             "values)",
    "NLR02": "nondeterministic source (unseeded RNG / uuid / urandom) "
             "reachable from the raft apply path",
    "NLR03": "unordered set iteration whose order escapes into stored "
             "or marshalled state under apply",
    "NLR04": "delta-log cursor advanced past the captured version "
             "(capture cluster/ports versions BEFORE reading, advance "
             "checked_* only to captured values)",
}

_HINTS = {
    "NLR01": "mint the timestamp leader-side at submit/plan time and "
             "carry it in the raft entry (a `now: float` parameter) so "
             "apply is a pure function of the log",
    "NLR02": "mint ids/seeds leader-side and carry them in the entry, "
             "or thread a caller-seeded rng parameter down the apply "
             "path",
    "NLR03": "iterate `sorted(the_set)` (or fold order-insensitively) "
             "before the order reaches stored/marshalled values",
    "NLR04": "capture `v = cl.version` / `p = cl.ports_version` before "
             "the first *_since read and assign checked_* from those "
             "captures only (scheduler/stack.py certify discipline)",
}

# ---- NLR01/NLR02 source taxonomy -------------------------------------

_TIME_LEAVES = frozenset({"time", "monotonic", "time_ns",
                          "monotonic_ns", "perf_counter",
                          "perf_counter_ns"})
_DATETIME_LEAVES = frozenset({"now", "utcnow", "today"})
_RANDOM_FNS = frozenset({"random", "randrange", "randint", "choice",
                         "choices", "shuffle", "sample", "uniform",
                         "gauss", "getrandbits", "randbytes"})
_UUID_LEAVES = frozenset({"uuid1", "uuid4"})
_STDLIB_SECRETS = frozenset({"token_hex", "token_bytes",
                             "token_urlsafe", "randbits", "choice"})
#: datetime appears as "datetime.py" (import datetime) or
#: "datetime/datetime.py" (from datetime import datetime)
_DATETIME_MODS = ("datetime.py", "datetime/datetime.py")


def _entropy_source(mi: ModuleInfo, d: str,
                    call: ast.Call) -> Optional[Tuple[str, str]]:
    """(rule, description) when the dotted call `d` reads the clock or
    an entropy source; None otherwise. Resolution goes through the
    module's import aliases, so a local `structs/secrets.py` or a
    seeded rng parameter never matches."""
    if not d:
        return None
    parts = d.split(".")
    root, leaf = parts[0], parts[-1]
    if len(parts) == 1:
        if root == "print":
            return None
        sym = mi.sym_imports.get(root)
        if sym is None:
            return None
        src, name = sym
        if src == "time.py" and name in _TIME_LEAVES:
            return ("NLR01", f"time.{name}()")
        if src == "random.py":
            if name in _RANDOM_FNS:
                return ("NLR02", f"random.{name}() on the module-"
                                 f"global RNG")
            if name == "Random" and not call.args and not call.keywords:
                return ("NLR02", "random.Random() seeded from OS "
                                 "entropy")
        if src == "uuid.py" and name in _UUID_LEAVES:
            return ("NLR02", f"uuid.{name}()")
        if src == "os.py" and name == "urandom":
            return ("NLR02", "os.urandom()")
        if src == "secrets.py" and name in _STDLIB_SECRETS:
            return ("NLR02", f"secrets.{name}()")
        return None
    tgt = mi.mod_aliases.get(root)
    if tgt is None:
        return None
    if tgt == "time.py" and leaf in _TIME_LEAVES:
        return ("NLR01", f"{d}()")
    if tgt in _DATETIME_MODS and leaf in _DATETIME_LEAVES:
        return ("NLR01", f"{d}()")
    if tgt == "random.py":
        if leaf in _RANDOM_FNS:
            return ("NLR02", f"{d}() on the module-global RNG")
        if leaf == "Random" and not call.args and not call.keywords:
            return ("NLR02", f"{d}() seeded from OS entropy")
    if tgt == "uuid.py" and leaf in _UUID_LEAVES:
        return ("NLR02", f"{d}()")
    if tgt == "os.py" and leaf == "urandom":
        return ("NLR02", f"{d}()")
    if tgt == "secrets.py" and leaf in _STDLIB_SECRETS:
        return ("NLR02", f"{d}()")
    return None


# ---- apply-path scope ------------------------------------------------

_FSM_CLASS_NAMES = frozenset({"FSM", "Fsm"})
_FSM_METHODS = ("apply", "apply_resilient", "restore")
_FSM_MODULE_FNS = ("restore_state", "snapshot_state", "validate_op")


def _allowed_ops(prog: Program) -> Set[str]:
    """The union of every module-level `ALLOWED_OPS` string literal —
    the op names `FSM.apply`'s `getattr(state, op)` dispatch can reach,
    invisible to call resolution."""
    ops: Set[str] = set()
    for mi in prog.modules.values():
        for node in mi.tree.body:
            if not isinstance(node, ast.Assign):
                continue
            names = [t.id for t in node.targets
                     if isinstance(t, ast.Name)]
            if "ALLOWED_OPS" not in names:
                continue
            for c in ast.walk(node.value):
                if isinstance(c, ast.Constant) \
                        and isinstance(c.value, str):
                    ops.add(c.value)
    return ops


def _roots(prog: Program,
           ops: Set[str]) -> List[Tuple[FuncInfo, str]]:
    roots: List[Tuple[FuncInfo, str]] = []
    seen: Set[int] = set()

    def add(fi: Optional[FuncInfo], label: str) -> None:
        if fi is not None and id(fi) not in seen:
            seen.add(id(fi))
            roots.append((fi, label))

    for rel in sorted(prog.modules):
        mi = prog.modules[rel]
        has_fsm = any(n in _FSM_CLASS_NAMES for n in mi.classes)
        for cname in sorted(mi.classes):
            ci = mi.classes[cname]
            if ci.name in _FSM_CLASS_NAMES:
                for m in _FSM_METHODS:
                    add(ci.methods.get(m), "raft apply entry point")
            if ops:
                defined = sorted(ops & set(ci.methods))
                if len(defined) >= 2:
                    for m in defined:
                        add(ci.methods[m],
                            f"ALLOWED_OPS mutator on {ci.name}")
        if has_fsm:
            for m in _FSM_MODULE_FNS:
                add(mi.functions.get(m), "snapshot/restore path")
    return roots


def _scope(prog: Program, roots: List[Tuple[FuncInfo, str]]):
    """BFS closure over resolved calls from the roots, plus the
    `structs/` value domain. Returns ({id: (fi, root-label)},
    {id: (caller, call-line)})."""
    label: Dict[int, Tuple[FuncInfo, str]] = {}
    parent: Dict[int, Tuple[FuncInfo, int]] = {}
    q: deque = deque()
    for fi, lab in roots:
        if id(fi) not in label:
            label[id(fi)] = (fi, lab)
            q.append(fi)
    for fi in prog.funcs:
        if "/structs/" in fi.rel and id(fi) not in label:
            label[id(fi)] = (fi, "replicated-value domain (structs/)")
            q.append(fi)
    while q:
        fi = q.popleft()
        lab = label[id(fi)][1]
        for cs, callee in zip(fi.calls, fi.resolved):
            if callee is None or id(callee) in label:
                continue
            label[id(callee)] = (callee, lab)
            parent[id(callee)] = (fi, cs.line)
            q.append(callee)
    return label, parent


def _render_path(fi: FuncInfo, label, parent):
    """NLT04-style hop chain root→leaf + related locations for SARIF:
    [(rel, line, text), ...]."""
    hops: List[Tuple[FuncInfo, int, FuncInfo]] = []
    cur = fi
    seen = {id(fi)}
    while id(cur) in parent:
        caller, line = parent[id(cur)]
        if id(caller) in seen:
            break
        hops.append((caller, line, cur))
        seen.add(id(caller))
        cur = caller
    root, root_label = label[id(cur)]
    parts = [f"{root.qual} [{root_label}]"]
    related: List[Tuple[str, int, str]] = [
        (root.rel, root.node.lineno,
         f"apply-path root {root.qual} ({root_label})")]
    for caller, line, callee in reversed(hops):
        parts.append(f"-> {callee.qual} [{caller.rel}:{line}]")
        related.append((caller.rel, line,
                        f"{caller.qual} calls {callee.qual}"))
    return " ".join(parts), tuple(related)


def _own_walk(nodes):
    """BFS over statements, stopping at nested defs/lambdas/classes
    (they run later / in another scope, like _FnScan)."""
    todo = deque(nodes)
    while todo:
        n = todo.popleft()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda, ast.ClassDef)):
            continue
        yield n
        todo.extend(ast.iter_child_nodes(n))


# ---- NLR03 -----------------------------------------------------------

_ORDER_FOLDS = frozenset({"sorted", "sum", "min", "max", "any", "all",
                          "len", "set", "frozenset"})
_ORDER_ESCAPE_METHODS = frozenset({"append", "insert", "extend",
                                   "appendleft", "write"})


def _src_text(e: ast.AST) -> str:
    try:
        return ast.unparse(e)
    except Exception:  # pragma: no cover — unparse is total on 3.9+
        return "<set>"


def _nlr03(fi: FuncInfo, findings: List[Finding],
           path: str, related) -> None:
    node = fi.node
    if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return
    set_vars: Set[str] = set()

    def is_set_expr(e: ast.AST) -> bool:
        if isinstance(e, (ast.Set, ast.SetComp)):
            return True
        if isinstance(e, ast.Name):
            return e.id in set_vars
        if isinstance(e, ast.Call) and isinstance(e.func, ast.Name):
            return e.func.id in ("set", "frozenset")
        if isinstance(e, ast.BinOp) and isinstance(
                e.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
            return is_set_expr(e.left) or is_set_expr(e.right)
        return False

    body = list(_own_walk(node.body))
    for n in body:
        if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                and isinstance(n.targets[0], ast.Name) \
                and is_set_expr(n.value):
            set_vars.add(n.targets[0].id)
    # comprehensions consumed by an order-insensitive fold are exempt
    exempt: Set[int] = set()
    for n in body:
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) \
                and n.func.id in _ORDER_FOLDS:
            for a in n.args:
                exempt.add(id(a))

    def emit(line: int, what: str, src: ast.AST) -> None:
        findings.append(Finding(
            fi.rel, line, "NLR03",
            f"{what} over unordered set `{_src_text(src)}` under "
            f"apply — replicas disagree on the escaped order; "
            f"path: {path}",
            hint=_HINTS["NLR03"], context=fi.qual, related=related))

    for n in body:
        if isinstance(n, ast.For) and is_set_expr(n.iter):
            esc = _order_escape(n.body)
            if esc:
                emit(n.lineno, f"iteration ({esc})", n.iter)
        elif isinstance(n, ast.ListComp) and id(n) not in exempt \
                and n.generators \
                and is_set_expr(n.generators[0].iter):
            emit(n.lineno, "list comprehension",
                 n.generators[0].iter)
        elif isinstance(n, ast.Call) and isinstance(n.func, ast.Name) \
                and n.func.id in ("list", "tuple") \
                and len(n.args) == 1 and is_set_expr(n.args[0]):
            emit(n.lineno, f"{n.func.id}() materialization", n.args[0])


def _order_escape(body) -> Optional[str]:
    for n in _own_walk(body):
        if isinstance(n, (ast.Yield, ast.YieldFrom)):
            return "yield"
        if isinstance(n, ast.Call) \
                and isinstance(n.func, ast.Attribute) \
                and n.func.attr in _ORDER_ESCAPE_METHODS:
            return f".{n.func.attr}()"
        if isinstance(n, ast.Assign) \
                and any(isinstance(t, ast.Subscript)
                        for t in n.targets):
            return "subscript store"
        if isinstance(n, ast.AugAssign) \
                and isinstance(n.target, ast.Subscript):
            return "subscript store"
    return None


# ---- NLR04 -----------------------------------------------------------

_READER_LEAVES = frozenset({"hot_entries_since", "hot_rows_since",
                            "port_words_since", "plan_windows_since"})
_CURSOR_KEYS = frozenset({"checked_version", "checked_ports"})
_VERSION_ATTRS = frozenset({"version", "ports_version"})


def _nlr04(fi: FuncInfo, findings: List[Finding]) -> None:
    reads = [line for line, d, _c in fi.raw_calls
             if d and d.split(".")[-1] in _READER_LEAVES]
    if not reads:
        return
    first_read = min(reads)
    node = fi.node
    if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return
    captures: Dict[str, int] = {}
    for n in _own_walk(node.body):
        if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                and isinstance(n.targets[0], ast.Name) \
                and isinstance(n.value, ast.Attribute) \
                and n.value.attr in _VERSION_ATTRS:
            captures.setdefault(n.targets[0].id, n.lineno)
    for n in _own_walk(node.body):
        if isinstance(n, ast.Assign) and len(n.targets) == 1:
            tgt, value = n.targets[0], n.value
        elif isinstance(n, ast.AugAssign):
            tgt, value = n.target, n.value
        else:
            continue
        key = None
        if isinstance(tgt, ast.Subscript) \
                and isinstance(tgt.slice, ast.Constant) \
                and tgt.slice.value in _CURSOR_KEYS:
            key = tgt.slice.value
        elif isinstance(tgt, ast.Attribute) and tgt.attr in _CURSOR_KEYS:
            key = tgt.attr
        if key is None:
            continue
        live = [s for s in ast.walk(value)
                if isinstance(s, ast.Attribute)
                and s.attr in _VERSION_ATTRS]
        if live:
            findings.append(Finding(
                fi.rel, n.lineno, "NLR04",
                f"cursor {key!r} advanced from a LIVE "
                f".{live[0].attr} read — a mutation landing after the "
                f"delta-log read at line {first_read} is silently "
                f"skipped; capture the version before reading",
                hint=_HINTS["NLR04"], context=fi.qual))
            continue
        late = sorted(nm for s in ast.walk(value)
                      if isinstance(s, ast.Name)
                      for nm in [s.id]
                      if nm in captures and captures[nm] > first_read)
        if late:
            findings.append(Finding(
                fi.rel, n.lineno, "NLR04",
                f"cursor {key!r} advanced to {late[0]!r}, captured at "
                f"line {captures[late[0]]} AFTER the first delta-log "
                f"read at line {first_read} — entries between read and "
                f"capture are silently skipped",
                hint=_HINTS["NLR04"], context=fi.qual))


# ---- driver ----------------------------------------------------------

def analyze_replica(prog: Program) -> List[Finding]:
    findings: List[Finding] = []
    ops = _allowed_ops(prog)
    roots = _roots(prog, ops)
    label, parent = _scope(prog, roots)
    for _id in sorted(label, key=lambda i: (label[i][0].rel,
                                            label[i][0].qual)):
        fi, _lab = label[_id]
        mi = prog.modules.get(fi.rel)
        if mi is None:
            continue
        path, related = _render_path(fi, label, parent)
        for line, d, call in fi.raw_calls:
            src = _entropy_source(mi, d, call)
            if src is None:
                continue
            rule, desc = src
            noun = ("wall-clock read" if rule == "NLR01"
                    else "nondeterministic source")
            findings.append(Finding(
                fi.rel, line, rule,
                f"{noun} {desc} on the apply path — replicas applying "
                f"the same log entry diverge; path: {path}",
                hint=_HINTS[rule], context=fi.qual, related=related))
        _nlr03(fi, findings, path, related)
    for fi in prog.funcs:
        _nlr04(fi, findings)
    return findings
