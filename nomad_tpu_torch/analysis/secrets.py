"""NLS01 — secret-taint manifest and rule.

PR 10's review found `node_get` serving `structs.Node.secret_id` to any
fabric peer — exactly the credential `connect_issue` verifies. The fix
was a one-line redaction; the LESSON is that redaction-before-egress
must be machine-checked or it regresses the next time someone adds a
read endpoint. This module is that check.

The MANIFEST below registers what is secret and where secrets may
legally exit:

* `SECRET_FIELDS` — attribute/tree-key names that are secrets
  (`structs.Node.secret_id` first; extend the set as fields grow).
* `BEARER_PRODUCERS` — call leaves returning an object CARRYING a
  secret field (`node_by_id`). Any function whose return value is such
  an object is itself a producer (fixpoint over resolved calls).
* `BEARER_PARAMS` — parameter names that carry a bearer into a
  function (`node`).
* Egress surfaces — methods of classes named `Server` (every method IS
  an RPC reply: `_register_endpoints` exposes them on the fabric) and
  everything in `agent/http.py` (HTTP responders).

Two taint shapes, both NLS01:

* **value taint** (checked EVERYWHERE, not just surfaces): a secret
  attribute reaching a log call, `print`, or the flight recorder —
  `log.info(f"... {node.secret_id}")` persists the credential in
  plaintext telemetry and the operator debug bundle.
* **bearer egress** (surfaces only): a bearer object — or its
  `to_wire` tree — returned without passing a redaction idiom first:
  `dataclasses.replace(node, secret_id="")` (server.py node_get) or
  `tree.pop("secret_id", None)` (agent/http.py node_wire).

Interprocedural via the callgraph's resolution; under-approximating
like everything else here — unresolvable flows contribute nothing, so
every finding names a real egress path.
"""
from __future__ import annotations

import ast
from collections import deque
from typing import Dict, List, Optional, Set, Tuple

from .callgraph import FuncInfo, Program
from .core import Finding, dotted as _dotted

#: attribute / wire-tree key names that are secrets
SECRET_FIELDS = frozenset({"secret_id"})
#: call leaves producing a secret-bearing object
BEARER_PRODUCERS = frozenset({"node_by_id"})
#: parameter names that carry a bearer into a function
BEARER_PARAMS = frozenset({"node"})
#: classes whose every method is an RPC reply surface
SURFACE_CLASSES = frozenset({"Server"})
#: files whose every function is an HTTP responder surface
SURFACE_FILE_SUFFIXES = ("agent/http.py",)

_LOG_METHODS = frozenset({"debug", "info", "warning", "warn", "error",
                          "exception", "critical", "log"})

SECRET_RULES = {
    "NLS01": "secret field reaches an egress surface (RPC reply / HTTP "
             "responder / log / flight recorder) without redaction",
}

_HINTS = {
    "NLS01": "redact before egress: dataclasses.replace(obj, "
             "secret_id=\"\") for objects, tree.pop(\"secret_id\", "
             "None) for wire trees; never log or flight-record secret "
             "fields",
}


def _leaf(d: str) -> str:
    return d.split(".")[-1] if d else ""


def _sink_kind(d: str, call: ast.Call) -> Optional[str]:
    if d == "print":
        return "print()"
    leaf = _leaf(d)
    if leaf in _LOG_METHODS and "." in d \
            and "log" in d.rsplit(".", 1)[0].lower():
        return f"log sink {d}()"
    if leaf == "record" and "flight" in d.lower():
        return f"flight recorder {d}()"
    if leaf in ("publish", "publish_entry") and "." in d:
        # ISSUE 18: the cluster event broker is an egress surface —
        # every subscriber (HTTP stream, CLI, debug bundle) receives
        # the payload verbatim, so a secret published once is served
        # forever from the replay buffer
        recv = d.rsplit(".", 1)[0].lower()
        if "event" in recv or "broker" in recv:
            return f"event publish {d}()"
    if not d and isinstance(call.func, ast.Attribute) \
            and call.func.attr == "record" \
            and isinstance(call.func.value, ast.Call):
        inner = _dotted(call.func.value.func)
        if "flight" in inner.lower():
            return f"flight recorder {inner}().record()"
    return None


def _secret_attrs(call: ast.Call) -> List[str]:
    """Secret attribute reads anywhere in the call's arguments
    (f-strings included — JoinedStr holds FormattedValue children)."""
    out: List[str] = []
    for arg in list(call.args) + [kw.value for kw in call.keywords]:
        for sub in ast.walk(arg):
            if isinstance(sub, ast.Attribute) \
                    and sub.attr in SECRET_FIELDS:
                out.append(sub.attr)
    return sorted(set(out))


def _is_redaction(call: ast.Call) -> bool:
    """dataclasses.replace(obj, secret_id="") — replacing a secret
    field makes the RESULT clean."""
    return _leaf(_dotted(call.func)) == "replace" \
        and any(kw.arg in SECRET_FIELDS for kw in call.keywords)


def _contains_producer(expr: ast.AST, resolved, rb: Set[int]) -> bool:
    for sub in ast.walk(expr):
        if not isinstance(sub, ast.Call):
            continue
        if _is_redaction(sub):
            continue
        if _leaf(_dotted(sub.func)) in BEARER_PRODUCERS:
            return True
        callee = resolved.get(id(sub))
        if callee is not None and id(callee) in rb:
            return True
    return False


def _flow_names(expr: ast.AST) -> Set[str]:
    """Names through which a WHOLE object flows into an expression.
    `node.status` reads one non-secret field, not the bearer — skip
    it; `node` bare, `node.secret_id`, or `{"n": tree}` all count."""
    out: Set[str] = set()
    todo = [expr]
    while todo:
        n = todo.pop()
        if isinstance(n, ast.Attribute) \
                and n.attr not in SECRET_FIELDS \
                and isinstance(n.value, ast.Name):
            continue
        if isinstance(n, ast.Name):
            out.add(n.id)
        todo.extend(ast.iter_child_nodes(n))
    return out


def _own_stmts(node):
    """Statements of one body in source order, stopping at nested
    defs/lambdas/classes (they run in another scope)."""
    todo = deque(node.body)
    out = []
    while todo:
        n = todo.popleft()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda, ast.ClassDef)):
            continue
        out.append(n)
        todo.extend(ast.iter_child_nodes(n))
    out.sort(key=lambda n: getattr(n, "lineno", 0))
    return out


def _resolution(fi: FuncInfo) -> Dict[int, FuncInfo]:
    return {id(cs.node): callee
            for cs, callee in zip(fi.calls, fi.resolved)
            if callee is not None}


def _returns_bearer(prog: Program) -> Set[int]:
    """ids of FuncInfos whose return value carries a bearer (fixpoint
    over resolved calls). A `replace(..., secret_id=...)` return is
    clean by construction."""
    rb: Set[int] = set()
    changed = True
    while changed:
        changed = False
        for fi in prog.funcs:
            if id(fi) in rb or not fi.returns:
                continue
            node = fi.node
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            resolved = _resolution(fi)
            bound: Set[str] = set()
            for st in _own_stmts(node):
                if isinstance(st, ast.Assign) and len(st.targets) == 1 \
                        and isinstance(st.targets[0], ast.Name):
                    tgt = st.targets[0].id
                    v = st.value
                    if isinstance(v, ast.Call) and _is_redaction(v):
                        bound.discard(tgt)
                    elif _contains_producer(v, resolved, rb):
                        bound.add(tgt)
                    elif isinstance(v, ast.Name) and v.id in bound:
                        bound.add(tgt)
                    else:
                        bound.discard(tgt)
            for ret in fi.returns:
                v = ret.value
                if v is None or (isinstance(v, ast.Call)
                                 and _is_redaction(v)):
                    continue
                if _contains_producer(v, resolved, rb) or any(
                        isinstance(s, ast.Name) and s.id in bound
                        for s in ast.walk(v)):
                    rb.add(id(fi))
                    changed = True
                    break
    return rb


def _is_surface(fi: FuncInfo) -> bool:
    if fi.cls is not None and fi.cls.name in SURFACE_CLASSES:
        return True
    return fi.rel.endswith(SURFACE_FILE_SUFFIXES)


def _scan_surface(fi: FuncInfo, rb: Set[int],
                  findings: List[Finding],
                  surface: bool = True) -> None:
    """Tracked-name flow scan. Return-egress fires only on RPC/HTTP
    `surface` functions; the event-publish sink check runs EVERYWHERE
    a bearer/tree name is trackable — the broker lives outside the
    surface files, and a secret published there streams to every
    subscriber."""
    node = fi.node
    if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return
    resolved = _resolution(fi)
    #: name -> "bearer" | "tree"; params seed the map
    tracked: Dict[str, str] = {
        a.arg: "bearer"
        for a in node.args.args + node.args.kwonlyargs
        if a.arg in BEARER_PARAMS}
    for st in _own_stmts(node):
        if isinstance(st, ast.Assign) and len(st.targets) == 1:
            tgt = st.targets[0]
            v = st.value
            if isinstance(tgt, ast.Name):
                name = tgt.id
                tracked.pop(name, None)
                if isinstance(v, ast.Call) and _is_redaction(v):
                    pass
                elif isinstance(v, ast.Call) \
                        and _leaf(_dotted(v.func)) == "to_wire" \
                        and v.args \
                        and isinstance(v.args[0], ast.Name) \
                        and v.args[0].id in tracked:
                    tracked[name] = "tree"
                elif _contains_producer(v, resolved, rb):
                    tracked[name] = "bearer"
                elif isinstance(v, ast.Name) and v.id in tracked:
                    tracked[name] = tracked[v.id]
            elif isinstance(tgt, ast.Subscript) \
                    and isinstance(tgt.value, ast.Name) \
                    and isinstance(tgt.slice, ast.Constant) \
                    and tgt.slice.value in SECRET_FIELDS:
                # tree["secret_id"] = <overwrite> — a redaction
                tracked.pop(tgt.value.id, None)
        elif isinstance(st, ast.Call) \
                and isinstance(st.func, ast.Attribute) \
                and st.func.attr == "pop" \
                and isinstance(st.func.value, ast.Name) \
                and st.args \
                and isinstance(st.args[0], ast.Constant) \
                and st.args[0].value in SECRET_FIELDS:
            tracked.pop(st.func.value.id, None)
        elif isinstance(st, ast.Call):
            sink = _sink_kind(_dotted(st.func), st)
            if sink is not None and sink.startswith("event publish"):
                leaked = sorted({
                    name
                    for a in list(st.args)
                    + [kw.value for kw in st.keywords]
                    for name in _flow_names(a)
                    if name in tracked})
                if leaked:
                    kind = tracked[leaked[0]]
                    findings.append(Finding(
                        fi.rel, st.lineno, "NLS01",
                        f"secret-bearing {kind} {leaked[0]!r} flows "
                        f"into {sink} un-redacted — the broker "
                        f"replays it to every subscriber",
                        hint=_HINTS["NLS01"], context=fi.qual))
        elif isinstance(st, ast.Delete):
            for t in st.targets:
                if isinstance(t, ast.Subscript) \
                        and isinstance(t.value, ast.Name) \
                        and isinstance(t.slice, ast.Constant) \
                        and t.slice.value in SECRET_FIELDS:
                    tracked.pop(t.value.id, None)
        elif isinstance(st, ast.Return):
            if not surface:
                continue
            v = st.value
            if v is None or (isinstance(v, ast.Call)
                             and _is_redaction(v)):
                continue
            if _contains_producer(v, resolved, rb):
                findings.append(Finding(
                    fi.rel, st.lineno, "NLS01",
                    f"RPC/HTTP reply returns a "
                    f"{'/'.join(sorted(BEARER_PRODUCERS))} bearer "
                    f"directly — {'/'.join(sorted(SECRET_FIELDS))} "
                    f"serves to any fabric peer",
                    hint=_HINTS["NLS01"], context=fi.qual))
                continue
            leaked = sorted({s.id for s in ast.walk(v)
                             if isinstance(s, ast.Name)
                             and s.id in tracked})
            if leaked:
                kind = tracked[leaked[0]]
                findings.append(Finding(
                    fi.rel, st.lineno, "NLS01",
                    f"RPC/HTTP reply returns secret-bearing "
                    f"{kind} {leaked[0]!r} un-redacted "
                    f"({'/'.join(sorted(SECRET_FIELDS))})",
                    hint=_HINTS["NLS01"], context=fi.qual))


def analyze_secrets(prog: Program) -> List[Finding]:
    findings: List[Finding] = []
    rb = _returns_bearer(prog)
    for fi in prog.funcs:
        # value taint: secret attrs into log/print/flight — anywhere
        for line, d, call in fi.raw_calls:
            sink = _sink_kind(d, call)
            if sink is None:
                continue
            fields = _secret_attrs(call)
            if fields:
                findings.append(Finding(
                    fi.rel, line, "NLS01",
                    f"secret field .{fields[0]} flows into {sink} — "
                    f"plaintext credential in telemetry/debug output",
                    hint=_HINTS["NLS01"], context=fi.qual))
        _scan_surface(fi, rb, findings, surface=_is_surface(fi))
    return findings
