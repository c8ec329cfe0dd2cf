"""Whole-program model for the interprocedural rule families.

The per-class call trees of `thread_rules` answer "which thread touches
this attribute"; the NLT04–NLT06 and NLD families need more: which LOCK
is held at which CALL, across classes and modules. This module builds
that model once per `run_tree` and hands it to the rule passes:

* **Lock identity via attr-path.** `self._lock = threading.Lock()`
  inside class `C` of module `m` is one lock object for the life of the
  instance — identity `m:C._lock`. `threading.Condition(self._lock)`
  ALIASES the underlying lock (acquiring the condition acquires the
  lock), so `broker._cv` and `broker._lock` are one node in the graph.
  Module-level `X = threading.Lock()` is `m:X`.

* **Call resolution.** `self.m()` resolves within the class;
  `self.attr.m()` through the attr-type map (`self.attr = Klass(...)`
  in any method, ctor resolved through the module's imports, then by
  unique bare name program-wide); `f()` through local nested defs, then
  module functions, then `from X import f` imports; `alias.f()` through
  `import`/`from .. import alias` module aliases. Unresolvable calls
  (dynamic callables, foreign libraries) contribute NOTHING — the model
  under-approximates, so every reported edge is a real code path.

* **Lock effect sets.** `effects(f)` = locks `f` may acquire, directly
  or through any resolved callee (fixpoint). `blocks(f)` = whether `f`
  may block (the NLT02 taxonomy: sleep / subprocess / socket / RPC /
  wait / join), again transitively.

* **The lock-acquisition graph.** Edge A→B with a witness
  (function, line, via-callee) whenever some function acquires (or
  calls into an acquisition of) B while holding A. NLT04 reports its
  cycles; a same-lock "edge" (B already held) is the NLT05 re-entrancy
  hazard, kept separately.

Pure `ast`; context-insensitive by design (a held-lock set is tracked
lexically per function). `*_locked`-suffixed methods follow the repo
convention (caller holds the owner's lock) — their bodies acquire
nothing extra, so the convention introduces no false edges.
"""
from __future__ import annotations

import ast
import os
from collections import deque
from typing import Dict, List, Optional, Set, Tuple

from .core import dotted as _dotted

_LOCK_CTORS = {"Lock", "RLock", "Semaphore", "BoundedSemaphore"}
_COND_CTORS = {"Condition"}

#: blocking-call taxonomy (NLT02's, shared so NLT06 reads the same way)
_BLOCKING_LEAVES = {"sleep", "accept", "recv", "recvfrom", "sendall",
                    "connect_ex", "select", "getaddrinfo"}
_BLOCKING_SUBPROCESS = {"run", "Popen", "call", "check_call",
                        "check_output", "communicate"}
_BLOCKING_ROOTS = {"conn", "sock", "socket", "rpc", "requests", "urllib"}
#: device-synchronizing leaves (NLT06 extends the blocking set with the
#: calls that stall on the accelerator)
_DEVICE_SYNC_LEAVES = {"block_until_ready", "device_get"}


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) \
            and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _cond_kind(call: ast.Call) -> str:
    """A Condition's re-entrancy is its wrapped lock's: the no-arg
    default wraps an RLock (re-entry is legal at runtime, so modeling
    it non-reentrant would fail the empty-baseline gate on correct
    code), an inline `Condition(threading.Lock())` adopts the explicit
    ctor, and an unresolvable wrapped expression stays the
    conservative non-reentrant "Condition"."""
    if not call.args:
        return "RLock"
    arg = call.args[0]
    if isinstance(arg, ast.Call):
        inner = _dotted(arg.func).split(".")[-1]
        if inner in _LOCK_CTORS:
            return inner
    return "Condition"


class Lock:
    __slots__ = ("id", "display", "kind", "rel")

    def __init__(self, id_: str, display: str, kind: str, rel: str):
        self.id = id_
        self.display = display
        self.kind = kind          # Lock | RLock | Condition | Semaphore…
        self.rel = rel

    def __repr__(self):  # pragma: no cover — debug aid
        return f"<Lock {self.id} ({self.kind})>"


class CallSite:
    __slots__ = ("line", "held", "target", "node")

    def __init__(self, line: int, held: Tuple[str, ...], target, node):
        self.line = line
        self.held = held          # lock ids held at the call
        self.target = target      # resolution key tuple (see _FnScan)
        self.node = node


class FuncInfo:
    __slots__ = ("qual", "rel", "cls", "node", "acquisitions", "calls",
                 "attr_calls", "blocking", "lease_events", "effects",
                 "may_block", "resolved", "nested", "raw_calls",
                 "returns")

    def __init__(self, qual: str, rel: str, cls: Optional["ClassInfo"],
                 node: ast.AST):
        self.qual = qual          # Class.method / func / Class.m.<nested>
        self.rel = rel
        self.cls = cls
        self.node = node
        #: (lock_id, line, held-before tuple)
        self.acquisitions: List[Tuple[str, int, Tuple[str, ...]]] = []
        self.calls: List[CallSite] = []
        #: direct invocation of a STORED callable attribute:
        #: (attr, line, held tuple)
        self.attr_calls: List[Tuple[str, int, Tuple[str, ...]]] = []
        #: (line, what, held tuple) — NLT02 taxonomy leaves
        self.blocking: List[Tuple[int, str, Tuple[str, ...]]] = []
        #: ordered (line, kind, what) events for the lease rule:
        #: kind ∈ {lease, release, blocking, devsync}
        self.lease_events: List[Tuple[int, str, str]] = []
        self.effects: Set[str] = set()
        self.may_block = False
        self.resolved: List[Optional["FuncInfo"]] = []
        #: defs nested directly in this body, by bare name — the ONLY
        #: scope a bare call may resolve them from
        self.nested: Dict[str, "FuncInfo"] = {}
        #: EVERY call in the body as (line, dotted-name, ast.Call) —
        #: including the unresolvable ones _classify drops. The NLR/NLS
        #: taint passes need stdlib leaves (time.time, random.Random,
        #: log.info) that never resolve to in-tree FuncInfos.
        self.raw_calls: List[Tuple[int, str, ast.Call]] = []
        #: every `return` statement in the body (secret-taint egress)
        self.returns: List[ast.Return] = []


class ClassInfo:
    __slots__ = ("rel", "name", "node", "lock_attrs", "lock_kinds",
                 "methods", "attr_types", "callable_attrs")

    def __init__(self, rel: str, name: str, node: ast.ClassDef):
        self.rel = rel
        self.name = name
        self.node = node
        self.lock_attrs: Dict[str, str] = {}    # attr -> lock id
        self.lock_kinds: Dict[str, str] = {}    # lock id -> ctor kind
        self.methods: Dict[str, FuncInfo] = {}
        self.attr_types: Dict[str, str] = {}    # attr -> ctor bare name
        self.callable_attrs: Set[str] = set()   # attrs holding callables


class ModuleInfo:
    __slots__ = ("rel", "tree", "locks", "functions", "classes",
                 "mod_aliases", "sym_imports")

    def __init__(self, rel: str, tree: ast.Module):
        self.rel = rel
        self.tree = tree
        self.locks: Dict[str, Lock] = {}         # module-level name -> Lock
        self.functions: Dict[str, FuncInfo] = {}
        self.classes: Dict[str, ClassInfo] = {}
        self.mod_aliases: Dict[str, str] = {}    # alias -> module rel
        self.sym_imports: Dict[str, Tuple[str, str]] = {}  # alias->(rel,sym)


def _module_rel_from(rel: str, level: int, module: Optional[str]) -> str:
    """Resolve a relative import to a repo-relative module dir/prefix."""
    parts = rel.split("/")[:-1]          # package dirs of this module
    if level:
        parts = parts[: len(parts) - (level - 1)] if level > 1 else parts
    else:
        parts = []
    if module:
        parts = parts + module.split(".")
    return "/".join(parts)


class Program:
    """Parsed whole-tree model + resolution and fixpoints."""

    def __init__(self) -> None:
        self.modules: Dict[str, ModuleInfo] = {}
        self.locks: Dict[str, Lock] = {}
        self.class_by_name: Dict[str, List[ClassInfo]] = {}
        self.funcs: List[FuncInfo] = []

    # ---- construction ----

    @classmethod
    def build(cls, parsed: Dict[str, ast.Module]) -> "Program":
        prog = cls()
        for rel, tree in sorted(parsed.items()):
            prog._scan_module(rel, tree)
        prog._resolve_calls()
        prog._fixpoints()
        return prog

    def _add_lock(self, lk: Lock) -> Lock:
        return self.locks.setdefault(lk.id, lk)

    def _scan_module(self, rel: str, tree: ast.Module) -> None:
        mi = ModuleInfo(rel, tree)
        self.modules[rel] = mi
        # imports
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    tgt = a.name.replace(".", "/")
                    mi.mod_aliases[a.asname or a.name.split(".")[0]] = \
                        tgt + ".py"
            elif isinstance(node, ast.ImportFrom):
                base = _module_rel_from(rel, node.level, node.module)
                for a in node.names:
                    alias = a.asname or a.name
                    as_mod = f"{base}/{a.name}.py"
                    mi.mod_aliases[alias] = as_mod
                    mi.sym_imports[alias] = (base + ".py", a.name)
        # module-level locks
        for node in tree.body:
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call):
                v = node.value
                ctor = _dotted(v.func).split(".")[-1]
                if ctor not in _LOCK_CTORS | _COND_CTORS:
                    continue
                for t in node.targets:
                    if not isinstance(t, ast.Name):
                        continue
                    if ctor in _COND_CTORS:
                        # Condition(X) over an earlier module lock
                        # aliases it; otherwise re-entrancy follows
                        # the wrapped lock (_cond_kind)
                        if v.args and isinstance(v.args[0], ast.Name) \
                                and v.args[0].id in mi.locks:
                            mi.locks[t.id] = mi.locks[v.args[0].id]
                            continue
                        kind = _cond_kind(v)
                    else:
                        kind = ctor
                    lk = Lock(f"{rel}:{t.id}", t.id, kind, rel)
                    mi.locks[t.id] = self._add_lock(lk)
        # classes (top-level and nested in functions are both visible
        # via ast.walk; methods of inner classes resolve the same way)
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                ci = self._scan_class(mi, node)
                mi.classes[node.name] = ci
                self.class_by_name.setdefault(node.name, []).append(ci)
        # module functions
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fi = FuncInfo(node.name, rel, None, node)
                mi.functions[node.name] = fi
                self.funcs.append(fi)
                _FnScan(self, mi, None, fi).scan()

    @staticmethod
    def _walk_own(node: ast.ClassDef):
        """ast.walk over ONE class's own scope — stops at nested
        ClassDef boundaries: a nested class's `self.<attr>` assigns
        (and its __init__ params) belong to IT, and _scan_module scans
        it separately; absorbing them here would mint a phantom
        Outer.<attr> lock identity for the inner class's lock."""
        # BFS in source order (ast.walk's order): Condition(self._lock)
        # aliasing needs the wrapped lock's assign scanned FIRST
        todo = deque(ast.iter_child_nodes(node))
        while todo:
            sub = todo.popleft()
            if isinstance(sub, ast.ClassDef):
                continue
            yield sub
            todo.extend(ast.iter_child_nodes(sub))

    def _scan_class(self, mi: ModuleInfo, node: ast.ClassDef) -> ClassInfo:
        ci = ClassInfo(mi.rel, node.name, node)
        init_params: Set[str] = set()
        # pass 1: lock attrs / attr types / stored callables
        for sub in self._walk_own(node):
            if isinstance(sub, ast.FunctionDef) and sub.name == "__init__":
                init_params = {a.arg for a in sub.args.args
                               + sub.args.kwonlyargs if a.arg != "self"}
        for sub in self._walk_own(node):
            if not isinstance(sub, ast.Assign):
                continue
            for t in sub.targets:
                attr = _self_attr(t)
                if attr is None:
                    continue
                v = sub.value
                if isinstance(v, ast.Call):
                    ctor = _dotted(v.func).split(".")[-1]
                    if ctor in _LOCK_CTORS:
                        lk = Lock(f"{mi.rel}:{node.name}.{attr}",
                                  f"{node.name}.{attr}", ctor, mi.rel)
                        ci.lock_attrs[attr] = self._add_lock(lk).id
                        ci.lock_kinds[lk.id] = ctor
                    elif ctor in _COND_CTORS:
                        # Condition(self._x) aliases the wrapped lock
                        inner = _self_attr(v.args[0]) if v.args else None
                        if inner is not None and inner in ci.lock_attrs:
                            ci.lock_attrs[attr] = ci.lock_attrs[inner]
                        else:
                            kind = _cond_kind(v)
                            lk = Lock(f"{mi.rel}:{node.name}.{attr}",
                                      f"{node.name}.{attr}",
                                      kind, mi.rel)
                            ci.lock_attrs[attr] = self._add_lock(lk).id
                            ci.lock_kinds[lk.id] = kind
                    elif ctor and ctor[0].isupper():
                        ci.attr_types[attr] = ctor
                elif isinstance(v, ast.Name) and v.id in init_params:
                    # `self.x = x` in/around __init__: a stored object
                    # or callback — callable if ever CALLED directly
                    ci.callable_attrs.add(attr)
                elif isinstance(v, ast.Lambda):
                    ci.callable_attrs.add(attr)
        # pass 2: methods (+ nested defs as separate FuncInfos)
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{node.name}.{item.name}"
                fi = FuncInfo(qual, mi.rel, ci, item)
                ci.methods[item.name] = fi
                self.funcs.append(fi)
                _FnScan(self, mi, ci, fi).scan()
        return ci

    # ---- resolution ----

    def _resolve_one(self, fi: FuncInfo, target) -> Optional[FuncInfo]:
        mi = self.modules.get(fi.rel)
        if mi is None or target is None:
            return None
        kind = target[0]
        if kind == "self" and fi.cls is not None:
            return fi.cls.methods.get(target[1])
        if kind == "attr" and fi.cls is not None:
            ctor = fi.cls.attr_types.get(target[1])
            if ctor is None:
                return None
            ci = self._class_for(mi, ctor)
            return ci.methods.get(target[2]) if ci else None
        if kind == "var":
            ci = self._class_for(mi, target[1])
            return ci.methods.get(target[2]) if ci else None
        if kind == "name":
            name = target[1]
            # a nested def of THIS function shadows module scope; a
            # same-named METHOD of the class does not (bare `f()`
            # never dispatches to self.f at runtime — resolving it
            # there fabricates call edges)
            nested = fi.nested.get(name)
            if nested is not None:
                return nested
            if name in mi.functions:
                return mi.functions[name]
            sym = mi.sym_imports.get(name)
            if sym is not None:
                m2 = self.modules.get(sym[0])
                if m2 is not None:
                    return m2.functions.get(sym[1])
            return None
        if kind == "mod":
            m2rel = mi.mod_aliases.get(target[1])
            m2 = self.modules.get(m2rel) if m2rel else None
            if m2 is not None:
                return m2.functions.get(target[2])
            return None
        if kind == "cls":
            # ClassName.method / ClassName(...) — constructor calls
            ci = self._class_for(mi, target[1])
            if ci is None:
                return None
            return ci.methods.get(target[2] if len(target) > 2
                                  else "__init__")
        return None

    def _class_for(self, mi: ModuleInfo, name: str) -> Optional[ClassInfo]:
        if name in mi.classes:
            return mi.classes[name]
        sym = mi.sym_imports.get(name)
        if sym is not None:
            m2 = self.modules.get(sym[0])
            if m2 is not None and sym[1] in m2.classes:
                return m2.classes[sym[1]]
        cands = self.class_by_name.get(name, [])
        return cands[0] if len(cands) == 1 else None

    def _resolve_calls(self) -> None:
        for fi in self.funcs:
            fi.resolved = [self._resolve_one(fi, cs.target)
                           for cs in fi.calls]

    # ---- fixpoints ----

    def _fixpoints(self) -> None:
        for fi in self.funcs:
            fi.effects = {a[0] for a in fi.acquisitions}
            fi.may_block = bool(fi.blocking)
        changed = True
        while changed:
            changed = False
            for fi in self.funcs:
                for callee in fi.resolved:
                    if callee is None:
                        continue
                    if not callee.effects <= fi.effects:
                        fi.effects |= callee.effects
                        changed = True
                    if callee.may_block and not fi.may_block:
                        fi.may_block = True
                        changed = True

    # ---- the lock-acquisition graph ----

    def lock_graph(self):
        """edges: {(a, b): witness} for a≠b; reentries: list of
        (lock_id, FuncInfo, line, via) where an already-held lock is
        (transitively) re-acquired. Witness = (FuncInfo, line, via_str).
        RLock re-entries are sanctioned and skipped."""
        edges: Dict[Tuple[str, str], Tuple[FuncInfo, int, str]] = {}
        reentries: List[Tuple[str, FuncInfo, int, str]] = []

        def kind(lock_id: str) -> str:
            lk = self.locks.get(lock_id)
            return lk.kind if lk else "Lock"

        for fi in self.funcs:
            for lock, line, held in fi.acquisitions:
                for h in held:
                    if h == lock:
                        if kind(lock) != "RLock":
                            reentries.append((lock, fi, line, "directly"))
                    elif (h, lock) not in edges:
                        edges[(h, lock)] = (fi, line, "directly")
            for cs, callee in zip(fi.calls, fi.resolved):
                if callee is None or not cs.held:
                    continue
                via = callee.qual
                for lock in callee.effects:
                    if lock in cs.held:
                        if kind(lock) != "RLock":
                            reentries.append((lock, fi, cs.line,
                                              f"via {via}()"))
                        continue
                    for h in cs.held:
                        if (h, lock) not in edges:
                            edges[(h, lock)] = (fi, cs.line,
                                                f"via {via}()")
        return edges, reentries


class _FnScan(ast.NodeVisitor):
    """One function/method body: held-lock tracking, call sites,
    blocking leaves, lease events. Nested defs are scanned as their own
    FuncInfos (a nested def's body does not run at definition time), so
    this scan STOPS at them."""

    def __init__(self, prog: Program, mi: ModuleInfo,
                 ci: Optional[ClassInfo], fi: FuncInfo):
        self.prog = prog
        self.mi = mi
        self.ci = ci
        self.fi = fi
        self.held: List[str] = []
        self.var_types: Dict[str, str] = {}
        self._depth = 0

    def scan(self) -> None:
        node = self.fi.node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for stmt in node.body:
                self.visit(stmt)

    # -- helpers --

    def _lock_of(self, expr: ast.AST) -> Optional[str]:
        attr = _self_attr(expr)
        if attr is not None and self.ci is not None:
            return self.ci.lock_attrs.get(attr)
        if isinstance(expr, ast.Name):
            lk = self.mi.locks.get(expr.id)
            if lk is not None:
                return lk.id
        return None

    # -- visitors --

    def visit_FunctionDef(self, node: ast.FunctionDef):
        # nested def: separate FuncInfo, reachable by bare name ONLY
        # from its enclosing function (registering it on the class or
        # module would let an unrelated same-named bare call resolve
        # to it and fabricate an edge); its body never inherits this
        # scan's held set (it runs later)
        fi = FuncInfo(f"{self.fi.qual}.{node.name}", self.fi.rel,
                      self.ci, node)
        self.fi.nested.setdefault(node.name, fi)
        self.prog.funcs.append(fi)
        _FnScan(self.prog, self.mi, self.ci, fi).scan()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node: ast.ClassDef):
        # a function-local class is scanned as a CLASS by _scan_module's
        # ast.walk pass; descending here would double-scan its method
        # bodies and register them as bare-name-resolvable nested defs
        # of this function (a fabricated-edge source: bare `f()` never
        # dispatches to a local class's method)
        return

    def visit_Lambda(self, node: ast.Lambda):
        # a lambda body runs LATER (timer threads, callbacks), never
        # under the locks held at its definition site — do not scan it
        # in this context (its calls are unresolvable anyway)
        return

    def visit_With(self, node: ast.With):
        got = 0
        for item in node.items:
            self.visit(item.context_expr)
            lock = self._lock_of(item.context_expr)
            if lock is not None:
                self.fi.acquisitions.append(
                    (lock, node.lineno, tuple(self.held)))
                # `with a, b:` enters a BEFORE b — every later item is
                # acquired while holding the earlier ones, exactly like
                # the nested-with form (an `a -> b` edge)
                self.held.append(lock)
                got += 1
        for stmt in node.body:
            self.visit(stmt)
        if got:
            del self.held[-got:]

    def visit_Assign(self, node: ast.Assign):
        if isinstance(node.value, ast.Call):
            ctor = _dotted(node.value.func).split(".")[-1]
            if ctor and ctor[0].isupper() and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                self.var_types[node.targets[0].id] = ctor
        self.generic_visit(node)

    def _classify(self, node: ast.Call):
        func = node.func
        if isinstance(func, ast.Name):
            if func.id in self.var_types or func.id in self.mi.classes \
                    or (func.id in self.mi.sym_imports
                        and func.id[0:1].isupper()):
                return ("cls", func.id)
            return ("name", func.id)
        if isinstance(func, ast.Attribute):
            recv = func.value
            sattr = _self_attr(func)
            if sattr is not None:
                # self.x(...) — method or stored callable; resolve as
                # method first, the rule pass checks callable_attrs
                return ("self", sattr)
            inner = _self_attr(recv)
            if inner is not None:
                return ("attr", inner, func.attr)
            if isinstance(recv, ast.Name):
                if recv.id in self.var_types:
                    return ("var", self.var_types[recv.id], func.attr)
                if recv.id in self.mi.mod_aliases:
                    return ("mod", recv.id, func.attr)
                if recv.id in self.mi.classes \
                        or recv.id in self.prog.class_by_name:
                    return ("cls", recv.id, func.attr)
        return None

    def _blocking_name(self, node: ast.Call) -> Optional[str]:
        d = _dotted(node.func)
        leaf = d.split(".")[-1] if d else ""
        root = d.split(".")[0] if d else ""
        if d == "time.sleep" or (root == "time" and leaf == "sleep"):
            return d
        if root == "subprocess" and leaf in _BLOCKING_SUBPROCESS:
            return d
        if leaf in _BLOCKING_LEAVES:
            return d or leaf
        if root in _BLOCKING_ROOTS or ".conn." in f".{d}.":
            return d
        if leaf in ("wait", "wait_for") \
                and isinstance(node.func, ast.Attribute):
            recv = self._lock_of(node.func.value)
            # waiting on a HELD condition releases it — not blocking
            # under that lock (NLT02's exemption)
            if recv is not None and recv in self.held:
                return None
            return d or leaf
        if leaf == "join" and isinstance(node.func, ast.Attribute):
            low = _dotted(node.func.value).lower()
            if any(w in low for w in ("thread", "proc", "worker")):
                return d or leaf
        return None

    def visit_Return(self, node: ast.Return):
        self.fi.returns.append(node)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        held = tuple(self.held)
        target = self._classify(node)
        d = _dotted(node.func)
        self.fi.raw_calls.append((node.lineno, d, node))
        leaf = d.split(".")[-1] if d else (
            node.func.attr if isinstance(node.func, ast.Attribute) else "")
        # direct lock-method acquisition: self._lock.acquire()
        if leaf == "acquire" and isinstance(node.func, ast.Attribute):
            lock = self._lock_of(node.func.value)
            if lock is not None:
                self.fi.acquisitions.append((lock, node.lineno, held))
        if target is not None:
            cs = CallSite(node.lineno, held, target, node)
            self.fi.calls.append(cs)
            # stored-callable invocation: self.x(...) where x is a
            # stored callback, not a def'd method
            if target[0] == "self" and self.ci is not None \
                    and target[1] in self.ci.callable_attrs \
                    and target[1] not in self.ci.methods:
                self.fi.attr_calls.append((target[1], node.lineno, held))
        blocking = self._blocking_name(node)
        if blocking is not None:
            self.fi.blocking.append((node.lineno, blocking, held))
            self.fi.lease_events.append((node.lineno, "blocking",
                                         blocking))
        if leaf in _DEVICE_SYNC_LEAVES or (leaf == "item"
                                           and not node.args):
            self.fi.lease_events.append((node.lineno, "devsync",
                                         d or leaf))
        # lease lifecycle (scheduler/stack.py view leases, lib/hbm.py)
        if leaf in ("lease_view",):
            self.fi.lease_events.append((node.lineno, "lease", leaf))
        for kw in node.keywords:
            if kw.arg == "lease_token" \
                    and not (isinstance(kw.value, ast.Constant)
                             and kw.value.value is None):
                self.fi.lease_events.append((node.lineno, "lease",
                                             d or leaf))
        if leaf in ("release_view", "release_lease"):
            self.fi.lease_events.append((node.lineno, "release", leaf))
        self.generic_visit(node)
