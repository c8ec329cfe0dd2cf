"""Thread-safety rules (NLT01–NLT03) for the server/client/agent
runtime.

The model mirrors how the Go reference leans on the race detector:

* Per class, every method passed as `threading.Thread(target=self.X)`
  is a *thread root*; its same-class call tree is that thread's
  context. Methods not reachable from any root form the *main*
  context (external API).
* NLT01 fires when an attribute is written without a lock in one
  context and touched without a lock in a different one — the exact
  shape of the task_runner template-watcher race (ADVICE.md r5) and
  the sticky-disk deflakes.
* NLT02 fires on blocking calls (sleep, subprocess, socket ops, RPC
  via `conn`, waiting on an Event) made while holding a
  `threading.Lock`/`RLock`/`Condition` attribute — `cv.wait()` on the
  *held* condition is exempt (it releases).
* NLT03 fires on `except:`/`except Exception:` handlers inside a
  thread context's loop whose body neither logs nor re-raises — a
  wedged run loop with no trace is how soak flakes are born.

`threading.Event` attributes are exempt from NLT01 (set/is_set are the
sanctioned cross-thread signal), as are writes in `__init__` (before
the thread exists).

Scope: applied to modules under the THREAD_SCOPE prefixes only — the
server/client/agent runtime, where threads actually live.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .core import Finding, dotted as _dotted

THREAD_RULES = {
    "NLT01": "attribute shared across threads without a common lock",
    "NLT02": "lock held across a blocking call",
    "NLT03": "exception silently swallowed inside a thread loop",
}

_HINTS = {
    "NLT01": "guard both sides with one lock, or confine the attribute "
             "to a single thread",
    "NLT02": "copy state under the lock, release, then block",
    "NLT03": "log the exception (or narrow the except type) so a "
             "wedged loop leaves a trace",
}

#: repo-relative prefixes the concurrency rules run on
THREAD_SCOPE = (
    "nomad_tpu_torch/server/",
    "nomad_tpu_torch/client/",
    "nomad_tpu_torch/agent/",
    "nomad_tpu_torch/connect_proxy.py",
)

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore"}
_EVENT_CTORS = {"Event"}
_BLOCKING_LEAVES = {"sleep", "accept", "recv", "recvfrom", "sendall",
                    "connect_ex", "select", "getaddrinfo"}
_BLOCKING_SUBPROCESS = {"run", "Popen", "call", "check_call",
                        "check_output", "communicate"}
_BLOCKING_ROOTS = {"conn", "sock", "socket", "rpc", "requests",
                   "urllib"}


def _self_attr(node: ast.AST) -> Optional[str]:
    """'x' for `self.x`, else None."""
    if isinstance(node, ast.Attribute) \
            and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _base_self_attr(node: ast.AST) -> Optional[str]:
    """'x' for self.x, self.x[...], self.x.y — the owning attribute."""
    while isinstance(node, (ast.Subscript,)):
        node = node.value
    return _self_attr(node)


class _Access:
    __slots__ = ("attr", "write", "line", "locked", "method")

    def __init__(self, attr, write, line, locked, method):
        self.attr = attr
        self.write = write
        self.line = line
        self.locked = locked
        self.method = method


class _MethodScan(ast.NodeVisitor):
    """Collect self-attribute accesses (+lock depth) and local calls
    for one method; also NLT02/NLT03 sites."""

    def __init__(self, cls: "_ClassScan", name: str):
        self.cls = cls
        self.name = name
        # repo convention (mirrors the Go reference): a `*_locked`
        # method is documented as called with the owner's lock held
        self.lock_depth = 1 if name.endswith("_locked") else 0
        self.held: List[str] = []   # dotted exprs of held locks
        self.loop_depth = 0
        self.accesses: List[_Access] = []
        self.calls: Set[str] = set()
        self.thread_targets: Set[str] = set()
        self.blocking: List[Tuple[int, str]] = []
        self.swallows: List[int] = []
        self._fn_depth = 0

    # -- helpers --

    def _record(self, attr: Optional[str], write: bool, line: int):
        if attr is None:
            return
        self.accesses.append(_Access(attr, write, line,
                                     self.lock_depth > 0, self.name))

    def _is_lock_expr(self, node: ast.AST) -> bool:
        attr = _self_attr(node)
        if attr is not None and attr in self.cls.lock_attrs:
            return True
        # `with lock:` on a local alias is treated as a lock too
        return isinstance(node, ast.Name) and "lock" in node.id.lower()

    # -- visitors --

    def visit_With(self, node: ast.With):
        locked = [i.context_expr for i in node.items
                  if self._is_lock_expr(i.context_expr)]
        if locked:
            self.lock_depth += 1
            self.held.extend(_dotted(e) for e in locked)
        for item in node.items:
            self.visit(item.context_expr)
        for stmt in node.body:
            self.visit(stmt)
        if locked:
            self.lock_depth -= 1
            del self.held[-len(locked):]

    def _record_target(self, t: ast.AST, line: int) -> None:
        # recurse through tuple/list/starred targets: `self.a, self.b
        # = x, y` publishes paired state and must count as writes
        if isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                self._record_target(e, line)
        elif isinstance(t, ast.Starred):
            self._record_target(t.value, line)
        else:
            self._record(_base_self_attr(t), True, line)

    def visit_Assign(self, node: ast.Assign):
        for t in node.targets:
            self._record_target(t, node.lineno)
        # threading.Thread(target=self.X) / target=fn
        if isinstance(node.value, ast.Call):
            self._scan_thread_ctor(node.value)
        self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign):
        self._record(_base_self_attr(node.target), True, node.lineno)
        self.visit(node.value)

    def visit_Attribute(self, node: ast.Attribute):
        attr = _self_attr(node)
        if attr is not None and isinstance(node.ctx, ast.Load):
            self._record(attr, False, node.lineno)
        self.generic_visit(node)

    def _scan_thread_ctor(self, call: ast.Call):
        if not _dotted(call.func).endswith("Thread"):
            return
        for kw in call.keywords:
            if kw.arg != "target":
                continue
            t = _self_attr(kw.value)
            if t is not None:
                self.thread_targets.add(t)
            elif isinstance(kw.value, ast.Name):
                self.cls.module.fn_thread_targets.add(kw.value.id)

    def visit_Call(self, node: ast.Call):
        self._scan_thread_ctor(node)
        d = _dotted(node.func)
        leaf = d.split(".")[-1]
        root = d.split(".")[0]
        # local method calls (self.m()) for the call graph
        if isinstance(node.func, ast.Attribute):
            m = _self_attr(node.func)
            if m is not None:
                self.calls.add(m)
            # mutator calls on self.<attr> count as writes
            if leaf in ("append", "extend", "update", "setdefault",
                        "pop", "add", "remove", "clear", "insert"):
                self._record(_base_self_attr(node.func.value), True,
                             node.lineno)
        if self.lock_depth:
            blocking = None
            if d == "time.sleep" or (root == "time" and leaf == "sleep"):
                blocking = d
            elif root == "subprocess" and leaf in _BLOCKING_SUBPROCESS:
                blocking = d
            elif leaf in _BLOCKING_LEAVES:
                blocking = d or leaf
            elif root in _BLOCKING_ROOTS or ".conn." in f".{d}.":
                blocking = d
            elif leaf in ("wait", "wait_for", "join") and \
                    isinstance(node.func, ast.Attribute):
                # (.get() deliberately absent: dict.get is syntactically
                # indistinguishable from queue.Queue.get)
                recv = _dotted(node.func.value)
                if leaf in ("wait", "wait_for"):
                    # cv.wait() on the HELD condition releases it — exempt
                    blocking = None if recv in self.held else (d or leaf)
                else:  # .join: only when the receiver smells like a
                    # thread/process (str.join is everywhere)
                    low = recv.lower()
                    if any(w in low for w in ("thread", "proc", "worker")):
                        blocking = d or leaf
            if blocking:
                self.blocking.append((node.lineno, blocking))
        self.generic_visit(node)

    def visit_While(self, node: ast.While):
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    def visit_For(self, node: ast.For):
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    def visit_Try(self, node: ast.Try):
        for h in node.handlers:
            if self.loop_depth and self._swallows(h):
                self.swallows.append(h.lineno)
        self.generic_visit(node)

    @staticmethod
    def _swallows(h: ast.ExceptHandler) -> bool:
        def broad(t) -> bool:
            if t is None:
                return True
            if isinstance(t, ast.Name):
                return t.id in ("Exception", "BaseException")
            if isinstance(t, ast.Tuple):
                return any(broad(e) for e in t.elts)
            return False

        if not broad(h.type):
            return False
        for stmt in h.body:
            if isinstance(stmt, (ast.Pass, ast.Continue, ast.Break)):
                continue
            if isinstance(stmt, ast.Expr) \
                    and isinstance(stmt.value, ast.Constant):
                continue  # docstring/ellipsis
            return False  # any real statement (log call, raise, …)
        return True

    def visit_FunctionDef(self, node: ast.FunctionDef):
        # nested closures: scanned as part of this method (thread
        # targets inside are picked up by _scan_thread_ctor)
        self._fn_depth += 1
        self.generic_visit(node)
        self._fn_depth -= 1


class _ModuleScan:
    def __init__(self):
        self.fn_thread_targets: Set[str] = set()


class _ClassScan:
    def __init__(self, node: Optional[ast.ClassDef], module: _ModuleScan):
        self.node = node
        self.module = module
        self.lock_attrs: Set[str] = set()
        self.event_attrs: Set[str] = set()
        self.methods: Dict[str, _MethodScan] = {}
        self.thread_roots: Set[str] = set()

    def scan(self):
        # pass 1: lock/event attributes from any `self.x = threading.X()`
        for sub in ast.walk(self.node):
            if isinstance(sub, ast.Assign) \
                    and isinstance(sub.value, ast.Call):
                ctor = _dotted(sub.value.func).split(".")[-1]
                for t in sub.targets:
                    attr = _self_attr(t)
                    if attr is None:
                        continue
                    if ctor in _LOCK_CTORS:
                        self.lock_attrs.add(attr)
                    elif ctor in _EVENT_CTORS:
                        self.event_attrs.add(attr)
        # pass 2: per-method scans
        for item in self.node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                ms = _MethodScan(self, item.name)
                for stmt in item.body:
                    ms.visit(stmt)
                self.methods[item.name] = ms
                self.thread_roots |= ms.thread_targets
        self.thread_roots &= set(self.methods)

    def reachable(self, root: str) -> Set[str]:
        seen: Set[str] = set()
        stack = [root]
        while stack:
            m = stack.pop()
            if m in seen or m not in self.methods:
                continue
            seen.add(m)
            stack.extend(self.methods[m].calls)
        return seen

    def contexts(self) -> Dict[str, Set[str]]:
        """context name -> method set. One context per thread root,
        plus 'main' = closure over externally-callable methods."""
        ctxs = {f"thread:{r}": self.reachable(r)
                for r in sorted(self.thread_roots)}
        called_internally: Set[str] = set()
        for ms in self.methods.values():
            called_internally |= ms.calls & set(self.methods)
        main_entries = [
            m for m in self.methods
            if m not in self.thread_roots
            and (m == "__init__" or m not in called_internally
                 or not m.startswith("_"))
        ]
        main: Set[str] = set()
        for m in main_entries:
            main |= self.reachable(m)
        main -= self.thread_roots
        ctxs["main"] = main
        return ctxs


def analyze_threads(tree: ast.Module, rel: str) -> List[Finding]:
    in_scope = any(
        rel.startswith(p) if p.endswith("/") else rel == p
        for p in THREAD_SCOPE)
    if not in_scope:
        return []
    findings: List[Finding] = []
    module = _ModuleScan()
    classes = [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]
    scans: List[_ClassScan] = []
    for cls in classes:
        cs = _ClassScan(cls, module)
        cs.scan()
        scans.append(cs)
    for cs in scans:
        cname = cs.node.name
        # NLT02 / NLT03 per method
        for mname, ms in cs.methods.items():
            for line, what in ms.blocking:
                findings.append(Finding(
                    rel, line, "NLT02",
                    THREAD_RULES["NLT02"] + f": {what}()",
                    _HINTS["NLT02"], context=f"{cname}.{mname}"))
        if not cs.thread_roots:
            continue
        ctxs = cs.contexts()
        thread_methods: Set[str] = set()
        for name, methods in ctxs.items():
            if name.startswith("thread:"):
                thread_methods |= methods
        for mname in sorted(thread_methods):
            ms = cs.methods.get(mname)
            if ms is None:
                continue
            for line in ms.swallows:
                findings.append(Finding(
                    rel, line, "NLT03", THREAD_RULES["NLT03"],
                    _HINTS["NLT03"], context=f"{cname}.{mname}"))
        # NLT01: attribute written in one context and touched in
        # another, unless BOTH sides hold a lock at every access —
        # one-sided locking (locked writer, unlocked reader) is still
        # a race and still fires
        skip = cs.lock_attrs | cs.event_attrs | set(cs.methods)
        per_attr: Dict[str, Dict[str, List[_Access]]] = {}
        for ctx_name, methods in ctxs.items():
            for mname in methods:
                ms = cs.methods.get(mname)
                if ms is None or mname == "__init__":
                    continue
                for acc in ms.accesses:
                    if acc.attr in skip:
                        continue
                    per_attr.setdefault(acc.attr, {}).setdefault(
                        ctx_name, []).append(acc)
        for attr in sorted(per_attr):
            by_ctx = per_attr[attr]
            if len(by_ctx) < 2:
                continue
            write_ctxs = sorted(c for c, accs in by_ctx.items()
                                if any(a.write for a in accs))
            if not write_ctxs:
                continue
            other = sorted(c for c in by_ctx if c not in write_ctxs)
            if not other and len(write_ctxs) < 2:
                continue
            unlocked = [a for accs in by_ctx.values() for a in accs
                        if not a.locked]
            if not unlocked:
                continue  # consistently locked on every side
            # report at an unlocked write (thread context first), else
            # at the unlocked access that breaks the discipline
            uw = [a for a in unlocked if a.write]
            site = min(uw or unlocked, key=lambda a: a.line)
            peers = sorted(set(write_ctxs + other))
            findings.append(Finding(
                rel, site.line, "NLT01",
                THREAD_RULES["NLT01"]
                + f": self.{attr} is shared by {', '.join(peers)} and "
                  f"accessed without the lock in {site.method}",
                _HINTS["NLT01"], context=f"{cname}.{attr}"))
    # NLT03 in module-level thread-target functions
    fn_targets = module.fn_thread_targets
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            if _dotted(node.func).endswith("Thread"):
                for kw in node.keywords:
                    if kw.arg == "target" \
                            and isinstance(kw.value, ast.Name):
                        fn_targets.add(kw.value.id)
    if fn_targets:
        seen_lines = {f.line for f in findings if f.rule == "NLT03"}
        for node in ast.walk(tree):
            if isinstance(node, ast.FunctionDef) \
                    and node.name in fn_targets:
                ms = _MethodScan(_ClassScan(None, module), node.name)
                for stmt in node.body:
                    ms.visit(stmt)
                for line in ms.swallows:
                    if line in seen_lines:
                        continue  # nested closure already reported
                    seen_lines.add(line)
                    findings.append(Finding(
                        rel, line, "NLT03", THREAD_RULES["NLT03"],
                        _HINTS["NLT03"], context=node.name))
    return findings
