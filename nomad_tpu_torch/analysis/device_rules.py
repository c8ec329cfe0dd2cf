"""Device-discipline rules on the port (NLD01, NLD03, NLD04).

The reference's device rules read `jax` calls; these read their torch
counterparts and keep the reference's rule ids, so each rule's twin is
found by its id:

* **NLD01 — un-ledgered transfer.** Every host↔device transfer on the
  dispatch path is EXPLICIT and ledger-accounted (lib/transfer.py
  completeness contract). An upload — `.to(<device>)`, `.cuda()`,
  `torch.as_tensor`/`torch.tensor`/`torch.from_numpy` with a device,
  `to_device_async`, `.copy_` from a host tensor — a fetch — `.cpu()`,
  `.to("cpu")`, `.copy_` of a device tensor into a host one, and
  `.numpy()`/`.tolist()`/`.item()` of a device value — or a wait
  (`.synchronize()`) reachable from the dispatch path outside a
  `TransferLedger` scope (`with led.timed(...)`/`led.scope()`) or
  `guard_scope()` region is an unattributed round-trip. A device value
  is one produced by a placement launch (`place_*`, `resolve`), an
  upload, or a torch factory given a device. Coverage is
  interprocedural within the module, as in the reference: a helper
  whose every call site sits inside a covered region is covered.

* **NLD03 — unbooked long-lived device allocation.** A device tensor
  stored on `self` (outliving the function) must be booked in the HBM
  residency ledger in the same function (`hbm.track`/`track_cluster`,
  or a lease) — otherwise the capacity planner's projection silently
  loses a term.

* **NLD04 — non-bitwise carry fold.** Per-lane carries (`torch.stack`
  of per-lane results, or `torch.func.vmap`/`torch.vmap` results) fold
  into one view carry by exact per-row lane SELECTION (`torch.where` on
  a changed-mask), never arithmetic: a float re-accumulation (`+`,
  `.sum(dim=…)`, `torch.sum`/`torch.mean` over the lane axis) breaks
  the carry == host-fold bit-parity the adoption proof relies on
  (kernels/placement.py place_table_wave_plain). Arithmetic combination
  of a per-lane value is flagged; selection, comparison and reshaping
  are not (a comparison result is a mask, no longer a carry).

**Left out: NLD02 (donation-after-use).** Torch has no buffer donation:
no call kills its argument the way `jax.jit(..., donate_argnums=...)`
does. The hazard it guarded — a kernel writing a view another thread
still reads — is met on the port by leasing the view on every launching
path, and NLT06 ("blocking under a device-view lease", `lock_rules`)
already guards that lease.

All rules are scoped to the device-path modules (see the *_SCOPE
tuples) and are pure `ast` — no torch import.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .core import Finding, dotted as _dotted

DEVICE_RULES = {
    "NLD01": "host-device transfer outside a TransferLedger scope or "
             "transfer-guard region",
    "NLD03": "long-lived device allocation not booked in the HBM "
             "residency ledger",
    "NLD04": "arithmetic fold of per-lane carries (wave contract "
             "requires bitwise per-row lane selection)",
}

_HINTS = {
    "NLD01": "wrap the transfer in `with ledger.timed(site, nbytes)` "
             "(or record() it) inside the guard scope",
    "NLD03": "book it: hbm.track(site, buf) / track_cluster — the "
             "site must be in the residency taxonomy",
    "NLD04": "fold by selection: torch.where(changed_mask, lane_value, "
             "base) per lane, copied bitwise",
}

#: the fused dispatch path — modules whose transfers must be accounted
#: (the port moved K7/K8's staging into kernels/rows.py and the sharded
#: routes into kernels/shard.py)
TRANSFER_SCOPE = (
    "nomad_tpu_torch/scheduler/stack.py",
    "nomad_tpu_torch/server/select_batch.py",
    "nomad_tpu_torch/server/program_table.py",
    "nomad_tpu_torch/parallel/mesh.py",
    "nomad_tpu_torch/kernels/rows.py",
    "nomad_tpu_torch/kernels/shard.py",
)
#: where per-lane carries are produced and folded
WAVE_SCOPE = (
    "nomad_tpu_torch/kernels/",
    "nomad_tpu_torch/parallel/",
    "nomad_tpu_torch/scheduler/stack.py",
)

_COVER_LEAVES = {"timed", "scope", "guard_scope"}
#: the port's staged upload helper (convert.py)
_UPLOAD_CALLS = {"to_device_async"}
#: torch constructors that upload when given a device
_FACTORY_UPLOADS = {"as_tensor", "tensor", "from_numpy"}
#: torch constructors that allocate on a device when given one
_DEVICE_ALLOCS = _FACTORY_UPLOADS | {
    "zeros", "ones", "full", "empty", "arange", "zeros_like",
    "ones_like", "full_like", "empty_like"}
#: fetches of a device value
_FETCH_METHODS = {"numpy", "tolist", "item"}
_SYNC_LEAVES = {"synchronize"}
_BOOK_LEAVES = {"track", "track_cluster", "lease"}
_FOLD_LEAVES = {"sum", "mean", "average"}
_ARITH_OPS = (ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv)


def _in_scope(rel: str, scope) -> bool:
    return any(rel.startswith(p) if p.endswith("/") else rel == p
               for p in scope)


def _leaf(node: ast.Call) -> str:
    d = _dotted(node.func)
    if d:
        return d.split(".")[-1]
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    return ""


def _method(node: ast.Call) -> str:
    """'cpu' for `<expr>.cpu(...)`, '' for a bare call."""
    return node.func.attr if isinstance(node.func, ast.Attribute) else ""


def _root_name(node: ast.AST) -> Optional[str]:
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Starred)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _kw(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _device_kind(expr: ast.AST) -> Optional[str]:
    """'cpu', 'device' or None (a dtype, or nothing) for the target of
    `.to(expr)` / a `device=` argument."""
    if isinstance(expr, ast.Constant):
        if isinstance(expr.value, str):
            return "cpu" if expr.value.startswith("cpu") else "device"
        return None
    if isinstance(expr, ast.Call):
        if _leaf(expr) == "device":
            return (_device_kind(expr.args[0]) if expr.args
                    else "device")
        return None
    if isinstance(expr, (ast.Name, ast.Attribute, ast.Subscript)):
        d = _dotted(expr)
        leaf = d.split(".")[-1] if d else ""
        if "dtype" in leaf or leaf == "dt" or (
                d.startswith("torch.") and leaf != "device"):
            return None
        return "device"
    return None


def _to_kind(call: ast.Call) -> Optional[str]:
    """The direction of a `.to(...)` call: 'cpu', 'device' or None."""
    dev = _kw(call, "device")
    if dev is not None:
        return _device_kind(dev)
    return _device_kind(call.args[0]) if call.args else None


def _factory_device(call: ast.Call) -> bool:
    """`torch.<factory>(..., device=<not cpu>)`."""
    d = _dotted(call.func)
    dev = _kw(call, "device")
    return (d.startswith("torch.") and dev is not None
            and _device_kind(dev) == "device")


def _uploads(call: ast.Call) -> bool:
    """An upload call that yields a device tensor."""
    m = _method(call)
    if m == "cuda" or (m == "to" and _to_kind(call) == "device"):
        return True
    leaf = _leaf(call)
    if leaf in _UPLOAD_CALLS:
        return True
    return leaf in _FACTORY_UPLOADS and _factory_device(call)


class _FnUnit:
    """One function / assigned lambda: transfer calls + local coverage."""

    __slots__ = ("name", "cls", "node", "transfers", "callsites",
                 "covered")

    def __init__(self, name: str, cls: Optional[str], node: ast.AST):
        self.name = name
        self.cls = cls            # owning class (direct methods only)
        self.node = node
        #: (line, api, lexically_covered)
        self.transfers: List[Tuple[int, str, bool]] = []
        #: call sites: (kind, name, covered), kind ∈ {bare, self} —
        #: kept separate so coverage propagation never matches a
        #: `self.m()` call against another class's same-named method
        self.callsites: List[Tuple[str, str, bool]] = []
        self.covered = False


# ---- NLD01 -----------------------------------------------------------------


class _TransferScan(ast.NodeVisitor):
    """Scan one function unit: transfer calls with coverage + device
    and host taint (for fetch and `.copy_` detection), local callsite
    coverage."""

    def __init__(self, unit: _FnUnit, np_aliases: Set[str]):
        self.unit = unit
        self.np = np_aliases
        self.cover = 0
        self.device: Set[str] = set()
        self.host: Set[str] = set()

    def scan(self) -> None:
        node = self.unit.node
        body = node.body if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef)) else [node.body]
        for stmt in body:
            self.visit(stmt)

    # device taint: launches, uploads and device factories
    def _device_producing(self, expr: ast.AST) -> bool:
        if isinstance(expr, ast.Call):
            leaf = _leaf(expr)
            if leaf.startswith("place_") or leaf == "resolve":
                return True
            return _uploads(expr) or (leaf in _DEVICE_ALLOCS
                                      and _factory_device(expr))
        r = _root_name(expr)
        return r is not None and r in self.device

    # host taint: tensors made from or fetched into host memory
    def _host_producing(self, expr: ast.AST) -> bool:
        if isinstance(expr, ast.Call):
            d = _dotted(expr.func)
            leaf = _leaf(expr)
            m = _method(expr)
            if m in ("cpu", "pin_memory", "numpy") \
                    or (m == "to" and _to_kind(expr) == "cpu"):
                return True
            if d.split(".")[0] in self.np:
                return True
            if d.startswith("torch.") and leaf in _DEVICE_ALLOCS:
                return not _factory_device(expr)
            return False
        r = _root_name(expr)
        return r is not None and r in self.host

    def _bind(self, target: ast.AST, value: Optional[ast.AST]) -> None:
        if isinstance(target, ast.Name):
            for taint, producing in ((self.device, self._device_producing),
                                     (self.host, self._host_producing)):
                if value is not None and producing(value):
                    taint.add(target.id)
                else:
                    taint.discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            pairs = (zip(target.elts, value.elts)
                     if isinstance(value, (ast.Tuple, ast.List))
                     and len(value.elts) == len(target.elts)
                     else ((e, None) for e in target.elts))
            for e, v in pairs:
                self._bind(e, v)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, None)

    def visit_Assign(self, node: ast.Assign):
        self.generic_visit(node)
        for tgt in node.targets:
            self._bind(tgt, node.value)

    def visit_With(self, node: ast.With):
        covered = any(
            isinstance(i.context_expr, ast.Call)
            and _leaf(i.context_expr) in _COVER_LEAVES
            for i in node.items)
        for i in node.items:
            self.visit(i.context_expr)
        if covered:
            self.cover += 1
        for stmt in node.body:
            self.visit(stmt)
        if covered:
            self.cover -= 1

    def visit_FunctionDef(self, node):
        return  # nested defs are their own units

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        return  # assigned lambdas are their own units

    def visit_comprehension(self, node: ast.comprehension):
        # `x.tolist() for x in result.explain` — the generator target
        # inherits the iterable's device taint
        if self._device_producing(node.iter):
            self._bind(node.target, node.iter)
        self.generic_visit(node)

    def _api(self, node: ast.Call) -> Optional[str]:
        d = _dotted(node.func)
        m = _method(node)
        leaf = _leaf(node)
        if m in _SYNC_LEAVES:
            return f"{d or '.' + m}()"
        if m == "cpu" and not node.args:
            return f"{d or '.cpu'}()"
        if m == "cuda":
            return f"{d or '.cuda'}()"
        kind = _to_kind(node) if m == "to" else None
        if kind is not None:
            return f"{d or '.to'}({'cpu' if kind == 'cpu' else '<device>'})"
        if leaf in _UPLOAD_CALLS:
            return d or leaf
        if leaf in _FACTORY_UPLOADS and _factory_device(node):
            return f"{d}(device=...)"
        if m == "copy_" and node.args:
            src = node.args[0]
            if self._host_producing(src) \
                    and not self._host_producing(node.func.value):
                return ".copy_(<host tensor>)"
            if self._device_producing(src) \
                    and self._host_producing(node.func.value):
                return "<host tensor>.copy_(<device tensor>)"
        if m in _FETCH_METHODS \
                and self._device_producing(node.func.value):
            return f"<device value>.{m}()"
        return None

    def visit_Call(self, node: ast.Call):
        for g in [g for sub in ast.walk(node)
                  if isinstance(sub, (ast.GeneratorExp, ast.ListComp))
                  for g in sub.generators]:
            self.visit_comprehension(g)
        api = self._api(node)
        if api is not None:
            self.unit.transfers.append((node.lineno, api,
                                        self.cover > 0))
        # local/module callsites for coverage propagation
        if isinstance(node.func, ast.Name):
            self.unit.callsites.append(("bare", node.func.id,
                                        self.cover > 0))
        elif isinstance(node.func, ast.Attribute) \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id == "self":
            self.unit.callsites.append(("self", node.func.attr,
                                        self.cover > 0))
        self.generic_visit(node)


def _collect_units(tree: ast.Module) -> List[_FnUnit]:
    method_of: Dict[ast.AST, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            for stmt in node.body:
                if isinstance(stmt,
                              (ast.FunctionDef, ast.AsyncFunctionDef)):
                    method_of[stmt] = node.name
    units: List[_FnUnit] = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            units.append(_FnUnit(node.name, method_of.get(node), node))
        elif isinstance(node, ast.Assign) \
                and isinstance(node.value, ast.Lambda) \
                and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            units.append(_FnUnit(node.targets[0].id, None, node.value))
    return units


def _np_aliases(tree: ast.Module) -> Set[str]:
    np_ = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "numpy":
                    np_.add(a.asname or "numpy")
    return np_ or {"np", "numpy"}


def _check_transfers(tree: ast.Module, rel: str,
                     findings: List[Finding]) -> None:
    if not _in_scope(rel, TRANSFER_SCOPE):
        return
    np_a = _np_aliases(tree)
    units = _collect_units(tree)
    for u in units:
        _TransferScan(u, np_a).scan()
    # coverage propagation: a unit is covered when its name has call
    # sites and EVERY one is covered (lexically, or from a covered
    # unit). `self.m()` sites match only the CALLER'S class's method;
    # bare calls match only module-level units and assigned lambdas.
    # Units sharing one (class, name) key — e.g. two same-named upload
    # lambdas, one per branch — are judged as a GROUP against the same
    # site set: requiring every syntactic call site of the name to be
    # covered is conservative for whichever unit a given site actually
    # binds to.
    groups: Dict[Tuple[Optional[str], str], List[_FnUnit]] = {}
    for u in units:
        groups.setdefault((u.cls, u.name), []).append(u)
    changed = True
    while changed:
        changed = False
        for (cls, name), members in groups.items():
            if members[0].covered:
                continue
            sites = [cov or caller.covered
                     for caller in units
                     for kind, cname, cov in caller.callsites
                     if cname == name
                     and (cls is not None and caller.cls == cls
                          if kind == "self" else cls is None)]
            if sites and all(sites):
                for m in members:
                    m.covered = True
                changed = True
    for u in units:
        if u.covered:
            continue
        qual = u.name
        for line, api, covered in u.transfers:
            if covered:
                continue
            findings.append(Finding(
                rel, line, "NLD01",
                DEVICE_RULES["NLD01"] + f": {api}",
                _HINTS["NLD01"], context=qual))


# ---- NLD03 -----------------------------------------------------------------


def _device_alloc(call: ast.Call) -> bool:
    """A call that yields a tensor on a device."""
    return _uploads(call) or (_leaf(call) in _DEVICE_ALLOCS
                              and _factory_device(call))


def _check_residency(tree: ast.Module, rel: str,
                     findings: List[Finding]) -> None:
    if not _in_scope(rel, TRANSFER_SCOPE):
        return
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        books = any(
            isinstance(sub, ast.Call) and _leaf(sub) in _BOOK_LEAVES
            for sub in ast.walk(fn))
        if books:
            continue
        for sub in ast.walk(fn):
            if not isinstance(sub, ast.Assign) \
                    or not isinstance(sub.value, ast.Call) \
                    or not _device_alloc(sub.value):
                continue
            d = _dotted(sub.value.func) or f".{_method(sub.value)}"
            for t in sub.targets:
                attr = None
                tt = t
                while isinstance(tt, (ast.Tuple, ast.List)):
                    tt = tt.elts[0]
                if isinstance(tt, ast.Attribute) \
                        and isinstance(tt.value, ast.Name) \
                        and tt.value.id == "self":
                    attr = tt.attr
                if attr is not None:
                    findings.append(Finding(
                        rel, sub.lineno, "NLD03",
                        DEVICE_RULES["NLD03"]
                        + f": self.{attr} = {d}(...) with no "
                          f"hbm.track in {fn.name}()",
                        _HINTS["NLD03"], context=fn.name))


# ---- NLD04 -----------------------------------------------------------------


class _WaveScan(ast.NodeVisitor):
    def __init__(self, rel: str, qual: str, findings: List[Finding]):
        self.rel = rel
        self.qual = qual
        self.findings = findings
        self.lanes: Set[str] = set()

    def visit_FunctionDef(self, node):
        return

    visit_AsyncFunctionDef = visit_FunctionDef

    def _lane_value(self, expr: ast.AST) -> bool:
        """Per-lane taint: `torch.stack` and vmap results, through
        subscript/attr; a comparison kills it (a mask is no longer a
        carry)."""
        if isinstance(expr, (ast.Compare, ast.BoolOp)):
            return False
        if isinstance(expr, ast.Call):
            # torch.vmap(f)(args) / torch.func.vmap(f)(args)
            if isinstance(expr.func, ast.Call) \
                    and _leaf(expr.func) == "vmap":
                return True
            return _dotted(expr.func) == "torch.stack"
        r = _root_name(expr)
        return r is not None and r in self.lanes

    def _bind(self, target: ast.AST, value: ast.AST) -> None:
        if isinstance(target, ast.Name):
            if self._lane_value(value):
                self.lanes.add(target.id)
            else:
                self.lanes.discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            if isinstance(value, (ast.Tuple, ast.List)) \
                    and len(value.elts) == len(target.elts):
                # `a, b = torch.stack(a), torch.stack(b)`
                for t, v in zip(target.elts, value.elts):
                    self._bind(t, v)
            elif self._lane_value(value):
                # destructured vmap result: every component is per-lane
                for name in {n.id for n in ast.walk(target)
                             if isinstance(n, ast.Name)}:
                    self.lanes.add(name)

    def visit_Assign(self, node: ast.Assign):
        self.generic_visit(node)
        for t in node.targets:
            self._bind(t, node.value)

    def _flag(self, node: ast.AST, what: str) -> None:
        self.findings.append(Finding(
            self.rel, node.lineno, "NLD04",
            DEVICE_RULES["NLD04"] + f": {what}",
            _HINTS["NLD04"], context=self.qual))

    def visit_BinOp(self, node: ast.BinOp):
        if isinstance(node.op, _ARITH_OPS) and (
                self._lane_value(node.left)
                or self._lane_value(node.right)):
            self._flag(node, "arithmetic on a per-lane value")
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign):
        if isinstance(node.op, _ARITH_OPS) and (
                self._lane_value(node.target)
                or self._lane_value(node.value)):
            self._flag(node, "arithmetic on a per-lane value")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        leaf = _leaf(node)
        root = _dotted(node.func).split(".")[0]
        if leaf in _FOLD_LEAVES and root in ("torch", "np") \
                and node.args and self._lane_value(node.args[0]):
            self._flag(node, f"{root}.{leaf}() reduces per-lane values")
        elif _method(node) in _FOLD_LEAVES \
                and self._lane_value(node.func.value):
            self._flag(node, f".{_method(node)}() reduces per-lane "
                             "values")
        self.generic_visit(node)


def _check_wave_fold(tree: ast.Module, rel: str,
                     findings: List[Finding]) -> None:
    if not _in_scope(rel, WAVE_SCOPE):
        return
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scan = _WaveScan(rel, fn.name, findings)
            for stmt in fn.body:
                scan.visit(stmt)


def analyze_device(tree: ast.Module, rel: str) -> List[Finding]:
    findings: List[Finding] = []
    _check_transfers(tree, rel, findings)
    _check_residency(tree, rel, findings)
    _check_wave_fold(tree, rel, findings)
    return findings
