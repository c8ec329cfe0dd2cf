"""Preemption candidate ranking (K3).

When bin-packing finds no node with room, the reference retries each node
with eviction enabled (`rank.go:228-448`, a scalar per-node loop calling
the greedy Preemptor). As in `nomad_tpu/kernels/preemption.py`, the search
over nodes is one dense pass: per node, sort that node's preemptible
allocs by job priority ascending, prefix-sum the released resources, find
the minimal victim prefix whose release admits the ask, and score it by
the post-eviction bin-pack fit (`funcs.go:175`) and the logistic
net-priority preemption score (`rank.go:747-783`), averaged. The winning
node's exact victim set is then refined on the host by the greedy
Preemptor (`scheduler/preemption.py`).

Shapes: N node rows × A candidate slots (bucketed). Ineligible slots
(padding, priority delta < 10, the job's own allocs) carry priority
INF_PRIO, so the stable sort puts them behind every real candidate and
the prefix stops at the first of them. The table comes in two forms:

- dense (`PreemptionCandidates`): prio f32[N, A], usage f32[N, A, R],
  pads at INF_PRIO — the reference's layout;
- compact (`CompactCandidates`): only the real victims, row by row (row
  offsets, and for each entry its slot, priority and usage row); an
  absent slot is a pad. `dense_candidates` expands it, `compact_candidates`
  drops a dense table's pads.

Two implementations compute the same function:

- `preempt_rank_plain`: plain PyTorch on any device, on the dense table.
  The CPU tests compare it with the JAX package; `chip_smoke.py` compares
  the kernel with it on the card.
- the hand-written CUDA kernel (`csrc/preempt.cu` `rank_block`): one
  launch a call over either form, fed by one staged copy that carries the
  argument block and whatever arrives as host arrays — the numpy program
  (`PREEMPT_FIELDS`), the snapshot's four arrays (only the attribute
  columns the program reads) and the compact table.

`preempt_rank` dispatches on the device of `cluster.used`: CPU → plain,
CUDA → the kernel (or raise). `preempt_rank_compact` takes the retry's
host arrays and a device: on the CPU it expands the table and runs the
plain version, on a card the kernel. There is no fallback between the
two. The kernel reads only the cluster's capacity, used, node_ok and
attrs; its `ports_used` and `dyn_free` may be None. The kernel's old
two-launch route stays callable as `preempt_rank_two_pass_cuda`.
"""
from __future__ import annotations

import ctypes
from typing import Any, NamedTuple

import numpy as np
import torch

from ..structs.funcs import PREEMPTION_SCORE_ORIGIN, PREEMPTION_SCORE_RATE
from .placement import (_ARG_OFFSETS, _ARG_WORDS, _DIM_FIELDS, _DIM_INTS,
                        PARAM_TYPES, PREEMPT_FIELDS, ClusterArrays,
                        TGParams, _PlaceArgs, _program_dims, _RowLauncher,
                        _lookup, _scatter, _shape, _staged, _tokens,
                        constraint_mask, fit_scores, program_args,
                        program_bytes)

NEG_INF = -1e30
INF_PRIO = 1e9


class PreemptionCandidates(NamedTuple):
    """Per-node candidate-alloc table, dense (the reference's layout)."""

    prio: torch.Tensor    # f32[N, A] — victim job priority; INF_PRIO = pad
    usage: torch.Tensor   # f32[N, A, R] — per-alloc resource rows


class CompactCandidates(NamedTuple):
    """The same table holding only its real victims: row n's entries are
    offsets[n] .. offsets[n + 1], each with its slot in the row's A (slots
    distinct within a row), priority and usage row. numpy arrays (as the
    retry builds it) or tensors."""

    offsets: Any   # i32[N + 1]
    slot: Any      # i32[E]
    prio: Any      # f32[E]
    usage: Any     # f32[E, R]
    slots: int     # A


class PreemptionResult(NamedTuple):
    best_row: torch.Tensor    # i32 — chosen node row, −1 if none feasible
    best_k: torch.Tensor      # i32 — victims in the minimal prefix there
    best_score: torch.Tensor  # f32 — combined normalized score
    order: torch.Tensor       # i32[N, A] — priority-ascending permutation
    feasible: torch.Tensor    # bool[N] — admits the ask after some eviction
    scores: torch.Tensor      # f32[N] — combined score (NEG_INF infeasible)


def compact_candidates(prio, usage) -> CompactCandidates:
    """A dense table (numpy, or tensors on the CPU) as its compact form:
    every slot whose priority is not INF_PRIO, row by row in slot order."""
    prio = np.asarray(prio, dtype=np.float32)
    usage = np.asarray(usage, dtype=np.float32)
    n, a = prio.shape
    rows, slot = np.nonzero(prio != INF_PRIO)
    offsets = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(np.bincount(rows, minlength=n), out=offsets[1:])
    return CompactCandidates(offsets, slot.astype(np.int32),
                             prio[rows, slot], usage[rows, slot], a)


def dense_candidates(table: CompactCandidates):
    """The compact table expanded to the dense layout, as numpy (prio
    f32[N, A], usage f32[N, A, R]): absent slots at INF_PRIO with usage 0,
    the pads the reference's table build writes."""
    offsets, slot, prio_e, usage_e = (np.asarray(t) for t in table[:4])
    n, a = offsets.shape[0] - 1, table.slots
    rows = np.repeat(np.arange(n), np.diff(offsets))
    prio = np.full((n, a), INF_PRIO, dtype=np.float32)
    usage = np.zeros((n, a, usage_e.shape[1]), dtype=np.float32)
    prio[rows, slot] = prio_e
    usage[rows, slot] = usage_e
    return prio, usage


def _feasible(cluster: ClusterArrays, p: TGParams) -> torch.Tensor:
    """The placement kernel's mask as the retry sees it: constraints,
    distinct_hosts and the distinct_property starting counts (the
    reference keeps DistinctHosts/DistinctPropertyIterator ahead of the
    evict-enabled BinPackIterator, stack.go:321-411)."""
    n = cluster.capacity.shape[0]
    feas = constraint_mask(cluster, p)
    if p.jc_idx.shape[0]:
        job_cnt0 = _scatter(p.jc_idx, p.jc_val, n)
        feas = feas & ~(p.distinct_hosts & (job_cnt0 > 0))
    if p.dp_key_idx.shape[0]:
        d_v = p.dp_counts0.shape[1]
        dtok = _tokens(cluster.attrs, p.dp_key_idx, d_v)
        row_ok = (((_lookup(p.dp_counts0, dtok) < p.dp_allowed[None, :])
                   & (dtok != d_v - 1)) | ~p.dp_active[None, :])
        feas = feas & torch.all(row_ok, dim=1)
    return feas


def preempt_rank_plain(cluster: ClusterArrays, p: TGParams,
                       cand: PreemptionCandidates) -> PreemptionResult:
    """Plain PyTorch ranking, term by term the reference's `preempt_rank`;
    its one-hot selections of the minimal prefix are direct indexing
    (one non-zero term each)."""
    cap = cluster.capacity
    n, a = cand.prio.shape
    dev = cap.device
    feas = _feasible(cluster, p)
    used = cluster.used
    if p.delta_idx.shape[0]:
        used = used - _scatter(p.delta_idx, p.delta_res, n)

    order = torch.argsort(cand.prio, dim=1, stable=True)
    prio_s = torch.gather(cand.prio, 1, order)
    usage_s = torch.gather(cand.usage, 1,
                           order[:, :, None].expand(-1, -1, cap.shape[1]))
    eligible = prio_s < INF_PRIO
    prefix_ok = torch.cumprod(eligible.to(torch.int32), dim=1).bool()
    release = torch.cumsum(usage_s, dim=1)
    util_k = (used[:, None, :] - release) + p.ask[None, None, :]
    fits_k = torch.all(util_k <= cap[:, None, :], dim=2) & prefix_ok
    any_fit = torch.any(fits_k, dim=1) & feas
    k_idx = torch.argmax(fits_k.to(torch.int32), dim=1)   # first fit

    psum = torch.cumsum(torch.where(eligible, prio_s, 0.0), dim=1)
    rows = torch.arange(n, device=dev)
    max_p = prio_s[rows, k_idx]           # sorted: the prefix's last is max
    sum_p = psum[rows, k_idx]
    net_prio = torch.where(max_p > 0,
                           max_p + sum_p / torch.clamp(max_p, min=1.0), 0.0)
    pre_score = 1.0 / (1.0 + torch.exp(
        PREEMPTION_SCORE_RATE * (net_prio - PREEMPTION_SCORE_ORIGIN)))
    binpack, _ = fit_scores(util_k[rows, k_idx], cap)
    scores = torch.where(any_fit, (binpack + pre_score) / 2.0, NEG_INF)

    best = torch.argmax(scores)
    found = scores[best] > NEG_INF
    return PreemptionResult(
        best_row=torch.where(found, best, -1).to(torch.int32),
        best_k=torch.where(found, k_idx[best] + 1, 0).to(torch.int32),
        best_score=torch.where(found, scores[best], 0.0),
        order=order.to(torch.int32),
        feasible=any_fit,
        scores=scores,
    )


_VOID, _INT = ctypes.c_void_p, ctypes.c_int


class _PreemptRun(ctypes.Structure):
    """Mirror of `PreemptRun` in csrc/preempt.cu."""

    _fields_ = [("run_size", _INT), ("args_size", _INT), ("slots", _INT),
                ("rows", _INT), ("grid", _INT), ("smem", _INT),
                ("on_chip", _INT), ("offsets", _VOID), ("slot", _VOID),
                ("prio", _VOID), ("usage", _VOID), ("order", _VOID),
                ("feasible", _VOID), ("scores", _VOID), ("best", _VOID),
                ("blocks", _VOID), ("ticket", _VOID), ("scratch", _VOID)]


#: rows (warps) a block at most; a block's default and opt-in limits of
#: dynamic shared memory (csrc/preempt.cu)
PREEMPT_ROWS = 8
SMEM_DEFAULT = 48 * 1024
SMEM_MAX = 232448
#: a block's shared memory before its rows: the PlaceArgs copy, 32
#: (score, row, k) triples and the last-block flag
HEAD_BYTES = ((ctypes.sizeof(_PlaceArgs) + 15) & ~15) + 32 * 12 + 16


def preempt_layout(n: int, a: int, r: int, sms: int) -> dict:
    """How `rank_block` runs N rows of A slots and R resources, by shape
    alone: a row's state (A priorities, A order entries, A·R usages) in
    shared memory, up to 8 rows a block within the default 48 KB, else one
    row a block under the 227 KB opt-in, else off chip — each warp's row
    in its own slice of a scratch buffer, over a grid of one block of 8
    warps an SM (`sms`). Returns rows a block, blocks, dynamic shared
    bytes, on_chip, and the scratch's f32 words (0 on chip)."""
    words = (a * (r + 2) + 3) & ~3
    rows = min(PREEMPT_ROWS, (SMEM_DEFAULT - HEAD_BYTES) // (4 * words))
    if rows < 1 and HEAD_BYTES + 4 * words <= SMEM_MAX:
        rows = 1
    if rows >= 1:
        return dict(rows=rows, grid=-(-n // rows),
                    smem=HEAD_BYTES + 4 * rows * words, on_chip=1,
                    scratch=0)
    grid = min(-(-n // PREEMPT_ROWS), sms)
    return dict(rows=PREEMPT_ROWS, grid=grid, smem=HEAD_BYTES, on_chip=0,
                scratch=grid * PREEMPT_ROWS * words)


class _PreemptLauncher(_RowLauncher):
    """csrc/preempt.cu: the one-launch ranking (`nomad_preempt_stage_rank`,
    `launches` counts its launches, one a call) beside the old two-launch
    route (`nomad_preempt_rank`, `two_pass_launches` two a call); `calls`
    counts the library host calls of both."""

    def __init__(self, *a):
        super().__init__(*a)
        self.two_pass_launches = 0
        self.calls = 0

    def lib(self):
        if self._lib is None:
            lib = super().lib()
            for fn in ("nomad_preempt_run_size", "nomad_preempt_head_bytes"):
                getattr(lib, fn).restype = ctypes.c_size_t
                getattr(lib, fn).argtypes = []
            if (lib.nomad_preempt_run_size() != ctypes.sizeof(_PreemptRun)
                    or lib.nomad_preempt_head_bytes() != HEAD_BYTES):
                raise RuntimeError(
                    "preempt library's PreemptRun or shared-memory layout "
                    "differs from the wrapper's (rebuild csrc/preempt.cu)")
            lib.nomad_preempt_stage_rank.restype = ctypes.c_int
            lib.nomad_preempt_stage_rank.argtypes = [
                _INT, _VOID, _VOID, _VOID, ctypes.c_size_t, _VOID,
                ctypes.POINTER(_PreemptRun), _VOID, _VOID]
        return self._lib

    def _raise(self, lib, err):
        raise RuntimeError("preempt kernel launch failed: "
                           + lib.nomad_preempt_error_string(err).decode())

    def rank(self, index: int, args: np.ndarray, src: int, dst: int,
             nbytes: int, run: _PreemptRun, done) -> None:
        """One `nomad_preempt_stage_rank` call on CUDA device `index`'s
        current stream: the staged copy of `nbytes` from pinned `src` to
        `dst` (the argument block first; `args` its host copy), the one
        `rank_block` launch, then event `done`. Raises when the library
        refuses it (the run carries the wrapper's struct sizes and
        shared-memory plan, checked at every launch)."""
        lib = self.lib()
        stream = torch._C._cuda_getCurrentRawStream(index)
        self.calls += 1
        err = lib.nomad_preempt_stage_rank(
            index, args.ctypes.data, src, dst, nbytes, dst,
            ctypes.byref(run), stream, done.cuda_event)
        if err != 0:
            self._raise(lib, err)
        self.launches += 1

    def two_pass(self, args: _PlaceArgs, *ptrs, device) -> None:
        """The old route's two launches on `device`'s current stream."""
        lib = self.lib()
        stream = torch.cuda.current_stream(device).cuda_stream
        self.calls += 1
        err = lib.nomad_preempt_rank(ctypes.byref(args), *ptrs, stream)
        if err != 0:
            self._raise(lib, err)
        self.two_pass_launches += 2


_PREEMPT = _PreemptLauncher("preempt", "nomad_preempt_rank",
                            [_VOID, _VOID, _INT] + [_VOID] * 7)

#: the cluster fields K3 reads, and their types (attrs i16 or i32)
_READ = {"capacity": torch.float32, "used": torch.float32,
         "node_ok": torch.bool}
_READ_NP = {"capacity": np.float32, "used": np.float32, "node_ok": np.bool_}
#: 8-byte words of the read program fields' and cluster fields' pointers
_PREEMPT_WORDS = np.array([_ARG_OFFSETS[f] // 8 for f in PREEMPT_FIELDS])
_CLUSTER_WORDS = np.array([_ARG_OFFSETS[f] // 8
                           for f in (*_READ, "attrs")])
#: the compact table's types, as tensors and on the host
_TABLE = {"offsets": torch.int32, "slot": torch.int32,
          "prio": torch.float32, "usage": torch.float32}
_TABLE_NP = {"offsets": np.int32, "slot": np.int32, "prio": np.float32,
             "usage": np.float32}
_SMS: dict = {}


def launch_count() -> int:
    """Launches of the one-launch ranking (`rank_block`) since the last
    reset: one a call."""
    return _PREEMPT.launches


def two_pass_launch_count() -> int:
    """Kernel launches of the old route since the last reset: two a
    call."""
    return _PREEMPT.two_pass_launches


def host_calls() -> int:
    """Library host calls of both routes since the last reset: one a
    call."""
    return _PREEMPT.calls


def reset_launch_count() -> None:
    _PREEMPT.launches = _PREEMPT.two_pass_launches = _PREEMPT.calls = 0


def build_kernel() -> None:
    """Build (or load the cached build of) the K3 library now."""
    _PREEMPT.lib()


def _is_host(x) -> bool:
    return not isinstance(x, torch.Tensor)


def _on_card(t, index: int, dtype, name: str) -> int:
    """The device pointer of tensor `t`, checked: on card `index`, of
    `dtype`, contiguous."""
    if (not isinstance(t, torch.Tensor) or t.get_device() != index
            or t.dtype != dtype or not t.is_contiguous()):
        raise TypeError(f"{name} must be a contiguous {dtype} on cuda:"
                        f"{index}")
    return t.data_ptr()


def _check_shapes(n: int, r: int, shapes: dict, a: int, table) -> None:
    """Raises unless the program and the table fit a view of n rows of R
    resources."""
    if not 2 <= r <= 32 or shapes["ask"] != (r,):
        raise ValueError("capacity, used and ask disagree, or R > 32")
    if shapes["extra_mask"] not in ((1,), (n,)):
        raise ValueError("extra_mask must have 1 or N entries")
    if (len(shapes["lut"]) != 2 or shapes["key_idx"] != shapes["lut"][:1]
            or shapes["delta_res"] != shapes["delta_idx"] + (r,)
            or shapes["jc_val"] != shapes["jc_idx"]
            or shapes["dp_counts0"][:1] != shapes["dp_key_idx"]
            or shapes["dp_allowed"] != shapes["dp_key_idx"]
            or shapes["dp_active"] != shapes["dp_key_idx"]):
        raise ValueError("the program's constraint, delta, job-count or "
                         "distinct_property fields disagree in shape")
    if a < 1:
        raise ValueError("the candidate table needs A ≥ 1 slots")
    if isinstance(table, PreemptionCandidates):
        if (tuple(table.prio.shape) != (n, a)
                or tuple(table.usage.shape) != (n, a, r)):
            raise ValueError("candidate tables must be [N, A] and "
                             "[N, A, R]")
        return
    e = _shape(table.slot)
    if (_shape(table.offsets) != (n + 1,) or len(e) != 1
            or _shape(table.prio) != e or _shape(table.usage) != e + (r,)):
        raise ValueError("a compact table must be offsets [N + 1], slot "
                         "and prio [E], usage [E, R]")


def preempt_stage(cluster, p, table, index: int):
    """One `rank_block` launch's staged copy on card `index`: (parts,
    finish, (N, A, R)). Each of the cluster (capacity, used, node_ok, attrs), the
    program (`PREEMPT_FIELDS`) and the table (dense `PreemptionCandidates`
    or `CompactCandidates`) is read in place when it comes as tensors on
    the card and staged when it comes as host arrays. `parts` are numpy
    arrays: room for the argument block, the ticket (zeros), then the
    staged inputs. When both the cluster and the program are host arrays,
    only the attribute columns the program's key_idx and dp_key_idx
    reference are staged, the indices remapped to them. `finish(addr)`,
    given each part's device address, returns (the argument block as
    uint64 words, the table's four pointers: offsets, slot, prio, usage —
    offsets and slot 0 for a dense table). Raises when an input does not
    fit the others."""
    parts = [np.empty(_ARG_WORDS, dtype=np.uint64), np.zeros(4, np.uint32)]
    where = {}   # name → part index (staged) or pointer (in place)

    def put(name, arr):
        where[name] = ("part", len(parts))
        parts.append(arr)

    host_cl, host_p = _is_host(cluster.used), _is_host(p.ask)
    n, r = _shape(cluster.capacity)
    attrs = cluster.attrs
    if host_cl:
        for name, dt in _READ_NP.items():
            a = np.asarray(getattr(cluster, name))
            if a.shape != ((n, r) if name != "node_ok" else (n,)):
                raise ValueError(f"cluster.{name} has shape {a.shape}")
            put(name, a if a.dtype == dt and a.flags.c_contiguous
                else np.ascontiguousarray(a, dtype=dt))
        attrs = np.asarray(attrs)
        if attrs.shape[0] != n:
            raise ValueError(f"cluster.attrs has {attrs.shape[0]} rows, "
                             f"capacity {n}")
        if attrs.dtype not in (np.int16, np.int32):
            attrs = attrs.astype(np.int32)
        if host_p:
            cols = np.unique(np.concatenate([
                np.asarray(p.key_idx, np.int32).reshape(-1),
                np.asarray(p.dp_key_idx, np.int32).reshape(-1)]))
            p = p._replace(
                key_idx=np.searchsorted(cols, p.key_idx).astype(np.int32),
                dp_key_idx=np.searchsorted(cols, p.dp_key_idx).astype(
                    np.int32))
            attrs = attrs[:, cols]
        k_cols, attrs_i32 = attrs.shape[1], int(attrs.dtype == np.int32)
        if attrs.size:
            put("attrs", np.ascontiguousarray(attrs))
        else:
            where["attrs"] = ("ptr", 0)
    else:
        for name, dt in _READ.items():
            where[name] = ("ptr", _on_card(getattr(cluster, name), index, dt,
                                           f"cluster.{name}"))
        if attrs.dtype not in (torch.int16, torch.int32):
            raise TypeError("cluster.attrs must be int16 or int32")
        where["attrs"] = ("ptr", _on_card(attrs, index, attrs.dtype,
                                          "cluster.attrs"))
        k_cols, attrs_i32 = attrs.shape[1], int(attrs.dtype == torch.int32)
        if tuple(cluster.used.shape) != (n, r) or attrs.shape[0] != n:
            raise ValueError("capacity, used and attrs disagree on N or R")

    if host_p:
        blob, offs = program_bytes(p, PREEMPT_FIELDS)
        blob_at = len(parts)
        parts.append(blob)
        prog = None
    else:
        prog = [_on_card(getattr(p, f), index, PARAM_TYPES[f],
                         f"params.{f}") for f in PREEMPT_FIELDS]

    dense = isinstance(table, PreemptionCandidates)
    a = table.prio.shape[1] if dense else int(table.slots)
    shapes = {f: _shape(getattr(p, f)) for f in _DIM_FIELDS + (
        "jc_val", "dp_allowed", "dp_active")}
    _check_shapes(n, r, shapes, a, table)
    names = ("offsets", "slot", "prio", "usage")
    if dense:
        where["offsets"] = where["slot"] = ("ptr", 0)
        for name in ("prio", "usage"):
            where[name] = ("ptr", _on_card(getattr(table, name), index,
                                           torch.float32, f"cand.{name}"))
    elif _is_host(table.prio):
        slot = np.asarray(table.slot)
        if slot.size and (slot.min() < 0 or slot.max() >= a):
            raise ValueError(f"a compact table's slots must lie in [0, {a})")
        for name in names:
            put(name, np.ascontiguousarray(getattr(table, name),
                                           dtype=_TABLE_NP[name]))
    else:
        for name in names:
            where[name] = ("ptr", _on_card(getattr(table, name), index,
                                           _TABLE[name], f"table.{name}"))
    dims = list(_program_dims(shapes, shapes["penalty_idx"][0], False,
                              n).values())

    def finish(addr):
        def ptr(name):
            kind, v = where[name]
            return addr[v] if kind == "part" else v

        words = np.zeros(_ARG_WORDS, dtype=np.uint64)
        words[_PREEMPT_WORDS] = (prog if prog is not None
                                 else [addr[blob_at] + o for o in offs])
        words[_CLUSTER_WORDS] = [ptr(f) for f in (*_READ, "attrs")]
        words.view(np.int32)[_DIM_INTS] = dims + [n, r, k_cols, 0,
                                                  attrs_i32]
        return words, [ptr(f) for f in names]

    return parts, finish, (n, a, r)


def _sms(index: int) -> int:
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SMS[index]


def _check(cluster: ClusterArrays, p: TGParams,
           cand: PreemptionCandidates) -> None:
    dev = cluster.used.device
    tensors = [(f"cluster.{f}", getattr(cluster, f))
               for f in (*_READ, "attrs")]
    tensors += [(f"params.{f}", t) for f, t in p._asdict().items()]
    tensors += [("cand.prio", cand.prio), ("cand.usage", cand.usage)]
    for name, t in tensors:
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, cluster on {dev}")
    for name, dt in _READ.items():
        if getattr(cluster, name).dtype != dt:
            raise TypeError(f"cluster.{name} must be {dt}")
    if cluster.attrs.dtype not in (torch.int16, torch.int32):
        raise TypeError("cluster.attrs must be int16 or int32")
    for name, dt in PARAM_TYPES.items():
        if getattr(p, name).dtype != dt:
            raise TypeError(f"params.{name} must be {dt}")
    if cand.prio.dtype != torch.float32 or cand.usage.dtype != torch.float32:
        raise TypeError("candidate tables must be float32")
    n, r = cluster.capacity.shape
    a = cand.prio.shape[1] if cand.prio.dim() == 2 else 0
    if cand.prio.shape != (n, a) or cand.usage.shape != (n, a, r) or a < 1:
        raise ValueError("candidate tables must be [N, A] and [N, A, R], "
                         "A ≥ 1")
    if not 2 <= r <= 32 or cluster.used.shape != (n, r) \
            or p.ask.shape != (r,):
        raise ValueError("capacity, used and ask disagree, or R > 32")
    if p.extra_mask.shape[0] not in (1, n):
        raise ValueError("extra_mask must have 1 or N entries")


def _rank_cuda(cluster, p, table, dev: torch.device) -> PreemptionResult:
    """`rank_block` on card `dev` in one library call: the staged copy
    (`preempt_stage`), the launch, the ring's event. Outputs stay on the
    card; best_row, best_k and best_score are one three-word record
    (`preempt_best` reads it in one copy)."""
    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    dev = torch.device("cuda", index)
    parts, finish, (n, a, r) = preempt_stage(cluster, p, table, index)
    lay = preempt_layout(n, a, r, _sms(index))
    buf, addr, upload = _staged(parts, dev)
    args, (offsets, slot, prio, usage) = finish(addr)
    order = torch.empty((n, a), dtype=torch.int32, device=dev)
    feasible = torch.empty(n, dtype=torch.bool, device=dev)
    scores = torch.empty(n, dtype=torch.float32, device=dev)
    # the three scalars, then each block's (score, row, k)
    rec = torch.empty(4 + 3 * lay["grid"], dtype=torch.int32, device=dev)
    scratch = (torch.empty(lay["scratch"], dtype=torch.float32, device=dev)
               if lay["scratch"] else None)
    run = _PreemptRun(
        run_size=ctypes.sizeof(_PreemptRun),
        args_size=ctypes.sizeof(_PlaceArgs), slots=a, rows=lay["rows"],
        grid=lay["grid"], smem=lay["smem"], on_chip=lay["on_chip"],
        offsets=offsets, slot=slot, prio=prio, usage=usage,
        order=order.data_ptr(), feasible=feasible.data_ptr(),
        scores=scores.data_ptr(), best=rec.data_ptr(),
        blocks=rec.data_ptr() + 16, ticket=addr[1],
        scratch=None if scratch is None else scratch.data_ptr())
    # the staged copy, the launch and the ring's event in one library call
    upload([args] + parts[1:], lambda host, total, done: _PREEMPT.rank(
        index, args, host.data_ptr(), addr[0], total, run, done))
    # the staged buffer and the scratch may be freed now: the caching
    # allocator hands their memory only to work queued after this launch
    # on the same stream
    del buf, scratch
    return PreemptionResult(best_row=rec[0], best_k=rec[1],
                            best_score=rec[2:3].view(torch.float32)[0],
                            order=order, feasible=feasible, scores=scores)


def preempt_best(result: PreemptionResult):
    """(best_row, best_k, best_score) on the host. The kernel's three are
    one record on the card, read back in one copy and one sync; the plain
    version's are read one by one."""
    row = result.best_row
    at = row.data_ptr()
    if (row.device.type == "cuda" and result.best_k.data_ptr() == at + 4
            and result.best_score.data_ptr() == at + 8):
        w = torch.as_strided(row, (3,), (1,)).cpu().numpy()
        return int(w[0]), int(w[1]), float(w[2:].view(np.float32)[0])
    return int(row), int(result.best_k), float(result.best_score)


def preempt_rank_cuda(cluster: ClusterArrays, p: TGParams,
                      cand) -> PreemptionResult:
    """K3 on CUDA tensors (`csrc/preempt.cu` `rank_block`): one launch, a
    warp a node row with the row in shared memory, the argmax over rows
    in the same launch. `cand` is the dense `PreemptionCandidates` or a
    `CompactCandidates` of tensors on the card; read in place, only the
    argument block and the ticket are staged. Raises when the build or
    the launch fails; never falls back."""
    if cluster.used.device.type != "cuda":
        raise ValueError("preempt_rank_cuda needs CUDA tensors")
    return _rank_cuda(cluster, p, cand, cluster.used.device)


def preempt_rank_two_pass_cuda(cluster: ClusterArrays, p: TGParams,
                               cand: PreemptionCandidates
                               ) -> PreemptionResult:
    """K3's old route, kept to hold and time the one-launch ranking
    against: `csrc/preempt.cu` `nomad_preempt_rank` — `rank_rows` (a warp
    a row, every read from device memory) then `best_row` (one block over
    the rows) — on the dense table as tensors on the card. Raises when the
    build or the launch fails."""
    if cluster.used.device.type != "cuda":
        raise ValueError("preempt_rank_two_pass_cuda needs CUDA tensors")
    _check(cluster, p, cand)
    cluster = ClusterArrays(*(None if t is None else t.contiguous()
                              for t in cluster))
    p = TGParams(*(t.contiguous() for t in p))
    prio, usage = cand.prio.contiguous(), cand.usage.contiguous()
    dev = cluster.used.device
    n, a = prio.shape
    order = torch.empty((n, a), dtype=torch.int32, device=dev)
    feasible = torch.empty(n, dtype=torch.bool, device=dev)
    scores = torch.empty(n, dtype=torch.float32, device=dev)
    kbuf = torch.empty(n, dtype=torch.int32, device=dev)
    best = torch.empty(2, dtype=torch.int32, device=dev)
    best_score = torch.empty((), dtype=torch.float32, device=dev)
    _PREEMPT.two_pass(program_args(cluster, p), prio.data_ptr(),
                      usage.data_ptr(), a, order.data_ptr(),
                      feasible.data_ptr(), scores.data_ptr(),
                      kbuf.data_ptr(), best[0].data_ptr(),
                      best[1].data_ptr(), best_score.data_ptr(), device=dev)
    return PreemptionResult(best_row=best[0], best_k=best[1],
                            best_score=best_score, order=order,
                            feasible=feasible, scores=scores)


def preempt_rank(cluster: ClusterArrays, p: TGParams,
                 cand) -> PreemptionResult:
    """Rank every node for a preemption retry: the plain version for CPU
    tensors, the K3 kernel for CUDA tensors. `cand` is dense, or compact
    on the card."""
    kind = cluster.used.device.type
    if kind == "cpu":
        if isinstance(cand, CompactCandidates):
            cand = PreemptionCandidates(*map(torch.from_numpy,
                                             dense_candidates(cand)))
        return preempt_rank_plain(cluster, p, cand)
    if kind == "cuda":
        return preempt_rank_cuda(cluster, p, cand)
    raise ValueError(f"no preempt_rank implementation for device {kind!r}")


def _cpu_cluster(cluster) -> ClusterArrays:
    """Host arrays (or CPU tensors) of the four fields K3 reads as CPU
    tensors in their kernel types."""
    out = {}
    for name in (*_READ, "attrs"):
        v = getattr(cluster, name)
        if isinstance(v, torch.Tensor):
            out[name] = v
            continue
        v = np.asarray(v)
        dt = _READ_NP.get(name, v.dtype if v.dtype in (np.int16, np.int32)
                          else np.int32)
        out[name] = torch.from_numpy(np.ascontiguousarray(v, dtype=dt))
    return ClusterArrays(**out, ports_used=None, dyn_free=None)


def preempt_rank_compact(cluster, p, table: CompactCandidates,
                         device=None) -> PreemptionResult:
    """The retry's ranking from what its host code holds: the snapshot's
    cluster arrays (numpy, or tensors), `compile_tg`'s numpy program (or
    tensors) and the compact table (numpy, or tensors). The device is the
    cluster's when it holds tensors, else `device` (None → the card). On
    the CPU the table is expanded (`dense_candidates`) and the plain
    version runs; on a card the kernel (`_rank_cuda`: one staged copy, one
    launch, outputs on the card — `preempt_best` reads the three scalars
    back). No fallback between the two."""
    from ..device import resolve_device

    dev = (cluster.used.device if isinstance(cluster.used, torch.Tensor)
           else resolve_device(device))
    if dev.type == "cpu":
        from ..convert import params_from_numpy

        q = p if isinstance(p.ask, torch.Tensor) else params_from_numpy(
            p, "cpu")
        return preempt_rank(_cpu_cluster(cluster), q, table)
    if dev.type == "cuda":
        return _rank_cuda(cluster, p, table, dev)
    raise ValueError(f"no preempt_rank implementation for device "
                     f"{dev.type!r}")
