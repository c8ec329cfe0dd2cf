"""Node-sharded placement: the reference's jitted kernels on a node-sharded
view, without GSPMD.

A `ShardedCluster` holds the cluster's rows split into contiguous node
shards, one per column of a grid of devices, replicated over the grid's
rows (one copy per distinct device). Every route runs K1's scan with its
node axis split: per step, each shard evaluates its rows and reports its
best (score, global row) with what the combine needs; the lead device
(node shard 0 of the batch row) combines the reports — the max score, the
lowest global row among equal scores, the preferred-row override — and
every shard applies the winner: the owner adds the ask to its row, every
shard adds the winner's spread and distinct_property tokens to its copy
of the replicated counts. The routes:

- K9, `sharded_place` (the reference's `_batch_place` and `_step` under a
  (batch, nodes) mesh, `nomad_tpu/parallel/mesh.py:287`, `:303`): a
  batch of B programs split over the grid's rows, Bp = B / rows each,
  independent; `fold` adds `_step`'s fold-in, `used + Σ_b (new_used_b −
  used)` per shard in ascending b.
- B10, `sharded_chain` (`place_task_group_chain` / `place_packed_chain`,
  `nomad_tpu/kernels/placement.py:778`, `:802`, on a sharded view): the
  programs in order on batch row 0's shards, each shard passing its own
  (used, dyn_free) carry from program to program.
- B11, `sharded_task_group` (`place_task_group`, `:345`): B10 at one
  program.
- B12, `sharded_system_feasibility` (`system_feasibility`, `:957`): K2's
  two masks over every shard's rows, in global row order.

With explain (B10, B11) each shard reduces its own rows and the combine
sums the counts and merges the shards' top-K into the global one (score
descending, the lowest global row first among equal scores; K = min(5,
global N)). With a batch axis > 1 the chain, single and system routes
read batch row 0's shards; the view cache keeps every copy equal.

Each route has a plain version (the same loop in PyTorch, on any devices;
the CPU tests hold it against the reference's mesh) and a CUDA one
(`csrc/shard.cu`, K2's `csrc/system.cu` for B12, `csrc/lanes.cu` for K9
on one card); the shards' device type picks. B12 on CUDA shards is one
`system_rows` launch a card over every shard it holds, each shard's
argument block pointing at its rows moved back by its first row, the
program's fields global (no rebase). On CUDA shards each of B10,
B11 and K9 takes one of two launch structures, chosen from the devices
and the layout alone (`chain_route`, `step_route`): when the S ≤ 8 node
shards share one card, thread-block clusters of S blocks, one a shard —
B10/B11 two launches a dispatch (the static pass of every shard, then one
cluster that runs every step of every program), K9 one cluster a program
(csrc/lanes.cu's lane route, each shard's rows in shared memory) in one
launch and the fold in a second; otherwise launches a step per shard,
records copied to the lead device, a combine there and the winner copied
back. A failed launch raises; neither structure gives way to the other,
and the two are bitwise equal.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .placement import (
    _ARGS_DTYPE,
    _LANES,
    BLOCK_SMEM,
    EXPLAIN_TOPK,
    MAX_FOLD_COPIES,
    ClusterArrays,
    PlacementExplain,
    PlacementResult,
    TGParams,
    _check_cluster,
    _explain_of,
    _explain_out,
    _explain_step,
    _flat_outputs,
    _lane_args,
    _LaneRun,
    _LaneShardFold,
    _PlaceArgs,
    _program,
    _program_dims,
    _rows_ptrs,
    _scratch_shapes,
    _set_cluster,
    _stacked_source,
    _staged,
    _static_plain,
    _step_plain,
    _take_plain,
    _unpack_params,
    args_pointer,
    lane_layout,
    pack_params,
    packed_ptrs,
    system_feasibility_plain,
    system_masks_on,
    system_pass_cuda,
)

_VOID = ctypes.c_void_p
_INT = ctypes.c_int


def _to(t: torch.Tensor, dev) -> torch.Tensor:
    """`t` on `dev`: every move the sharded routes make between the
    grid's devices (a program slice to its shard, a shard's result or
    carry to the grid's first device) goes through here."""
    return t.to(dev)  # nomadlint: ok NLD01 device to device on a card mesh, no copy on one card or on CPU shards; the server's programs are already on the lead card, uploaded at a booked site (host programs from entry's step or a test upload here unbooked)


def _host(t: torch.Tensor) -> torch.Tensor:
    """`t` on the host: the plain versions' gather of the shards' step
    results."""
    return t.cpu()  # nomadlint: ok NLD01 plain version: on the server's path it runs on CPU shards (a CUDA view takes the kernel routes), where this moves nothing; on a card mesh it runs only as the kernels' reference


#: TGParams fields that hold node rows (−1 pads): rebased to each shard
ROW_FIELDS = ("delta_idx", "cand_idx", "penalty_idx", "jc_idx", "jtc_idx",
              "pclr_idx", "pset_idx")


class ShardedCluster(NamedTuple):
    """A cluster view split into row shards over a grid of devices."""

    devices: tuple   # [batch rows][node shards] torch.device
    row0: tuple      # the first global row of each node shard
    n: int           # global rows
    shards: tuple    # [batch rows][node shards] ClusterArrays

    def full(self, device=None) -> ClusterArrays:
        """The whole view on one device (the first of the grid's by
        default), gathered from the first batch row's shards."""
        dev = self.devices[0][0] if device is None else torch.device(device)
        return ClusterArrays(*(torch.cat([_to(t, dev) for t in ts])
                               for ts in zip(*self.shards[0])))


def rebase(p: TGParams, row0: int, rows: int, n: int) -> TGParams:
    """Programs `p` as one shard of `rows` rows from global row `row0` sees
    them: row fields are `idx − row0` inside the shard and −1 outside; a
    node-width extra_mask (last dim n) is sliced. The preferred rows stay
    global (the combine reads them)."""
    f = p._asdict()
    for name in ROW_FIELDS:
        t = f[name]
        f[name] = torch.where((t >= row0) & (t < row0 + rows), t - row0, -1)
    em = f["extra_mask"]
    if em.shape[-1] == n and n != 1:
        f["extra_mask"] = em[..., row0:row0 + rows]
    return TGParams(**f)


def _as_params(batch) -> TGParams:
    if any(isinstance(t, np.ndarray) for t in batch):
        from ..convert import params_from_numpy

        return params_from_numpy(batch, "cpu")
    return batch


def _per_row(sc: ShardedCluster, batch) -> int:
    """Programs per batch row of a stacked batch (numpy or tensors).
    Raises ValueError when the batch rows do not divide B."""
    b, bm = batch.n_place.shape[0], len(sc.devices)
    if b % bm:
        raise ValueError(f"{b} programs do not split over {bm} batch rows")
    return b // bm


def _split(sc: ShardedCluster, batch) -> Tuple[TGParams, int, int]:
    """The batch as CPU/torch tensors, and (programs per batch row, rows
    per shard). Raises ValueError when the batch rows do not divide B."""
    return _as_params(batch), _per_row(sc, batch), sc.n // len(sc.row0)


def _row_programs(batch: TGParams, i: int, bp: int, dev) -> TGParams:
    return TGParams(*(_to(t[i * bp:(i + 1) * bp], dev) for t in batch))


def _check_grid(sc: ShardedCluster, kind: str) -> None:
    for row in sc.devices:
        for d in row:
            if d.type != kind:
                raise ValueError(f"shard on {d}, expected {kind} devices")


# ---- plain PyTorch version --------------------------------------------------


def _merge_topk(parts, row0, k: int):
    """The global top-`k` from the shards' top-K lists `parts` (per shard
    (local idx, score, score parts), each in top-K order): a stable
    descending sort of the concatenation, in shard order, keeps the lowest
    global row first among equal scores."""
    idx = torch.cat([_host(i.long()) + r0 for (i, _s, _p), r0 in
                     zip(parts, row0)])
    score = torch.cat([_host(sc) for _i, sc, _p in parts])
    pp = torch.cat([_host(p) for _i, _s, p in parts])
    order = torch.sort(score, descending=True, stable=True).indices[:k]
    return idx[order].to(torch.int32), score[order], pp[order]


def _place_program_plain(shards, ps, row0, ns, max_allocs, explain=False,
                         topk=0):
    """One program over the node shards `shards` (its rebased fields
    `ps`, one per shard): static pass, then per step the shards' reports,
    the combine and the apply. Returns (sel, score, nodes_feasible, fits,
    final0 per shard, new_used per shard, the explain leaves or None);
    explain's top-K holds `topk` rows of the whole view."""
    nm = len(shards)
    sts = [_static_plain(cl, p, explain) for cl, p in zip(shards, ps)]
    p0 = ps[0]
    sels, scores, fits, final0 = [], [], [], None
    ex_steps = []
    for i in range(max_allocs):
        # (b) each shard's step and its best row
        evs = [_step_plain(cl, p, st, i)
               for cl, p, st in zip(shards, ps, sts)]
        local = [int(torch.argmax(ev["masked"])) for ev in evs]
        if i == 0:
            final0 = [ev["masked"] for ev in evs]
        if explain:
            # each shard's reductions over its own rows, then the combine
            steps = [_explain_step(st, ev, min(topk, ns))
                     for st, ev in zip(sts, evs)]
            tk = _merge_topk([x[5:] for x in steps], row0, topk)
            ex_steps.append(tuple(
                sum(_host(x[q]) for x in steps) for q in range(5)) + tk)
        # (c) the combine: the max score, the first shard (lowest global
        # row) among equal ones; the preferred row from its owner
        vals = torch.stack([_host(ev["masked"][k]) for ev, k in
                            zip(evs, local)])
        jb = int(torch.argmax(vals))
        pref = int(p0.preferred_idx[i])
        pj = pref // ns if pref >= 0 else nm
        pref_ok = pj < nm and bool(evs[pj]["ok"][pref - row0[pj]])
        j = pj if pref_ok else jb
        loc = pref - row0[pj] if pref_ok else local[jb]
        found = bool(evs[j]["ok"][loc]) and i < int(p0.n_place)
        sels.append(row0[j] + loc if found else -1)
        scores.append(_host(evs[j]["final"][loc]) if found
                      else torch.zeros((), dtype=torch.float32))
        fits.append(sum(int((st["feas"] & ev["fits"]).sum())
                        for st, ev in zip(sts, evs)))
        # (d) the apply on every shard, the tokens from the owner
        stok, dtok = sts[j]["stok"][loc], sts[j]["dtok"][loc]
        for k, (p, st) in enumerate(zip(ps, sts)):
            dev = st["used"].device
            _take_plain(st, p, loc if k == j else -1, found, _to(stok, dev),
                        _to(dtok, dev))
    nfeas = sum(int(st["nodes_feasible"]) for st in sts)
    ex = None
    if explain:
        ex_static = {f: sum(_host(st["ex_static"][f]) for st in sts)
                     for f in sts[0]["ex_static"]}
        ex = _explain_of(ex_static, ex_steps)
    return (sels, scores, nfeas, fits, final0, [st["used"] for st in sts],
            ex)


def sharded_place_plain(sc: ShardedCluster, batch, max_allocs: int,
                        fold: bool = False):
    """Plain sharded placement; returns (PlacementResult with a leading B,
    gathered on the grid's first device, the folded used per node shard
    or None)."""
    batch, bp, ns = _split(sc, batch)
    bm, nm = len(sc.devices), len(sc.row0)
    out = sc.devices[0][0]
    rows = []
    carries = [[[] for _ in range(nm)] for _ in range(bm)]
    for i in range(bm):
        ps = [rebase(_row_programs(batch, i, bp, sc.devices[i][j]),
                     sc.row0[j], ns, sc.n) for j in range(nm)]
        for k in range(bp):
            sels, scores, nfeas, fits, final0, used, _ex = \
                _place_program_plain(sc.shards[i],
                                     [_program(p, k) for p in ps], sc.row0,
                                     ns, max_allocs)
            rows.append(PlacementResult(
                sel_idx=torch.tensor(sels, dtype=torch.int32),
                sel_score=torch.stack(scores) if scores
                else torch.zeros(0, dtype=torch.float32),
                new_used=torch.cat([_to(u, out) for u in used]),
                nodes_feasible=torch.tensor(nfeas, dtype=torch.int32),
                nodes_fit=torch.tensor(fits, dtype=torch.int32),
                final_scores0=(torch.cat([_to(f, out) for f in final0])
                               if final0 is not None
                               else torch.zeros(0, dtype=torch.float32))))
            for j in range(nm):
                carries[i][j].append(used[j])
    result = PlacementResult(*(torch.stack([_to(getattr(r, f), out)
                                            for r in rows])
                               for f in PlacementResult._fields[:6]))
    folded = None
    if fold:
        folded = []
        for j in range(nm):
            acc = torch.zeros_like(sc.shards[0][j].used)
            for i in range(bm):
                used = sc.shards[i][j].used
                acc = _to(acc, used.device)
                for nu in carries[i][j]:
                    acc = acc + (nu - used)
            folded.append(used + acc)
    return result, folded


def _on(p: TGParams, dev) -> TGParams:
    return TGParams(*(_to(t, dev) for t in p))


def _shard_dyn(dyn, n_dyn, sel, row0: int, rows: int):
    """A shard's dyn_free carry after a program that placed on global
    rows `sel`: dyn − placed · n_dyn, as `_chain_with_carry` does."""
    local = torch.as_tensor(sel, dtype=torch.long) - row0
    local = _to(local[(local >= 0) & (local < rows)], dyn.device)
    placed = torch.zeros(rows, dtype=torch.float32, device=dyn.device)
    placed = placed.index_add_(0, local, torch.ones_like(local,
                                                         dtype=torch.float32))
    return dyn - placed * n_dyn


def sharded_chain_plain(sc: ShardedCluster, batch, max_allocs: int,
                        explain: bool = False):
    """Plain B10: the programs of `batch` ([P, ...] fields) in order on
    batch row 0's shards, each shard's (used, dyn_free) carried from
    program to program. Returns (PlacementResult with a leading P on the
    grid's first device, new_used the carry after each program; the
    final carry per shard)."""
    batch = _as_params(batch)
    shards, devs = sc.shards[0], sc.devices[0]
    ns = sc.n // len(sc.row0)
    out = devs[0]
    topk = min(EXPLAIN_TOPK, sc.n)
    carry = [(sh.used, sh.dyn_free) for sh in shards]
    results = []
    for b in range(batch.n_place.shape[0]):
        prog = _program(batch, b)
        ps = [rebase(_on(prog, d), r0, ns, sc.n)
              for d, r0 in zip(devs, sc.row0)]
        cls = [sh._replace(used=u, dyn_free=d)
               for sh, (u, d) in zip(shards, carry)]
        sels, scores, nfeas, fits, final0, used, ex = _place_program_plain(
            cls, ps, sc.row0, ns, max_allocs, explain, topk)
        carry = [(u, _shard_dyn(d, p.n_dyn, sels, r0, ns))
                 for u, (_u, d), p, r0 in zip(used, carry, ps, sc.row0)]
        results.append(PlacementResult(
            sel_idx=torch.tensor(sels, dtype=torch.int32),
            sel_score=(torch.stack(scores) if scores
                       else torch.zeros(0, dtype=torch.float32)),
            new_used=torch.cat([_to(u, out) for u in used]),
            nodes_feasible=torch.tensor(nfeas, dtype=torch.int32),
            nodes_fit=torch.tensor(fits, dtype=torch.int32),
            final_scores0=(torch.cat([_to(f, out) for f in final0])
                           if final0 is not None
                           else torch.zeros(0, dtype=torch.float32)),
            explain=ex))
    ex = None
    if explain:
        ex = PlacementExplain(*(torch.stack([_to(leaf, out) for leaf in col])
                                for col in zip(*(r.explain
                                                 for r in results))))
    result = PlacementResult(*(torch.stack([_to(getattr(r, f), out)
                                            for r in results])
                               for f in PlacementResult._fields[:6]),
                             explain=ex)
    return result, carry


# ---- the CUDA kernel ----------------------------------------------------------


#: the combine's explain outputs, in `ShardCombine`'s order (the names of
#: `_scratch_shapes`' explain buffers)
_EXPLAIN_BUFS = ("ex_static", "filt_constraint", "filt_distinct", "filt_dp",
                 "exh_dim", "exh_dyn", "exh_res", "topk_idx", "topk_score",
                 "topk_parts")


class _ShardStep(ctypes.Structure):
    """Mirror of `ShardStep` in csrc/shard.cu."""

    _fields_ = [("step", _INT), ("apply", _INT), ("row0", _INT),
                ("rec_words", _INT), ("win_words", _INT), ("rec", _VOID),
                ("win", _VOID), ("counts", _VOID), ("dyn_c", _VOID),
                ("taken", _VOID)]


class _ShardCombine(ctypes.Structure):
    """Mirror of `ShardCombine` in csrc/shard.cu."""

    _fields_ = [("step", _INT), ("shards", _INT), ("progs", _INT),
                ("m", _INT), ("rec_words", _INT), ("win_words", _INT),
                ("prog0", _INT), ("cstride", _INT),
                ("rec", _VOID), ("win", _VOID), ("sel_idx", _VOID),
                ("sel_score", _VOID), ("nodes_fit", _VOID),
                ("nodes_feasible", _VOID)] + [
                    (name, _VOID) for name in _EXPLAIN_BUFS]


#: the largest thread-block cluster of the chain kernel (csrc/shard.cu
#: MAX_CLUSTER, the portable cluster size)
MAX_CLUSTER = 8


class _ShardChain(ctypes.Structure):
    """Mirror of `ShardChain` in csrc/shard.cu."""

    _fields_ = [("shards", _INT), ("progs", _INT), ("m", _INT),
                ("scan_bytes", _INT), ("n", _INT),
                ("args", _VOID * MAX_CLUSTER), ("row0", _INT * MAX_CLUSTER),
                ("dyn_c", _VOID * MAX_CLUSTER), ("snap", _VOID),
                ("out", _ShardCombine)]


class _Launcher:
    """The shard library (csrc/shard.cu), built at first use, its count of
    K9 dispatches and their kernel launches on either route, the kernel
    launches of the sharded routes, the host calls (launches and copies)
    the last sharded dispatch made, and the route the last chain or
    single dispatch and the last K9 dispatch took."""

    def __init__(self):
        self.launches = 0
        self.step_kernels = 0
        self.routes = dict.fromkeys(ROUTES, 0)
        self.host_calls = 0
        self.last_route = None
        self.last_step_route = None
        self._lib = None

    def lib(self):
        if self._lib is None:
            from ._build import load_library

            lib = load_library("shard")
            for fn in ("nomad_shard_args_size", "nomad_shard_chain_size"):
                getattr(lib, fn).restype = ctypes.c_size_t
                getattr(lib, fn).argtypes = []
            lib.nomad_shard_error_string.restype = ctypes.c_char_p
            lib.nomad_shard_error_string.argtypes = [ctypes.c_int]
            args = ctypes.POINTER(_PlaceArgs)
            for fn, argtypes in (
                    ("nomad_shard_static", [args, _VOID, _INT, _INT,
                                            _VOID]),
                    ("nomad_shard_step", [args, _VOID, _INT,
                                          ctypes.POINTER(_ShardStep), _VOID]),
                    ("nomad_shard_combine", [_VOID,
                                             ctypes.POINTER(_ShardCombine),
                                             _VOID]),
                    ("nomad_shard_static_shards", [
                        args, ctypes.POINTER(_ShardChain), _VOID]),
                    ("nomad_shard_chain", [args, ctypes.POINTER(_ShardChain),
                                           _VOID]),
                    ("nomad_shard_fold", [_VOID, _VOID, _VOID, _VOID, _INT,
                                          _INT, _VOID])):
                getattr(lib, fn).restype = ctypes.c_int
                getattr(lib, fn).argtypes = argtypes
            if lib.nomad_shard_args_size() != ctypes.sizeof(_PlaceArgs) \
                    or lib.nomad_shard_chain_size() != ctypes.sizeof(
                        _ShardChain):
                raise RuntimeError(
                    "shard library's PlaceArgs or ShardChain layout differs "
                    "from the wrapper's (rebuild csrc/shard.cu)")
            self._lib = lib
        return self._lib

    def call(self, fn: str, dev, *args, route: Optional[str] = None) -> None:
        """Run entry point `fn` with `dev` current, on its current stream
        (the last argument); raises on a refused launch. Counts the launch
        to `route`'s launches when given."""
        lib = self.lib()
        with torch.cuda.device(dev):
            err = getattr(lib, fn)(
                *args, torch.cuda.current_stream(dev).cuda_stream)
        self.host_calls += 1
        if err != 0:
            raise RuntimeError(f"shard kernel {fn} failed: "
                               + lib.nomad_shard_error_string(err).decode())
        if route == STEP:
            self.step_kernels += 1
        elif route is not None:
            self.routes[route] += 1

    def copy(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        """A record or winner copy between shards, on the devices' current
        streams (a cross-device copy waits on both)."""
        dst.copy_(src)
        self.host_calls += 1


#: the sharded routes with a launch count of their own
ROUTES = ("chain", "single", "system")
#: K9's launches count to `step_kernel_launches`
STEP = "step"

_SHARD = _Launcher()


def launch_count() -> int:
    """K9 dispatches since the last reset."""
    return _SHARD.launches


def reset_launch_count() -> None:
    """Zero K9's dispatch and kernel-launch counts."""
    _SHARD.launches = _SHARD.step_kernels = 0


def step_kernel_launches() -> int:
    """Kernel launches of K9's dispatches on CUDA shards since the last
    reset: on the cluster route one (`lane_cluster`) and, with the fold,
    a second; on the steps route every static, step, combine and fold
    launch."""
    return _SHARD.step_kernels


def last_step_route() -> Optional[str]:
    """The route the last K9 dispatch took: "plain", "cluster" or "steps"
    (`step_route`); None before the first."""
    return _SHARD.last_step_route


def route_launch_counts() -> dict:
    """Kernel launches of the sharded chain (B10), single program (B11)
    and system masks (B12) on CUDA shards since the last reset: every
    static, cluster, step and combine launch of a chain or single
    dispatch; a launch a card of a system call (a shard on its shards
    route)."""
    return dict(_SHARD.routes)


def reset_route_launch_counts() -> None:
    _SHARD.routes = dict.fromkeys(ROUTES, 0)


def host_calls() -> int:
    """Host calls (kernel launches and copies) of the last CUDA sharded
    chain, single, step or system dispatch (on B12's shards route its K2
    launches alone)."""
    return _SHARD.host_calls


def last_chain_route() -> Optional[str]:
    """The route the last sharded chain or single dispatch took:
    "plain", "cluster" or "steps" (`chain_route`); None before the
    first."""
    return _SHARD.last_route


def build_kernel() -> None:
    """Build (or load the cached build of) the shard library now."""
    _SHARD.lib()


_ARG_SIZE = ctypes.sizeof(_PlaceArgs)


def _words(dims: dict, r: int, explain: bool) -> Tuple[int, int]:
    """A step record's and a winner's words (csrc/shard.cu
    shard_rec_words(), 2 + s + p)."""
    tw = dims["s"] + dims["p"]
    rec = 7 + 2 * tw + (4 + r + 7 * dims["topk"] + 3 + dims["c"]
                        if explain else 0)
    return rec, 2 + tw


class _Cell:
    """One (batch row, node shard) of a dispatch: the shard's programs,
    scratch, carries, counts, step records and winners on its device.
    A chain cell (`chain`) runs its programs one at a time against one
    carry, started from the shard's view, and holds one program's
    records; a batch cell (K9) runs them side by side, a carry each. A
    chain cell counts its launches to `route`."""

    def __init__(self, shard: ClusterArrays, progs: TGParams, row0: int,
                 max_allocs: int, explain: bool = False, chain: bool = False,
                 n_global: Optional[int] = None,
                 route: Optional[str] = None):
        _check_cluster(shard)
        self.dev = shard.used.device
        self.row0 = row0
        self.route = route
        # held until the dispatch ends: the launches read these fields
        self.progs = TGParams(*(t.contiguous() for t in progs))
        progs = self.progs
        bp, shapes, ptrs_of = _stacked_source(shard, progs)
        lanes, per_lane = (1, bp) if chain else (bp, 1)
        (self.dims, self.args, self.dev_args, self.prog, self.lane,
         self.used) = _lane_args(shard, shapes, ptrs_of, lanes, per_lane,
                                 max_allocs, explain, n_global=n_global)
        d = self.dims
        self.rec_words, self.win_words = _words(d, shard.capacity.shape[1],
                                                explain)
        i32 = torch.int32
        rows = 1 if chain else bp
        self.rec = torch.empty((rows, self.rec_words), dtype=i32,  # nomadlint: ok NLD03 a cell's scratch lives for one steps dispatch (the cells are dropped when it returns), like the kernels' other per-launch scratch
                               device=self.dev)
        self.win = torch.zeros((rows, self.win_words), dtype=i32,  # nomadlint: ok NLD03 a cell's scratch lives for one steps dispatch (the cells are dropped when it returns), like the kernels' other per-launch scratch
                               device=self.dev)
        self.counts = torch.empty(  # nomadlint: ok NLD03 a cell's scratch lives for one steps dispatch (the cells are dropped when it returns), like the kernels' other per-launch scratch
            (rows, max(d["s"] * d["sv"] + d["p"] * d["dv"], 1)),
            dtype=torch.float32, device=self.dev)
        self.dyn = self.taken = None
        if chain:
            self.used[0].copy_(shard.used)
            self.dyn = shard.dyn_free.clone()
            self.taken = torch.empty(max(max_allocs, 1), dtype=i32,  # nomadlint: ok NLD03 a cell's scratch lives for one steps dispatch (the cells are dropped when it returns), like the kernels' other per-launch scratch
                                     device=self.dev)

    def static(self, carry: bool) -> None:
        """The static pass of every program; `carry` also writes each
        program's carry from the view (K9)."""
        _SHARD.call("nomad_shard_static", self.dev, args_pointer(self.args),
                    self.dev_args.data_ptr(), len(self.args), int(carry),
                    route=self.route)

    def step(self, step: int, apply: bool, k: Optional[int] = None) -> None:
        """Step `step` of every program (K9), or of a chain's program
        `k`."""
        t = _ShardStep(step=step, apply=int(apply), row0=self.row0,
                       rec_words=self.rec_words, win_words=self.win_words,
                       rec=self.rec.data_ptr(), win=self.win.data_ptr(),
                       counts=self.counts.data_ptr(),
                       dyn_c=None if self.dyn is None else self.dyn.data_ptr(),
                       taken=(None if self.taken is None
                              else self.taken.data_ptr()))
        off = 0 if k is None else k
        _SHARD.call("nomad_shard_step", self.dev,
                    args_pointer(self.args[off:]),
                    self.dev_args.data_ptr() + off * _ARG_SIZE,
                    len(self.args) if k is None else 1, ctypes.byref(t),
                    route=self.route)


def _step_dims(batch: TGParams, max_allocs: int, n: int) -> dict:
    """`_program_dims` of K9's programs (explain off) on n global rows."""
    return _program_dims({f: tuple(t.shape[1:])
                          for f, t in batch._asdict().items()},
                         max_allocs, False, n)


def step_route(devices, n: int, dims: dict, r: int) -> str:
    """K9's route over the grid `devices` ([batch rows][node shards]) for
    programs of `dims` (`_program_dims`) on n rows, R = r, from the devices
    and the layout alone: "plain" on CPU shards; "cluster" (csrc/lanes.cu:
    one thread-block cluster a program, one block a node shard, then one
    fold launch) when every shard of every batch row lies on one CUDA
    device, there are at most MAX_CLUSTER node shards and MAX_FOLD_COPIES
    shards in all, and a node shard's rows fit a block of the lane route
    (`lane_layout`; programs with a step, vocabularies within u16
    tokens); else "steps" (csrc/shard.cu: launches a step per shard,
    records copied to the lead device, a combine there). Raises
    ValueError when the shards lie on more than one device type."""
    grid = [torch.device(d) for row in devices for d in row]
    kinds = {d.type for d in grid}
    if kinds == {"cpu"}:
        return "plain"
    if kinds != {"cuda"}:
        raise ValueError(f"no sharded placement for devices {sorted(kinds)}")
    s = len(devices[0])
    if (len(set(grid)) != 1 or s > MAX_CLUSTER or len(grid) > MAX_FOLD_COPIES
            or n % s or dims["m"] < 1
            or max(dims["sv"], dims["dv"]) > 65536):
        return "steps"
    fits = lane_layout(n // s, dims, r, s)["total"] <= BLOCK_SMEM
    return "cluster" if fits else "steps"


def _step_outputs(b: int, n: int, r: int, m: int, dev) -> dict:
    """K9's outputs of b programs on n rows, by PlaceArgs field name."""
    i32, f32 = torch.int32, torch.float32
    return dict(sel_idx=torch.empty((b, m), dtype=i32, device=dev),
                sel_score=torch.empty((b, m), dtype=f32, device=dev),
                nodes_feasible=torch.empty(b, dtype=i32, device=dev),
                nodes_fit=torch.empty((b, m), dtype=i32, device=dev),
                final0=torch.empty((b, n), dtype=f32, device=dev),
                new_used=torch.empty((b, n, r), dtype=f32, device=dev))


def cluster_args(sc: ShardedCluster, dims: dict, bp: int, ptrs_of,
                 outputs: dict) -> np.ndarray:
    """The argument blocks of K9's cluster route, block (l, j) at l·S + j
    for program l (of batch row l // bp) and node shard j: the program's
    fields (`ptrs_of(field)`, one pointer a program) and its rows of
    `outputs` ([B, ...] tensors by field name), the dims of `dims` with n
    the global rows, and the cluster fields of its batch row's shard j,
    each moved back j·(N / S) rows, so that global row g of the shard
    lies g rows past the pointer (csrc/lanes.cu)."""
    bm, s, n = len(sc.devices), len(sc.row0), sc.n
    ns, b = n // s, bm * bp
    base = _PlaceArgs()
    _set_cluster(base, sc.shards[0][0])
    base.n = n
    for name, val in dims.items():
        setattr(base, name, val)
    # a program's block first, then S copies of it (the shards' differ in
    # their cluster pointers alone)
    args = np.repeat(np.frombuffer(bytearray(base), dtype=_ARGS_DTYPE), b)
    for f in TGParams._fields:
        args[f] = ptrs_of(f)
    for name, t in outputs.items():
        args[name] = _rows_ptrs(t, np.arange(b))
    args = np.repeat(args, s)
    for name in ClusterArrays._fields:
        col = np.empty((bm, s), dtype=np.int64)
        for i, row in enumerate(sc.shards):
            for j, sh in enumerate(row):
                t = getattr(sh, name)
                col[i, j] = (t.data_ptr()
                             - j * ns * t.stride(0) * t.element_size())
        args[name] = np.repeat(col, bp, axis=0).reshape(-1)
    return args


def _place_cluster(sc: ShardedCluster, batch, bp: int, max_allocs: int,
                   fold: bool, dims: dict):
    """K9's cluster route (every shard on one card): the B = rows · bp
    programs (of `dims`, `_step_dims`) as B lanes of csrc/lanes.cu's
    `lane_cluster`, S blocks each, block j node shard j with its rows in
    shared memory — one launch — each program's carry written once into
    new_used [B, N, R]; then, with `fold`, `lane_shard_fold` over every
    node shard (one launch). The argument blocks (lane l, shard j at l·S
    + j) and, for programs not on the card (numpy, or tensors elsewhere),
    their fields packed as `pack_params` packs them, go to the card in
    one staged copy. A block's cluster pointers are its shard's, moved
    back by its first row (csrc/lanes.cu), its program fields the
    program's own: no rebase. Raises RuntimeError when the library
    refuses or a launch fails."""
    shards = [sh for row in sc.shards for sh in row]
    for sh in shards:
        _check_cluster(sh)
    out = sc.devices[0][0]
    bm, s, n, m = len(sc.devices), len(sc.row0), sc.n, max_allocs
    ns = n // s
    if sc.row0 != tuple(j * ns for j in range(s)):
        raise ValueError("the node shards must be equal and in row order")
    b = bm * bp
    shard0 = sc.shards[0][0]
    r = shard0.capacity.shape[1]
    _SHARD.host_calls = 0
    if all(isinstance(t, torch.Tensor) and t.device == out for t in batch):
        _b, _shapes, ptrs_of = _stacked_source(shard0, batch)
        packed, parts = None, []
    else:
        packed = pack_params(TGParams(*(
            t.cpu()  # nomadlint: ok NLD01 programs on another device than the card are packed on the host first; the server's are on the card already and skip this
            if isinstance(t, torch.Tensor) else t for t in batch)))
        parts = list(packed[:3])
    res = _step_outputs(b, n, r, m, out)
    buf, addr, upload = _staged([np.empty(b * s, _ARGS_DTYPE)] + parts, out)
    if packed is not None:
        _b, _shapes, ptrs_of = packed_ptrs(dict(zip("ifu", addr[1:])),
                                           packed[3])

    args = cluster_args(sc, dims, bp, ptrs_of, res)
    _LANES.check_layout(args, ns, dims, r, s)
    upload([args] + parts)
    _SHARD.host_calls += 1
    run = _LaneRun(lanes=b, per_lane=1, clusters=s, rows=ns, n=n, r=r,
                   fold=0, shards=1, used0=shard0.used.data_ptr(),
                   dyn0=shard0.dyn_free.data_ptr(),
                   carry_used=res["new_used"].data_ptr(),
                   out_used=res["new_used"].data_ptr())

    def count(k):
        _SHARD.step_kernels += k
        _SHARD.host_calls += 1

    _LANES.launch(args, addr[0], run, out, count)
    folded = None
    if fold:
        folded = [torch.empty_like(sh.used) for sh in sc.shards[0]]
        f = _LaneShardFold(shards=s, batch_rows=bm, per_row=bp,
                           count=ns * r,
                           new_used=res["new_used"].data_ptr())
        for i, row in enumerate(sc.shards):
            for j, sh in enumerate(row):
                f.used[i * s + j] = sh.used.data_ptr()
        for j, t in enumerate(folded):
            f.out[j] = t.data_ptr()
        _SHARD.host_calls += 1
        _LANES.shard_fold(f, out)
        _SHARD.step_kernels += 1
    # the staged buffer may be freed now: the caching allocator hands its
    # memory only to work queued after these launches on the same stream
    del buf
    result = PlacementResult(
        sel_idx=res["sel_idx"], sel_score=res["sel_score"],
        new_used=res["new_used"], nodes_feasible=res["nodes_feasible"],
        nodes_fit=res["nodes_fit"], final_scores0=res["final0"])
    return result, folded


def sharded_place_cuda(sc: ShardedCluster, batch, max_allocs: int,
                       fold: bool = False, route: Optional[str] = None):
    """K9 on CUDA shards; returns what `sharded_place_plain` returns.
    `route` None: `step_route`'s by the devices and the layout; "cluster"
    or "steps" forces one (the card tests and chip_smoke.py hold the two
    against each other, bitwise). Every launch and copy is queued on the
    devices' current streams (cross-device copies wait on both); nothing
    syncs with the host. Raises when a build or launch fails; never falls
    back."""
    _check_grid(sc, "cuda")
    bp = _per_row(sc, batch)
    dims = _step_dims(batch, max_allocs, sc.n)
    if route is None:
        route = step_route(sc.devices, sc.n, dims,
                           sc.shards[0][0].capacity.shape[1])
    if route == "cluster":
        out = _place_cluster(sc, batch, bp, max_allocs, fold, dims)
    elif route == "steps":
        out = _place_steps(sc, _as_params(batch), bp, sc.n // len(sc.row0),
                           max_allocs, fold)
    else:
        raise ValueError(f"no K9 route {route!r} on CUDA shards")
    _SHARD.launches += 1
    _SHARD.last_step_route = route
    return out


def _place_steps(sc: ShardedCluster, batch: TGParams, bp: int, ns: int,
                 max_allocs: int, fold: bool):
    """K9's steps route (`csrc/shard.cu`), a cell a shard on any CUDA
    devices: the static pass of every shard, then per step each shard's
    step launch, the records to the lead device, the combine there and
    the winner back; then the fold a shard. 3S + 1 host calls a step."""
    bm, nm = len(sc.devices), len(sc.row0)
    m = max_allocs
    _SHARD.lib()
    cells, leads = [], []
    for i in range(bm):
        on_dev = {}
        row = []
        for j in range(nm):
            dev = sc.devices[i][j]
            if dev not in on_dev:
                on_dev[dev] = _row_programs(batch, i, bp, dev)
            row.append(_Cell(sc.shards[i][j],
                             rebase(on_dev[dev], sc.row0[j], ns, sc.n),
                             sc.row0[j], m, route=STEP))
        lead = row[0]
        i32 = torch.int32
        leads.append(dict(
            rec=torch.empty((nm, bp, lead.rec_words), dtype=i32,
                            device=lead.dev),
            win=torch.zeros((bp, lead.win_words), dtype=i32, device=lead.dev),
            sel_idx=torch.empty((bp, m), dtype=i32, device=lead.dev),
            sel_score=torch.empty((bp, m), dtype=torch.float32,
                                  device=lead.dev),
            nodes_fit=torch.empty((bp, m), dtype=i32, device=lead.dev),
            nodes_feasible=torch.zeros(bp, dtype=i32, device=lead.dev)))
        cells.append(row)

    # (a) the static pass of every shard
    _SHARD.host_calls = 0
    for row in cells:
        for c in row:
            c.static(carry=True)
    for step in range(m):
        for row, lead in zip(cells, leads):
            # (b) each shard's step, with the previous winner applied first
            for c in row:
                c.step(step, apply=step > 0)
            # (c) the records to the lead device, the combine, the winner
            # back to every shard
            for j, c in enumerate(row):
                _SHARD.copy(lead["rec"][j], c.rec)
            comb = _ShardCombine(
                step=step, shards=nm, progs=bp, m=m,
                rec_words=row[0].rec_words, win_words=row[0].win_words,
                **{k: lead[k].data_ptr() for k in (
                    "rec", "win", "sel_idx", "sel_score", "nodes_fit",
                    "nodes_feasible")})
            _SHARD.call("nomad_shard_combine", row[0].dev,
                        row[0].dev_args.data_ptr(), ctypes.byref(comb),
                        route=STEP)
            for c in row:
                _SHARD.copy(c.win, lead["win"])
    # (d) the last step's winner
    if m > 0:
        for row in cells:
            for c in row:
                c.step(m, apply=True)

    out = sc.devices[0][0]
    result = PlacementResult(
        sel_idx=torch.cat([_to(ld["sel_idx"], out) for ld in leads]),
        sel_score=torch.cat([_to(ld["sel_score"], out) for ld in leads]),
        new_used=torch.cat([torch.cat([_to(c.used, out) for c in row], dim=1)
                            for row in cells]),
        nodes_feasible=torch.cat([_to(ld["nodes_feasible"], out)
                                  for ld in leads]),
        nodes_fit=torch.cat([_to(ld["nodes_fit"], out) for ld in leads]),
        final_scores0=torch.cat([torch.cat([_to(c.prog["final0"], out)
                                            for c in row], dim=1)
                                 for row in cells]))
    folded = None
    if fold:
        folded = []
        for j in range(nm):
            acc = torch.zeros(sc.shards[0][j].used.shape,
                              dtype=torch.float32, device=sc.devices[0][j])
            new = None
            for i in range(bm):
                c, used = cells[i][j], sc.shards[i][j].used
                acc = _to(acc, c.dev)
                new = (torch.empty_like(used) if i == bm - 1 else None)
                _SHARD.call("nomad_shard_fold", c.dev, c.used.data_ptr(),
                            used.data_ptr(), acc.data_ptr(),
                            None if new is None else new.data_ptr(), bp,
                            used.numel(), route=STEP)
            folded.append(new)
    return result, folded


def sharded_place(sc: ShardedCluster, batch, max_allocs: int,
                  fold: bool = False):
    """Sharded placement of a stacked batch (numpy or tensors, [B, ...]
    fields): the plain version on CPU shards, the K9 kernel on CUDA
    shards. Returns (PlacementResult with a leading B on the grid's first
    device, the folded used per node shard when `fold`, else None)."""
    kinds = {d.type for row in sc.devices for d in row}
    if kinds == {"cpu"}:
        _SHARD.last_step_route = "plain"
        return sharded_place_plain(sc, batch, max_allocs, fold)
    if kinds == {"cuda"}:
        return sharded_place_cuda(sc, batch, max_allocs, fold)
    raise ValueError(f"no sharded placement for devices {sorted(kinds)}")


# ---- the sharded routes of the view's readers (B10, B11, B12) ------------------


def chain_route(devices) -> str:
    """The route of a sharded chain (B10) or single program (B11) over node
    shards on `devices` (batch row 0's): "plain" on CPU shards; "cluster"
    when every shard is on one CUDA device and there are at most
    MAX_CLUSTER of them (two launches a dispatch); else "steps" (launches
    a step per shard, copies to the lead device and a combine). Raises
    ValueError when the shards lie on more than one device type."""
    devices = [torch.device(d) for d in devices]
    kinds = {d.type for d in devices}
    if kinds == {"cpu"}:
        return "plain"
    if kinds == {"cuda"}:
        one_card = len(set(devices)) == 1
        return ("cluster" if one_card and len(devices) <= MAX_CLUSTER
                else "steps")
    raise ValueError(f"no sharded placement for devices {sorted(kinds)}")


def _outputs(dims: dict, n: int, r: int, n_progs: int, m: int, out,
             explain: bool):
    """A chain's outputs on the lead device (a leading program axis) and
    the combine's pointers to them."""
    i32, f32 = torch.int32, torch.float32
    res = dict(sel_idx=torch.empty((n_progs, m), dtype=i32, device=out),
               sel_score=torch.empty((n_progs, m), dtype=f32, device=out),
               nodes_fit=torch.empty((n_progs, m), dtype=i32, device=out),
               nodes_feasible=torch.zeros(n_progs, dtype=i32, device=out))
    if explain:
        shapes = _scratch_shapes(dims, n, r, True)["prog"]
        for name in _EXPLAIN_BUFS:
            shape, dt = shapes[name]
            shape = shape if isinstance(shape, tuple) else (shape,)
            res[name] = torch.empty((n_progs,) + shape, dtype=dt,
                                    device=out)
    ptrs = {k: res[k].data_ptr() if k in res else None
            for k in ("sel_idx", "sel_score", "nodes_fit",
                      "nodes_feasible") + _EXPLAIN_BUFS}
    return res, ptrs


def _chain_result(res: dict, c: int, new_used, final0, carries,
                  explain: bool):
    ex = _explain_out(res, c) if explain else None
    result = PlacementResult(
        sel_idx=res["sel_idx"], sel_score=res["sel_score"],
        new_used=new_used, nodes_feasible=res["nodes_feasible"],
        nodes_fit=res["nodes_fit"], final_scores0=final0, explain=ex)
    return result, carries


def _chain_steps(sc: ShardedCluster, batch, max_allocs: int,
                 explain: bool = False, snapshots: bool = True,
                 route: str = "chain"):
    """The steps route of B10/B11, a cell a shard on any CUDA devices: per
    program, each shard's step launches, the records to the lead device,
    the combine, the winner back, M times, then the last apply with the
    shards' dyn_free carry update; S + P·(M·(3S + 1) + S) launches and
    copies."""
    _check_grid(sc, "cuda")
    if max_allocs < 1:
        raise ValueError("the sharded chain needs max_allocs >= 1")
    batch = _as_params(batch)
    shards, devs = sc.shards[0], sc.devices[0]
    ns, m, out = sc.n // len(sc.row0), max_allocs, devs[0]
    n_progs = batch.n_place.shape[0]
    _SHARD.lib()
    _SHARD.host_calls = 0
    on_dev, cells = {}, []
    for j, (sh, d) in enumerate(zip(shards, devs)):
        if d not in on_dev:
            on_dev[d] = _on(batch, d)
        cells.append(_Cell(sh, rebase(on_dev[d], sc.row0[j], ns, sc.n),
                           sc.row0[j], m, explain, chain=True,
                           n_global=sc.n, route=route))
    lead = cells[0]
    res, ptrs = _outputs(lead.dims, sc.n, shards[0].capacity.shape[1],
                         n_progs, m, out, explain)
    rec = torch.empty((len(cells), 1, lead.rec_words), dtype=torch.int32,
                      device=out)
    win = torch.zeros((1, lead.win_words), dtype=torch.int32, device=out)
    for c in cells:
        c.static(carry=False)
    snaps = []
    for k in range(n_progs):
        for step in range(m):
            for c in cells:
                c.step(step, apply=step > 0, k=k)
            for j, c in enumerate(cells):
                _SHARD.copy(rec[j], c.rec)
            comb = _ShardCombine(
                step=step, shards=len(cells), progs=1, m=m,
                rec_words=lead.rec_words, win_words=lead.win_words,
                prog0=k, cstride=max(lead.dims["c"], 1),
                rec=rec.data_ptr(), win=win.data_ptr(), **ptrs)
            _SHARD.call("nomad_shard_combine", out,
                        lead.dev_args.data_ptr() + k * _ARG_SIZE,
                        ctypes.byref(comb), route=route)
            for c in cells:
                _SHARD.copy(c.win, win)
        for c in cells:
            c.step(m, apply=True, k=k)
        if snapshots:
            snaps.append(torch.cat([_to(c.used[0], out) for c in cells]))
    _SHARD.last_route = "steps"
    return _chain_result(
        res, lead.dims["c"], torch.stack(snaps) if snapshots else None,
        torch.cat([_to(c.prog["final0"], out) for c in cells], dim=1),
        [(c.used[0], c.dyn) for c in cells], explain)


def _shards_source(cluster: ClusterArrays, batch: TGParams, s: int,
                   n: int):
    """(b, shapes, ptrs_of, the rebased fields) of a stacked `batch` as
    each of `s` node shards of one card sees it, shard-major (shard j's
    program k at j·b + k): the row fields rebased for every shard at once
    (`rebase`'s arithmetic), a node-width extra_mask split by shard, the
    other fields shared. `cluster` is a shard (for the checks)."""
    b, shapes, _ptrs = _stacked_source(cluster, batch)
    ns = n // s
    row0 = torch.arange(s, dtype=torch.int32,
                        device=batch.n_place.device) * ns
    own = {}
    for name in ROW_FIELDS:
        t = getattr(batch, name)
        local = t.unsqueeze(0) - row0.view((s,) + (1,) * t.dim())
        own[name] = torch.where((local >= 0) & (local < ns), local, -1)
    if shapes["extra_mask"] == (n,) and n != 1:
        own["extra_mask"] = batch.extra_mask.view(b, s, ns).transpose(
            0, 1).contiguous()
        shapes["extra_mask"] = (ns,)
    every = np.arange(s * b)

    def ptrs_of(name):
        if name in own:
            t = own[name]
            return _rows_ptrs(t.view((s * b,) + tuple(t.shape[2:])), every)
        return np.tile(_rows_ptrs(getattr(batch, name), np.arange(b)), s)

    return b, shapes, ptrs_of, own


def _chain_cluster(sc: ShardedCluster, batch, max_allocs: int,
                   explain: bool = False, snapshots: bool = True,
                   route: str = "chain"):
    """The cluster route of B10/B11, every shard of batch row 0 on one
    card: every shard's program fields and argument blocks built at once
    (one lane a shard), the static pass of every shard in one launch, then
    `shard_chain_cluster`, one block a shard as one thread-block cluster,
    every step of every program inside the launch. Raises RuntimeError
    when the library refuses either launch (more than MAX_CLUSTER shards,
    arguments that disagree, no cluster that fits) or a launch fails."""
    from ..convert import to_device_async
    from ..lib.transfer import default_ledger

    _check_grid(sc, "cuda")
    if max_allocs < 1:
        raise ValueError("the sharded chain needs max_allocs >= 1")
    shards, out = sc.shards[0], sc.devices[0][0]
    s, n, m = len(shards), sc.n, max_allocs
    ns = n // s
    if sc.row0 != tuple(j * ns for j in range(s)):
        raise ValueError("the node shards must be equal and in row order")
    for sh in shards:
        _check_cluster(sh)
    batch = _on(_as_params(batch), out)
    batch = TGParams(*(t.contiguous() for t in batch))
    _SHARD.lib()
    _SHARD.host_calls = 0
    # (the rebased fields are freed on return: the launches below read
    # them first on this stream, which orders any reuse after them)
    bp, shapes, ptrs_of, _own = _shards_source(shards[0], batch, s, n)
    dims, args, _first_upload, prog, _lane, used = _lane_args(
        shards[0], shapes, ptrs_of, s, bp, m, explain, n_global=n)
    # _lane_args points every block at shard 0's rows: each shard's blocks
    # read their own, and the records go up again
    for j, sh in enumerate(shards[1:], 1):
        for name, t in sh._asdict().items():
            args[name][j * bp:(j + 1) * bp] = t.data_ptr()
    # the patched table goes up again, at the site _lane_args books it
    with default_ledger().timed("select_batch.pack_buffers", args.nbytes):
        dev_args = to_device_async(args.view(np.uint8), out)
    torch.cat([sh.used for sh in shards], out=used.view(n, -1))
    dyn = torch.cat([sh.dyn_free for sh in shards])
    r = shards[0].capacity.shape[1]
    res, ptrs = _outputs(dims, n, r, bp, m, out, explain)
    rec_words, win_words = _words(dims, r, explain)
    q = _ShardChain(shards=s, progs=bp, m=m, n=n)
    for j in range(min(s, MAX_CLUSTER)):
        q.args[j] = dev_args.data_ptr() + j * bp * _ARG_SIZE
        q.row0[j] = sc.row0[j]
        q.dyn_c[j] = dyn[j * ns:].data_ptr()
    snap = None
    if snapshots:
        snap = torch.empty((bp, n, r), dtype=torch.float32, device=out)
        q.snap = snap.data_ptr()
    q.out = _ShardCombine(shards=s, progs=1, m=m, rec_words=rec_words,
                          win_words=win_words,
                          cstride=max(dims["c"], 1), **ptrs)
    a0 = args_pointer(args)
    _SHARD.call("nomad_shard_static_shards", out, a0, ctypes.byref(q),
                route=route)
    _SHARD.call("nomad_shard_chain", out, a0, ctypes.byref(q), route=route)
    _SHARD.last_route = "cluster"
    final0 = prog["final0"].view(s, bp, ns).transpose(0, 1).reshape(bp, n)
    return _chain_result(res, dims["c"], snap, final0,
                         [(used[j], dyn[j * ns:(j + 1) * ns])
                          for j in range(s)], explain)


def sharded_chain_cuda(sc: ShardedCluster, batch, max_allocs: int,
                       explain: bool = False, snapshots: bool = True,
                       route: str = "chain"):
    """B10 (and B11 at one program, `route` "single") on CUDA shards
    (`csrc/shard.cu`): what `sharded_chain_plain` returns; new_used only
    with `snapshots`. The cluster route when `chain_route` gives it (every
    shard of batch row 0 on one card, S ≤ MAX_CLUSTER), else the steps
    route; the launches count to `route`. Every launch and copy is queued
    on the devices' current streams; nothing syncs with the host. Raises
    when a build or launch fails."""
    if chain_route(sc.devices[0]) == "cluster":
        return _chain_cluster(sc, batch, max_allocs, explain, snapshots,
                              route)
    return _chain_steps(sc, batch, max_allocs, explain, snapshots, route)


def _dispatch(sc: ShardedCluster, batch, max_allocs: int, explain: bool,
              snapshots: bool, route: str) -> PlacementResult:
    if chain_route(sc.devices[0]) == "plain":
        _SHARD.last_route = "plain"
        return sharded_chain_plain(sc, batch, max_allocs, explain)[0]
    return sharded_chain_cuda(sc, batch, max_allocs, explain, snapshots,
                              route)[0]


def sharded_chain(sc: ShardedCluster, batch, max_allocs: int,
                  explain: bool = False) -> PlacementResult:
    """B10: `place_task_group_chain` on a sharded view — the programs of
    `batch` in order, new_used the carry after each program, every output
    on the grid's first device."""
    return _dispatch(sc, batch, max_allocs, explain, True, "chain")


def sharded_packed_chain(sc: ShardedCluster, i32buf, f32buf, u8buf, spec,
                         max_allocs: int, explain: bool = False):
    """B10: `place_packed_chain` on a sharded view; returns (sel_idx,
    sel_score, nodes_feasible, nodes_fit[, explain leaves]) on the grid's
    first device, as the unsharded route does."""
    batch = _unpack_params(i32buf, f32buf, u8buf, spec)
    return _flat_outputs(_dispatch(sc, batch, max_allocs, explain, False,
                                   "chain"), explain)


def _first(r: PlacementResult, explain: bool) -> PlacementResult:
    """Program 0 of a chain's result, shaped as one program's."""
    ex = (PlacementExplain(*(leaf[0] for leaf in r.explain))
          if explain else None)
    return PlacementResult(*(f[0] for f in r[:6]), explain=ex)


def sharded_task_group_plain(sc: ShardedCluster, p: TGParams,
                             max_allocs: int,
                             explain: bool = False) -> PlacementResult:
    """Plain B11: the plain chain at one program (any devices)."""
    batch = TGParams(*(t.unsqueeze(0) for t in p))
    return _first(sharded_chain_plain(sc, batch, max_allocs, explain)[0],
                  explain)


def sharded_task_group(sc: ShardedCluster, p: TGParams, max_allocs: int,
                       explain: bool = False) -> PlacementResult:
    """B11: `place_task_group` on a sharded view (the chain at one
    program), shaped as the unsharded route returns it."""
    batch = TGParams(*(t.unsqueeze(0) for t in p))
    return _first(_dispatch(sc, batch, max_allocs, explain, True, "single"),
                  explain)


def system_route(devices) -> str:
    """B12's route over node shards on `devices` (batch row 0's), from the
    devices alone: "plain" on CPU shards; "cards" on CUDA shards, one
    `system_rows` launch a card over every shard it holds
    (csrc/system.cu). Raises ValueError when the shards lie on more than
    one device type."""
    kinds = {torch.device(d).type for d in devices}
    if kinds == {"cpu"}:
        return "plain"
    if kinds == {"cuda"}:
        return "cards"
    raise ValueError(f"no sharded placement for devices {sorted(kinds)}")


def card_groups(devices) -> dict:
    """{device: the indices of the node shards on it, ascending}, the
    devices in order of their first shard: the cards route's launches."""
    groups: dict = {}
    for j, d in enumerate(devices):
        groups.setdefault(torch.device(d), []).append(j)
    return groups


def _system_over(sc: ShardedCluster, p, fn) -> torch.Tensor:
    shards, devs = sc.shards[0], sc.devices[0]
    ns = sc.n // len(sc.row0)
    p = _as_params(p)
    feas, fit = [], []
    for sh, d, r0 in zip(shards, devs, sc.row0):
        f, g = fn(sh, rebase(_on(p, d), r0, ns, sc.n))
        feas.append(_to(f, devs[0]))
        fit.append(_to(g, devs[0]))
    return torch.stack((torch.cat(feas), torch.cat(fit)))


def sharded_system_plain(sc: ShardedCluster, p) -> torch.Tensor:
    """Plain B12: K2's plain version on each shard's rows (any devices),
    the program's row fields rebased; bool [2, N] on the grid's first
    device."""
    return _system_over(sc, p, system_feasibility_plain)


def _system_cards(sc: ShardedCluster, p) -> torch.Tensor:
    """B12's cards route: batch row 0's node shards grouped by the card
    that holds them, one `system_masks_on` launch a card (its argument
    blocks and, for a program not on that card, the packed program in one
    staged copy), then every other card's shard rows copied into the first
    shard's card's [2, N] buffer. Host calls: a staged copy and a launch a
    card, a copy a shard off the first card."""
    shards = sc.shards[0]
    rows = sc.n // len(sc.row0)
    for j, sh in enumerate(shards):
        if sh.capacity.shape[0] != rows or sc.row0[j] != j * rows:
            raise ValueError("the node shards must be equal and in row order")
    groups = card_groups([sh.used.device for sh in shards])
    lead = shards[0].used.device
    _SHARD.host_calls = 0
    out, others = None, []
    for dev, js in groups.items():
        buf = system_masks_on([shards[j] for j in js],
                              [sc.row0[j] for j in js], sc.n, p)
        _SHARD.routes["system"] += 1
        _SHARD.host_calls += 2
        if dev == lead:
            out = buf
        else:
            others.append((buf, js))
    for buf, js in others:
        for j in js:
            r0 = sc.row0[j]
            out[:, r0:r0 + rows].copy_(buf[:, r0:r0 + rows])
            _SHARD.host_calls += 1
    return out


def _system_shards(sc: ShardedCluster, p) -> torch.Tensor:
    """B12's shards route, kept to hold and time the cards route against:
    per shard the program moved to the shard's device and its row fields
    rebased (`rebase`), K2's old pass on the shard's rows
    (`system_pass_cuda`), the two masks copied to the first device; then
    joined. Counts a launch a shard to `route_launch_counts()["system"]`
    and to `host_calls()` (its torch operations are not counted there)."""
    _SHARD.host_calls = 0

    def k2(shard: ClusterArrays, q: TGParams):
        out = system_pass_cuda(shard, q)
        _SHARD.routes["system"] += 1
        _SHARD.host_calls += 1
        return out

    return _system_over(sc, p, k2)


def sharded_system_feasibility(sc: ShardedCluster, p,
                               route: Optional[str] = None) -> torch.Tensor:
    """B12: `system_feasibility` on a sharded view — the two masks over
    batch row 0's node shards in global row order, bool [2, N] on the
    first shard's device. `p` as tensors or as the numpy `TGParams` of
    `compile_tg`. The route follows the devices alone (`system_route`):
    the plain version on CPU shards, the cards route on CUDA shards (one
    launch a card, no field rebased). `route="shards"` forces the old
    route (K2's old pass a shard, `_system_shards`), kept so that the card
    tests and chip_smoke.py hold the two bitwise and time them in turns.
    A refused build or launch raises; neither route gives way to the
    other."""
    layout = system_route(sc.devices[0])
    if layout == "plain":
        if route not in (None, "plain"):
            raise ValueError(f"no B12 route {route!r} on CPU shards")
        return sharded_system_plain(sc, p)
    if route in (None, "cards"):
        return _system_cards(sc, p)
    if route == "shards":
        return _system_shards(sc, p)
    raise ValueError(f"no B12 route {route!r} on CUDA shards")
