"""Node-sharded batched placement (K9): the reference's `_batch_place`
and `_step` under a (batch, nodes) mesh (`nomad_tpu/parallel/mesh.py:287`,
`:303`), without GSPMD.

A `ShardedCluster` holds the cluster's rows split into contiguous node
shards, one per column of a grid of devices, replicated over the grid's
rows (one copy per distinct device). A batch of B programs splits over the
grid's rows: Bp = B / rows programs each. Every program runs K1's scan
with its node axis split: per step, each shard evaluates its rows and
reports its best (score, global row) with what the combine needs; the
batch row's lead device (node shard 0) combines the reports — the max
score, the lowest global row among equal scores, the preferred-row
override — and every shard applies the winner: the owner adds the ask to
its row, every shard adds the winner's spread and distinct_property tokens
to its copy of the replicated counts. `fold` adds the reference's
`_step` fold-in, `used + Σ_b (new_used_b − used)` per shard in ascending
b.

Two implementations compute the same function: `sharded_place_plain`
(the same loop in PyTorch, on any devices; the CPU tests hold it against
the reference's mesh) and `sharded_place_cuda` (`csrc/shard.cu`, on CUDA
devices). `sharded_place` picks by the shards' device type.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .placement import (
    ClusterArrays,
    PlacementResult,
    TGParams,
    _check_cluster,
    _lane_args,
    _PlaceArgs,
    _program,
    args_pointer,
    _stacked_source,
    _static_plain,
    _step_plain,
    _take_plain,
)

_VOID = ctypes.c_void_p
_INT = ctypes.c_int

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
        return ClusterArrays(*(
            torch.cat([t.to(dev) for t in ts]) for ts in zip(*self.shards[0])))


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


def _split(sc: ShardedCluster, batch) -> Tuple[TGParams, int, int]:
    """The batch as CPU/torch tensors, and (programs per batch row, rows
    per shard). Raises ValueError when the batch rows do not divide B."""
    if any(isinstance(t, np.ndarray) for t in batch):
        from ..convert import params_from_numpy

        batch = params_from_numpy(batch, "cpu")
    b, bm = batch.n_place.shape[0], len(sc.devices)
    if b % bm:
        raise ValueError(f"{b} programs do not split over {bm} batch rows")
    return batch, b // bm, sc.n // len(sc.row0)


def _row_programs(batch: TGParams, i: int, bp: int, dev) -> TGParams:
    return TGParams(*(t[i * bp:(i + 1) * bp].to(dev) for t in batch))


def _check_grid(sc: ShardedCluster, kind: str) -> None:
    for row in sc.devices:
        for d in row:
            if d.type != kind:
                raise ValueError(f"shard on {d}, expected {kind} devices")


# ---- plain PyTorch version --------------------------------------------------


def _place_program_plain(shards, ps, row0, ns, max_allocs):
    """One program over the node shards `shards` (its rebased fields
    `ps`, one per shard): static pass, then per step the shards' reports,
    the combine and the apply. Returns (sel, score, nodes_feasible, fits,
    final0 per shard, new_used per shard)."""
    nm = len(shards)
    sts = [_static_plain(cl, p, False) for cl, p in zip(shards, ps)]
    p0 = ps[0]
    sels, scores, fits, final0 = [], [], [], None
    for i in range(max_allocs):
        # (b) each shard's step and its best row
        evs = [_step_plain(cl, p, st, i)
               for cl, p, st in zip(shards, ps, sts)]
        local = [int(torch.argmax(ev["masked"])) for ev in evs]
        if i == 0:
            final0 = [ev["masked"] for ev in evs]
        # (c) the combine: the max score, the first shard (lowest global
        # row) among equal ones; the preferred row from its owner
        vals = torch.stack([ev["masked"][k].cpu() for ev, k in
                            zip(evs, local)])
        jb = int(torch.argmax(vals))
        pref = int(p0.preferred_idx[i])
        pj = pref // ns if pref >= 0 else nm
        pref_ok = pj < nm and bool(evs[pj]["ok"][pref - row0[pj]])
        j = pj if pref_ok else jb
        loc = pref - row0[pj] if pref_ok else local[jb]
        found = bool(evs[j]["ok"][loc]) and i < int(p0.n_place)
        sels.append(row0[j] + loc if found else -1)
        scores.append(evs[j]["final"][loc].cpu() if found
                      else torch.zeros((), dtype=torch.float32))
        fits.append(sum(int((st["feas"] & ev["fits"]).sum())
                        for st, ev in zip(sts, evs)))
        # (d) the apply on every shard, the tokens from the owner
        stok, dtok = sts[j]["stok"][loc], sts[j]["dtok"][loc]
        for k, (p, st) in enumerate(zip(ps, sts)):
            dev = st["used"].device
            _take_plain(st, p, loc if k == j else -1, found, stok.to(dev),
                        dtok.to(dev))
    nfeas = sum(int(st["nodes_feasible"]) for st in sts)
    return (sels, scores, nfeas, fits, final0, [st["used"] for st in sts])


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
            sels, scores, nfeas, fits, final0, used = _place_program_plain(
                sc.shards[i], [_program(p, k) for p in ps], sc.row0, ns,
                max_allocs)
            rows.append(PlacementResult(
                sel_idx=torch.tensor(sels, dtype=torch.int32),
                sel_score=torch.stack(scores) if scores
                else torch.zeros(0, dtype=torch.float32),
                new_used=torch.cat([u.to(out) for u in used]),
                nodes_feasible=torch.tensor(nfeas, dtype=torch.int32),
                nodes_fit=torch.tensor(fits, dtype=torch.int32),
                final_scores0=(torch.cat([f.to(out) for f in final0])
                               if final0 is not None
                               else torch.zeros(0, dtype=torch.float32))))
            for j in range(nm):
                carries[i][j].append(used[j])
    result = PlacementResult(*(torch.stack([getattr(r, f).to(out)
                                            for r in rows])
                               for f in PlacementResult._fields[:6]))
    folded = None
    if fold:
        folded = []
        for j in range(nm):
            acc = torch.zeros_like(sc.shards[0][j].used)
            for i in range(bm):
                used = sc.shards[i][j].used
                acc = acc.to(used.device)
                for nu in carries[i][j]:
                    acc = acc + (nu - used)
            folded.append(used + acc)
    return result, folded


# ---- the CUDA kernel ----------------------------------------------------------


class _ShardStep(ctypes.Structure):
    """Mirror of `ShardStep` in csrc/shard.cu."""

    _fields_ = [("step", _INT), ("apply", _INT), ("row0", _INT),
                ("rec_words", _INT), ("win_words", _INT), ("rec", _VOID),
                ("win", _VOID), ("counts", _VOID)]


class _ShardCombine(ctypes.Structure):
    """Mirror of `ShardCombine` in csrc/shard.cu."""

    _fields_ = [("step", _INT), ("shards", _INT), ("progs", _INT),
                ("m", _INT), ("rec_words", _INT), ("win_words", _INT),
                ("rec", _VOID), ("win", _VOID), ("sel_idx", _VOID),
                ("sel_score", _VOID), ("nodes_fit", _VOID),
                ("nodes_feasible", _VOID)]


class _Launcher:
    """The shard library (csrc/shard.cu), built at first use, and its
    count of dispatches on the main path."""

    def __init__(self):
        self.launches = 0
        self._lib = None

    def lib(self):
        if self._lib is None:
            from ._build import load_library

            lib = load_library("shard")
            lib.nomad_shard_args_size.restype = ctypes.c_size_t
            lib.nomad_shard_args_size.argtypes = []
            lib.nomad_shard_error_string.restype = ctypes.c_char_p
            lib.nomad_shard_error_string.argtypes = [ctypes.c_int]
            args = ctypes.POINTER(_PlaceArgs)
            for fn, argtypes in (
                    ("nomad_shard_static", [args, _VOID, _INT, _VOID]),
                    ("nomad_shard_step", [args, _VOID, _INT,
                                          ctypes.POINTER(_ShardStep), _VOID]),
                    ("nomad_shard_combine", [_VOID,
                                             ctypes.POINTER(_ShardCombine),
                                             _VOID]),
                    ("nomad_shard_fold", [_VOID, _VOID, _VOID, _VOID, _INT,
                                          _INT, _VOID])):
                getattr(lib, fn).restype = ctypes.c_int
                getattr(lib, fn).argtypes = argtypes
            if lib.nomad_shard_args_size() != ctypes.sizeof(_PlaceArgs):
                raise RuntimeError(
                    "shard library's PlaceArgs layout differs from the "
                    "wrapper's (rebuild csrc/shard.cu)")
            self._lib = lib
        return self._lib

    def call(self, fn: str, dev, *args) -> None:
        """Run entry point `fn` with `dev` current, on its current stream
        (the last argument); raises on a refused launch."""
        lib = self.lib()
        with torch.cuda.device(dev):
            err = getattr(lib, fn)(
                *args, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"shard kernel {fn} failed: "
                               + lib.nomad_shard_error_string(err).decode())


_SHARD = _Launcher()


def launch_count() -> int:
    """K9 dispatches since the last reset."""
    return _SHARD.launches


def reset_launch_count() -> None:
    _SHARD.launches = 0


def build_kernel() -> None:
    """Build (or load the cached build of) the shard library now."""
    _SHARD.lib()


class _Cell:
    """One (batch row, node shard) of a dispatch: the shard's programs,
    scratch, carries, counts, step records and winners on its device."""

    def __init__(self, shard: ClusterArrays, progs: TGParams, row0: int,
                 max_allocs: int):
        _check_cluster(shard)
        self.dev = shard.used.device
        self.row0 = row0
        # held until the dispatch ends: the launches read these fields
        self.progs = TGParams(*(t.contiguous() for t in progs))
        progs = self.progs
        bp, shapes, ptrs_of = _stacked_source(shard, progs)
        (self.dims, self.args, self.dev_args, self.prog, self.lane,
         self.used) = _lane_args(shard, shapes, ptrs_of, bp, 1, max_allocs,
                                 False)
        d = self.dims
        self.rec_words = 7 + 2 * (d["s"] + d["p"])
        self.win_words = 2 + d["s"] + d["p"]
        i32 = torch.int32
        self.rec = torch.empty((bp, self.rec_words), dtype=i32,
                               device=self.dev)
        self.win = torch.zeros((bp, self.win_words), dtype=i32,
                               device=self.dev)
        self.counts = torch.empty(
            (bp, max(d["s"] * d["sv"] + d["p"] * d["dv"], 1)),
            dtype=torch.float32, device=self.dev)

    def step(self, step: int, apply: bool) -> None:
        t = _ShardStep(step=step, apply=int(apply), row0=self.row0,
                       rec_words=self.rec_words, win_words=self.win_words,
                       rec=self.rec.data_ptr(), win=self.win.data_ptr(),
                       counts=self.counts.data_ptr())
        _SHARD.call("nomad_shard_step", self.dev, args_pointer(self.args),
                    self.dev_args.data_ptr(), len(self.args),
                    ctypes.byref(t))


def sharded_place_cuda(sc: ShardedCluster, batch, max_allocs: int,
                       fold: bool = False):
    """K9 on CUDA shards (`csrc/shard.cu`); returns what
    `sharded_place_plain` returns. Every launch and copy is queued on the
    devices' current streams (cross-device copies wait on both); nothing
    syncs with the host. Raises when a build or launch fails."""
    _check_grid(sc, "cuda")
    batch, bp, ns = _split(sc, batch)
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
                             sc.row0[j], m))
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
    for row in cells:
        for c in row:
            _SHARD.call("nomad_shard_static", c.dev, args_pointer(c.args),
                        c.dev_args.data_ptr(), bp)
    for step in range(m):
        for row, lead in zip(cells, leads):
            # (b) each shard's step, with the previous winner applied first
            for c in row:
                c.step(step, apply=step > 0)
            # (c) the records to the lead device, the combine, the winner
            # back to every shard
            for j, c in enumerate(row):
                lead["rec"][j].copy_(c.rec)
            comb = _ShardCombine(
                step=step, shards=nm, progs=bp, m=m,
                rec_words=row[0].rec_words, win_words=row[0].win_words,
                **{k: lead[k].data_ptr() for k in (
                    "rec", "win", "sel_idx", "sel_score", "nodes_fit",
                    "nodes_feasible")})
            _SHARD.call("nomad_shard_combine", row[0].dev,
                        row[0].dev_args.data_ptr(), ctypes.byref(comb))
            for c in row:
                c.win.copy_(lead["win"])
    # (d) the last step's winner
    if m > 0:
        for row in cells:
            for c in row:
                c.step(m, apply=True)
    _SHARD.launches += 1

    out = sc.devices[0][0]
    result = PlacementResult(
        sel_idx=torch.cat([ld["sel_idx"].to(out) for ld in leads]),
        sel_score=torch.cat([ld["sel_score"].to(out) for ld in leads]),
        new_used=torch.cat([torch.cat([c.used.to(out) for c in row], dim=1)
                            for row in cells]),
        nodes_feasible=torch.cat([ld["nodes_feasible"].to(out)
                                  for ld in leads]),
        nodes_fit=torch.cat([ld["nodes_fit"].to(out) for ld in leads]),
        final_scores0=torch.cat([torch.cat([c.prog["final0"].to(out)
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
                acc = acc.to(c.dev)
                new = (torch.empty_like(used) if i == bm - 1 else None)
                _SHARD.call("nomad_shard_fold", c.dev, c.used.data_ptr(),
                            used.data_ptr(), acc.data_ptr(),
                            None if new is None else new.data_ptr(), bp,
                            used.numel())
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
        return sharded_place_plain(sc, batch, max_allocs, fold)
    if kinds == {"cuda"}:
        return sharded_place_cuda(sc, batch, max_allocs, fold)
    raise ValueError(f"no sharded placement for devices {sorted(kinds)}")

