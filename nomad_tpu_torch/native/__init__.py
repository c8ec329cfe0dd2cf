"""ctypes bindings for the C++ host core (`native/core.cpp`).

Builds `core.cpp` with g++ on first use into `build/libnomad_core-<hash>.so`
at the repository root; the hash covers the source and the flags, so an
edited source builds anew and a stale library is never loaded. A build
writes a file of its own and renames it into place, so processes building
at once never load a half-written library. There is no fallback: a missing
compiler or a failed build raises RuntimeError with g++'s output.

Consumers: `structs/network.py` (dynamic-port first-fit) and the compiled
scalar select (`compiled_select`), the host baseline the scheduler's
evals/s are compared with. Imports numpy and ctypes only: the CLI and
the agent start without torch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from typing import List, Optional, Sequence

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "core.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build")
GXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")
_ABI_VERSION = 4

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

#: (seconds the build took, whether the library was already built)
BUILD_INFO: dict = {}


def library_path() -> str:
    """The build's path; its hash covers the source and the flags."""
    with open(_SRC, "rb") as f:
        src = f.read()
    tag = hashlib.sha1(src + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libnomad_core-{tag}.so")


def _build(out: str) -> None:
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, _SRC],
                              capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"cannot run g++ to build {_SRC}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {_SRC}:\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, cached=False)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if os.path.exists(out):
            BUILD_INFO.update(seconds=0.0, cached=True)
        else:
            _build(out)
        lib = ctypes.CDLL(out)
        lib.nomad_first_fit_ports.restype = ctypes.c_int
        lib.nomad_count_free_ports.restype = ctypes.c_int
        lib.nomad_core_abi_version.restype = ctypes.c_int
        abi = lib.nomad_core_abi_version()
        if abi != _ABI_VERSION:
            raise RuntimeError(f"{out}: ABI version {abi}, want "
                               f"{_ABI_VERSION}")
        _lib = lib
        return _lib


def available() -> bool:
    """Builds (or loads) the library and returns True; raises otherwise."""
    _load()
    return True


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _f32_buffer(arr: np.ndarray, what: str) -> None:
    if not (arr.flags.c_contiguous and arr.dtype == np.float32):
        raise ValueError(f"{what} is written in place and must be a "
                         "contiguous float32 array")


# ---- first-fit dynamic ports ----

def first_fit_ports(used: np.ndarray, min_port: int, max_port: int,
                    reserved: Sequence[int], count: int) -> List[int]:
    """First `count` free ports in [min_port, max_port) excluding
    `reserved`. Returns [] when exhausted. `used` is bool[65536]."""
    if count <= 0:
        return []
    lib = _load()
    used = np.ascontiguousarray(used, dtype=np.bool_)
    res = np.asarray(list(reserved), dtype=np.int32)
    out = np.empty(count, dtype=np.int32)
    n = lib.nomad_first_fit_ports(
        _ptr(used, ctypes.c_uint8), min_port, max_port,
        _ptr(res, ctypes.c_int32), len(res), count,
        _ptr(out, ctypes.c_int32))
    if n < count:
        return []
    return [int(p) for p in out]


def _first_fit_py(used, min_port, max_port, reserved, count) -> List[int]:
    """The plain version of `first_fit_ports`, which tests hold it to."""
    mask = used[min_port:max_port].copy()
    for r in reserved:
        if min_port <= r < max_port:
            mask[r - min_port] = True
    free = np.flatnonzero(~mask)
    if len(free) < count:
        return []
    return [int(p) + min_port for p in free[:count]]


# ---- batch fit / score / scatter ----

def fits_batch(capacity: np.ndarray, used: np.ndarray, ask: np.ndarray,
               rows: np.ndarray) -> np.ndarray:
    """bool[n]: ask fits on capacity[rows]-used[rows] in every dimension."""
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    lib = _load()
    capacity = np.ascontiguousarray(capacity, dtype=np.float32)
    used = np.ascontiguousarray(used, dtype=np.float32)
    ask = np.ascontiguousarray(ask, dtype=np.float32)
    out = np.empty(len(rows), dtype=np.uint8)
    lib.nomad_fits_batch(
        _ptr(capacity, ctypes.c_float), _ptr(used, ctypes.c_float),
        capacity.shape[1], _ptr(ask, ctypes.c_float),
        _ptr(rows, ctypes.c_int32), len(rows), _ptr(out, ctypes.c_uint8))
    return out.astype(bool)


def scatter_add(used: np.ndarray, rows: np.ndarray, usage: np.ndarray,
                sign: float = 1.0) -> None:
    """used[rows[i]] += sign * usage[i], in place (`used` contiguous
    float32)."""
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    lib = _load()
    _f32_buffer(used, "used")
    usage = np.ascontiguousarray(usage, dtype=np.float32)
    lib.nomad_scatter_add(
        _ptr(used, ctypes.c_float), used.shape[1],
        _ptr(rows, ctypes.c_int32), _ptr(usage, ctypes.c_float),
        len(rows), ctypes.c_float(sign))


def score_binpack(capacity: np.ndarray, used: np.ndarray, ask: np.ndarray,
                  rows: np.ndarray) -> np.ndarray:
    """BestFit-v3 scores in [0, 18] for ask on each row (funcs.go:175
    ScoreFitBinPack, same clamping; capacity = resources − reserved)."""
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    lib = _load()
    capacity = np.ascontiguousarray(capacity, dtype=np.float32)
    used = np.ascontiguousarray(used, dtype=np.float32)
    ask = np.ascontiguousarray(ask, dtype=np.float32)
    out = np.empty(len(rows), dtype=np.float32)
    lib.nomad_score_binpack(
        _ptr(capacity, ctypes.c_float), _ptr(used, ctypes.c_float),
        capacity.shape[1], _ptr(ask, ctypes.c_float),
        _ptr(rows, ctypes.c_int32), len(rows), _ptr(out, ctypes.c_float))
    return out


def count_free_ports(used: np.ndarray, min_port: int, max_port: int) -> int:
    lib = _load()
    used = np.ascontiguousarray(used, dtype=np.bool_)
    return lib.nomad_count_free_ports(_ptr(used, ctypes.c_uint8),
                                      min_port, max_port)


# ---- compiled scalar select (the host baseline) ----

def select_eval(capacity: np.ndarray, used: np.ndarray, ask: np.ndarray,
                attrs: np.ndarray, key_idx: np.ndarray, lut: np.ndarray,
                aff_key_idx: np.ndarray, aff_lut: np.ndarray,
                aff_inv_sum: float,
                s_key: np.ndarray, s_weight: np.ndarray,
                s_has_targets: np.ndarray, s_active: np.ndarray,
                s_desired: np.ndarray, s_counts: np.ndarray,
                dp_key: np.ndarray, dp_allowed: np.ndarray,
                dp_counts: np.ndarray,
                distinct_hosts: bool, dh_counts: np.ndarray,
                jtc: np.ndarray,
                desired_count: float, node_ok: np.ndarray,
                extra_mask: np.ndarray, n_allocs: int,
                order: np.ndarray = None, limit: int = 0,
                max_skip: int = 3, skip_threshold: float = 0.0):
    """One evaluation through the compiled scalar select loop
    (native `nomad_select_eval`) — full-node scan per alloc with in-loop
    accounting. MUTATES used/dh_counts/jtc/s_counts. `dh_counts` is the
    distinct-hosts gate vector (job-level counts for job-scoped
    distinct_hosts, job+tg counts for tg-scoped — stack.py dh_counts).
    With `order` (a shuffled row permutation), runs the SAMPLED loop
    instead (`nomad_select_eval_sampled` — the reference's actual
    log2(n)-candidate + maxSkip shape, scheduler/stack.go:10-18,77-89);
    `limit` 0 means ceil(log2(n)) like the reference.
    Returns (sel i32[M], score f32[M])."""
    lib = _load()
    capacity = np.ascontiguousarray(capacity, dtype=np.float32)
    for name, buf in (("used", used), ("s_counts", s_counts),
                      ("dp_counts", dp_counts), ("dh_counts", dh_counts),
                      ("jtc", jtc)):
        _f32_buffer(buf, name)
    dp_key = np.ascontiguousarray(dp_key, dtype=np.int32)
    dp_allowed = np.ascontiguousarray(dp_allowed, dtype=np.float32)
    ask = np.ascontiguousarray(ask, dtype=np.float32)
    attrs = np.ascontiguousarray(attrs, dtype=np.int32)
    key_idx = np.ascontiguousarray(key_idx, dtype=np.int32)
    lut_u8 = np.ascontiguousarray(lut, dtype=np.uint8)
    aff_key_idx = np.ascontiguousarray(aff_key_idx, dtype=np.int32)
    aff_lut = np.ascontiguousarray(aff_lut, dtype=np.float32)
    s_key = np.ascontiguousarray(s_key, dtype=np.int32)
    s_weight = np.ascontiguousarray(s_weight, dtype=np.float32)
    s_has = np.ascontiguousarray(s_has_targets, dtype=np.uint8)
    s_act = np.ascontiguousarray(s_active, dtype=np.uint8)
    s_desired = np.ascontiguousarray(s_desired, dtype=np.float32)
    node_ok_u8 = np.ascontiguousarray(node_ok, dtype=np.uint8)
    extra_u8 = np.ascontiguousarray(extra_mask, dtype=np.uint8)
    n, r = capacity.shape
    v = lut_u8.shape[1] if lut_u8.size else (
        aff_lut.shape[1] if aff_lut.size else s_desired.shape[1])
    out_sel = np.empty(n_allocs, dtype=np.int32)
    out_score = np.empty(n_allocs, dtype=np.float32)
    common = (
        _ptr(capacity, ctypes.c_float), _ptr(used, ctypes.c_float), n, r,
        _ptr(ask, ctypes.c_float),
        _ptr(attrs, ctypes.c_int32), attrs.shape[1],
        _ptr(key_idx, ctypes.c_int32), _ptr(lut_u8, ctypes.c_uint8),
        lut_u8.shape[0], v,
        _ptr(aff_key_idx, ctypes.c_int32), _ptr(aff_lut, ctypes.c_float),
        aff_lut.shape[0], ctypes.c_float(aff_inv_sum),
        _ptr(s_key, ctypes.c_int32), _ptr(s_weight, ctypes.c_float),
        _ptr(s_has, ctypes.c_uint8), _ptr(s_act, ctypes.c_uint8),
        _ptr(s_desired, ctypes.c_float),
        _ptr(s_counts, ctypes.c_float), s_key.shape[0],
        _ptr(dp_key, ctypes.c_int32), _ptr(dp_allowed, ctypes.c_float),
        _ptr(dp_counts, ctypes.c_float), dp_key.shape[0],
        int(distinct_hosts), _ptr(dh_counts, ctypes.c_float),
        _ptr(jtc, ctypes.c_float), ctypes.c_float(desired_count),
        _ptr(node_ok_u8, ctypes.c_uint8), _ptr(extra_u8, ctypes.c_uint8),
        extra_u8.shape[0])
    outs = (_ptr(out_sel, ctypes.c_int32), _ptr(out_score, ctypes.c_float))
    if order is not None:
        order = np.ascontiguousarray(order, dtype=np.int32)
        if not limit:
            limit = max(int(np.ceil(np.log2(max(n, 2)))), 2)
        lib.nomad_select_eval_sampled(
            *common, _ptr(order, ctypes.c_int32), int(limit), int(max_skip),
            ctypes.c_float(skip_threshold), n_allocs, *outs)
    else:
        lib.nomad_select_eval(*common, n_allocs, *outs)
    return out_sel, out_score


def compiled_select(stack, job, tg, n_allocs: int, order=None,
                    limit: int = 0, max_skip: int = 3,
                    skip_threshold: float = 0.0):
    """Marshal one (job, task-group) placement of a `TorchStack` through
    the compiled scalar select loop, from the stack's host arrays and its
    program compiler; the card takes no part. Returns (sel i32[M],
    score f32[M])."""
    _load()
    cl = stack.cluster
    prog = stack._static_program(job, tg, None)
    used = cl.used.astype(np.float32, copy=True)
    jc = np.zeros(cl.n_cap, dtype=np.float32)
    jtc = np.zeros(cl.n_cap, dtype=np.float32)
    for row, tgname in cl.job_allocs.get(job.id, {}).values():
        jc[row] += 1.0
        if tgname == tg.name:
            jtc[row] += 1.0
    # tg-scoped distinct_hosts gates on job+tg collisions, job-scoped on
    # job collisions (feasible.go:494-500; stack.py dh_counts)
    dh_counts = jc if prog["dh_job"] else jtc.copy()
    sp_key, sp_w, sp_has, sp_desired, sp_active = prog["sp_static"]
    s_counts = np.zeros_like(sp_desired, dtype=np.float32)
    # distinct_property: reuse the stack's own program builder so existing
    # allocs seed the counts and literal-LTarget specs clamp n_allocs
    # exactly as the kernel path does (stack._dp_program)
    from ..scheduler.stack import PlanContext

    dpk, dpa, dpact, dpc0, n_allocs = stack._dp_program(
        job, tg, prog, PlanContext(), n_allocs)
    dp_key = np.ascontiguousarray(dpk[dpact], dtype=np.int32)
    dp_allowed = np.ascontiguousarray(dpa[dpact], dtype=np.float32)
    dp_counts = np.ascontiguousarray(dpc0[dpact], dtype=np.float32)
    extra = prog["extra"]
    if extra is None:
        extra = np.ones(1, dtype=bool)
    return select_eval(
        np.ascontiguousarray(cl.capacity, np.float32), used,
        prog["ask"], np.ascontiguousarray(cl.attrs, np.int32),
        prog["cc"].key_idx, prog["feas_lut"],
        prog["ca"].key_idx, prog["aff_lut"],
        prog["ca"].inv_sum_abs_weight,
        sp_key, sp_w, sp_has, sp_active, sp_desired, s_counts,
        dp_key, dp_allowed, dp_counts,
        prog["distinct"], dh_counts, jtc, float(max(tg.count, 1)),
        np.ascontiguousarray(cl.node_ok, np.uint8), extra, n_allocs,
        order=order, limit=limit, max_skip=max_skip,
        skip_threshold=skip_threshold)
