"""Row scatter: `dst[idx[k]] = src[k]` for whole rows (K8).

The device program table's insert (`server/program_table.py`) writes the
static rows of programs never seen before into its three class tables;
the reference does it with the jitted `_get_insert_jit`
(`nomad_tpu/server/program_table.py:99`). Two implementations compute it:

- `row_scatter_plain`: `index_copy_`, on any device;
- the hand-written CUDA kernel (`csrc/rows.cu`), for CUDA tensors.

`row_scatter` takes the plain version for CPU tensors and the kernel for
CUDA tensors (or raises); there is no fallback between the two. The
kernel is generic over the row width in bytes, so the view's row-delta
writes can reuse it.
"""
from __future__ import annotations

import ctypes

import torch


def row_scatter_plain(dst: torch.Tensor, idx: torch.Tensor,
                      src: torch.Tensor) -> torch.Tensor:
    """In place: row idx[k] of `dst` becomes row k of `src`."""
    return dst.index_copy_(0, idx.long(), src)


class _Launcher:
    def __init__(self):
        self.launches = 0
        self._lib = None

    def lib(self):
        if self._lib is None:
            from ._build import load_library

            lib = load_library("rows")
            lib.nomad_row_scatter.restype = ctypes.c_int
            lib.nomad_row_scatter.argtypes = [
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_void_p]
            lib.nomad_rows_error_string.restype = ctypes.c_char_p
            lib.nomad_rows_error_string.argtypes = [ctypes.c_int]
            self._lib = lib
        return self._lib


_LAUNCHER = _Launcher()


def launch_count() -> int:
    """Row-scatter kernel launches since the last reset."""
    return _LAUNCHER.launches


def reset_launch_count() -> None:
    _LAUNCHER.launches = 0


def build_kernel() -> None:
    _LAUNCHER.lib()


def row_scatter_cuda(dst: torch.Tensor, idx: torch.Tensor,
                     src: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors: `dst` [T, ...] contiguous, `idx` i32[K],
    `src` [K, ...] of dst's type and row shape. Indices outside [0, T)
    are skipped. Raises when the launch fails; never falls back."""
    dev = dst.device
    if dev.type != "cuda":
        raise ValueError("row_scatter_cuda needs CUDA tensors")
    if idx.device != dev or src.device != dev:
        raise ValueError("dst, idx and src must share a device")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise TypeError("idx must be i32[K]")
    if src.dtype != dst.dtype or tuple(src.shape[1:]) != tuple(dst.shape[1:]) \
            or src.shape[0] != idx.shape[0]:
        raise ValueError("src must be [K, *dst.shape[1:]] of dst's type")
    if not (dst.is_contiguous() and idx.is_contiguous()
            and src.is_contiguous()):
        raise ValueError("row_scatter_cuda needs contiguous tensors")
    lib = _LAUNCHER.lib()
    width = dst[0].numel() * dst.element_size() if dst.shape[0] else 0
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.nomad_row_scatter(dst.data_ptr(), dst.shape[0], idx.data_ptr(),
                                src.data_ptr(), idx.shape[0], width, stream)
    if err != 0:
        raise RuntimeError("row scatter launch failed: "
                           + lib.nomad_rows_error_string(err).decode())
    _LAUNCHER.launches += 1
    return dst


def row_scatter(dst: torch.Tensor, idx: torch.Tensor,
                src: torch.Tensor) -> torch.Tensor:
    """In place: row idx[k] of `dst` becomes row k of `src`. Plain on CPU
    tensors, the kernel on CUDA tensors."""
    kind = dst.device.type
    if kind == "cpu":
        return row_scatter_plain(dst, idx, src)
    if kind == "cuda":
        return row_scatter_cuda(dst, idx, src)
    raise ValueError(f"no row scatter for device {kind!r}")
