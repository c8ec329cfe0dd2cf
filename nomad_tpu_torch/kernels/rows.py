"""Row scatters: the program-table insert (K8) and the device view's
row-delta refresh (K7).

K8. The device program table's insert (`server/program_table.py`) writes
the static rows of programs never seen before into its three class
tables; the reference does it with the jitted `_get_insert_jit`
(`nomad_tpu/server/program_table.py:99`). `row_scatter`:
`dst[idx[k]] = src[k]` for whole rows.

K7. The view cache (`scheduler/stack.py` `TorchStack.device_arrays`)
ships only the rows the cluster's delta log names and writes them into
the cached device tensors; the reference does it with `_rows_update`,
`_hot_delta_impl`, `_ports_delta_impl` and `_ports_word_impl`
(`nomad_tpu/scheduler/stack.py:115-171`), run over 32-row chunks padded
by repeating the first row. Three parts, any count, distinct indices:

- `hot_rows_update`: used, node_ok and dyn_free rows of one delta, in one
  launch;
- `port_rows_update`: whole rows of the u32[N, W] port bitmap (K8's
  generic scatter, counted as K7);
- `port_words_update`: single words, `ports[rows[k], words[k]] = vals[k]`.

Each has a plain version (`index_copy_`, on any device) and the
hand-written CUDA kernel (`csrc/rows.cu`). The routing functions take the
plain version for CPU tensors and the kernel for CUDA tensors (or raise);
there is no fallback between the two. All write in place into the tensors
they are given: the caller decides between the cached tensors and a copy
(the view cache's copy slot).

B13. Under an active mesh the view is node-sharded (the reference's delta
applies run "on the already-sharded buffers",
`nomad_tpu/scheduler/stack.py:801-802`): `hot_rows_update_sharded`,
`port_rows_update_sharded` and `port_words_update_sharded` route each
changed row or word to the node shard that owns it, rebased to the
shard's first row, and run the same K7 part on every distinct copy of
that shard; a shard no change of which lands launches nothing.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

_VOID, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

#: the K7 parts, the keys of `delta_launch_counts`
DELTA_PARTS = ("hot_rows", "port_rows", "port_words")


def row_scatter_plain(dst: torch.Tensor, idx: torch.Tensor,
                      src: torch.Tensor) -> torch.Tensor:
    """In place: row idx[k] of `dst` becomes row k of `src`."""
    return dst.index_copy_(0, idx.long(), src)


def hot_rows_update_plain(used, node_ok, dyn_free, idx, used_vals, ok_vals,
                          dyn_vals):
    """In place: row idx[k] of used/node_ok/dyn_free becomes row k of
    used_vals/ok_vals/dyn_vals."""
    i = idx.long()
    used.index_copy_(0, i, used_vals)
    node_ok.index_copy_(0, i, ok_vals)
    dyn_free.index_copy_(0, i, dyn_vals)
    return used, node_ok, dyn_free


def port_rows_update_plain(ports, idx, vals):
    return row_scatter_plain(ports, idx, vals)


def port_words_update_plain(ports, rows, words, vals):
    """In place: ports[rows[k], words[k]] = vals[k] (the flat view)."""
    flat = ports.view(-1)
    flat.index_copy_(0, rows.long() * ports.shape[1] + words.long(), vals)
    return ports


class _Launcher:
    def __init__(self):
        self.launches = 0
        self.delta_launches = dict.fromkeys(DELTA_PARTS, 0)
        #: B13: K7 launches on a card's shard copies
        self.sharded_launches = 0
        self._lib = None

    def lib(self):
        if self._lib is None:
            from ._build import load_library

            lib = load_library("rows")
            lib.nomad_row_scatter.restype = _INT
            lib.nomad_row_scatter.argtypes = [
                _VOID, _LL, _VOID, _VOID, _INT, _LL, _VOID]
            lib.nomad_hot_rows.restype = _INT
            lib.nomad_hot_rows.argtypes = [
                _VOID, _VOID, _VOID, _LL, _INT, _VOID, _VOID, _VOID, _VOID,
                _INT, _VOID]
            lib.nomad_word_scatter.restype = _INT
            lib.nomad_word_scatter.argtypes = [
                _VOID, _LL, _INT, _VOID, _VOID, _VOID, _INT, _VOID]
            lib.nomad_rows_error_string.restype = ctypes.c_char_p
            lib.nomad_rows_error_string.argtypes = [ctypes.c_int]
            self._lib = lib
        return self._lib

    def check(self, err: int, what: str) -> None:
        if err != 0:
            raise RuntimeError(f"{what} launch failed: "
                               + self.lib().nomad_rows_error_string(err)
                               .decode())


_LAUNCHER = _Launcher()


def launch_count() -> int:
    """Program-table insert (K8) launches since the last reset."""
    return _LAUNCHER.launches


def reset_launch_count() -> None:
    _LAUNCHER.launches = 0


def delta_launch_counts() -> Dict[str, int]:
    """View row-delta (K7) launches per part since the last reset."""
    return dict(_LAUNCHER.delta_launches)


def reset_delta_launch_counts() -> None:
    _LAUNCHER.delta_launches = dict.fromkeys(DELTA_PARTS, 0)


def sharded_delta_launch_count() -> int:
    """K7 launches on the copies of a sharded view's shards on a card
    (B13) since the last reset."""
    return _LAUNCHER.sharded_launches


def reset_sharded_delta_launch_count() -> None:
    _LAUNCHER.sharded_launches = 0


def build_kernel() -> None:
    _LAUNCHER.lib()


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check_common(dst: torch.Tensor, *others: torch.Tensor) -> None:
    dev = dst.device
    if dev.type != "cuda":
        raise ValueError("the row kernels need CUDA tensors")
    for t in others:
        if t.device != dev:
            raise ValueError("all tensors must share a device")
    for t in (dst,) + others:
        if not t.is_contiguous():
            raise ValueError("the row kernels need contiguous tensors")


def _check_idx(idx: torch.Tensor, name: str = "idx") -> None:
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise TypeError(f"{name} must be i32[K]")


def _launch_row_scatter(dst, idx, src) -> int:
    _check_common(dst, idx, src)
    _check_idx(idx)
    if src.dtype != dst.dtype or tuple(src.shape[1:]) != tuple(dst.shape[1:]) \
            or src.shape[0] != idx.shape[0]:
        raise ValueError("src must be [K, *dst.shape[1:]] of dst's type")
    width = dst[0].numel() * dst.element_size() if dst.shape[0] else 0
    err = _LAUNCHER.lib().nomad_row_scatter(
        dst.data_ptr(), dst.shape[0], idx.data_ptr(), src.data_ptr(),
        idx.shape[0], width, _stream(dst.device))
    _LAUNCHER.check(err, "row scatter")
    return int(idx.shape[0] > 0 and width > 0)


def row_scatter_cuda(dst: torch.Tensor, idx: torch.Tensor,
                     src: torch.Tensor) -> torch.Tensor:
    """The K8 kernel on CUDA tensors: `dst` [T, ...] contiguous, `idx`
    i32[K], `src` [K, ...] of dst's type and row shape. Indices outside
    [0, T) are skipped. Raises when the launch fails; never falls back."""
    _LAUNCHER.launches += _launch_row_scatter(dst, idx, src)
    return dst


def hot_rows_update_cuda(used, node_ok, dyn_free, idx, used_vals, ok_vals,
                         dyn_vals):
    """K7, hot part: used f32[N, R], node_ok bool[N], dyn_free f32[N]
    (contiguous, on one card), idx i32[K], values f32[K, R], bool[K],
    f32[K]; one launch."""
    _check_common(used, node_ok, dyn_free, idx, used_vals, ok_vals,
                  dyn_vals)
    _check_idx(idx)
    n, k = used.shape[0], idx.shape[0]
    if (used.dtype != torch.float32 or dyn_free.dtype != torch.float32
            or node_ok.dtype != torch.bool or used.dim() != 2
            or node_ok.shape != (n,) or dyn_free.shape != (n,)):
        raise TypeError("used f32[N, R], node_ok bool[N], dyn_free f32[N]")
    if (used_vals.dtype != torch.float32
            or tuple(used_vals.shape) != (k, used.shape[1])
            or ok_vals.dtype != torch.bool or ok_vals.shape != (k,)
            or dyn_vals.dtype != torch.float32 or dyn_vals.shape != (k,)):
        raise TypeError("values must be f32[K, R], bool[K], f32[K]")
    err = _LAUNCHER.lib().nomad_hot_rows(
        used.data_ptr(), node_ok.data_ptr(), dyn_free.data_ptr(), n,
        used.shape[1], idx.data_ptr(), used_vals.data_ptr(),
        ok_vals.data_ptr(), dyn_vals.data_ptr(), k, _stream(used.device))
    _LAUNCHER.check(err, "hot rows")
    if k:
        _LAUNCHER.delta_launches["hot_rows"] += 1
    return used, node_ok, dyn_free


def port_rows_update_cuda(ports, idx, vals):
    """K7, whole port rows: the generic row scatter on the bitmap."""
    if _launch_row_scatter(ports, idx, vals):
        _LAUNCHER.delta_launches["port_rows"] += 1
    return ports


def port_words_update_cuda(ports, rows, words, vals):
    """K7, single words: ports [N, W] of 32-bit words (int32 holding the
    u32 bits), rows/words i32[K], vals [K] of ports' type."""
    _check_common(ports, rows, words, vals)
    _check_idx(rows, "rows")
    _check_idx(words, "words")
    k = rows.shape[0]
    if (ports.dim() != 2 or ports.element_size() != 4
            or vals.dtype != ports.dtype or vals.shape != (k,)
            or words.shape != (k,)):
        raise TypeError("ports [N, W] of 32-bit words, vals [K] of its type")
    err = _LAUNCHER.lib().nomad_word_scatter(
        ports.data_ptr(), ports.shape[0], ports.shape[1], rows.data_ptr(),
        words.data_ptr(), vals.data_ptr(), k, _stream(ports.device))
    _LAUNCHER.check(err, "port words")
    if k:
        _LAUNCHER.delta_launches["port_words"] += 1
    return ports


def _route(t: torch.Tensor, plain, cuda):
    kind = t.device.type
    if kind == "cpu":
        return plain
    if kind == "cuda":
        return cuda
    raise ValueError(f"no row kernel for device {kind!r}")


def row_scatter(dst: torch.Tensor, idx: torch.Tensor,
                src: torch.Tensor) -> torch.Tensor:
    """In place: row idx[k] of `dst` becomes row k of `src`. Plain on CPU
    tensors, the kernel on CUDA tensors."""
    return _route(dst, row_scatter_plain, row_scatter_cuda)(dst, idx, src)


def hot_rows_update(used, node_ok, dyn_free, idx, used_vals, ok_vals,
                    dyn_vals):
    return _route(used, hot_rows_update_plain, hot_rows_update_cuda)(
        used, node_ok, dyn_free, idx, used_vals, ok_vals, dyn_vals)


def port_rows_update(ports, idx, vals):
    return _route(ports, port_rows_update_plain, port_rows_update_cuda)(
        ports, idx, vals)


def port_words_update(ports, rows, words, vals):
    return _route(ports, port_words_update_plain, port_words_update_cuda)(
        ports, rows, words, vals)


# ---- K7 on a node-sharded view (B13) -------------------------------------------


def _per_shard(bufs, rows: int, row_of, launch) -> None:
    """Route the changes at global rows `row_of` to the copies of the
    node shards that own them (`bufs`: per field {(device, node shard):
    tensor}, shards of `rows` rows): `launch(copy's tensors, their
    device, positions, local rows)` once per copy of each shard with
    changes. Counts each K7 launch on a card as a B13 launch."""
    from ..parallel.mesh import route_rows

    keys = list(bufs[0])
    for j, pos, local in route_rows(row_of, rows,
                                    len({k[1] for k in keys})):
        for key in keys:
            if key[1] == j:
                dev = bufs[0][key].device
                launch(tuple(b[key] for b in bufs), dev, pos, local)
                if dev.type == "cuda":
                    _LAUNCHER.sharded_launches += 1


def staged(a: np.ndarray, dev) -> torch.Tensor:
    """Host array `a` on `dev`, staged through pinned memory."""
    from ..convert import to_device_async

    return to_device_async(np.ascontiguousarray(a), dev)


def hot_rows_update_sharded(bufs, rows: int, idx, used_vals, ok_vals,
                            dyn_vals) -> None:
    """K7's hot part on a sharded view: `bufs` = (used, node_ok,
    dyn_free), each {(device, node shard): tensor}; host arrays `idx`
    (global rows, i32) and their f32[K, R], bool[K], f32[K] values.
    Writes in place."""
    def launch(b, dev, pos, local):
        hot_rows_update(*b, staged(local, dev), staged(used_vals[pos], dev),
                        staged(ok_vals[pos], dev), staged(dyn_vals[pos], dev))

    _per_shard(bufs, rows, idx, launch)


def port_rows_update_sharded(ports, rows: int, idx, vals) -> None:
    """K7's whole port rows on a sharded bitmap ({(device, node shard):
    tensor}); host `idx` global rows and their [K, W] words."""
    def launch(b, dev, pos, local):
        port_rows_update(b[0], staged(local, dev), staged(vals[pos], dev))

    _per_shard((ports,), rows, idx, launch)


def port_words_update_sharded(ports, rows: int, row_idx, words, vals) -> None:
    """K7's single words on a sharded bitmap: host `row_idx` (global
    rows), `words` and `vals`, [K] each."""
    def launch(b, dev, pos, local):
        port_words_update(b[0], staged(local, dev), staged(words[pos], dev),
                          staged(vals[pos], dev))

    _per_shard((ports,), rows, row_idx, launch)
