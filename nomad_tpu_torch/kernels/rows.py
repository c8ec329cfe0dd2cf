"""Row writes: the program-table insert (K8) and the device view's
row-delta refresh (K7), each one staged copy and one launch.

K8. The device program table's insert (`server/program_table.py`) returns
new i32/f32/u8 class tables equal to the old ones with K rows replaced,
as the reference's non-donated `_get_insert_jit` does
(`nomad_tpu/server/program_table.py:99`): dispatches that already hold the
old tables keep reading them. `pack_insert` packs the K row indices
(sorted ascending) and rows into one host buffer; `table_insert` stages it
and writes the three new tables in one launch.

K7. The view cache (`scheduler/stack.py` `TorchStack.device_arrays`)
ships only the rows the cluster's delta log names; the reference writes
them with `_rows_update`, `_hot_delta_impl`, `_ports_delta_impl` and
`_ports_word_impl` (`nomad_tpu/scheduler/stack.py:115-177`), run over
32-row chunks padded by repeating the first row. Here a refresh gathers
its parts on the host in a `ViewDelta` — hot rows (used, node_ok,
dyn_free), whole port rows, single port words; any count, distinct rows —
and `apply_view_delta` flushes them: one packed buffer, one staged copy,
one launch, in place into the tensors it is given (the caller decides
between the cached tensors and copies, the view cache's copy slot).

B13. Under an active mesh the view is node-sharded (the reference's delta
applies run "on the already-sharded buffers",
`nomad_tpu/scheduler/stack.py:801-802`): `apply_view_delta` with
`shard_rows` routes each changed row or word to the node shard that owns
it, rebased to the shard's first row (`parallel/mesh.py` `route_rows`),
packs one buffer for each device holding a shard with changes and
launches once for each copy of such a shard; a shard no change lands in
launches nothing.

The packed buffer (`Packed`): sub-packs, each an int64 header — the counts
and widths first, then one byte offset an array, relative to the header —
and the arrays, every piece on a 16-byte boundary. The header's bytes in
the host copy are its only form: the C entry points (`csrc/rows.cu`) and
the wrappers' checks read them there (`_read_head`), and the plain
versions decode the buffer the same way (the arrays where the buffer
lies), so the CPU tests exercise the layout too.

Each entry point has a plain version (`torch.index_copy`) and the
hand-written CUDA kernel. The routing functions take the plain version
for CPU tensors and the kernel for CUDA tensors, and raise for any other
device; there is no fallback between the two.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence

import numpy as np
import torch

_VOID, _LL = ctypes.c_void_p, ctypes.c_longlong

#: every piece of a packed buffer starts on a 16-byte boundary
ALIGN = 16
#: header fields (int64) of an insert and of a view delta, in the order the
#: C entry points read them: the counts and widths, then one offset an array
INSERT_HEAD = ("k", "li", "lf", "lu", "idx", "ri", "rf", "ru")
DELTA_HEAD = ("n_hot", "r", "n_prow", "w", "n_words", "hot_idx", "hot_used",
              "hot_ok", "hot_dyn", "prow_idx", "prow_vals", "word_row",
              "word_col", "word_val")


def _aligned(nbytes: int) -> int:
    return -(-nbytes // ALIGN) * ALIGN


class Packed:
    """Sub-packs in one u8 buffer. `host` is the buffer in host memory
    (pinned when it goes to a card) and `raw` the same memory as numpy,
    `buf` the buffer where it is read (`host` itself until `to` stages
    it), `at` each sub-pack's byte offset."""

    __slots__ = ("host", "raw", "buf", "at")

    def __init__(self, host: torch.Tensor, raw: np.ndarray,
                 buf: torch.Tensor, at: List[int]) -> None:
        self.host = host
        self.raw = raw
        self.buf = buf
        self.at = at

    def to(self, device) -> "Packed":
        """The buffer on `device`: one copy, asynchronous from pinned
        memory to a card (the caching host allocator keeps the block until
        the copy has run); the host buffer itself on the CPU."""
        dev = torch.device(device)
        if self.buf.device == dev or (dev.type == "cpu"
                                      and self.buf.device.type == "cpu"):
            return self
        return Packed(self.host, self.raw,
                      self.host.to(dev, non_blocking=True),  # nomadlint: ok NLD01 the one staged copy of a K7/K8 buffer, booked by its callers: program_table.py at select_batch.table_insert, stack.py at the stack.* part sites
                      self.at)


def _pack(names: Sequence[str], subs, pinned: bool) -> Packed:
    """One buffer of sub-packs `subs` = [(counts, arrays)]: each sub-pack's
    header holds its counts, then the offset of each of its arrays."""
    head_bytes = _aligned(8 * len(names))
    at, offsets, total = [], [], 0
    for _counts, arrays in subs:
        offs, size = [], head_bytes
        for a in arrays:
            offs.append(size)
            size += _aligned(a.nbytes)
        at.append(total)
        offsets.append(offs)
        total += size
    host = torch.empty(total, dtype=torch.uint8, pin_memory=pinned)
    raw = host.numpy()
    for start, (counts, arrays), offs in zip(at, subs, offsets):
        raw[start:start + 8 * len(names)].view(np.int64)[:] = \
            [int(c) for c in counts] + offs
        for off, a in zip(offs, arrays):
            if a.nbytes:
                raw[start + off:start + off + a.nbytes] = \
                    a.view(np.uint8).reshape(-1)
    return Packed(host, raw, host, at)


def _read_head(packed: Packed, sub: int, names: Sequence[str]):
    """Sub-pack `sub`'s header, read from the buffer's bytes (the host
    copy: a staged buffer's header needs no read back from the card)."""
    at = packed.at[sub]
    return dict(zip(names, packed.raw[at:at + 8 * len(names)]
                    .view(np.int64).tolist()))


def _segment(packed: Packed, sub: int, off: int, dtype, shape):
    """The array at byte offset `off` of sub-pack `sub`, as a view of the
    buffer."""
    start = packed.at[sub] + off
    nbytes = int(np.prod(shape)) * dtype.itemsize
    return packed.buf[start:start + nbytes].view(dtype).view(shape)


class _Launcher:
    def __init__(self):
        self.launches = 0
        #: K7 launches (a refresh's flush on an unsharded view)
        self.delta_launches = 0
        #: B13: K7 launches on a card's shard copies
        self.sharded_launches = 0
        self._lib = None

    def lib(self):
        if self._lib is None:
            from ._build import load_library

            lib = load_library("rows")
            lib.nomad_table_insert.restype = ctypes.c_int
            lib.nomad_table_insert.argtypes = [
                _VOID, _VOID, ctypes.c_int] + [_VOID] * 7
            lib.nomad_view_delta.restype = ctypes.c_int
            lib.nomad_view_delta.argtypes = [
                _VOID, _VOID, _LL, _VOID, _VOID, _VOID, _VOID, _VOID]
            lib.nomad_rows_error_string.restype = ctypes.c_char_p
            lib.nomad_rows_error_string.argtypes = [ctypes.c_int]
            # the current stream's raw handle, read at every launch (never
            # cached: a launch must land on the stream current at the call,
            # a capturing one included); a torch without the getter fails
            # here, at load
            self.raw_stream = torch._C._cuda_getCurrentRawStream
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


def delta_launch_counts() -> int:
    """View row-delta (K7) launches on an unsharded view since the last
    reset: one a flush that applied changes (a shard copy's launches
    count as B13's, `sharded_delta_launch_count`)."""
    return _LAUNCHER.delta_launches


def reset_delta_launch_counts() -> None:
    _LAUNCHER.delta_launches = 0


def sharded_delta_launch_count() -> int:
    """K7 launches on the copies of a sharded view's shards on a card
    (B13) since the last reset."""
    return _LAUNCHER.sharded_launches


def reset_sharded_delta_launch_count() -> None:
    _LAUNCHER.sharded_launches = 0


def build_kernel() -> None:
    _LAUNCHER.lib()


def _route(t: torch.Tensor, plain, cuda):
    kind = t.device.type
    if kind == "cpu":
        return plain
    if kind == "cuda":
        return cuda
    raise ValueError(f"no row kernel for device {kind!r}")


# ---- K8: the program-table insert -----------------------------------------


def pack_insert(idx, ri, rf, ru, device=None) -> Packed:
    """The insert's host arrays in one buffer (pinned when `device` is a
    card): `idx` i32[K] strictly ascending row indices, `ri` i32[K, Li],
    `rf` f32[K, Lf], `ru` u8[K, Lu] their rows."""
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    ri = np.ascontiguousarray(ri, dtype=np.int32)
    rf = np.ascontiguousarray(rf, dtype=np.float32)
    ru = np.ascontiguousarray(ru, dtype=np.uint8)
    k = idx.shape[0] if idx.ndim == 1 else -1
    if any(a.ndim != 2 or a.shape[0] != k for a in (ri, rf, ru)):
        raise ValueError("idx [K] and rows [K, L] of each class table")
    if k > 1 and not (idx[1:] > idx[:-1]).all():
        raise ValueError("the insert's row indices must be strictly "
                         "ascending")
    pinned = device is not None and torch.device(device).type == "cuda"
    return _pack(INSERT_HEAD, [((k, ri.shape[1], rf.shape[1], ru.shape[1]),
                                (idx, ri, rf, ru))], pinned)


def table_insert_plain(tables, packed: Packed):
    """New (ti, tf, tu): row idx[k] of each replaced by its staged row k,
    decoded from `packed`; `torch.index_copy` out of place, one call a
    table."""
    h = _read_head(packed, 0, INSERT_HEAD)
    k = h["k"]
    idx = _segment(packed, 0, h["idx"], torch.int32, (k,)).long()
    out = []
    for table, name, width in zip(tables, ("ri", "rf", "ru"),
                                  (h["li"], h["lf"], h["lu"])):
        rows = _segment(packed, 0, h[name], table.dtype, (k, width))
        out.append(torch.index_copy(table, 0, idx, rows))
    return tuple(out)


def table_insert_cuda(tables, packed: Packed):
    """K8 on CUDA tensors: ti i32[T, Li], tf f32[T, Lf], tu u8[T, Lu]
    (contiguous, on one card); stages `packed` if it is not there yet,
    allocates the new tables and writes them in one launch. Raises when
    the launch fails; never falls back."""
    ti, tf, tu = tables
    dev = ti.device
    h = _read_head(packed, 0, INSERT_HEAD)
    t = ti.shape[0]
    if (ti.dtype != torch.int32 or tf.dtype != torch.float32
            or tu.dtype != torch.uint8 or ti.shape != (t, h["li"])
            or tf.shape != (t, h["lf"]) or tu.shape != (t, h["lu"])
            or tf.device != dev or tu.device != dev
            or not (ti.is_contiguous() and tf.is_contiguous()
                    and tu.is_contiguous())):
        raise ValueError("the insert needs contiguous i32[T, Li], "
                         "f32[T, Lf] and u8[T, Lu] tables on one card, "
                         "of the packed rows' widths")
    lib = _LAUNCHER.lib()
    packed = packed.to(dev)  # nomadlint: ok NLD01 Packed.to: the staged copy, booked by program_table.py at select_batch.table_insert (none when the caller staged it)
    out = tuple(torch.empty(x.shape, dtype=x.dtype, device=dev)
                for x in tables)
    at = packed.at[0]
    err = lib.nomad_table_insert(
        packed.host.data_ptr() + at, packed.buf.data_ptr() + at, t,
        ti.data_ptr(), tf.data_ptr(), tu.data_ptr(), out[0].data_ptr(),
        out[1].data_ptr(), out[2].data_ptr(), _LAUNCHER.raw_stream(dev.index))
    _LAUNCHER.check(err, "table insert")
    if t:
        _LAUNCHER.launches += 1
    return out


def table_insert(tables, packed: Packed):
    """New class tables with the packed rows inserted (the old ones are
    never written). Plain on CPU tensors, the kernel on CUDA tensors."""
    return _route(tables[0], table_insert_plain, table_insert_cuda)(
        tables, packed)


# ---- K7: the view row-delta refresh ----------------------------------------

_NO_I32 = np.empty(0, dtype=np.int32)


class ViewDelta:
    """One refresh's row delta, gathered on the host; `apply_view_delta`
    flushes it. Parts (each at most once, distinct rows, numpy):
    `hot` = (idx i32[H], used f32[H, R], node_ok bool[H], dyn_free f32[H]),
    `port_rows` = (idx i32[P], words [P, W] of 32 bits),
    `port_words` = (rows i32[Q], words i32[Q], values [Q] of 32 bits)."""

    __slots__ = ("hot", "port_rows", "port_words")

    def __init__(self) -> None:
        self.hot = self.port_rows = self.port_words = None

    def __bool__(self) -> bool:
        return (self.hot is not None or self.port_rows is not None
                or self.port_words is not None)

    def add_hot(self, idx, used, node_ok, dyn_free) -> None:
        self.hot = (np.ascontiguousarray(idx, dtype=np.int32),
                    np.ascontiguousarray(used, dtype=np.float32),
                    np.ascontiguousarray(node_ok, dtype=np.bool_),
                    np.ascontiguousarray(dyn_free, dtype=np.float32))

    def add_port_rows(self, idx, words) -> None:
        self.port_rows = (np.ascontiguousarray(idx, dtype=np.int32),
                          _bits32(words))

    def add_port_words(self, rows, words, values) -> None:
        self.port_words = (np.ascontiguousarray(rows, dtype=np.int32),
                           np.ascontiguousarray(words, dtype=np.int32),
                           _bits32(values))

    def sub(self, r: int, w: int):
        """(counts, arrays) of one sub-pack for view tensors of `r` used
        columns and `w` port words a row (`DELTA_HEAD` order)."""
        hot = self.hot or (_NO_I32, np.empty((0, r), np.float32),
                           np.empty(0, np.bool_), np.empty(0, np.float32))
        prow = self.port_rows or (_NO_I32, np.empty((0, w), np.int32))
        words = self.port_words or (_NO_I32, _NO_I32, _NO_I32)
        return ((hot[0].shape[0], r, prow[0].shape[0], w,
                 words[0].shape[0]), hot + prow + words)

    def split(self, rows: int, shards: int) -> Dict[int, "ViewDelta"]:
        """The delta of each node shard of `rows` rows that any change
        lands in, its rows rebased to the shard's first row."""
        from ..parallel.mesh import route_rows

        out: Dict[int, ViewDelta] = {}
        for name in ("hot", "port_rows", "port_words"):
            part = getattr(self, name)
            if part is None:
                continue
            for j, pos, local in route_rows(part[0], rows, shards):
                setattr(out.setdefault(j, ViewDelta()), name,
                        (local,) + tuple(a[pos] for a in part[1:]))
        return out


def _bits32(a) -> np.ndarray:
    """32-bit words as the int32 holding the same bits (the device
    bitmap's type)."""
    a = np.ascontiguousarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a.astype(
        np.int32, copy=False)


def pack_view_delta(deltas: Sequence[ViewDelta], copies, device) -> Packed:
    """One buffer of sub-packs, delta i for the view tensors `copies[i]` =
    (used, node_ok, dyn_free, ports); pinned when `device` is a card."""
    subs = [d.sub(c[0].shape[1], c[3].shape[1])
            for d, c in zip(deltas, copies)]
    return _pack(DELTA_HEAD, subs, torch.device(device).type == "cuda")


def view_delta_plain(bufs, packed: Packed, sub: int = 0):
    """In place into bufs = (used, node_ok, dyn_free, ports): sub-pack
    `sub` of `packed`, decoded with torch slicing, through `index_copy_`."""
    used, node_ok, dyn_free, ports = bufs
    h = _read_head(packed, sub, DELTA_HEAD)
    n_hot, n_prow, n_words, w = h["n_hot"], h["n_prow"], h["n_words"], h["w"]

    def seg(name, dtype, shape):
        return _segment(packed, sub, h[name], dtype, shape)

    if n_hot:
        i = seg("hot_idx", torch.int32, (n_hot,)).long()
        used.index_copy_(0, i, seg("hot_used", torch.float32,
                                   (n_hot, h["r"])))
        node_ok.index_copy_(0, i, seg("hot_ok", torch.bool, (n_hot,)))
        dyn_free.index_copy_(0, i, seg("hot_dyn", torch.float32, (n_hot,)))
    if n_prow:
        ports.index_copy_(0, seg("prow_idx", torch.int32, (n_prow,)).long(),
                          seg("prow_vals", ports.dtype, (n_prow, w)))
    if n_words:
        flat = (seg("word_row", torch.int32, (n_words,)).long() * w
                + seg("word_col", torch.int32, (n_words,)).long())
        ports.view(-1).index_copy_(0, flat, seg("word_val", ports.dtype,
                                                (n_words,)))
    return bufs


def view_delta_cuda(bufs, packed: Packed, sub: int = 0, shard: bool = False):
    """K7 on CUDA tensors: used f32[N, R], node_ok bool[N], dyn_free
    f32[N], ports [N, W] of 32-bit words (contiguous, on one card); stages
    `packed` if it is not there yet and applies sub-pack `sub` in one
    launch, counted as B13's when `shard` (the tensors are a shard's
    copy). Raises when the launch fails; never falls back."""
    used, node_ok, dyn_free, ports = bufs
    dev = used.device
    h = _read_head(packed, sub, DELTA_HEAD)
    n = used.shape[0]
    if (used.dtype != torch.float32 or used.dim() != 2
            or node_ok.dtype != torch.bool or node_ok.shape != (n,)
            or dyn_free.dtype != torch.float32 or dyn_free.shape != (n,)
            or ports.dim() != 2 or ports.shape[0] != n
            or ports.element_size() != 4
            or node_ok.device != dev or dyn_free.device != dev
            or ports.device != dev
            or not (used.is_contiguous() and node_ok.is_contiguous()
                    and dyn_free.is_contiguous() and ports.is_contiguous())):
        raise ValueError("K7 needs contiguous used f32[N, R], node_ok "
                         "bool[N], dyn_free f32[N] and ports [N, W] of "
                         "32-bit words on one card")
    if used.shape[1] != h["r"] or ports.shape[1] != h["w"]:
        raise ValueError("the packed delta was built for other widths")
    lib = _LAUNCHER.lib()
    packed = packed.to(dev)  # nomadlint: ok NLD01 Packed.to: the staged copy, booked by stack.py at the stack.* part sites (none when apply_view_delta staged it)
    at = packed.at[sub]
    err = lib.nomad_view_delta(
        packed.host.data_ptr() + at, packed.buf.data_ptr() + at, n,
        used.data_ptr(), node_ok.data_ptr(), dyn_free.data_ptr(),
        ports.data_ptr(), _LAUNCHER.raw_stream(dev.index))
    _LAUNCHER.check(err, "view delta")
    if h["n_hot"] or h["n_prow"] or h["n_words"]:
        if shard:
            _LAUNCHER.sharded_launches += 1
        else:
            _LAUNCHER.delta_launches += 1
    return bufs


def view_delta(bufs, packed: Packed, sub: int = 0, shard: bool = False):
    """Sub-pack `sub` of `packed` into bufs = (used, node_ok, dyn_free,
    ports), in place (`shard`: the tensors are a shard's copy, B13). Plain
    on CPU tensors, the kernel on CUDA tensors."""
    if _route(bufs[0], False, True):
        return view_delta_cuda(bufs, packed, sub, shard)
    return view_delta_plain(bufs, packed, sub)


def apply_view_delta(bufs, delta: ViewDelta, shard_rows=None):
    """Flush `delta` into bufs = (used, node_ok, dyn_free, ports), in
    place: tensors on one device (one packed buffer, one staged copy, one
    launch), or under a mesh (`shard_rows` rows a node shard) each field a
    {(device, node shard): tensor} — one packed buffer and copy for each
    device that holds a shard with changes, one launch for each copy of
    such a shard (B13). Returns `bufs`."""
    if shard_rows is None:
        dev = bufs[0].device
        staged = pack_view_delta([delta], [bufs], dev).to(dev)  # nomadlint: ok NLD01 Packed.to: the staged copy, booked by stack.py at the stack.* part sites
        view_delta(bufs, staged)
        return bufs
    keys = list(bufs[0])
    parts = delta.split(shard_rows, len({key[1] for key in keys}))
    by_dev: Dict[object, list] = {}
    for key in keys:
        if key[1] in parts:
            by_dev.setdefault(key[0], []).append(key)
    for group in by_dev.values():
        copies = [tuple(b[key] for b in bufs) for key in group]
        dev = copies[0][0].device
        packed = pack_view_delta([parts[key[1]] for key in group], copies,
                                 dev)
        packed = packed.to(dev)  # nomadlint: ok NLD01 Packed.to: the staged copy of one device's shard deltas, booked by stack.py at the stack.* part sites
        for i, copy in enumerate(copies):
            view_delta(copy, packed, i, True)
    return bufs
