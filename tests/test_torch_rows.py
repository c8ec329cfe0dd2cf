"""The port's row writes (K8, K7, B13) against the reference's kernels.

K8: `table_insert_plain` decodes a packed insert and returns new class
tables through `torch.index_copy`; it must equal the reference's jitted
`_get_insert_jit` (`nomad_tpu/server/program_table.py:99`) bitwise on the
same numpy-seeded tables, with the row indices ascending as `commit`
sorts them, and leave the old tables unwritten.

K7: `view_delta_plain` decodes a packed view delta (hot rows, whole port
rows, port words) and applies it with `index_copy_`; it must equal the
reference's `_delta_kernels(donate=False)` parts (`_hot_delta_impl`,
`_ports_delta_impl`, `_ports_word_impl`,
`nomad_tpu/scheduler/stack.py:115-177`) bitwise. The packing is covered on
its own: an empty delta, each part alone, all three, port rows whose
width is no multiple of 16 bytes, unaligned u8 widths in an insert, and
n_cap // 4 rows (the most a refresh sends before it uploads whole).

B13: a sharded flush packs one buffer for each device that holds a shard
with changes and launches once for each copy of such a shard, and every
copy equals the unsharded flush's rows.

On the CPU every wrapper takes the plain version and counts no launch;
a tensor on any other device than the CPU or a card raises.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomad_tpu.scheduler import stack as jstack
from nomad_tpu.server import program_table as jpt
from torch_chain_cases import one_torch_thread  # noqa: F401

from nomad_tpu_torch.kernels import rows as kr


def _tables(rng, t, li, lf, lu):
    return (rng.integers(-2 ** 31, 2 ** 31 - 1, (t, li), dtype=np.int32),
            rng.standard_normal((t, lf)).astype(np.float32),
            rng.integers(0, 256, (t, lu), dtype=np.uint8))


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _assert_bitwise(want, got, what):
    for i, (w, g) in enumerate(zip(want, got)):
        w, g = np.asarray(w), np.asarray(g)
        assert w.shape == g.shape and w.dtype == g.dtype, (what, i)
        np.testing.assert_array_equal(_bits(w), _bits(g),
                                      err_msg=f"{what} {i}")


# ---- K8: the program-table insert ------------------------------------------

#: (table rows T, inserted rows K, Li, Lf, Lu): the u8 widths include ones
#: that are no multiple of 16 (or of 4) bytes
INSERT_SIZES = [(16, 3, 5, 3, 1), (16, 1, 5, 3, 7), (64, 8, 12, 4, 13),
                (512, 128, 96, 40, 37), (64, 64, 16, 16, 48)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("size", INSERT_SIZES,
                         ids=lambda s: "T{}-K{}-i{}-f{}-u{}".format(*s))
def test_table_insert_plain_matches_reference(seed, size):
    t, k, li, lf, lu = size
    rng = np.random.default_rng(seed)
    old = _tables(rng, t, li, lf, lu)
    idx = np.sort(rng.choice(t, k, replace=False)).astype(np.int32)
    ri, rf, ru = _tables(rng, k, li, lf, lu)
    want = jpt._get_insert_jit()(*map(jnp.asarray, old + (idx, ri, rf, ru)))
    tables = tuple(torch.from_numpy(a.copy()) for a in old)
    launches = kr.launch_count()
    got = kr.table_insert(tables, kr.pack_insert(idx, ri, rf, ru))
    assert kr.launch_count() == launches    # the CPU takes the plain version
    _assert_bitwise(want, [g.numpy() for g in got], "insert")
    _assert_bitwise(old, [x.numpy() for x in tables], "old tables written")
    plain = kr.table_insert_plain(tables, kr.pack_insert(idx, ri, rf, ru))
    _assert_bitwise(want, [g.numpy() for g in plain], "plain insert")


def test_empty_insert_returns_copies():
    """No rows to insert (the reference's jit never traces that case:
    `commit` inserts only pending rows): new tables equal to the old."""
    rng = np.random.default_rng(4)
    old = _tables(rng, 8, 3, 2, 5)
    tables = tuple(torch.from_numpy(a) for a in old)
    got = kr.table_insert(tables, kr.pack_insert(
        np.empty(0, np.int32), *_tables(rng, 0, 3, 2, 5)))
    _assert_bitwise(old, [g.numpy() for g in got], "empty insert")
    assert all(g.data_ptr() != t.data_ptr() for g, t in zip(got, tables))


def test_insert_rows_must_ascend():
    rng = np.random.default_rng(3)
    ri, rf, ru = _tables(rng, 3, 4, 4, 4)
    with pytest.raises(ValueError, match="ascending"):
        kr.pack_insert(np.array([5, 2, 9], np.int32), ri, rf, ru)
    with pytest.raises(ValueError, match="ascending"):
        kr.pack_insert(np.array([2, 2, 9], np.int32), ri, rf, ru)


# ---- K7: the view row-delta refresh -----------------------------------------

N, R = 64, 8


def _view(rng, w):
    return (rng.standard_normal((N, R)).astype(np.float32) * 1000,
            rng.random(N) < 0.5,
            rng.standard_normal(N).astype(np.float32) * 100,
            rng.integers(0, 2 ** 32, (N, w), dtype=np.uint32))


def _delta(rng, w, n_hot, n_prow, n_words):
    """A delta of distinct hot rows, distinct whole port rows and distinct
    (row, word) pairs on rows no whole port row names."""
    hot = np.sort(rng.choice(N, n_hot, replace=False)).astype(np.int32)
    rows = rng.permutation(N)
    prow = np.sort(rows[:n_prow]).astype(np.int32)
    pairs = rng.permutation([(r, c) for r in rows[n_prow:] for c in range(w)])
    pairs = sorted(map(tuple, pairs[:n_words]))
    return dict(
        hot=(hot, rng.standard_normal((n_hot, R)).astype(np.float32),
             rng.random(n_hot) < 0.5,
             rng.standard_normal(n_hot).astype(np.float32)),
        prow=(prow, rng.integers(0, 2 ** 32, (n_prow, w), dtype=np.uint32)),
        words=(np.array([p[0] for p in pairs], np.int32).reshape(-1),
               np.array([p[1] for p in pairs], np.int32).reshape(-1),
               rng.integers(0, 2 ** 32, n_words, dtype=np.uint32)))


def _view_delta(parts):
    d = kr.ViewDelta()
    if parts["hot"][0].size:
        d.add_hot(*parts["hot"])
    if parts["prow"][0].size:
        d.add_port_rows(*parts["prow"])
    if parts["words"][0].size:
        d.add_port_words(*parts["words"])
    return d


def _reference(view, parts):
    hot_k, ports_k, word_k = jstack._delta_kernels(donate=False)
    used, ok, dyn, ports = map(jnp.asarray, view)
    if parts["hot"][0].size:
        used, ok, dyn = hot_k(used, ok, dyn, *map(jnp.asarray, parts["hot"]))
    if parts["prow"][0].size:
        ports = ports_k(ports, *map(jnp.asarray, parts["prow"]))
    if parts["words"][0].size:
        ports = word_k(ports, *map(jnp.asarray, parts["words"]))
    return [np.asarray(x) for x in (used, ok, dyn, ports)]


def _port_tensors(view):
    used, ok, dyn, ports = view
    return (torch.from_numpy(used.copy()), torch.from_numpy(ok.copy()),
            torch.from_numpy(dyn.copy()),
            torch.from_numpy(ports.view(np.int32).copy()))


def _port_np(bufs):
    used, ok, dyn, ports = (b.numpy() for b in bufs)
    return [used, ok, dyn, ports.view(np.uint32)]


#: (hot rows, whole port rows, port words, words a port row): an empty
#: delta, each part alone, all three, port rows of 20 bytes (no multiple
#: of 16), and n_cap // 4 rows of each part
DELTA_CASES = {
    "empty": (0, 0, 0, 16),
    "hot_only": (5, 0, 0, 16),
    "port_rows_only": (0, 3, 0, 16),
    "words_only": (0, 0, 9, 16),
    "all_three": (7, 2, 11, 16),
    "unaligned_rows": (3, 4, 6, 5),
    "quarter": (N // 4, N // 4, N // 4, 16),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", sorted(DELTA_CASES))
def test_view_delta_plain_matches_reference(case, seed):
    n_hot, n_prow, n_words, w = DELTA_CASES[case]
    rng = np.random.default_rng(100 + seed)
    view = _view(rng, w)
    parts = _delta(rng, w, n_hot, n_prow, n_words)
    want = _reference(view, parts)
    delta = _view_delta(parts)
    assert bool(delta) == (n_hot + n_prow + n_words > 0)
    bufs = _port_tensors(view)
    launches = kr.delta_launch_counts()
    kr.apply_view_delta(bufs, delta)
    assert kr.delta_launch_counts() == launches
    _assert_bitwise(want, _port_np(bufs), case)
    # the plain version on the same packed buffer, through the router
    bufs = _port_tensors(view)
    kr.view_delta(bufs, kr.pack_view_delta([delta], [bufs], "cpu"))
    _assert_bitwise(want, _port_np(bufs), f"{case} (view_delta)")


def _segments(packed, sub, names, arrays):
    """Every array of sub-pack `sub` read back from the buffer at the
    offset its header gives."""
    head = kr._read_head(packed, sub, names)
    n_counts = len(names) - len(arrays)
    for name, a in zip(names[n_counts:], arrays):
        off = packed.at[sub] + head[name]
        assert off % kr.ALIGN == 0, name
        raw = packed.buf[off:off + a.nbytes].numpy()
        np.testing.assert_array_equal(
            raw, np.ascontiguousarray(a).view(np.uint8).reshape(-1),
            err_msg=name)
    return head


@pytest.mark.parametrize("case", sorted(DELTA_CASES))
def test_view_delta_packing_layout(case):
    """Each array of a packed delta sits on a 16-byte boundary at the
    offset its header names, byte for byte; the header read from the
    buffer holds the parts' counts and widths."""
    n_hot, n_prow, n_words, w = DELTA_CASES[case]
    rng = np.random.default_rng(7)
    view = _view(rng, w)
    parts = _delta(rng, w, n_hot, n_prow, n_words)
    bufs = _port_tensors(view)
    delta = _view_delta(parts)
    packed = kr.pack_view_delta([delta], [bufs], "cpu")
    counts, arrays = delta.sub(R, w)
    head = _segments(packed, 0, kr.DELTA_HEAD, arrays)
    assert (head["n_hot"], head["r"], head["n_prow"], head["w"],
            head["n_words"]) == (n_hot, R, n_prow, w, n_words) == counts
    assert packed.buf.numel() % kr.ALIGN == 0


@pytest.mark.parametrize("size", INSERT_SIZES,
                         ids=lambda s: "T{}-K{}-i{}-f{}-u{}".format(*s))
def test_insert_packing_layout(size):
    _t, k, li, lf, lu = size
    rng = np.random.default_rng(11)
    idx = np.arange(k, dtype=np.int32) * 2
    ri, rf, ru = _tables(rng, k, li, lf, lu)
    packed = kr.pack_insert(idx, ri, rf, ru)
    head = _segments(packed, 0, kr.INSERT_HEAD, (idx, ri, rf, ru))
    assert (head["k"], head["li"], head["lf"], head["lu"]) == (k, li, lf, lu)


# ---- B13: the sharded flush -------------------------------------------------

#: two devices, each holding a copy of every one of 4 node shards
DEVICES = (torch.device("cpu"), torch.device("cpu", 0))
SHARDS = 4


@pytest.mark.parametrize("changed", [(), (1,), (1, 3), (0, 1, 2, 3)],
                         ids=["none", "one", "two", "all"])
def test_sharded_flush_one_buffer_a_device_one_launch_a_copy(changed,
                                                             monkeypatch):
    rows = N // SHARDS
    rng = np.random.default_rng(5)
    view = _view(rng, 16)
    in_shards = np.array([r for r in range(N) if r // rows in changed],
                         dtype=np.int64)
    parts = _delta(rng, 16, 0, 0, 0)
    if in_shards.size:
        pick = rng.permutation(in_shards)
        hot = np.sort(pick[:6]).astype(np.int32)
        prow = np.sort(pick[6:8]).astype(np.int32)
        wrow = np.sort(pick[8:12]).astype(np.int32)
        parts = dict(
            hot=(hot, rng.standard_normal((hot.size, R)).astype(np.float32),
                 rng.random(hot.size) < 0.5,
                 rng.standard_normal(hot.size).astype(np.float32)),
            prow=(prow, rng.integers(0, 2 ** 32, (prow.size, 16),
                                     dtype=np.uint32)),
            words=(wrow, rng.integers(0, 16, wrow.size).astype(np.int32),
                   rng.integers(0, 2 ** 32, wrow.size, dtype=np.uint32)))
    whole = _port_tensors(view)
    bufs = tuple({(d, j): t[j * rows:(j + 1) * rows].clone()
                  for d in DEVICES for j in range(SHARDS)} for t in whole)
    packs, launches = [], []
    real_pack, real_launch = kr.pack_view_delta, kr.view_delta

    def pack(deltas, copies, device):
        packs.append(len(deltas))
        return real_pack(deltas, copies, device)

    def launch(copy, packed, *rest):
        launches.append(id(copy[0]))
        return real_launch(copy, packed, *rest)

    monkeypatch.setattr(kr, "pack_view_delta", pack)
    monkeypatch.setattr(kr, "view_delta", launch)
    kr.apply_view_delta(bufs, _view_delta(parts), rows)
    copies = {id(bufs[0][(d, j)]) for d in DEVICES for j in changed}
    assert packs == ([len(changed)] * len(DEVICES) if changed else [])
    assert sorted(launches) == sorted(copies)
    kr.apply_view_delta(whole, _view_delta(parts))
    for f, (field, full) in enumerate(zip(bufs, whole)):
        for (d, j), t in field.items():
            assert torch.equal(t, full[j * rows:(j + 1) * rows]), (f, d, j)


# ---- routing ----------------------------------------------------------------


def test_other_devices_raise():
    """Neither the plain version nor a kernel runs on a device other than
    the CPU or a card: the wrappers raise."""
    meta = torch.empty((4, 3), dtype=torch.int32, device="meta")
    tables = (meta, meta.float(), meta.to(torch.uint8))
    rng = np.random.default_rng(0)
    ri, rf, ru = _tables(rng, 1, 3, 3, 3)
    with pytest.raises(ValueError, match="meta"):
        kr.table_insert(tables, kr.pack_insert(np.array([1], np.int32),
                                               ri, rf, ru))
    bufs = (torch.empty((4, R), device="meta"),
            torch.empty(4, dtype=torch.bool, device="meta"),
            torch.empty(4, device="meta"),
            torch.empty((4, 2), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="meta"):
        kr.apply_view_delta(bufs, kr.ViewDelta())
