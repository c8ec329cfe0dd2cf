"""Twins of the reference's `tests/test_lib.py` (unit tests of the
`lib/` helpers; reference: lib/delayheap, lib/kheap, lib/circbufwriter,
nomad/timetable.go test suites), run on the port's copies.

`TestAgainstReference` drives the reference's helpers and the port's
with the same seeded operation sequences and compares every result.
"""
import random
import threading
import time

import pytest

from nomad_tpu_torch.lib import CircBufWriter, DelayHeap, KHeap, TimeTable

from torch_ops_cases import PACKAGES, mod


class TestDelayHeap:
    def test_push_pop_order(self):
        h = DelayHeap()
        assert h.push("b", 2.0, "B")
        assert h.push("a", 1.0, "A")
        assert h.push("c", 3.0, "C")
        assert len(h) == 3
        assert h.peek().key == "a"
        out = h.pop_expired(2.5)
        assert [i.key for i in out] == ["a", "b"]
        assert len(h) == 1
        assert h.pop_expired(2.5) == []

    def test_duplicate_push_rejected(self):
        h = DelayHeap()
        assert h.push("x", 1.0)
        assert not h.push("x", 2.0)

    def test_update_reschedules(self):
        h = DelayHeap()
        h.push("x", 1.0)
        h.push("y", 2.0)
        assert h.update("x", 5.0)
        assert h.peek().key == "y"
        out = h.pop_expired(10.0)
        assert sorted(i.key for i in out) == ["x", "y"]
        assert len([i for i in out if i.key == "x"]) == 1  # no stale dup

    def test_remove(self):
        h = DelayHeap()
        h.push("x", 1.0)
        assert h.remove("x")
        assert not h.remove("x")
        assert h.peek() is None
        assert h.pop_expired(99.0) == []

    def test_contains(self):
        h = DelayHeap()
        h.push("x", 1.0)
        assert "x" in h and "y" not in h


class TestKHeap:
    def test_top_k_desc(self):
        h = KHeap(3)
        for s in [1.0, 5.0, 3.0, 4.0, 2.0]:
            h.push(s, s)
        assert h.items_desc() == [5.0, 4.0, 3.0]
        assert len(h) == 3

    def test_under_capacity(self):
        h = KHeap(10)
        h.push(2.0, "b")
        h.push(1.0, "a")
        assert h.items_desc() == ["b", "a"]

    def test_equal_scores_keep_earliest(self):
        h = KHeap(2)
        h.push(1.0, "first")
        h.push(1.0, "second")
        h.push(1.0, "third")  # not better than min — dropped
        assert h.items_desc() == ["first", "second"]


class TestCircBufWriter:
    def test_passthrough(self):
        got = []
        w = CircBufWriter(lambda b: got.append(b), size=1024)
        w.write(b"hello ")
        w.write(b"world")
        w.close()
        assert b"".join(got) == b"hello world"

    def test_overrun_drops_oldest(self):
        got = []
        block = threading.Event()

        def sink(b):
            block.wait(5)
            got.append(b)

        w = CircBufWriter(sink, size=8, flush_interval=0.01)
        w.write(b"0123456789abcdef")  # 16 bytes into 8-byte ring
        block.set()
        w.close()
        data = b"".join(got)
        assert data.endswith(b"abcdef")
        assert len(data) <= 8 + 16  # oldest dropped, never more than written
        assert w.dropped_bytes >= 8

    def test_write_after_close_raises(self):
        w = CircBufWriter(lambda b: None)
        w.close()
        try:
            w.write(b"x")
            assert False, "expected ValueError"
        except ValueError:
            pass


class TestTimeTable:
    def test_nearest_index_and_time(self):
        tt = TimeTable(granularity=0.0)
        tt.witness(10, 100.0)
        tt.witness(20, 200.0)
        tt.witness(30, 300.0)
        assert tt.nearest_index(250.0) == 20
        assert tt.nearest_index(99.0) == 0
        assert tt.nearest_index(1000.0) == 30
        assert tt.nearest_time(15) == 100.0
        assert tt.nearest_time(31) == 300.0
        assert tt.nearest_time(5) == 0.0

    def test_granularity_suppresses(self):
        tt = TimeTable(granularity=10.0)
        tt.witness(1, 100.0)
        tt.witness(2, 105.0)  # within granularity — dropped
        tt.witness(3, 111.0)
        assert tt.nearest_index(106.0) == 1
        assert tt.nearest_index(112.0) == 3

    def test_limit_trims(self):
        tt = TimeTable(granularity=0.0, limit=50.0)
        tt.witness(1, 100.0)
        tt.witness(2, 200.0)  # 100 is now older than limit
        assert tt.nearest_index(150.0) == 0  # trimmed away


def test_alloc_metric_populate_score_meta():
    from nomad_tpu_torch.structs.alloc import AllocMetric

    m = AllocMetric()
    for i in range(10):
        m.score_node(f"n{i}", "normalized-score", float(i))
    m.populate_score_meta(k=3)
    assert [sm.node_id for sm in m.score_meta] == ["n9", "n8", "n7"]


# ---- seeded operation sequences through the reference and the port -------


def _delay_ops(pkg, seed):
    rng = random.Random(seed)
    h = mod(pkg, "lib").DelayHeap()
    out = []
    for step in range(200):
        key = f"k{rng.randrange(20)}"
        op = rng.randrange(5)
        if op == 0:
            out.append(("push", h.push(key, rng.uniform(0, 100), step)))
        elif op == 1:
            out.append(("update", h.update(key, rng.uniform(0, 100))))
        elif op == 2:
            out.append(("remove", h.remove(key)))
        elif op == 3:
            out.append(("pop", [(i.key, i.data) for i in
                                h.pop_expired(rng.uniform(0, 60))]))
        else:
            top = h.peek()
            out.append(("peek", None if top is None else top.key,
                        key in h, len(h)))
    return out


def _kheap_ops(pkg, seed, k):
    rng = random.Random(seed)
    h = mod(pkg, "lib").KHeap(k)
    for i in range(50):
        h.push(rng.choice([0.5, 1.0, rng.random()]), i)
    return h.items_desc(), len(h)


def _timetable_ops(pkg, seed):
    rng = random.Random(seed)
    tt = mod(pkg, "lib").TimeTable(granularity=rng.choice([0.0, 5.0]),
                                   limit=rng.choice([None, 300.0]) or 0.0)
    t, idx, out = 100.0, 0, []
    for _ in range(60):
        t += rng.uniform(0, 20)
        idx += rng.randrange(1, 4)
        tt.witness(idx, t)
        probe = rng.uniform(80, t + 20)
        out.append((tt.nearest_index(probe),
                    tt.nearest_time(rng.randrange(0, idx + 3))))
    return out


def _circbuf(pkg, chunks, size):
    got = []
    w = mod(pkg, "lib").CircBufWriter(got.append, size=size)
    for c in chunks:
        w.write(c)
    w.close()
    return b"".join(got)


def _score_meta(pkg, seed, k):
    rng = random.Random(seed)
    m = mod(pkg, "structs.alloc").AllocMetric()
    for i in range(rng.randrange(1, 20)):
        m.score_node(f"n{rng.randrange(15)}", "normalized-score",
                     rng.choice([0.25, 0.5, rng.random()]))
    m.populate_score_meta(k=k)
    return [(sm.node_id, sm.norm_score) for sm in m.score_meta]


class TestAgainstReference:
    @pytest.mark.parametrize("seed", range(4))
    def test_delay_heap_equals_reference(self, seed):
        ref, got = (_delay_ops(pkg, seed) for pkg in PACKAGES)
        assert got == ref

    @pytest.mark.parametrize("seed,k", [(0, 1), (1, 3), (2, 10), (3, 64)])
    def test_kheap_equals_reference(self, seed, k):
        ref, got = (_kheap_ops(pkg, seed, k) for pkg in PACKAGES)
        assert got == ref

    @pytest.mark.parametrize("seed", range(4))
    def test_timetable_equals_reference(self, seed):
        ref, got = (_timetable_ops(pkg, seed) for pkg in PACKAGES)
        assert got == ref

    def test_circbuf_passthrough_equals_reference(self):
        chunks = [bytes([65 + i % 26]) * (1 + i % 7) for i in range(40)]
        ref, got = (_circbuf(pkg, chunks, 4096) for pkg in PACKAGES)
        assert got == ref == b"".join(chunks)

    @pytest.mark.parametrize("seed,k", [(0, 3), (1, 5), (2, 1), (3, 20)])
    def test_score_meta_equals_reference(self, seed, k):
        ref, got = (_score_meta(pkg, seed, k) for pkg in PACKAGES)
        assert got == ref
