"""Twins of the reference's `tests/test_flight.py` (flight-recorder ring
semantics), run on the port.

`lib/flight.py` carries the `server/events.py` long-poll contract —
strictly monotonic sequence numbers, no lost or duplicated events under
concurrent record + poll, wrap drops only the oldest, wake on record —
plus the closed event-type vocabulary the operator-debug reader and
dashboards key on. `TestAgainstReference` records the same sequences in
the reference's recorder and the port's and compares what each returns
(every field but the wall-clock stamp), its counts and the registry
counters it mirrors.
"""
import threading
import time

import pytest

from nomad_tpu_torch.lib.flight import (FLIGHT_TYPES, FlightRecorder,
                                  default_flight)
from nomad_tpu_torch.lib.metrics import MetricsRegistry

from torch_ops_cases import PACKAGES, mod


class TestVocabulary:
    def test_unknown_type_rejected(self):
        fr = FlightRecorder()
        with pytest.raises(ValueError):
            fr.record("not.a.type")

    def test_bad_severity_rejected(self):
        fr = FlightRecorder()
        with pytest.raises(ValueError):
            fr.record("plan.partial", severity="fatal")

    def test_every_vocabulary_type_records(self):
        fr = FlightRecorder()
        for t in sorted(FLIGHT_TYPES):
            fr.record(t, key="k")
        _, out = fr.records_after(0)
        assert {e["type"] for e in out} == set(FLIGHT_TYPES)
        assert fr.counts() == {t: 1 for t in FLIGHT_TYPES}

    def test_vocabulary_frozen(self):
        """The closed vocabulary IS the operator contract — extending it
        must be a deliberate act (update this set in the same PR)."""
        assert FLIGHT_TYPES == {
            "leadership.gained", "leadership.lost", "raft.term",
            "plan.partial", "broker.eval_failed", "heartbeat.expired",
            "error.streak", "hbm.stuck_lease", "wave.collisions",
            "membership.change", "spec.rollback", "slo.burn",
        }


class TestRing:
    def test_wrap_keeps_newest_and_stays_monotonic(self):
        fr = FlightRecorder(capacity=8)
        for i in range(20):
            fr.record("plan.partial", key=f"k{i}")
        idx, out = fr.records_after(0)
        assert len(out) == 8
        assert [e["key"] for e in out] == [f"k{i}" for i in range(12, 20)]
        assert [e["seq"] for e in out] == list(range(13, 21))
        assert idx == 20 and fr.last_index() == 20
        # lifetime counts survive ring eviction
        assert fr.counts() == {"plan.partial": 20}

    def test_cursor_past_wrap_sees_no_duplicates(self):
        fr = FlightRecorder(capacity=8)
        for i in range(10):
            fr.record("heartbeat.expired", key=f"k{i}")
        _, first = fr.records_after(0)
        cursor = max(e["seq"] for e in first)
        for i in range(10, 26):
            fr.record("heartbeat.expired", key=f"k{i}")
        _, second = fr.records_after(cursor)
        seen = [e["seq"] for e in first] + [e["seq"] for e in second]
        assert len(seen) == len(set(seen)), "duplicate event seqs"
        assert seen == sorted(seen), "events out of seq order"

    def test_type_filter(self):
        fr = FlightRecorder()
        fr.record("plan.partial", key="a")
        fr.record("leadership.gained", key="b")
        fr.record("plan.partial", key="c")
        _, out = fr.records_after(0, types=["plan.partial"])
        assert [e["key"] for e in out] == ["a", "c"]

    def test_snapshot_limit(self):
        fr = FlightRecorder()
        for i in range(10):
            fr.record("raft.term", key=f"k{i}")
        snap = fr.snapshot(limit=3)
        assert [e["key"] for e in snap] == ["k7", "k8", "k9"]

    def test_registry_mirror(self):
        reg = MetricsRegistry()
        fr = FlightRecorder(registry=reg)
        fr.record("wave.collisions")
        fr.record("wave.collisions")
        fr.record("error.streak")
        ctrs = reg.snapshot()["counters"]
        assert ctrs["flight.events"] == 3
        assert ctrs["flight.type.wave.collisions"] == 2
        assert ctrs["flight.type.error.streak"] == 1


class TestConcurrentRecordLongPoll:
    def test_no_lost_or_duplicated_under_concurrent_record(self):
        """4 recorders × 50 events race one long-polling consumer: with
        a ring large enough to never wrap past the cursor, every event
        is delivered exactly once and in seq order (the events.py
        gate, applied to the ring the operator debug bundle reads)."""
        fr = FlightRecorder(capacity=4096)
        n_rec, per = 4, 50
        done = threading.Event()

        def rec(p):
            for i in range(per):
                fr.record("plan.partial", key=f"p{p}-{i}")

        threads = [threading.Thread(target=rec, args=(p,), daemon=True)
                   for p in range(n_rec)]
        got = []

        def consume():
            cursor = 0
            while True:
                _, out = fr.records_after(cursor, timeout=0.2)
                if out:
                    got.extend(out)
                    cursor = max(e["seq"] for e in out)
                elif done.is_set() and len(got) >= n_rec * per:
                    return

        c = threading.Thread(target=consume, daemon=True)
        c.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(10.0)
        done.set()
        c.join(10.0)
        assert not c.is_alive()
        assert len(got) == n_rec * per
        seqs = [e["seq"] for e in got]
        assert seqs == sorted(seqs), "long-poll returned out of order"
        assert len(set(seqs)) == len(seqs), "duplicated event"
        assert {e["key"] for e in got} == {
            f"p{p}-{i}" for p in range(n_rec) for i in range(per)}
        # per-recorder order preserved through the global seq order
        for p in range(n_rec):
            mine = [e["key"] for e in got
                    if e["key"].startswith(f"p{p}-")]
            assert mine == [f"p{p}-{i}" for i in range(per)]

    def test_long_poll_wakes_on_record(self):
        fr = FlightRecorder()
        fr.record("raft.term")
        idx = fr.last_index()

        def later():
            time.sleep(0.15)
            fr.record("leadership.gained", key="late")

        threading.Thread(target=later, daemon=True).start()
        t0 = time.time()
        _, out = fr.records_after(idx, timeout=5.0)
        dt = time.time() - t0
        assert out and out[0]["key"] == "late"
        assert dt < 2.0, f"long-poll slept {dt:.2f}s past the record"

    def test_long_poll_times_out_empty(self):
        fr = FlightRecorder()
        t0 = time.time()
        _, out = fr.records_after(10**9, timeout=0.2)
        assert out == [] and time.time() - t0 >= 0.15


class TestDefaultRecorder:
    def test_process_global_singleton_with_registry(self):
        from nomad_tpu_torch.lib.metrics import default_registry

        fr = default_flight()
        assert fr is default_flight()
        before = default_registry().counter("flight.events").value
        fr.record("membership.change", key="m.test")
        assert default_registry().counter("flight.events").value \
            == before + 1


# ---- the same records through the reference's recorder and the port's ----


def _recorded(pkg, capacity, plan):
    fl = mod(pkg, "lib.flight")
    reg = mod(pkg, "lib.metrics").MetricsRegistry()
    fr = fl.FlightRecorder(capacity=capacity, registry=reg)
    rejected = []
    for i, (typ, sev) in enumerate(plan):
        try:
            fr.record(typ, key=f"k{i}", source="s", severity=sev,
                      detail={"i": i})
        except ValueError:
            rejected.append(i)

    def strip(recs):
        return [{k: v for k, v in r.items() if k != "time_unix"}
                for r in recs]

    idx, out = fr.records_after(0)
    _, planned = fr.records_after(len(plan) // 2,
                                  types=["plan.partial", "raft.term"])
    return (idx, strip(out), strip(planned), strip(fr.snapshot(limit=3)),
            fr.counts(), fr.last_index(), rejected,
            reg.snapshot()["counters"])


class TestAgainstReference:
    @pytest.mark.parametrize("capacity", [2, 8, 4096])
    def test_records_equal_reference(self, capacity):
        types = sorted(mod("nomad_tpu", "lib.flight").FLIGHT_TYPES)
        plan = [(types[i % len(types)], "warn" if i % 4 == 0 else "info")
                for i in range(40)]
        plan[7] = ("not.a.type", "info")
        plan[11] = ("plan.partial", "fatal")
        ref, got = (_recorded(pkg, capacity, plan) for pkg in PACKAGES)
        assert got == ref
        assert got[6] == [7, 11]

    def test_vocabulary_equals_reference(self):
        assert FLIGHT_TYPES == mod("nomad_tpu", "lib.flight").FLIGHT_TYPES
