"""Twins of the reference's `tests/test_events.py` (event-broker
semantics under wrap and concurrency, the FSM-sourced cluster broker,
and its separation from the flight recorder), run on the port.

`server/events.py` is the index-long-poll idiom `/v1/scheduler/timeline`
reuses (lib/transfer.DispatchTimeline.records_after), so its contract is
pinned here: indexes are strictly monotonic, `events_after` never
returns a duplicate or an out-of-order event, the bounded ring drops
only the OLDEST events on wrap, and a long-poller wakes on publish
instead of sleeping out its timeout.

`TestAgainstReference` drives the reference's brokers and the port's
with the same publishes, and the reference's `StateStore` and the
port's with the same writes (objects built by the reference's mocks,
wired to the port), and compares the event sequences they give.
"""
import threading
import time

from nomad_tpu_torch.server.events import (Event, EventBroker, TOPIC_JOB,
                                           TOPIC_NODE)

from torch_ops_cases import PACKAGES, REF, as_pkg, mod


def _ev(topic=TOPIC_JOB, key="k", index=0):
    return Event(topic=topic, type="T", key=key, index=index)


class TestRingWrap:
    def test_wrap_keeps_newest_and_stays_monotonic(self):
        b = EventBroker(size=8)
        for i in range(20):
            b.publish(_ev(key=f"k{i}"))
        idx, out = b.events_after(0)
        # only the newest `size` survive; the dropped ones are the oldest
        assert len(out) == 8
        assert [e.key for e in out] == [f"k{i}" for i in range(12, 20)]
        assert [e.index for e in out] == list(range(13, 21))
        assert idx == 20
        assert b.last_index() == 20

    def test_cursor_past_wrap_sees_no_duplicates(self):
        b = EventBroker(size=8)
        for i in range(10):
            b.publish(_ev(key=f"k{i}"))
        idx, first = b.events_after(0)
        cursor = max(e.index for e in first)
        # wrap the ring completely past the cursor
        for i in range(10, 26):
            b.publish(_ev(key=f"k{i}"))
        _, second = b.events_after(cursor)
        seen = [e.index for e in first] + [e.index for e in second]
        assert len(seen) == len(set(seen)), "duplicate event indexes"
        assert seen == sorted(seen), "events out of index order"

    def test_topic_filter_across_wrap(self):
        b = EventBroker(size=6)
        for i in range(12):
            b.publish(_ev(topic=TOPIC_JOB if i % 2 else TOPIC_NODE,
                          key=f"k{i}"))
        _, jobs = b.events_after(0, topics=[TOPIC_JOB])
        assert jobs and all(e.topic == TOPIC_JOB for e in jobs)
        assert [e.index for e in jobs] == sorted(e.index for e in jobs)

    def test_explicit_index_advances_assignment(self):
        """A publisher-supplied index (raft-applied state index) must
        advance the auto-assign floor so later auto events stay above."""
        b = EventBroker(size=8)
        b.publish(_ev(index=100))
        b.publish(_ev())  # auto
        _, out = b.events_after(0)
        assert [e.index for e in out] == [100, 101]


class TestConcurrentPublishLongPoll:
    def test_no_lost_or_duplicated_under_concurrent_publish(self):
        """4 publishers × 50 events race one long-polling consumer: with
        a ring large enough to never wrap past the cursor, every event
        is delivered exactly once and in index order."""
        b = EventBroker(size=4096)
        n_pub, per = 4, 50
        done = threading.Event()

        def pub(p):
            for i in range(per):
                b.publish(_ev(key=f"p{p}-{i}"))

        threads = [threading.Thread(target=pub, args=(p,), daemon=True)
                   for p in range(n_pub)]

        got = []

        def consume():
            cursor = 0
            while True:
                _, out = b.events_after(cursor, timeout=0.2)
                if out:
                    got.extend(out)
                    cursor = max(e.index for e in out)
                elif done.is_set() and len(got) >= n_pub * per:
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
        assert len(got) == n_pub * per
        idxs = [e.index for e in got]
        assert idxs == sorted(idxs), "long-poll returned out of order"
        assert len(set(idxs)) == len(idxs), "duplicated event"
        assert {e.key for e in got} == {
            f"p{p}-{i}" for p in range(n_pub) for i in range(per)}
        # per-publisher order preserved through the global index order
        for p in range(n_pub):
            mine = [e.key for e in got if e.key.startswith(f"p{p}-")]
            assert mine == [f"p{p}-{i}" for i in range(per)]

    def test_long_poll_wakes_on_publish(self):
        b = EventBroker()
        b.publish(_ev())
        idx = b.last_index()

        def later():
            time.sleep(0.15)
            b.publish(_ev(key="late"))

        threading.Thread(target=later, daemon=True).start()
        t0 = time.time()
        _, out = b.events_after(idx, timeout=5.0)
        dt = time.time() - t0
        assert out and out[0].key == "late"
        assert dt < 2.0, f"long-poll slept {dt:.2f}s past the publish"

    def test_long_poll_times_out_empty(self):
        b = EventBroker()
        t0 = time.time()
        idx, out = b.events_after(0, timeout=0.2)
        assert out == [] and time.time() - t0 >= 0.15


# ---- ClusterEventBroker: the FSM-sourced broker extends the
# ring contract with push subscriptions, index resume, and the explicit
# lost-gap marker — loss is ANNOUNCED, never silent ----

import pytest

from nomad_tpu_torch.lib.metrics import MetricsRegistry
from nomad_tpu_torch.server.event_broker import (GAP_TYPE, ClusterEventBroker,
                                           parse_topic_filter)


def _cev(i, topic="Job", type_="JobRegistered", key=None):
    return Event(topic=topic, type=type_, key=key or f"k{i}", index=i)


class TestClusterBrokerContract:
    def test_publish_rejects_names_outside_closed_vocab(self):
        b = ClusterEventBroker()
        with pytest.raises(ValueError):
            b.publish([_cev(1, topic="Gossip")])
        with pytest.raises(ValueError):
            b.publish([_cev(1, type_="JobExploded")])

    def test_topic_filter_grammar_rejects_unknown_topic(self):
        assert parse_topic_filter(None) is None
        assert parse_topic_filter(["*"]) is None
        f = parse_topic_filter(["Eval:*", "Job:web"])
        assert f == {"Eval": {"*"}, "Job": {"web"}}
        with pytest.raises(ValueError):
            parse_topic_filter(["Bogus"])

    def test_wrapped_cursor_gets_gap_marker_not_silence(self):
        """Resume below the evicted range yields a leading lost-gap
        whose resume_from re-anchors the cursor; events after the gap
        arrive exactly once."""
        b = ClusterEventBroker(size=8)
        for i in range(1, 21):
            b.publish([_cev(i)])
        idx, out = b.events_after(0)
        assert out[0].type == GAP_TYPE
        gap = out[0]
        assert gap.payload["lost_through"] == 12
        assert gap.payload["resume_from"] == 12
        live = out[1:]
        assert [e.index for e in live] == list(range(13, 21))
        # resuming from the gap's resume_from is clean: no marker
        _, clean = b.events_after(gap.payload["resume_from"])
        assert [e.index for e in clean] == list(range(13, 21))
        assert all(e.type != GAP_TYPE for e in clean)

    def test_subscription_replays_then_pushes(self):
        b = ClusterEventBroker()
        for i in range(1, 4):
            b.publish([_cev(i)])
        sub = b.subscribe(topics=["Job"], from_index=1)
        first = sub.poll()
        assert [e.index for e in first] == [2, 3]
        b.publish([_cev(4)])
        assert [e.index for e in sub.poll(timeout=2.0)] == [4]
        assert sub.last_delivered == 4
        sub.close()

    def test_live_subscription_starts_at_now(self):
        b = ClusterEventBroker()
        b.publish([_cev(1)])
        sub = b.subscribe()  # from_index=None → live only
        assert sub.poll() == []
        b.publish([_cev(2)])
        assert [e.index for e in sub.poll(timeout=2.0)] == [2]
        sub.close()

    def test_slow_subscriber_evicts_into_gap_and_counts(self):
        """A consumer further behind than its queue bound loses the
        OLDEST events into a gap marker; the loss is metered on
        events.subscriber_evictions and the publish path never
        blocks."""
        m = MetricsRegistry()
        b = ClusterEventBroker()
        b.bind_metrics(m)
        sub = b.subscribe(topics=["Job"], from_index=0, max_pending=4)
        for i in range(1, 11):
            b.publish([_cev(i)])
        out = sub.poll()
        assert out[0].type == GAP_TYPE
        assert out[0].payload["lost_through"] == 6
        assert [e.index for e in out[1:]] == [7, 8, 9, 10]
        assert sub.evictions == 6
        snap = m.snapshot()["counters"]
        assert snap["events.subscriber_evictions"] == 6
        assert snap["events.published"] == 10
        assert snap["events.topic.job"] == 10
        sub.close()

    def test_subscribe_below_evicted_range_leads_with_gap(self):
        b = ClusterEventBroker(size=4)
        for i in range(1, 11):
            b.publish([_cev(i)])
        sub = b.subscribe(topics=["Job"], from_index=0)
        out = sub.poll()
        assert out[0].type == GAP_TYPE
        assert out[0].payload["lost_through"] == 6
        assert [e.index for e in out[1:]] == [7, 8, 9, 10]
        sub.close()

    def test_concurrent_publish_subscribe_evict_no_lost_no_dup(self):
        """Publishers race subscribers while the ring AND per-sub
        queues evict: every subscriber sees a strictly increasing
        index stream where anything missing is covered by a gap
        marker — never silently lost, never duplicated."""
        b = ClusterEventBroker(size=64)
        n = 400
        results = {}

        def consume(tag, max_pending):
            sub = b.subscribe(topics=["Job"], from_index=0,
                              max_pending=max_pending)
            seen, gaps = [], []
            while True:
                out = sub.poll(timeout=0.3)
                if not out:
                    if b.last_index() >= n and not sub._pending:
                        break
                    continue
                for e in out:
                    if e.type == GAP_TYPE:
                        gaps.append(e)
                    else:
                        seen.append(e.index)
            results[tag] = (seen, gaps)
            sub.close()

        threads = [
            threading.Thread(target=consume, args=("fast", 4096),
                             daemon=True),
            threading.Thread(target=consume, args=("slow", 8),
                             daemon=True),
        ]
        for t in threads:
            t.start()

        # publishes are serialized in index order (the store holds its
        # lock across mutate+emit) but come from competing threads
        pub_lock = threading.Lock()
        counter = [0]

        def pub():
            while True:
                with pub_lock:
                    if counter[0] >= n:
                        return
                    counter[0] += 1
                    b.publish([_cev(counter[0])])

        pubs = [threading.Thread(target=pub, daemon=True)
                for _ in range(2)]
        for t in pubs:
            t.start()
        for t in pubs:
            t.join(20.0)
        for t in threads:
            t.join(20.0)
            assert not t.is_alive()
        for tag, (seen, gaps) in results.items():
            assert len(seen) == len(set(seen)), f"{tag}: duplicate"
            assert seen == sorted(seen), f"{tag}: out of order"
            # completeness: every index 1..n is either delivered or
            # inside a gap's lost range
            covered = set(seen)
            for g in gaps:
                covered.update(
                    range(g.payload["requested_index"] + 1,
                          g.payload["lost_through"] + 1))
            missing = set(range(1, n + 1)) - covered
            assert not missing, f"{tag}: silently lost {missing}"

    def test_mark_restored_turns_history_into_gap(self):
        """After a snapshot restore the broker cannot replay history —
        a resume below the restored index must see a deterministic
        lost-gap, not an empty page."""
        b = ClusterEventBroker()
        b.mark_restored(50)
        assert b.last_index() == 50
        idx, out = b.events_after(0)
        assert [e.type for e in out] == [GAP_TYPE]
        assert out[0].payload["resume_from"] == 50
        # at-or-above the restore point: clean empty page
        _, clean = b.events_after(50)
        assert clean == []

    def test_stats_shape(self):
        b = ClusterEventBroker(size=8)
        for i in range(1, 4):
            b.publish([_cev(i, topic="Eval", type_="EvalUpdated")])
        s = b.stats()
        assert s["last_index"] == 3 and s["buffered"] == 3
        assert s["oldest_index"] == 1 and s["subscribers"] == 0
        assert s["buffered_by_topic"]["Eval"] == 3
        assert set(s["buffered_by_topic"]) == {
            "Job", "Eval", "Alloc", "Deployment", "Node", "Plan"}


class TestFlightBrokerSeparation:
    """The flight recorder and the event broker
    stay SEPARATE rings (README "Flight recorder vs event broker") —
    replica-local operational signals are flight-only, replicated state
    transitions are broker-only, and no site books one fact into both
    (the legacy server-side `_publish` double-entry path is gone)."""

    def test_membership_and_leadership_stay_flight_only(self):
        from nomad_tpu_torch.analysis.vocab import (EVENT_TOPICS, EVENT_TYPES,
                                              FLIGHT_TYPES)
        assert {"membership.change", "leadership.gained",
                "leadership.lost"} <= FLIGHT_TYPES
        # the broker's closed taxonomy has NO name for the replica-local
        # signals — they differ per server, so replicating them would
        # break the identical-on-every-replica stream contract
        vocab = {v.lower() for v in EVENT_TOPICS | EVENT_TYPES}
        assert not any("member" in v or "leader" in v or "gossip" in v
                       for v in vocab)
        b = ClusterEventBroker()
        with pytest.raises(ValueError):
            b.publish([_cev(1, topic="Membership", type_="MemberAlive")])

    def test_state_transition_books_into_broker_once_and_not_flight(self):
        """One fact, one ring: a store-applied node registration
        publishes exactly ONE broker event (the emit hook — no second
        server-side publish) and records nothing in the flight ring."""
        import random

        from nomad_tpu_torch.lib.flight import default_flight
        from nomad_tpu_torch.server.state import StateStore
        from nomad_tpu_torch.synth import synth_node

        store = StateStore()
        store.event_broker = b = ClusterEventBroker()
        idx0 = default_flight().last_index()
        node = synth_node(random.Random(3), 0)
        store.upsert_node(node)
        got = [e for e in b.buffered() if e.topic == "Node"]
        assert len(got) == 1
        assert got[0].type in ("NodeRegistered", "NodeUpdated")
        assert got[0].key == node.id
        assert got[0].index == store.index.value
        # flight gained nothing about this node (background threads from
        # other fixtures may record liveness noise — filter by key)
        _, fl = default_flight().records_after(idx0)
        assert not [r for r in fl if getattr(r, "key", None) == node.id]


# ---- the same publishes and writes through the reference and the port ----


def _view(events):
    return [(e.topic, e.type, e.key, e.namespace, e.index,
             {k: v for k, v in sorted(e.payload.items())
              if isinstance(v, (int, str, bool))})
            for e in events]


def _ring(pkg, size, n, every_topic):
    ev = mod(pkg, "server.events")
    b = ev.EventBroker(size=size)
    for i in range(n):
        topic = ev.TOPIC_JOB if i % every_topic else ev.TOPIC_NODE
        b.publish(ev.Event(topic=topic, type="T", key=f"k{i}",
                           index=100 + i if i == n // 2 else 0))
    out = [b.events_after(c) for c in (0, n // 3, b.last_index())]
    jobs = b.events_after(0, topics=[ev.TOPIC_JOB])
    return ([(idx, _view(evs)) for idx, evs in out],
            (jobs[0], _view(jobs[1])), b.last_index())


def _cluster_broker(pkg, size, n, max_pending, restored):
    eb = mod(pkg, "server.event_broker")
    ev = mod(pkg, "server.events")
    b = eb.ClusterEventBroker(size=size)
    if restored:
        b.mark_restored(restored)
    sub = b.subscribe(topics=["Job"], from_index=0, max_pending=max_pending)
    live = b.subscribe(topics=["Eval:*"])
    for i in range(1, n + 1):
        topic, typ = (("Job", "JobRegistered") if i % 3
                      else ("Eval", "EvalUpdated"))
        b.publish([ev.Event(topic=topic, type=typ, key=f"k{i}",
                            index=restored + i)])
    pages = [_view(b.events_after(c)[1]) for c in (0, restored + n // 2)]
    got = (_view(sub.poll()), _view(live.poll()), sub.evictions,
           sub.last_delivered, b.stats(), pages)
    sub.close()
    live.close()
    return got


def _store_stream(pkg, objs):
    """The events a StateStore emits for one object's life each: a node
    registered, drained and removed; a job registered, its eval, an
    alloc placed, run by the client and stopped; a deployment; the job
    deregistered."""
    import copy

    st = mod(pkg, "server.state").StateStore()
    st.event_broker = b = mod(pkg, "server.event_broker").ClusterEventBroker()
    node, job, ev, alloc, dep = (as_pkg(pkg, o) for o in objs)
    st.upsert_node(node)
    st.upsert_job(job)
    st.upsert_eval(ev)
    st.upsert_alloc(alloc)
    upd = copy.copy(alloc)
    upd.client_status = "running"
    st.update_alloc_from_client(upd)
    st.upsert_deployment(dep)
    n2 = copy.copy(node)
    n2.scheduling_eligibility = "ineligible"
    st.upsert_node(n2)
    ev2 = copy.copy(ev)
    ev2.status = "complete"
    st.upsert_eval(ev2)
    st.delete_alloc(alloc.id)
    st.delete_eval(ev.id)
    st.delete_job(job.namespace, job.id)
    st.delete_node(node.id)
    return _view(b.buffered()), st.index.value


class TestAgainstReference:
    @pytest.mark.parametrize("size,n,every_topic", [
        (8, 20, 2), (6, 12, 3), (4096, 200, 5), (1, 3, 2)])
    def test_ring_equals_reference(self, size, n, every_topic):
        ref, got = (_ring(pkg, size, n, every_topic) for pkg in PACKAGES)
        assert got == ref

    @pytest.mark.parametrize("size,n,max_pending,restored", [
        (8, 20, 4096, 0), (64, 40, 4, 0), (4, 10, 8, 0), (16, 12, 3, 50)])
    def test_cluster_broker_equals_reference(self, size, n, max_pending,
                                             restored):
        ref, got = (_cluster_broker(pkg, size, n, max_pending, restored)
                    for pkg in PACKAGES)
        assert got == ref

    def test_state_store_stream_equals_reference(self):
        rm = mod(REF, "mock")
        node = rm.node()
        job = rm.job()
        ev = rm.eval_(job_id=job.id, type=job.type)
        alloc = rm.alloc(job=job, node_id=node.id)
        alloc.job_id = job.id
        dep = mod(REF, "structs.deployment").Deployment(
            id="dep-1", namespace=job.namespace, job_id=job.id,
            job_version=job.version)
        ref, got = (_store_stream(pkg, (node, job, ev, alloc, dep))
                    for pkg in PACKAGES)
        assert got == ref
        topics = {t for t, *_rest in got[0]}
        assert topics == {"Node", "Job", "Eval", "Alloc", "Deployment"}

    @pytest.mark.parametrize("spec", [
        None, ["*"], ["Eval:*", "Job:web"], ["Node"], ["Alloc:a", "Alloc:b"],
        ["Bogus"], ["Job:"], ["Deployment:*", "Plan"]])
    def test_topic_filter_grammar_equals_reference(self, spec):
        def parse(pkg):
            try:
                return mod(pkg, "server.event_broker").parse_topic_filter(spec)
            except ValueError:
                return ValueError

        assert parse("nomad_tpu_torch") == parse(REF)
