"""EvalBroker — priority queue of pending evaluations with at-least-once
delivery.

Behavioral reference: `nomad/eval_broker.go` (EvalBroker :47, Enqueue :181,
Dequeue :329, Ack :531, Nack :595, runDelayedEvalsWatcher :751):

- per-scheduler-type priority heaps of ready evals
- per-(namespace, job) serialization: only one eval of a job outstanding at a
  time; later evals for the same job wait in a per-job pending heap and are
  released on Ack (structs.go:9524 contract — this is what makes whole
  dequeued batches safe to schedule concurrently)
- ack/nack with a nack timeout (auto-requeue on worker death) and a delivery
  limit, after which the eval lands in a `failed-queue` served last
- delayed evals (`wait_until`) sit in a time-ordered heap drained by a
  watcher thread
- `dequeue_batch` drains up to `max_n` ready evals in one
  call — the mega-batch feed for the fused TPU dispatch — partitioned
  into CONFLICT GROUPS by a cheap host-side node-footprint estimate
  (`footprint_fn`, supplied by the server): evals whose footprints are
  disjoint land in different groups (the coordinator runs them as
  parallel wave lanes inside one dispatch), overlapping ones share a
  group in priority order (they ride the sequential conflict-aware
  chain). An adaptive HOLD window lets a loaded queue accumulate
  hundreds of evals per drain while an idle queue keeps single-eval
  latency.
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import fast_uuid
from ..lib import DelayHeap
from ..lib.metrics import MetricsRegistry
from ..lib.tracectx import TraceContext
from ..structs import Evaluation

FAILED_QUEUE = "_failed"
DEFAULT_NACK_TIMEOUT = 5.0
DEFAULT_DELIVERY_LIMIT = 3


class _Unack:
    __slots__ = ("eval", "token", "timer", "dequeues")

    def __init__(self, eval: Evaluation, token: str, dequeues: int) -> None:
        self.eval = eval
        self.token = token
        self.timer: Optional[threading.Timer] = None
        self.dequeues = dequeues


#: counter names mirrored by the legacy `stats` view
_STAT_KEYS = ("enqueued", "dequeued", "acked", "nacked", "failed",
              "requeued")


class EvalBroker:
    def __init__(self, nack_timeout: float = DEFAULT_NACK_TIMEOUT,
                 delivery_limit: int = DEFAULT_DELIVERY_LIMIT,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer=None,
                 footprint_fn: Optional[Callable[[Evaluation],
                                                 Optional[np.ndarray]]]
                 = None) -> None:
        self.nack_timeout = nack_timeout
        self.delivery_limit = delivery_limit
        #: eval → bool[n_cap] node-row footprint estimate (None/raise =
        #: unknown, conflicts with everything). Server-supplied: the
        #: broker itself knows nothing about jobs or nodes. Called
        #: OUTSIDE the broker lock — the estimate reads state/cluster
        #: structures whose mutators may re-enter broker.enqueue.
        self.footprint_fn = footprint_fn
        #: registry-backed telemetry (go-metrics IncrCounter analog);
        #: a standalone broker gets a private registry so unit tests
        #: never cross-count between instances
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer
        self._ctr = {k: self.metrics.counter(f"broker.{k}")
                     for k in _STAT_KEYS}
        # queue-state gauges: created EAGERLY so the exposed
        # series set is deterministic; refreshed by queue_stats() (the
        # metrics scrape path) — depths mutate too often to gauge inline
        self._g_ready = self.metrics.gauge("broker.ready_depth")
        self._g_unacked = self.metrics.gauge("broker.unacked_depth")
        self._g_pending = self.metrics.gauge("broker.pending_depth")
        self._g_delayed = self.metrics.gauge("broker.delayed_depth")
        self._g_oldest = self.metrics.gauge("broker.oldest_eval_age_s")
        self._gauged_queues: set = set()
        #: eval id → wall time it became waitable (ready or job-pending);
        #: cleared on ack / final delivery — feeds the oldest-eval-age
        #: gauges (a growing age under load = the backpressure signal)
        self._enqueue_wall: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._enabled = False
        self._seq = itertools.count()
        # scheduler type -> heap of (-priority, seq, eval)
        self._ready: Dict[str, List[Tuple[int, int, Evaluation]]] = {}
        self._unack: Dict[str, _Unack] = {}
        # (namespace, job_id) -> outstanding eval id
        self._job_outstanding: Dict[Tuple[str, str], str] = {}
        # (namespace, job_id) -> pending heap (evals waiting on serialization)
        self._job_pending: Dict[Tuple[str, str], List[Tuple[int, int, Evaluation]]] = {}
        self._dequeues: Dict[str, int] = {}  # eval id -> delivery count
        # delayed evals, keyed by eval id (reference lib/delayheap via
        # eval_broker.go:751)
        self._delayed = DelayHeap()
        self._delay_thread: Optional[threading.Thread] = None
        self._shutdown = False

    @property
    def stats(self) -> Dict[str, int]:
        """Legacy counter view (now registry-backed, lock-free reads)."""
        return {k: int(c.value) for k, c in self._ctr.items()}

    # ---- lifecycle ----

    def set_enabled(self, enabled: bool) -> None:
        """Leader gate (reference SetEnabled, eval_broker.go:131): flush on
        disable."""
        with self._cv:
            self._enabled = enabled
            if not enabled:
                self._ready.clear()
                self._unack.clear()
                self._job_outstanding.clear()
                self._job_pending.clear()
                self._dequeues.clear()
                self._enqueue_wall.clear()
                self._delayed = DelayHeap()
            else:
                if self._delay_thread is None:
                    self._delay_thread = threading.Thread(
                        target=self._run_delayed_watcher, daemon=True
                    )
                    self._delay_thread.start()
            self._cv.notify_all()

    def shutdown(self) -> None:
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()

    # ---- enqueue ----

    def enqueue(self, eval: Evaluation) -> None:
        with self._cv:
            self._enqueue_locked(eval, token="")

    def enqueue_all(self, evals: Dict[Evaluation, str]) -> None:
        """Reference EnqueueAll (eval_broker.go:198): enqueue with tokens —
        used for requeueing an updated eval while it is still outstanding."""
        with self._cv:
            for eval, token in evals.items():
                self._process_waiting_locked(eval, token)
                self._enqueue_locked(eval, token)

    def _process_waiting_locked(self, eval: Evaluation, token: str) -> None:
        # If outstanding under the same token, drop the outstanding slot so
        # the requeued eval can be dequeued again after Ack.
        un = self._unack.get(eval.id)
        if un is not None and (not token or un.token == token):
            if un.timer is not None:
                un.timer.cancel()
            self._unack.pop(eval.id, None)
            self._job_outstanding.pop((eval.namespace, eval.job_id), None)

    def _enqueue_locked(self, eval: Evaluation, token: str) -> None:
        if not self._enabled:
            return
        if self.tracer is not None:
            # the eval id IS the trace id; (re-)enqueue re-anchors the
            # queue_wait span (nack redeliveries measure their own wait)
            self.tracer.begin(eval.id)
            # distributed binding: the ingress-minted span
            # context rides the Evaluation struct; binding it here
            # parents every phase span this eval records under the
            # submit trace (first bind wins across redeliveries)
            if eval.trace_id and eval.trace_span_id:
                self.tracer.bind(eval.id, TraceContext(
                    eval.trace_id, eval.trace_span_id,
                    eval.trace_parent_span_id))
        now = time.time()
        if eval.wait_until and eval.wait_until > now:
            if not self._delayed.push(eval.id, eval.wait_until, eval):
                self._delayed.update(eval.id, eval.wait_until, eval)
            self._cv.notify_all()
            return
        jk = (eval.namespace, eval.job_id)
        outstanding = self._job_outstanding.get(jk)
        if outstanding is not None and outstanding != eval.id:
            heapq.heappush(
                self._job_pending.setdefault(jk, []),
                (-eval.priority, next(self._seq), eval),
            )
            self._enqueue_wall[eval.id] = now
            return
        queue = FAILED_QUEUE if self._dequeues.get(eval.id, 0) >= self.delivery_limit \
            else eval.type
        heapq.heappush(
            self._ready.setdefault(queue, []),
            (-eval.priority, next(self._seq), eval),
        )
        self._enqueue_wall[eval.id] = now
        self._ctr["enqueued"].inc()
        self._cv.notify_all()

    # ---- dequeue ----

    def dequeue(self, schedulers: Sequence[str], timeout: Optional[float] = None
                ) -> Tuple[Optional[Evaluation], str]:
        """Blocking dequeue of the highest-priority ready eval for any of the
        given scheduler types (reference Dequeue, eval_broker.go:329). The
        failed-queue is eligible for every scheduler (served when nothing
        else is ready)."""
        deadline = time.time() + timeout if timeout is not None else None
        with self._cv:
            while True:
                if self._shutdown:
                    return None, ""
                pick = self._pick_locked(schedulers)
                if pick is not None:
                    return self._deliver_locked(pick)
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.time()
                    if remaining <= 0:
                        return None, ""
                self._cv.wait(remaining if remaining is not None else 1.0)

    def _deliver_locked(self, eval: Evaluation) -> Tuple[Evaluation, str]:
        """Register one picked eval as an outstanding delivery (token,
        unack timer, per-job outstanding slot, counters)."""
        token = fast_uuid()
        count = self._dequeues.get(eval.id, 0) + 1
        self._dequeues[eval.id] = count
        un = _Unack(eval, token, count)
        self._unack[eval.id] = un
        self._job_outstanding[(eval.namespace, eval.job_id)] = eval.id
        if self.nack_timeout > 0:
            un.timer = threading.Timer(
                self.nack_timeout, self._nack_timeout, (eval.id, token)
            )
            un.timer.daemon = True
            un.timer.start()
        self._ctr["dequeued"].inc()
        if self.tracer is not None:
            self.tracer.span_from_mark(eval.id, "enqueue", "queue_wait")
            self.tracer.mark(eval.id, "dequeue")
        return eval, token

    def _pick_locked(self, schedulers: Sequence[str],
                     types: Optional[Sequence[str]] = None
                     ) -> Optional[Evaluation]:
        """`types` (dequeue_batch's batch_types) restricts which eval
        TYPES are pickable — it only bites on the failed queue, which
        holds every type; a scheduler queue's name is its type. A
        type-excluded head leaves its queue untouched this pick (the
        eval behind it is served by later unrestricted dequeues)."""
        best_q, best = None, None
        for q in list(schedulers) + [FAILED_QUEUE]:
            heap = self._ready.get(q)
            # A copy of an eval that is currently outstanding cannot be
            # delivered now, but the signal must not be lost — park it in the
            # per-job pending queue; Ack releases it.
            while heap and heap[0][2].id in self._unack:
                stale = heapq.heappop(heap)
                jk = (stale[2].namespace, stale[2].job_id)
                heapq.heappush(self._job_pending.setdefault(jk, []), stale)
            if not heap:
                continue
            cand = heap[0]
            if types is not None and cand[2].type not in types:
                continue
            jk = (cand[2].namespace, cand[2].job_id)
            out = self._job_outstanding.get(jk)
            if out is not None and out != cand[2].id:
                # Should not happen (serialized at enqueue) — requeue pending.
                heapq.heappop(heap)
                heapq.heappush(self._job_pending.setdefault(jk, []), cand)
                continue
            if best is None or cand[0] < best[0]:
                best_q, best = q, cand
        if best is None:
            return None
        heapq.heappop(self._ready[best_q])
        return best[2]

    # ---- batch dequeue (drain-cadence mega-batching) ----

    def dequeue_batch(self, schedulers: Sequence[str], max_n: int,
                      timeout: Optional[float] = None,
                      hold_s: float = 0.0,
                      batch_types: Optional[Sequence[str]] = None
                      ) -> List[List[Tuple[Evaluation, str]]]:
        """Drain up to `max_n` ready evals as ONE delivery wave,
        partitioned into conflict groups (see `_group_picks`). Blocks up
        to `timeout` for the FIRST eval exactly like `dequeue`; extra
        evals never delay an idle queue beyond that.

        `batch_types` restricts which eval types ride beyond the first
        pick (the worker passes its BATCHABLE_TYPES); a first pick
        outside them returns alone. The failed-queue is eligible for
        every scheduler, exactly as in `dequeue`.

        Eligibility rule (documented contract, mirroring the scan order
        of the reference Dequeue, eval_broker.go:329, with an explicit
        anti-starvation extension): after the first pick, every drained
        batch reserves — WITHIN max_n, and only for evals whose type
        the batch may carry —

          1. one slot for the head of the FAILED queue (if any) — under
             a continuous healthy feed, delivery-limited evals still
             progress one per batch instead of waiting for an idle
             queue (the reference serves them only when nothing else is
             ready, which a loaded mega-batch would starve forever);
          2. one slot for the globally OLDEST ready eval (smallest
             enqueue sequence across the batchable + failed queues) —
             FIFO aging, so a continuous high-priority feed cannot
             starve low-priority evals: every ready eval advances at
             least one seq-rank per drained batch;

        and fills the rest in strict (priority, seq) order. Per-job
        serialization holds across the whole batch: a delivered eval's
        job is outstanding immediately, so a second eval of the same
        job can never ride the same batch.

        `hold_s` is the drain-cadence window: once the greedy drain got
        at least one EXTRA eval (the queue is demonstrably loaded, not
        idle) and the batch is still short of `max_n`, keep draining
        arrivals until the window lapses. The worker sizes the window
        from the measured per-dispatch overhead — waiting is break-even
        when it costs what the merged dispatch saves.
        """
        batch_types = tuple(batch_types) if batch_types else \
            tuple(schedulers)
        deadline = time.time() + timeout if timeout is not None else None
        held_ms = 0.0
        with self._cv:
            picks: List[Tuple[Evaluation, str]] = []
            while True:
                if self._shutdown:
                    return []
                pick = self._pick_locked(schedulers)
                if pick is not None:
                    picks.append(self._deliver_locked(pick))
                    break
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.time()
                    if remaining <= 0:
                        return []
                self._cv.wait(remaining if remaining is not None else 1.0)
            if max_n > 1 and picks[0][0].type in batch_types:
                # fairness slots first (rule above; reserved WITHIN
                # max_n, never in addition to it, and only for types
                # the batch may carry), then priority fill
                queues = list(batch_types) + [FAILED_QUEUE]
                if len(picks) < max_n:
                    head = self._pick_failed_head_locked(batch_types)
                    if head is not None:
                        picks.append(self._deliver_locked(head))
                if len(picks) < max_n:
                    oldest = self._pick_oldest_locked(queues,
                                                      batch_types)
                    if oldest is not None:
                        picks.append(self._deliver_locked(oldest))
                while len(picks) < max_n:
                    pick = self._pick_locked(batch_types,
                                             types=batch_types)
                    if pick is None:
                        break
                    picks.append(self._deliver_locked(pick))
                if hold_s > 0 and len(picks) >= 2:
                    hold_deadline = time.time() + hold_s
                    t_hold = time.time()
                    while len(picks) < max_n and not self._shutdown:
                        pick = self._pick_locked(batch_types,
                                                 types=batch_types)
                        if pick is not None:
                            picks.append(self._deliver_locked(pick))
                            continue
                        remaining = hold_deadline - time.time()
                        if remaining <= 0:
                            break
                        self._cv.wait(remaining)
                    held_ms = (time.time() - t_hold) * 1e3
        # the fairness slots were ADMITTED out of order; the batch's
        # chain order is still strict priority (stable on delivery
        # order within a priority — the aging slot was delivered first
        # among its peers, i.e. in seq order)
        picks.sort(key=lambda it: -it[0].priority)
        groups = self._group_picks(picks)
        self.metrics.inc("drain.drains")
        self.metrics.add_sample("drain.batch_width", len(picks))
        self.metrics.add_sample("drain.groups", len(groups))
        self.metrics.add_sample("drain.hold_ms", held_ms)
        return groups

    def _pick_failed_head_locked(self, batch_types: Sequence[str]
                                 ) -> Optional[Evaluation]:
        """Highest-priority deliverable failed-queue eval whose TYPE
        may ride this batch (the reserved fairness slot of
        `dequeue_batch` — the failed queue holds every type, and a
        non-batchable eval delivered here would demote the whole
        mega-batch to one-by-one processing)."""
        return self._pick_locked((), types=batch_types)

    def _pick_oldest_locked(self, queues: Sequence[str],
                            batch_types: Sequence[str]
                            ) -> Optional[Evaluation]:
        """Deliverable batch-typed ready eval with the smallest enqueue
        sequence across `queues` — the FIFO-aging slot. O(ready) scan;
        stale outstanding copies and serialized same-job evals are
        skipped in place (the normal pick path parks them when it
        meets them)."""
        best_q = best_i = best = None
        for q in queues:
            heap = self._ready.get(q)
            if not heap:
                continue
            for i, item in enumerate(heap):
                ev = item[2]
                if ev.id in self._unack or ev.type not in batch_types:
                    continue
                out = self._job_outstanding.get((ev.namespace, ev.job_id))
                if out is not None and out != ev.id:
                    continue
                if best is None or item[1] < best[1]:
                    best_q, best_i, best = q, i, item
        if best is None:
            return None
        heap = self._ready[best_q]
        heap[best_i] = heap[-1]
        heap.pop()
        heapq.heapify(heap)
        return best[2]

    def _group_picks(self, picks: List[Tuple[Evaluation, str]]
                     ) -> List[List[Tuple[Evaluation, str]]]:
        """Partition delivered picks into conflict groups by node
        footprint. Transitive-overlap merge: two evals share a group
        iff their footprints connect through any chain of overlaps; an
        unknown footprint (None / estimator error) conflicts with
        everything. Groups are ordered by their highest-priority member
        (first pick index) and members keep delivery order, so
        flattening the groups reproduces the priority order a plain
        sequential drain would have delivered.

        Runs WITHOUT the broker lock: the footprint estimator reads
        server state whose mutators re-enter `enqueue`. Footprints are
        drain-time estimates — a node added mid-flight can make two
        "disjoint" evals collide later; the wave dispatch detects
        cross-lane row collisions on device and plan-apply verification
        resolves them, exactly like the reference's optimistic worker
        race (plan_apply.go:437). Never a wrong placement, only a
        retried one."""
        if len(picks) <= 1:
            return [list(picks)] if picks else []
        if self.footprint_fn is None:
            return [list(picks)]
        fps: List[Optional[np.ndarray]] = []
        for ev, _tok in picks:
            try:
                fps.append(self.footprint_fn(ev))
            except Exception:  # noqa: BLE001 — estimate only, never fatal
                fps.append(None)
        groups: List[List[int]] = []
        masks: List[Optional[np.ndarray]] = []  # None = universal

        def _overlap(a, b) -> bool:
            # masks of different lengths come from a row-bucket growth
            # mid-drain; rows past the shorter mask read as False (that
            # estimate predates the new rows, so it cannot target them)
            if a is None or b is None:
                return True
            n = min(a.shape[0], b.shape[0])
            return bool(np.logical_and(a[:n], b[:n]).any())

        def _union(a, b):
            if a is None or b is None:
                return None
            if a.shape[0] < b.shape[0]:
                a, b = b, a
            out = a.copy()
            out[: b.shape[0]] |= b
            return out

        for i, fp in enumerate(fps):
            hit = [gi for gi in range(len(groups))
                   if _overlap(masks[gi], fp)]
            if not hit:
                groups.append([i])
                masks.append(fp if fp is None else fp.astype(bool))
                continue
            # merge every overlapping group (transitive closure), keep
            # the earliest group's position for ordering
            dst = hit[0]
            for gi in reversed(hit[1:]):
                groups[dst].extend(groups[gi])
                masks[dst] = _union(masks[dst], masks[gi])
                del groups[gi]
                del masks[gi]
            groups[dst].append(i)
            groups[dst].sort()
            masks[dst] = _union(masks[dst], fp)
        return [[picks[i] for i in g] for g in groups]

    # ---- ack / nack ----

    def ack(self, eval_id: str, token: str) -> None:
        with self._cv:
            un = self._unack.get(eval_id)
            if un is None or un.token != token:
                raise ValueError(f"token mismatch for eval {eval_id}")
            if un.timer is not None:
                un.timer.cancel()
            del self._unack[eval_id]
            self._dequeues.pop(eval_id, None)
            self._enqueue_wall.pop(eval_id, None)
            jk = (un.eval.namespace, un.eval.job_id)
            if self._job_outstanding.get(jk) == eval_id:
                del self._job_outstanding[jk]
            self._ctr["acked"].inc()
            if self.tracer is not None:
                self.tracer.record(eval_id, "ack")
            # Release the next pending eval of this job (eval_broker.go:560)
            pending = self._job_pending.get(jk)
            if pending:
                _, _, nxt = heapq.heappop(pending)
                if not pending:
                    del self._job_pending[jk]
                self._enqueue_locked(nxt, token="")
            self._cv.notify_all()
        if self.tracer is not None:
            # close the eval's ROOT span (enqueue → ack) outside the
            # broker lock — it lands in the process SpanStore
            self.tracer.emit_root(eval_id)

    def nack(self, eval_id: str, token: str) -> None:
        with self._cv:
            un = self._unack.get(eval_id)
            if un is None or un.token != token:
                raise ValueError(f"token mismatch for eval {eval_id}")
            if un.timer is not None:
                un.timer.cancel()
            del self._unack[eval_id]
            jk = (un.eval.namespace, un.eval.job_id)
            if self._job_outstanding.get(jk) == eval_id:
                del self._job_outstanding[jk]
            self._ctr["nacked"].inc()
            dequeues = self._dequeues.get(eval_id, 0)
            exhausted = dequeues >= self.delivery_limit
            if exhausted:
                self._ctr["failed"].inc()
            else:
                self._ctr["requeued"].inc()
            self._enqueue_locked(un.eval, token="")
            self._cv.notify_all()
        if exhausted:
            # delivery budget exhausted → the eval now waits in the
            # failed queue served last: silent progress loss without a
            # flight event (the soak's "why did this job stall" read)
            from ..lib.flight import default_flight

            try:
                default_flight().record(
                    "broker.eval_failed", key=eval_id,
                    source=un.eval.job_id, severity="warn",
                    detail={"dequeues": dequeues,
                            "type": un.eval.type})
            except Exception:  # noqa: BLE001 — telemetry only
                pass

    def _nack_timeout(self, eval_id: str, token: str) -> None:
        try:
            self.nack(eval_id, token)
        except ValueError:
            pass  # already acked/nacked

    # ---- delayed evals ----

    def _run_delayed_watcher(self) -> None:
        """Reference runDelayedEvalsWatcher (eval_broker.go:751)."""
        while True:
            with self._cv:
                if self._shutdown:
                    return
                now = time.time()
                for item in self._delayed.pop_expired(now):
                    eval = item.data
                    eval.wait_until = 0.0
                    self._enqueue_locked(eval, token="")
                wait = 1.0
                head = self._delayed.peek()
                if head is not None:
                    wait = max(min(head.wait_until - now, 1.0), 0.01)
            time.sleep(wait)

    # ---- introspection ----

    def outstanding(self, eval_id: str, token: str) -> bool:
        """Is this (eval, token) the current outstanding delivery? (reference
        OutstandingReset, eval_broker.go — the plan applier's stale-plan gate)."""
        with self._lock:
            un = self._unack.get(eval_id)
            return un is not None and un.token == token

    def ready_count(self) -> int:
        with self._lock:
            return sum(len(h) for h in self._ready.values())

    def unacked_count(self) -> int:
        with self._lock:
            return len(self._unack)

    def queue_stats(self) -> Dict[str, object]:
        """Queue-state report + gauge refresh: per-scheduler
        ready depth and oldest waiting-eval age, unacked/pending/delayed
        depths. Called from the metrics scrape path (and `operator
        debug`), so a Prometheus poll is enough to watch broker
        backpressure build — depth climbing with age is a starved
        worker pool; depth flat with age climbing is per-job
        serialization head-of-line blocking."""
        now = time.time()
        with self._lock:
            ready = {q: len(h) for q, h in self._ready.items() if h}
            oldest_by_queue: Dict[str, float] = {}
            for q, h in self._ready.items():
                for item in h:
                    t = self._enqueue_wall.get(item[2].id)
                    if t is None:
                        continue
                    age = max(now - t, 0.0)
                    if age > oldest_by_queue.get(q, 0.0):
                        oldest_by_queue[q] = age
            pending = sum(len(v) for v in self._job_pending.values())
            unacked = len(self._unack)
            delayed = len(self._delayed)
            # _gauged_queues bookkeeping stays under the lock: scrapes
            # run concurrently (ThreadingHTTPServer), and a bare set
            # mutated mid-iteration raises
            drained = self._gauged_queues - set(ready)
            self._gauged_queues -= drained
            self._gauged_queues |= set(ready)
        oldest = max(oldest_by_queue.values(), default=0.0)
        self._g_ready.set(sum(ready.values()))
        self._g_unacked.set(unacked)
        self._g_pending.set(pending)
        self._g_delayed.set(delayed)
        self._g_oldest.set(round(oldest, 3))
        # per-scheduler depth gauges; queues that emptied are zeroed so
        # a scrape never reads a stale depth for a drained scheduler
        for q in drained:
            self.metrics.set_gauge(f"broker.ready.{q}", 0)
        for q, n in ready.items():
            self.metrics.set_gauge(f"broker.ready.{q}", n)
        return {
            "ready": dict(sorted(ready.items())),
            "ready_total": sum(ready.values()),
            "unacked": unacked,
            "pending_jobs": pending,
            "delayed": delayed,
            "oldest_eval_age_s": round(oldest, 3),
            "oldest_by_queue": {q: round(a, 3)
                                for q, a in sorted(
                                    oldest_by_queue.items())},
        }
