"""Batched select dispatch — the control plane's road onto the chain and
wave placement kernels.

Counterpart of the reference package's `server/select_batch.py`. One
worker drains a batch of evals from the broker and runs each eval's
scheduler in a short-lived thread; this coordinator fuses their
`TorchStack.select` runs into chain dispatches (`place_table_chain`,
kernels/placement.py): program b of a chain places against the
(used, dyn_free) carry of programs 0..b-1, so a batch cannot over-commit
a node.

Determinism: programs chain in the evals' broker-drain order (each
request carries its batch position), so within a dispatch a batched
server places exactly what a sequential one would, regardless of thread
timing. Later rounds (multi-TG jobs, refresh retries) place against the
view at dispatch time; cross-round conflicts fall to plan-apply
verification like the reference's optimistic worker race.

Rendezvous protocol: scheduler threads park in `select()`; the
coordinator dispatches when every live thread is parked or when a short
window expires, until every thread has finished.

Pipelined dispatch: a dispatch packs first, resolves the device view at
the last instant, launches, and releases its waiters with LAZY outputs
(`_BatchOut`). On a card the launch records a CUDA event on the
coordinator thread's current stream; the first waiter to resolve waits
on it and copies the outputs to the host. On the CPU the plain versions
have already run when the waiters are released.

Transport: programs whose static half fits the device program table
(`server/program_table.py`) dispatch as table row indices plus small
dynamic rows; the rest ride the packed transport (`place_packed_chain`)
or, alone, the single-program kernel. Broker conflict groups with
disjoint node footprints run as parallel lanes of one wave dispatch
(`place_table_wave`), whose lane carries fold by an exact per-row lane
select; a cross-lane collision (stale footprint) is counted on the
device and plan-apply verification resolves it.

Carry and speculation: a table dispatch notes its device (used,
dyn_free) carry on the view cache (`note_dispatch_carry`, predicted rows
filled when its outputs land), so the next refresh can adopt it. It then
offers the NEXT batch's coordinator a speculative launch against that
carry (`_offer_spec` → `try_spec_launch`), which queues behind it on the
device's stream while this batch's plans commit; the successor certifies
at the top of its own `run()` against the chain's stale rows
(`_certify_spec`) and re-dispatches only the lane suffixes a conflicting
commit touched.

Leases: every dispatch that resolves a cluster-bound view leases it until
its outputs are on the host (`scheduler/stack.py` writes a leased view's
tensors never, only copies of them).
"""
from __future__ import annotations

import os
import threading
import time
import weakref
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils import bucket as _bucket

# ---- speculative wave dispatch ---------------------------------------------
# Launch batch k+1's fused dispatch against the PREDICTED post-commit
# view (scheduler/stack.py spec_chain_view — the predecessor's chain
# carry over the base tensors) while batch k's plans are still
# committing; CERTIFY at commit time against the chain's stale-row set
# and keep only the program slices whose node footprints a conflicting
# commit provably did not touch — those are bit-identical to sequential
# dispatch. Everything else re-dispatches against the committed view.

#: hard opt-out: NOMAD_TPU_SPECULATE=0 disables speculative launches
SPECULATE_ENV = "NOMAD_TPU_SPECULATE"
#: how long a predecessor dispatch waits for the successor batch's
#: round-1 rendezvous before giving up on speculation (ms). The wait
#: runs on the coordinator thread while the predecessor's plans commit
#: on waiter threads — time that is otherwise the dispatch bubble.
SPEC_PARK_ENV = "NOMAD_TPU_SPEC_PARK_MS"
#: adaptive gate: disarm speculation when the rolled-back share of
#: recent launches exceeds this (a misprediction storm must degrade to
#: the plain pipelined path, not thrash re-dispatches)
SPEC_ROLLBACK_MAX_ENV = "NOMAD_TPU_SPEC_ROLLBACK_MAX"


def spec_enabled() -> bool:
    return os.environ.get(SPECULATE_ENV, "1").strip().lower() \
        not in ("0", "off", "false")


def _spec_park_s() -> float:
    try:
        return max(float(os.environ.get(SPEC_PARK_ENV, "30")), 0.0) / 1e3
    except ValueError:
        return 0.03


class SpecGate:
    """Adaptive speculation gate: a sliding window of launch outcomes;
    when the rolled-back share exceeds the threshold the gate disarms
    for a cooldown of skipped opportunities, then re-arms with a clean
    window (churn may have passed). Consecutive failed LAUNCH ATTEMPTS
    (rendezvous timeouts, residency misses) disarm it the same way — a
    host where the successor batch never parks in time must stop
    paying the park wait, not retry it per dispatch. One gate per
    cluster, shared by every coordinator batch that dispatches against
    it."""

    WINDOW = 16
    MIN_SAMPLES = 8
    COOLDOWN = 8
    MISS_LIMIT = 3

    def __init__(self, threshold: Optional[float] = None) -> None:
        if threshold is None:
            try:
                threshold = float(
                    os.environ.get(SPEC_ROLLBACK_MAX_ENV, "0.5"))
            except ValueError:
                threshold = 0.5
        self.threshold = min(max(threshold, 0.0), 1.0)
        self._lock = threading.Lock()
        self._outcomes: "deque[int]" = deque(maxlen=self.WINDOW)
        self._cooldown = 0
        self._misses = 0

    def armed(self) -> bool:
        with self._lock:
            if self._cooldown > 0:
                self._cooldown -= 1
                if self._cooldown == 0:
                    self._outcomes.clear()  # re-arm with a clean window
                return False
            o = self._outcomes
            if len(o) >= self.MIN_SAMPLES \
                    and sum(o) / len(o) > self.threshold:
                self._cooldown = self.COOLDOWN
                return False
            return True

    def record(self, rolled_back: bool) -> None:
        with self._lock:
            self._outcomes.append(1 if rolled_back else 0)
            self._misses = 0  # a real launch happened

    def record_miss(self) -> None:
        """A launch attempt paid its wait and produced nothing."""
        with self._lock:
            self._misses += 1
            if self._misses >= self.MISS_LIMIT:
                self._misses = 0
                self._cooldown = self.COOLDOWN


#: cluster → SpecGate (weak: gates die with their cluster)
_SPEC_GATES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_SPEC_GATES_LOCK = threading.Lock()


def _gate_for(cluster) -> SpecGate:
    with _SPEC_GATES_LOCK:
        g = _SPEC_GATES.get(cluster)
        if g is None:
            g = _SPEC_GATES[cluster] = SpecGate()
        return g


class _SelectReq:
    __slots__ = ("arrays_fn", "params", "n_place", "order", "explain",
                 "event", "out", "err")

    def __init__(self, arrays_fn, params, n_place: int, order: int,
                 explain: bool = False) -> None:
        #: zero-arg callable returning the CURRENT device cluster view
        #: (TorchStack.device_arrays) — resolved at dispatch time,
        #: because the predecessor batch's plans commit between park and
        #: dispatch
        self.arrays_fn = arrays_fn
        self.params = params
        self.n_place = n_place
        self.order = order
        #: request wants PlacementExplain outputs; a fused dispatch runs
        #: with explain when ANY of its programs asked
        self.explain = explain
        self.event = threading.Event()
        #: (_BatchOut, program index | None, dispatch token | None)
        self.out: Optional[Tuple] = None
        self.err: Optional[BaseException] = None


class _BatchOut:
    """Shared lazy holder for one dispatch's device outputs: the first
    accessor waits for the launch to land, copies the outputs to the
    host and fires `on_first_resolve` with the numpy tuple (kernel span,
    timeline and fetch-ledger attribution); everyone else reuses the
    numpy copy.

    On a card, construction records a CUDA event on the current stream
    (the stream the launch went to — construct right after the launch,
    on the launching thread); `resolve` waits on that event before the
    copy. On the CPU the outputs are already computed."""

    __slots__ = ("_dev", "_np", "_lock", "_on_first", "_event")

    def __init__(self, dev: Tuple, on_first_resolve=None) -> None:
        self._dev = dev
        self._np = None
        self._lock = threading.Lock()
        self._on_first = on_first_resolve
        self._event = None
        if dev and dev[0].device.type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(dev[0].device))
        # residency ledger: the lazy device outputs are live from launch
        # until the first resolver materializes them
        from ..lib.hbm import default_hbm

        hbm = default_hbm()
        for leaf in dev:
            hbm.track("select_batch.batch_out", leaf)

    def resolve(self) -> Tuple:
        with self._lock:
            if self._np is None:
                if self._event is not None:
                    self._event.synchronize()
                self._np = tuple(x.cpu().numpy() for x in self._dev)
                # dropping the device refs frees the outputs; the
                # residency bookings release with them
                self._dev = None
                if self._on_first is not None:
                    cb, self._on_first = self._on_first, None
                    cb(self._np)
            return self._np


def _device_of(reqs, resolved, key) -> torch.device:
    """The device a group dispatches on: its stack's, or the resolved
    view's for bare-arrays callers."""
    owner = getattr(reqs[0].arrays_fn, "__self__", None)
    dev = getattr(owner, "device", None)
    if dev is not None:
        return dev
    return resolved[key].used.device


class SelectCoordinator:
    """Fuses concurrent select dispatches from one eval batch."""

    #: floor on wave width: fewer lanes than this and the dispatch just
    #: rides the sequential chain
    _MIN_WAVE_LANES = 2

    def __init__(self, window_s: float = 0.004, tracer=None,
                 timeline=None, registry=None) -> None:
        self._cv = threading.Condition()
        self._live = 0
        self._parked: List[_SelectReq] = []
        self.window_s = window_s
        # stats: the coordinator-driving worker thread writes most keys
        # in _dispatch; kernel_ms is attributed by whichever WAITER
        # materializes a dispatch's outputs first, so those increments go
        # through _stats_lock
        self._stats_lock = threading.Lock()
        self.stats = {"dispatches": 0, "programs": 0, "batched": 0,
                      "dispatch_ms": 0.0, "view_ms": 0.0, "pack_ms": 0.0,
                      "kernel_ms": 0.0, "pack_bytes": 0}
        #: eval-lifecycle tracer + program-order → eval-id map (worker
        #: fills trace_ids in start_batch) for per-eval pack/kernel spans
        self.tracer = tracer
        self.trace_ids: Dict[int, str] = {}
        #: program-order → broker conflict-group id (worker fills in
        #: start_batch from dequeue_batch's footprint partition); absent
        #: orders conflict with everything
        self.group_ids: Dict[int, int] = {}
        #: program-order → bool[n_cap] node-footprint mask (worker fills
        #: from Server._eval_footprint); certification intersects these
        #: with the chain's stale rows — absent/None conflicts with
        #: every stale row, so the program rolls back on ANY conflicting
        #: commit (always sound, never fast)
        self.footprints: Dict[int, Optional[np.ndarray]] = {}
        #: the NEXT batch's coordinator (worker wires it before driving
        #: this one): offered a speculative launch the moment this
        #: batch's fused dispatch (or certified speculation) has a
        #: chain carry to predict from
        self.successor: Optional["SelectCoordinator"] = None
        #: pending speculative dispatch awaiting certification (set by
        #: _dispatch_table(spec=True) on the predecessor's thread,
        #: consumed at the top of run())
        self._spec: Optional[dict] = None
        self._ran = False
        #: server metrics registry for the wave.* instruments (None for
        #: bare coordinators in tests — wave stats still land in .stats)
        self.registry = registry
        #: dispatch-pipeline timeline (lib/transfer.DispatchTimeline,
        #: server-owned); None for bare coordinators in tests
        self.timeline = timeline

    # ---- scheduler-thread side ----

    def add_thread(self) -> None:
        with self._cv:
            self._live += 1

    def thread_done(self) -> None:
        with self._cv:
            self._live -= 1
            self._cv.notify_all()

    def select(self, arrays_fn, params, n_place: int, order: int = 0,
               explain: bool = False):
        """Park until the coordinator dispatches this program. Returns
        (sel_rows i32[M], scores f32[M], nodes_feasible int,
        nodes_fit i32[M], explain PlacementExplain|None — numpy leaves,
        this program's slice — plus the dispatch token, None off the
        table path). Materialization happens HERE, on the waiter thread:
        this blocks until the dispatch has landed."""
        req = _SelectReq(arrays_fn, params, n_place, order, explain)
        with self._cv:
            self._parked.append(req)
            self._cv.notify_all()
        req.event.wait()
        if req.err is not None:
            raise req.err
        holder, i, token = req.out
        out = holder.resolve()
        sel, score, feas, fit = out[:4]
        # a fused dispatch runs with explain when ANY program asked; a
        # program that opted out gets none. Slice the explain leaves by
        # FIELD COUNT: a wave dispatch appends its collision count.
        ex_leaves = ()
        if explain and len(out) > 4:
            from ..kernels.placement import PlacementExplain

            ex_leaves = out[4:4 + len(PlacementExplain._fields)]
        ex = None
        if i is None:
            if ex_leaves:
                from ..kernels.placement import PlacementExplain

                ex = PlacementExplain(*ex_leaves)
            return sel, score, int(feas), fit, ex, token
        if ex_leaves:
            from ..kernels.placement import PlacementExplain

            ex = PlacementExplain(*(leaf[i] for leaf in ex_leaves))
        return sel[i], score[i], int(feas[i]), fit[i], ex, token

    # ---- coordinator side (the worker's batch thread) ----

    def run(self) -> None:
        """Dispatch parked programs until all scheduler threads finish.

        Round 1 is a STRICT rendezvous: before the first dispatch no
        thread can be blocked anywhere but here, so waiting for every
        live thread yields one full-width chain. Later rounds use a
        short window — batch-mates may be busy applying plans.

        When the batch was already launched SPECULATIVELY by the
        predecessor's coordinator (self._spec), the first act is
        certification: by the time the worker drives this coordinator,
        every predecessor plan has committed, so the chain's stale-row
        set is final for the speculative launch — certified program
        slices release with their speculative results, rolled-back ones
        re-dispatch against the committed view."""
        self._ran = True
        first = True
        if self._spec is not None:
            spec, self._spec = self._spec, None
            first = False  # round-1 rendezvous already happened
            try:
                self._certify_spec(spec)
            except BaseException as e:  # noqa: BLE001 — fail the waiters
                for r in spec["reqs"]:
                    if not r.event.is_set():
                        r.err = e
                        r.event.set()
        while True:
            with self._cv:
                deadline = None
                while True:
                    if self._parked:
                        if len(self._parked) >= self._live:
                            break
                        window = 0.1 if first else self.window_s
                        if deadline is None:
                            deadline = time.time() + window
                        remaining = deadline - time.time()
                        if remaining <= 0:
                            break
                        self._cv.wait(remaining)
                    else:
                        if self._live == 0:
                            return
                        deadline = None
                        self._cv.wait(0.05)
                batch, self._parked = self._parked, []
                first = False
            try:
                self._dispatch(batch)
            except BaseException as e:  # noqa: BLE001 — fail the waiters
                for r in batch:
                    if not r.event.is_set():
                        r.err = e
                        r.event.set()

    def _dispatch(self, batch: List[_SelectReq]) -> None:
        from ..convert import params_from_numpy, to_device_async
        from ..kernels.placement import (pack_params, place_packed_chain,
                                         place_task_group)
        from ..lib.transfer import default_ledger, guard_scope
        from ..parallel.pad import pad_params, stack_params
        from ..scheduler import stack as stack_mod

        led = default_ledger()
        t_start = time.perf_counter()
        # stats use perf_counter; trace spans use the monotonic clock —
        # bridge with a one-shot offset so both read the same instants
        _off = time.monotonic() - t_start

        def _mono(t: float) -> float:
            return t + _off

        self.stats["dispatches"] += 1
        self.stats["programs"] += len(batch)
        # group by owning CLUSTER without resolving the device view yet
        # (the view is resolved once per group, after the host pack). An
        # arrays_fn that is not a cluster-bound method is resolved HERE
        # and grouped by its view's capacity tensor.
        groups: Dict[tuple, List[_SelectReq]] = {}
        resolved: Dict[tuple, object] = {}
        for r in batch:
            owner = getattr(r.arrays_fn, "__self__", None)
            cluster = getattr(owner, "cluster", None)
            if cluster is not None:
                key = ("cluster", id(cluster))
            else:
                a = r.arrays_fn()
                key = ("arrays", id(a.capacity))
                resolved[key] = a
            groups.setdefault(key, []).append(r)
        _kernel_done = self._kernel_done_factory(led, _mono)

        for key, reqs in groups.items():
            reqs.sort(key=lambda r: r.order)
            want_ex = any(r.explain for r in reqs)
            dev = _device_of(reqs, resolved, key)
            # device-resident table path first; falls back to the packed
            # or single transport on residency ceilings, caps flush races,
            # an active device mesh (the view is node-sharded: the packed
            # and single routes reach the sharded chain, B10, and single
            # program, B11, through its type) or coordinator-less (bare
            # arrays) callers
            cluster = None
            if key[0] == "cluster":
                from ..parallel.mesh import get_active_mesh

                owner = getattr(reqs[0].arrays_fn, "__self__", None)
                cluster = getattr(owner, "cluster", None)
                if get_active_mesh() is None and self._dispatch_table(
                        reqs, cluster, dev, want_ex, led, _mono,
                        _kernel_done):
                    continue
            # a cluster-bound view is leased until the outputs are on
            # the host (released by the resolver callback, or below on a
            # failed launch); a bare-arrays caller owns its view
            token = (next(stack_mod._DISPATCH_TOKENS)
                     if cluster is not None else None)
            if len(reqs) == 1:
                r = reqs[0]
                tv = time.perf_counter()
                try:
                    with led.scope() as moved:
                        arrays = resolved.get(key) or self._resolve(
                            r, token)
                    tk = time.perf_counter()
                    self.stats["view_ms"] += (tk - tv) * 1e3
                    self._trace([r], "delta_apply", _mono(tv), _mono(tk))
                    (p,), m = pad_params([r.params])
                    res = place_task_group(arrays, params_from_numpy(p, dev),
                                           m, explain=want_ex)
                except BaseException:
                    if cluster is not None:
                        stack_mod.release_view(cluster, token)
                    raise
                seq = 0
                if self.timeline is not None:
                    seq = self.timeline.commit(
                        programs=1, batched=False,
                        pack=(_mono(tv), _mono(tv)),
                        view=(_mono(tv), _mono(tk)),
                        kernel_start=_mono(tk),
                        transfer_bytes=moved[0], transfer_count=moved[1],
                        traces=self._dist_traces([r]))
                out = (res.sel_idx, res.sel_score, res.nodes_feasible,
                       res.nodes_fit)
                if res.explain is not None:
                    out = out + tuple(res.explain)
                r.out = (_BatchOut(out, _kernel_done(
                    [r], tk, seq, cluster=cluster, token=token,
                    carry=False)), None, None)
                r.event.set()
                continue
            self.stats["batched"] += len(reqs)
            params_list = [r.params for r in reqs]
            # pad the program axis to a power of two with inert programs
            # (n_place=0, no deltas), as the reference does
            b = _bucket(len(reqs), lo=2)
            if b > len(reqs):
                pad = _inert_program(params_list[0])
                params_list = params_list + [pad] * (b - len(reqs))
            t0 = time.perf_counter()
            stacked, m = stack_params(params_list)
            # packed transport: one buffer per dtype class
            ibuf, fbuf, ubuf, spec = pack_params(stacked)
            t1 = time.perf_counter()
            self.stats["pack_ms"] += (t1 - t0) * 1e3
            self._trace(reqs, "pack", _mono(t0), _mono(t1))
            with guard_scope():
                nb = ibuf.nbytes + fbuf.nbytes + ubuf.nbytes
                with led.timed("select_batch.pack_buffers", nb, count=3):
                    dibuf = to_device_async(ibuf, dev)
                    dfbuf = to_device_async(fbuf, dev)
                    dubuf = to_device_async(ubuf, dev)
                self.stats["pack_bytes"] += nb
                t2 = time.perf_counter()
                # view AFTER pack, at the last instant before the kernel
                try:
                    with led.scope() as moved:
                        arrays = resolved.get(key) or self._resolve(
                            reqs[0], token)
                    tv = time.perf_counter()
                    self.stats["view_ms"] += (tv - t2) * 1e3
                    self._trace(reqs, "delta_apply", _mono(t2), _mono(tv))
                    dev_out = place_packed_chain(arrays, dibuf, dfbuf,
                                                 dubuf, spec, m,
                                                 explain=want_ex)
                except BaseException:
                    if cluster is not None:
                        stack_mod.release_view(cluster, token)
                    raise
            seq = 0
            if self.timeline is not None:
                seq = self.timeline.commit(
                    programs=len(reqs), batched=True,
                    pack=(_mono(t0), _mono(t1)),
                    upload=(_mono(t1), _mono(t2)),
                    view=(_mono(t2), _mono(tv)),
                    kernel_start=_mono(tv),
                    transfer_bytes=nb + moved[0],
                    transfer_count=3 + moved[1],
                    traces=self._dist_traces(reqs))
            out = _BatchOut(tuple(dev_out), _kernel_done(
                reqs, tv, seq, cluster=cluster, token=token, carry=False))
            # release waiters at LAUNCH: each materializes the shared
            # output as the chain lands
            for i, r in enumerate(reqs):
                r.out = (out, i, None)
                r.event.set()
        self.stats["dispatch_ms"] += (time.perf_counter() - t_start) * 1e3

    @staticmethod
    def _resolve(req, token):
        """The request's current view, leased to `token` when given."""
        if token is None:
            return req.arrays_fn()
        return req.arrays_fn(lease_token=token)

    def _kernel_done_factory(self, led, _mono):
        """Resolver-callback factory shared by every dispatch route and
        the speculative one (`_dispatch_spec`) — ONE body, so the
        kernel-land bookkeeping (stats, trace, fetch ledger, timeline,
        collision flight event, carry prediction, lease release) can
        never drift between them. `carry=False` (the packed and single
        transports) releases the lease and notes no carry."""

        def _kernel_done(reqs, t_launch, seq, cluster=None, token=None,
                         idxs=None, wave=False, spec_state=None,
                         carry=True):
            def cb(np_out):
                t_end = time.perf_counter()
                with self._stats_lock:
                    self.stats["kernel_ms"] += (t_end - t_launch) * 1e3
                if spec_state is not None:
                    # certification reads this to account the wasted
                    # share of a rolled-back speculative kernel
                    spec_state["kernel_ms"] = (t_end - t_launch) * 1e3
                self._trace(reqs, "kernel", _mono(t_launch), _mono(t_end))
                # the device→host fetch happened on the first resolver's
                # thread: credit it to the timeline and the fetch site
                fetch = sum(int(getattr(a, "nbytes", 0)) for a in np_out)
                led.record("select_batch.fetch", fetch,
                           count=len(np_out))
                if self.timeline is not None:
                    self.timeline.kernel_end(seq, _mono(t_end),
                                             fetch_bytes=fetch,
                                             fetch_count=len(np_out))
                if cluster is not None:
                    from ..scheduler import stack as stack_mod

                    if carry:
                        self._note_landed(np_out, reqs, cluster, token,
                                          seq, idxs, wave)
                    stack_mod.release_view(cluster, token)
            return cb

        return _kernel_done

    def _note_landed(self, np_out, reqs, cluster, token, seq, idxs,
                     wave) -> None:
        """A table dispatch has landed: count a wave's cross-lane
        collisions and fill the carry note's predicted placement rows
        (per eval, from sel_idx)."""
        from ..scheduler import stack as stack_mod

        coll = int(np_out[-1]) if wave else 0
        if coll:
            if self.registry is not None:
                self.registry.inc("wave.collisions", coll)
            # stale-footprint spike → flight event: plan-apply absorbs
            # the race; the recorder makes the episode visible
            from ..lib.flight import default_flight

            try:
                default_flight().record(
                    "wave.collisions", key=str(seq), severity="warn",
                    detail={"collisions": coll, "programs": len(reqs)})
            except Exception:  # noqa: BLE001 — telemetry
                pass
        sel = np.asarray(np_out[0])
        predicted: Dict[Optional[str], set] = {}
        for j, r in enumerate(reqs):
            i = idxs[j] if idxs is not None else j
            eid = self.trace_ids.get(r.order)
            rows = {int(x) for x in sel[i].reshape(-1) if x >= 0}
            predicted[eid] = predicted.get(eid, set()) | rows
        if not coll:
            # a cross-lane collision row's true combined usage exists in
            # no lane: leave the carry note unpredicted — unadoptable,
            # the next refresh overlays from host (view.carry_rejects);
            # chain-held carries route through the same fill
            stack_mod.carry_predicted(cluster, token, predicted)

    def _upload_dyn(self, prep, dev, led, shape=None):
        """The dispatch's dynamic rows on the device (ledgered); the
        table row indices stay on the host — the kernel's argument block
        carries them."""
        from ..convert import to_device_async

        bufs = (prep.dyn_i, prep.dyn_f, prep.dyn_u)
        if shape is not None:
            bufs = tuple(b.reshape(shape + (b.shape[1],)) for b in bufs)
        nb = sum(b.nbytes for b in bufs)
        with led.timed("select_batch.dyn_rows", nb, count=3):
            out = tuple(to_device_async(b, dev) for b in bufs)
        return out, nb

    def _dispatch_table(self, reqs, cluster, dev, want_ex, led, _mono,
                        _kernel_done, spec: bool = False) -> bool:
        """Dispatch one cluster group through the device program table.
        Returns False (nothing dispatched, no side effects on reqs) when
        the group can't ride the table — the caller then runs the packed
        transport. Requests spanning ≥2 disjoint broker conflict groups
        dispatch as a WAVE (parallel lanes) instead of one chain.

        `spec`: resolve the view from the speculative chain (predicted
        post-commit state) instead of the committed cache, record the
        carry on the chain instead of the cache note, and STASH the
        outputs for commit-time certification instead of releasing the
        waiters — run() certifies once the predecessor's plans have all
        committed."""
        from ..kernels.placement import place_table_chain
        from ..lib.transfer import guard_scope
        from ..scheduler import stack as stack_mod
        from .program_table import table_for

        lanes = self._wave_lanes(reqs)
        if len(lanes) >= self._MIN_WAVE_LANES:
            return self._dispatch_table_wave(lanes, cluster, dev, want_ex,
                                             led, _mono, _kernel_done,
                                             spec=spec)
        table = table_for(cluster, dev)
        params_list = [r.params for r in reqs]
        # pad the program axis to a power of two with inert programs; the
        # pad shares program 0's static table row with a no-effect
        # dynamic row
        b = _bucket(len(reqs), lo=2)
        if b > len(reqs):
            pad = _inert_program(params_list[0])
            params_list = params_list + [pad] * (b - len(reqs))
        t0 = time.perf_counter()
        prep = table.prepare(params_list)
        if prep is None:
            return False
        t1 = time.perf_counter()
        with guard_scope():
            com = table.commit(prep, led)
            if com is None:
                return False  # caps flush raced this prepare
            ti, tf, tu, ins_nb, ins_count = com
            self.stats["pack_ms"] += (t1 - t0) * 1e3
            self._trace(reqs, "pack", _mono(t0), _mono(t1))
            if len(reqs) > 1:
                self.stats["batched"] += len(reqs)
            (di, df, du), nb = self._upload_dyn(prep, dev, led)
            self.stats["pack_bytes"] += nb + ins_nb
            t2 = time.perf_counter()
            # view AFTER pack, at the last instant before the kernel (the
            # predecessor batch's plans have committed and, when its
            # carry survived, resolve here as a zero-transfer adoption),
            # leased ATOMICALLY with the resolve
            token = next(stack_mod._DISPATCH_TOKENS)
            try:
                with led.scope() as moved:
                    if spec:
                        arrays = stack_mod.spec_chain_view(cluster, token,
                                                           dev)
                        if arrays is None:
                            return False  # nothing predictable — the
                            # caller re-parks and the batch dispatches
                            # normally once the predecessor commits
                    else:
                        arrays = reqs[0].arrays_fn(lease_token=token)
                tv = time.perf_counter()
                self.stats["view_ms"] += (tv - t2) * 1e3
                self._trace(reqs, "delta_apply", _mono(t2), _mono(tv))
                out, carry = place_table_chain(
                    arrays, ti, tf, tu, prep.rows, di, df, du,
                    prep.sspec, prep.dspec, prep.m, explain=want_ex)
            except BaseException:
                # the lease is normally released by the first resolver; a
                # failed launch has no resolvers
                stack_mod.release_view(cluster, token)
                raise
        spec_state = None
        if spec:
            spec_state = {"reqs": reqs, "idxs": None, "cluster": cluster,
                          "token": token, "lanes":
                          [list(range(len(reqs)))], "kernel_ms": 0.0}
        seq = 0
        if self.timeline is not None:
            seq = self.timeline.commit(
                programs=len(reqs), batched=len(reqs) > 1,
                pack=(_mono(t0), _mono(t1)),
                upload=(_mono(t1), _mono(t2)),
                view=(_mono(t2), _mono(tv)),
                kernel_start=_mono(tv),
                transfer_bytes=nb + ins_nb + moved[0],
                transfer_count=3 + ins_count + moved[1],
                traces=self._dist_traces(reqs),
                speculative=spec)
        self._note_carry(reqs, cluster, token, arrays, carry, spec)
        holder = _BatchOut(
            tuple(out),
            _kernel_done(reqs, tv, seq, cluster=cluster, token=token,
                         spec_state=spec_state))
        if spec:
            spec_state["holder"] = holder
            spec_state["seq"] = seq
            self._spec = spec_state
            if self.registry is not None:
                self.registry.inc("spec.launches")
            return True
        for i, r in enumerate(reqs):
            r.out = (holder, i, token)
            r.event.set()
        # the launched dispatch has a chain carry to predict from: offer
        # the NEXT batch a speculative launch against it, overlapping
        # this batch's plan commits with its successor's kernel
        self._offer_spec(cluster)
        return True

    def _note_carry(self, reqs, cluster, token, arrays, carry, spec):
        """Carry note: once this dispatch's outputs land and its plans
        commit, the next refresh may adopt the (used, dyn_free) carry
        instead of re-uploading the committed rows; a speculative
        dispatch advances the chain instead. The token (leased at the
        resolve) also rides the waiters' results onto their plans
        (carry_token): a commit window covers the carry only when it
        came from THIS dispatch. Residency: the carry tensors are held
        until the next refresh adopts (re-sites them into the view) or
        rejects them."""
        from ..lib.hbm import default_hbm
        from ..scheduler import stack as stack_mod

        hbm = default_hbm()
        hbm.track("select_batch.carry", carry[0])
        hbm.track("select_batch.carry", carry[1])
        evals = [self.trace_ids.get(r.order) for r in reqs]
        stop_rows = set()
        for r in reqs:
            p = r.params
            for arr in (p.delta_idx, p.pclr_idx, p.pset_idx):
                a = np.asarray(arr).reshape(-1)
                stop_rows.update(int(x) for x in a[a >= 0])
        if spec:
            stack_mod.spec_chain_advance(cluster, token, evals,
                                         stop_rows, carry[0], carry[1])
        else:
            stack_mod.note_dispatch_carry(cluster, token, arrays, evals,
                                          stop_rows, carry[0], carry[1])

    def _wave_lanes(self, reqs) -> List[list]:
        """Partition a cluster group's requests into wave lanes from the
        broker's conflict groups. Returns [reqs] (single lane — the
        sequential chain) unless ≥2 disjoint groups exist and every
        request has a known group.

        Groups pack into at most NOMAD_TPU_WAVE_LANES lanes (default 8)
        longest-first onto the least-loaded lane (LPT): a wave takes as
        long as its LONGEST lane. Concatenating disjoint groups inside
        one lane is always safe — a lane is sequential."""
        if not self.group_ids:
            return [reqs]
        groups: Dict[int, list] = {}
        for r in reqs:
            gid = self.group_ids.get(r.order)
            if gid is None:
                return [reqs]
            groups.setdefault(gid, []).append(r)
        if len(groups) < self._MIN_WAVE_LANES:
            return [reqs]
        try:
            max_lanes = max(int(os.environ.get("NOMAD_TPU_WAVE_LANES",
                                               "8")), 1)
        except ValueError:
            max_lanes = 8
        n_lanes = min(len(groups), max_lanes)
        if n_lanes < self._MIN_WAVE_LANES:
            return [reqs]
        lanes: List[list] = [[] for _ in range(n_lanes)]
        for g in sorted(groups.values(), key=len, reverse=True):
            min(lanes, key=len).extend(g)
        return [l for l in lanes if l]

    def _dispatch_table_wave(self, lanes, cluster, dev, want_ex, led, _mono,
                             _kernel_done, spec: bool = False) -> bool:
        """Dispatch ≥2 disjoint-footprint lanes as ONE wave through the
        device program table (`place_table_wave`). Same transport, lease,
        carry-note and ledger discipline as the chain path; the program
        axis is [L, P] (lanes × bucketed lane length, inert-padded).
        Returns False untouched on a table-residency miss — the caller
        then runs the packed transport as one sequential chain. `spec`
        as in _dispatch_table: predicted view, chain carry, deferred
        waiters."""
        from ..kernels.placement import place_table_wave
        from ..lib.transfer import guard_scope
        from ..scheduler import stack as stack_mod
        from .program_table import table_for

        reqs = [r for lane in lanes for r in lane]
        table = table_for(cluster, dev)
        t0 = time.perf_counter()
        lane_len = _bucket(max(len(lane) for lane in lanes), lo=2)
        n_lanes = _bucket(len(lanes), lo=2)
        pad = _inert_program(lanes[0][0].params)
        params_list: List = []
        idxs: List[int] = []
        for li, lane in enumerate(lanes):
            for pi, r in enumerate(lane):
                idxs.append(li * lane_len + pi)
            params_list.extend([r.params for r in lane])
            params_list.extend([pad] * (lane_len - len(lane)))
        # fully-inert pad lanes (bucketed lane count); they share the
        # template's table row and fold as no-ops
        params_list.extend([pad] * ((n_lanes - len(lanes)) * lane_len))
        prep = table.prepare(params_list)
        if prep is None:
            return False
        t1 = time.perf_counter()
        with guard_scope():
            com = table.commit(prep, led)
            if com is None:
                return False  # caps flush raced this prepare
            ti, tf, tu, ins_nb, ins_count = com
            self.stats["pack_ms"] += (t1 - t0) * 1e3
            self._trace(reqs, "pack", _mono(t0), _mono(t1))
            self.stats["batched"] += len(reqs)
            rows2 = prep.rows.reshape(n_lanes, lane_len)
            (di, df, du), nb = self._upload_dyn(prep, dev, led,
                                                (n_lanes, lane_len))
            self.stats["pack_bytes"] += nb + ins_nb
            t2 = time.perf_counter()
            # view AFTER pack + atomic lease, exactly like the chain path
            token = next(stack_mod._DISPATCH_TOKENS)
            try:
                with led.scope() as moved:
                    if spec:
                        arrays = stack_mod.spec_chain_view(cluster, token,
                                                           dev)
                        if arrays is None:
                            return False
                    else:
                        arrays = reqs[0].arrays_fn(lease_token=token)
                tv = time.perf_counter()
                self.stats["view_ms"] += (tv - t2) * 1e3
                self._trace(reqs, "delta_apply", _mono(t2), _mono(tv))
                out, carry = place_table_wave(
                    arrays, ti, tf, tu, rows2, di, df, du,
                    prep.sspec, prep.dspec, prep.m, explain=want_ex)
            except BaseException:
                stack_mod.release_view(cluster, token)
                raise
        spec_state = None
        if spec:
            pos = 0
            lanes_idx: List[List[int]] = []
            for lane in lanes:
                lanes_idx.append(list(range(pos, pos + len(lane))))
                pos += len(lane)
            spec_state = {"reqs": reqs, "idxs": idxs, "cluster": cluster,
                          "token": token, "lanes": lanes_idx,
                          "kernel_ms": 0.0}
        seq = 0
        if self.timeline is not None:
            seq = self.timeline.commit(
                programs=len(reqs), batched=True,
                pack=(_mono(t0), _mono(t1)),
                upload=(_mono(t1), _mono(t2)),
                view=(_mono(t2), _mono(tv)),
                kernel_start=_mono(tv),
                transfer_bytes=nb + ins_nb + moved[0],
                transfer_count=3 + ins_count + moved[1],
                traces=self._dist_traces(reqs),
                speculative=spec)
        if self.registry is not None:
            self.registry.inc("wave.dispatches")
            self.registry.inc("wave.programs", len(reqs))
            self.registry.add_sample("wave.lanes", len(lanes))
            self.registry.add_sample("wave.lane_len",
                                     max(len(l) for l in lanes))
        self._note_carry(reqs, cluster, token, arrays, carry, spec)
        holder = _BatchOut(
            tuple(out),
            _kernel_done(reqs, tv, seq, cluster=cluster, token=token,
                         idxs=idxs, wave=True, spec_state=spec_state))
        if spec:
            spec_state["holder"] = holder
            spec_state["seq"] = seq
            self._spec = spec_state
            if self.registry is not None:
                self.registry.inc("spec.launches")
            return True
        for j, r in enumerate(reqs):
            r.out = (holder, idxs[j], token)
            r.event.set()
        self._offer_spec(cluster)
        return True

    # ---- speculative launch + commit-time certification ----

    def _offer_spec(self, cluster) -> None:
        """A fused table dispatch just launched (or certified): its
        chain carry predicts the post-commit view. Offer the successor
        batch a speculative launch against it — the successor's kernel
        then queues right behind this one on the device's stream while
        this batch's plans commit on the waiter threads. Speculation must
        never fail the real path: any error just means no speculation."""
        succ = self.successor
        if succ is None or succ is self:
            return
        try:
            succ.try_spec_launch(cluster)
        except Exception:  # noqa: BLE001 — speculative only
            pass

    def try_spec_launch(self, cluster) -> bool:
        """Speculatively dispatch this coordinator's round-1 batch
        against the predicted post-commit view of `cluster`. Called on
        the PREDECESSOR batch's coordinator thread (the shared worker
        thread — run() has not been entered yet, so there is no
        dispatch race). Waits briefly for the round-1 rendezvous (the
        schedulers are compiling on the pool); aborts — leaving the
        batch parked for the normal path — unless every live thread is
        parked, every request is bound to `cluster`, the adaptive gate
        is armed, and the chain has a carry to predict from. Declines
        under an active device mesh (its dispatches carry no view to
        predict from)."""
        if not spec_enabled() or self._ran or self._spec is not None:
            return False
        from ..parallel.mesh import get_active_mesh

        if get_active_mesh() is not None:
            return False
        gate = _gate_for(cluster)
        if not gate.armed():
            return False
        deadline = time.time() + _spec_park_s()
        with self._cv:
            while True:
                if self._parked and len(self._parked) >= self._live:
                    break
                remaining = deadline - time.time()
                if remaining <= 0:
                    # the wait was paid for nothing — consecutive
                    # misses disarm the gate (see SpecGate)
                    gate.record_miss()
                    return False
                self._cv.wait(min(remaining, 0.01))
            batch = list(self._parked)
            for r in batch:
                owner = getattr(r.arrays_fn, "__self__", None)
                if getattr(owner, "cluster", None) is not cluster:
                    return False
            self._parked = []
        batch.sort(key=lambda r: r.order)
        ok = False
        try:
            ok = self._dispatch_spec(batch, cluster)
        finally:
            if not ok:
                gate.record_miss()
                # nothing launched: re-park untouched for run()'s
                # normal dispatch
                with self._cv:
                    self._parked = batch + self._parked
                    self._cv.notify_all()
        return ok

    def _dispatch_spec(self, batch, cluster) -> bool:
        from ..lib.transfer import default_ledger

        led = default_ledger()
        t_start = time.perf_counter()
        _off = time.monotonic() - t_start

        def _mono(t: float) -> float:
            return t + _off

        # the SAME resolver callback as the normal path (collision
        # flight events, carry-prediction fill — chain-aware — and
        # lease release included); only the dispatch entry differs
        _kernel_done = self._kernel_done_factory(led, _mono)
        want_ex = any(r.explain for r in batch)
        dev = _device_of(batch, {}, None)
        if not self._dispatch_table(batch, cluster, dev, want_ex, led,
                                    _mono, _kernel_done, spec=True):
            return False
        self.stats["dispatches"] += 1
        self.stats["programs"] += len(batch)
        self.stats["dispatch_ms"] += (time.perf_counter() - t_start) * 1e3
        return True

    def _certify_spec(self, spec) -> None:
        """Commit-time certification: the predecessor batch's plans have
        ALL committed (the worker finishes batch k before driving this
        coordinator), so the chain's stale-row set is final for this
        launch. A program slice keeps its speculative result iff its
        lane prefix is clean: no program at or before it in its lane
        has a footprint touching a stale row (later programs in a lane
        saw earlier ones' placements through the in-lane carry, so a
        rollback cascades down its lane — disjoint lanes are
        untouched). Rolled-back slices re-dispatch against the
        committed view; `spec.redispatch_programs` counts them
        exactly."""
        from ..scheduler import stack as stack_mod

        reqs = spec["reqs"]
        cluster = spec["cluster"]
        holder = spec["holder"]
        idxs = spec["idxs"]
        token = spec["token"]
        reg = self.registry
        try:
            stale = stack_mod.spec_chain_certify(cluster)
        except Exception:  # noqa: BLE001 — unprovable == roll back
            stale = None
        rolled: set = set()
        if stale is None:
            rolled = set(range(len(reqs)))
        elif stale:
            for lane in spec["lanes"]:
                for pos, i in enumerate(lane):
                    fp = self.footprints.get(reqs[i].order)
                    if self._fp_hit(fp, stale):
                        rolled.update(lane[pos:])
                        break
        for i in range(len(reqs)):
            if i not in rolled:
                r = reqs[i]
                r.out = (holder, i if idxs is None else idxs[i], token)
                r.event.set()
        if not rolled:
            if reg is not None:
                reg.inc("spec.certified")
            if self.timeline is not None:
                self.timeline.spec_resolve(spec["seq"], "certified")
            _gate_for(cluster).record(False)
            # hand the certified HEAD carry to the view cache instead
            # of dropping it at chain end: a refresh landing mid-chain
            # or after the chain winds down adopts the chain's folded
            # view and overlays only the genuinely-foreign delta
            # (stack.spec_chain_publish_carry / _chain_carry_overlay)
            stack_mod.spec_chain_publish_carry(cluster)
            # chain continues: this dispatch's carry predicts the next
            # post-commit view while THESE plans commit
            self._offer_spec(cluster)
            return
        # ---- rollback ----
        # resolve the holder on THIS thread: the launch must land so
        # its wasted share is known, the view lease releases, and a
        # fully rolled-back dispatch leaves no live device outputs
        holder.resolve()
        kms = float(spec.get("kernel_ms") or 0.0)
        wasted = kms * len(rolled) / max(len(reqs), 1)
        if reg is not None:
            reg.inc("spec.rolled_back")
            reg.inc("spec.redispatch_programs", len(rolled))
            reg.inc("spec.wasted_kernel_ms", wasted)
        if self.timeline is not None:
            self.timeline.spec_resolve(
                spec["seq"], "rolled_back",
                wasted_frac=len(rolled) / max(len(reqs), 1))
        _gate_for(cluster).record(True)
        rejected = stack_mod.spec_chain_last_rejected(cluster)
        stack_mod.spec_chain_reset(cluster)
        from ..lib.flight import default_flight

        try:
            default_flight().record(
                "spec.rollback", key=str(spec["seq"]), severity="warn",
                detail={"programs": len(rolled), "batch": len(reqs),
                        "stale_rows": (sorted(stale)[:8]
                                       if stale else None),
                        "rejected_rows": (sorted(rejected)[:8]
                                          if rejected else None),
                        "wasted_kernel_ms": round(wasted, 3)})
        except Exception:  # noqa: BLE001 — telemetry only
            pass
        # re-dispatch ONLY the affected slices against the committed
        # view (normal path: fresh refresh, fresh carry note — the
        # chain re-seeds from it via the launch hook)
        self._dispatch([reqs[i] for i in sorted(rolled)])

    @staticmethod
    def _fp_hit(fp, stale) -> bool:
        """Does a program's footprint mask touch any stale row? An
        unknown footprint (None) conflicts with everything; a stale row
        past the mask's length post-dates its estimate and counts as a
        hit (sound, and node growth resets the chain anyway)."""
        if fp is None:
            return bool(stale)
        n = fp.shape[0]
        return any(r >= n or bool(fp[r]) for r in stale)

    def _trace(self, reqs: List[_SelectReq], phase: str,
               start: float, end: float) -> None:
        """Per-eval span for a fused phase: every program in the batch
        rode the same host pack / device dispatch, so each gets the
        batch's interval (monotonic clock)."""
        if self.tracer is None:
            return
        for r in reqs:
            tid = self.trace_ids.get(r.order)
            if tid is not None:
                self.tracer.record(tid, phase, start=start, end=end)

    def _dist_traces(self, reqs: List[_SelectReq]) -> List[str]:
        """Distributed trace ids (lib/tracectx.py) of the evals riding a
        dispatch, deduped in batch order."""
        if self.tracer is None:
            return []
        out: List[str] = []
        for r in reqs:
            tid = self.trace_ids.get(r.order)
            ctx = self.tracer.binding(tid) if tid is not None else None
            if ctx is not None and ctx.trace_id not in out:
                out.append(ctx.trace_id)
        return out


def _inert_program(p):
    """A zero-effect pad program: places nothing (n_place=0) and carries
    no plan-relative deltas, so the chain's (used, dyn_free) carry passes
    through it unchanged. Only DYNAMIC fields are touched, so the pad
    shares its template's program-table row."""
    z = np.zeros_like
    return p._replace(
        n_place=np.int32(0),
        delta_idx=np.full_like(np.asarray(p.delta_idx), -1),
        delta_res=z(np.asarray(p.delta_res)),
        pclr_idx=np.full_like(np.asarray(p.pclr_idx), -1),
        pclr_port=np.full_like(np.asarray(p.pclr_port), -1),
        pset_idx=np.full_like(np.asarray(p.pset_idx), -1),
        pset_port=np.full_like(np.asarray(p.pset_port), -1),
    )
