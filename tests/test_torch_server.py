"""The port's batched server path: `Server(device="cpu")`.

Broker → worker → select coordinator → program table → chain and wave
transports (their plain versions on CPU tensors) → plan apply. Twins of
the reference's server cases in `tests/test_select_batch.py` and
`tests/test_drain.py`, run on the port:

- a batched server (eval_batch=8) places exactly what a sequential one
  (eval_batch=1) does, and the batch path engaged;
- a contended batch does not over-commit a node;
- a poisoned eval does not sink its batch;
- the 2000-node dc-pinned feed dispatches at least one wave, places what
  the sequential run places, and keeps plan-apply partials flat.

And the port against the reference: one seeded feed through both
packages' `Server`s places alloc by alloc on the same nodes — with
speculation and chain-carry adoption switched off in both
(`NOMAD_TPU_SPECULATE=0`, `NOMAD_TPU_SPEC_CHAIN_ADOPT=0`), and with both
servers at their defaults (both on). Port-batched == port-sequential ==
reference-sequential then holds the batched path to the reference. The
plans themselves carry the same certification: for the same evals the
port's `Plan.carry_exact` and `carry_token` (by its dispatch's position)
equal the reference's.

And the reference's `tests/test_server.py` lifecycle cases, each run on
both packages' `Server` with the same mock nodes and jobs (deep copies
into the reference, over the wire into the port): register places the
allocs, exhausted capacity blocks and then unblocks, deregister stops the
allocs, a system job runs on new nodes, the broker serializes per job —
with the same allocs on the same nodes in both.
"""
import random
import time

import pytest

from nomad_tpu.structs.codec import to_wire
from nomad_tpu.synth import synth_node, synth_service_job
from torch_chain_cases import one_torch_thread  # noqa: F401

from nomad_tpu_torch import mock
from nomad_tpu_torch.structs.codec import from_wire

FINAL = ("complete", "failed", "blocked", "cancelled")


def _port(obj):
    return from_wire(to_wire(obj))


def _feed(seed, n_nodes, jobs_fn):
    """Seeded nodes and jobs from the reference's generator (both
    packages get the same objects: the port's over the wire)."""
    rng = random.Random(seed)
    nodes = [synth_node(rng, i) for i in range(n_nodes)]
    return nodes, jobs_fn(rng)


def _run(server_mod, eval_batch, nodes, jobs, timeout=120.0, port=True,
         **server_kw):
    """One server run; returns ({(job idx, alloc index): node name},
    planner stats, worker batch stats, registry counters)."""
    cfg = server_mod.ServerConfig(num_schedulers=1, heartbeat_ttl=3600.0,
                                  eval_batch=eval_batch)
    s = server_mod.Server(cfg, **server_kw)
    conv = _port if port else (lambda o: o)
    try:
        for n in nodes:
            s.state.upsert_node(conv(n))
        jobs = [conv(j) for j in jobs]
        # register BEFORE starting the workers: the first drain then sees
        # a deep queue and the batch path engages
        evs = [s.job_register(j) for j in jobs]
        s.start()
        for ev in evs:
            got = s.wait_for_eval(ev.id, statuses=FINAL, timeout=timeout)
            assert got is not None and got.status == "complete", got
        names = {nid: nd.name for nid, nd in s.state._nodes.items()}
        placements = {}
        for ji, j in enumerate(jobs):
            for a in s.state.allocs_by_job("default", j.id):
                placements[(ji, a.name.rsplit("[", 1)[1])] = \
                    names.get(a.node_id, a.node_id)
        deadline = time.time() + 10.0
        while eval_batch > 1 and time.time() < deadline \
                and not s.workers[0].batch_stats.get("evals"):
            time.sleep(0.05)   # finish_batch writes its counters last
        return (placements, dict(s.planner.stats),
                dict(s.workers[0].batch_stats), s.metrics.counters())
    finally:
        s.shutdown()


def _port_run(eval_batch, nodes, jobs, monkeypatch, **kw):
    from nomad_tpu_torch import server as tsrv

    monkeypatch.delenv("NOMAD_TPU_EVAL_BATCH", raising=False)
    return _run(tsrv, eval_batch, nodes, jobs, device="cpu", **kw)


def _jobs_of_count(n_jobs, count):
    return lambda rng: [synth_service_job(rng, count=count)
                        for _ in range(n_jobs)]


def test_batched_equals_sequential(monkeypatch):
    nodes, jobs = _feed(7, 32, _jobs_of_count(12, 2))
    seq, _st, _w, _c = _port_run(1, nodes, jobs, monkeypatch)
    bat, bat_stats, wstats, _c = _port_run(8, nodes, jobs, monkeypatch)
    assert seq and set(seq) == set(bat)
    diffs = {k for k in seq if seq[k] != bat[k]}
    assert not diffs, f"{len(diffs)} placements differ: {sorted(diffs)[:5]}"
    assert wstats.get("batched", 0) > 0, wstats
    assert bat_stats.get("partial", 0) == 0


def test_contended_batch_does_not_overcommit(monkeypatch):
    from nomad_tpu_torch.server import Server, ServerConfig

    monkeypatch.delenv("NOMAD_TPU_EVAL_BATCH", raising=False)
    s = Server(ServerConfig(num_schedulers=1, heartbeat_ttl=3600.0,
                            eval_batch=8), device="cpu")
    try:
        for i in range(6):
            n = mock.node()
            n.id = f"n-{i}"
            n.node_resources.cpu = 1000
            n.node_resources.memory_mb = 1024
            s.state.upsert_node(n)
        jobs = []
        for i in range(6):
            j = mock.job()
            j.id = f"contend-{i}"
            j.task_groups[0].count = 1
            j.task_groups[0].tasks[0].resources.cpu = 700
            j.task_groups[0].tasks[0].resources.memory_mb = 128
            j.task_groups[0].networks = []
            jobs.append(j)
        evs = [s.job_register(j) for j in jobs]
        s.start()
        for ev in evs:
            got = s.wait_for_eval(ev.id, statuses=FINAL, timeout=60.0)
            assert got is not None and got.status == "complete", got
        used = [a.node_id for j in jobs
                for a in s.state.allocs_by_job("default", j.id)]
        assert len(used) == 6 and len(set(used)) == 6, used
        assert s.planner.stats.get("partial", 0) == 0
    finally:
        s.shutdown()


def test_poisoned_eval_does_not_sink_its_batch(monkeypatch):
    import nomad_tpu_torch.server.worker as worker_mod
    from nomad_tpu_torch.server import Server, ServerConfig
    from nomad_tpu_torch.synth import synth_node as port_node
    from nomad_tpu_torch.synth import synth_service_job as port_job

    real = worker_mod.GenericScheduler
    poison = set()

    class Exploding(real):
        def process(self, eval):
            if eval.job_id in poison:
                raise RuntimeError("poisoned eval (test)")
            return real.process(self, eval)

    monkeypatch.setattr(worker_mod, "GenericScheduler", Exploding)
    monkeypatch.delenv("NOMAD_TPU_EVAL_BATCH", raising=False)
    # pin the drain hold window so the 8-eval rendezvous forms
    monkeypatch.setenv("NOMAD_TPU_DRAIN_WINDOW_MS", "300")
    rng = random.Random(11)
    s = Server(ServerConfig(num_schedulers=1, heartbeat_ttl=3600.0,
                            eval_batch=8), device="cpu")
    try:
        for i in range(16):
            s.state.upsert_node(port_node(rng, i))
        jobs = [port_job(rng, count=2) for _ in range(8)]
        poison.add(jobs[3].id)
        evs = [s.job_register(j) for j in jobs]
        s.start()
        for i, ev in enumerate(evs):
            if i == 3:
                continue
            got = s.wait_for_eval(ev.id, statuses=FINAL, timeout=60.0)
            assert got is not None and got.status == "complete", (i, got)
        for i, j in enumerate(jobs):
            want = 0 if i == 3 else 2
            assert len(s.state.allocs_by_job("default", j.id)) == want
        deadline = time.time() + 30.0
        while time.time() < deadline \
                and s.broker._dequeues.get(evs[3].id, 0) < 2:
            time.sleep(0.05)
        assert s.broker._dequeues.get(evs[3].id, 0) >= 2
        got = s.state.eval_by_id(evs[3].id)
        assert got is None or got.status != "complete"
        deadline = time.time() + 10.0
        while time.time() < deadline \
                and not s.workers[0].batch_stats.get("batched", 0):
            time.sleep(0.05)
        assert s.workers[0].batch_stats.get("batched", 0) > 0
    finally:
        s.shutdown()


def _pinned_jobs(rng):
    return [synth_service_job(rng, count=2, datacenter=f"dc{1 + i % 3}")
            for i in range(9)]


def test_wave_parity_2000_nodes(monkeypatch):
    nodes, jobs = _feed(17, 2000, _pinned_jobs)
    seq, seq_stats, _w, seq_c = _port_run(1, nodes, jobs, monkeypatch,
                                          timeout=300.0)
    bat, bat_stats, _w, bat_c = _port_run(64, nodes, jobs, monkeypatch,
                                          timeout=300.0)
    assert seq_c.get("wave.dispatches", 0) == 0
    assert bat_c.get("wave.dispatches", 0) >= 1, "no wave was dispatched"
    assert seq and set(seq) == set(bat)
    diffs = {k: (seq[k], bat[k]) for k in seq if seq[k] != bat[k]}
    assert not diffs, sorted(diffs.items())[:4]
    assert bat_stats.get("partial", 0) == seq_stats.get("partial", 0)
    assert bat_stats.get("rejected_nodes", 0) == \
        seq_stats.get("rejected_nodes", 0)


def _mixed_jobs(rng):
    kinds = [dict(with_affinity=True), dict(with_spread=True),
             dict(distinct_hosts=True), dict(distinct_property=True),
             dict(), dict(datacenter="dc2")]
    return [synth_service_job(rng, count=3, **kinds[i % len(kinds)])
            for i in range(10)]


def _versus_reference(monkeypatch):
    from nomad_tpu import server as jsrv

    nodes, jobs = _feed(23, 48, _mixed_jobs)
    port_seq, port_stats, _w, _c = _port_run(1, nodes, jobs, monkeypatch)
    port_bat, _st, wstats, port_c = _port_run(8, nodes, jobs, monkeypatch)
    with monkeypatch.context() as m:
        m.delenv("NOMAD_TPU_EVAL_BATCH", raising=False)
        ref, ref_stats, _w, _c = _run(jsrv, 1, nodes, jobs, port=False)
    assert ref and set(ref) == set(port_seq) == set(port_bat)
    diffs = {k: (ref[k], port_seq[k], port_bat[k]) for k in ref
             if not ref[k] == port_seq[k] == port_bat[k]}
    assert not diffs, sorted(diffs.items())[:4]
    assert wstats.get("batched", 0) > 0
    assert ref_stats.get("partial", 0) == port_stats.get("partial", 0)
    return port_c


def test_port_places_like_the_reference(monkeypatch):
    """Both servers with speculation and chain adoption switched off."""
    monkeypatch.setenv("NOMAD_TPU_SPECULATE", "0")
    monkeypatch.setenv("NOMAD_TPU_SPEC_CHAIN_ADOPT", "0")
    port_c = _versus_reference(monkeypatch)
    assert not port_c.get("spec.launches", 0)


def test_port_places_like_the_reference_at_defaults(monkeypatch):
    """Both servers at their defaults: speculation, chain adoption and
    the row-delta view on."""
    monkeypatch.delenv("NOMAD_TPU_SPECULATE", raising=False)
    monkeypatch.delenv("NOMAD_TPU_SPEC_CHAIN_ADOPT", raising=False)
    _versus_reference(monkeypatch)


def _plan_certification(server_mod, plan_apply, conv, monkeypatch, **kw):
    """[(carry_exact, token rank)] per eval of one server run: a job
    placed alone, then 16 evals pre-enqueued in two batches of 8 — the
    first an update of that job (in-place updates: not carry-exact), the
    rest new jobs. A token's rank is its position among the run's
    dispatch tokens (tokens are process-wide counters)."""
    import copy

    monkeypatch.delenv("NOMAD_TPU_EVAL_BATCH", raising=False)
    monkeypatch.setenv("NOMAD_TPU_DRAIN_WINDOW_MS", "50")
    seen = {}
    real = plan_apply.PlanApplier.apply

    def apply(self, plan):
        seen.setdefault(plan.eval_id, []).append(
            (plan.carry_exact, plan.carry_token))
        return real(self, plan)

    monkeypatch.setattr(plan_apply.PlanApplier, "apply", apply)
    rng = random.Random(5)
    s = server_mod.Server(server_mod.ServerConfig(
        num_schedulers=1, heartbeat_ttl=3600.0, eval_batch=8), **kw)
    try:
        for i in range(40):
            s.state.upsert_node(conv(synth_node(rng, i)))
        base = synth_service_job(rng, count=2)
        s.start()
        ev = s.job_register(conv(base))
        got = s.wait_for_eval(ev.id, statuses=FINAL, timeout=60.0)
        assert got is not None and got.status == "complete", got
        s.broker.set_enabled(False)
        update = copy.deepcopy(base)
        update.task_groups[0].count = 3
        jobs = [update] + [synth_service_job(rng, count=2,
                                             with_devices=i % 3 == 0)
                           for i in range(15)]
        evs = [s.job_register(conv(j)) for j in jobs]
        s.broker.set_enabled(True)
        s._restore_evals()
        for e in evs:
            got = s.wait_for_eval(e.id, statuses=FINAL, timeout=120.0)
            assert got is not None and got.status == "complete", got
        plans = [seen[e.id] for e in evs]
    finally:
        s.shutdown()
    rank = {t: i for i, t in enumerate(sorted(
        {tok for ps in plans for _x, tok in ps if tok is not None}))}
    return [[(x, rank.get(tok)) for x, tok in ps] for ps in plans]


def test_plans_carry_the_references_certification(monkeypatch):
    """The same evals give plans with the reference's `carry_exact` and
    `carry_token` (by its dispatch's position): certified where the
    fused dispatch's carry holds the placements, revoked for the
    in-place update."""
    from nomad_tpu import server as jsrv
    from nomad_tpu.server import plan_apply as jpa
    from nomad_tpu_torch import server as tsrv
    from nomad_tpu_torch.server import plan_apply as tpa

    with monkeypatch.context() as m:
        ref = _plan_certification(jsrv, jpa, lambda o: o, m)
    with monkeypatch.context() as m:
        got = _plan_certification(tsrv, tpa, _port, m, device="cpu")
    assert got == ref
    assert ref[0] == [(False, 0)]
    assert all(ps == [(True, 0)] for ps in ref[1:8])
    assert all(ps == [(True, 1)] for ps in ref[8:])


@pytest.mark.parametrize("typ", ["system"])
def test_unported_scheduler_raises(typ):
    """The worker's scheduler types that were once unported now build
    their scheduler on the server's device instead of raising (the
    system scheduler since ROADMAP A7)."""
    import torch

    from nomad_tpu_torch.scheduler.harness import InMemState
    from nomad_tpu_torch.scheduler.system import SystemScheduler
    from nomad_tpu_torch.server import ServerConfig
    from nomad_tpu_torch.server.worker import Worker

    class _Srv:
        device = "cpu"
        config = ServerConfig()

    snap = InMemState()
    sched = Worker(_Srv())._make_scheduler(
        type("E", (), {"type": typ})(), snap, None)
    assert isinstance(sched, SystemScheduler)
    assert sched.device == torch.device("cpu")
    assert sched.cluster is snap.cluster


# ---- tests/test_server.py lifecycle cases, both packages -------------------


def _lifecycle(pkg, scenario):
    """Run `scenario(server, conv)` on a started `pkg` server ("ref" or
    "port", the port's on the CPU); returns what it returns."""
    import copy

    if pkg == "ref":
        from nomad_tpu.server import Server, ServerConfig

        s, conv = Server(ServerConfig(num_schedulers=1,
                                      heartbeat_ttl=60.0)), copy.deepcopy
    else:
        from nomad_tpu_torch.server import Server, ServerConfig

        s, conv = Server(ServerConfig(num_schedulers=1, heartbeat_ttl=60.0),
                         device="cpu"), _port
    s.start()
    try:
        return scenario(s, conv)
    finally:
        s.shutdown()


def _on_both(scenario):
    got = {pkg: _lifecycle(pkg, scenario) for pkg in ("ref", "port")}
    assert got["port"] == got["ref"]
    return got["port"]


def _register(s, conv, nodes):
    for n in nodes:
        s.node_register(conv(n))


def _live(s, job_id):
    return sorted(a.node_id for a in s.state.allocs_by_job("default", job_id)
                  if not a.terminal_status())


def _until(fn, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        got = fn()
        if got:
            return got
        time.sleep(0.05)
    return fn()


def test_job_register_places_allocs():
    from nomad_tpu import mock as ref_mock

    nodes = [ref_mock.node() for _ in range(3)]
    job = ref_mock.job()
    job.task_groups[0].count = 4

    def scenario(s, conv):
        _register(s, conv, nodes)
        done = s.wait_for_eval(s.job_register(conv(job)).id)
        assert done is not None and done.status == "complete"
        allocs = s.state.allocs_by_job("default", job.id)
        assert all(a.node_id for a in allocs)
        return sorted(a.node_id for a in allocs)

    assert len(_on_both(scenario)) == 4


def test_exhausted_capacity_blocks_then_unblocks():
    """One small node: the job wants more memory than it has, so one
    alloc places and a blocked eval waits; a new node unblocks it."""
    from nomad_tpu import mock as ref_mock

    small, extra = ref_mock.node(), ref_mock.node()
    job = ref_mock.job()
    job.task_groups[0].count = 2
    job.task_groups[0].tasks[0].resources.memory_mb = 6000   # fits once

    def scenario(s, conv):
        _register(s, conv, [small])
        done = s.wait_for_eval(s.job_register(conv(job)).id)
        assert done is not None and done.status == "complete"
        first = (_live(s, job.id), s.blocked.blocked_count())
        _register(s, conv, [extra])
        placed = _until(lambda: len(_live(s, job.id)) == 2
                        and s.blocked.blocked_count() == 0)
        return first, placed, _live(s, job.id), s.blocked.blocked_count()

    first, placed, allocs, blocked = _on_both(scenario)
    assert len(first[0]) == 1 and first[1] == 1
    assert placed and len(allocs) == 2 and blocked == 0


def test_job_deregister_stops_allocs():
    from nomad_tpu import mock as ref_mock

    nodes = [ref_mock.node() for _ in range(2)]
    job = ref_mock.job()
    job.task_groups[0].count = 2

    def scenario(s, conv):
        _register(s, conv, nodes)
        assert s.wait_for_eval(s.job_register(conv(job)).id).status \
            == "complete"
        placed = sorted(a.node_id for a in s.wait_for_allocs(
            "default", job.id, 2))
        ev2 = s.job_deregister("default", job.id)
        assert s.wait_for_eval(ev2.id).status == "complete"
        stopped = _until(lambda: not [
            a for a in s.state.allocs_by_job("default", job.id)
            if a.desired_status == "run"], timeout=5.0)
        return placed, stopped

    placed, stopped = _on_both(scenario)
    assert len(placed) == 2 and stopped


def test_system_job_runs_on_new_nodes():
    from nomad_tpu import mock as ref_mock

    nodes = [ref_mock.node() for _ in range(3)]
    job = ref_mock.system_job()

    def scenario(s, conv):
        _register(s, conv, nodes[:2])
        assert s.wait_for_eval(s.job_register(conv(job)).id).status \
            == "complete"
        two = sorted(a.node_id for a in s.wait_for_allocs(
            "default", job.id, 2))
        _register(s, conv, nodes[2:])   # the job extends to it
        three = sorted(a.node_id for a in s.wait_for_allocs(
            "default", job.id, 3))
        return two, three

    two, three = _on_both(scenario)
    assert len(two) == 2
    assert len(three) == 3 and len(set(three)) == 3


def test_broker_serializes_per_job():
    """Two evals for one job: the second waits until the first acks, and
    both complete."""
    from nomad_tpu import mock as ref_mock

    nodes = [ref_mock.node() for _ in range(2)]
    job = ref_mock.job()
    job.task_groups[0].count = 1

    def scenario(s, conv):
        _register(s, conv, nodes)
        ev1 = s.job_register(conv(job))
        ev2 = s.job_register(conv(job))
        d1, d2 = s.wait_for_eval(ev1.id), s.wait_for_eval(ev2.id)
        assert d1 is not None and d2 is not None
        return d1.status, d2.status, len(_live(s, job.id))

    assert _on_both(scenario) == ("complete", "complete", 1)
