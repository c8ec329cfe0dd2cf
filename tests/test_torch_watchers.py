"""Twins of the reference's `tests/test_watchers.py` (node drain,
periodic dispatch and core GC; reference test models:
nomad/drainer/*_test.go, nomad/periodic_test.go,
nomad/core_sched_test.go), run on the port's `Server(device="cpu")`.

`TestAgainstReference` runs the same scenarios through the reference's
server and the port's on the same nodes and jobs (built by the
reference's mocks, wired to the port) and compares what they leave:
alloc placements and states by name, node drain state, the allocs a
drainer tick marks, cron times, periodic children and the ids GC reaps.
Waits are bounded polls; threads' interleavings are not compared, only
the states they settle in.
"""
import copy
import datetime as dt
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.core_sched import CoreScheduler, GCConfig
from nomad_tpu_torch.server.periodic import CronExpr, PeriodicDispatch
from nomad_tpu_torch.structs import Evaluation
from nomad_tpu_torch.structs.job import PeriodicConfig
from nomad_tpu_torch.structs.node import DrainStrategy, NODE_STATUS_DOWN

from torch_chain_cases import one_torch_thread  # noqa: F401
from torch_ops_cases import REF, as_pkg, mod, run_both, wait_for
from torch_ops_cases import server as make_server


@pytest.fixture()
def server():
    s = Server(ServerConfig(num_schedulers=1, heartbeat_ttl=60.0,
                            gc_interval=3600.0), device="cpu")
    s.start()
    yield s
    s.shutdown()


def _wait(cond, timeout=10.0, every=0.05):
    dl = time.time() + timeout
    while time.time() < dl:
        if cond():
            return True
        time.sleep(every)
    return cond()


def _settle(server, job, count):
    """Register, wait for eval, mark allocs running on the client side."""
    ev = server.job_register(job)
    done = server.wait_for_eval(ev.id)
    assert done is not None and done.status == "complete"
    allocs = server.state.allocs_by_job(job.namespace, job.id)
    assert len(allocs) == count
    for a in allocs:
        import copy

        upd = copy.copy(a)
        upd.client_status = "running"
        server.state.update_alloc_from_client(upd)
    return allocs


class TestNodeDrain:
    def test_drain_migrates_allocs_and_completes(self, server):
        n1, n2 = mock.node(), mock.node()
        server.node_register(n1)
        server.node_register(n2)
        job = mock.job()
        job.task_groups[0].count = 2
        _settle(server, job, 2)

        drained = [n for n in (n1, n2)
                   if server.state.allocs_by_node(n.id)]
        target = drained[0]
        server.node_update_drain(target.id, DrainStrategy(deadline_s=30.0))
        node = server.state.node_by_id(target.id)
        assert node.scheduling_eligibility == "ineligible"

        # All allocs migrate off the drained node; replacements placed
        def drained_clean():
            allocs = [a for a in server.state.allocs_by_node(target.id)
                      if not a.terminal_status()]
            placed = [a for a in server.state.allocs_by_job("default", job.id)
                      if not a.terminal_status() and a.node_id != target.id]
            # client acks stops + runs replacements
            for a in server.state.allocs_by_job("default", job.id):
                import copy

                if a.desired_status == "stop" and a.client_status == "running":
                    upd = copy.copy(a)
                    upd.client_status = "complete"
                    server.state.update_alloc_from_client(upd)
                elif a.desired_status == "run" and a.client_status == "pending":
                    upd = copy.copy(a)
                    upd.client_status = "running"
                    server.state.update_alloc_from_client(upd)
            return not allocs and len(placed) == 2

        assert _wait(drained_clean), "drain never migrated all allocs"
        # Drain completes: strategy cleared, node stays ineligible
        assert _wait(lambda: server.state.node_by_id(target.id).drain is None)
        assert server.state.node_by_id(
            target.id).scheduling_eligibility == "ineligible"

    def test_cancel_drain_restores_eligibility(self, server):
        node = mock.node()
        server.node_register(node)
        server.node_update_drain(node.id, DrainStrategy(deadline_s=60.0))
        assert server.state.node_by_id(
            node.id).scheduling_eligibility == "ineligible"
        server.node_update_drain(node.id, None)
        got = server.state.node_by_id(node.id)
        assert got.drain is None and got.scheduling_eligibility == "eligible"

    def test_max_parallel_batching(self, server):
        # Single draining node, 4 allocs, max_parallel=1 → the first tick
        # marks exactly one alloc for migration.
        node, other = mock.node(), mock.node()
        server.node_register(node)
        server.node_register(other)
        # stop background drainer so we can observe a single tick
        server.drainer.shutdown()
        job = mock.job()
        job.task_groups[0].count = 4
        from nomad_tpu_torch.structs.job import MigrateStrategy

        job.task_groups[0].migrate_strategy = MigrateStrategy(max_parallel=1)
        _settle(server, job, 4)
        on_node = server.state.allocs_by_node(node.id)
        if not on_node:
            node = other
            on_node = server.state.allocs_by_node(node.id)
        server.state.node_by_id(node.id)
        import copy

        upd = copy.copy(server.state.node_by_id(node.id))
        upd.drain = DrainStrategy(deadline_s=600.0)
        upd.scheduling_eligibility = "ineligible"
        server.state.upsert_node(upd)
        server.drainer._track(upd)
        server.drainer.tick()
        marked = [a for a in server.state.allocs_by_node(node.id)
                  if a.desired_transition.should_migrate()]
        assert len(marked) == 1

    def test_deadline_forces_all(self, server):
        node = mock.node()
        server.node_register(node)
        server.drainer.shutdown()
        job = mock.job()
        job.task_groups[0].count = 3
        _settle(server, job, 3)
        import copy

        upd = copy.copy(server.state.node_by_id(node.id))
        upd.drain = DrainStrategy(deadline_s=-1)  # force immediately
        upd.scheduling_eligibility = "ineligible"
        server.state.upsert_node(upd)
        server.drainer._track(upd)
        server.drainer.tick()
        marked = [a for a in server.state.allocs_by_node(node.id)
                  if a.desired_transition.should_migrate()]
        assert len(marked) == 3


class TestCron:
    def test_every_five_minutes(self):
        e = CronExpr.parse("*/5 * * * *")
        # 2026-01-01 10:02:30 UTC
        import datetime as dt

        ts = dt.datetime(2026, 1, 1, 10, 2, 30,
                         tzinfo=dt.timezone.utc).timestamp()
        nxt = e.next_after(ts)
        got = dt.datetime.fromtimestamp(nxt, dt.timezone.utc)
        assert (got.hour, got.minute) == (10, 5)

    def test_strictly_after(self):
        import datetime as dt

        e = CronExpr.parse("0 * * * *")
        ts = dt.datetime(2026, 1, 1, 10, 0, 0,
                         tzinfo=dt.timezone.utc).timestamp()
        got = dt.datetime.fromtimestamp(e.next_after(ts), dt.timezone.utc)
        assert (got.hour, got.minute) == (11, 0)

    def test_daily_at_time(self):
        import datetime as dt

        e = CronExpr.parse("30 6 * * *")
        ts = dt.datetime(2026, 3, 10, 7, 0, 0,
                         tzinfo=dt.timezone.utc).timestamp()
        got = dt.datetime.fromtimestamp(e.next_after(ts), dt.timezone.utc)
        assert (got.day, got.hour, got.minute) == (11, 6, 30)

    def test_dow_restriction(self):
        import datetime as dt

        e = CronExpr.parse("0 12 * * 0")  # Sundays noon
        # 2026-01-01 is a Thursday; next Sunday is Jan 4
        ts = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc).timestamp()
        got = dt.datetime.fromtimestamp(e.next_after(ts), dt.timezone.utc)
        assert (got.month, got.day, got.hour) == (1, 4, 12)

    def test_bad_specs_rejected(self):
        for spec in ("* * * *", "61 * * * *", "* * 32 * *", "*/0 * * * *",
                     "* * * * 8"):
            with pytest.raises(ValueError):
                CronExpr.parse(spec)

    def test_dow_seven_is_sunday(self):
        import datetime as dt

        e = CronExpr.parse("0 12 * * 7")
        ts = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc).timestamp()
        got = dt.datetime.fromtimestamp(e.next_after(ts), dt.timezone.utc)
        assert (got.month, got.day, got.hour) == (1, 4, 12)  # Sunday Jan 4

    def test_bad_periodic_spec_rejected_at_register(self):
        from nomad_tpu_torch.server import Server, ServerConfig

        s = Server(ServerConfig(), device="cpu")
        try:
            s.start()
            job = mock.job()
            job.periodic = PeriodicConfig(spec="not a cron")
            with pytest.raises(ValueError):
                s.job_register(job)
            assert s.state.job_by_id(job.namespace, job.id) is None
        finally:
            s.shutdown()


class TestPeriodicDispatch:
    def test_register_tracks_no_eval(self, server):
        job = mock.job()
        job.periodic = PeriodicConfig(spec="*/5 * * * *")
        out = server.job_register(job)
        assert out is None  # no eval at register time
        assert any(j.id == job.id for j in server.periodic.tracked())

    def test_force_launches_child(self, server):
        server.node_register(mock.node())
        job = mock.job()
        job.task_groups[0].count = 1
        job.periodic = PeriodicConfig(spec="0 0 1 1 *")  # yearly; never fires
        server.job_register(job)
        ev = server.periodic.force(job.namespace, job.id)
        assert ev is not None
        child = server.state.job_by_id(job.namespace, ev.job_id)
        assert child is not None
        assert child.parent_id == job.id
        assert child.id.startswith(job.id + "/periodic-")
        assert child.periodic is None
        done = server.wait_for_eval(ev.id)
        assert done.status == "complete"
        assert len(server.state.allocs_by_job(job.namespace, child.id)) == 1

    def test_prohibit_overlap_skips(self, server):
        server.node_register(mock.node())
        job = mock.job()
        job.task_groups[0].count = 1
        job.periodic = PeriodicConfig(spec="0 0 1 1 *", prohibit_overlap=True)
        server.job_register(job)
        ev1 = server.periodic.force(job.namespace, job.id)
        assert ev1 is not None
        server.wait_for_eval(ev1.id)
        # first child's alloc still pending/running → second launch skipped
        ev2 = server.periodic.force(job.namespace, job.id)
        assert ev2 is None

    def test_deregister_untracks(self, server):
        job = mock.job()
        job.periodic = PeriodicConfig(spec="*/5 * * * *")
        server.job_register(job)
        server.job_deregister(job.namespace, job.id)
        assert not any(j.id == job.id for j in server.periodic.tracked())


class TestCoreGC:
    def test_force_gc_reaps_terminal_eval_and_allocs(self, server):
        server.node_register(mock.node())
        job = mock.job()
        job.task_groups[0].count = 1
        ev = server.job_register(job)
        server.wait_for_eval(ev.id)
        # stop the job and mark allocs complete
        server.job_deregister(job.namespace, job.id)
        _wait(lambda: all(
            a.desired_status == "stop"
            for a in server.state.allocs_by_job("default", job.id)))
        import copy

        for a in server.state.allocs_by_job("default", job.id):
            upd = copy.copy(a)
            upd.client_status = "complete"
            server.state.update_alloc_from_client(upd)
        _wait(lambda: all(
            e.status in ("complete", "failed", "cancelled")
            for e in server.state.evals()))
        server.run_gc("force-gc")
        assert server.state.evals_by_job("default", job.id) == []
        assert server.state.allocs_by_job("default", job.id) == []
        assert server.state.job_by_id("default", job.id) is None

    def test_eval_gc_skips_young_and_nonterminal(self, server):
        ev = Evaluation(id="e1", namespace="default", job_id="j",
                        type="service", status="pending")
        server.state.upsert_eval(ev)
        cs = CoreScheduler(server, server.state.snapshot())
        assert cs.eval_gc(force=True) == 0  # non-terminal: kept
        ev2 = Evaluation(id="e2", namespace="default", job_id="j2",
                         type="service", status="complete")
        server.state.upsert_eval(ev2)
        # Young (timetable has no old witness) → kept without force
        assert cs.eval_gc(force=False) == 0
        assert cs.eval_gc(force=True) == 1
        assert server.state.eval_by_id("e2") is None

    def test_node_gc_only_down_and_empty(self, server):
        node = mock.node()
        server.node_register(node)
        cs = CoreScheduler(server, server.state.snapshot())
        assert cs.node_gc(force=True) == 0  # ready node kept
        server.node_update_status(node.id, NODE_STATUS_DOWN)
        assert cs.node_gc(force=True) == 1
        assert server.state.node_by_id(node.id) is None

    def test_core_eval_routed_through_worker(self, server):
        ev2 = Evaluation(id="gce", namespace="-", job_id="x",
                         type="service", status="complete")
        server.state.upsert_eval(ev2)
        core = server.enqueue_core_eval("eval-gc")
        done = server.wait_for_eval(core.id)
        assert done is not None and done.status == "complete"


# ---- the same scenarios through the reference's server and the port's ----


def _started(pkg):
    s = make_server(pkg, num_schedulers=1, heartbeat_ttl=60.0,
                    gc_interval=3600.0)
    s.start()
    return s


def _ack(s, job_id):
    """Client acks: stops complete, pending allocs running."""
    for a in s.state.allocs_by_job("default", job_id):
        if a.desired_status == "stop" and a.client_status == "running":
            upd = copy.copy(a)
            upd.client_status = "complete"
            s.state.update_alloc_from_client(upd)
        elif a.desired_status == "run" and a.client_status == "pending":
            upd = copy.copy(a)
            upd.client_status = "running"
            s.state.update_alloc_from_client(upd)


def _alloc_states(s, job_id):
    return sorted((a.name, a.node_id, a.desired_status, a.client_status)
                  for a in s.state.allocs_by_job("default", job_id))


def _drain_scenario(pkg, nodes, job):
    s = _started(pkg)
    try:
        for n in nodes:
            s.node_register(as_pkg(pkg, n))
        ev = s.job_register(as_pkg(pkg, job))
        assert s.wait_for_eval(ev.id).status == "complete"
        _ack(s, job.id)
        target = sorted({a.node_id for a in s.state.allocs_by_job(
            "default", job.id)})[0]
        s.node_update_drain(target, mod(pkg, "structs.node").DrainStrategy(
            deadline_s=30.0))

        def settled():
            _ack(s, job.id)
            live = [a for a in s.state.allocs_by_job("default", job.id)
                    if not a.terminal_status()]
            return (len(live) == job.task_groups[0].count
                    and all(a.node_id != target
                            and a.client_status == "running" for a in live)
                    and s.state.node_by_id(target).drain is None)

        assert wait_for(settled), "drain never settled"
        node = s.state.node_by_id(target)
        live = sorted((a.name, a.node_id)
                      for a in s.state.allocs_by_job("default", job.id)
                      if not a.terminal_status())
        return target, node.scheduling_eligibility, live
    finally:
        s.shutdown()


def _tick_scenario(pkg, nodes, job, deadline_s):
    """One drainer tick on a node holding every alloc of `job`: the
    allocs it marks for migration."""
    s = _started(pkg)
    try:
        s.drainer.shutdown()
        for n in nodes:
            s.node_register(as_pkg(pkg, n))
        ev = s.job_register(as_pkg(pkg, job))
        assert s.wait_for_eval(ev.id).status == "complete"
        _ack(s, job.id)
        node = max(nodes, key=lambda n: len(s.state.allocs_by_node(n.id)))
        upd = copy.copy(s.state.node_by_id(node.id))
        upd.drain = mod(pkg, "structs.node").DrainStrategy(
            deadline_s=deadline_s)
        upd.scheduling_eligibility = "ineligible"
        s.state.upsert_node(upd)
        s.drainer._track(upd)
        s.drainer.tick()
        on = s.state.allocs_by_node(node.id)
        return len(on), sum(a.desired_transition.should_migrate()
                            for a in on)
    finally:
        s.shutdown()


def _periodic_scenario(pkg, node, job):
    s = _started(pkg)
    try:
        s.node_register(as_pkg(pkg, node))
        assert s.job_register(as_pkg(pkg, job)) is None
        tracked = [j.id for j in s.periodic.tracked()]
        ev = s.periodic.force(job.namespace, job.id)
        child = s.state.job_by_id(job.namespace, ev.job_id)
        done = s.wait_for_eval(ev.id)
        second = s.periodic.force(job.namespace, job.id)
        allocs = s.state.allocs_by_job(job.namespace, child.id)
        s.job_deregister(job.namespace, job.id)
        return dict(
            tracked=tracked, status=done.status, parent=child.parent_id,
            prefix=child.id.rsplit("/periodic-", 1)[0],
            periodic=child.periodic, type=child.type,
            placed=sorted((a.name.split(".", 1)[1], a.node_id)
                          for a in allocs),
            overlap=second is None,
            untracked=[j.id for j in s.periodic.tracked()])
    finally:
        s.shutdown()


def _gc_scenario(pkg, node, down, job):
    """Evals, nodes and a stopped job through the core scheduler: what
    each collector reaps."""
    s = _started(pkg)
    try:
        structs = mod(pkg, "structs")
        core = mod(pkg, "server.core_sched")
        for n in (node, down):
            s.node_register(as_pkg(pkg, n))
        s.state.upsert_eval(structs.Evaluation(
            id="pending-e", namespace="default", job_id="j",
            type="service", status="pending"))
        s.state.upsert_eval(structs.Evaluation(
            id="done-e", namespace="default", job_id="j2",
            type="service", status="complete"))
        cs = core.CoreScheduler(s, s.state.snapshot())
        out = dict(young=cs.eval_gc(force=False),
                   forced=cs.eval_gc(force=True),
                   evals=sorted(e.id for e in s.state.evals()))
        out["ready_nodes"] = cs.node_gc(force=True)
        s.node_update_status(down.id, "down")
        out["down_nodes"] = cs.node_gc(force=True)
        ev = s.job_register(as_pkg(pkg, job))
        s.wait_for_eval(ev.id)
        s.job_deregister(job.namespace, job.id)
        assert wait_for(lambda: all(
            a.desired_status == "stop"
            for a in s.state.allocs_by_job("default", job.id)))
        _ack(s, job.id)
        assert wait_for(lambda: all(
            e.status in ("complete", "failed", "cancelled")
            for e in s.state.evals_by_job("default", job.id)))
        s.run_gc("force-gc")
        out.update(
            nodes=sorted(n.id for n in s.state.nodes()),
            job_left=s.state.job_by_id("default", job.id) is not None,
            job_evals=len(s.state.evals_by_job("default", job.id)),
            job_allocs=len(s.state.allocs_by_job("default", job.id)))
        return out
    finally:
        s.shutdown()


class TestAgainstReference:
    def test_drain_end_state_equals_reference(self):
        rm = mod(REF, "mock")
        nodes = [rm.node(), rm.node()]
        job = rm.job()
        job.task_groups[0].count = 2
        ref, got = run_both(_drain_scenario, nodes, job)
        assert got == ref
        assert got[1] == "ineligible"
        assert all(node != got[0] for _name, node in got[2])

    @pytest.mark.parametrize("max_parallel,deadline_s,want", [
        (1, 600.0, 1), (None, -1, 3)], ids=["max_parallel", "deadline"])
    def test_drain_tick_marks_equal_reference(self, max_parallel,
                                              deadline_s, want):
        rm = mod(REF, "mock")
        nodes = [rm.node(), rm.node()] if max_parallel else [rm.node()]
        job = rm.job()
        tg = job.task_groups[0]
        tg.count = 4 if max_parallel else 3
        if max_parallel:
            tg.migrate_strategy = mod(REF, "structs.job").MigrateStrategy(
                max_parallel=max_parallel)
        ref, got = run_both(_tick_scenario, nodes, job, deadline_s)
        assert got == ref
        assert got[1] == (want if max_parallel else got[0])

    @pytest.mark.parametrize("spec", [
        "*/5 * * * *", "0 * * * *", "30 6 * * *", "0 12 * * 0",
        "0 12 * * 7", "15,45 */2 * * 1-5", "0 0 1 1 *", "0 0 29 2 *",
        "59 23 31 12 *", "*/7 3-9 * * 6"])
    def test_cron_next_after_equals_reference(self, spec):
        ref_e = mod(REF, "server.periodic").CronExpr.parse(spec)
        port_e = CronExpr.parse(spec)
        for start in (dt.datetime(2026, 1, 1, 10, 2, 30),
                      dt.datetime(2026, 3, 10, 7, 0, 0),
                      dt.datetime(2027, 12, 31, 23, 59, 59),
                      dt.datetime(2028, 2, 28, 12, 0, 0)):
            ts = start.replace(tzinfo=dt.timezone.utc).timestamp()
            for _ in range(5):
                nxt = port_e.next_after(ts)
                assert nxt == ref_e.next_after(ts), (spec, ts)
                assert nxt > ts
                ts = nxt

    @pytest.mark.parametrize("spec", [
        "* * * *", "61 * * * *", "* * 32 * *", "*/0 * * * *", "* * * * 8",
        "a b c d e", "", "* * * * * *", "5-1 * * * *"])
    def test_bad_cron_rejected_like_reference(self, spec):
        ref_bad = port_bad = False
        try:
            mod(REF, "server.periodic").CronExpr.parse(spec)
        except ValueError:
            ref_bad = True
        try:
            CronExpr.parse(spec)
        except ValueError:
            port_bad = True
        assert port_bad == ref_bad

    def test_periodic_child_equals_reference(self):
        rm = mod(REF, "mock")
        node = rm.node()
        job = rm.job()
        job.task_groups[0].count = 1
        job.periodic = mod(REF, "structs.job").PeriodicConfig(
            spec="0 0 1 1 *", prohibit_overlap=True)
        ref, got = run_both(_periodic_scenario, node, job)
        assert got == ref
        assert got["tracked"] == [job.id] and got["untracked"] == []
        assert got["parent"] == job.id == got["prefix"]
        assert got["status"] == "complete" and len(got["placed"]) == 1
        assert got["overlap"] and got["periodic"] is None

    def test_gc_reaps_what_reference_reaps(self):
        rm = mod(REF, "mock")
        node, down = rm.node(), rm.node()
        job = rm.job()
        job.task_groups[0].count = 1
        ref, got = run_both(_gc_scenario, node, down, job)
        assert got == ref
        assert (got["young"], got["forced"]) == (0, 1)
        assert got["evals"] == ["pending-e"]
        assert (got["ready_nodes"], got["down_nodes"]) == (0, 1)
        assert got["nodes"] == [node.id]
        assert (got["job_left"], got["job_evals"], got["job_allocs"]) == \
            (False, 0, 0)
