"""A new leader of the port's region commits a Raft barrier before its
subsystems start (`nomad_tpu_torch/server/cluster.py`
`ClusterServer._establish_leadership`; the reference's `leaderLoop`
in `nomad/leader.go` does the same before `establishLeadership`).

Each case holds one follower's FSM applier on a `threading.Event`, so the
follower's log is whole while its state lags, then nudges that follower
into leadership with `raft._run_election()`. Without the barrier the new
leader restored an eval the previous term had already completed and
placed its job a second time: every server ended with 20 of its 10
allocs. Every wait is on an event or a condition, bounded.
"""
import threading
import time

import pytest

from nomad_tpu_torch import mock

from test_torch_cluster import _shutdown, _wait, leader_of, make_cluster

#: the longest a held applier stays held when nothing releases it first
HOLD_S = 15.0


@pytest.fixture()
def region():
    agents = make_cluster(3, device="cpu")
    try:
        assert _wait(lambda: leader_of(agents) is not None)
        leader = leader_of(agents)
        assert _wait(lambda: leader.server._running)
        yield agents, leader
    finally:
        _shutdown(agents)


class _Hold:
    """Holds `agent`'s FSM applier at the first entry whose op is `op`
    (any op when None) until `release()`, or HOLD_S at most."""

    def __init__(self, agent, op=None):
        self.held = threading.Event()
        self._release = threading.Event()
        self._armed = True
        real = agent.raft.apply_fn

        def apply_fn(data):
            if self._armed and (op is None or data.get("op") == op):
                self._armed = False
                self.held.set()
                self._release.wait(HOLD_S)
            return real(data)

        agent.raft.apply_fn = apply_fn

    def release(self):
        self._release.set()


def _caught_up(agents):
    return len({a.raft.log.last_index() for a in agents}) == 1


def _nudge(agents, target):
    """`target` runs elections until it leads, each once every log is
    equal, as the region twins nudge a transition."""
    for _ in range(20):
        if not _wait(lambda: _caught_up(agents), timeout=2.0):
            continue
        target.raft._run_election()
        if _wait(target.is_leader, timeout=3.0):
            return True
    return False


def _settled(agents, leader, job):
    """The new leader's subsystems are up, every eval of `job` is
    terminal on it, and every server applied all it committed."""
    if not (leader.is_leader() and leader.server._running):
        return False
    evals = leader.state.evals_by_job(job.namespace, job.id)
    if not evals or any(not e.terminal_status() for e in evals):
        return False
    commit = leader.raft.commit_index
    return all(a.raft.last_applied == commit for a in agents)


def _held_leader(region, op=None):
    """A follower whose applier is held at a node registered through the
    leader, nudged into leadership: (agents, old leader, new, hold)."""
    agents, old = region
    new = next(a for a in agents if a is not old)
    hold = _Hold(new, op)
    old.call("node_register", mock.node())
    assert hold.held.wait(10.0)
    assert _nudge(agents, new), "the held follower never led"
    return agents, old, new, hold


def test_a_flap_places_each_alloc_once(region):
    """The gate: a follower that held the previous term's placement
    unapplied wins leadership; the job keeps 10 allocs on every server."""
    agents, old = region
    for _ in range(4):
        old.call("node_register", mock.node())
    new = next(a for a in agents if a is not old)
    hold = _Hold(new, "upsert_plan_results")
    try:
        job = mock.job()
        job.task_groups[0].count = 10
        ev = old.call("job_register", job)
        done = old.server.wait_for_eval(ev.id, timeout=20.0)
        assert done is not None and done.status == "complete"
        assert hold.held.wait(10.0)
        held = new.state.eval_by_id(ev.id)
        assert held is not None and held.status == "pending"
        assert new.state.allocs_by_job(job.namespace, job.id) == []
        old_last = old.raft.log.last_index()
        assert _nudge(agents, new), "the held follower never led"
        # released once the new term wrote past the old one's last
        # entry (the barrier, or a placement of its own), else after a
        # bounded wait
        _wait(lambda: new.raft.log.last_index() > old_last, timeout=10.0)
        hold.release()
        assert _wait(lambda: _settled(agents, new, job), timeout=30.0)
        counts = {a.config.node_id:
                  len(a.state.allocs_by_job(job.namespace, job.id))
                  for a in agents}
        assert counts == {a.config.node_id: 10 for a in agents}
    finally:
        hold.release()


def test_subsystems_wait_for_the_barrier(region):
    """A leader whose applier is held has not started its subsystems:
    they start once the held entry and the barrier apply."""
    agents, old, new, hold = _held_leader(region)
    try:
        assert new.is_leader()
        time.sleep(1.0)
        assert not new.server._running
        assert new.last_barrier_ms is None
        hold.release()
        assert _wait(lambda: new.server._running, timeout=20.0)
        assert new.last_barrier_ms > 0.0
    finally:
        hold.release()


def test_shutdown_returns_during_a_held_barrier(region):
    """A shutdown does not wait on a barrier in flight, and the barrier
    that then completes starts nothing."""
    agents, old, new, hold = _held_leader(region)
    try:
        t0 = time.monotonic()
        new.shutdown()
        assert time.monotonic() - t0 < 3.0
    finally:
        hold.release()
    assert not _wait(lambda: new.server._running, timeout=1.0)


def test_forwarded_register_waits_out_the_barrier(region):
    """A job registered through a follower while the new leader's
    barrier is held is served once its subsystems are up."""
    agents, old, new, hold = _held_leader(region)
    out = {}

    def register():
        try:
            job = mock.job()
            out["job"] = job
            out["eval"] = old.call("job_register", job, timeout=20.0)
        except Exception as e:  # noqa: BLE001 — asserted below
            out["error"] = e

    caller = threading.Thread(target=register, daemon=True)
    try:
        caller.start()
        caller.join(1.0)
        assert caller.is_alive(), out
        assert not new.server._running
        hold.release()
        caller.join(25.0)
        assert not caller.is_alive()
        assert "error" not in out, out.get("error")
        done = new.server.wait_for_eval(out["eval"].id, timeout=20.0)
        assert done is not None and done.status == "complete"
    finally:
        hold.release()
