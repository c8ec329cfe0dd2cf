"""Shared twins for the port's view-cache, speculation and residency tests.

`REF` and `PORT` bundle each package's stack, coordinator and structs
behind one surface, so a test runs the same churn and rounds through the
reference (`TPUStack`/`SelectCoordinator` on JAX's CPU backend) and the
port (`TorchStack(device="cpu")`, the plain versions of its kernels) and
compares what comes out. Objects are built once by the reference's
generators and cross into the port through the wire format, so both
packages see identical nodes, jobs and allocs.

Helpers mirror the reference's own test helpers
(`tests/test_program_table.py` `_run_round`/`_commit_round`,
`tests/test_spec.py` `_start_parked`/`_drive_chain`/`_dc_*`) for either
package.
"""
from __future__ import annotations

import random
import threading
import time
import uuid

import numpy as np

from nomad_tpu import mock
from nomad_tpu.structs.codec import to_wire

from nomad_tpu_torch.structs.codec import from_wire


class Pkg:
    """One package's surface for the twin tests."""

    def __init__(self, name: str) -> None:
        self.name = name
        if name == "ref":
            from nomad_tpu.lib import hbm, metrics, transfer
            from nomad_tpu.mock import alloc_resources
            from nomad_tpu.scheduler import generic, stack
            from nomad_tpu.server import select_batch
            from nomad_tpu.structs import Allocation
            from nomad_tpu.tensor import ClusterTensors, cluster

            self.conv = lambda o: o
            self.make_stack = stack.TPUStack
        else:
            from nomad_tpu_torch.lib import hbm, metrics, transfer
            from nomad_tpu_torch.mock import alloc_resources
            from nomad_tpu_torch.scheduler import generic, stack
            from nomad_tpu_torch.server import select_batch
            from nomad_tpu_torch.structs import Allocation
            from nomad_tpu_torch.tensor import ClusterTensors, cluster

            self.conv = lambda o: from_wire(to_wire(o))
            self.make_stack = lambda cl: stack.TorchStack(cl, device="cpu")
        self.hbm, self.metrics, self.transfer = hbm, metrics, transfer
        self.generic, self.stack_mod, self.sb = generic, stack, select_batch
        self.cluster_mod = cluster
        self.Allocation, self.alloc_resources = Allocation, alloc_resources
        self.ClusterTensors = ClusterTensors

    def __repr__(self) -> str:
        return self.name

    # ---- the view ----

    def view_np(self, arrays) -> dict:
        """A numpy COPY of a view (the port writes cached tensors in
        place, so a view kept across a refresh must not alias them); the
        port's port bitmap back as u32."""
        out = {}
        for f in arrays._fields:
            a = np.array(getattr(arrays, f), copy=True)
            if f == "ports_used" and a.dtype == np.int32:
                a = a.view(np.uint32)
            out[f] = a
        return out

    def cold_view(self, cl) -> dict:
        """A full upload of the current state: drop the device cache so a
        fresh stack pays the cold path."""
        self.stack_mod._DEV_CACHE.pop(cl, None)
        return self.view_np(self.make_stack(cl).device_arrays())

    def cache_entry(self, cl):
        ent = self.stack_mod._DEV_CACHE.get(cl)
        if ent is not None and self.name == "port":
            ent = next(iter(ent.values()))
        return ent

    def counters(self, prefix: str) -> dict:
        return dict(self.metrics.default_registry().counters(prefix=prefix))

    def counter(self, name: str) -> int:
        return self.counters("view.").get(name, 0)

    def ledger(self) -> dict:
        return self.transfer.default_ledger().snapshot()

    # ---- objects ----

    def cluster(self, nodes):
        cl = self.ClusterTensors()
        for n in nodes:
            cl.upsert_node(self.conv(n))
        return cl

    def alloc(self, node_id, job_id="job-a", cpu=100, memory_mb=64,
              disk_mb=10, networks=(), alloc_id=None):
        return self.Allocation(
            id=alloc_id or uuid.uuid4().hex, namespace="default",
            job_id=job_id, task_group="web", node_id=node_id,
            allocated_resources=self.alloc_resources(
                cpu=cpu, memory_mb=memory_mb, disk_mb=disk_mb,
                networks=[self.conv(n) for n in networks]),
            desired_status="run", client_status="pending")

    # ---- coordinator rounds (tests/test_program_table.py shapes) ----

    def run_round(self, cl, jobs, coord=None, eval_ids=None, plans=None):
        coord = coord or self.sb.SelectCoordinator()
        if eval_ids:
            coord.trace_ids = dict(enumerate(eval_ids))
        results = {}

        def one(i, job):
            stack = self.make_stack(cl)
            stack.coordinator = coord
            stack.coordinator_order = i
            try:
                r = stack.select(job, job.task_groups[0], 1,
                                 (plans or {}).get(i))
                results[i] = (r.node_ids, r.ask, r.carry_token,
                              [float(x) for x in r.scores])
            finally:
                coord.thread_done()

        threads = []
        for i, j in enumerate(jobs):
            coord.add_thread()
            threads.append(threading.Thread(
                target=one, args=(i, self.conv(j)), daemon=True))
        for t in threads:
            t.start()
        coord.run()
        for t in threads:
            t.join(30.0)
        return coord, results

    def commit_round(self, cl, results, eval_ids, exact=True, clean=True,
                     skip_evals=(), wrong_token=False):
        """Host-commit each eval's placements as the plan applier would
        (usage == the compiled ask), one window mark per eval stamped
        with the dispatch token the selection reported."""
        for i, eid in enumerate(eval_ids):
            if eid in skip_evals:
                continue
            node_ids, ask, token = results[i][:3]
            if wrong_token:
                token = (token or 0) + 10_000
            v_lo = cl.version
            for nid in node_ids:
                if nid is None:
                    continue
                cl.upsert_alloc(self.alloc(
                    nid, job_id=f"job-{eid}", cpu=int(ask[0]),
                    memory_mb=int(ask[1]), disk_mb=int(ask[2])))
            cl.mark_plan_window(eid, v_lo, cl.version, clean=clean,
                                exact=exact, token=token)

    def start_parked(self, cl, jobs, coord):
        """One scheduler thread per job; they compile and PARK at the
        coordinator (run() not yet driven)."""
        results = {}

        def one(i, job):
            stack = self.make_stack(cl)
            stack.coordinator = coord
            stack.coordinator_order = i
            try:
                r = stack.select(job, job.task_groups[0], 1, None)
                results[i] = (r.node_ids, r.ask, r.carry_token,
                              [float(x) for x in r.scores])
            finally:
                coord.thread_done()

        threads = []
        for i, j in enumerate(jobs):
            coord.add_thread()
            t = threading.Thread(target=one, args=(i, self.conv(j)),
                                 daemon=True)
            threads.append(t)
            t.start()
        deadline = time.time() + 20.0
        while time.time() < deadline:
            with coord._cv:
                if coord._parked and len(coord._parked) >= coord._live:
                    return threads, results
            time.sleep(0.002)
        raise AssertionError("schedulers never parked")

    def coordinator(self, reg=None, ids=(), groups=None, footprints=None):
        coord = self.sb.SelectCoordinator(registry=reg)
        coord.trace_ids = dict(enumerate(ids))
        if groups is not None:
            coord.group_ids = groups
        if footprints is not None:
            coord.footprints = footprints
        return coord

    def drive_chain(self, cl, monkeypatch, k=3, reg=None):
        """Round 0 REAL dispatch, then k speculative rounds certified
        clean (tests/test_spec.py `_drive_chain`). Returns (reg,
        last_res, last_ids) with the final round's plans uncommitted."""
        monkeypatch.setenv("NOMAD_TPU_SPEC_ROLLBACK_MAX", "1.0")
        reg = reg if reg is not None else self.metrics.MetricsRegistry()
        prev_ids = ["c0-a", "c0-b"]
        _c0, prev_res = self.run_round(
            cl, [dc_job("dc1"), dc_job("dc2")], eval_ids=prev_ids)
        for n in range(1, k + 1):
            ids = [f"c{n}-a", f"c{n}-b"]
            jobs = [dc_job("dc1", cpu=100 + 10 * n),
                    dc_job("dc2", cpu=100 + 10 * n)]
            coord = self.coordinator(reg, ids, {0: 0, 1: 1},
                                     {0: dc_mask(cl, "dc1"),
                                      1: dc_mask(cl, "dc2")})
            threads, res = self.start_parked(cl, jobs, coord)
            assert coord.try_spec_launch(cl), f"round {n} never speculated"
            self.commit_round(cl, prev_res, prev_ids)
            coord.run()
            for t in threads:
                t.join(30.0)
            prev_res, prev_ids = res, ids
        return reg, prev_res, prev_ids


REF, PORT = Pkg("ref"), Pkg("port")
BOTH = (REF, PORT)


def assert_views_equal(a: dict, b: dict, what: str = "") -> None:
    for f, x in a.items():
        y = b[f]
        assert x.dtype == y.dtype and x.shape == y.shape, (what, f)
        assert np.array_equal(x, y), \
            f"{what}: {f} differs at rows " \
            f"{np.argwhere(x != y)[:5].tolist()}"


def assert_same_placements(ref: dict, got: dict, what: str = "") -> None:
    """Node ids equal, scores within 1e-6 (XLA's exp against torch.exp2;
    the port's plain versions and the reference round differently by an
    ulp at most)."""
    assert set(ref) == set(got), what
    for i in ref:
        assert ref[i][0] == got[i][0], (what, i)
        np.testing.assert_allclose(got[i][3], ref[i][3], rtol=0, atol=1e-6,
                                   err_msg=f"{what} {i}")


def mini_nodes(n_nodes=12, cpu=4000, mem=8192):
    """tests/test_program_table.py `_mini_cluster`'s nodes."""
    nodes = []
    for i in range(n_nodes):
        n = mock.node()
        n.id = f"node-{i}"
        n.node_resources.cpu = int(cpu)
        n.node_resources.memory_mb = int(mem)
        nodes.append(n)
    return nodes


def dc_nodes(n_nodes=8, n_dcs=2):
    """tests/test_spec.py `_dc_cluster`'s nodes."""
    nodes = []
    for i in range(n_nodes):
        n = mock.node()
        n.id = f"node-{i}"
        n.datacenter = f"dc{1 + i % n_dcs}"
        n.node_resources.cpu = 4000
        n.node_resources.memory_mb = 8192
        nodes.append(n)
    return nodes


def dc_job(dc, cpu=300):
    j = mock.job()
    j.datacenters = [dc]
    j.task_groups[0].tasks[0].resources.cpu = cpu
    j.task_groups[0].tasks[0].resources.memory_mb = 64
    j.task_groups[0].networks = []
    return j


def dc_mask(cl, dc):
    m = np.zeros(cl.n_cap, dtype=bool)
    for nid, row in cl.row_of.items():
        if cl.nodes[nid].datacenter == dc:
            m[row] = True
    return m


def mixed_job(rng, i):
    """tests/test_program_table.py `_job`: the synth flavor matrix."""
    from nomad_tpu.structs import Constraint, Spread, SpreadTarget

    j = mock.job()
    j.task_groups[0].tasks[0].resources.cpu = rng.choice((100, 250, 400))
    j.task_groups[0].tasks[0].resources.memory_mb = rng.choice((64, 128))
    j.task_groups[0].networks = []
    if i % 2 == 0:
        j.constraints.append(Constraint("${node.datacenter}", "dc1", "="))
    if i % 3 == 0:
        j.spreads.append(Spread(attribute="${node.datacenter}", weight=50,
                                spread_target=[
                                    SpreadTarget(value="dc1", percent=60)]))
    if i % 5 == 0:
        j.constraints.append(Constraint(operand="distinct_hosts"))
    return j


def seeded(seed):
    return random.Random(seed)
