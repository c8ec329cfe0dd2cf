"""Preemptor — selects lower-priority victim allocations on one node.

Behavioral reference: `scheduler/preemption.go` (Preemptor :96,
PreemptForTaskGroup :198, PreemptForNetwork :270, PreemptForDevice :472,
filterAndGroupPreemptibleAllocs :663, filterSuperset :702, distance math
:608-661) and the logistic preemption score `scheduler/rank.go:747-783`.

Division of labor, as in the reference package: the *node ranking* half of
preemption (which node could admit this ask if low-priority allocs were
evicted, and how good would that be) runs over every node row on the
device (`kernels/preemption.py`, K3 — sort + prefix scan over the per-node
alloc axis). This module is the host half: the exact greedy victim-set
selection on the ONE chosen node, a sequential, order-dependent loop over
a few dozen allocs that the reference also runs scalar.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..convert import tensor_from_numpy
from ..device import DeviceLike, resolve_device
from ..kernels.placement import ClusterArrays
from ..kernels.preemption import (CompactCandidates, preempt_best,
                                  preempt_rank_compact)
from ..structs import Allocation, NetworkResource
from ..structs.funcs import (  # noqa: F401 — re-exported parity anchors
    PREEMPTION_SCORE_ORIGIN,
    PREEMPTION_SCORE_RATE,
    preemption_score,
)
from ..structs.resources import ComparableResources
from ..utils import bucket
from .util import proposed_allocs

# Score penalty applied per already-preempted alloc of the same job/tg beyond
# its migrate max_parallel (reference preemption.go:13).
MAX_PARALLEL_PENALTY = 50.0

# Minimum priority delta between the preempting job and a victim
# (reference preemption.go:677 "within a delta of 10").
PRIORITY_DELTA = 10


def basic_resource_distance(ask: ComparableResources,
                            used: ComparableResources) -> float:
    """Euclidean distance in normalized (cpu, mem, disk) coordinates
    (reference preemption.go:608)."""
    mem = cpu = disk = 0.0
    if ask.memory_mb > 0:
        mem = (ask.memory_mb - used.memory_mb) / ask.memory_mb
    if ask.cpu > 0:
        cpu = (ask.cpu - used.cpu) / ask.cpu
    if ask.disk_mb > 0:
        disk = (ask.disk_mb - used.disk_mb) / ask.disk_mb
    return math.sqrt(mem * mem + cpu * cpu + disk * disk)


def network_resource_distance(used: Optional[NetworkResource],
                              needed: Optional[NetworkResource]) -> float:
    """Distance on megabits only (reference preemption.go:627)."""
    if used is None or needed is None or needed.mbits == 0:
        return float("inf")
    return abs((needed.mbits - used.mbits) / needed.mbits)


def score_for_task_group(ask: ComparableResources, used: ComparableResources,
                         max_parallel: int, num_preempted: int) -> float:
    """Distance + migrate max_parallel penalty (reference preemption.go:640)."""
    penalty = 0.0
    if max_parallel > 0 and num_preempted >= max_parallel:
        penalty = float(num_preempted + 1 - max_parallel) * MAX_PARALLEL_PENALTY
    return basic_resource_distance(ask, used) + penalty


def score_for_network(used: Optional[NetworkResource],
                      needed: Optional[NetworkResource],
                      max_parallel: int, num_preempted: int) -> float:
    """Reference preemption.go:650."""
    if used is None or needed is None:
        return float("inf")
    penalty = 0.0
    if max_parallel > 0 and num_preempted >= max_parallel:
        penalty = float(num_preempted + 1 - max_parallel) * MAX_PARALLEL_PENALTY
    return network_resource_distance(used, needed) + penalty


def net_priority(allocs: List[Allocation]) -> float:
    """Max victim priority plus sum/max crowding penalty (rank.go:747)."""
    total = 0
    mx = 0.0
    for a in allocs:
        p = a.job.priority if a.job is not None else 0
        mx = max(mx, float(p))
        total += p
    if mx == 0.0:
        return 0.0
    return mx + total / mx


def _alloc_priority(alloc: Allocation) -> int:
    return alloc.job.priority if alloc.job is not None else 0


def filter_and_group_preemptible(job_priority: int,
                                 allocs: List[Allocation]
                                 ) -> List[Tuple[int, List[Allocation]]]:
    """Group eligible victims by job priority, ascending
    (reference preemption.go:663)."""
    by_prio: Dict[int, List[Allocation]] = {}
    for a in allocs:
        if a.job is None:
            continue
        if job_priority - _alloc_priority(a) < PRIORITY_DELTA:
            continue
        by_prio.setdefault(_alloc_priority(a), []).append(a)
    return sorted(by_prio.items(), key=lambda kv: kv[0])


class Preemptor:
    """Greedy victim selection on a single node (reference preemption.go:96)."""

    def __init__(self, job_priority: int, namespace: str, job_id: str) -> None:
        self.job_priority = job_priority
        self.namespace = namespace
        self.job_id = job_id
        self.current_allocs: List[Allocation] = []
        self._resources: Dict[str, ComparableResources] = {}
        self._max_parallel: Dict[str, int] = {}
        self._preemption_counts: Dict[Tuple[str, str, str], int] = {}
        self.node_remaining: Optional[ComparableResources] = None

    # -- setup (reference SetNode/SetCandidates/SetPreemptions) --

    def set_node(self, node) -> None:
        rem = node.comparable_resources()
        reserved = node.comparable_reserved_resources()
        if reserved is not None:
            rem.subtract(reserved)
        self.node_remaining = rem

    def set_candidates(self, allocs: List[Allocation]) -> None:
        self.current_allocs = []
        for a in allocs:
            if a.job_id == self.job_id and a.namespace == self.namespace:
                continue  # never preempt the job being placed
            max_par = 0
            tg = a.job.lookup_task_group(a.task_group) if a.job else None
            if tg is not None and tg.migrate_strategy is not None:
                max_par = tg.migrate_strategy.max_parallel
            self._resources[a.id] = a.comparable_resources()
            self._max_parallel[a.id] = max_par
            self.current_allocs.append(a)

    def set_preemptions(self, allocs: List[Allocation]) -> None:
        self._preemption_counts = {}
        for a in allocs:
            key = (a.namespace, a.job_id, a.task_group)
            self._preemption_counts[key] = self._preemption_counts.get(key, 0) + 1

    def _num_preemptions(self, alloc: Allocation) -> int:
        return self._preemption_counts.get(
            (alloc.namespace, alloc.job_id, alloc.task_group), 0
        )

    # -- selection (reference PreemptForTaskGroup :198) --

    def preempt_for_task_group(self, ask: ComparableResources
                               ) -> List[Allocation]:
        needed = ask.copy()
        remaining = self.node_remaining.copy()
        for a in self.current_allocs:
            remaining.subtract(self._resources[a.id])

        grouped = filter_and_group_preemptible(
            self.job_priority, self.current_allocs
        )
        best: List[Allocation] = []
        available = remaining.copy()
        met = False
        for _prio, grp in grouped:
            grp = list(grp)
            while grp and not met:
                # Pick the alloc with the lowest distance-to-ask score.
                best_i, best_d = -1, float("inf")
                for i, a in enumerate(grp):
                    d = score_for_task_group(
                        needed, self._resources[a.id],
                        self._max_parallel[a.id], self._num_preemptions(a)
                    )
                    if d < best_d:
                        best_d, best_i = d, i
                chosen = grp.pop(best_i)
                res = self._resources[chosen.id]
                available.add(res)
                met, _ = available.superset(ask)
                best.append(chosen)
                needed.subtract(res)
            if met:
                break
        if not met:
            return []
        return self._filter_superset_basic(best, remaining, ask)

    def _filter_superset_basic(self, best: List[Allocation],
                               remaining: ComparableResources,
                               ask: ComparableResources) -> List[Allocation]:
        """Drop victims whose resources another victim already covers
        (reference filterSuperset :702): re-add by descending distance and
        stop at the first prefix meeting the ask."""
        best = sorted(
            best,
            key=lambda a: basic_resource_distance(ask, self._resources[a.id]),
            reverse=True,
        )
        available = remaining.copy()
        out: List[Allocation] = []
        for a in best:
            out.append(a)
            available.add(self._resources[a.id])
            met, _ = available.superset(ask)
            if met:
                break
        return out

    # -- network preemption (reference PreemptForNetwork :270) --

    def preempt_for_network(self, ask: NetworkResource, net_idx
                            ) -> List[Allocation]:
        if not self.current_allocs:
            return []
        reserved_needed = {p.value for p in ask.reserved_ports}

        device_to_allocs: Dict[str, List[Allocation]] = {}
        filtered_ports: Dict[str, set] = {}
        for a in self.current_allocs:
            if a.job is None:
                continue
            nets = self._alloc_networks(a)
            if not nets:
                continue
            net = nets[0]  # reference also only checks the first network
            if self.job_priority - _alloc_priority(a) < PRIORITY_DELTA:
                for p in net.reserved_ports:
                    filtered_ports.setdefault(net.device, set()).add(p.value)
                continue
            device_to_allocs.setdefault(net.device, []).append(a)

        for device, allocs in device_to_allocs.items():
            # Reserved ports held by non-preemptible allocs block the device.
            if reserved_needed & filtered_ports.get(device, set()):
                continue
            # Ports held by preemptible allocs on this device: each needed
            # reserved port must end up released (held by a chosen victim) or
            # never held at all.
            held_by: Dict[int, set] = {}
            for a in allocs:
                net = self._alloc_networks(a)[0]
                for port in list(net.reserved_ports) + list(net.dynamic_ports):
                    held_by.setdefault(port.value, set()).add(a.id)
            released: set = set()
            mbits_freed = 0
            chosen: List[Allocation] = []
            allocs = sorted(
                allocs,
                key=lambda a: score_for_network(
                    self._alloc_networks(a)[0], ask,
                    self._max_parallel[a.id], self._num_preemptions(a)
                ),
            )
            free_mbits = self._device_free_mbits(net_idx, device)
            for a in allocs:
                net = self._alloc_networks(a)[0]
                chosen.append(a)
                mbits_freed += net.mbits
                released.update(p.value for p in net.reserved_ports)
                released.update(p.value for p in net.dynamic_ports)
                chosen_ids = {c.id for c in chosen}
                ports_ok = all(
                    port in released or not (held_by.get(port, set()) - chosen_ids)
                    for port in reserved_needed
                )
                if free_mbits + mbits_freed >= ask.mbits and ports_ok:
                    return self._filter_superset_network(
                        chosen, free_mbits, ask
                    )
        return []

    def _filter_superset_network(self, best: List[Allocation],
                                 free_mbits: int, ask: NetworkResource
                                 ) -> List[Allocation]:
        best = sorted(
            best,
            key=lambda a: network_resource_distance(
                self._alloc_networks(a)[0], ask
            ),
            reverse=True,
        )
        out: List[Allocation] = []
        freed = 0
        for a in best:
            out.append(a)
            freed += self._alloc_networks(a)[0].mbits
            if free_mbits + freed >= ask.mbits:
                break
        return out

    @staticmethod
    def _alloc_networks(a: Allocation) -> List[NetworkResource]:
        cr = a.comparable_resources()
        return list(cr.networks)

    @staticmethod
    def _device_free_mbits(net_idx, device: str) -> int:
        if net_idx is None:
            return 0
        avail = net_idx.avail_bandwidth.get(device, 0)
        used = net_idx.used_bandwidth.get(device, 0)
        return max(avail - used, 0)

    # -- device preemption (reference PreemptForDevice :472) --

    def preempt_for_device(self, device_name: str, needed_count: int,
                           free_count: int) -> List[Allocation]:
        """Victims using instances of a matching device, lowest net priority
        first. `free_count` is the device's currently-free instance count."""
        users: List[Tuple[Allocation, int]] = []
        for a in self.current_allocs:
            if a.job is None:
                continue
            if self.job_priority - _alloc_priority(a) < PRIORITY_DELTA:
                continue
            n = self._alloc_device_instances(a, device_name)
            if n > 0:
                users.append((a, n))
        if not users:
            return []
        # Group by priority ascending, accumulate until count met.
        users.sort(key=lambda t: (_alloc_priority(t[0]), -t[1]))
        chosen: List[Allocation] = []
        count = free_count
        for a, n in users:
            if count >= needed_count:
                break
            chosen.append(a)
            count += n
        if count < needed_count:
            return []
        # Minimality pass: prefer fewer victims (instances descending).
        chosen.sort(
            key=lambda a: -self._alloc_device_instances(a, device_name)
        )
        out: List[Allocation] = []
        count = free_count
        for a in chosen:
            if count >= needed_count:
                break
            out.append(a)
            count += self._alloc_device_instances(a, device_name)
        return out

    @staticmethod
    def _alloc_device_instances(a: Allocation, device_name: str) -> int:
        if a.allocated_resources is None:
            return 0
        total = 0
        for tr in a.allocated_resources.tasks.values():
            for dev in tr.devices:
                if device_name in (dev.name, f"{dev.type}/{dev.name}",
                                   f"{dev.vendor}/{dev.type}/{dev.name}",
                                   dev.type):
                    total += len(dev.device_ids)
        return total


# ---------------------------------------------------------------------------
# Orchestration: kernel-ranked node search + host victim refinement
# ---------------------------------------------------------------------------

def _eligible_victims(job, allocs: List[Allocation]) -> List[Allocation]:
    out = []
    for a in allocs:
        if a.job_id == job.id and a.namespace == job.namespace:
            continue
        if a.job is None:
            continue
        if job.priority - _alloc_priority(a) < PRIORITY_DELTA:
            continue
        out.append(a)
    return out


def candidate_table(state, cluster, job, plan
                    ) -> Optional[CompactCandidates]:
    """Per-node eligible-victim table on the host, in compact form: each
    row's eligible victims in its slots 0, 1, … (prio f32, usage f32[R]),
    A the bucketed largest victim count; `dense_candidates` gives the
    reference's [N, A] table with its pads at INF_PRIO. None when no node
    has an eligible victim."""
    per_row: Dict[int, List[Allocation]] = {}
    a_max = 0
    for node_id, row in cluster.row_of.items():
        cands = _eligible_victims(job, proposed_allocs(state, plan, node_id))
        if cands:
            per_row[row] = cands
            a_max = max(a_max, len(cands))
    if not per_row:
        return None

    n = cluster.n_cap
    a_cap = bucket(a_max)
    counts = np.zeros(n, dtype=np.int32)
    prio, usage = [], []
    for row in sorted(per_row):
        cands = per_row[row][:a_cap]
        counts[row] = len(cands)
        prio += [_alloc_priority(a) for a in cands]
        usage += [cluster.usage_row(a) for a in cands]
    offsets = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(counts, out=offsets[1:])
    slot = (np.arange(offsets[-1], dtype=np.int32)
            - np.repeat(offsets[:-1], counts))
    return CompactCandidates(offsets, slot, np.array(prio, np.float32),
                             np.array(usage, np.float32), a_cap)


def ranked_snapshot(cluster) -> ClusterArrays:
    """The four host arrays K3 reads — capacity, used, node_ok and attrs —
    of a fresh `cluster.snapshot()`, the state the reference ranks
    against (its port bitmap and dyn_free None: K3 never reads them). Not
    the cached device view: that is refreshed on its own schedule, not
    this snapshot."""
    snap = cluster.snapshot()
    return ClusterArrays(capacity=snap.capacity, used=snap.used,
                         node_ok=snap.node_ok, attrs=snap.attrs,
                         ports_used=None, dyn_free=None)


def ranked_cluster(cluster, device: DeviceLike = None) -> ClusterArrays:
    """`ranked_snapshot` uploaded to `device` as the four tensors K3 reads,
    each in its kernel type (the route the retry took before its ranking
    read host arrays: a copy a tensor)."""
    dev = resolve_device(device)
    snap = ranked_snapshot(cluster)
    attrs = np.asarray(snap.attrs)
    return ClusterArrays(
        capacity=tensor_from_numpy(snap.capacity, dev, np.float32),
        used=tensor_from_numpy(snap.used, dev, np.float32),
        node_ok=tensor_from_numpy(snap.node_ok, dev, np.bool_),
        attrs=tensor_from_numpy(
            attrs, dev,
            None if attrs.dtype in (np.int16, np.int32) else np.int32),
        ports_used=None,
        dyn_free=None,
    )


def find_preemption_placement(state, cluster, job, tg, params, plan,
                              device: DeviceLike = None
                              ) -> Optional[Tuple[str, List[Allocation], float]]:
    """Full preemption pass for one failed placement: rank every node on
    `device` (K3, `kernels/preemption.py`), then refine the winner's
    victim set with the faithful greedy Preemptor. Returns (node_id,
    victims, score) or None. The ranking reads host arrays — the snapshot,
    `compile_tg`'s numpy program and the compact victim table — which on a
    card go in one staged copy with one launch; its best row, prefix and
    score come back in one copy.

    Replaces the reference's evict-enabled BinPackIterator retry
    (`rank.go:228-448` + `generic_sched.go:720-738` selectNextOption).
    """
    # A literal-LTarget distinct_property caps TOTAL placements via the
    # n_place clamp (stack._dp_program), not a node mask — a clamp to zero
    # means no further alloc may exist anywhere, so eviction can't help.
    if int(params.n_place) < 1:
        return None

    table = candidate_table(state, cluster, job, plan)
    if table is None:
        return None

    best_row, _k, best_score = preempt_best(preempt_rank_compact(
        ranked_snapshot(cluster), params, table, device=device))
    if best_row < 0:
        return None
    node_id = cluster.node_of_row[best_row]
    if node_id is None:
        return None

    node = state.node_by_id(node_id)
    preemptor = Preemptor(job.priority, job.namespace, job.id)
    preemptor.set_node(node)
    preemptor.set_candidates(proposed_allocs(state, plan, node_id))
    preemptor.set_preemptions(
        [a for lst in plan.node_preemptions.values() for a in lst]
    )
    res = job.combined_task_resources(tg)
    ask = ComparableResources(
        cpu=res.cpu, memory_mb=res.memory_mb, disk_mb=res.disk_mb
    )
    victims = preemptor.preempt_for_task_group(ask)
    if not victims:
        return None
    return node_id, victims, best_score


def preempt_on_node(state, job, tg, node_id: str, plan) -> List[Allocation]:
    """System-scheduler preemption: victims on ONE fixed node
    (reference system_sched.go preemption path — no cross-node ranking)."""
    from .util import proposed_allocs

    node = state.node_by_id(node_id)
    if node is None:
        return []
    preemptor = Preemptor(job.priority, job.namespace, job.id)
    preemptor.set_node(node)
    preemptor.set_candidates(proposed_allocs(state, plan, node_id))
    preemptor.set_preemptions(
        [a for lst in plan.node_preemptions.values() for a in lst]
    )
    res = job.combined_task_resources(tg)
    ask = ComparableResources(
        cpu=res.cpu, memory_mb=res.memory_mb, disk_mb=res.disk_mb
    )
    return preemptor.preempt_for_task_group(ask)
