"""Device mesh + sharding layout for the scheduling kernels.

The counterpart of the reference package's `parallel/mesh.py` for PyTorch.
The reference scales scheduling over a 2-D mesh of devices:

  axis "batch" — independent pending evaluations (the domain's data
                 parallelism; the broker already serializes per-JobID,
                 `nomad/structs/structs.go:9524`, so a dequeued batch is safe)
  axis "nodes" — the cluster's node axis (the domain's sequence/context
                 parallelism; full-width masks instead of sampling)

There GSPMD partitions the jitted kernels from sharding annotations. Here
one process drives the whole mesh, as JAX's single controller does: a
`Mesh` is a [batch, nodes] grid of `torch.device`s, devices may repeat
(four shards on one card, or on `cpu` in the tests, stand in for the
reference's virtual devices), `shard_cluster` splits the view's rows into
node shards on those devices, and the sharded step is K9
(`kernels/shard.py`): each shard's local argmax combined on the batch row's
lead device, in place of GSPMD's all-reduce.

`STATIC_DIMS`, `param_dims`, `pad_params` and `stack_params` live in
`parallel/pad.py` and are re-exported here, where the reference has them.
"""
from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.placement import ClusterArrays, PlacementResult, TGParams
from ..kernels.shard import ShardedCluster, sharded_place
from .pad import STATIC_DIMS, pad_params, param_dims, stack_params  # noqa: F401

BATCH_AXIS = "batch"
NODE_AXIS = "nodes"


class Mesh:
    """A [batch, nodes] grid of devices and the names of its two axes."""

    def __init__(self, devices: np.ndarray,
                 axis_names=(BATCH_AXIS, NODE_AXIS)) -> None:
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def grid(self) -> tuple:
        """The devices as a tuple of rows (one per batch index)."""
        return tuple(tuple(row) for row in self.devices.tolist())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


#: process-wide mesh the control plane shards its cluster view over (None =
#: single-device dispatch). `Server(ServerConfig(mesh=...))` installs it
#: and removes it on shutdown; the view cache (`TorchStack.device_arrays`)
#: then keeps a node-sharded view, and its readers take the sharded routes
#: (kernels/shard.py).
_ACTIVE_MESH: Optional[Mesh] = None


def set_active_mesh(mesh: Optional[Mesh]) -> None:
    """Install (or clear, with None) the control plane's device mesh."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def get_active_mesh() -> Optional[Mesh]:
    return _ACTIVE_MESH


def mesh_from_env() -> Optional[Mesh]:
    """Build a mesh from NOMAD_TPU_MESH: unset/"0"/"1" → None (single
    device), "auto" → all visible cards, an integer → that many."""
    spec = os.environ.get("NOMAD_TPU_MESH", "").strip().lower()
    if spec in ("", "0", "1", "off", "none"):
        return None
    if spec == "auto":
        n = None
    else:
        try:
            n = int(spec)
        except ValueError:
            raise ValueError(
                f"NOMAD_TPU_MESH={spec!r}: must be an integer device "
                f"count, 'auto', or unset/'off'") from None
    if n is not None and n <= 1:
        return None
    return make_mesh(n)


def make_mesh(n_devices: Optional[int] = None, batch: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ("batch", "nodes") mesh over the first `n_devices` of
    `devices` (default: the visible cards, cuda:0..count-1). Devices may
    repeat."""
    if devices is None:
        devices = [resolve_device(f"cuda:{i}")
                   for i in range(max(torch.cuda.device_count(), 1))]
    devices = [torch.device(d) for d in devices]
    n = len(devices) if n_devices is None else n_devices
    if not 1 <= n <= len(devices):
        raise ValueError(f"need {n} devices, have {len(devices)}")
    devices = devices[:n]
    if batch is None:
        # Node-axis size must divide the cluster row bucket (a power of two ≥
        # 64), so give NODE_AXIS the largest power-of-two divisor of n and put
        # the remainder on the eval-batch axis; with a pure power of two,
        # still keep a batch axis of 2 to exercise both parallelism forms.
        node = 1
        while n % (node * 2) == 0:
            node *= 2
        batch = n // node
        if batch == 1 and node >= 4:
            batch = 2
    if n % batch:
        raise ValueError(f"{n} devices not divisible by batch={batch}")
    nodes_dim = n // batch
    if nodes_dim & (nodes_dim - 1):
        raise ValueError(f"node axis {nodes_dim} must be a power of two to "
                         "divide row buckets")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(batch, nodes_dim), (BATCH_AXIS, NODE_AXIS))


class NamedSharding(NamedTuple):
    """How an array lies on a mesh: per dimension, the mesh axis it is
    split over, or None (replicated)."""

    mesh: Mesh
    spec: tuple


def cluster_sharding(mesh: Mesh) -> ClusterArrays:
    """Shardings for the cluster snapshot: node axis split over NODE_AXIS,
    replicated over the eval batch."""
    row = NamedSharding(mesh, (NODE_AXIS,))
    mat = NamedSharding(mesh, (NODE_AXIS, None))
    return ClusterArrays(capacity=mat, used=mat, node_ok=row, attrs=mat,
                         ports_used=mat, dyn_free=row)


def params_sharding(mesh: Mesh, batched: bool = True) -> TGParams:
    """Shardings for (batched) TGParams: the batch axis over BATCH_AXIS,
    replicated across the node ring (the sharded step rebases each
    shard's row indices itself)."""
    spec = (BATCH_AXIS,) if batched else ()
    return TGParams(*(NamedSharding(mesh, spec) for _ in TGParams._fields))


def shard_tensor(t: torch.Tensor, mesh: Mesh,
                 axis: int = 0) -> Dict[Tuple[torch.device, int],
                                        torch.Tensor]:
    """Tensor `t` split along `axis` into the mesh's node shards, each
    copied to its devices: {(device, node shard): copy}, one copy per
    distinct device of a node column. Raises ValueError when the shards
    do not divide the rows."""
    n = int(t.shape[axis])
    nm = mesh.devices.shape[1]
    if n % nm:
        raise ValueError(f"{n} rows do not split over {nm} node shards")
    rows = n // nm
    copies = {}
    for row in mesh.grid():
        for j, dev in enumerate(row):
            if (dev, j) not in copies:
                copies[(dev, j)] = t.narrow(axis, j * rows, rows).to(
                    dev, copy=True)
    return copies


def assemble(mesh: Mesh, n: int, fields: ClusterArrays) -> ShardedCluster:
    """The sharded view over `n` rows from per-field copies (each field
    `shard_tensor`'s {(device, node shard): tensor})."""
    grid = mesh.grid()
    nm = len(grid[0])
    return ShardedCluster(
        devices=grid, row0=tuple(j * (n // nm) for j in range(nm)), n=n,
        shards=tuple(tuple(ClusterArrays(*(f[(dev, j)] for f in fields))
                           for j, dev in enumerate(row)) for row in grid))


def copy_fields(sc: ShardedCluster) -> ClusterArrays:
    """Per field, the {(device, node shard): tensor} of every distinct
    copy of a sharded view (what `assemble` takes)."""
    copies = shard_copies(sc)
    return ClusterArrays(*({k: getattr(c, f) for k, c in copies.items()}
                           for f in ClusterArrays._fields))


def shard_copies(sc: ShardedCluster) -> Dict[Tuple[torch.device, int],
                                             ClusterArrays]:
    """The distinct copies of a sharded view: {(device, node shard):
    ClusterArrays}."""
    return {(dev, j): shard
            for devs, shards in zip(sc.devices, sc.shards)
            for j, (dev, shard) in enumerate(zip(devs, shards))}


def route_rows(row_of: np.ndarray, rows: int,
               shards: int) -> List[Tuple[int, np.ndarray, np.ndarray]]:
    """Changed global rows (or the row of each changed port word)
    `row_of` routed to the node shards of `rows` rows that own them:
    [(node shard, the positions in `row_of` it owns, those rows rebased
    to its first row, i32)] for each shard that owns any. Every distinct
    copy of a shard takes the same changes."""
    row_of = np.asarray(row_of, dtype=np.int64)
    owner = row_of // rows
    out = []
    for j in range(shards):
        pos = np.nonzero(owner == j)[0]
        if pos.size:
            out.append((j, pos, (row_of[pos] - j * rows).astype(np.int32)))
    return out


def shard_cluster(arrays: ClusterArrays, mesh: Mesh) -> ShardedCluster:
    """Split the view's rows into the mesh's node shards, each copied to
    its devices (one copy per distinct device of a node column): every
    tensor is sharded as `cluster_sharding` says (`shard_tensor`, which
    is also the view cache's full upload under an active mesh)."""
    from ..lib.hbm import default_hbm
    from ..lib.transfer import default_ledger

    n = int(arrays.capacity.shape[0])
    axes = [sh.spec.index(NODE_AXIS) for sh in cluster_sharding(mesh)]
    nb = sum(int(a.nbytes) for a in arrays)
    with default_ledger().timed("mesh.shard_cluster", nb,
                                count=len(arrays)):
        fields = ClusterArrays(*(shard_tensor(t, mesh, axis)
                                 for t, axis in zip(arrays, axes)))
    sc = assemble(mesh, n, fields)
    # residency ledger: each distinct shard booked on its device, with the
    # node-axis length so the capacity planner can price a node row
    hbm = default_hbm()
    for shard in shard_copies(sc).values():
        for a in shard:
            hbm.track("mesh.cluster", a, rows=n)
    return sc


def _check_on(cluster: ShardedCluster, mesh: Mesh) -> None:
    if cluster.devices != mesh.grid():
        raise ValueError("the cluster is sharded over another mesh")


def _batch_place(cluster: ShardedCluster, batch: TGParams,
                 max_allocs: int) -> PlacementResult:
    return sharded_place(cluster, batch, max_allocs)[0]


def place_batch_sharded(mesh: Mesh, max_allocs: int):
    """The batched placement dispatch over `mesh`: fn(sharded cluster,
    stacked batch) → PlacementResult with a leading B on the mesh's first
    device. CPU meshes run the plain version, CUDA meshes the K9 kernel;
    a B the batch axis does not divide raises ValueError."""
    def fn(cluster: ShardedCluster, batch: TGParams) -> PlacementResult:
        _check_on(cluster, mesh)
        return _batch_place(cluster, batch, max_allocs)
    return fn


def _step(cluster: ShardedCluster, batch: TGParams, max_allocs: int):
    """One full scheduler step: batched placement + state fold-in.

    The fold-in (sum of per-eval used deltas, in ascending eval order) is
    the device-side analog of the leader's plan-apply commit
    (`nomad/plan_apply.go:204`): each eval's placements consume capacity in
    the shared snapshot for the next round. Conflicts (overcommit) are
    detected host-side exactly as the reference's `evaluateNodePlan` does;
    this step only advances the optimistic view."""
    result, folded = sharded_place(cluster, batch, max_allocs, fold=True)
    copies = {}   # one copy per distinct device of a node column
    for row in cluster.shards:
        for j, shard in enumerate(row):
            dev = shard.used.device
            if (dev, j) not in copies:
                copies[(dev, j)] = shard._replace(used=folded[j].to(dev))
    shards = tuple(tuple(copies[(shard.used.device, j)]
                         for j, shard in enumerate(row))
                   for row in cluster.shards)
    return cluster._replace(shards=shards), result


def scheduler_step(mesh: Mesh, max_allocs: int):
    """The full step (placement + snapshot advance) over `mesh`:
    fn(sharded cluster, stacked batch) → (the advanced sharded cluster,
    PlacementResult). This is what `entry.dryrun_multichip` runs."""
    def fn(cluster: ShardedCluster, batch: TGParams):
        _check_on(cluster, mesh)
        return _step(cluster, batch, max_allocs)
    return fn
