"""Carry state into the port.

- `cluster_from_numpy` / `params_from_numpy` turn numpy arrays (the host
  cluster view and compiled programs, from this package's stack or from
  the reference package's `ClusterArrays`/`TGParams` as numpy) into the
  port's tensors on an explicit device; `candidates_from_numpy` does the
  same for a preemption candidate table.
- Objects (jobs, nodes, allocs, evals) cross through the wire format:
  `structs.codec.from_wire(tree)` rebuilds them from any `to_wire` tree
  of the same struct names.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .kernels.placement import PARAM_TYPES, ClusterArrays, TGParams
from .kernels.preemption import PreemptionCandidates

_NP_TYPES = {torch.float32: np.float32, torch.int32: np.int32,
             torch.bool: np.bool_}


def _fields(d: Any) -> Mapping[str, Any]:
    return d._asdict() if hasattr(d, "_asdict") else d


def tensor_from_numpy(a: Any, device: torch.device,
                      dtype: Any = None) -> torch.Tensor:
    """A copy of numpy array `a` (in `dtype`) on `device`; 0-d stays 0-d.
    A u32 array crosses as int32 holding the same bits."""
    a = np.require(a, dtype=dtype, requirements="C")
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if device.type == "cpu" or not a.flags.writeable:
        a = a.copy()   # the tensor must not alias the caller's array
    return torch.from_numpy(a).to(device)


def cluster_from_numpy(d: Any, device: DeviceLike = None) -> ClusterArrays:
    """numpy cluster view → ClusterArrays on `device`. The u32 port bitmap
    is carried as int32 holding the same bits; attrs keep int16 (or
    int32 for very large vocabularies)."""
    dev = resolve_device(device)
    d = _fields(d)
    attrs = np.asarray(d["attrs"])
    return ClusterArrays(
        capacity=tensor_from_numpy(d["capacity"], dev, np.float32),
        used=tensor_from_numpy(d["used"], dev, np.float32),
        node_ok=tensor_from_numpy(d["node_ok"], dev, np.bool_),
        attrs=tensor_from_numpy(
            attrs, dev,
            None if attrs.dtype in (np.int16, np.int32) else np.int32),
        ports_used=tensor_from_numpy(d["ports_used"], dev),
        dyn_free=tensor_from_numpy(d["dyn_free"], dev, np.float32),
    )


def params_from_numpy(d: Any, device: DeviceLike = None) -> TGParams:
    """numpy program (TGParams fields) → TGParams of tensors on
    `device`, each field in its kernel type (i32, f32 or bool)."""
    dev = resolve_device(device)
    d = _fields(d)
    return TGParams(**{
        name: tensor_from_numpy(d[name], dev, _NP_TYPES[dt])
        for name, dt in PARAM_TYPES.items()})


def candidates_from_numpy(prio: Any, usage: Any,
                          device: DeviceLike = None) -> PreemptionCandidates:
    """numpy candidate table (prio f32[N, A], usage f32[N, A, R]) →
    PreemptionCandidates on `device`."""
    dev = resolve_device(device)
    return PreemptionCandidates(
        prio=tensor_from_numpy(prio, dev, np.float32),
        usage=tensor_from_numpy(usage, dev, np.float32))


def to_device_async(a: Any, device: torch.device,
                    dtype: Any = None) -> torch.Tensor:
    """`tensor_from_numpy` for the dispatch path: on a card the bytes go
    through pinned host memory and the copy is enqueued on the current
    stream without waiting for the device (the caching host allocator
    keeps the pinned block until the copy has run)."""
    if device.type != "cuda":
        return tensor_from_numpy(a, device, dtype)
    a = np.require(a, dtype=dtype, requirements=("C", "W"))
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).pin_memory().to(device, non_blocking=True)
