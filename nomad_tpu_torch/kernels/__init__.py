"""Device kernels of the port: hand-written CUDA beside plain PyTorch
(feasibility + ranking, the replacement for the reference's scalar
iterator chain, `scheduler/stack.go:321`)."""

from .placement import (  # noqa: F401
    EXPLAIN_SCORE_NAMES,
    EXPLAIN_TOPK,
    ClusterArrays,
    PlacementExplain,
    PlacementResult,
    TGParams,
    place_packed_batch,
    place_task_group,
    place_task_group_batch,
    system_feasibility,
)
