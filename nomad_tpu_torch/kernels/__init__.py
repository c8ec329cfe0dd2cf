"""Device kernels of the port: hand-written CUDA beside plain PyTorch
(feasibility + ranking, the replacement for the reference's scalar
iterator chain, `scheduler/stack.go:321`). The vmap transport
`place_task_group_batch` is not ported yet (ROADMAP B8)."""

from .placement import (  # noqa: F401
    EXPLAIN_SCORE_NAMES,
    EXPLAIN_TOPK,
    ClusterArrays,
    PlacementExplain,
    PlacementResult,
    TGParams,
    place_task_group,
    system_feasibility,
)
