"""Multi-device parallelism: device mesh construction and sharded dispatch
of the placement kernels (the node axis is this domain's sequence axis;
evals are the batch axis), and the host padding of programs
(`parallel/pad.py`)."""
from .mesh import (  # noqa: F401
    BATCH_AXIS,
    NODE_AXIS,
    Mesh,
    cluster_sharding,
    get_active_mesh,
    make_mesh,
    mesh_from_env,
    params_sharding,
    place_batch_sharded,
    scheduler_step,
    set_active_mesh,
    shard_cluster,
)
from .pad import STATIC_DIMS, pad_params, param_dims, stack_params  # noqa: F401
