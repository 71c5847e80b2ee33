"""Multi-process execution and the mesh's sharding rules (port of
`vod_tpu/parallel/`: `distributed.py` and the dp and fsdp parts of
`mesh.py`; `moe`, `pipeline` and `ring` wait for ROADMAP §A item 6)."""

from .distributed import (
    all_gather_tensor,
    all_reduce_,
    barrier,
    global_batch_from_local,
    init_distributed,
    is_main_process,
    process_slice,
    rank_device,
    world_size,
)
from .mesh import (
    DataParallel,
    axis_group,
    axis_index,
    axis_size,
    data_parallel,
    fsdp_dim,
    fsdp_flax_dims,
    fsdp_sharding,
    make_mesh,
    shard_batch,
    shard_params,
)

__all__ = [
    "DataParallel",
    "all_gather_tensor",
    "all_reduce_",
    "axis_group",
    "axis_index",
    "axis_size",
    "barrier",
    "data_parallel",
    "fsdp_dim",
    "fsdp_flax_dims",
    "fsdp_sharding",
    "global_batch_from_local",
    "init_distributed",
    "is_main_process",
    "make_mesh",
    "process_slice",
    "rank_device",
    "shard_batch",
    "shard_params",
    "world_size",
]
