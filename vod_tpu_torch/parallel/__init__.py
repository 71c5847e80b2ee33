"""Multi-process execution, the mesh's sharding rules and model parallelism
(port of `vod_tpu/parallel/`): `distributed.py`, `mesh.py` (the dp, fsdp
and tp axes), `moe.py` (experts split over an ep axis), `pipeline.py`
(GPipe over a pp axis) and `ring.py` (ring attention over an sp axis)."""

from .distributed import (
    all_gather_tensor,
    all_reduce_,
    barrier,
    copy_over,
    global_batch_from_local,
    init_distributed,
    is_main_process,
    ppermute,
    process_slice,
    rank_device,
    sum_over,
    world_size,
)
from .mesh import (
    DataParallel,
    axis_group,
    axis_index,
    axis_size,
    combined_sharding,
    data_parallel,
    fsdp_dim,
    fsdp_flax_dims,
    fsdp_sharding,
    make_mesh,
    shard_batch,
    shard_params,
    shard_params_combined,
    shard_params_tp,
    tp_flax_dim,
    tp_sharding,
)
from .moe import MoEFFN, ep_sharding, shard_params_ep
from .pipeline import pipeline_apply, pp_encoder_forward, stack_pipeline_stages
from .ring import ring_attention, sp_encoder_forward

__all__ = [
    "DataParallel",
    "MoEFFN",
    "all_gather_tensor",
    "all_reduce_",
    "axis_group",
    "axis_index",
    "axis_size",
    "barrier",
    "combined_sharding",
    "copy_over",
    "data_parallel",
    "ep_sharding",
    "fsdp_dim",
    "fsdp_flax_dims",
    "fsdp_sharding",
    "global_batch_from_local",
    "init_distributed",
    "is_main_process",
    "make_mesh",
    "pipeline_apply",
    "pp_encoder_forward",
    "ppermute",
    "process_slice",
    "rank_device",
    "ring_attention",
    "shard_batch",
    "shard_params",
    "shard_params_combined",
    "shard_params_ep",
    "shard_params_tp",
    "sp_encoder_forward",
    "stack_pipeline_stages",
    "sum_over",
    "tp_flax_dim",
    "tp_sharding",
    "world_size",
]
