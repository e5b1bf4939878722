"""Multi-GPU training, data-parallel sampling and model-parallel serving
(counterpart of ``vdiff_tpu/parallel/``): process groups and meshes
(:mod:`.mesh`), FSDP2 state sharding (:mod:`.fsdp`), tensor parallelism
(:mod:`.tp`), height sharding (:mod:`.spatial`) and the multi-rank dry run
(:mod:`.dryrun`)."""

from .fsdp import (
    full_optimizer_state,
    full_state_dict,
    load_full_optimizer_state_,
    load_full_state_dict_,
    resolve_fsdp_axis,
    shard_model,
    state_bytes_per_device,
)
from .mesh import (
    DATA_AXIS,
    FSDP_AXIS,
    all_gather_along,
    all_gather_rows,
    broadcast_object,
    create_mesh,
    init_distributed,
    is_leader,
    rank,
    shard_batch,
    sync_global_devices,
    world_size,
)
from .spatial import SpatialShard, SpatialShardedUNet, rows_per_rank
from .tp import (
    MODEL_AXIS,
    TP_MIN_SHARD_SIZE,
    TPShard,
    create_tp_mesh,
    tp_shard_model_,
    tp_shard_plan,
)

__all__ = [
    "DATA_AXIS",
    "FSDP_AXIS",
    "MODEL_AXIS",
    "SpatialShard",
    "SpatialShardedUNet",
    "TPShard",
    "TP_MIN_SHARD_SIZE",
    "all_gather_along",
    "all_gather_rows",
    "broadcast_object",
    "create_mesh",
    "full_optimizer_state",
    "full_state_dict",
    "init_distributed",
    "is_leader",
    "load_full_optimizer_state_",
    "load_full_state_dict_",
    "rank",
    "resolve_fsdp_axis",
    "rows_per_rank",
    "shard_batch",
    "shard_model",
    "state_bytes_per_device",
    "sync_global_devices",
    "tp_shard_model_",
    "tp_shard_plan",
    "world_size",
]
