"""Multi-GPU training and data-parallel sampling (counterpart of
``vdiff_tpu/parallel/``): process groups and meshes (:mod:`.mesh`), FSDP2
state sharding (:mod:`.fsdp`) and the multi-rank dry run (:mod:`.dryrun`).
The model-parallel serving modes (JAX's ``tp.py`` and ``spatial.py``) are
ROADMAP A10b."""

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

__all__ = [
    "DATA_AXIS",
    "FSDP_AXIS",
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
    "shard_batch",
    "shard_model",
    "state_bytes_per_device",
    "sync_global_devices",
    "world_size",
]
