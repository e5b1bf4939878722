"""Tensor parallelism for serving: one forward split over the ranks
(counterpart of ``vdiff_tpu/parallel/tp.py``).

JAX annotates every conv and dense kernel whose output-features dim divides
the mesh as sharded on that dim and lets GSPMD insert the collectives. The
port does it by hand, with the batch replicated on every rank:

* :func:`tp_shard_plan` is JAX's rule on the torch layouts: a weight is
  sharded when its rank is at least 2, its output dim (dim 0 of ``Conv2d``'s
  (O, I, kh, kw) and of ``Linear``'s (O, I)) divides by the rank count and it
  holds at least ``TP_MIN_SHARD_SIZE`` elements. Biases, GroupNorm scales
  and the 3-channel output conv stay whole, as JAX replicates them; the
  fused qkv projection (3C, C, 1, 1) shards its packed 3C rows.
* :func:`tp_shard_model_` keeps each planned weight's contiguous block of
  output rows on its rank and records a :class:`TPShard` on the module. The
  ``conv2d`` and ``linear`` helpers of ``models/layers.py`` then compute the
  rank's output channels (with its slice of the whole bias) and all-gather
  them along channels in rank order into the whole activation. Everything
  between the sharded layers (GroupNorm, SiLU, FiLM, the residual adds, the
  attention kernels) runs on whole activations, as on one card.
* Under :mod:`.spatial` as well (``--tp --spatial-shard``) a sharded weight is
  all-gathered whole at its use and the layer runs on the rank's rows: the
  spatial numerics with TP's parameter bytes.

The weights come from the single-card checkpoint: load it whole, then shard.
``state_bytes_per_device`` (:mod:`.fsdp`) counts a sharded model's bytes, as
JAX's does. Every collective is an ``all_gather``, which gloo also runs on
CUDA tensors.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch import nn

from .mesh import all_gather_along, world_size

MODEL_AXIS = "model"

# TP shards smaller tensors than FSDP does (2^12 elements): with the batch
# replicated every unsharded weight is redundant compute, not just memory
TP_MIN_SHARD_SIZE = 2**12


def create_tp_mesh():
    """A 1-D ``DeviceMesh`` over every rank of the process group, its axis
    ``MODEL_AXIS``; its devices are the group's (CUDA under NCCL, the CPU
    under gloo)."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (world_size(),), mesh_dim_names=(MODEL_AXIS,))


def shards(shape, n: int) -> bool:
    """JAX's rule for one tensor of ``shape`` whose output dim is dim 0."""
    return len(shape) >= 2 and shape[0] % n == 0 and math.prod(shape) >= TP_MIN_SHARD_SIZE


def tp_shard_plan(model: nn.Module, n: int) -> list:
    """The names of ``model``'s parameters that ``n`` ranks shard: the
    weights of its ``Conv2d`` and ``Linear`` modules that :func:`shards`
    accepts."""
    return [f"{name}.weight" for name, m in model.named_modules()
            if isinstance(m, (nn.Conv2d, nn.Linear)) and shards(m.weight.shape, n)]


class TPShard:
    """A module's share of an output-sharded weight: rows ``[rank·O/world,
    (rank+1)·O/world)`` of its ``out`` output channels, over ``group``."""

    def __init__(self, group, rank: int, world: int, out: int):
        self.group, self.rank = group, rank
        self.per = out // world

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of a whole per-channel tensor (the bias)."""
        return t[self.rank * self.per:(self.rank + 1) * self.per]

    def whole(self, w: torch.Tensor) -> torch.Tensor:
        """The whole weight, gathered from every rank's rows."""
        return all_gather_along(w, 0, self.group)

    def gather_channels(self, y: torch.Tensor) -> torch.Tensor:
        """The whole activation from every rank's channels of its last dim."""
        return all_gather_along(y, y.dim() - 1, self.group)


@torch.no_grad()
def tp_shard_model_(model: nn.Module, group=None):
    """Shard ``model`` in place over ``group`` (default: the world): every
    weight of :func:`tp_shard_plan` keeps this rank's contiguous block of
    output rows (a copy: the whole weight is freed), and its module records
    a :class:`TPShard`; biases stay whole. Returns the model."""
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    for name in tp_shard_plan(model, n):
        m = model.get_submodule(name.rpartition(".")[0])
        m.tp_shard = TPShard(group, rank, n, m.weight.shape[0])
        m.weight = nn.Parameter(m.tp_shard.rows(m.weight).clone(),
                                requires_grad=m.weight.requires_grad)
    return model
