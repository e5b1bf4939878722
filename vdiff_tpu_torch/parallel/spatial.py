"""Spatial partitioning: one image's height split over the ranks
(counterpart of ``vdiff_tpu/parallel/spatial.py``).

JAX puts one sharding constraint on the NHWC ``x_t`` at each denoise call and
lets XLA derive the rest: halo exchanges at the 3x3 convs, a psum of the
GroupNorm statistics, the token axis gathered for attention. The port writes
those three out, with the same collectives on every rank:

* :class:`SpatialShardedUNet` takes the whole, replicated ``x_t``, keeps rank
  r's rows ``[r·H/N, (r+1)·H/N)``, runs the UNet on them and all-gathers the
  output rows, so the sampler does not change;
* every 3x3 conv (stride 1 or 2) first takes one halo row from each
  neighbour, zeros at the image's edge, and runs with padding (0, 1)
  (:meth:`SpatialShard.halo`);
* every GroupNorm all-reduces its per-(b, c) Σx and Σx² before it forms mean
  and 1/σ (:meth:`SpatialShard.sum_`, read by ``ops/groupnorm.py::_stats``);
* attention all-gathers the qkv tokens (a height shard is a contiguous token
  range of the row-major H·W), runs the kernel on the whole T, the same
  launch as one card, and keeps this rank's token rows;
* the 2x average pool and nearest upsample are local.

Each level's rows must split evenly: ``H / 2^(levels-1)`` divides by N
(:func:`rows_per_rank`). The fused inference kernels compute GroupNorm
statistics from their own slab, so both switches are refused here. Every
collective is an ``all_gather`` or ``all_reduce``, which gloo also runs on
CUDA tensors. Inference only.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch import nn

from .mesh import all_gather_along

FUSED_SWITCHES = ("VDIFF_FUSED_CONV", "VDIFF_FUSED_GN")


def rows_per_rank(H: int, levels: int, world: int) -> int:
    """The image rows a rank holds; raises unless ``world`` divides the rows
    of the lowest of the UNet's ``levels`` (H / 2^(levels-1))."""
    bottom = H >> (levels - 1)
    if H % (1 << (levels - 1)) or bottom % world:
        raise ValueError(f"a height shard needs H / 2^(levels-1) divisible by the {world} ranks: "
                         f"H={H} with {levels} levels leaves {H / (1 << (levels - 1)):g} rows "
                         "at the lowest level")
    return H // world


class SpatialShard:
    """The collectives of a height shard over ``group`` (default: the
    world); the modules that :class:`SpatialShardedUNet` marks read it."""

    def __init__(self, group=None):
        self.group = group
        self.rank, self.world = dist.get_rank(group), dist.get_world_size(group)

    def halo(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW ``x`` (in ``channels_last`` memory) with one row of each
        neighbour above and below, zeros past the image's edge: every rank's
        top and bottom rows in one all-gather."""
        xh = x.permute(0, 2, 3, 1).contiguous()  # (B, h, W, C), x's own bytes
        edges = all_gather_along(torch.cat((xh[:, :1], xh[:, -1:]), 1), 1, self.group)
        zero = torch.zeros_like(xh[:, :1])
        top = edges[:, 2 * self.rank - 1:2 * self.rank] if self.rank > 0 else zero
        bottom = (edges[:, 2 * self.rank + 2:2 * self.rank + 3] if self.rank < self.world - 1
                  else zero)
        return torch.cat((top, xh, bottom), 1).permute(0, 3, 1, 2)

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks, in place (GroupNorm's sums)."""
        dist.all_reduce(t, group=self.group)
        return t

    def gather_tokens(self, qkv: torch.Tensor) -> torch.Tensor:
        """(B, T/N, ·) tokens of every rank → the whole (B, T, ·)."""
        return all_gather_along(qkv, 1, self.group)

    def own_tokens(self, out: torch.Tensor) -> torch.Tensor:
        """This rank's token rows of a whole (B, T, ·)."""
        per = out.shape[1] // self.world
        return out[:, self.rank * per:(self.rank + 1) * per]


class SpatialShardedUNet(nn.Module):
    """``model`` (a UNet, TP-sharded or not) run on this rank's rows of a
    whole ``x``: ``forward(x, t, y=None)`` → the whole (B, H, W, C_out) on
    every rank. Marks every conv, GroupNorm and attention block of the model
    with its :class:`SpatialShard` (the model then runs only through this
    wrapper). Inference only."""

    def __init__(self, model: nn.Module, group=None):
        super().__init__()
        from ..models.unet import AttentionBlock, GroupNorm32

        self.model = model
        self.shard = SpatialShard(group)
        self.levels = len(model.downsamples)
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, GroupNorm32, AttentionBlock)):
                m.spatial = self.shard

    def forward(self, x: torch.Tensor, t: torch.Tensor, y=None) -> torch.Tensor:
        on = [name for name in FUSED_SWITCHES if os.environ.get(name, "0") == "1"]
        if on:
            raise ValueError(f"a height shard cannot run {'/'.join(on)}=1: the fused kernels "
                             "compute GroupNorm statistics from their local slab")
        if torch.is_grad_enabled():
            raise RuntimeError("SpatialShardedUNet is inference only: call it under "
                               "torch.inference_mode() or torch.no_grad()")
        per = rows_per_rank(x.shape[1], self.levels, self.shard.world)
        rows = x[:, self.shard.rank * per:(self.shard.rank + 1) * per].contiguous()
        return all_gather_along(self.model(rows, t, y), 1, self.shard.group)
