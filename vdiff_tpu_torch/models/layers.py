"""NN primitives: the reference's LeCun-truncated initialiser, label one-hot
and the two resamplers (counterpart of ``vdiff_tpu/models/layers.py``).

Dense layers are ``nn.Linear`` and convolutions ``nn.Conv2d``; parameters
stay float32 and are cast to the model's compute dtype where they are used,
as Flax does with ``dtype=``. The resamplers work on NCHW tensors (the UNet
keeps NCHW in ``channels_last`` memory, the same bytes as JAX's NHWC).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


@torch.no_grad()
def lecun_trunc_normal_(w: torch.Tensor, scale: float = 1.0,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """±2σ-truncated standard normal times sqrt(scale / fan_in), without the
    truncation-variance correction; scale 0 gives zeros. fan_in is every dim
    but the first (torch (out, in) / OIHW layouts)."""
    if scale == 0.0:
        return w.zero_()
    fan_in = math.prod(w.shape[1:])
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(math.sqrt(scale / fan_in))


def conv2d(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """``conv`` applied in ``dtype`` (weights cast at use)."""
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), bias, conv.stride, conv.padding)


def linear(x: torch.Tensor, fc: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``fc`` applied in ``dtype`` (weights cast at use)."""
    return F.linear(x.to(dtype), fc.weight.to(dtype), fc.bias.to(dtype))


def one_hot_exclude_zero(y: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Labels 1..K map to basis vectors; label 0 (the CFG null class) maps to
    the all-zeros vector. Returns f32 (B, K)."""
    y = y.long()
    out = F.one_hot((y - 1).clamp(min=0), num_classes).float()
    return torch.where((y == 0)[:, None], torch.zeros_like(out), out)


def nearest_upsample(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsample of NCHW x."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 average-pool downsample of NCHW x."""
    return F.avg_pool2d(x, 2)
