"""GroupNorm(+FiLM)(+SiLU) as one per-channel y = x·A + B.

Counterpart of ``vdiff_tpu/ops/groupnorm.py::gn_film_silu_reference``, the
path the JAX sampler takes (its Pallas kernel is off by default), following it
line for line: single-pass f32 Σx and Σx² per channel, folded to groups, and
the normalisation, affine and FiLM folded into one multiply-add in the compute
dtype. ``F.group_norm`` is not used: its variance algorithm differs.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def gn_film_silu(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    film_shift: Optional[torch.Tensor] = None,
    film_scale: Optional[torch.Tensor] = None,
    *,
    num_groups: int = 32,
    eps: float = 1e-6,
    apply_silu: bool = True,
) -> torch.Tensor:
    """x: (B, H, W, C) (any strides); gamma/beta: (C,); film_*: (B, C) or None."""
    B, H, W, C = x.shape
    cg = C // num_groups
    x32 = x.float()
    s1c = x32.sum(dim=(1, 2))  # (B, C)
    s2c = (x32 * x32).sum(dim=(1, 2))
    s1 = s1c.reshape(B, num_groups, cg).sum(dim=2)  # (B, G)
    s2 = s2c.reshape(B, num_groups, cg).sum(dim=2)
    n = H * W * cg
    mean = s1 / n
    var = s2 / n - mean * mean
    inv = torch.rsqrt(var + eps)

    mean_c = mean.repeat_interleave(cg, dim=1)  # (B, C)
    inv_c = inv.repeat_interleave(cg, dim=1)
    a = gamma.float()[None, :] * inv_c
    b = beta.float()[None, :] - mean_c * a
    if film_scale is not None:
        fs = 1.0 + film_scale.float()
        a = a * fs
        b = b * fs
    if film_shift is not None:
        b = b + film_shift.float()

    a = a.to(x.dtype)[:, None, None, :]
    b = b.to(x.dtype)[:, None, None, :]
    y = x * a + b
    if apply_silu:
        y = F.silu(y)
    return y
