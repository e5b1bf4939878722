"""GroupNorm(+FiLM)(+SiLU) as one per-channel y = x·A + B, with a hand-written
backward.

Counterpart of ``vdiff_tpu/ops/groupnorm.py``'s XLA path, the one the JAX
sampler and trainer take (its Pallas kernel is off by default), following it
line for line: single-pass f32 Σx and Σx² per channel, folded to groups, and
the normalisation, affine and FiLM folded into one multiply-add in the compute
dtype. ``F.group_norm`` is not used: its variance algorithm differs.

When autograd records, :class:`GNFilmSiLU` carries the backward of JAX's
``_gn_film_silu_core`` custom VJP: two per-(b, c) spatial reductions,
R1 = Σdz and R2 = Σdz·x̂, from which every gradient follows, with x̂ and dz
materialised in the compute dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _stats(x: torch.Tensor, num_groups: int, eps: float):
    """Per-(b, group) mean and 1/σ in f32 (single pass: Σx and Σx²)."""
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
    return mean, torch.rsqrt(var + eps)


def _forward(x, gamma, beta, film_shift, film_scale, mean, inv, apply_silu):
    cg = x.shape[-1] // mean.shape[1]
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


class GNFilmSiLU(torch.autograd.Function):
    """The differentiable form of :func:`gn_film_silu` (JAX's
    ``_gn_film_silu_core``): the forward is the same single-pass math and
    saves x and the group statistics; the backward is the JAX VJP:
    dx = inv·(w·dz − m1 − x̂·m2) with m1 = mean_G(w·dz), m2 = mean_G(w·dz·x̂),
    dγ = Σ_b f·R2, dβ = Σ_b f·R1, dscale = γ·R2 + β·R1, dshift = R1."""

    @staticmethod
    def forward(ctx, x, gamma, beta, film_shift, film_scale, num_groups, eps, apply_silu):
        mean, inv = _stats(x, num_groups, eps)
        ctx.save_for_backward(x, gamma, beta, film_shift, film_scale, mean, inv)
        ctx.apply_silu = apply_silu
        return _forward(x, gamma, beta, film_shift, film_scale, mean, inv, apply_silu)

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta, film_shift, film_scale, mean, inv = ctx.saved_tensors
        B, H, W, C = x.shape
        G = mean.shape[1]
        cg = C // G
        n = H * W * cg
        has_film = film_scale is not None
        gamma32, beta32 = gamma.float(), beta.float()

        mean_c = mean.repeat_interleave(cg, dim=1)[:, None, None, :]  # (B,1,1,C) f32
        inv_c = inv.repeat_interleave(cg, dim=1)[:, None, None, :]
        f = (1.0 + film_scale.float())[:, None, None, :] if has_film else 1.0
        w = gamma32[None, None, None, :] * f  # (B,1,1,C) or (1,1,1,C)

        # full-size intermediates in x's compute dtype, statistics in f32
        cdt = x.dtype
        xhat = ((x.float() - mean_c) * inv_c).to(cdt)
        xhat32 = xhat.float()
        if ctx.apply_silu:
            # recompute z from x̂ for silu'
            s_off = beta32[None, None, None, :] * f
            if film_shift is not None:
                s_off = s_off + film_shift.float()[:, None, None, :]
            z = w * xhat32 + s_off
            sig = torch.sigmoid(z)
            dz = (g.float() * sig * (1.0 + z * (1.0 - sig))).to(cdt)
        else:
            dz = g.to(cdt)
        dz32 = dz.float()

        r1 = dz32.sum(dim=(1, 2))  # (B, C)
        r2 = (dz32 * xhat32).sum(dim=(1, 2))
        w_bc = (w[:, 0, 0, :] if has_film else w[0, 0, 0, :][None]).expand(B, C)
        m1 = (w_bc * r1).reshape(B, G, cg).sum(dim=2) / n  # (B, G)
        m2 = (w_bc * r2).reshape(B, G, cg).sum(dim=2) / n
        m1_c = m1.repeat_interleave(cg, dim=1)[:, None, None, :]
        m2_c = m2.repeat_interleave(cg, dim=1)[:, None, None, :]
        dx = (inv_c * (w * dz32 - m1_c - xhat32 * m2_c)).to(x.dtype)

        f_bc = (1.0 + film_scale.float()) if has_film else torch.ones(1, C, device=x.device)
        dgamma = (f_bc * r2).sum(dim=0).to(gamma.dtype)
        dbeta = (f_bc * r1).sum(dim=0).to(beta.dtype)
        dscale = (gamma32[None, :] * r2 + beta32[None, :] * r1).to(film_scale.dtype) if has_film else None
        dshift = r1.to(film_shift.dtype) if film_shift is not None else None
        return dx, dgamma, dbeta, dshift, dscale, None, None, None


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
    """x: (B, H, W, C) (any strides); gamma/beta: (C,); film_*: (B, C) or None.
    Goes through :class:`GNFilmSiLU` only when autograd records, so the
    sampler pays nothing for the backward."""
    if torch.is_grad_enabled():
        return GNFilmSiLU.apply(x, gamma, beta, film_shift, film_scale, num_groups, eps,
                                apply_silu)
    mean, inv = _stats(x, num_groups, eps)
    return _forward(x, gamma, beta, film_shift, film_scale, mean, inv, apply_silu)
