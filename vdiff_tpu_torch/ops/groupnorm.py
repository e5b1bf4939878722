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

:func:`gn_film_silu_kernel` is the counterpart of JAX's Pallas kernel
(``_gn_kernel`` through ``gn_film_silu_pallas``): the whole chain as one CUDA
kernel (``csrc/gn_film_silu.cu``), inference only. It keeps A and B in f32
and rounds once, at the output, where the default path rounds A, B, the
multiply-add and the SiLU to the compute dtype, so in bf16 the two differ by
construction; :func:`gn_film_silu_kernel_reference` is the kernel's
arithmetic in plain PyTorch. :func:`gn_film_silu` takes the kernel when
``use_kernel`` says so, or, left to itself, when ``VDIFF_FUSED_GN=1`` and
autograd is not recording (off by default, as in the JAX package, whose
dispatch never takes its kernel unasked).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F

from .. import kernels


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


def coefficients(x, gamma, beta, film_shift, film_scale, num_groups, eps):
    """The kernels' f32 (B, C) pair (A, B) with GN(+FiLM)(x) = x·A + B, in the
    Pallas kernels' order of operations."""
    mean, inv = _stats(x, num_groups, eps)
    cg = x.shape[-1] // num_groups
    a = gamma.float()[None, :] * inv.repeat_interleave(cg, dim=1)
    b = beta.float()[None, :] - mean.repeat_interleave(cg, dim=1) * a
    if film_shift is not None:
        fs = 1.0 + film_scale.float()
        a = a * fs
        b = b * fs + film_shift.float()
    return a, b


def gn_film_silu_kernel_reference(x, gamma, beta, film_shift=None, film_scale=None, *,
                                  num_groups: int = 32, eps: float = 1e-6,
                                  apply_silu: bool = True) -> torch.Tensor:
    """Plain twin of :func:`gn_film_silu_kernel` (the Pallas ``_gn_kernel``'s
    arithmetic): f32 coefficients, y = x·A + B and the SiLU in f32, one cast
    to x's dtype."""
    check_gn_input("gn_film_silu_kernel_reference", x, gamma, beta, film_shift, film_scale,
                   num_groups)
    a, b = coefficients(x, gamma, beta, film_shift, film_scale, num_groups, eps)
    y = x.float() * a[:, None, None, :] + b[:, None, None, :]
    if apply_silu:
        y = F.silu(y)
    return y.to(x.dtype)


_DTYPES = (torch.float32, torch.bfloat16)


def check_gn_input(name, x, gamma, beta, film_shift, film_scale, num_groups):
    """What the GroupNorm kernels take: x (B, H, W, C) f32/bf16 contiguous
    (an NCHW tensor in ``channels_last`` memory, viewed as NHWC: read in
    place, never copied here), C divisible by ``num_groups``, gamma/beta
    (C,), FiLM rows (B, C) both or neither, f32 or x's dtype, unit stride
    along C. Returns (B, H, W, C)."""
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be (B, H, W, C), got {tuple(x.shape)}")
    B, H, W, C = x.shape
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported (float32, bfloat16)")
    if num_groups <= 0 or C % num_groups:
        raise ValueError(f"{name}: C={C} is not divisible by num_groups={num_groups}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous as (B, H, W, C), got strides {x.stride()}")
    if gamma.shape != (C,) or beta.shape != (C,):
        raise ValueError(f"{name}: gamma/beta must be ({C},), got {tuple(gamma.shape)}, "
                         f"{tuple(beta.shape)}")
    if (film_shift is None) != (film_scale is None):
        raise ValueError(f"{name}: film_shift and film_scale come together or not at all")
    for f in (film_shift, film_scale):
        if f is None:
            continue
        if f.shape != (B, C) or f.dtype not in (torch.float32, x.dtype) or f.stride(1) != 1:
            raise ValueError(f"{name}: a FiLM input must be ({B}, {C}) float32 or {x.dtype} with "
                             f"unit stride along C, got {tuple(f.shape)} {f.dtype} {f.stride()}")
    if film_shift is not None and (film_shift.dtype != film_scale.dtype
                                   or film_shift.stride(0) != film_scale.stride(0)):
        raise ValueError(f"{name}: film_shift and film_scale must share dtype and row stride")
    return B, H, W, C


def need_cuda(name: str, *tensors: Optional[torch.Tensor]) -> None:
    for t in tensors:
        if t is not None and t.device.type != "cuda":
            raise RuntimeError(f"{name}: tensor on {t.device}; the kernel needs a CUDA tensor")


def film_args(film_shift, film_scale):
    """(shift pointer, scale pointer, row stride, is-f32 flag) of the FiLM
    rows for the C entry points; null pointers without FiLM."""
    if film_shift is None:
        return None, None, 0, 1
    return (film_shift.data_ptr(), film_scale.data_ptr(), film_shift.stride(0),
            int(film_shift.dtype == torch.float32))


def gn_film_silu_kernel(x, gamma, beta, film_shift=None, film_scale=None, *,
                        num_groups: int = 32, eps: float = 1e-6,
                        apply_silu: bool = True) -> torch.Tensor:
    """GroupNorm(+FiLM)(+SiLU) as one CUDA kernel (``csrc/gn_film_silu.cu``).

    Replaces JAX's Pallas ``_gn_kernel`` (ops/groupnorm.py, through
    ``gn_film_silu_pallas``). Bound by bytes; a block takes one sample and a
    run of groups about 32 channels wide, reads its slab for the sums and
    once more from L2 to write y (see the source's header). CUDA tensors
    only, like the backward passes of the attention: the CPU path is
    :func:`gn_film_silu_kernel_reference`, which :func:`gn_film_silu` takes
    for a CPU tensor. Inference only: nothing here is differentiable."""
    B, H, W, C = check_gn_input("gn_film_silu_kernel", x, gamma, beta, film_shift, film_scale,
                                num_groups)
    need_cuda("gn_film_silu_kernel", x, gamma, beta, film_shift, film_scale)
    gamma, beta = gamma.float().contiguous(), beta.float().contiguous()
    out = torch.empty_like(x)
    err = kernels.library().vdiff_gn_film_silu(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), *film_args(film_shift, film_scale),
        out.data_ptr(), B, H * W, C, num_groups, eps, int(apply_silu),
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(err, "vdiff_gn_film_silu")
    gn_film_silu_kernel.launches += 1
    return out


gn_film_silu_kernel.launches = 0


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
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    """x: (B, H, W, C) (any strides; contiguous for the kernel); gamma/beta:
    (C,); film_*: (B, C) or None.

    ``use_kernel=None`` takes the one-kernel form when ``VDIFF_FUSED_GN=1``
    and autograd is not recording (the counterpart of ``use_pallas=None`` in
    JAX's dispatch, which resolves to off); ``True`` asks for it and is
    refused while autograd records. The one-kernel form is
    :func:`gn_film_silu_kernel` on a CUDA tensor and its twin on a CPU
    tensor. Otherwise the default chain runs, through :class:`GNFilmSiLU`
    only when autograd records, so the sampler pays nothing for the
    backward."""
    if use_kernel is None:
        use_kernel = (os.environ.get("VDIFF_FUSED_GN", "0") == "1"
                      and not torch.is_grad_enabled())
    if use_kernel:
        if torch.is_grad_enabled():
            raise RuntimeError("gn_film_silu: the one-kernel form is inference only; call it "
                               "under torch.no_grad() or torch.inference_mode()")
        fn = gn_film_silu_kernel_reference if x.device.type == "cpu" else gn_film_silu_kernel
        return fn(x, gamma, beta, film_shift, film_scale, num_groups=num_groups, eps=eps,
                  apply_silu=apply_silu)
    if torch.is_grad_enabled():
        return GNFilmSiLU.apply(x, gamma, beta, film_shift, film_scale, num_groups, eps,
                                apply_silu)
    mean, inv = _stats(x, num_groups, eps)
    return _forward(x, gamma, beta, film_shift, film_scale, mean, inv, apply_silu)
