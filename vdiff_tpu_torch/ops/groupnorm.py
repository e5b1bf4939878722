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
kernel (``csrc/gn_film_silu.cu``) that reads x once, split as
:func:`gn_plan` says, inference only. It keeps A and B in f32
and rounds once, at the output, where the default path rounds A, B, the
multiply-add and the SiLU to the compute dtype, so in bf16 the two differ by
construction; :func:`gn_film_silu_kernel_reference` is the kernel's
arithmetic in plain PyTorch. :func:`gn_film_silu` takes the kernel when
``use_kernel`` says so, or, left to itself, when ``VDIFF_FUSED_GN=1`` and
autograd is not recording (off by default, as in the JAX package, whose
dispatch never takes its kernel unasked).
"""

from __future__ import annotations

import functools
import math
import os
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .. import kernels


def _stats(x: torch.Tensor, num_groups: int, eps: float, shard=None):
    """Per-(b, group) mean and 1/σ in f32 (single pass: Σx and Σx²). With a
    ``shard`` (``parallel/spatial.py``'s ``SpatialShard``), x is one of
    ``shard.world`` equal height shards of the image, and the per-(b, c) sums
    are summed over them (``shard.sum_``) before the statistics."""
    B, H, W, C = x.shape
    cg = C // num_groups
    x32 = x.float()
    s1c = x32.sum(dim=(1, 2))  # (B, C)
    s2c = (x32 * x32).sum(dim=(1, 2))
    if shard is not None:
        s1c, s2c = shard.sum_(torch.stack((s1c, s2c)))
        H *= shard.world
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


# gn_plan's defaults (measured on an H100, PERF.md §6): a run of at least 64
# bytes a pixel, so that a warp's 16-byte loads fill whole 32-byte sectors;
# a whole slab in one block up to 96 KB (two blocks an SM); past that a
# cluster whose blocks hold at most 48 KB each (four blocks an SM hide the
# cluster's barriers better than two); warps enough for 8 16-byte vectors
# a thread, 2 to 8 (small slabs lose to long folds over idle warps)
RUN_BYTES = 64
SLAB_BYTES = 96 * 1024
CLUSTER_SLAB_BYTES = 48 * 1024
VECTORS_PER_THREAD = 8
MIN_WARPS, MAX_WARPS = 2, 8  # csrc/gn_film_silu.cu's kGnThreads = 32 * MAX_WARPS
MAX_RANKS = 16  # the largest (non-portable) thread-block cluster
MAX_SMEM_BYTES = 232448  # H100: 227 KB of dynamic shared memory a block


class GNPlan(NamedTuple):
    """How :func:`gn_film_silu_kernel` splits a call. A block takes one
    sample's ``pixels`` pixels × one run of ``groups`` whole groups
    (``run_bytes`` a pixel, a multiple of 16); a thread-block cluster of
    ``ranks`` blocks takes the sample's whole (HW, run) slab; each block
    holds its part in ``smem_bytes`` of dynamic shared memory (the slab, the
    warps' per-channel sums, the per-channel A and B) and runs ``threads``,
    whole warps of which each lane takes one 16-byte column of the run."""
    groups: int
    run_bytes: int
    ranks: int
    pixels: int
    threads: int
    smem_bytes: int


@functools.lru_cache(maxsize=None)  # on every call of the wrapper: keep the host fast
def gn_plan(H, W, C, num_groups, dtype, *, run_bytes=RUN_BYTES,
            cluster_slab_bytes=CLUSTER_SLAB_BYTES, warps=None) -> GNPlan:
    """The split of a call on (B, H, W, C) ``dtype`` input (the batch is
    the grid's other dimension and does not enter): the fewest whole groups
    per run that divide ``num_groups``, make a multiple of 16 bytes a pixel
    and reach ``run_bytes`` (else all the groups); one block a slab if it
    fits SLAB_BYTES, else the smallest cluster (2, 4, 8 or 16 blocks
    along the pixels) whose blocks' parts fit ``cluster_slab_bytes``, else
    the smallest whose blocks' parts fit their shared memory; and
    ``warps`` warps a block, or as many as give each thread
    VECTORS_PER_THREAD 16-byte vectors. Raises ValueError where the kernel
    cannot take the call: a pixel's C values are not a multiple of 16 bytes,
    a run is wider than a warp's 32 16-byte loads, or no cluster of up to 16
    blocks holds the slab."""
    size = dtype.itemsize
    if (C * size) % 16 or C % num_groups:
        raise ValueError(f"gn_plan: a pixel's {C} channels of {dtype} are {C * size} bytes, not "
                         f"a multiple of 16, or not {num_groups} whole groups")
    cg = C // num_groups
    step = 16 // math.gcd(cg * size, 16)  # the fewest groups that make 16-byte multiples
    fits = [r for r in range(step, num_groups + 1, step) if num_groups % r == 0]
    groups = next((r for r in fits if r * cg * size >= run_bytes), fits[-1])
    run_ch, vecs = groups * cg, groups * cg * size // 16
    if vecs > 32:
        raise ValueError(f"gn_plan: a run of {groups} groups is {vecs} 16-byte vectors a pixel, "
                         "more than a warp's 32 lanes")
    HW = H * W
    clusters = (2, 4, 8, MAX_RANKS)
    # one block; a cluster within its budget; a cluster within shared memory
    for ranks, budget in ([(1, SLAB_BYTES)] + [(k, cluster_slab_bytes) for k in clusters]
                          + [(k, MAX_SMEM_BYTES) for k in clusters]):
        pixels = -(-HW // ranks)
        w = warps or min(MAX_WARPS, max(MIN_WARPS, -(-pixels * vecs // (32 * VECTORS_PER_THREAD))))
        # the slab, the warps' per-channel sums, the channels' parameters
        # (then A and B), the group sums
        smem = 16 * pixels * vecs + 4 * (2 * w * run_ch + 4 * run_ch + 2 * groups)
        if pixels * (ranks - 1) < HW and 16 * pixels * vecs <= budget and smem <= MAX_SMEM_BYTES:
            return GNPlan(groups, run_ch * size, ranks, pixels, 32 * w, smem)
    raise ValueError(f"gn_plan: no cluster of up to {MAX_RANKS} blocks holds a slab of {HW} "
                     f"pixels x {run_ch * size} bytes in {MAX_SMEM_BYTES} bytes of shared memory "
                     "a block")


def gn_film_silu_kernel(x, gamma, beta, film_shift=None, film_scale=None, *,
                        num_groups: int = 32, eps: float = 1e-6,
                        apply_silu: bool = True) -> torch.Tensor:
    """GroupNorm(+FiLM)(+SiLU) as one CUDA kernel (``csrc/gn_film_silu.cu``).

    Replaces JAX's Pallas ``_gn_kernel`` (ops/groupnorm.py, through
    ``gn_film_silu_pallas``). Bound by bytes: one launch reads x once into
    shared memory and writes y once, a block (or a thread-block cluster
    where one block cannot hold it) per (sample, run of groups) slab, as
    :func:`gn_plan` splits the call (see the source's header). CUDA tensors
    only, like the backward passes of the attention: the CPU path is
    :func:`gn_film_silu_kernel_reference`, which :func:`gn_film_silu` takes
    for a CPU tensor. Raises before any launch where the kernel cannot take
    the call (see :func:`gn_plan`; x not 16-byte aligned). Inference only:
    nothing here is differentiable."""
    _, H, W, C = check_gn_input("gn_film_silu_kernel", x, gamma, beta, film_shift, film_scale,
                                num_groups)
    need_cuda("gn_film_silu_kernel", x, gamma, beta, film_shift, film_scale)
    out = launch_planned(x, gamma, beta, film_shift, film_scale, num_groups, eps, apply_silu,
                         gn_plan(H, W, C, num_groups, x.dtype))
    gn_film_silu_kernel.launches += 1
    return out


def launch_planned(x, gamma, beta, film_shift, film_scale, num_groups, eps, apply_silu, plan):
    """One launch of ``csrc/gn_film_silu.cu`` split as ``plan`` says, on
    input :func:`gn_film_silu_kernel` has checked (its body; the probe
    scripts time other plans through it). Counts nothing. Raises before the
    launch where x is not on a 16-byte boundary."""
    if x.data_ptr() % 16:
        raise ValueError("gn_film_silu_kernel: x must start on a 16-byte boundary (16-byte "
                         f"loads), got address {x.data_ptr():#x}")
    B, H, W, C = x.shape
    gamma, beta = gamma.float().contiguous(), beta.float().contiguous()
    out = torch.empty_like(x)
    err = kernels.library().vdiff_gn_film_silu(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), *film_args(film_shift, film_scale),
        out.data_ptr(), B, H * W, C, num_groups, eps, int(apply_silu),
        int(x.dtype == torch.bfloat16), plan.groups, plan.ranks, plan.pixels, plan.threads,
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(err, "vdiff_gn_film_silu")
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
    shard=None,
) -> torch.Tensor:
    """x: (B, H, W, C) (any strides; contiguous for the kernel); gamma/beta:
    (C,); film_*: (B, C) or None; ``shard``: the height shard x is one part
    of (:func:`_stats`), for the default chain at inference only.

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
    if shard is not None and (use_kernel or torch.is_grad_enabled()):
        raise RuntimeError("gn_film_silu: a height shard takes the default chain at inference "
                           "only; the one-kernel form computes its statistics from its own rows")
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
    mean, inv = _stats(x, num_groups, eps, shard)
    return _forward(x, gamma, beta, film_shift, film_scale, mean, inv, apply_silu)
