"""Fused GroupNorm(+FiLM) → SiLU → 3x3 conv (+bias, +skip-add).

Counterpart of ``vdiff_tpu/ops/conv3x3.py``: the residual block's inference
chain ``GN[(+FiLM)] → SiLU → conv3x3`` plus the residual add, with the
normalised activation kept out of device memory.

* :func:`fused_gn_silu_conv3x3` wraps two CUDA kernels: a statistics pass
  that leaves the f32 (B, C_in) coefficients A and B (``gn_common.cuh``,
  shared with B10), then a conv pass. bf16 calls run the tensor-core conv of
  ``csrc/gn_silu_conv3x3_tc.cu`` (halo tiles of y = ``silu(x·A + B)`` staged
  once per chunk of channels, mma.sync over the 9 shifted windows), at the
  tile :func:`conv_tc_tile` picks; f32 calls the FMA conv of
  ``csrc/gn_silu_conv3x3.cu``, which applies the prologue to each input value
  as it loads it. Given a CPU tensor it returns the twin's result; given a
  CUDA tensor it launches the kernels or raises. It counts its calls that
  launch in ``.launches`` (one per call: the two passes are one count).
* :func:`fused_gn_silu_conv3x3_reference` is the kernel's arithmetic in plain
  PyTorch. It is not the unfused path: the kernel keeps A and B in f32, rounds
  y once to x's dtype, multiplies operands of x's dtype with f32 accumulation
  and adds the f32 bias and skip before its one output cast, where the default
  chain rounds after each step.
* :func:`fusable` is routing: JAX's gates, copied so that the same convs of a
  UNet go fused as on a TPU. They shape no Hopper kernel: the kernel takes f32
  and bf16, any C_in divisible by ``num_groups``, any C_out, H and W.

Inference only; training takes the composition in ``ops/groupnorm.py``.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F

from .. import kernels
from .groupnorm import check_gn_input, coefficients, film_args, need_cuda

#: C_in above this does not fit the conv pass's shared-memory coefficients
MAX_C_IN = 4096


def _check(name, x, weight, bias, gamma, beta, film_shift, film_scale, skip, num_groups):
    """Shapes, dtypes and layouts the kernel takes; returns (B, H, W, C, CO)."""
    apply_gn = gamma is not None
    if not apply_gn and any(a is not None for a in (beta, film_shift, film_scale)):
        raise ValueError(f"{name}: beta and FiLM need gamma (without it the conv is bare)")
    if apply_gn:
        if beta is None:
            raise ValueError(f"{name}: gamma comes with beta")
        B, H, W, C = check_gn_input(name, x, gamma, beta, film_shift, film_scale, num_groups)
    else:
        if x.dim() != 4 or x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous():
            raise ValueError(f"{name}: x must be contiguous (B, H, W, C) float32 or bfloat16, got "
                             f"{tuple(x.shape)} {x.dtype} strides {x.stride()}")
        B, H, W, C = x.shape
    if weight.dim() != 4 or weight.shape[1:] != (C, 3, 3):
        raise ValueError(f"{name}: weight must be (C_out, {C}, 3, 3), got {tuple(weight.shape)}")
    CO = weight.shape[0]
    if bias.shape != (CO,):
        raise ValueError(f"{name}: bias must be ({CO},), got {tuple(bias.shape)}")
    if skip is not None and (skip.shape != (B, H, W, CO) or skip.dtype != x.dtype
                             or not skip.is_contiguous()):
        raise ValueError(f"{name}: skip must be contiguous {(B, H, W, CO)} {x.dtype}, got "
                         f"{tuple(skip.shape)} {skip.dtype} strides {skip.stride()}")
    if C > MAX_C_IN:
        raise ValueError(f"{name}: C_in={C} exceeds {MAX_C_IN}")
    return B, H, W, C, CO


def fused_gn_silu_conv3x3_reference_f32(x, weight, bias, gamma=None, beta=None, film_shift=None,
                                        film_scale=None, skip=None, *, num_groups: int = 32,
                                        eps: float = 1e-6) -> torch.Tensor:
    """:func:`fused_gn_silu_conv3x3_reference` before its one output cast: the
    f32 (B, H, W, C_out) sum that the kernel rounds to x's dtype."""
    _check("fused_gn_silu_conv3x3_reference", x, weight, bias, gamma, beta, film_shift,
           film_scale, skip, num_groups)
    y = x
    if gamma is not None:
        a, b = coefficients(x, gamma, beta, film_shift, film_scale, num_groups, eps)
        y = F.silu(x.float() * a[:, None, None, :] + b[:, None, None, :]).to(x.dtype)
    out = F.conv2d(y.float().permute(0, 3, 1, 2), weight.to(x.dtype).float(), bias.float(),
                   padding=1).permute(0, 2, 3, 1)
    if skip is not None:
        out = out + skip.float()
    return out.contiguous()


def fused_gn_silu_conv3x3_reference(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    gamma: Optional[torch.Tensor] = None,
    beta: Optional[torch.Tensor] = None,
    film_shift: Optional[torch.Tensor] = None,
    film_scale: Optional[torch.Tensor] = None,
    skip: Optional[torch.Tensor] = None,
    *,
    num_groups: int = 32,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Plain twin of :func:`fused_gn_silu_conv3x3` (the Pallas
    ``_gn_silu_conv_kernel``'s arithmetic): y = silu(x·A + B) in f32 with f32
    coefficients, rounded to x's dtype; the weights rounded to x's dtype; both
    widened to f32 and convolved in f32 (zero padding of y); + f32 bias + f32
    skip; one cast. On a CUDA tensor the f32 conv follows
    ``torch.backends.cudnn.allow_tf32``, which a comparison sets to False."""
    return fused_gn_silu_conv3x3_reference_f32(
        x, weight, bias, gamma, beta, film_shift, film_scale, skip, num_groups=num_groups,
        eps=eps).to(x.dtype)


def conv_tc_tile(W: int) -> int:
    """Output columns of a block of ``gn_silu_conv3x3_tc.cu`` (8 rows × 128
    output channels) for images W wide: 16, or 8 on images at most 8 wide,
    where an 8×16 tile would be half outside the image (on the H100 the
    8-wide tile ran 0.060 ms at B=64, 8×8, 256→256 against 0.076). The tile
    moves no result: each output's sum runs over the same chunks and taps
    in the same order."""
    return 16 if W > 8 else 8


def fused_gn_silu_conv3x3(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    gamma: Optional[torch.Tensor] = None,
    beta: Optional[torch.Tensor] = None,
    film_shift: Optional[torch.Tensor] = None,
    film_scale: Optional[torch.Tensor] = None,
    skip: Optional[torch.Tensor] = None,
    *,
    num_groups: int = 32,
    eps: float = 1e-6,
) -> torch.Tensor:
    """out = conv3x3(silu(GN_film(x))) + bias (+ skip), CUDA kernels
    ``csrc/gn_silu_conv3x3_tc.cu`` (bf16) and ``csrc/gn_silu_conv3x3.cu``
    (f32).

    x: (B, H, W, C_in) NHWC, contiguous (an NCHW ``channels_last`` tensor
    viewed as NHWC is read in place); weight: (C_out, C_in, 3, 3), the
    ``nn.Conv2d`` layout; bias: (C_out,); gamma/beta: (C_in,); film_*:
    (B, C_in) rows, f32 or x's dtype, possibly strided (the halves of one
    (B, 2·C_in) projection), or None; skip: (B, H, W, C_out) in x's dtype or
    None. Without gamma the GN+SiLU prologue is left out (a bare conv).
    Returns (B, H, W, C_out) in x's dtype.

    Replaces JAX's Pallas ``_gn_silu_conv_kernel`` (ops/conv3x3.py). Bound by
    operations. A bf16 call runs the statistics pass, then the tensor-core
    conv pass at the tile :func:`conv_tc_tile` picks; an f32 call the same
    statistics pass, then the FMA conv pass (see the sources' headers). The
    wrapper lays the weights out as both read them, (9·C_in, C_out) with taps
    dy-major, in x's dtype (for bf16, columns padded with zeros to a multiple
    of 8, the 16-byte rows the tensor-core kernel copies): one transposing
    copy of the weights per call."""
    B, H, W, C, CO = _check("fused_gn_silu_conv3x3", x, weight, bias, gamma, beta, film_shift,
                            film_scale, skip, num_groups)
    if x.device.type == "cpu":
        return fused_gn_silu_conv3x3_reference(x, weight, bias, gamma, beta, film_shift,
                                               film_scale, skip, num_groups=num_groups, eps=eps)
    need_cuda("fused_gn_silu_conv3x3", x, weight, bias, gamma, beta, film_shift, film_scale, skip)
    launch = _launch_tc if x.dtype == torch.bfloat16 else _launch_fma
    out = launch(x, weight, bias, gamma, beta, film_shift, film_scale, skip, num_groups, eps)
    fused_gn_silu_conv3x3.launches += 1
    return out


fused_gn_silu_conv3x3.launches = 0


def _operands(x, weight, bias, gamma, beta, ldw):
    """The kernels' operands: the (9·C_in, ldw) weights in x's dtype (columns
    past C_out zero), f32 bias, gamma and beta, the output and the f32
    coefficient scratch (None without gamma)."""
    B, H, W, C = x.shape
    CO = weight.shape[0]
    taps = weight.permute(2, 3, 1, 0).reshape(9 * C, CO)
    if ldw == CO:
        w2 = taps.to(x.dtype).contiguous()
    else:
        w2 = torch.zeros(9 * C, ldw, dtype=x.dtype, device=x.device)
        w2[:, :CO] = taps
    out = torch.empty(B, H, W, CO, dtype=x.dtype, device=x.device)
    coef = None
    if gamma is not None:
        gamma, beta = gamma.float().contiguous(), beta.float().contiguous()
        coef = torch.empty(2, B, C, dtype=torch.float32, device=x.device)
    return w2, bias.float().contiguous(), gamma, beta, out, coef


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_fma(x, weight, bias, gamma, beta, film_shift, film_scale, skip, num_groups, eps):
    """The statistics pass, then the FMA conv pass (entry
    ``vdiff_gn_silu_conv3x3``), on checked CUDA inputs of either dtype; the
    caller counts the launch."""
    B, H, W, C = x.shape
    CO = weight.shape[0]
    w2, bias, gamma, beta, out, coef = _operands(x, weight, bias, gamma, beta, CO)
    err = kernels.library().vdiff_gn_silu_conv3x3(
        x.data_ptr(), w2.data_ptr(), bias.data_ptr(), _ptr(gamma), _ptr(beta),
        *film_args(film_shift, film_scale), _ptr(skip), out.data_ptr(), _ptr(coef),
        B, H, W, C, CO, num_groups, eps, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(err, "vdiff_gn_silu_conv3x3")
    return out


def _launch_tc(x, weight, bias, gamma, beta, film_shift, film_scale, skip, num_groups, eps,
               tile_w=None):
    """The statistics pass, then the tensor-core conv pass (entry
    ``vdiff_gn_silu_conv3x3_tc``), on checked bf16 CUDA inputs, at ``tile_w``
    output columns a block (default :func:`conv_tc_tile`); the caller counts
    the launch."""
    B, H, W, C = x.shape
    CO = weight.shape[0]
    ldw = -(-CO // 8) * 8
    w2, bias, gamma, beta, out, coef = _operands(x, weight, bias, gamma, beta, ldw)
    err = kernels.library().vdiff_gn_silu_conv3x3_tc(
        x.data_ptr(), w2.data_ptr(), ldw, bias.data_ptr(), _ptr(gamma), _ptr(beta),
        *film_args(film_shift, film_scale), _ptr(skip), out.data_ptr(), _ptr(coef),
        B, H, W, C, CO, num_groups, eps, tile_w or conv_tc_tile(W),
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(err, "vdiff_gn_silu_conv3x3_tc")
    return out


def fusable(x: torch.Tensor, c_out: int) -> bool:
    """Whether JAX's UNet would send this conv to its fused kernel on a TPU:
    ``VDIFF_FUSED_CONV=1`` (off by default), bf16 activations, C_in and C_out
    multiples of 128, H·W a multiple of 16, and JAX's one-image working-set
    estimate within 14 MiB. x: (B, H, W, C_in). The gates are JAX's routing
    (``vdiff_tpu/ops/conv3x3.py::fusable`` without its backend check), kept so
    that both packages fuse the same convs; none is a limit of the CUDA
    kernel."""
    if os.environ.get("VDIFF_FUSED_CONV", "0") != "1":
        return False
    B, H, W, C = x.shape
    if x.dtype != torch.bfloat16:
        return False
    if C % 128 or c_out % 128:
        return False
    if (H * W) % 16:
        return False
    hw = H * W
    bytes_p1 = hw * C * (2 * 2 + 4 + 4 + 2 + 2) + hw * c_out * (4 + 2 * 2) + 9 * C * c_out * 2
    return bytes_p1 <= 14 * 1024 * 1024
