"""Spatial self-attention on the fused qkv projection.

Counterpart of ``vdiff_tpu/ops/attention.py``'s inference path. Every entry
takes the fused projection output ``qkv`` of shape (B, T, 3·N·C), laid out
[q heads | k heads | v heads], and returns (B, T, N·C):

* :func:`attention_qkv_reference` is the plain PyTorch version, the twin of
  JAX's ``_xla_attention``. It is the CPU path and what the kernels are held
  against on the card.
* :func:`attn_fwd_online` and :func:`attn_fwd_qblk` wrap the two hand-written
  CUDA kernels (``csrc/attn_fwd_online.cu``, ``csrc/attn_fwd_qblk.cu``).
* :func:`spatial_attention_qkv` dispatches on the token count.

A wrapper given a CPU tensor returns the twin's result; given a CUDA tensor it
launches its kernel or raises. Each counts its launches in ``.launches``.
"""

from __future__ import annotations

import math

import torch

from .. import kernels

#: token counts above this take the q-blocked direct-softmax kernel, as JAX's
#: ``flash_attention_qkv`` does (``_QBLK_THRESHOLD``)
QBLK_THRESHOLD = 512

_HEAD_DIMS = (32, 64, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)


def attention_qkv_reference(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain attention: scores in f32, softmax in f32 with scale 1/√C, the
    probabilities cast to v's dtype for the second product (``_xla_attention``)."""
    B, T, C = _shape(qkv, num_heads)
    q, k, v = qkv.reshape(B, T, 3, num_heads, C).unbind(2)
    logits = torch.einsum("btnc,bsnc->bnts", q.float(), k.float())
    weights = torch.softmax(logits * (1.0 / math.sqrt(C)), dim=-1).to(v.dtype)
    out = torch.einsum("bnts,bsnc->btnc", weights, v)
    return out.reshape(B, T, num_heads * C)


def _shape(qkv: torch.Tensor, num_heads: int):
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"qkv must be (B, T, 3*N*C) with N={num_heads}, got {tuple(qkv.shape)}")
    B, T, three_nc = qkv.shape
    return B, T, three_nc // (3 * num_heads)


def _check_kernel_input(qkv: torch.Tensor, num_heads: int, name: str):
    """Shape/dtype/layout gates shared by both kernels; returns (B, T, C)."""
    B, T, C = _shape(qkv, num_heads)
    if qkv.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {qkv.dtype} not supported (float32, bfloat16)")
    if C not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim {C} not supported {_HEAD_DIMS}")
    if T % 32:
        raise ValueError(f"{name}: token count {T} must be a multiple of 32")
    if not qkv.is_contiguous():
        raise ValueError(f"{name}: qkv must be contiguous")
    return B, T, C


def _launch(fn_name: str, qkv: torch.Tensor, num_heads: int, B: int, T: int, C: int):
    if qkv.device.type != "cuda":
        raise RuntimeError(f"{fn_name}: tensor on {qkv.device}; the kernel needs a CUDA tensor")
    out = torch.empty(B, T, num_heads * C, dtype=qkv.dtype, device=qkv.device)
    err = getattr(kernels.library(), fn_name)(
        qkv.data_ptr(), out.data_ptr(), B, T, num_heads, C,
        int(qkv.dtype == torch.bfloat16), torch.cuda.current_stream(qkv.device).cuda_stream,
    )
    kernels.check(err, fn_name)
    return out


def attn_fwd_online(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Online-softmax attention forward (CUDA kernel ``attn_fwd_online.cu``).

    Replaces JAX's Pallas ``_flash_kernel`` (ops/attention.py, used by
    ``flash_attention_qkv`` at T ≤ 512). Compute bound at the sampler's
    shapes; the first version runs f32 FMAs from shared memory, keeping the q
    tile resident and reading q/k/v straight out of the fused qkv (see the
    source's header for the design)."""
    B, T, C = _check_kernel_input(qkv, num_heads, "attn_fwd_online")
    if qkv.device.type == "cpu":
        return attention_qkv_reference(qkv, num_heads)
    out = _launch("vdiff_attn_fwd_online", qkv, num_heads, B, T, C)
    attn_fwd_online.launches += 1
    return out


attn_fwd_online.launches = 0


def attn_fwd_qblk(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Direct-softmax q-blocked attention forward (CUDA kernel
    ``attn_fwd_qblk.cu``).

    Replaces JAX's Pallas ``_attn_fwd_kernel_qblk`` (ops/attention.py, used by
    ``flash_attention_qkv`` at T > 512). Each block keeps its whole (16, T)
    f32 score row in shared memory, so T is capped by the 227 KB a block may
    use (2848 at C=256); compute bound, f32 FMAs in this first version."""
    B, T, C = _check_kernel_input(qkv, num_heads, "attn_fwd_qblk")
    if qkv.device.type == "cpu":
        return attention_qkv_reference(qkv, num_heads)
    max_t = kernels.library().vdiff_attn_fwd_qblk_max_t(C)
    if T > max_t:
        raise ValueError(f"attn_fwd_qblk: T={T} exceeds the shared-memory score row ({max_t} at C={C})")
    out = _launch("vdiff_attn_fwd_qblk", qkv, num_heads, B, T, C)
    attn_fwd_qblk.launches += 1
    return out


attn_fwd_qblk.launches = 0


def spatial_attention_qkv(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, T, 3·N·C) → (B, T, N·C). T ≤ 512 takes the online-softmax kernel
    (the sampler's T=64 too, where JAX uses XLA), T > 512 the q-blocked one."""
    if qkv.shape[1] <= QBLK_THRESHOLD:
        return attn_fwd_online(qkv, num_heads)
    return attn_fwd_qblk(qkv, num_heads)
