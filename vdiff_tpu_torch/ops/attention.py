"""Spatial self-attention on the fused qkv projection.

Counterpart of ``vdiff_tpu/ops/attention.py``'s CIFAR paths. Every forward
takes the fused projection output ``qkv`` of shape (B, T, 3·N·C), laid out
[q heads | k heads | v heads], and returns (B, T, N·C); the backward returns
d(qkv) in the same layout as one buffer:

* :func:`attention_qkv_reference` is the plain PyTorch forward, the twin of
  JAX's ``_xla_attention``; :func:`attention_qkv_bwd_reference` the plain
  backward, the twin of the Pallas ``_attn_bwd_kernel``. They are the CPU
  path and what the kernels are held against on the card.
* :func:`attn_fwd_online`, :func:`attn_fwd_qblk` and :func:`attn_fwd_train`
  wrap the forward CUDA kernels (``csrc/attn_fwd_online.cu``,
  ``csrc/attn_fwd_qblk.cu``, ``csrc/attn_fwd_train.cu``);
  :func:`attn_bwd_rows` and :func:`attn_bwd_cols` the two passes of the
  backward (``csrc/attn_bwd_rows.cu``, ``csrc/attn_bwd_cols.cu``), which
  :func:`attn_bwd` runs in turn.
* :func:`spatial_attention_qkv` dispatches on the token count and, with
  ``train=True``, goes through :class:`TrainableAttention`, the
  ``torch.autograd.Function`` counterpart of ``flash_attention_trainable``.

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


def _need_cuda(fn_name: str, *tensors: torch.Tensor):
    for t in tensors:
        if t.device.type != "cuda":
            raise RuntimeError(f"{fn_name}: tensor on {t.device}; the kernel needs a CUDA tensor")


def _launch(fn_name: str, qkv: torch.Tensor, num_heads: int, B: int, T: int, C: int):
    _need_cuda(fn_name, qkv)
    out = torch.empty(B, T, num_heads * C, dtype=qkv.dtype, device=qkv.device)
    err = getattr(kernels.library(), fn_name)(
        qkv.data_ptr(), out.data_ptr(), B, T, num_heads, C,
        int(qkv.dtype == torch.bfloat16), torch.cuda.current_stream(qkv.device).cuda_stream,
    )
    kernels.check(err, fn_name)
    return out


def _check_max_t(name: str, T: int, C: int, max_t_fn: str):
    max_t = getattr(kernels.library(), max_t_fn)(C)
    if T > max_t:
        raise ValueError(f"{name}: T={T} exceeds the shared-memory score row ({max_t} at C={C})")


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
    _need_cuda("attn_fwd_qblk", qkv)
    _check_max_t("attn_fwd_qblk", T, C, "vdiff_attn_fwd_qblk_max_t")
    out = _launch("vdiff_attn_fwd_qblk", qkv, num_heads, B, T, C)
    attn_fwd_qblk.launches += 1
    return out


attn_fwd_qblk.launches = 0


def attn_fwd_train(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Training attention forward at T ≤ 512 (CUDA kernel ``attn_fwd_train.cu``).

    Replaces JAX's Pallas ``_attn_fwd_kernel`` (ops/attention.py, used by
    ``flash_attention_trainable`` at T ≤ 512). A whole (T, T) tile does not
    fit a block's shared memory at T=256, so the kernel is q-tiled with the
    (16, T) score row resident; it normalises P when C ≥ T and divides the
    output otherwise, as the Pallas kernel does. Compute bound; f32 FMAs in
    this first version."""
    B, T, C = _check_kernel_input(qkv, num_heads, "attn_fwd_train")
    if qkv.device.type == "cpu":
        return attention_qkv_reference(qkv, num_heads)
    _need_cuda("attn_fwd_train", qkv)
    _check_max_t("attn_fwd_train", T, C, "vdiff_attn_fwd_qblk_max_t")
    out = _launch("vdiff_attn_fwd_train", qkv, num_heads, B, T, C)
    attn_fwd_train.launches += 1
    return out


attn_fwd_train.launches = 0


def attention_qkv_bwd_reference(qkv: torch.Tensor, g: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain attention backward, following the Pallas ``_attn_bwd_kernel``
    line for line: P recomputed in f32 with scale 1/√C after the q·k product,
    dP = dO·Vᵀ, dS = P∘(dP − rowsum(P∘dP)), dQ = dS·K/√C, dK = dSᵀ·Q/√C,
    dV = Pᵀ·dO. P and dS are rounded to the input dtype only as matmul
    operands; every product accumulates in f32. ``g`` is d(out), (B, T, N·C);
    returns d(qkv) (B, T, 3·N·C) in qkv's dtype."""
    B, T, C = _shape(qkv, num_heads)
    dt = qkv.dtype
    scale = 1.0 / math.sqrt(C)
    q, k, v = (a.float() for a in qkv.reshape(B, T, 3, num_heads, C).unbind(2))
    do = g.reshape(B, T, num_heads, C).float()
    s = torch.einsum("btnc,bsnc->bnts", q, k) * scale
    p = torch.softmax(s, dim=-1)
    dp = torch.einsum("btnc,bsnc->bnts", do, v)
    ds = (p * (dp - (p * dp).sum(dim=-1, keepdim=True))).to(dt).float()
    pn = p.to(dt).float()
    dq = torch.einsum("bnts,bsnc->btnc", ds, k) * scale
    dk = torch.einsum("bnts,btnc->bsnc", ds, q) * scale
    dv = torch.einsum("bnts,btnc->bsnc", pn, do)
    return torch.stack([dq, dk, dv], dim=2).to(dt).reshape(B, T, 3 * num_heads * C)


def _check_bwd_input(qkv: torch.Tensor, g: torch.Tensor, num_heads: int, name: str):
    B, T, C = _check_kernel_input(qkv, num_heads, name)
    if g.shape != (B, T, num_heads * C) or g.dtype != qkv.dtype or g.device != qkv.device:
        raise ValueError(f"{name}: d(out) must be {(B, T, num_heads * C)} {qkv.dtype} on "
                         f"{qkv.device}, got {tuple(g.shape)} {g.dtype} on {g.device}")
    if not g.is_contiguous():
        raise ValueError(f"{name}: d(out) must be contiguous")
    return B, T, C


def _bwd_args(qkv, num_heads, B, T, C):
    return (B, T, num_heads, C, int(qkv.dtype == torch.bfloat16),
            torch.cuda.current_stream(qkv.device).cuda_stream)


def attn_bwd_rows(qkv: torch.Tensor, g: torch.Tensor, num_heads: int, dqkv: torch.Tensor):
    """First backward pass (CUDA kernel ``attn_bwd_rows.cu``): writes dQ into
    the q columns of ``dqkv`` and returns the f32 row statistics (lse, δ),
    each (B, N, T), that :func:`attn_bwd_cols` reads. CUDA tensors only: the
    CPU path of the backward is :func:`attention_qkv_bwd_reference`."""
    B, T, C = _check_bwd_input(qkv, g, num_heads, "attn_bwd_rows")
    _need_cuda("attn_bwd_rows", qkv, g, dqkv)
    _check_max_t("attn_bwd_rows", T, C, "vdiff_attn_bwd_rows_max_t")
    lse = torch.empty(B, num_heads, T, dtype=torch.float32, device=qkv.device)
    delta = torch.empty_like(lse)
    err = kernels.library().vdiff_attn_bwd_rows(
        qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        *_bwd_args(qkv, num_heads, B, T, C))
    kernels.check(err, "vdiff_attn_bwd_rows")
    attn_bwd_rows.launches += 1
    return lse, delta


attn_bwd_rows.launches = 0


def attn_bwd_cols(qkv: torch.Tensor, g: torch.Tensor, num_heads: int, lse: torch.Tensor,
                  delta: torch.Tensor, dqkv: torch.Tensor) -> None:
    """Second backward pass (CUDA kernel ``attn_bwd_cols.cu``): dK and dV into
    the k and v columns of ``dqkv``, from :func:`attn_bwd_rows`' statistics.
    CUDA tensors only."""
    B, T, C = _check_bwd_input(qkv, g, num_heads, "attn_bwd_cols")
    _need_cuda("attn_bwd_cols", qkv, g, lse, delta, dqkv)
    err = kernels.library().vdiff_attn_bwd_cols(
        qkv.data_ptr(), g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dqkv.data_ptr(),
        *_bwd_args(qkv, num_heads, B, T, C))
    kernels.check(err, "vdiff_attn_bwd_cols")
    attn_bwd_cols.launches += 1


attn_bwd_cols.launches = 0


def attn_bwd(qkv: torch.Tensor, g: torch.Tensor, num_heads: int) -> torch.Tensor:
    """d(qkv) (B, T, 3·N·C) from qkv and d(out), at any T the kernels take.

    Replaces JAX's Pallas ``_attn_bwd_kernel`` (T ≤ 512) and
    ``_attn_bwd_kernel_qblk`` (T > 512): both compute this one backward. On a
    CPU tensor returns :func:`attention_qkv_bwd_reference`; on a CUDA tensor
    runs the row pass (dQ, lse, δ) and then the column pass (dK, dV) into one
    buffer, deterministically (no atomics)."""
    _check_bwd_input(qkv, g, num_heads, "attn_bwd")
    if qkv.device.type == "cpu":
        return attention_qkv_bwd_reference(qkv, g, num_heads)
    dqkv = torch.empty_like(qkv)
    lse, delta = attn_bwd_rows(qkv, g, num_heads, dqkv)
    attn_bwd_cols(qkv, g, num_heads, lse, delta, dqkv)
    return dqkv


class TrainableAttention(torch.autograd.Function):
    """Differentiable attention on the fused qkv: the counterpart of JAX's
    ``flash_attention_trainable`` custom VJP. The forward saves qkv (JAX saves
    q/k/v) and runs :func:`attn_fwd_train` at T ≤ 512 or :func:`attn_fwd_qblk`
    above; the backward recomputes P and returns d(qkv) from :func:`attn_bwd`."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
        ctx.save_for_backward(qkv)
        ctx.num_heads = num_heads
        if qkv.shape[1] <= QBLK_THRESHOLD:
            return attn_fwd_train(qkv, num_heads)
        return attn_fwd_qblk(qkv, num_heads)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (qkv,) = ctx.saved_tensors
        return attn_bwd(qkv, g.contiguous(), ctx.num_heads), None


def spatial_attention_qkv(qkv: torch.Tensor, num_heads: int, train: bool = False) -> torch.Tensor:
    """(B, T, 3·N·C) → (B, T, N·C). At inference T ≤ 512 takes the
    online-softmax kernel (the sampler's T=64 too, where JAX uses XLA), T > 512
    the q-blocked one. With ``train`` the call is differentiable through
    :class:`TrainableAttention`, as JAX's ``train=True`` goes through
    ``flash_attention_trainable``."""
    if train:
        return TrainableAttention.apply(qkv, num_heads)
    if qkv.shape[1] <= QBLK_THRESHOLD:
        return attn_fwd_online(qkv, num_heads)
    return attn_fwd_qblk(qkv, num_heads)
