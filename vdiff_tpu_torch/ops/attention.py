"""Spatial self-attention on the fused qkv projection.

Counterpart of ``vdiff_tpu/ops/attention.py``. Every forward takes the fused
projection output ``qkv`` of shape (B, T, 3·N·C), laid out
[q heads | k heads | v heads], and returns (B, T, N·C); the backward returns
d(qkv) in the same layout as one buffer:

* :func:`attention_qkv_reference` is the plain PyTorch forward, the twin of
  JAX's ``_xla_attention``; :func:`attention_qkv_lse_reference` adds the
  per-row logsumexp; :func:`attention_qkv_bwd_reference` is the plain
  full-row backward (the Pallas ``_attn_bwd_kernel``'s math) and
  :func:`attention_qkv_bwd_kv_reference` the kv-chunked one
  (``_attn_bwd_kernel_pack1_kv``'s). They are the CPU path and what the
  kernels are held against on the card.
* :func:`attn_fwd_online`, :func:`attn_fwd_qblk` and :func:`attn_fwd_train`
  wrap the forward CUDA kernels (``csrc/attn_fwd_online.cu``,
  ``csrc/attn_fwd_qblk.cu``, ``csrc/attn_fwd_train.cu``);
  :func:`attn_bwd_rows` and :func:`attn_bwd_cols` the two passes of the
  backward (``csrc/attn_bwd_rows.cu``, ``csrc/attn_bwd_cols.cu``), which
  :func:`attn_bwd` runs in turn. These run f32 FMAs.
* :func:`attn_fwd_tc` and :func:`attn_bwd_tc` wrap the bf16 tensor-core
  kernels (``csrc/attn_fwd_tc.cu``, ``csrc/attn_bwd_tc.cu``). B2's bf16
  calls (:func:`attn_fwd_qblk`) and B5's (:func:`attn_bwd` at T > 512) go to
  them by an explicit dispatch on dtype; f32 calls keep the FMA kernels.
* :func:`attn_fwd_pack1`, :func:`attn_fwd_pack1_lse`, :func:`attn_bwd_pack1`
  and :func:`attn_bwd_pack1_kv` are the counterparts of JAX's head-dim 32/64
  ``pack1`` kernels B6–B9, each with a launch counter of its own. They
  dispatch on dtype as B2 and B5 do: bf16 calls run the tensor-core kernels
  (B6 ``csrc/attn_fwd_tc.cu``, B7 its lse entry, B8 ``csrc/attn_bwd_tc.cu``,
  B9 that file's saved-statistics entry), f32 calls the FMA kernels (B6 B1's
  online kernel, B7 its logsumexp entry, B8 the two backward passes, B9 a
  kv-streamed dQ pass followed by the column pass,
  ``csrc/attn_bwd_pack1_kv.cu``).
* :func:`spatial_attention_qkv` routes each call as JAX's
  ``spatial_attention_qkv`` does on a TPU without head padding
  (:func:`route`) and, with ``train=True``, goes through one of the
  ``torch.autograd.Function`` counterparts of JAX's custom VJPs:
  :class:`QkvAttention` (``flash_attention_trainable`` and
  ``pack1_attention_trainable``) or :class:`Pack1AttentionKV`
  (``pack1_attention_trainable_kv``).

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
#: head dims of JAX's pack1 family: whole heads tile a 128-lane block
_SUBLANE_HEAD_DIMS = (32, 64)
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
    """Direct-softmax q-blocked attention forward: the counterpart of JAX's
    Pallas ``_attn_fwd_kernel_qblk`` (B2; ops/attention.py, used by
    ``flash_attention_qkv`` at T > 512).

    A bf16 CUDA tensor goes to :func:`attn_fwd_tc` (tensor cores, counted
    there). An f32 one launches ``attn_fwd_qblk.cu``, counted here: each
    block keeps its whole (16, T) f32 score row in shared memory, so T is
    capped by the 227 KB a block may use (2848 at C=256); f32 FMAs."""
    B, T, C = _check_kernel_input(qkv, num_heads, "attn_fwd_qblk")
    if qkv.device.type == "cpu":
        return attention_qkv_reference(qkv, num_heads)
    if qkv.dtype == torch.bfloat16:
        return attn_fwd_tc(qkv, num_heads)
    _need_cuda("attn_fwd_qblk", qkv)
    _check_max_t("attn_fwd_qblk", T, C, "vdiff_attn_fwd_qblk_max_t")
    out = _launch("vdiff_attn_fwd_qblk", qkv, num_heads, B, T, C)
    attn_fwd_qblk.launches += 1
    return out


attn_fwd_qblk.launches = 0


def _check_tc(name: str, qkv: torch.Tensor, *others: torch.Tensor):
    """The tensor-core kernels' gates on top of the shape checks: bf16 only,
    and every tensor on a 16-byte boundary (their tiles arrive by 16-byte
    ``cp.async`` copies)."""
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"{name}: dtype {qkv.dtype} not supported (bfloat16; float32 calls "
                        "take the FMA kernels)")
    if any(t.data_ptr() % 16 for t in (qkv, *others)):
        raise ValueError(f"{name}: every tensor must start on a 16-byte boundary")


def attn_fwd_tc(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """bf16 attention forward on the tensor cores (CUDA kernel
    ``attn_fwd_tc.cu``): B2's bf16 calls.

    Replaces JAX's Pallas ``_attn_fwd_kernel_qblk`` (B2) for bf16: per
    64-row q tile, mma.sync products over 64-key tiles (32 at C=256) that
    cp.async double-buffers, an online softmax in f32 registers and the
    output divided once, so any T that is a multiple of 32 runs. Scale on
    f32 S after the product; e is rounded to bf16 as the operand of e·v, the
    one departure from the Pallas kernel's f32 e·v (at most 2^-9·Σ p|v| per
    output). Its CPU twin is :func:`attention_qkv_reference`. The same kernel
    serves B6's bf16 calls (:func:`attn_fwd_pack1`), and with an lse output
    B7's (:func:`attn_fwd_pack1_lse`), each counted by its own wrapper."""
    B, T, C = _check_kernel_input(qkv, num_heads, "attn_fwd_tc")
    _check_tc("attn_fwd_tc", qkv)
    if qkv.device.type == "cpu":
        return attention_qkv_reference(qkv, num_heads)
    out = _fwd_tc("attn_fwd_tc", qkv, num_heads, B, T, C)
    attn_fwd_tc.launches += 1
    return out


attn_fwd_tc.launches = 0


def _fwd_tc(fn_name, qkv, num_heads, B, T, C):
    """Launch ``vdiff_attn_fwd_tc`` on checked bf16 CUDA input; the caller
    counts the launch (B2 under :func:`attn_fwd_tc`, B6 under
    :func:`attn_fwd_pack1`)."""
    _need_cuda(fn_name, qkv)
    out = torch.empty(B, T, num_heads * C, dtype=qkv.dtype, device=qkv.device)
    err = kernels.library().vdiff_attn_fwd_tc(
        qkv.data_ptr(), out.data_ptr(), B, T, num_heads, C,
        torch.cuda.current_stream(qkv.device).cuda_stream)
    kernels.check(err, "vdiff_attn_fwd_tc")
    return out


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


def _bwd_rows(qkv, g, num_heads, dqkv, B, T, C):
    lse = torch.empty(B, num_heads, T, dtype=torch.float32, device=qkv.device)
    delta = torch.empty_like(lse)
    err = kernels.library().vdiff_attn_bwd_rows(
        qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        *_bwd_args(qkv, num_heads, B, T, C))
    kernels.check(err, "vdiff_attn_bwd_rows")
    return lse, delta


def _bwd_cols(qkv, g, num_heads, lse, delta, dqkv, B, T, C):
    err = kernels.library().vdiff_attn_bwd_cols(
        qkv.data_ptr(), g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dqkv.data_ptr(),
        *_bwd_args(qkv, num_heads, B, T, C))
    kernels.check(err, "vdiff_attn_bwd_cols")


def attn_bwd_rows(qkv: torch.Tensor, g: torch.Tensor, num_heads: int, dqkv: torch.Tensor):
    """First backward pass (CUDA kernel ``attn_bwd_rows.cu``): writes dQ into
    the q columns of ``dqkv`` and returns the f32 row statistics (lse, δ),
    each (B, N, T), that :func:`attn_bwd_cols` reads. CUDA tensors only: the
    CPU path of the backward is :func:`attention_qkv_bwd_reference`."""
    B, T, C = _check_bwd_input(qkv, g, num_heads, "attn_bwd_rows")
    _need_cuda("attn_bwd_rows", qkv, g, dqkv)
    _check_max_t("attn_bwd_rows", T, C, "vdiff_attn_bwd_rows_max_t")
    lse, delta = _bwd_rows(qkv, g, num_heads, dqkv, B, T, C)
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
    _bwd_cols(qkv, g, num_heads, lse, delta, dqkv, B, T, C)
    attn_bwd_cols.launches += 1


attn_bwd_cols.launches = 0


def attn_bwd_tc(qkv: torch.Tensor, g: torch.Tensor, num_heads: int) -> torch.Tensor:
    """bf16 attention backward on the tensor cores (entry ``vdiff_attn_bwd_tc``
    of ``attn_bwd_tc.cu``): d(qkv) (B, T, 3·N·C) from qkv and d(out) alone.

    Replaces JAX's Pallas ``_attn_bwd_kernel_qblk`` (B5) for bf16. The entry
    runs a row kernel (per 64-row q tile: a sweep for the f32 row max, sum
    and δ = rowsum(P∘dP), then dS and dQ) and a column kernel (per 64-key
    tile: dK and dV in f32 registers), all products mma.sync with P and dS
    rounded to bf16 as operands; no atomics, any T that is a multiple of 32,
    head dims 32-256. One count per call; B8's bf16 calls
    (:func:`attn_bwd_pack1`) launch the same kernel under their own count.
    Its CPU twin is :func:`attention_qkv_bwd_reference`."""
    B, T, C = _check_bwd_input(qkv, g, num_heads, "attn_bwd_tc")
    _check_tc("attn_bwd_tc", qkv, g)
    if qkv.device.type == "cpu":
        return attention_qkv_bwd_reference(qkv, g, num_heads)
    dqkv = _bwd_tc("attn_bwd_tc", qkv, g, num_heads, B, T, C)
    attn_bwd_tc.launches += 1
    return dqkv


attn_bwd_tc.launches = 0


def _bwd_tc(fn_name, qkv, g, num_heads, B, T, C):
    """Launch ``vdiff_attn_bwd_tc`` on checked bf16 CUDA inputs; the caller
    counts the launch (B5 under :func:`attn_bwd_tc`, B8 under
    :func:`attn_bwd_pack1`)."""
    _need_cuda(fn_name, qkv, g)
    dqkv = torch.empty_like(qkv)
    lse = torch.empty(B, num_heads, T, dtype=torch.float32, device=qkv.device)
    delta = torch.empty_like(lse)
    err = kernels.library().vdiff_attn_bwd_tc(
        qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        B, T, num_heads, C, torch.cuda.current_stream(qkv.device).cuda_stream)
    kernels.check(err, "vdiff_attn_bwd_tc")
    return dqkv


def attn_bwd(qkv: torch.Tensor, g: torch.Tensor, num_heads: int) -> torch.Tensor:
    """d(qkv) (B, T, 3·N·C) from qkv and d(out), at any T the kernels take.

    Replaces JAX's Pallas ``_attn_bwd_kernel`` (B4, T ≤ 512) and
    ``_attn_bwd_kernel_qblk`` (B5, T > 512): both compute this one backward.
    On a CPU tensor returns :func:`attention_qkv_bwd_reference`. B5's bf16
    calls go to :func:`attn_bwd_tc`; every other CUDA call runs the row pass
    (dQ, lse, δ) and then the column pass (dK, dV) into one buffer,
    deterministically (no atomics)."""
    B, T, C = _check_bwd_input(qkv, g, num_heads, "attn_bwd")
    if qkv.device.type == "cpu":
        return attention_qkv_bwd_reference(qkv, g, num_heads)
    if qkv.dtype == torch.bfloat16 and T > QBLK_THRESHOLD:
        return attn_bwd_tc(qkv, g, num_heads)
    dqkv = torch.empty_like(qkv)
    lse, delta = attn_bwd_rows(qkv, g, num_heads, dqkv)
    attn_bwd_cols(qkv, g, num_heads, lse, delta, dqkv)
    return dqkv


def attn_fwd_trainable(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The forward of JAX's ``flash_attention_trainable``: :func:`attn_fwd_train`
    at T ≤ 512, :func:`attn_fwd_qblk` above."""
    if qkv.shape[1] <= QBLK_THRESHOLD:
        return attn_fwd_train(qkv, num_heads)
    return attn_fwd_qblk(qkv, num_heads)


class QkvAttention(torch.autograd.Function):
    """Differentiable attention on the fused qkv that saves qkv (JAX saves
    q/k/v) and recomputes P in the backward: ``QkvAttention.apply(qkv, N, fwd,
    bwd)`` runs ``fwd(qkv, N)`` forward and returns d(qkv) as one buffer from
    ``bwd(qkv, g, N)``. The counterpart of JAX's ``flash_attention_trainable``
    (:func:`attn_fwd_trainable`, :func:`attn_bwd`) and
    ``pack1_attention_trainable`` (:func:`attn_fwd_pack1`,
    :func:`attn_bwd_pack1`; JAX concatenates dq/dk/dv) custom VJPs."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, num_heads: int, fwd, bwd) -> torch.Tensor:
        ctx.save_for_backward(qkv)
        ctx.num_heads, ctx.bwd = num_heads, bwd
        return fwd(qkv, num_heads)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (qkv,) = ctx.saved_tensors
        return ctx.bwd(qkv, g.contiguous(), ctx.num_heads), None, None, None


def attention_qkv_lse_reference(qkv: torch.Tensor, num_heads: int):
    """Plain twin of the Pallas ``_attn_fwd_kernel_pack1_lse`` (B7): q cast
    to f32 and scaled by 1/√C before the product with f32 k, e = exp(s − max),
    out = (e·v)/Σe in f32 cast to qkv's dtype, and lse = max + log Σe per row.
    Returns (out (B, T, N·C), lse (B, N, T) f32); JAX broadcasts lse over each
    head's C lanes of a (B, T, N·C) array, a TPU layout."""
    B, T, C = _shape(qkv, num_heads)
    q, k, v = (a.float() for a in qkv.reshape(B, T, 3, num_heads, C).unbind(2))
    s = torch.einsum("btnc,bsnc->bnts", q * (1.0 / math.sqrt(C)), k)
    m = s.amax(dim=-1, keepdim=True)
    e = s.sub_(m).exp_()  # in place: one (B, N, T, T) f32 tensor at a time
    l = e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bnts,bsnc->btnc", e, v) / l.permute(0, 2, 1, 3)
    lse = (m + torch.log(l)).squeeze(-1)
    return out.to(qkv.dtype).reshape(B, T, num_heads * C), lse


def attention_qkv_bwd_kv_reference(qkv: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                                   g: torch.Tensor, num_heads: int, chunk: int = 1024):
    """Plain twin of the Pallas ``_attn_bwd_kernel_pack1_kv`` (B9), line by
    line in kv chunks of ``chunk`` keys: δ = Σ_C dO∘O from the forward's
    saved output ``out`` in its own dtype; per chunk S = q·kᵀ/√C (scaled after
    the product), P = exp(S − lse) with the forward's ``lse`` (B, N, T) f32,
    dP = dO·vᵀ, dS = P∘(dP − δ), dQ += dS·k/√C, dK = dSᵀ·q/√C, dV = Pᵀ·dO; P and
    dS rounded to the input dtype as matmul operands, every product in f32.
    ``g`` is d(out); returns d(qkv) (B, T, 3·N·C) in qkv's dtype."""
    B, T, C = _shape(qkv, num_heads)
    dt = qkv.dtype
    scale = 1.0 / math.sqrt(C)
    q, k, v = (a.float() for a in qkv.reshape(B, T, 3, num_heads, C).unbind(2))
    do = g.reshape(B, T, num_heads, C).float()
    delta = (do * out.reshape(B, T, num_heads, C).float()).sum(-1).permute(0, 2, 1)[..., None]
    lse = lse.reshape(B, num_heads, T, 1).float()
    dq = torch.zeros_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for j in range(0, T, chunk):
        kj, vj = k[:, j:j + chunk], v[:, j:j + chunk]
        s = torch.einsum("btnc,bsnc->bnts", q, kj) * scale
        p = torch.exp(s - lse)
        dp = torch.einsum("btnc,bsnc->bnts", do, vj)
        ds = (p * (dp - delta)).to(dt).float()
        pn = p.to(dt).float()
        dk[:, j:j + chunk] = torch.einsum("bnts,btnc->bsnc", ds, q) * scale
        dv[:, j:j + chunk] = torch.einsum("bnts,btnc->bsnc", pn, do)
        dq += torch.einsum("bnts,bsnc->btnc", ds, kj) * scale
    return torch.stack([dq, dk, dv], dim=2).to(dt).reshape(B, T, 3 * num_heads * C)


def _check_sublane(qkv: torch.Tensor, num_heads: int, name: str):
    B, T, C = _check_kernel_input(qkv, num_heads, name)
    if C not in _SUBLANE_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {C} not supported {_SUBLANE_HEAD_DIMS}")
    return B, T, C


def attn_fwd_pack1(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Attention forward for head dims 32/64 at any T, counted here and not
    in :func:`attn_fwd_tc` or :func:`attn_fwd_online`.

    Replaces JAX's Pallas ``_attn_fwd_kernel_pack1`` (B6, through
    ``_pack1_fwd_call``), which computes B1's function. The TPU kernel holds a
    whole (bq, T) score tile; at T=4096 no score row fits a block's shared
    memory, and both kernels stream the softmax over key tiles. A bf16 CUDA
    call runs the tensor-core kernel of :func:`attn_fwd_tc`
    (``attn_fwd_tc.cu``; 16-byte alignment checked), which rounds e to bf16
    as the operand of e·v where JAX's B6 takes e·v in f32; an f32 one B1's
    online-softmax FMA kernel (``attn_fwd_online.cu``, entry
    ``vdiff_attn_fwd_online``). Its CPU twin is
    :func:`attention_qkv_lse_reference`'s output: B6's f32 e·v, where
    :func:`attention_qkv_reference` rounds P to a bf16 input's dtype first."""
    B, T, C = _check_sublane(qkv, num_heads, "attn_fwd_pack1")
    if qkv.device.type == "cpu":
        return attention_qkv_lse_reference(qkv, num_heads)[0]
    if qkv.dtype == torch.bfloat16:
        _check_tc("attn_fwd_pack1", qkv)
        out = _fwd_tc("attn_fwd_pack1", qkv, num_heads, B, T, C)
    else:
        out = _launch("vdiff_attn_fwd_online", qkv, num_heads, B, T, C)
    attn_fwd_pack1.launches += 1
    return out


attn_fwd_pack1.launches = 0


def attn_fwd_pack1_lse(qkv: torch.Tensor, num_heads: int):
    """:func:`attn_fwd_pack1` that also returns each row's logsumexp of the
    scaled scores as f32 (B, N, T).

    Replaces JAX's Pallas ``_attn_fwd_kernel_pack1_lse`` (B7, through
    ``_pack1_fwd_lse_call``), the forward of the kv-chunked training path.
    A bf16 CUDA call runs the tensor-core kernel's lse entry
    (``vdiff_attn_fwd_tc_lse`` of ``attn_fwd_tc.cu``; 16-byte alignment
    checked), which rounds e to bf16 as the operand of e·v as
    :func:`attn_fwd_tc` does; an f32 one the online kernel's
    (``vdiff_attn_fwd_pack1_lse`` of ``attn_fwd_online.cu``). Counted here
    either way, not in :func:`attn_fwd_tc`."""
    B, T, C = _check_sublane(qkv, num_heads, "attn_fwd_pack1_lse")
    if qkv.device.type == "cpu":
        return attention_qkv_lse_reference(qkv, num_heads)
    _need_cuda("attn_fwd_pack1_lse", qkv)
    out = torch.empty(B, T, num_heads * C, dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty(B, num_heads, T, dtype=torch.float32, device=qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    if qkv.dtype == torch.bfloat16:
        _check_tc("attn_fwd_pack1_lse", qkv)
        err = kernels.library().vdiff_attn_fwd_tc_lse(
            qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), B, T, num_heads, C, stream)
        kernels.check(err, "vdiff_attn_fwd_tc_lse")
    else:
        err = kernels.library().vdiff_attn_fwd_pack1_lse(
            qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), B, T, num_heads, C, 0, stream)
        kernels.check(err, "vdiff_attn_fwd_pack1_lse")
    attn_fwd_pack1_lse.launches += 1
    return out, lse


attn_fwd_pack1_lse.launches = 0


def attn_bwd_pack1(qkv: torch.Tensor, g: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Full-row attention backward for head dims 32/64: d(qkv) (B, T, 3·N·C).

    Replaces JAX's Pallas ``_attn_bwd_kernel_pack1`` (B8, through
    ``_pack1_bwd_call``), which computes B4's function. A bf16 CUDA call runs
    the tensor-core backward of :func:`attn_bwd_tc` (``attn_bwd_tc.cu``; any
    T, 16-byte alignment checked); an f32 one the row and column kernels of
    :func:`attn_bwd_rows` / :func:`attn_bwd_cols` (``attn_bwd_rows.cu``,
    ``attn_bwd_cols.cu``; T ≤ 1664 at C=64). Either way one launch is counted
    here, and the other wrappers' counts stay B4's and B5's."""
    B, T, C = _check_bwd_input(qkv, g, num_heads, "attn_bwd_pack1")
    if C not in _SUBLANE_HEAD_DIMS:
        raise ValueError(f"attn_bwd_pack1: head dim {C} not supported {_SUBLANE_HEAD_DIMS}")
    if qkv.device.type == "cpu":
        return attention_qkv_bwd_reference(qkv, g, num_heads)
    if qkv.dtype == torch.bfloat16:
        _check_tc("attn_bwd_pack1", qkv, g)
        dqkv = _bwd_tc("attn_bwd_pack1", qkv, g, num_heads, B, T, C)
    else:
        _need_cuda("attn_bwd_pack1", qkv, g)
        _check_max_t("attn_bwd_pack1", T, C, "vdiff_attn_bwd_rows_max_t")
        dqkv = torch.empty_like(qkv)
        lse, delta = _bwd_rows(qkv, g, num_heads, dqkv, B, T, C)
        _bwd_cols(qkv, g, num_heads, lse, delta, dqkv, B, T, C)
    attn_bwd_pack1.launches += 1
    return dqkv


attn_bwd_pack1.launches = 0


def attn_bwd_pack1_kv(qkv: torch.Tensor, out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                      num_heads: int) -> torch.Tensor:
    """kv-streamed attention backward for head dims 32/64 at any T, from the
    forward's ``out`` and ``lse`` (:func:`attn_fwd_pack1_lse`): d(qkv).

    Replaces JAX's Pallas ``_attn_bwd_kernel_pack1_kv`` (B9, through
    ``_pack1_bwd_kv_call``): δ = Σ_C dO∘O from the saved output, P = exp(S −
    lse) from the saved lse. A bf16 CUDA call runs the tensor-core entry
    ``vdiff_attn_bwd_tc_kv`` of ``attn_bwd_tc.cu`` (16-byte alignment
    checked): a row kernel that reads lse, takes δ from ``out`` and makes one
    sweep for dQ, then the column kernel of :func:`attn_bwd_tc` for dK/dV. An
    f32 call runs ``vdiff_attn_bwd_pack1_kv`` (``attn_bwd_pack1_kv.cu``): its
    own FMA dQ/δ kernel, then the column kernel of :func:`attn_bwd_cols`.
    Either way one launch is counted here, and the other wrappers' counts
    stay theirs."""
    B, T, C = _check_bwd_input(qkv, g, num_heads, "attn_bwd_pack1_kv")
    if C not in _SUBLANE_HEAD_DIMS:
        raise ValueError(f"attn_bwd_pack1_kv: head dim {C} not supported {_SUBLANE_HEAD_DIMS}")
    if (out.shape != g.shape or out.dtype != qkv.dtype or lse.shape != (B, num_heads, T)
            or lse.dtype != torch.float32 or not (out.is_contiguous() and lse.is_contiguous())):
        raise ValueError(f"attn_bwd_pack1_kv: out must be {tuple(g.shape)} {qkv.dtype} and lse "
                         f"{(B, num_heads, T)} float32, both contiguous; got "
                         f"{tuple(out.shape)} {out.dtype}, {tuple(lse.shape)} {lse.dtype}")
    if qkv.device.type == "cpu":
        return attention_qkv_bwd_kv_reference(qkv, out, lse, g, num_heads)
    _need_cuda("attn_bwd_pack1_kv", qkv, out, lse, g)
    dqkv = torch.empty_like(qkv)
    delta = torch.empty_like(lse)
    ptrs = (qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), g.data_ptr(), dqkv.data_ptr(),
            delta.data_ptr())
    if qkv.dtype == torch.bfloat16:
        _check_tc("attn_bwd_pack1_kv", qkv, out, lse, g)
        err = kernels.library().vdiff_attn_bwd_tc_kv(
            *ptrs, B, T, num_heads, C, torch.cuda.current_stream(qkv.device).cuda_stream)
        kernels.check(err, "vdiff_attn_bwd_tc_kv")
    else:
        err = kernels.library().vdiff_attn_bwd_pack1_kv(*ptrs, *_bwd_args(qkv, num_heads, B, T, C))
        kernels.check(err, "vdiff_attn_bwd_pack1_kv")
    attn_bwd_pack1_kv.launches += 1
    return dqkv


attn_bwd_pack1_kv.launches = 0


class Pack1AttentionKV(torch.autograd.Function):
    """Differentiable head-dim 32/64 attention for long rows: the counterpart
    of JAX's ``pack1_attention_trainable_kv`` custom VJP. Forward
    :func:`attn_fwd_pack1_lse` (B7), saving (qkv, out, lse); backward
    :func:`attn_bwd_pack1_kv` (B9), d(qkv) as one buffer."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
        out, lse = attn_fwd_pack1_lse(qkv, num_heads)
        ctx.save_for_backward(qkv, out, lse)
        ctx.num_heads = num_heads
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        qkv, out, lse = ctx.saved_tensors
        return attn_bwd_pack1_kv(qkv, out, lse, g.contiguous(), ctx.num_heads), None


# JAX's VMEM q-block pickers (vdiff_tpu/ops/attention.py), copied as they are.
# On the TPU they size blocks; here they only decide which of JAX's kernels a
# call corresponds to, so that the port routes every shape as JAX does. They
# do not shape the Hopper kernels.
_PACK1_BWD_MIN_BQ = 128


def _pick_qblk_fwd(T: int, C: int) -> int:
    for bq in (512, 256, 128):
        if T % bq == 0 and bq * T * 4 + 4 * T * C * 4 <= 12 * 1024 * 1024:
            return bq
    return 0


def _pick_qblk_pack1(T: int, C: int) -> int:
    for bq in (512, 256, 128):
        vmem = bq * T * 4 + 2 * T * C * 4 + 2 * T * 128 * 2 + 2 * bq * 128 * 4
        if T % bq == 0 and vmem <= 13 * 1024 * 1024:
            return bq
    return 0


def _pick_qblk_pack1_bwd(T: int, C: int) -> int:
    for bq in (256, 128, 64, 32):
        vmem = (3 * bq * T * 4 + 2 * T * 128 * 4 + 2 * T * 128 * 4
                + 2 * T * 128 * 2 + 3 * bq * 128 * 4)
        if T % bq == 0 and vmem <= 14 * 1024 * 1024:
            return bq
    return 0


def _pick_qblk_pack1_kv(T: int, C: int) -> int:
    for bq in (256, 128):
        for bkv in (1024, 512):
            if T % bq or T % bkv or bkv >= T:
                continue
            vmem = (3 * bq * bkv * 4 + 2 * bkv * 128 * 4 + 2 * T * 128 * 4
                    + 2 * T * 128 * 2 + 6 * bq * 128 * 4)
            if vmem <= 13 * 1024 * 1024:
                return bq
    return 0


def route(T: int, num_heads: int, C: int, train: bool) -> str:
    """The kernel family JAX's ``spatial_attention_qkv`` takes for a call at
    (T, N, C) on a TPU without head padding, by the same gates:

    * ``"pack1"``: head dim 32/64, T % 128 == 0, N·C % 128 == 0 — B6
      (:func:`attn_fwd_pack1`); training B6 + B8 (:class:`QkvAttention`)
      when the full-row backward's q-block reaches ``_PACK1_BWD_MIN_BQ``;
    * ``"pack1_kv"``: training of such a shape whose full-row backward block
      is too small (T=4096) — B7 + B9 (:class:`Pack1AttentionKV`);
    * ``"qblk"``: inference, B2 (:func:`attn_fwd_qblk`): head dim 32/64 with
      N·C unaligned and T % 128 == 0 (JAX's folded native-width path), or
      T > 512 at other head dims;
    * ``"online"``: inference otherwise, B1 (:func:`attn_fwd_online`; T=64,
      where JAX runs XLA, too);
    * ``"train"``: training otherwise, :class:`QkvAttention` (B3/B2
      forward, B4/B5 backward)."""
    sublane = C in _SUBLANE_HEAD_DIMS and T % 128 == 0
    if sublane and (num_heads * C) % 128 == 0 and _pick_qblk_pack1(T, C):
        if not train or _pick_qblk_pack1_bwd(T, C) >= _PACK1_BWD_MIN_BQ:
            return "pack1"
        if _pick_qblk_pack1_kv(T, C):
            return "pack1_kv"
    if train:
        return "train"
    if sublane:
        return "qblk" if _pick_qblk_fwd(T, C) else "online"
    return "online" if T <= QBLK_THRESHOLD else "qblk"


_INFERENCE = {"pack1": attn_fwd_pack1, "qblk": attn_fwd_qblk, "online": attn_fwd_online}
#: (forward, backward) of each route whose VJP saves qkv alone
_TRAINABLE = {"pack1": (attn_fwd_pack1, attn_bwd_pack1), "train": (attn_fwd_trainable, attn_bwd)}


def spatial_attention_qkv(qkv: torch.Tensor, num_heads: int, train: bool = False) -> torch.Tensor:
    """(B, T, 3·N·C) → (B, T, N·C) through the kernel :func:`route` picks.
    With ``train`` the call is differentiable through one of the
    ``torch.autograd.Function`` classes, as JAX's ``train=True`` goes through its
    custom VJPs."""
    B, T, C = _shape(qkv, num_heads)
    kind = route(T, num_heads, C, train)
    if not train:
        return _INFERENCE[kind](qkv, num_heads)
    if kind == "pack1_kv":
        return Pack1AttentionKV.apply(qkv, num_heads)
    return QkvAttention.apply(qkv, num_heads, *_TRAINABLE[kind])
