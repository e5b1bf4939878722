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
* :func:`attn_fwd_online` (B1), :func:`attn_fwd_qblk` (B2) and
  :func:`attn_fwd_train` (B3) wrap the forward tensor-core kernels: bf16
  calls ``csrc/attn_fwd_tc.cu`` (mma.sync on bf16 operands), f32 calls
  ``csrc/attn_fwd_tf32.cu`` (3xTF32: each f32 operand split into two TF32
  parts, three products, f32 accumulators), by an explicit dispatch on
  dtype. :func:`attn_bwd_rows` and :func:`attn_bwd_cols` wrap the row and
  column kernels of the f32 backward on the tensor cores
  (``csrc/attn_bwd_tf32.cu``, 3xTF32), which :func:`attn_bwd` runs in turn
  for f32 calls.
* :func:`attn_fwd_tc` and :func:`attn_bwd_tc` wrap the bf16 tensor-core
  kernels (``csrc/attn_fwd_tc.cu``, ``csrc/attn_bwd_tc.cu``). The bf16 calls
  of B4 (:func:`attn_bwd` at T ≤ 512) and B5 (:func:`attn_bwd` at T > 512)
  go to the backward one by an explicit dispatch on dtype; f32 calls take
  the 3xTF32 pair. B1, B3 and B4 count under their own wrappers, B2's bf16
  calls and B5's under these two, B2's f32 calls under
  :func:`attn_fwd_qblk`, B4's and B5's under the pair's two wrappers.
* :func:`attn_fwd_pack1`, :func:`attn_fwd_pack1_lse`, :func:`attn_bwd_pack1`
  and :func:`attn_bwd_pack1_kv` are the counterparts of JAX's head-dim 32/64
  ``pack1`` kernels B6–B9, each with a launch counter of its own. They
  dispatch on dtype: bf16 calls run the tensor-core kernels (B6
  ``csrc/attn_fwd_tc.cu``, B7 its lse entry, B8 ``csrc/attn_bwd_tc.cu``, B9
  that file's saved-statistics entry); f32 calls of B6 and B7 run
  ``csrc/attn_fwd_tf32.cu`` and its lse entry, those of B8 the row and
  column kernels of ``csrc/attn_bwd_tf32.cu`` and those of B9 that file's
  saved-statistics entry (a row kernel that reads lse and takes δ from the
  saved output, then the same column kernel).
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


def attn_fwd_online(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Attention forward at T ≤ 512 for inference, counted here and not in
    :func:`attn_fwd_tc`.

    Replaces JAX's Pallas ``_flash_kernel`` (B1; ops/attention.py, used by
    ``flash_attention_qkv`` at T ≤ 512; JAX runs ``_xla_attention`` at T=64,
    which this also takes). A CUDA call runs the forward tensor-core kernel
    of its dtype (:func:`_fwd_tc`): in bf16 ``attn_fwd_tc.cu``, which
    rounds e to bf16 as the operand of e·v where JAX's B1 takes e·v in f32;
    in f32 ``attn_fwd_tf32.cu``, f32-accurate products (3xTF32). Its CPU
    twin is :func:`attention_qkv_reference`."""
    B, T, C = _check_kernel_input(qkv, num_heads, "attn_fwd_online")
    if qkv.device.type == "cpu":
        return attention_qkv_reference(qkv, num_heads)
    out = _fwd_tc("attn_fwd_online", qkv, num_heads, B, T, C)
    attn_fwd_online.launches += 1
    return out


attn_fwd_online.launches = 0


def attn_fwd_qblk(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Attention forward at T > 512: the counterpart of JAX's Pallas
    ``_attn_fwd_kernel_qblk`` (B2; ops/attention.py, used by
    ``flash_attention_qkv`` at T > 512), whose direct softmax over the whole
    score row the tensor-core kernels take online, over key tiles, with the
    output divided once (roundings only).

    A bf16 CUDA tensor goes to :func:`attn_fwd_tc` (``attn_fwd_tc.cu``,
    counted there). An f32 one launches ``attn_fwd_tf32.cu`` (3xTF32,
    :func:`_fwd_tc`), counted here; any T that is a multiple of 32 runs."""
    B, T, C = _check_kernel_input(qkv, num_heads, "attn_fwd_qblk")
    if qkv.device.type == "cpu":
        return attention_qkv_reference(qkv, num_heads)
    if qkv.dtype == torch.bfloat16:
        return attn_fwd_tc(qkv, num_heads)
    out = _fwd_tc("attn_fwd_qblk", qkv, num_heads, B, T, C)
    attn_fwd_qblk.launches += 1
    return out


attn_fwd_qblk.launches = 0


def _check_aligned(name: str, *tensors: torch.Tensor):
    """The tensor-core kernels' tiles arrive by 16-byte ``cp.async`` copies:
    every tensor must start on a 16-byte boundary."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: every tensor must start on a 16-byte boundary")


def _check_tc(name: str, qkv: torch.Tensor, *others: torch.Tensor):
    """The bf16 tensor-core wrappers' gates on top of the shape checks: bf16
    only, and every tensor 16-byte aligned."""
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"{name}: dtype {qkv.dtype} not supported (bfloat16)")
    _check_aligned(name, qkv, *others)


def attn_fwd_tc(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """bf16 attention forward on the tensor cores (CUDA kernel
    ``attn_fwd_tc.cu``): B2's bf16 calls.

    Replaces JAX's Pallas ``_attn_fwd_kernel_qblk`` (B2) for bf16: per q
    tile of 64 rows (32 on small grids, :func:`fwd_tc_q_rows`), mma.sync
    products over 64-key tiles (32 at C=256) that cp.async double-buffers,
    an online softmax in f32 registers and the output divided once, so any
    T that is a multiple of 32 runs. Scale on
    f32 S after the product; e is rounded to bf16 as the operand of e·v, the
    one departure from the Pallas kernel's f32 e·v (at most 2^-9·Σ p|v| per
    output). Its CPU twin is :func:`attention_qkv_reference`. The same kernel
    serves the bf16 calls of B1 (:func:`attn_fwd_online`), B3
    (:func:`attn_fwd_train`) and B6 (:func:`attn_fwd_pack1`), and with an lse
    output B7's (:func:`attn_fwd_pack1_lse`), each counted by its own
    wrapper."""
    B, T, C = _check_kernel_input(qkv, num_heads, "attn_fwd_tc")
    _check_tc("attn_fwd_tc", qkv)
    if qkv.device.type == "cpu":
        return attention_qkv_reference(qkv, num_heads)
    out = _fwd_tc("attn_fwd_tc", qkv, num_heads, B, T, C)
    attn_fwd_tc.launches += 1
    return out


attn_fwd_tc.launches = 0


#: SMs of the H100, for which :func:`fwd_tc_q_rows` sizes the forward's grid
_SMS = 132


def fwd_tc_q_rows(B: int, T: int, N: int) -> int:
    """q rows per block of the bf16 forward tensor-core kernel
    (``attn_fwd_tc.cu``) for a call at (B, T, N): 32 (two warps) when a grid
    of 64-row tiles, ceil(T/64)·N·B blocks, would leave some of the card's SMs
    without a block, else 64 (four warps). CIFAR's T=64 with one head is one
    64-row tile per (head, batch). The q tile moves no result (the key tile
    and every per-row step are the same); the source's header has the times
    behind the choice."""
    return 32 if -(-T // 64) * N * B < _SMS else 64


#: blocks of 128 q rows ``attn_fwd_tf32.cu``'s grid needs to take them: 97%
#: of the card's SMs (CIFAR's T=256 at B=64 gives 128)
_TF32_WIDE_BLOCKS = 128


def fwd_tf32_q_rows(B: int, T: int, N: int) -> int:
    """q rows per block of ``attn_fwd_tf32.cu`` for a call at (B, T, N): 128
    (eight warps) where T > 64 and the grid of 128-row tiles has at least
    _TF32_WIDE_BLOCKS blocks, else 64 (four warps). Measured at every f32
    path shape on an H100 (``scripts/probe_torch_tf32.py --time``), this
    picks the fastest of the 32/64/128-row tiles or one within 4% of it; the
    q tile moves no result."""
    return 128 if T > 64 and -(-T // 128) * N * B >= _TF32_WIDE_BLOCKS else 64


#: the forward tensor-core entry of each dtype
_FWD_TC_ENTRY = {torch.bfloat16: "vdiff_attn_fwd_tc", torch.float32: "vdiff_attn_fwd_tc_f32"}


def _fwd_tc(fn_name, qkv, num_heads, B, T, C, q_rows=None):
    """Launch the forward tensor-core kernel of qkv's dtype
    (``vdiff_attn_fwd_tc``, bf16, or ``vdiff_attn_fwd_tc_f32``, f32) on
    shape-checked CUDA input, refusing a qkv off a 16-byte boundary before
    the launch, with ``q_rows`` q rows per block (default
    :func:`fwd_tc_q_rows` in bf16, :func:`fwd_tf32_q_rows` in f32); the
    caller counts the launch (B1 under
    :func:`attn_fwd_online`, B2 under :func:`attn_fwd_tc` in bf16 and
    :func:`attn_fwd_qblk` in f32, B3 under :func:`attn_fwd_train`, B6 under
    :func:`attn_fwd_pack1`)."""
    _need_cuda(fn_name, qkv)
    _check_aligned(fn_name, qkv)
    entry = _FWD_TC_ENTRY[qkv.dtype]
    rows = fwd_tc_q_rows if qkv.dtype == torch.bfloat16 else fwd_tf32_q_rows
    out = torch.empty(B, T, num_heads * C, dtype=qkv.dtype, device=qkv.device)
    err = getattr(kernels.library(), entry)(
        qkv.data_ptr(), out.data_ptr(), B, T, num_heads, C,
        q_rows or rows(B, T, num_heads),
        torch.cuda.current_stream(qkv.device).cuda_stream)
    kernels.check(err, entry)
    return out


def attn_fwd_train(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Training attention forward at T ≤ 512, counted here and not in
    :func:`attn_fwd_tc`.

    Replaces JAX's Pallas ``_attn_fwd_kernel`` (B3; ops/attention.py, used by
    ``flash_attention_trainable`` at T ≤ 512), which holds a whole (T, T)
    tile, normalises P before P·v when C ≥ T and divides the output
    otherwise. A CUDA call runs the forward tensor-core kernel of its dtype
    (:func:`_fwd_tc`): an online softmax with the output divided once in
    either case, which moves roundings only; in bf16 (``attn_fwd_tc.cu``) e
    is rounded to bf16 as the operand of e·v, in f32 (``attn_fwd_tf32.cu``)
    the products are 3xTF32. Its CPU twin is
    :func:`attention_qkv_reference`."""
    B, T, C = _check_kernel_input(qkv, num_heads, "attn_fwd_train")
    if qkv.device.type == "cpu":
        return attention_qkv_reference(qkv, num_heads)
    out = _fwd_tc("attn_fwd_train", qkv, num_heads, B, T, C)
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


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_f32(name: str, qkv: torch.Tensor, *others: torch.Tensor):
    """The f32 tensor-core backward's gates on top of the shape checks: f32
    only, and every tensor 16-byte aligned (its tiles arrive by cp.async)."""
    if qkv.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {qkv.dtype} not supported (float32)")
    _check_aligned(name, qkv, *others)


def _bwd_rows(qkv, g, num_heads, dqkv, B, T, C):
    """Launch ``vdiff_attn_bwd_tf32_rows`` on checked f32 CUDA inputs: dQ
    into ``dqkv``, the row statistics (lse, δ) returned."""
    lse = torch.empty(B, num_heads, T, dtype=torch.float32, device=qkv.device)
    delta = torch.empty_like(lse)
    err = kernels.library().vdiff_attn_bwd_tf32_rows(
        qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        B, T, num_heads, C, _stream(qkv))
    kernels.check(err, "vdiff_attn_bwd_tf32_rows")
    return lse, delta


def _bwd_cols(qkv, g, num_heads, lse, delta, dqkv, B, T, C):
    """Launch ``vdiff_attn_bwd_tf32_cols`` on checked f32 CUDA inputs: dK and
    dV into ``dqkv``."""
    err = kernels.library().vdiff_attn_bwd_tf32_cols(
        qkv.data_ptr(), g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dqkv.data_ptr(),
        B, T, num_heads, C, _stream(qkv))
    kernels.check(err, "vdiff_attn_bwd_tf32_cols")


def attn_bwd_rows(qkv: torch.Tensor, g: torch.Tensor, num_heads: int, dqkv: torch.Tensor):
    """Row kernel of the f32 backward on the tensor cores (entry
    ``vdiff_attn_bwd_tf32_rows`` of ``attn_bwd_tf32.cu``, 3xTF32): per 64-row
    q tile, a sweep over the key tiles for each row's max, sum and
    δ = rowsum(P∘dP), then a sweep for dS and dQ += dS·k; writes dQ into the
    q columns of ``dqkv`` and returns the f32 row statistics (lse, δ), each
    (B, N, T), that :func:`attn_bwd_cols` reads. Any T that is a multiple of
    32. f32 CUDA tensors, 16-byte aligned, only: the CPU path of the backward
    is :func:`attention_qkv_bwd_reference`."""
    B, T, C = _check_bwd_input(qkv, g, num_heads, "attn_bwd_rows")
    _need_cuda("attn_bwd_rows", qkv, g, dqkv)
    _check_f32("attn_bwd_rows", qkv, g, dqkv)
    lse, delta = _bwd_rows(qkv, g, num_heads, dqkv, B, T, C)
    attn_bwd_rows.launches += 1
    return lse, delta


attn_bwd_rows.launches = 0


def attn_bwd_cols(qkv: torch.Tensor, g: torch.Tensor, num_heads: int, lse: torch.Tensor,
                  delta: torch.Tensor, dqkv: torch.Tensor) -> None:
    """Column kernel of the f32 backward on the tensor cores (entry
    ``vdiff_attn_bwd_tf32_cols`` of ``attn_bwd_tf32.cu``): per 64-key tile,
    one sweep over the q tiles, dK and dV accumulated in f32 registers and
    written once into the k and v columns of ``dqkv``, from
    :func:`attn_bwd_rows`' statistics. f32 CUDA tensors, 16-byte aligned,
    only."""
    B, T, C = _check_bwd_input(qkv, g, num_heads, "attn_bwd_cols")
    _need_cuda("attn_bwd_cols", qkv, g, lse, delta, dqkv)
    _check_f32("attn_bwd_cols", qkv, g, lse, delta, dqkv)
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
    head dims 32-256. One count per call; B4's bf16 calls (:func:`attn_bwd`
    at T ≤ 512) and B8's (:func:`attn_bwd_pack1`) launch the same kernel
    under their own counts.
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
    counts the launch (B4 under :func:`attn_bwd`, B5 under
    :func:`attn_bwd_tc`, B8 under :func:`attn_bwd_pack1`)."""
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
    On a CPU tensor returns :func:`attention_qkv_bwd_reference`. A bf16 CUDA
    call runs the tensor-core backward (``attn_bwd_tc.cu``; 16-byte alignment
    checked, refused before any launch): at T > 512 through
    :func:`attn_bwd_tc`, counted there (B5); at T ≤ 512 counted here (B4).
    An f32 CUDA call runs the 3xTF32 row kernel (:func:`attn_bwd_rows`: dQ,
    lse, δ) and then the column kernel (:func:`attn_bwd_cols`: dK, dV) into
    one buffer, deterministically (no atomics), each counted under its own
    wrapper; at any T, as in bf16."""
    B, T, C = _check_bwd_input(qkv, g, num_heads, "attn_bwd")
    if qkv.device.type == "cpu":
        return attention_qkv_bwd_reference(qkv, g, num_heads)
    if qkv.dtype == torch.bfloat16:
        if T > QBLK_THRESHOLD:
            return attn_bwd_tc(qkv, g, num_heads)
        _check_tc("attn_bwd", qkv, g)
        dqkv = _bwd_tc("attn_bwd", qkv, g, num_heads, B, T, C)
        attn_bwd.launches += 1
        return dqkv
    dqkv = torch.empty_like(qkv)
    lse, delta = attn_bwd_rows(qkv, g, num_heads, dqkv)
    attn_bwd_cols(qkv, g, num_heads, lse, delta, dqkv)
    return dqkv


attn_bwd.launches = 0


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
    memory, and the kernels stream the softmax over key tiles. A CUDA call
    runs the forward tensor-core kernel of its dtype (:func:`_fwd_tc`): in
    bf16 ``attn_fwd_tc.cu``, which rounds e
    to bf16 as the operand of e·v where JAX's B6 takes e·v in f32; in f32
    ``attn_fwd_tf32.cu`` (3xTF32). Its CPU twin is
    :func:`attention_qkv_lse_reference`'s output: B6's f32 e·v, where
    :func:`attention_qkv_reference` rounds P to a bf16 input's dtype first."""
    B, T, C = _check_sublane(qkv, num_heads, "attn_fwd_pack1")
    if qkv.device.type == "cpu":
        return attention_qkv_lse_reference(qkv, num_heads)[0]
    out = _fwd_tc("attn_fwd_pack1", qkv, num_heads, B, T, C)
    attn_fwd_pack1.launches += 1
    return out


attn_fwd_pack1.launches = 0

#: the forward tensor-core lse entry of each dtype
_FWD_TC_LSE_ENTRY = {torch.bfloat16: "vdiff_attn_fwd_tc_lse",
                     torch.float32: "vdiff_attn_fwd_tc_f32_lse"}


def attn_fwd_pack1_lse(qkv: torch.Tensor, num_heads: int):
    """:func:`attn_fwd_pack1` that also returns each row's logsumexp of the
    scaled scores as f32 (B, N, T).

    Replaces JAX's Pallas ``_attn_fwd_kernel_pack1_lse`` (B7, through
    ``_pack1_fwd_lse_call``), the forward of the kv-chunked training path.
    A CUDA call runs the lse entry of the forward tensor-core kernel of its
    dtype (16-byte alignment checked): ``vdiff_attn_fwd_tc_lse`` of
    ``attn_fwd_tc.cu`` in bf16, which rounds e to bf16 as the operand of e·v
    as :func:`attn_fwd_tc` does; ``vdiff_attn_fwd_tc_f32_lse`` of
    ``attn_fwd_tf32.cu`` in f32. Counted here either way, not in
    :func:`attn_fwd_tc`."""
    B, T, C = _check_sublane(qkv, num_heads, "attn_fwd_pack1_lse")
    if qkv.device.type == "cpu":
        return attention_qkv_lse_reference(qkv, num_heads)
    _need_cuda("attn_fwd_pack1_lse", qkv)
    _check_aligned("attn_fwd_pack1_lse", qkv)
    entry = _FWD_TC_LSE_ENTRY[qkv.dtype]
    out = torch.empty(B, T, num_heads * C, dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty(B, num_heads, T, dtype=torch.float32, device=qkv.device)
    err = getattr(kernels.library(), entry)(
        qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), B, T, num_heads, C,
        torch.cuda.current_stream(qkv.device).cuda_stream)
    kernels.check(err, entry)
    attn_fwd_pack1_lse.launches += 1
    return out, lse


attn_fwd_pack1_lse.launches = 0


def attn_bwd_pack1(qkv: torch.Tensor, g: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Full-row attention backward for head dims 32/64: d(qkv) (B, T, 3·N·C).

    Replaces JAX's Pallas ``_attn_bwd_kernel_pack1`` (B8, through
    ``_pack1_bwd_call``), which computes B4's function. A bf16 CUDA call runs
    the tensor-core backward of :func:`attn_bwd_tc` (``attn_bwd_tc.cu``); an
    f32 one the 3xTF32 row and column kernels of :func:`attn_bwd_rows` /
    :func:`attn_bwd_cols` (``attn_bwd_tf32.cu``). Any T, 16-byte alignment
    checked in both. Either way one launch is counted here, and the other
    wrappers' counts stay B4's and B5's."""
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
        _check_f32("attn_bwd_pack1", qkv, g)
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
    f32 call runs ``vdiff_attn_bwd_tf32_kv`` of ``attn_bwd_tf32.cu``, the
    same two kernels in 3xTF32 (the column kernel :func:`attn_bwd_cols`'),
    16-byte alignment checked. Either way one launch is counted here, and
    the other wrappers' counts stay theirs."""
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
    bf16 = qkv.dtype == torch.bfloat16
    (_check_tc if bf16 else _check_f32)("attn_bwd_pack1_kv", qkv, out, lse, g)
    entry = "vdiff_attn_bwd_tc_kv" if bf16 else "vdiff_attn_bwd_tf32_kv"
    err = getattr(kernels.library(), entry)(*ptrs, B, T, num_heads, C, _stream(qkv))
    kernels.check(err, entry)
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
