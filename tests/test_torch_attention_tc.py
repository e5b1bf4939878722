"""The bf16 tensor-core attention kernels of the port (``attn_fwd_tc.cu`` for
B2, ``attn_bwd_tc.cu`` for B5) on the CPU, where no CUDA kernel runs.

Each kernel's tile algorithm is written out in torch at the kernel's tile
sizes (``tests/torch_parity.py``, shared with tests/test_torch_pack1_tc.py)
and held, on bf16 inputs made from a numpy seed, against JAX's
Pallas ``_attn_fwd_kernel_qblk`` (B2) and ``_attn_bwd_kernel_qblk`` (B5) in
interpret mode, within the limits chip_smoke.py holds the kernels to on the
card: the public JAX functions at T=1024 (``flash_attention_qkv`` and the VJP
of ``flash_attention_trainable``, as tests/test_torch_attention_train.py runs
them), and the kernels' own bodies in a one-block ``pallas_call`` at ragged T
(a multiple of 32 and not of 64). The emulations follow the kernels' f32
arithmetic step by step (online softmax in the log2 domain, the scale on f32
S, P and dS rounded to bf16 as operands); only the order of each product's f32
sums differs. Then the wrappers: the CPU calls return the twins and count no
launch, bf16 CUDA calls dispatch to the new kernels (meta tensors into a stub
library), the refusals, and the build registration.
"""

import functools
import math
import os
import re
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tests import torch_parity as P  # noqa: E402
from vdiff_tpu_torch import kernels  # noqa: E402
from vdiff_tpu_torch.ops import attention as A  # noqa: E402


def _fold(a, N):
    """(B, T, N·C) → (B·N, T, C), JAX's head folding."""
    B, T, NC = a.shape
    return a.reshape(B, T, N, NC // N).transpose(0, 2, 1, 3).reshape(B * N, T, NC // N)


def _unfold(a, B, N):
    BN, T, C = a.shape
    return a.reshape(B, N, T, C).transpose(0, 2, 1, 3).reshape(B, T, N * C)


def _jax_bf16(t):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("B,T,N,C", [(1, 1024, 1, 256), (1, 1024, 2, 128)])
def test_fwd_tiles_match_pallas_qblk_through_flash_attention_qkv(B, T, N, C):
    """T=1024 reaches _attn_fwd_kernel_qblk through flash_attention_qkv;
    C=256 runs 32-key tiles, C=128 64-key tiles."""
    from jax.experimental.pallas import tpu as pltpu

    from vdiff_tpu.ops.attention import flash_attention_qkv

    qkv, _ = P.bf16_inputs(B, T, N, C, seed=C)
    with pltpu.force_tpu_interpret_mode():
        ref = _np(flash_attention_qkv(_jax_bf16(qkv), N))
    got, _ = P.emulate_fwd_tc(qkv, N)
    assert got.dtype == torch.bfloat16 and got.shape == (B, T, N * C)
    P.check_fwd_tc(got, ref, qkv, N)


@pytest.mark.parametrize("B,T,N,C", [(2, 96, 2, 64), (1, 160, 3, 32), (1, 1056, 1, 256)])
def test_fwd_tiles_match_pallas_qblk_at_ragged_t(B, T, N, C):
    """T a multiple of 32 and not of 64: the last 64-key tile is half masked
    (C ≤ 128) and the last q tile half past T. The Pallas kernel runs in one
    q block of all T rows through JAX's own _qblk_fwd_call."""
    from vdiff_tpu.ops.attention import _qblk_fwd_call

    qkv, _ = P.bf16_inputs(B, T, N, C, seed=T)
    q, k, v = (_fold(a, N) for a in np.split(qkv.float().numpy(), 3, axis=-1))
    ref = _np(_qblk_fwd_call(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), T,
                             interpret=True))
    P.check_fwd_tc(P.emulate_fwd_tc(qkv, N)[0], _unfold(ref, B, N), qkv, N)


@pytest.mark.parametrize("B,T,N,C", [(1, 1024, 1, 32), (1, 1024, 1, 256)])
def test_bwd_tiles_match_pallas_qblk_through_flash_attention_trainable(B, T, N, C):
    """T=1024 reaches _attn_bwd_kernel_qblk through flash_attention_trainable's
    VJP in bf16 (two q blocks of 512, dK/dV carried in f32)."""
    from vdiff_tpu.ops.attention import flash_attention_trainable

    qkv, g = P.bf16_inputs(B, T, N, C, seed=T + C)
    q, k, v = (_fold(a, N) for a in np.split(qkv.float().numpy(), 3, axis=-1))
    _, vjp = jax.vjp(lambda q, k, v: flash_attention_trainable(q, k, v, True),
                     *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    dref = np.concatenate([_unfold(_np(d), B, N)
                           for d in vjp(jnp.asarray(_fold(g.float().numpy(), N), jnp.bfloat16))], -1)
    got = P.emulate_bwd_tc(qkv, g, N)
    assert got.dtype == torch.bfloat16 and got.shape == qkv.shape
    P.check_bwd_tc(got, dref)
    P.check_bwd_tc(got, A.attention_qkv_bwd_reference(qkv, g, N).float().numpy())


def _pallas_bwd_one_block(q, k, v, g):
    """JAX's _attn_bwd_kernel_qblk over one q block of all T rows, as
    _flash_trainable_bwd calls it (dK/dV accumulated in f32 outputs)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from vdiff_tpu.ops.attention import _attn_bwd_kernel_qblk

    BN, T, C = q.shape
    spec = pl.BlockSpec((1, T, C), lambda b, i: (b, i, 0), memory_space=pltpu.VMEM)
    dq, dk, dv = pl.pallas_call(
        functools.partial(_attn_bwd_kernel_qblk, scale=1.0 / math.sqrt(C)),
        grid=(BN, 1), in_specs=[spec] * 4, out_specs=[spec] * 3,
        out_shape=[jax.ShapeDtypeStruct((BN, T, C), q.dtype),
                   jax.ShapeDtypeStruct((BN, T, C), jnp.float32),
                   jax.ShapeDtypeStruct((BN, T, C), jnp.float32)],
        interpret=True,
    )(q, k, v, g)
    return dq, dk.astype(k.dtype), dv.astype(v.dtype)


@pytest.mark.parametrize("B,T,N,C", [(2, 96, 2, 64), (1, 160, 1, 128), (1, 96, 1, 256)])
def test_bwd_tiles_match_pallas_qblk_at_ragged_t(B, T, N, C):
    """Ragged T: half-masked key tiles in the row kernel, a q tile half past T
    in the column kernel (C = 64), and a key block half past T."""
    qkv, g = P.bf16_inputs(B, T, N, C, seed=T + C)
    q, k, v = (_fold(a, N) for a in np.split(qkv.float().numpy(), 3, axis=-1))
    d = _pallas_bwd_one_block(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                              jnp.asarray(_fold(g.float().numpy(), N), jnp.bfloat16))
    dref = np.concatenate([_unfold(_np(a), B, N) for a in d], -1)
    got = P.emulate_bwd_tc(qkv, g, N)
    P.check_bwd_tc(got, dref)
    P.check_bwd_tc(got, A.attention_qkv_bwd_reference(qkv, g, N).float().numpy())


def test_emulations_round_p_where_the_twins_do_not():
    """The forward's one departure is real and small: the emulation differs
    from the f32 twin (bf16 e) but by less than the limit's P·|v| term."""
    qkv, _ = P.bf16_inputs(1, 128, 1, 64, seed=9)
    got = P.emulate_fwd_tc(qkv, 1)[0].float()
    f32 = A.attention_qkv_reference(qkv.float(), 1)
    assert not torch.equal(got, f32.to(torch.bfloat16).float())
    P.check_fwd_tc(got.to(torch.bfloat16), f32.numpy(), qkv, 1)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

COUNTERS = ("attn_fwd_tc", "attn_bwd_tc", "attn_fwd_qblk", "attn_bwd_rows", "attn_bwd_cols",
            "attn_fwd_train", "attn_fwd_online", "attn_bwd")


def _counts():
    return {name: getattr(A, name).launches for name in COUNTERS}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_calls_return_the_twins_and_count_no_launch(dtype):
    qkv, g = (a.to(dtype) for a in P.bf16_inputs(1, 1024, 1, 32, seed=2))
    before = _counts()
    fwd, bwd = A.attention_qkv_reference(qkv, 1), A.attention_qkv_bwd_reference(qkv, g, 1)
    calls = [(A.attn_fwd_qblk(qkv, 1), fwd), (A.attn_bwd(qkv, g, 1), bwd)]
    if dtype == torch.bfloat16:
        calls += [(A.attn_fwd_tc(qkv, 1), fwd), (A.attn_bwd_tc(qkv, g, 1), bwd)]
    x = qkv.clone().requires_grad_()
    out = A.spatial_attention_qkv(x, 1, train=True)
    out.backward(g)
    calls += [(out.detach(), fwd), (x.grad, bwd)]
    for got, ref in calls:
        assert got.dtype == dtype
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert _counts() == before


@pytest.fixture
def stub_kernels(monkeypatch):
    """Meta tensors take the wrappers' launch path into the stub library;
    returns a function that reads the counts and sets them to 0."""
    monkeypatch.setattr(kernels, "library", P.StubLibrary)
    monkeypatch.setattr(A, "_need_cuda", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    for name in COUNTERS:
        monkeypatch.setattr(getattr(A, name), "launches", 0)

    def read():
        counts = _counts()
        for name in COUNTERS:
            getattr(A, name).launches = 0
        return {k: v for k, v in counts.items() if v}

    return read


@pytest.mark.parametrize("T", [256, 1024])
def test_cuda_dispatch_on_dtype(stub_kernels, T):
    """B2 (attn_fwd_qblk) and B5 (attn_bwd at T > 512) send bf16 calls to the
    bf16 tensor-core kernels and f32 calls to the 3xTF32 ones; so does B4
    (attn_bwd at T ≤ 512), its bf16 calls counted under attn_bwd, its f32
    calls under the 3xTF32 pair's two wrappers (attn_bwd_rows,
    attn_bwd_cols)."""
    for dtype in (torch.float32, torch.bfloat16):
        qkv = torch.empty(2, T, 3 * 2 * 64, dtype=dtype, device="meta")
        g = torch.empty(2, T, 2 * 64, dtype=dtype, device="meta")
        assert A.attn_fwd_qblk(qkv, 2).shape == (2, T, 128)
        assert stub_kernels() == ({"attn_fwd_tc": 1} if dtype == torch.bfloat16 else
                                  {"attn_fwd_qblk": 1})
        assert A.attn_bwd(qkv, g, 2).shape == qkv.shape
        bf16 = dtype == torch.bfloat16
        assert stub_kernels() == ({"attn_bwd_tc": 1} if bf16 and T > A.QBLK_THRESHOLD else
                                  {"attn_bwd": 1} if bf16 else
                                  {"attn_bwd_rows": 1, "attn_bwd_cols": 1})


def _full_width(name, dtype):
    from vdiff_tpu_torch.factory import CONFIG_DIR, build_unet, load_experiment_config

    cfg, _ = load_experiment_config(f"{CONFIG_DIR}/{name}.json")
    celeba = name == "celeba"
    with torch.device("meta"):
        return build_unet(dict(cfg["model"], drop_rate=0.0), in_channels=3,
                          model_out_type=cfg["diffusion"]["model_out_type"],
                          num_classes=40 if celeba else 10, multitags=celeba, dtype=dtype)


# one forward, then one training forward and backward, of each full-width
# model in bf16: the counts chip_smoke.py asserts on the card's bf16 paths
BF16_COUNTS = {
    "cifar10_cond": ({"attn_fwd_online": 17, "attn_fwd_tc": 1},
                     {"attn_fwd_train": 17, "attn_fwd_tc": 1, "attn_bwd": 17, "attn_bwd_tc": 1}),
    "celeba": ({"attn_fwd_online": 9, "attn_fwd_tc": 8},
               {"attn_fwd_train": 16, "attn_fwd_tc": 1, "attn_bwd": 16, "attn_bwd_tc": 1}),
}


@pytest.mark.parametrize("name", sorted(BF16_COUNTS))
def test_bf16_paths_launch_the_tensor_core_kernels(stub_kernels, name):
    """cifar10_cond: B2 ×1 per forward, B2 ×1, B5 ×1 and B4 ×17 per train
    step; celeba: B2 ×8 per forward, B2 ×1, B5 ×1 and B4 ×16 per train step
    (its pack1 calls, counted elsewhere, do not move); the FMA pair never
    runs."""
    celeba = name == "celeba"
    model = _full_width(name, torch.bfloat16)
    res = 64 if celeba else 32
    x, t = torch.empty(2, res, res, 3, device="meta"), torch.empty(2, device="meta")
    y = torch.empty(2, 40, device="meta") if celeba else torch.empty(2, device="meta")
    fwd, step = BF16_COUNTS[name]
    with torch.no_grad():
        model(x, t, y)
    assert stub_kernels() == fwd
    model(x, t, y, train=True).float().sum().backward()
    assert stub_kernels() == step


@pytest.mark.parametrize("bad", ["float32", "float16", "head_dim", "tokens", "layout", "device",
                                 "misaligned", "grad"])
def test_tc_wrappers_refuse_what_the_kernels_do_not_take(bad):
    qkv = torch.zeros(1, 64, 3 * 64, dtype=torch.bfloat16)
    g = torch.zeros(1, 64, 64, dtype=torch.bfloat16)
    err = ValueError
    if bad in ("float32", "float16"):
        qkv, g, err = qkv.to(getattr(torch, bad)), g.to(getattr(torch, bad)), TypeError
    elif bad == "head_dim":
        qkv, g = torch.zeros(1, 64, 3 * 48).bfloat16(), torch.zeros(1, 64, 48).bfloat16()
    elif bad == "tokens":
        qkv, g = qkv[:, :48], g[:, :48]
    elif bad == "layout":
        qkv = torch.zeros(1, 64, 2 * 3 * 64, dtype=torch.bfloat16)[..., ::2]
    elif bad == "device":
        qkv, g, err = qkv.to("meta"), g.to("meta"), RuntimeError
    elif bad == "misaligned":  # contiguous, but 2 bytes past a 16-byte boundary
        qkv = torch.zeros(1 + 64 * 3 * 64, dtype=torch.bfloat16)[1:].view(1, 64, 3 * 64)
        g = torch.zeros(1 + 64 * 64, dtype=torch.bfloat16)[1:].view(1, 64, 64)
    else:
        g = torch.zeros(1, 64, 2 * 64, dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(err):
        if bad != "grad":
            A.attn_fwd_tc(qkv, 1)
        A.attn_bwd_tc(qkv, g, 1)


def test_new_sources_and_entry_points_are_built():
    """kernels.py compiles the two sources (and hashes their header) and binds
    both entry points; the sources use the tensor cores and asynchronous
    copies, and the tile sizes the emulations above assume."""
    assert {"attn_fwd_tc.cu", "attn_bwd_tc.cu"} <= set(kernels.SOURCES)
    assert "attn_tc.cuh" in kernels.HEADERS
    for name in kernels.SOURCES + kernels.HEADERS:
        assert os.path.isfile(os.path.join(kernels.CSRC_DIR, name)), name
    # qkv, out, B, T, N, C, q rows per block, stream
    assert len(kernels._ENTRY_POINTS["vdiff_attn_fwd_tc"]) == 8
    assert len(kernels._ENTRY_POINTS["vdiff_attn_bwd_tc"]) == 10
    src = {n: open(os.path.join(kernels.CSRC_DIR, n)).read()
           for n in ("attn_tc.cuh", "attn_fwd_tc.cu", "attn_bwd_tc.cu")}
    for token in ("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32", "ldmatrix", "cp.async"):
        assert token in src["attn_tc.cuh"]
    for n in ("attn_fwd_tc.cu", "attn_bwd_tc.cu"):
        assert re.search(r'extern "C" int vdiff_attn_(fwd|bwd)_tc\(', src[n])
        assert not re.search(r"cublas|cudnn|scaled_dot_product", src[n], re.I)
    assert "kBk = C == 256 ? 32 : 64" in src["attn_fwd_tc.cu"]
    assert "kBk = C == 256 ? 32 : 64" in src["attn_bwd_tc.cu"]
    assert "kBq = C >= 128 ? 32 : 64" in src["attn_bwd_tc.cu"]
