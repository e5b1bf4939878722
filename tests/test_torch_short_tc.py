"""B1 and B3 of the port on the tensor cores, on the CPU, where no CUDA kernel
runs.

bf16 CUDA calls of ``attn_fwd_online`` (B1, the samplers' attention at
T ≤ 512) and ``attn_fwd_train`` (B3, the train steps' forward at T ≤ 512) run
``attn_fwd_tc.cu``, B2's kernel, at a q tile of 64 or 32 rows
(``fwd_tc_q_rows``); f32 calls run ``attn_fwd_tf32.cu`` at the same q tile
(tests/test_torch_attention_tf32.py holds its algorithm). The kernel's tile algorithm, emulated in torch
(``tests/torch_parity.py::emulate_fwd_tc``; the q tile moves no result, the
key tile is the kernel's), is held on bf16 inputs made from a numpy seed
against what JAX runs at the same shapes, within the limit chip_smoke.py
holds the kernel to on the card, 2^-8·|ref| + 2^-8·(P·|v|) + 1e-4 per element
(the kernel rounds e to bf16 as the operand of e·v, which moves an output by
at most 2^-9·Σ p|v|, where JAX takes e·v in f32):

* B1: Pallas ``_flash_kernel`` through ``flash_attention_qkv`` in interpret
  mode at T=256, and at T=64 JAX's own ``_xla_attention``, which JAX runs
  there;
* B3: Pallas ``_attn_fwd_kernel`` through ``flash_attention_trainable``'s
  forward in interpret mode, in both of its branches (P normalised before
  P·v when C ≥ T, the output divided when C < T), which the kernel's one
  divide of the output covers.

Then the q-tile choice, the wrappers' dispatch on dtype into a recording stub
library (meta tensors), their refusals, the entries whole bf16 paths reach,
and the build registration.
"""

import collections
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


def _jax_bf16(t):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _fold(a, N):
    """jax (B, T, N·C) → (B·N, T, C), flash_attention_trainable's layout."""
    B, T, NC = a.shape
    return a.reshape(B, T, N, NC // N).transpose(0, 2, 1, 3).reshape(B * N, T, NC // N)


def _unfold(a, B, N):
    BN, T, C = a.shape
    return a.reshape(B, N, T, C).transpose(0, 2, 1, 3).reshape(B, T, N * C)


@pytest.mark.parametrize("B,T,N,C", [(1, 256, 1, 128), (1, 256, 2, 128), (1, 256, 1, 256),
                                     (1, 256, 2, 256)])
def test_b1_tc_forward_matches_pallas_flash_kernel(B, T, N, C):
    """T=256 reaches _flash_kernel through flash_attention_qkv (one 256-row
    q block, one 256-key block); the kernel runs 64-key tiles at C=128 and
    32-key tiles at C=256."""
    from jax.experimental.pallas import tpu as pltpu

    from vdiff_tpu.ops.attention import flash_attention_qkv

    qkv, _ = P.bf16_inputs(B, T, N, C, seed=C + N)
    with pltpu.force_tpu_interpret_mode():
        ref = _np(flash_attention_qkv(_jax_bf16(qkv), N))
    out, _ = P.emulate_fwd_tc(qkv, N)
    assert out.dtype == torch.bfloat16 and out.shape == (B, T, N * C)
    P.check_fwd_tc(out, ref, qkv, N)


@pytest.mark.parametrize("B,T,N,C", [(2, 64, 1, 256), (1, 64, 12, 64)])
def test_b1_tc_forward_matches_xla_attention_at_t64(B, T, N, C):
    """At T=64 JAX runs _xla_attention (P rounded to bf16 before P·v), which
    B1's wrapper takes too: CIFAR's one head of 256, celeba's twelve of 64."""
    from vdiff_tpu.ops.attention import _xla_attention

    qkv, _ = P.bf16_inputs(B, T, N, C, seed=T + N)
    q, k, v = (a.reshape(B, T, N, C) for a in jnp.split(_jax_bf16(qkv), 3, axis=-1))
    ref = _np(_xla_attention(q, k, v))
    out, _ = P.emulate_fwd_tc(qkv, N)
    P.check_fwd_tc(out, ref, qkv, N)
    # and the CPU twin the wrapper returns, the same function as JAX's
    P.check_fwd_tc(out, A.attn_fwd_online(qkv, N).float().numpy(), qkv, N)


@pytest.mark.parametrize("B,T,N,C", [
    (2, 64, 1, 64),    # C >= T: _attn_fwd_kernel normalises P before P·v
    (1, 64, 12, 64),   # the same at celeba's twelve heads of the 8x8 level
    (1, 256, 2, 32),   # C < T: it divides the (T, C) output by the row sums
])
def test_b3_tc_forward_matches_pallas_attn_fwd_kernel(B, T, N, C):
    """flash_attention_trainable's forward at T ≤ 512 is _attn_fwd_kernel;
    the tensor-core kernel divides the output once in both of its branches."""
    from vdiff_tpu.ops.attention import flash_attention_trainable

    qkv, _ = P.bf16_inputs(B, T, N, C, seed=3 * T + N)
    q, k, v = (_fold(a, N) for a in jnp.split(_jax_bf16(qkv), 3, axis=-1))
    ref = _unfold(_np(flash_attention_trainable(q, k, v, True)), B, N)
    out, _ = P.emulate_fwd_tc(qkv, N)
    assert out.dtype == torch.bfloat16 and out.shape == (B, T, N * C)
    P.check_fwd_tc(out, ref, qkv, N)
    P.check_fwd_tc(out, A.attn_fwd_train(qkv, N).float().numpy(), qkv, N)


# (B, T, N) → q rows: every shape the CIFAR and celeba paths give attn_fwd_tc.cu
# (B1, B3 and B2/B6/B7), at the paths' batches
Q_ROWS = {
    (64, 256, 1): 64, (64, 64, 1): 32,                       # B1, CIFAR sampling
    (32, 64, 12): 64, (32, 64, 9): 64,                       # B1, celeba sampling
    (128, 256, 1): 64, (128, 64, 1): 32,                     # B3, CIFAR train
    (48, 256, 9): 64, (48, 64, 12): 64, (48, 64, 9): 64,     # B3, celeba train
    (64, 1024, 1): 64, (128, 1024, 1): 64, (32, 256, 9): 64,  # B2
    (32, 1024, 9): 64, (48, 1024, 9): 64,
    (32, 4096, 6): 64, (48, 1024, 6): 64, (48, 256, 6): 64,  # B6
    (48, 256, 12): 64, (32, 256, 12): 64,
}


@pytest.mark.parametrize("shape,rows", sorted(Q_ROWS.items()))
def test_q_tile_at_the_path_shapes(shape, rows):
    """32-row tiles only where 64-row ones leave SMs idle (fewer than 132
    blocks): CIFAR's T=64, one head, at B=64 and 128."""
    assert A.fwd_tc_q_rows(*shape) == rows


COUNTERS = ("attn_fwd_online", "attn_fwd_qblk", "attn_fwd_train", "attn_bwd_rows",
            "attn_bwd_cols", "attn_fwd_tc", "attn_bwd_tc", "attn_fwd_pack1", "attn_fwd_pack1_lse",
            "attn_bwd_pack1", "attn_bwd_pack1_kv", "attn_bwd")


@pytest.fixture
def recorded(monkeypatch):
    """Meta tensors take the wrappers' launch path into a recording stub
    library; returns a function that reads (calls with their arguments,
    nonzero launch counts) and clears both."""
    lib = P.RecordingStubLibrary()
    monkeypatch.setattr(kernels, "library", lambda: lib)
    monkeypatch.setattr(A, "_need_cuda", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    for name in COUNTERS:
        monkeypatch.setattr(getattr(A, name), "launches", 0)

    def read():
        calls = list(lib.launched)
        counts = {name: getattr(A, name).launches for name in COUNTERS if getattr(A, name).launches}
        lib.launched.clear()
        for name in COUNTERS:
            getattr(A, name).launches = 0
        return calls, counts

    return read


@pytest.mark.parametrize("B,T,N,C", [(64, 64, 1, 256), (64, 256, 1, 256), (48, 64, 12, 64)])
def test_dispatch_on_dtype(recorded, B, T, N, C):
    """bf16 calls of B1 and B3 launch vdiff_attn_fwd_tc with the q tile
    fwd_tc_q_rows picks, f32 calls vdiff_attn_fwd_tc_f32 (3xTF32) with
    fwd_tf32_q_rows's; each counts under its own wrapper only, never
    attn_fwd_tc."""
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        entry = "vdiff_attn_fwd_tc" if bf16 else "vdiff_attn_fwd_tc_f32"
        rows = (A.fwd_tc_q_rows if bf16 else A.fwd_tf32_q_rows)(B, T, N)
        qkv = torch.empty(B, T, 3 * N * C, dtype=dtype, device="meta")
        want = [(entry, (0, 0, B, T, N, C, rows, 0))]
        out = A.attn_fwd_online(qkv, N)
        assert (out.shape, out.dtype) == ((B, T, N * C), dtype)
        assert recorded() == (want, {"attn_fwd_online": 1})
        out = A.attn_fwd_train(qkv, N)
        assert (out.shape, out.dtype) == ((B, T, N * C), dtype)
        assert recorded() == (want, {"attn_fwd_train": 1})


@pytest.mark.parametrize("wrapper", ["attn_fwd_online", "attn_fwd_train"])
def test_bf16_calls_refuse_unaligned_tensors(recorded, wrapper):
    """A contiguous bf16 qkv 2 bytes past a 16-byte boundary: the tensor-core
    kernel's cp.async tiles cannot read it, so the call is refused before any
    launch. The same call on an aligned qkv launches."""
    N, C, T = 1, 256, 64

    def call(offset):
        qkv = torch.empty(offset + T * 3 * N * C, dtype=torch.bfloat16, device="meta")
        return getattr(A, wrapper)(qkv[offset:].view(1, T, 3 * N * C), N)

    with pytest.raises(ValueError, match="16-byte"):
        call(1)
    assert recorded() == ([], {})
    call(8)  # 16 bytes in: aligned
    assert recorded()[1] == {wrapper: 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_calls_return_the_twin_and_count_no_launch(dtype):
    qkv, _ = P.bf16_inputs(2, 64, 2, 64, seed=5)
    qkv = qkv.to(dtype)
    before = (A.attn_fwd_online.launches, A.attn_fwd_train.launches, A.attn_fwd_tc.launches)
    ref = A.attention_qkv_reference(qkv, 2)
    for fn in (A.attn_fwd_online, A.attn_fwd_train):
        torch.testing.assert_close(fn(qkv, 2), ref, rtol=0, atol=0)
    assert (A.attn_fwd_online.launches, A.attn_fwd_train.launches,
            A.attn_fwd_tc.launches) == before


def _full_width(name):
    from vdiff_tpu_torch.factory import CONFIG_DIR, build_unet, load_experiment_config

    cfg, _ = load_experiment_config(f"{CONFIG_DIR}/{name}.json")
    celeba = name == "celeba"
    with torch.device("meta"):
        return build_unet(dict(cfg["model"], drop_rate=0.0), in_channels=3,
                          model_out_type=cfg["diffusion"]["model_out_type"],
                          num_classes=40 if celeba else 10, multitags=celeba,
                          dtype=torch.bfloat16)


def _inputs(name, B):
    res = 64 if name == "celeba" else 32
    y = torch.empty(B, 40, device="meta") if name == "celeba" else torch.empty(B, device="meta")
    return torch.empty(B, res, res, 3, device="meta"), torch.empty(B, device="meta"), y


def _entries(calls):
    """{entry: launches} and the q tiles of the vdiff_attn_fwd_tc launches."""
    names = collections.Counter(name for name, _ in calls)
    rows = collections.Counter(a[6] for name, a in calls if name == "vdiff_attn_fwd_tc")
    return dict(names), dict(rows)


# one bf16 forward at the sampler's batch: every attention call on the tensor
# cores; the counts chip_smoke.py asserts (SAMPLE_FWD_LAUNCHES_BF16,
# CELEBA_FWD_LAUNCHES_BF16) unchanged
SAMPLE_PATHS = {
    "cifar10_cond": (64, {"vdiff_attn_fwd_tc": 18}, {64: 9, 32: 9},
                     {"attn_fwd_online": 17, "attn_fwd_tc": 1}),
    "celeba": (32, {"vdiff_attn_fwd_tc": 27}, {64: 27},
               {"attn_fwd_pack1": 10, "attn_fwd_tc": 8, "attn_fwd_online": 9}),
}


@pytest.mark.parametrize("name", sorted(SAMPLE_PATHS))
def test_bf16_sampling_forward_reaches_only_the_tc_forward(recorded, name):
    """cifar10_cond at B=64: B1 ×17 (8 at T=256 on 64-row tiles, 9 at T=64 on
    32-row ones) and B2 ×1, all vdiff_attn_fwd_tc; celeba at B=32: B6 ×10,
    B2 ×8 and B1 ×9, all vdiff_attn_fwd_tc at 64 rows."""
    B, entries, rows, counts = SAMPLE_PATHS[name]
    model = _full_width(name)
    with torch.no_grad():
        model(*_inputs(name, B))
    calls, got = recorded()
    assert _entries(calls) == (entries, rows)
    assert got == counts


def test_bf16_cifar_train_step_reaches_only_the_tc_forward(recorded):
    """One bf16 training forward and backward of the full-width cifar10_cond
    UNet at B=128 on the meta device: B3 ×17 and B2 ×1 launch
    vdiff_attn_fwd_tc (the 9 calls at T=64 on 32-row tiles), B4 ×17 and B5
    ×1 vdiff_attn_bwd_tc; no FMA entry runs; the per-counter counts are
    chip_smoke's TRAIN_STEP_LAUNCHES_BF16 (B4's under attn_bwd)."""
    model = _full_width("cifar10_cond")
    model(*_inputs("cifar10_cond", 128), train=True).float().sum().backward()
    calls, counts = recorded()
    assert _entries(calls) == ({"vdiff_attn_fwd_tc": 18, "vdiff_attn_bwd_tc": 18},
                               {64: 9, 32: 9})
    assert counts == {"attn_fwd_train": 17, "attn_fwd_tc": 1, "attn_bwd": 17, "attn_bwd_tc": 1}


def test_q_tile_entry_is_built_and_bound():
    """kernels.py binds vdiff_attn_fwd_tc with its q-tile argument; the
    source builds the forward at two and four warps (32 and 64 q rows), the
    lse instantiation at four only, and keeps the key tile the emulation
    assumes (the q tile does not enter it)."""
    assert kernels._ENTRY_POINTS["vdiff_attn_fwd_tc"] == [kernels._P] * 2 + [kernels._I] * 5 + [
        kernels._P]
    src = open(os.path.join(kernels.CSRC_DIR, "attn_fwd_tc.cu")).read()
    assert re.search(r'extern "C" int vdiff_attn_fwd_tc\([^)]*int q_rows, void\* stream\)', src)
    assert "case 64: return launch<4>" in src and "case 32: return launch<2>" in src
    assert "launch<1>" not in src
    assert "kBk = C == 256 ? 32 : 64" in src and P.KEY_TILE == {32: 64, 64: 64, 128: 64, 256: 32}
