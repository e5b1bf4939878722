"""Port attention (vdiff_tpu_torch.ops.attention) vs the JAX package on the CPU.

The Pallas kernels run in TPU-interpret mode, as tests/test_attention.py runs
them: T=256 reaches ``_flash_kernel`` (B1) and T=1024 ``_attn_fwd_kernel_qblk``
(B2) through ``flash_attention_qkv``; T=64 is held against ``_xla_attention``.
On a CPU tensor the kernel wrappers return the plain twin, so these tests
pin the twin's math; the CUDA kernels are held against the same twin on the
card by chip_smoke.py.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from vdiff_tpu_torch.ops import attention as A  # noqa: E402

pytest_plugins = ["torch_limits"]

# f32 on both sides; the interpret-mode kernels accumulate blockwise.
ATOL = RTOL = 1e-5


def _qkv(B, T, N, C, seed):
    return (np.random.RandomState(seed).randn(B, T, 3 * N * C) * 0.5).astype(np.float32)


def _jax_split(qkv, N):
    B, T, _ = qkv.shape
    q, k, v = jnp.split(jnp.asarray(qkv), 3, axis=-1)
    return [a.reshape(B, T, N, -1) for a in (q, k, v)]


@pytest.mark.parametrize("T", [256, 1024])
def test_twin_matches_pallas_flash_qkv_interpret(T):
    from jax.experimental.pallas import tpu as pltpu

    from vdiff_tpu.ops.attention import flash_attention_qkv

    qkv = _qkv(1, T, 1, 128, seed=T)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(flash_attention_qkv(jnp.asarray(qkv), 1))
    out = A.spatial_attention_qkv(torch.from_numpy(qkv), 1).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("N,C", [(1, 128), (2, 64)])
def test_twin_matches_xla_attention_t64(N, C):
    from vdiff_tpu.ops.attention import _xla_attention

    qkv = _qkv(2, 64, N, C, seed=N)
    ref = np.asarray(_xla_attention(*_jax_split(qkv, N)))
    out = A.attention_qkv_reference(torch.from_numpy(qkv), N).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_dispatch_on_cpu_uses_twin_and_counts_no_launch():
    qkv = torch.from_numpy(_qkv(1, 1024, 2, 32, seed=3))
    before = (A.attn_fwd_online.launches, A.attn_fwd_qblk.launches)
    ref = A.attention_qkv_reference(qkv, 2)
    for fn in (A.spatial_attention_qkv, A.attn_fwd_online, A.attn_fwd_qblk):
        torch.testing.assert_close(fn(qkv, 2), ref, rtol=0, atol=0)
    assert (A.attn_fwd_online.launches, A.attn_fwd_qblk.launches) == before


def test_bf16_twin_keeps_dtype_and_f32_softmax():
    """bf16 in → bf16 out; scores and softmax in f32, probabilities rounded to
    bf16 for the second product (as ``_xla_attention`` does)."""
    from vdiff_tpu.ops.attention import _xla_attention

    qkv = _qkv(1, 64, 1, 32, seed=5)
    qkv_bf = torch.from_numpy(qkv).to(torch.bfloat16)
    out = A.attention_qkv_reference(qkv_bf, 1)
    assert out.dtype == torch.bfloat16
    ref = _xla_attention(*_jax_split(qkv_bf.float().numpy(), 1))
    # two bf16 roundings (probabilities, output) of values |v| ≤ ~2
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref), atol=2 * 2 ** -7 * 2, rtol=0)


@pytest.mark.parametrize("fn", [A.attn_fwd_online, A.attn_fwd_qblk, A.spatial_attention_qkv])
@pytest.mark.parametrize("bad", ["dtype", "head_dim", "tokens", "layout", "device"])
def test_wrappers_refuse_what_the_kernels_do_not_take(fn, bad):
    qkv = torch.zeros(1, 64, 3 * 64)
    if bad == "dtype":
        qkv, err = qkv.half(), TypeError
    elif bad == "head_dim":
        qkv, err = torch.zeros(1, 64, 3 * 48), ValueError
    elif bad == "tokens":
        qkv, err = torch.zeros(1, 48, 3 * 64), ValueError
    elif bad == "layout":
        qkv, err = torch.zeros(1, 64, 2 * 3 * 64)[..., ::2], ValueError
    else:
        qkv, err = qkv.to("meta"), RuntimeError
    with pytest.raises(err):
        fn(qkv, 1)


def test_kernel_build_reports_missing_nvcc(monkeypatch, tmp_path):
    from vdiff_tpu_torch import kernels

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernels.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.find_nvcc()


def test_kernel_digest_covers_sources_and_flags(monkeypatch):
    from vdiff_tpu_torch import kernels

    d0 = kernels.source_digest()
    assert d0 == kernels.source_digest()
    monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ("-G",))
    assert kernels.source_digest() != d0
