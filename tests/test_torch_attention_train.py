"""Port trainable attention (vdiff_tpu_torch.ops.attention.QkvAttention on the
training route, and its backward twin) vs the JAX package's flash_attention_trainable on the CPU.

The Pallas kernels run in interpret mode, as tests/test_attention.py runs them:
T=64 and T=256 reach ``_attn_fwd_kernel`` (B3) and ``_attn_bwd_kernel`` (B4);
T=1024 reaches ``_qblk_fwd_call`` (B2) and ``_attn_bwd_kernel_qblk`` (B5). JAX
takes head-folded q/k/v (B·N, T, C); the port the fused (B, T, 3·N·C) qkv, so
the inputs and gradients are converted between the two layouts. On CPU tensors
the port runs its twins; the CUDA kernels are held against the same twins on
the card by chip_smoke.py.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from vdiff_tpu_torch.ops import attention as A  # noqa: E402

# f32 on both sides; only the summation order differs.
RTOL = 1e-5


def _fold(a, N):
    """(B, T, N·C) → (B·N, T, C), JAX's head folding."""
    B, T, NC = a.shape
    return a.reshape(B, T, N, NC // N).transpose(0, 2, 1, 3).reshape(B * N, T, NC // N)


def _unfold(a, B, N):
    BN, T, C = a.shape
    return a.reshape(B, N, T, C).transpose(0, 2, 1, 3).reshape(B, T, N * C)


def _close(got, ref):
    """rtol 1e-5, with an absolute floor of 1e-5 of the array's scale for
    entries near zero."""
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * np.abs(ref).max())


@pytest.mark.parametrize("B,T,N,C", [
    (2, 64, 1, 64),    # B3/B4, C >= T: the normalise-P branch
    (1, 256, 2, 32),   # B3/B4, C < T: the output-divide branch; two heads
    (1, 1024, 1, 32),  # B2 forward, B5 backward (two q-blocks of 512)
])
def test_trainable_attention_matches_jax_flash_trainable(B, T, N, C):
    from vdiff_tpu.ops.attention import flash_attention_trainable

    rng = np.random.RandomState(T + N)
    qkv = (rng.randn(B, T, 3 * N * C) * 0.5).astype(np.float32)
    g = rng.randn(B, T, N * C).astype(np.float32)
    q, k, v = (_fold(a, N) for a in np.split(qkv, 3, axis=-1))
    ref, vjp = jax.vjp(lambda q, k, v: flash_attention_trainable(q, k, v, True),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    dref = np.concatenate([_unfold(np.asarray(d), B, N) for d in vjp(jnp.asarray(_fold(g, N)))], -1)

    x = torch.from_numpy(qkv).requires_grad_()
    out = A.spatial_attention_qkv(x, N, train=True)
    out.backward(torch.from_numpy(g))
    _close(out.detach().numpy(), _unfold(np.asarray(ref), B, N))
    _close(x.grad.numpy(), dref)


@pytest.mark.parametrize("N,C", [(1, 32), (2, 16), (4, 64)])
def test_bwd_twin_matches_autograd_through_forward_twin(N, C):
    """attention_qkv_bwd_reference is the gradient of attention_qkv_reference;
    in f32 only the summation order differs."""
    rng = np.random.RandomState(C)
    qkv = torch.from_numpy(rng.randn(2, 64, 3 * N * C).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(rng.randn(2, 64, N * C).astype(np.float32))
    A.attention_qkv_reference(qkv, N).backward(g)
    got = A.attention_qkv_bwd_reference(qkv.detach(), g, N)
    torch.testing.assert_close(got, qkv.grad, rtol=1e-5, atol=1e-5 * float(qkv.grad.abs().max()))


def test_bwd_twin_rounds_p_and_ds_to_bf16_operands():
    """bf16 in → bf16 d(qkv), within the bf16 rounding of P, dS and the
    output of the f32 gradient on the same values."""
    rng = np.random.RandomState(3)
    qkv = torch.from_numpy(rng.randn(1, 64, 3 * 32).astype(np.float32)).to(torch.bfloat16)
    g = torch.from_numpy(rng.randn(1, 64, 32).astype(np.float32)).to(torch.bfloat16)
    got = A.attention_qkv_bwd_reference(qkv, g, 1)
    assert got.dtype == torch.bfloat16 and got.shape == qkv.shape
    ref = A.attention_qkv_bwd_reference(qkv.float(), g.float(), 1)
    assert not torch.equal(got.float(), ref)  # the operands were rounded
    torch.testing.assert_close(got.float(), ref, rtol=2 ** -6, atol=2 ** -6 * float(ref.abs().max()))


def test_cpu_training_path_uses_twins_and_counts_no_launch():
    qkv = torch.randn(1, 64, 3 * 2 * 32)
    g = torch.randn(1, 64, 2 * 32)
    counters = (A.attn_fwd_train, A.attn_fwd_qblk, A.attn_bwd_rows, A.attn_bwd_cols)
    before = [f.launches for f in counters]
    torch.testing.assert_close(A.attn_fwd_train(qkv, 2), A.attention_qkv_reference(qkv, 2),
                               rtol=0, atol=0)
    torch.testing.assert_close(A.attn_bwd(qkv, g, 2), A.attention_qkv_bwd_reference(qkv, g, 2),
                               rtol=0, atol=0)
    x = qkv.clone().requires_grad_()
    A.spatial_attention_qkv(x, 2, train=True).backward(g)
    torch.testing.assert_close(x.grad, A.attention_qkv_bwd_reference(qkv, g, 2), rtol=0, atol=0)
    assert [f.launches for f in counters] == before


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "tokens", "layout", "device", "grad"])
def test_training_wrappers_refuse_what_the_kernels_do_not_take(bad):
    qkv, g = torch.zeros(1, 64, 3 * 64), torch.zeros(1, 64, 64)
    err = ValueError
    if bad == "dtype":
        qkv, g, err = qkv.half(), g.half(), TypeError
    elif bad == "head_dim":
        qkv, g = torch.zeros(1, 64, 3 * 48), torch.zeros(1, 64, 48)
    elif bad == "tokens":
        qkv, g = torch.zeros(1, 48, 3 * 64), torch.zeros(1, 48, 64)
    elif bad == "layout":
        qkv = torch.zeros(1, 64, 2 * 3 * 64)[..., ::2]
    elif bad == "device":
        qkv, g, err = qkv.to("meta"), g.to("meta"), RuntimeError
    else:
        g = torch.zeros(1, 64, 2 * 64)[..., ::2]
    with pytest.raises(err):
        if bad != "grad":
            A.attn_fwd_train(qkv, 1)
        A.attn_bwd(qkv, g, 1)


def test_backward_passes_refuse_cpu_tensors():
    """The two passes are kernel stages; the CPU backward is the twin."""
    qkv, g = torch.zeros(1, 64, 3 * 64), torch.zeros(1, 64, 64)
    with pytest.raises(RuntimeError, match="CUDA"):
        A.attn_bwd_rows(qkv, g, 1, torch.empty_like(qkv))
    lse = torch.zeros(1, 1, 64)
    with pytest.raises(RuntimeError, match="CUDA"):
        A.attn_bwd_cols(qkv, g, 1, lse, lse, torch.empty_like(qkv))
