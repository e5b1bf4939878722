"""The head-dim 32/64 attention family of the port (B6–B9 twins, wrappers and
autograd Functions in vdiff_tpu_torch.ops.attention) vs the JAX package's
pack1 Pallas kernels on the CPU, and the celeba UNet's routing.

The Pallas kernels run with ``interpret=True`` at small blocks (bq=128, and
kv chunks of 128 for B9), as tests/test_attention.py runs them: T=256 gives
two q blocks and two kv chunks. JAX packs lse as (B, T, N·C), each head's
value broadcast over its C lanes; the port keeps (B, N, T), so the tests
convert it. On CPU tensors the port runs its twins; the CUDA kernels are held
against the same twins on the card by chip_smoke.py.
"""

import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tests import torch_parity as P  # noqa: E402
from vdiff_tpu_torch.ops import attention as A  # noqa: E402

pytest_plugins = ["torch_limits"]

# f32: both sides do f32 math on the same values; only the summation order
# and (B7/B9) the running max or the chunking differ.
RTOL = 1e-5
# bf16: both round P and dS to bf16 at the same points and each output once;
# f32 sums in another order can move a rounding by one step. One bf16 step of
# each output (2^-7 relative) plus 2^-8 of the array's scale.
BF16_RTOL, BF16_SCALE = 2.0 ** -7, 2.0 ** -8
SHAPES = [(2, 256, 2, 64), (1, 256, 4, 32)]  # (B, T, N, C): N·C = 128
BQ, BKV = 128, 128


def _inputs(B, T, N, C, dtype, seed):
    rng = np.random.RandomState(seed)
    qkv = (rng.randn(B, T, 3 * N * C) * 0.5).astype(np.float32)
    g = rng.randn(B, T, N * C).astype(np.float32)
    if dtype == "bfloat16":  # both sides see the same bf16 values
        qkv = np.asarray(jnp.asarray(qkv, jnp.bfloat16).astype(jnp.float32))
        g = np.asarray(jnp.asarray(g, jnp.bfloat16).astype(jnp.float32))
    return qkv, g


def _jnp(a, dtype):
    return jnp.asarray(a, getattr(jnp, dtype))


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))


def _close(got, ref, dtype):
    got = np.asarray(torch.as_tensor(got).float().numpy() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    scale = max(float(np.abs(ref).max()), 1e-30)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * scale)
    else:
        np.testing.assert_allclose(got, ref, rtol=BF16_RTOL, atol=BF16_SCALE * scale)


def _jax_lse(lse, B, T, N, C):
    """JAX's lane-broadcast (B, T, N·C) lse → (B, N, T)."""
    return np.asarray(lse).reshape(B, T, N, C)[..., 0].transpose(0, 2, 1)


def _jax_dqkv(dq, dk, dv, dtype):
    """JAX's three outputs → one d(qkv), as its custom VJPs concatenate."""
    dt = getattr(jnp, dtype)
    return jnp.concatenate([dq, dk.astype(dt), dv.astype(dt)], axis=-1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,N,C", SHAPES)
def test_b6_b7_twins_match_pallas_pack1_forward(B, T, N, C, dtype):
    from vdiff_tpu.ops.attention import _pack1_fwd_call, _pack1_fwd_lse_call

    qkv, _ = _inputs(B, T, N, C, dtype, seed=C + N)
    ref6 = _pack1_fwd_call(_jnp(qkv, dtype), N, C, BQ, interpret=True)
    ref7, ref_lse = _pack1_fwd_lse_call(_jnp(qkv, dtype), N, C, BQ, interpret=True)
    out6 = A.attn_fwd_pack1(_t(qkv, dtype), N)
    out7, lse = A.attn_fwd_pack1_lse(_t(qkv, dtype), N)
    assert out6.dtype == out7.dtype == getattr(torch, dtype) and lse.dtype == torch.float32
    assert lse.shape == (B, N, T)
    _close(out6, ref6, dtype)
    _close(out7, ref7, dtype)
    # lse: f32 from the same values on both sides, |lse| ≲ 10
    np.testing.assert_allclose(lse.numpy(), _jax_lse(ref_lse, B, T, N, C), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,N,C", SHAPES)
def test_b8_twin_matches_pallas_pack1_backward(B, T, N, C, dtype):
    from vdiff_tpu.ops.attention import _pack1_bwd_call

    qkv, g = _inputs(B, T, N, C, dtype, seed=2 * C + N)
    ref = _jax_dqkv(*_pack1_bwd_call(_jnp(qkv, dtype), _jnp(g, dtype), N, C, BQ, interpret=True),
                    dtype)
    got = A.attn_bwd_pack1(_t(qkv, dtype), _t(g, dtype), N)
    assert got.dtype == getattr(torch, dtype) and got.shape == qkv.shape
    _close(got, ref, dtype)


@pytest.mark.parametrize("chunk", [64, 1024])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,N,C", SHAPES)
def test_b9_twin_matches_pallas_pack1_kv_backward(B, T, N, C, dtype, chunk):
    """The kv-chunked twin takes JAX's own forward residuals (out in the
    input dtype, lse converted), so δ = Σ dO∘O comes from the same saved O."""
    from vdiff_tpu.ops.attention import _pack1_bwd_kv_call, _pack1_fwd_lse_call

    qkv, g = _inputs(B, T, N, C, dtype, seed=3 * C + N)
    jq, jg = _jnp(qkv, dtype), _jnp(g, dtype)
    out, lse = _pack1_fwd_lse_call(jq, N, C, BQ, interpret=True)
    ref = _jax_dqkv(*_pack1_bwd_kv_call(jq, out, lse, jg, N, C, BQ, BKV, interpret=True), dtype)
    args = (_t(qkv, dtype), _t(np.asarray(out, np.float32), dtype),
            torch.from_numpy(np.ascontiguousarray(_jax_lse(lse, B, T, N, C))), _t(g, dtype), N)
    got = A.attention_qkv_bwd_kv_reference(*args, chunk=chunk)
    _close(got, ref, dtype)
    if chunk == 1024:
        torch.testing.assert_close(A.attn_bwd_pack1_kv(*args), got, rtol=0, atol=0)


def _trainable(x, N, kv):
    """The port's counterpart of pack1_attention_trainable(_kv)."""
    if kv:
        return A.Pack1AttentionKV.apply(x, N)
    return A.QkvAttention.apply(x, N, A.attn_fwd_pack1, A.attn_bwd_pack1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv", [False, True])
def test_autograd_functions_match_jax_custom_vjps(kv, dtype, monkeypatch):
    """QkvAttention (B6 + B8) / Pack1AttentionKV forward and d(qkv) vs JAX's
    pack1_attention_trainable / pack1_attention_trainable_kv (interpret), the
    pickers set to small blocks."""
    from vdiff_tpu.ops import attention as JA

    B, T, N, C = SHAPES[0]
    monkeypatch.setattr(JA, "_pick_qblk_pack1", lambda T, C: BQ)
    monkeypatch.setattr(JA, "_pick_qblk_pack1_bwd", lambda T, C: BQ)
    monkeypatch.setattr(JA, "_pick_qblk_pack1_kv", lambda T, C: (BQ, BKV))
    fn = JA.pack1_attention_trainable_kv if kv else JA.pack1_attention_trainable
    qkv, g = _inputs(B, T, N, C, dtype, seed=7 + kv)
    ref, vjp = jax.vjp(lambda x: fn(x, N, C, True), _jnp(qkv, dtype))
    (dref,) = vjp(_jnp(g, dtype))

    x = _t(qkv, dtype).requires_grad_()
    out = _trainable(x, N, kv)
    out.backward(_t(g, dtype))
    _close(out.detach(), ref, dtype)
    _close(x.grad, dref, dtype)


def test_cpu_pack1_path_uses_twins_and_counts_no_launch():
    qkv, g = (torch.from_numpy(a) for a in _inputs(1, 256, 2, 64, "float32", seed=1))
    counters = (A.attn_fwd_pack1, A.attn_fwd_pack1_lse, A.attn_bwd_pack1, A.attn_bwd_pack1_kv,
                A.attn_bwd_rows, A.attn_bwd_cols)
    before = [f.launches for f in counters]
    for kv in (False, True):
        x = qkv.clone().requires_grad_()
        _trainable(x, 2, kv).backward(g)
        torch.testing.assert_close(x.grad, A.attention_qkv_bwd_reference(qkv, g, 2),
                                   rtol=1e-5, atol=1e-6)
    assert [f.launches for f in counters] == before


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "tokens", "device"])
def test_pack1_wrappers_refuse_what_the_kernels_do_not_take(bad):
    qkv, g = torch.zeros(1, 64, 3 * 2 * 64), torch.zeros(1, 64, 2 * 64)
    out, lse = torch.zeros(1, 64, 2 * 64), torch.zeros(1, 2, 64)
    err = ValueError
    if bad == "head_dim":  # 128 is taken by the other kernels, not by these
        qkv, g, out = torch.zeros(1, 64, 3 * 128), torch.zeros(1, 64, 128), torch.zeros(1, 64, 128)
        lse = torch.zeros(1, 1, 64)
    elif bad == "dtype":
        qkv, g, err = qkv.half(), g.half(), TypeError
    elif bad == "tokens":
        qkv, g, out, lse = qkv[:, :48], g[:, :48], out[:, :48], lse[..., :48]
    else:
        qkv, g, out, lse = (a.to("meta") for a in (qkv, g, out, lse))
        err = RuntimeError
    N = 1 if bad == "head_dim" else 2
    for call in (lambda: A.attn_fwd_pack1(qkv, N), lambda: A.attn_fwd_pack1_lse(qkv, N),
                 lambda: A.attn_bwd_pack1(qkv, g, N),
                 lambda: A.attn_bwd_pack1_kv(qkv, out, lse, g, N)):
        with pytest.raises(err):
            call()


# ---------------------------------------------------------------------------
# routing: the celeba UNet's 27 attention calls, as JAX routes them
# ---------------------------------------------------------------------------

# (T, N) at C=64 → (inference kind, training kind), the table of JAX's
# spatial_attention_qkv on a TPU without head padding
CELEBA_ROUTES = {
    (1024, 6): ("pack1", "pack1"),    # down_1_*, up_1_{0..3}: B6 / B6 + B8
    (256, 6): ("pack1", "pack1"),     # down_1_ds
    (256, 12): ("pack1", "pack1"),    # up_3_us
    (4096, 6): ("pack1", "pack1_kv"),  # up_1_us: B6 / B7 + B9
    (256, 9): ("qblk", "train"),      # down_2_*, up_2_{0..3}: B2 folded / B3 + B4
    (1024, 9): ("qblk", "train"),     # up_2_us: B2 / B2 + B5
    (64, 9): ("online", "train"),     # down_2_ds: XLA / B3 + B4
    (64, 12): ("online", "train"),    # down_3_*, mid, up_3_{0..3}
}


@pytest.mark.parametrize("shape", sorted(CELEBA_ROUTES))
def test_route_matches_jax_dispatch_table(shape):
    T, N = shape
    assert (A.route(T, N, 64, False), A.route(T, N, 64, True)) == CELEBA_ROUTES[shape]


def test_route_pickers_agree_with_jax():
    """The port's copies of JAX's pickers give JAX's answers on every shape
    the routes depend on (the padded-heads gates are TPU layout and stay
    out)."""
    from vdiff_tpu.ops import attention as JA

    for T in (64, 128, 256, 512, 1024, 2048, 4096, 8192):
        for C in (32, 64):
            assert A._pick_qblk_fwd(T, C) == JA._pick_qblk_fwd(T, C)
            assert A._pick_qblk_pack1(T, C) == JA._pick_qblk_pack1(T, C)
            assert A._pick_qblk_pack1_bwd(T, C) == JA._pick_qblk_pack1_bwd(T, C)
            assert A._pick_qblk_pack1_kv(T, C) == JA._pick_qblk_pack1_kv(T, C)[0]
    assert A._PACK1_BWD_MIN_BQ == JA._PACK1_BWD_MIN_BQ
    # the CIFAR routes are unchanged: head dim 256
    assert [A.route(T, 1, 256, False) for T in (64, 256, 1024)] == ["online", "online", "qblk"]
    assert {A.route(T, 1, 256, True) for T in (64, 256, 1024)} == {"train"}


KERNELS = ("attn_fwd_online", "attn_fwd_qblk", "attn_fwd_train", "attn_bwd_rows",
           "attn_bwd_cols", "attn_fwd_tc", "attn_bwd_tc", "attn_fwd_pack1", "attn_fwd_pack1_lse",
           "attn_bwd_pack1", "attn_bwd_pack1_kv")


@pytest.fixture
def stub_kernels(monkeypatch):
    """Tensors on the meta device take the wrappers' launch path (they are
    not CPU tensors) into the stub library; counters start at 0."""
    from vdiff_tpu_torch import kernels

    monkeypatch.setattr(kernels, "library", P.StubLibrary)
    monkeypatch.setattr(A, "_need_cuda", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: types.SimpleNamespace(cuda_stream=0))
    for name in KERNELS:
        monkeypatch.setattr(getattr(A, name), "launches", 0)
    return lambda: {name: getattr(A, name).launches for name in KERNELS}


def _celeba_unet():
    """The full-width, full-depth celeba UNet on the meta device (shapes
    only, nothing computed), dropout off."""
    from vdiff_tpu_torch.factory import build_unet, load_experiment_config
    from vdiff_tpu_torch.factory import CONFIG_DIR

    cfg, _ = load_experiment_config(f"{CONFIG_DIR}/celeba.json")
    with torch.device("meta"):
        model = build_unet(dict(cfg["model"], drop_rate=0.0), in_channels=3,
                           model_out_type=cfg["diffusion"]["model_out_type"], num_classes=40,
                           multitags=True)
    return model


def test_celeba_forward_and_train_step_launch_counts(stub_kernels):
    """One inference forward of the celeba UNet launches new B6 ×10, B2 ×8
    and B1 ×9; one training forward and backward launches B6 ×9, B7 ×1, B8
    ×9, B9 ×1, B3 ×16, B2 ×1 and each backward pass of B4/B5 ×17 — the
    counts chip_smoke.py asserts on the card."""
    model = _celeba_unet()
    assert model.class_embed.weight.shape == (768, 40) and model.out_conv[2].weight.shape[0] == 6
    x = torch.empty(2, 64, 64, 3, device="meta")
    t, y = torch.empty(2, device="meta"), torch.empty(2, 40, device="meta")
    with torch.no_grad():
        out = model(x, t, y)
    assert out.shape == (2, 64, 64, 6)
    zero = dict.fromkeys(KERNELS, 0)
    assert stub_kernels() == dict(zero, attn_fwd_pack1=10, attn_fwd_qblk=8, attn_fwd_online=9)
    for name in KERNELS:
        setattr(getattr(A, name), "launches", 0)
    model(x, t, y, train=True).sum().backward()
    assert stub_kernels() == dict(zero, attn_fwd_pack1=9, attn_fwd_pack1_lse=1, attn_bwd_pack1=9,
                                  attn_bwd_pack1_kv=1, attn_fwd_train=16, attn_fwd_qblk=1,
                                  attn_bwd_rows=17, attn_bwd_cols=17)
