"""The port's fused GN→SiLU→conv3x3 (vdiff_tpu_torch.ops.conv3x3) and the
UNet's routing to the two fused inference kernels vs the JAX package on the
CPU: the Pallas kernel in interpret mode, the same weights and numpy inputs."""

import functools
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tests import torch_parity as P  # noqa: E402
from vdiff_tpu_torch.models import unet as U  # noqa: E402
from vdiff_tpu_torch.ops import attention as A  # noqa: E402
from vdiff_tpu_torch.ops import conv3x3 as C3  # noqa: E402
from vdiff_tpu_torch.ops import groupnorm as G  # noqa: E402


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _inputs(B, H, W, C, CO, film, has_skip, gn, seed=0):
    """x, HWIO kernel, bias, gamma, beta, shift, scale, skip as numpy f32."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    x, k, b = f(B, H, W, C), f(3, 3, C, CO) * 0.1, f(CO) * 0.1
    gamma = (rng.rand(C) + 0.5).astype(np.float32) if gn else None
    beta = f(C) * 0.1 if gn else None
    shift = f(B, C) * 0.1 if film else None
    scale = f(B, C) * 0.1 if film else None
    skip = f(B, H, W, CO) if has_skip else None
    return x, k, b, gamma, beta, shift, scale, skip


def _oihw(k):
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


CASES = [
    (2, 4, 4, 8, 16, False, False, True),   # JAX packs both images into one block
    (2, 4, 4, 8, 16, True, True, True),     # FiLM + skip
    (4, 4, 6, 8, 8, True, False, True),     # non-square
    (2, 8, 8, 8, 8, False, True, False),    # bare conv (no GN prologue)
    (1, 8, 8, 16, 8, True, True, True),     # single image
    (2, 5, 3, 24, 40, True, True, True),    # C_in != C_out, odd H and W, groups of 6
]


@pytest.mark.parametrize("B,H,W,C,CO,film,has_skip,gn", CASES)
def test_twin_matches_the_pallas_kernel_in_interpret_mode(B, H, W, C, CO, film, has_skip, gn):
    """f32 on both sides, 4 groups: the same arithmetic; the Pallas kernel sums
    the taps as im2col matmuls and torch as one conv, so only the order of the
    f32 sums differs (K = 9·C_in ≤ 216 terms of size ≤ ~0.5)."""
    from vdiff_tpu.ops.conv3x3 import fused_gn_silu_conv3x3

    x, k, b, gamma, beta, shift, scale, skip = _inputs(B, H, W, C, CO, film, has_skip, gn)
    ref = np.asarray(fused_gn_silu_conv3x3(_j(x), _j(k), _j(b), _j(gamma), _j(beta), _j(shift),
                                           _j(scale), _j(skip), num_groups=4, eps=1e-6,
                                           interpret=True))
    args = (_t(x), _oihw(k), _t(b), _t(gamma), _t(beta), _t(shift), _t(scale), _t(skip))
    out = C3.fused_gn_silu_conv3x3_reference(*args, num_groups=4)
    assert out.shape == (B, H, W, CO) and out.dtype == torch.float32 and out.is_contiguous()
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=2e-5)
    # on a CPU tensor the wrapper is the twin, and counts no launch
    before = C3.fused_gn_silu_conv3x3.launches
    torch.testing.assert_close(C3.fused_gn_silu_conv3x3(*args, num_groups=4), out, rtol=0, atol=0)
    assert C3.fused_gn_silu_conv3x3.launches == before


def test_twin_pads_the_normalised_activation_not_x():
    """SAME padding pads y = silu(GN(x)): a tap outside the image adds 0, not
    silu(B). With beta large every silu(B) is far from 0, so padding x instead
    would move every border pixel."""
    x, k, b, gamma, beta, _, _, _ = _inputs(1, 4, 4, 8, 8, False, False, True, seed=1)
    beta = beta + 3.0
    out = C3.fused_gn_silu_conv3x3_reference(_t(x), _oihw(k), _t(b), _t(gamma), _t(beta),
                                             num_groups=4)
    y = G.gn_film_silu_kernel_reference(_t(x), _t(gamma), _t(beta), num_groups=4)
    ref = torch.nn.functional.conv2d(y.permute(0, 3, 1, 2), _oihw(k), _t(b), padding=1)
    torch.testing.assert_close(out, ref.permute(0, 2, 3, 1), rtol=1e-5, atol=1e-5)


def test_bf16_twin_rounds_y_and_the_weights_and_casts_once():
    """bf16 in → bf16 out: y and the weights are rounded to bf16, the products
    accumulate in f32, bias and skip are added in f32, one cast. The unfused
    chain rounds after the conv, the bias and the add, so it differs."""
    x, k, b, gamma, beta, shift, scale, skip = _inputs(2, 8, 8, 32, 32, True, True, True, seed=2)
    xb, sb, cb, kb = (_t(a).bfloat16() for a in (x, shift, scale, skip))
    w = _oihw(k)
    out = C3.fused_gn_silu_conv3x3_reference(xb, w, _t(b), _t(gamma), _t(beta), sb, cb, kb)
    assert out.dtype == torch.bfloat16
    y = G.gn_film_silu_kernel_reference(xb, _t(gamma), _t(beta), sb, cb)  # bf16, rounded once
    acc = torch.nn.functional.conv2d(y.float().permute(0, 3, 1, 2), w.bfloat16().float(), _t(b),
                                     padding=1).permute(0, 2, 3, 1) + kb.float()
    torch.testing.assert_close(out, acc.bfloat16(), rtol=0, atol=0)
    f32 = C3.fused_gn_silu_conv3x3_reference_f32(xb, w, _t(b), _t(gamma), _t(beta), sb, cb, kb)
    assert f32.dtype == torch.float32 and torch.equal(f32.bfloat16(), out)


@pytest.mark.parametrize("bad", ["meta", "dtype", "layout", "weight", "bias", "skip_shape",
                                 "skip_dtype", "beta_alone", "film_without_gn", "half_film",
                                 "groups", "wide"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    x, k, b, gamma, beta, shift, scale, skip = _inputs(2, 4, 4, 8, 16, True, True, True)
    x, w, b, gamma, beta, shift, scale, skip = (_t(x), _oihw(k), _t(b), _t(gamma), _t(beta),
                                                _t(shift), _t(scale), _t(skip))
    kw, err = {"num_groups": 4}, ValueError
    if bad == "meta":  # neither a CPU tensor nor on the card: the launch path refuses it
        x, w, b, gamma, beta, shift, scale, skip = (
            a.to("meta") for a in (x, w, b, gamma, beta, shift, scale, skip))
        err = RuntimeError
    elif bad == "dtype":
        x, skip, err = x.half(), skip.half(), TypeError
    elif bad == "layout":
        x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    elif bad == "weight":
        w = w.permute(2, 3, 1, 0)  # HWIO, JAX's layout, where the port takes OIHW
    elif bad == "bias":
        b = b[:8]
    elif bad == "skip_shape":
        skip = skip[..., :8]
    elif bad == "skip_dtype":
        skip = skip.bfloat16()
    elif bad == "beta_alone":
        gamma = shift = scale = None
    elif bad == "film_without_gn":
        gamma = beta = None
    elif bad == "half_film":
        shift = None
    elif bad == "groups":
        kw = {"num_groups": 3}
    else:
        x = torch.zeros(1, 1, 1, C3.MAX_C_IN + 32)
        w, gamma, beta = torch.zeros(16, C3.MAX_C_IN + 32, 3, 3), None, None
        shift = scale = skip = None
    with pytest.raises(err):
        C3.fused_gn_silu_conv3x3(x, w, b, gamma, beta, shift, scale, skip, **kw)


def test_wrapper_lays_the_weights_out_tap_major_and_counts_its_launch(monkeypatch):
    """On the launch path (meta tensors into a stub library): the OIHW weights
    arrive as (9·C_in, C_out) in x's dtype, the FiLM halves with their row
    stride, x and skip uncopied, and the two passes count one launch. bf16
    calls reach the tensor-core entry (with the weights' row length and the
    picked tile), f32 calls the FMA entry."""
    from vdiff_tpu_torch import kernels

    seen = {}

    class Stub:
        def vdiff_gn_silu_conv3x3(self, *args):
            seen["fma"] = args
            return 0

        def vdiff_gn_silu_conv3x3_tc(self, *args):
            seen["tc"] = args
            return 0

    monkeypatch.setattr(kernels, "library", lambda: Stub())
    monkeypatch.setattr(C3, "need_cuda", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(C3.fused_gn_silu_conv3x3, "launches", 0)
    B, H, W, C, CO = 2, 4, 6, 64, 96
    meta = functools.partial(torch.empty, device="meta")
    for n, dtype in enumerate((torch.bfloat16, torch.float32), 1):
        x = meta(B, H, W, C, dtype=dtype)
        shift, scale = meta(B, 2 * C, dtype=dtype).chunk(2, dim=-1)
        out = C3.fused_gn_silu_conv3x3(x, meta(CO, C, 3, 3), meta(CO), meta(C), meta(C), shift,
                                       scale, meta(B, H, W, CO, dtype=dtype))
        assert out.shape == (B, H, W, CO) and out.dtype == dtype
        assert C3.fused_gn_silu_conv3x3.launches == n
    args = seen["fma"]
    # film_stride, film_f32 (the f32 call's FiLM rows are f32) | B, H, W, C, CO, G | is_bf16
    assert args[7:9] == (2 * C, 1) and args[12:18] == (B, H, W, C, CO, 32) and args[19] == 0
    args = seen["tc"]
    # ldw | film_stride, film_f32 | B, H, W, C, CO, G | tile_w
    assert args[2] == CO and args[8:10] == (2 * C, 0) and args[13:19] == (B, H, W, C, CO, 32)
    assert args[20] == C3.conv_tc_tile(W)
    # the re-layout itself, on real values: row (dy·3 + dx)·C_in + c, column o
    w = torch.arange(2 * 3 * 9, dtype=torch.float32).reshape(2, 3, 3, 3)
    w2 = w.permute(2, 3, 1, 0).reshape(27, 2)
    assert w2[(1 * 3 + 2) * 3 + 1, 1] == w[1, 1, 1, 2]


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

FUSABLE_TABLE = [  # (dtype, H, W, C, c_out) → JAX's gate with the backend check aside
    ("bfloat16", 32, 32, 256, 256, True),
    ("bfloat16", 8, 8, 256, 256, True),
    ("bfloat16", 32, 32, 384, 384, True),
    ("bfloat16", 8, 8, 768, 768, True),
    ("float32", 32, 32, 256, 256, False),   # f32 activations
    ("bfloat16", 32, 32, 192, 256, False),  # C_in not a multiple of 128
    ("bfloat16", 32, 32, 256, 192, False),  # C_out not a multiple of 128
    ("bfloat16", 2, 4, 256, 256, False),    # H·W not a multiple of 16
    ("bfloat16", 64, 64, 256, 256, False),  # one image over the 14 MiB estimate
    ("bfloat16", 32, 32, 512, 256, True),
    ("bfloat16", 64, 64, 128, 128, True),
]


@pytest.mark.parametrize("dtype,H,W,C,c_out,want", FUSABLE_TABLE)
def test_fusable_keeps_jax_gates(monkeypatch, dtype, H, W, C, c_out, want):
    from vdiff_tpu.ops import conv3x3 as JC

    monkeypatch.setattr(JC.jax, "default_backend", lambda: "tpu")
    jx = jax.ShapeDtypeStruct((2, H, W, C), jnp.dtype(dtype))
    tx = torch.empty(2, H, W, C, dtype=getattr(torch, dtype), device="meta")
    monkeypatch.delenv("VDIFF_FUSED_CONV", raising=False)
    assert not C3.fusable(tx, c_out) and not JC.fusable(jx, c_out)  # off by default
    monkeypatch.setenv("VDIFF_FUSED_CONV", "1")
    assert C3.fusable(tx, c_out) == JC.fusable(jx, c_out) == want


KERNELS = ("attn_fwd_online", "attn_fwd_qblk", "attn_fwd_tc", "attn_fwd_pack1",
           "gn_film_silu_kernel", "fused_gn_silu_conv3x3")
_HOME = {"gn_film_silu_kernel": G, "fused_gn_silu_conv3x3": C3}


@pytest.fixture
def stub_kernels(monkeypatch):
    """Meta tensors take the wrappers' launch path into a stub library;
    returns a function that reads the launch counts and sets them to 0."""
    from vdiff_tpu_torch import kernels
    from vdiff_tpu_torch.models import layers

    monkeypatch.setattr(kernels, "library", P.StubLibrary)
    monkeypatch.setattr(A, "_need_cuda", lambda *a: None)
    monkeypatch.setattr(G, "need_cuda", lambda *a: None)
    monkeypatch.setattr(C3, "need_cuda", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    # cuDNN and the CPU keep a channels_last input's layout through a conv; the
    # meta device's conv does not, so the UNet's convs get it back here
    monkeypatch.setattr(U, "conv2d", lambda x, conv, dt: layers.conv2d(x, conv, dt).contiguous(
        memory_format=torch.channels_last))
    fns = {name: getattr(_HOME.get(name, A), name) for name in KERNELS}
    for fn in fns.values():
        monkeypatch.setattr(fn, "launches", 0)

    def read():
        counts = {name: fn.launches for name, fn in fns.items()}
        for fn in fns.values():
            fn.launches = 0
        return counts

    return read


def _full_width(name, num_classes, multitags):
    from vdiff_tpu_torch.factory import CONFIG_DIR, build_unet, load_experiment_config

    cfg, _ = load_experiment_config(f"{CONFIG_DIR}/{name}.json")
    with torch.device("meta"):
        return build_unet(dict(cfg["model"], drop_rate=0.0), in_channels=3,
                          model_out_type=cfg["diffusion"]["model_out_type"],
                          num_classes=num_classes, multitags=multitags, dtype=torch.bfloat16)


# launches of one bf16 inference forward, by (VDIFF_FUSED_GN, VDIFF_FUSED_CONV):
# (B10, B11); the attention counts never move
FULL_WIDTH_COUNTS = {
    "cifar10_cond": {("0", "0"): (0, 0), ("1", "0"): (73, 0), ("1", "1"): (35, 38),
                     ("0", "1"): (0, 38)},
    "celeba": {("0", "0"): (0, 0), ("1", "0"): (100, 0), ("1", "1"): (77, 23),
               ("0", "1"): (0, 23)},
}


@pytest.mark.parametrize("name", sorted(FULL_WIDTH_COUNTS))
def test_full_width_launch_counts(stub_kernels, monkeypatch, name):
    """cifar10_cond (27 residual and 18 attention blocks): conv1 of the 11
    blocks that neither resample nor take an up-path skip plus all 27 conv2
    go fused (38); 18 attention norms, out_norm and norm1 of the 4 resampling
    and 12 up blocks stay alone (35; all 73 GroupNorms with the conv switch
    off). celeba fuses only its 384- and 768-wide convs (23). Training
    launches neither kernel whatever the switches say."""
    celeba = name == "celeba"
    model = _full_width(name, 40 if celeba else 10, celeba)
    res = 64 if celeba else 32
    x, t = torch.empty(2, res, res, 3, device="meta"), torch.empty(2, device="meta")
    y = torch.empty(2, 40, device="meta") if celeba else torch.empty(2, device="meta")
    # the bf16 model's B2 calls run the tensor-core kernel (attn_fwd_tc)
    attn = ({"attn_fwd_online": 9, "attn_fwd_qblk": 0, "attn_fwd_tc": 8, "attn_fwd_pack1": 10}
            if celeba else
            {"attn_fwd_online": 17, "attn_fwd_qblk": 0, "attn_fwd_tc": 1, "attn_fwd_pack1": 0})
    for (gn, conv), (n_gn, n_conv) in FULL_WIDTH_COUNTS[name].items():
        monkeypatch.setenv("VDIFF_FUSED_GN", gn)
        monkeypatch.setenv("VDIFF_FUSED_CONV", conv)
        with torch.no_grad():
            out = model(x, t, y)
        assert out.shape == (2, res, res, 6 if celeba else 3)
        assert stub_kernels() == dict(attn, gn_film_silu_kernel=n_gn, fused_gn_silu_conv3x3=n_conv)
    model(x, t, y, train=True)  # both switches still on
    counts = stub_kernels()
    assert counts["gn_film_silu_kernel"] == counts["fused_gn_silu_conv3x3"] == 0


# ---------------------------------------------------------------------------
# the UNet with the switches on
# ---------------------------------------------------------------------------


@pytest.fixture
def count_calls(monkeypatch):
    """Counts the UNet's calls of the fused conv wrapper and of the one-kernel
    GroupNorm's twin (the CPU form of both)."""
    calls = {"gn": 0, "conv": 0}
    twin, conv = G.gn_film_silu_kernel_reference, U.fused_gn_silu_conv3x3

    def gn_twin(*a, **k):
        calls["gn"] += 1
        return twin(*a, **k)

    def fused(*a, **k):
        calls["conv"] += 1
        return conv(*a, **k)

    monkeypatch.setattr(G, "gn_film_silu_kernel_reference", gn_twin)
    monkeypatch.setattr(U, "fused_gn_silu_conv3x3", fused)
    return calls


def test_small_unet_fused_matches_jax_fused_and_the_default_forward(monkeypatch, count_calls):
    """The small f32 UNet with both switches on (twins on the CPU; `fusable`
    forced on both sides, since its gates want bf16 and 128-wide channels)
    against the JAX UNet with its fused dispatch forced through the Pallas
    kernel in interpret mode, and against the port's own default forward. f32
    everywhere, so all three agree to summation order over ~30 layers."""
    from vdiff_tpu.models import unet as JU
    from vdiff_tpu.ops.conv3x3 import fused_gn_silu_conv3x3 as jax_fused

    x, t, y = P.inputs()
    model = P.port_unet()
    with torch.inference_mode():
        base = model(_t(x), _t(t), _t(y)).numpy()
    assert count_calls == {"gn": 0, "conv": 0}

    monkeypatch.setenv("VDIFF_FUSED_GN", "1")
    monkeypatch.setattr(U, "fusable", lambda x_, co: True)
    with torch.inference_mode():
        out = model(_t(x), _t(t), _t(y)).numpy()
    # 15 residual blocks: 15 conv2 + conv1 of down_{0,1,2}_0 and mid 1/2; 10
    # attention norms + out_norm + norm1 of 4 resampling and 6 up blocks
    assert count_calls == {"gn": 21, "conv": 20}
    np.testing.assert_allclose(out, base, rtol=1e-4, atol=1e-4)

    jm, params = P.jax_unet()
    monkeypatch.setattr(JU, "fusable", lambda x_, co: True)
    jax_calls = []

    def counted(*a, **k):
        jax_calls.append(1)
        return jax_fused(*a, interpret=True, **k)

    monkeypatch.setattr(JU, "fused_gn_silu_conv3x3", counted)
    ref = np.asarray(jax.jit(lambda x, t, y: jm.apply({"params": params}, x, t, y))(x, t, y))
    assert len(jax_calls) == 20  # JAX fuses the same 20 convs
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_small_bf16_unet_fused_stays_within_bf16_noise_of_the_default(monkeypatch, count_calls):
    """bf16: the fused forms round at other points than the default chain (by
    construction), so the outputs differ by bf16 noise over ~30 layers: the
    bound of the port-vs-JAX bf16 comparison, 2^-4 of the output's scale."""
    x, t, y = P.inputs(seed=2)
    model = P.port_unet(dtype_name="bfloat16")
    with torch.inference_mode():
        base = model(_t(x), _t(t), _t(y))
        monkeypatch.setenv("VDIFF_FUSED_GN", "1")
        monkeypatch.setattr(U, "fusable", lambda x_, co: True)
        out = model(_t(x), _t(t), _t(y))
    assert count_calls == {"gn": 21, "conv": 20}
    assert out.dtype == torch.float32 and not torch.equal(out, base)
    torch.testing.assert_close(out, base, rtol=0, atol=2 ** -4 * base.abs().max().item())


def test_switches_off_or_training_reach_neither_kernel_nor_twin(monkeypatch, count_calls):
    """Unset switches (the default): no call of either wrapper or twin. With
    both on, the gates still hold f32 and narrow convs back, and train=True
    routes to neither and stays differentiable."""
    x, t, y = (_t(a) for a in P.inputs(seed=3))
    model = P.port_unet()
    monkeypatch.delenv("VDIFF_FUSED_GN", raising=False)
    monkeypatch.delenv("VDIFF_FUSED_CONV", raising=False)
    with torch.inference_mode():
        base = model(x, t, y)
    assert count_calls == {"gn": 0, "conv": 0}

    monkeypatch.setenv("VDIFF_FUSED_GN", "1")
    monkeypatch.setenv("VDIFF_FUSED_CONV", "1")
    with torch.inference_mode():
        model(x, t, y)
    assert count_calls == {"gn": 41, "conv": 0}  # f32, hid 32: no conv passes JAX's gates
    count_calls.update(gn=0)
    monkeypatch.setattr(U, "fusable", lambda x_, co: True)
    out = model(x, t, y, train=True)
    assert count_calls == {"gn": 0, "conv": 0}
    torch.testing.assert_close(out, base, rtol=1e-5, atol=1e-5)
    out.sum().backward()
    assert all(p.grad is not None for p in model.parameters())


def test_up_blocks_jax_runs_concat_free_keep_conv1_unfused():
    """JAX's `split` gate on the port's static channel counts: an up block with
    a skip input, a 1x1 skip conv and no GroupNorm group across the seam."""
    blk = functools.partial(U.ResidualBlock, embed_dim=64)
    assert blk(512, 256, skip_in_channels=256).concat_free_in_jax
    assert blk(1152, 576, skip_in_channels=576).concat_free_in_jax  # groups of 36
    assert not blk(576, 192, skip_in_channels=192).concat_free_in_jax  # cg 18: 384 % 18
    assert not blk(512, 512, skip_in_channels=256).concat_free_in_jax  # no 1x1 skip conv
    assert not blk(512, 256).concat_free_in_jax                        # no skip input
    assert not blk(512, 256, resampling="upsample", skip_in_channels=256).concat_free_in_jax
    from vdiff_tpu.models.unet import ResidualBlock as JR

    for c1, c2 in ((256, 256), (768, 192), (384, 192), (48, 16), (40, 24)):
        assert blk(c1 + c2, 8, skip_in_channels=c2).concat_free_in_jax == JR._split_ok(c1, c2)


def test_kernel_wrappers_call_no_library_operator():
    """Neither wrapper reaches a library GroupNorm, conv or matmul, or its own
    twin by another name: on a tensor that is not on the CPU they launch their
    kernel or raise. (The conv wrapper names its twin once, for CPU tensors.)"""
    import ast
    import inspect

    banned = {"group_norm", "conv2d", "matmul", "einsum", "scaled_dot_product_attention",
              "compile", "gn_film_silu_kernel_reference", "coefficients"}
    for fn in (G.gn_film_silu_kernel, C3.fused_gn_silu_conv3x3):
        tree = ast.parse(inspect.getsource(fn))
        names = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
        names |= {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
        assert not names & banned, (fn.__name__, names & banned)
        assert "try" not in {type(n).__name__.lower() for n in ast.walk(tree)}


def test_generate_cli_says_which_switches_are_on(monkeypatch):
    from vdiff_tpu_torch.generate import fused_note

    monkeypatch.delenv("VDIFF_FUSED_CONV", raising=False)
    monkeypatch.setenv("VDIFF_FUSED_GN", "1")
    assert fused_note() == "fused inference kernels: VDIFF_FUSED_CONV=off, VDIFF_FUSED_GN=1 (on)"
