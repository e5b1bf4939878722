"""The port's one-kernel GroupNorm(+FiLM)(+SiLU) (vdiff_tpu_torch.ops.groupnorm:
gn_film_silu_kernel, its twin and the dispatch) vs the JAX package's Pallas
kernel run in interpret mode on the CPU, same numpy inputs."""

import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from vdiff_tpu_torch.ops import groupnorm as G  # noqa: E402

pytest_plugins = ["torch_limits"]


def _inputs(B=2, H=8, W=8, C=128, seed=0, film=True):
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, H, W, C) * 2 + 0.5).astype(np.float32)
    gamma = (rng.randn(C) * 0.1 + 1.0).astype(np.float32)
    beta = (rng.randn(C) * 0.1).astype(np.float32)
    shift = (rng.randn(B, C) * 0.2).astype(np.float32) if film else None
    scale = (rng.randn(B, C) * 0.2).astype(np.float32) if film else None
    return x, gamma, beta, shift, scale


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("C", [128, 192, 576, 1344, 1536])
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("film", [False, True])
def test_twin_matches_the_pallas_kernel_in_interpret_mode(film, silu, C):
    """f32 on both sides: the same single-pass statistics and f32 coefficients;
    the Pallas kernel folds groups with one-hot matmuls and the twin with a
    reshape, so only the order of the sums differs (C=192: groups of 6;
    celeba's widths 576, 1344, 1536: groups of 18, 42, 48)."""
    from jax.experimental.pallas import tpu as pltpu

    from vdiff_tpu.ops.groupnorm import gn_film_silu_pallas

    x, gamma, beta, shift, scale = _inputs(C=C, seed=C + 2 * film + silu, film=film)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(gn_film_silu_pallas(_j(x), _j(gamma), _j(beta), _j(shift), _j(scale),
                                             apply_silu=silu))
    out = G.gn_film_silu_kernel_reference(_t(x), _t(gamma), _t(beta), _t(shift), _t(scale),
                                          apply_silu=silu)
    assert out.dtype == torch.float32 and out.shape == x.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("groups,C", [(32, 1344), (4, 24), (32, 32)])
def test_twin_takes_any_group_width(groups, C):
    """No power-of-two or lane-tile assumption: groups of 42, 6 and 1
    channels against torch's own group_norm (two-pass variance; randn inputs
    keep the two formulas within f32 round-off)."""
    x, gamma, beta, _, _ = _inputs(B=2, H=4, W=6, C=C, seed=groups, film=False)
    out = G.gn_film_silu_kernel_reference(_t(x), _t(gamma), _t(beta), num_groups=groups,
                                          apply_silu=False)
    ref = torch.nn.functional.group_norm(_t(x).permute(0, 3, 1, 2), groups, _t(gamma), _t(beta),
                                         1e-6).permute(0, 2, 3, 1)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


def test_bf16_twin_keeps_f32_coefficients_and_rounds_once():
    """bf16 in → bf16 out, equal to the f32 twin on the same bf16 values
    rounded once; the default chain rounds A, B, the multiply-add and the SiLU
    and so differs from it by construction."""
    x, gamma, beta, shift, scale = _inputs(seed=5)
    xb, sb, cb = (_t(a).bfloat16() for a in (x, shift, scale))
    out = G.gn_film_silu_kernel_reference(xb, _t(gamma), _t(beta), sb, cb)
    assert out.dtype == torch.bfloat16
    ref = G.gn_film_silu_kernel_reference(xb.float(), _t(gamma), _t(beta), sb.float(), cb.float())
    torch.testing.assert_close(out, ref.bfloat16(), rtol=0, atol=0)
    chain = G.gn_film_silu(xb, _t(gamma), _t(beta), sb, cb, use_kernel=False)
    assert not torch.equal(chain, out)
    # four bf16 roundings of the chain against one, at |y| up to ~8
    torch.testing.assert_close(chain.float(), out.float(), rtol=0,
                               atol=4 * 2 ** -8 * ref.abs().max().item())


def test_dispatch_follows_the_switch_only_without_autograd(monkeypatch):
    """use_kernel=None reads VDIFF_FUSED_GN and takes the one-kernel form only
    when autograd is not recording; on a CPU tensor that form is the twin and
    no launch is counted. Off (the default), the default chain runs."""
    x, gamma, beta, shift, scale = (_t(a) for a in _inputs(seed=6))
    calls = []
    twin = G.gn_film_silu_kernel_reference
    monkeypatch.setattr(G, "gn_film_silu_kernel_reference",
                        lambda *a, **k: calls.append(1) or twin(*a, **k))
    before = G.gn_film_silu_kernel.launches

    monkeypatch.delenv("VDIFF_FUSED_GN", raising=False)
    with torch.no_grad():
        base = G.gn_film_silu(x, gamma, beta, shift, scale)
    assert not calls
    monkeypatch.setenv("VDIFF_FUSED_GN", "1")
    G.gn_film_silu(x, gamma, beta, shift, scale)  # autograd records: the default chain
    assert not calls
    with torch.no_grad():
        out = G.gn_film_silu(x, gamma, beta, shift, scale)
        assert len(calls) == 1
        G.gn_film_silu(x, gamma, beta, shift, scale, use_kernel=False)
        assert len(calls) == 1
    with torch.inference_mode():
        G.gn_film_silu(x, gamma, beta, shift, scale)
    assert len(calls) == 2
    torch.testing.assert_close(out, base, rtol=1e-5, atol=1e-5)  # f32: the same math
    assert G.gn_film_silu_kernel.launches == before
    with pytest.raises(RuntimeError, match="inference only"):
        G.gn_film_silu(x, gamma, beta, shift, scale, use_kernel=True)


@pytest.mark.parametrize("bad", ["device", "meta", "dtype", "rank", "groups", "layout", "gamma",
                                 "half_film", "film_shape", "film_dtype", "row", "pointer",
                                 "slab"])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(bad, monkeypatch):
    """Each refusal raises before any launch. The kernel's own refusals
    (a pixel's C values not a multiple of 16 bytes, x not on a 16-byte
    boundary, a slab no cluster holds) are reached with the device check
    stubbed and a library that fails the test if it is called."""
    from vdiff_tpu_torch import kernels

    x, gamma, beta, shift, scale = (_t(a) for a in _inputs(B=2, H=4, W=4, C=64, seed=7))
    kw, err = {}, ValueError
    if bad in ("row", "pointer", "slab"):
        monkeypatch.setattr(G, "need_cuda", lambda *a: None)
        monkeypatch.setattr(kernels, "library", lambda: pytest.fail("launched"))
    if bad == "device":  # a CPU tensor: the wrapper is the kernel alone
        err = RuntimeError
    elif bad == "meta":
        x, gamma, beta, shift, scale = (a.to("meta") for a in (x, gamma, beta, shift, scale))
        err = RuntimeError
    elif bad == "dtype":
        x, err = x.half(), TypeError
    elif bad == "rank":
        x = x[0]
    elif bad == "groups":
        kw = {"num_groups": 48}
    elif bad == "layout":  # an NCHW-contiguous tensor viewed as NHWC: no silent copy
        x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    elif bad == "gamma":
        gamma = gamma[:32]
    elif bad == "half_film":
        scale = None
    elif bad == "film_shape":
        shift, scale = shift[:1], scale[:1]
    elif bad == "film_dtype":
        shift, scale = shift.half(), scale.half()
    elif bad == "row":  # 36 bf16 channels: 72 bytes a pixel
        x, gamma, beta = x[..., :36].bfloat16().contiguous(), gamma[:36], beta[:36]
        shift, scale, kw = None, None, {"num_groups": 6}
    elif bad == "pointer":  # contiguous, but 4 bytes past a 16-byte boundary
        x = torch.empty(x.numel() + 1)[1:].view(x.shape).copy_(x)
        assert x.is_contiguous() and x.data_ptr() % 16 == 4
    else:  # a 256x256 bf16 sample of 576 channels: 590 KB slabs
        x = torch.empty(1, 256, 256, 576, device="meta", dtype=torch.bfloat16)
        gamma, beta = torch.ones(576), torch.zeros(576)
        shift = scale = None
    with pytest.raises(err):
        G.gn_film_silu_kernel(x, gamma, beta, shift, scale, **kw)
    if bad not in ("device", "meta", "row", "pointer", "slab"):  # the twin checks the same input
        with pytest.raises(err):
            G.gn_film_silu_kernel_reference(x, gamma, beta, shift, scale, **kw)


def test_kernel_wrapper_passes_strided_film_rows_and_counts_its_launch(monkeypatch):
    """On the launch path (meta tensors into a stub library): the FiLM halves
    of one (B, 2C) projection go in as they are, with their row stride and
    type flag, x is not copied, and the call counts one launch."""
    from vdiff_tpu_torch import kernels

    seen = {}

    class Stub:
        def vdiff_gn_film_silu(self, *args):
            seen["args"] = args
            return 0

    monkeypatch.setattr(kernels, "library", lambda: Stub())
    monkeypatch.setattr(G, "need_cuda", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(G.gn_film_silu_kernel, "launches", 0)
    B, H, W, C = 2, 4, 4, 192
    x = torch.empty(B, C, H, W, device="meta", dtype=torch.bfloat16,
                    memory_format=torch.channels_last).permute(0, 2, 3, 1)
    gamma, beta = torch.empty(C, device="meta"), torch.empty(C, device="meta")
    shift, scale = torch.empty(B, 2 * C, device="meta", dtype=torch.bfloat16).chunk(2, dim=-1)
    out = G.gn_film_silu_kernel(x, gamma, beta, shift, scale, apply_silu=False)
    assert out.shape == (B, H, W, C) and out.dtype == torch.bfloat16 and out.is_contiguous()
    assert G.gn_film_silu_kernel.launches == 1
    args = seen["args"]
    # film_stride, film_f32 | B, HW, C, G | apply_silu, is_bf16 | the plan
    assert args[5:7] == (2 * C, 0) and args[8:12] == (B, H * W, C, 32) and args[13:15] == (0, 1)
    assert args[12] == pytest.approx(1e-6)
    plan = G.gn_plan(H, W, C, 32, torch.bfloat16)
    assert args[15:19] == (plan.groups, plan.ranks, plan.pixels, plan.threads) == (8, 1, 16, 64)
