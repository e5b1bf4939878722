"""Port UNet and its layers (vdiff_tpu_torch.models, ops.groupnorm,
ops.numerics' device path) vs the JAX package on the CPU, same weights and
same numpy inputs."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tests import torch_parity as P  # noqa: E402


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("num_res_blocks", [1, 2])
def test_unet_forward_matches_jax_f32(num_res_blocks):
    """f32 end to end; the two frameworks' convs and matmuls sum in other
    orders, so the bound is f32 round-off grown over ~30 layers."""
    x, t, y = P.inputs()
    ref = P.jax_apply(num_res_blocks)(x, t, y)
    with torch.inference_mode():
        out = P.port_unet(num_res_blocks)(_t(x), _t(t), _t(y)).numpy()
    assert out.shape == ref.shape == (2, 32, 32, 3)
    assert np.abs(ref).max() > 0.1  # perturbed weights: not a vacuous comparison
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_unet_forward_matches_jax_bf16():
    """bf16 compute dtype on both sides (params f32, cast at use). The two
    frameworks round at different points, so the bound is a few bf16 ulps of
    the output's scale."""
    x, t, y = P.inputs()
    ref = P.jax_apply(dtype_name="bfloat16")(x, t, y)
    with torch.inference_mode():
        out = P.port_unet(dtype_name="bfloat16")(_t(x), _t(t), _t(y))
    assert out.dtype == torch.float32  # the output conv runs in f32, as Flax promotes it
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=2 ** -4 * scale)


def test_unet_without_labels_matches_jax():
    x, t, _ = P.inputs(seed=1)
    ref = P.jax_apply()(x, t, None)
    with torch.inference_mode():
        out = P.port_unet()(_t(x), _t(t), None).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gn_film_silu_matches_jax_reference(film, dtype):
    from vdiff_tpu.ops.groupnorm import gn_film_silu_reference
    from vdiff_tpu_torch.ops.groupnorm import gn_film_silu

    rng = np.random.RandomState(3)
    x = (rng.randn(2, 8, 8, 64) * 2 + 0.5).astype(np.float32)
    gamma, beta = rng.randn(64).astype(np.float32), rng.randn(64).astype(np.float32)
    shift = rng.randn(2, 64).astype(np.float32) if film else None
    scale = rng.randn(2, 64).astype(np.float32) if film else None
    jx = jnp.asarray(x).astype(dtype)
    ref = gn_film_silu_reference(jx, jnp.asarray(gamma), jnp.asarray(beta),
                                 None if shift is None else jnp.asarray(shift),
                                 None if scale is None else jnp.asarray(scale))
    out = gn_film_silu(_t(x).to(getattr(torch, dtype)), _t(gamma), _t(beta),
                       None if shift is None else _t(shift), None if scale is None else _t(scale))
    assert str(out.dtype) == f"torch.{dtype}"
    ref = np.asarray(ref.astype(jnp.float32))
    # f32: same single-pass statistics; bf16: one rounding each of A, B, x·A+B, silu
    atol = 1e-5 if dtype == "float32" else 4 * 2 ** -8 * np.abs(ref).max()
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=1e-5, atol=atol)


def test_timestep_embedding_matches_jax():
    from vdiff_tpu.ops.numerics import get_timestep_embedding as jax_emb
    from vdiff_tpu_torch.ops.numerics import get_timestep_embedding

    t = np.random.RandomState(0).rand(5).astype(np.float32)
    for dim in (32, 33):
        # sin/cos of arguments up to 1000: f32 argument rounding dominates
        np.testing.assert_allclose(get_timestep_embedding(_t(t), dim).numpy(),
                                   np.asarray(jax_emb(jnp.asarray(t), dim)), atol=2e-4)


def test_layers_match_jax():
    from vdiff_tpu.models import layers as JL
    from vdiff_tpu_torch.models import layers as L

    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    nchw = _t(x).permute(0, 3, 1, 2)
    np.testing.assert_array_equal(L.nearest_upsample(nchw).permute(0, 2, 3, 1).numpy(),
                                  np.asarray(JL.nearest_upsample(jnp.asarray(x))))
    np.testing.assert_allclose(L.avg_pool_2x(nchw).permute(0, 2, 3, 1).numpy(),
                               np.asarray(JL.avg_pool_2x(jnp.asarray(x))), rtol=1e-6)
    y = np.array([0, 1, 10, 3])
    np.testing.assert_array_equal(L.one_hot_exclude_zero(_t(y), 10).numpy(),
                                  np.asarray(JL.one_hot_exclude_zero(jnp.asarray(y), 10)))


def test_lecun_init_law():
    """±2σ-truncated normal times sqrt(scale/fan_in), zero for scale 0."""
    from vdiff_tpu_torch.models.layers import lecun_trunc_normal_

    g = torch.Generator().manual_seed(0)
    w = lecun_trunc_normal_(torch.empty(256, 64, 3, 3), 1.0, g)
    std = (1.0 / (64 * 9)) ** 0.5
    assert float(w.abs().max()) <= 2 * std + 1e-7
    assert abs(float(w.std()) / std - 0.88) < 0.02  # std of N(0,1) truncated at ±2
    assert not bool(lecun_trunc_normal_(torch.ones(3, 3), 0.0).any())


def test_port_init_zeroes_the_output_projections():
    from vdiff_tpu_torch.models.unet import UNet

    m = UNet(**P.SMALL, generator=torch.Generator().manual_seed(0))
    zero = {k for k, v in m.state_dict().items() if k.endswith("weight") and v.ndim > 1
            and not bool(v.any())}
    assert "out_conv.2.weight" in zero and "middle.1.proj_out.weight" in zero
    assert all(k.endswith(("conv2.weight", "proj_out.weight", "out_conv.2.weight")) for k in zero)
    with torch.inference_mode():
        out = m(*(_t(a) for a in P.inputs()))
    assert not bool(out.any())  # zero-init head: the untrained model predicts 0
