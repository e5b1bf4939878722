"""``UNet(resample_with_res=False)`` of the port against JAX's on the CPU: the
forward, the training loss and its gradients, the reference key layout of the
bare resampling convs, and both converters on those keys."""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tests import torch_parity as P  # noqa: E402

pytest_plugins = ["torch_limits"]

CFG = dict(P.SMALL, resample_with_res=False)
KW = dict(model_out_type="eps", reweight_type="snr_trunc", loss_type="mse", p_uncond=0.1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@functools.lru_cache(maxsize=None)
def _jax_unet():
    """(JAX UNet with strided-conv resampling, perturbed params as numpy)."""
    from vdiff_tpu.models.unet import UNet

    model = UNet(**CFG)
    x = jnp.zeros((1, 8, 8, 3))
    params = jax.jit(model.init)(jax.random.key(1), x, jnp.zeros((1,)), jnp.ones((1,)))["params"]
    return model, P.perturb(params, seed=7)


def _port_unet():
    from vdiff_tpu_torch.models.convert import flax_params_to_state_dict
    from vdiff_tpu_torch.models.unet import UNet

    model = UNet(**CFG)
    sd = flax_params_to_state_dict(_jax_unet()[1], CFG)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return model


def test_keys_follow_the_reference_layout():
    """The down conv is ``downsamples.level_i.{nres}``, the up conv
    ``upsamples.level_i.{nres+1}.1``; stride 2 with padding 1 halves H."""
    model = _port_unet()
    nres = CFG["num_res_blocks"]
    keys = model.state_dict().keys()
    for i in range(len(CFG["ch_multipliers"])):
        down = f"downsamples.level_{i}.{nres}.weight"
        up = f"upsamples.level_{i}.{nres + 1}.1.weight"
        assert (down in keys) == (i != len(CFG["ch_multipliers"]) - 1)
        assert (up in keys) == (i != 0)
    assert model.downsamples.level_0[nres].stride == (2, 2)
    assert model.downsamples.level_0[nres].padding == (1, 1)
    x = torch.randn(1, 32, 8, 8)
    assert model.downsamples.level_0[nres](x).shape == (1, 32, 4, 4)
    assert model.upsamples.level_1[nres + 1](x).shape == (1, 32, 16, 16)


def test_forward_matches_jax():
    """f32 inference forward, same weights and inputs: 1e-4 of the output's
    scale (the bound of test_torch_unet's forward parity)."""
    jm, params = _jax_unet()
    x, t, y = P.inputs(B=2, seed=3)
    ref = np.asarray(jax.jit(lambda x, t, y: jm.apply({"params": params}, x, t, y))(x, t, y))
    with torch.no_grad():
        out = _port_unet()(_t(x), _t(t), _t(y)).numpy()
    assert out.shape == ref.shape == (2, P.RES, P.RES, 3)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def test_loss_and_grads_match_jax():
    """value_and_grad of the training loss in train mode (dropout off), f32:
    the loss to 1e-5, every gradient to 1e-4 relative with a floor of 1e-5 of
    the largest (test_torch_train_parity's bounds)."""
    from vdiff_tpu.diffusion import GaussianDiffusion as JaxDiffusion
    from vdiff_tpu.ops.numerics import get_logsnr_schedule as jax_schedule
    from vdiff_tpu_torch.diffusion import GaussianDiffusion
    from vdiff_tpu_torch.models.convert import flax_params_to_state_dict
    from vdiff_tpu_torch.ops.numerics import get_logsnr_schedule

    x, t, y = P.inputs(B=2, seed=4)
    noise = np.random.RandomState(8).randn(*x.shape).astype(np.float32)
    jm, params = _jax_unet()
    jd = JaxDiffusion(logsnr_fn=jax_schedule("cosine"), **KW)

    def jloss(params):
        den = lambda x_t, t_, y_: jm.apply({"params": params}, x_t, t_, y_, train=True)
        return jd.train_loss(den, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y),
                             jnp.asarray(noise)).mean()

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(params)
    ref = flax_params_to_state_dict(jax.tree.map(np.asarray, ref_grads), CFG)
    model = _port_unet()
    td = GaussianDiffusion(logsnr_fn=get_logsnr_schedule("cosine"), **KW)
    den = lambda x_t, t_, y_: model(x_t, t_, y_, train=True)
    loss = td.train_loss(den, _t(x), _t(t), _t(y), _t(noise)).mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert grads.keys() == ref.keys()
    scale = max(np.abs(g).max() for g in ref.values())
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref[k], rtol=1e-4, atol=1e-5 * scale, err_msg=k)


def test_converters_round_trip_each_other():
    """The port's state_dict through JAX's ``torch_unet_to_flax`` and back
    through the port's ``flax_params_to_state_dict``, and JAX's params the
    other way round, come back bit for bit."""
    from vdiff_tpu.models.convert import torch_unet_to_flax
    from vdiff_tpu_torch.models.convert import flax_params_to_state_dict
    from vdiff_tpu_torch.models.unet import UNet

    jm, params = _jax_unet()
    sd = UNet(**CFG, generator=torch.Generator().manual_seed(2)).state_dict()
    back = flax_params_to_state_dict(torch_unet_to_flax(sd, jm), CFG)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v.numpy(), err_msg=k)
    again = torch_unet_to_flax(flax_params_to_state_dict(params, CFG), jm)
    flat, ref = (dict(jax.tree_util.tree_leaves_with_path(p)) for p in (again, params))
    assert flat.keys() == ref.keys()
    for k, v in ref.items():
        np.testing.assert_array_equal(np.asarray(flat[k]), np.asarray(v), err_msg=str(k))
