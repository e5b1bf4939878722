"""The port learns: the twin of tests/test_learning_e2e.py. A tiny port UNet,
started from the JAX test's own initial weights (``model.init`` at key 0,
carried across with ``flax_params_to_state_dict``), trained by the port's
``make_train_step`` with the JAX test's optimizer settings on constant 8x8
images, must lower its loss and then sample near-constant images near the
data's value with the port's DDIM sampler. The draws come from seeded torch
generators, so this compares behaviour with the JAX test, not bits."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

pytest_plugins = ["torch_limits"]

RES = 8
MODE = 0.5  # the one constant-image mode, as in the JAX test
CFG = dict(in_channels=1, hid_channels=32, out_channels=1, ch_multipliers=(1,),
           num_res_blocks=1, apply_attn=(False,), num_heads=1, drop_rate=0.0, num_classes=0)


def test_training_learns_constant_images():
    from vdiff_tpu.models.unet import UNet as JaxUNet
    from vdiff_tpu_torch.diffusion import GaussianDiffusion
    from vdiff_tpu_torch.models.convert import flax_params_to_state_dict
    from vdiff_tpu_torch.models.unet import UNet
    from vdiff_tpu_torch.ops.numerics import get_logsnr_schedule
    from vdiff_tpu_torch.train_lib import Optimizer, make_train_step

    rng = jax.random.key(0)
    params = JaxUNet(use_flash=False, **CFG).init(
        {"params": rng, "dropout": rng}, jnp.zeros((1, RES, RES, 1)), jnp.zeros((1,)), None
    )["params"]
    model = UNet(**CFG)
    sd = flax_params_to_state_dict(jax.tree.map(np.asarray, params), CFG)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)

    diffusion = GaussianDiffusion(
        logsnr_fn=get_logsnr_schedule("cosine"), sample_timesteps=32, model_out_type="eps",
        model_var_type="fixed_large", reweight_type="snr", loss_type="mse", w_guide=0.0,
        p_uncond=0.0)
    opt = Optimizer(model.parameters(), lr=2e-3, warmup=20, grad_norm=1.0)
    step = make_train_step(model.train(), diffusion, opt, timesteps=0)

    x = torch.full((32, RES, RES, 1), MODE)
    losses = [step(x, None, 1, i).item() for i in range(500)]
    assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])

    x_T = torch.randn(16, RES, RES, 1, generator=torch.Generator().manual_seed(2))
    out = diffusion.p_sample(model.eval(), x_T, use_ddim=True).numpy()
    means = out.mean(axis=(1, 2, 3))
    stds = out.std(axis=(1, 2, 3))
    # near-constant images close to the data mode
    assert np.median(np.abs(means - MODE)) < 0.2, means
    assert np.median(stds) < 0.25, stds
