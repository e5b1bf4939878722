"""The port's celeba model (multi-tag conditioning, the 'both' head, head dim
32/64 attention) vs the JAX package on the CPU, at a small width.

The small model keeps celeba.json's structure and token counts — 64×64
inputs, ch_mult (1, 2, 3, 4), attention at levels 1-3, 40 multi-hot tags,
the 'both' head (6 output channels) — at hid 64, one residual block a level
and head dim 32. Its attention takes every route of the celeba UNet: pack1
at level 1 (T=1024, N=4, N·C=128) and in up_1_us (T=4096; the kv-chunked
pair when training), the folded q-blocked route at level 2 (T=256, N=6,
N·C=192) and T=64 at level 3. JAX runs XLA attention on the CPU; the port
runs its twins.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tests.torch_parity import perturb  # noqa: E402

CELEBA_SMALL = dict(
    in_channels=3, hid_channels=64, out_channels=6, ch_multipliers=(1, 2, 3, 4),
    num_res_blocks=1, apply_attn=(False, True, True, True), embedding_dim=128,
    drop_rate=0.0, head_dim=32, num_classes=40, multitags=True,
)
RES = 64


@functools.lru_cache(maxsize=None)
def _jax_model():
    from vdiff_tpu.models.unet import UNet

    model = UNet(**CELEBA_SMALL)
    params = jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, RES, RES, 3)), jnp.zeros((1,)),
                                 jnp.zeros((1, 40)))["params"]
    return model, perturb(params, seed=40)


def _port_model():
    from vdiff_tpu_torch.models.convert import flax_params_to_state_dict
    from vdiff_tpu_torch.models.unet import UNet

    _, params = _jax_model()
    model = UNet(**CELEBA_SMALL)
    sd = flax_params_to_state_dict(params, CELEBA_SMALL)
    assert "class_embed.weight" in sd and "class_embed.1.weight" not in sd
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, strict=True)
    return model


def _inputs(B=2, seed=0):
    """x, t and multi-hot tags; the last row is all zeros (the null label)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, RES, RES, 3).astype(np.float32)
    t = rng.rand(B).astype(np.float32)
    y = (rng.rand(B, 40) < 0.3).astype(np.float32)
    y[-1] = 0.0
    return x, t, y


def test_celeba_unet_forward_matches_jax():
    jm, params = _jax_model()
    x, t, y = _inputs()
    apply = jax.jit(lambda x, t, y: jm.apply({"params": params}, x, t, y))
    ref = np.asarray(apply(jnp.asarray(x), jnp.asarray(t), jnp.asarray(y)))
    model = _port_model().eval()
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y)).numpy()
    assert out.shape == (2, RES, RES, 6)
    # f32 through ~40 layers in two frameworks (the CIFAR UNet's bound)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_celeba_unet_train_loss_and_grads_match_jax():
    """value_and_grad of the training loss ('both' head, snr_trunc mse) with
    a CFG keep mask that drops one example's tags, train mode, dropout off."""
    from vdiff_tpu.diffusion import GaussianDiffusion as JaxDiffusion
    from vdiff_tpu.ops.numerics import get_logsnr_schedule as jax_schedule
    from vdiff_tpu_torch.diffusion import GaussianDiffusion
    from vdiff_tpu_torch.models.convert import flax_params_to_state_dict
    from vdiff_tpu_torch.ops.numerics import get_logsnr_schedule

    kw = dict(model_out_type="both", model_var_type="fixed_large", reweight_type="snr_trunc",
              loss_type="mse", p_uncond=0.1)
    x, t, y = _inputs(seed=1)
    x = np.tanh(x)
    noise = np.random.RandomState(2).randn(*x.shape).astype(np.float32)
    y[-1] = y[0]
    keep = np.array([True, False])
    jm, params = _jax_model()
    jd = JaxDiffusion(logsnr_fn=jax_schedule("cosine"), **kw)

    def jloss(params):
        den = lambda x_t, t_, y_: jm.apply({"params": params}, x_t, t_, y_, train=True)
        return jd.train_loss(den, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y * keep[:, None]),
                             jnp.asarray(noise)).mean()

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(params)
    ref_sd = flax_params_to_state_dict(jax.tree.map(np.asarray, ref_grads), CELEBA_SMALL)

    model = _port_model()
    td = GaussianDiffusion(logsnr_fn=get_logsnr_schedule("cosine"), **kw)
    den = lambda x_t, t_, y_: model(x_t, t_, y_, train=True)
    loss = td.train_loss(den, *(torch.from_numpy(a) for a in (x, t, y, noise)),
                         keep=torch.from_numpy(keep)).mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert grads.keys() == ref_sd.keys()
    scale = max(np.abs(g).max() for g in ref_sd.values())
    for k, g in grads.items():
        # relative to the largest gradient of the model, as the CIFAR step's
        np.testing.assert_allclose(g.numpy(), ref_sd[k], rtol=1e-4, atol=1e-5 * scale, err_msg=k)


def test_celeba_train_step_runs_with_multitag_labels():
    """The port's train step (loss, backward, clip, AdamW, EMA) on the small
    model with multi-hot tags and its own draws: a finite loss, and the
    update moves the tag embedding."""
    from vdiff_tpu_torch.diffusion import GaussianDiffusion
    from vdiff_tpu_torch.ops.numerics import get_logsnr_schedule
    from vdiff_tpu_torch.train_lib import Optimizer, make_train_step

    model = _port_model()
    ema = _port_model().requires_grad_(False)
    d = GaussianDiffusion(logsnr_fn=get_logsnr_schedule("cosine"), model_out_type="both",
                          model_var_type="fixed_large", reweight_type="snr_trunc",
                          loss_type="mse", p_uncond=0.5)
    opt = Optimizer(model.parameters(), lr=1e-3, warmup=0)
    step = make_train_step(model, d, opt, 0, use_cfg=True, ema_model=ema)
    x, _, y = _inputs(B=4, seed=3)
    before = model.class_embed.weight.detach().clone()
    loss = step(torch.from_numpy(np.tanh(x)), torch.from_numpy(y), 0, 0)
    assert np.isfinite(loss.item())
    assert not torch.equal(model.class_embed.weight.detach(), before)


def test_celeba_config_builds_the_301m_model():
    """celeba.json through the port's loader: heads of 64 (N = 6/9/12), the
    'both' head, a bare tag embedding; 301,377,222 parameters, bench.py's
    model. Configs that name no head_dim keep the defaults' num_heads=1."""
    from vdiff_tpu_torch.factory import CONFIG_DIR, build_unet, load_experiment_config

    cfg, _ = load_experiment_config(f"{CONFIG_DIR}/celeba.json")
    assert cfg["model"]["head_dim"] == 64 and cfg["model"]["num_heads"] is None
    with torch.device("meta"):
        model = build_unet(cfg["model"], in_channels=3, model_out_type="both", num_classes=40,
                           multitags=True)
    assert sum(p.numel() for p in model.parameters()) == 301_377_222
    assert [m.num_heads for name, m in model.named_modules() if name.endswith("downsamples.level_1.0.1")] == [6]
    cifar, _ = load_experiment_config(f"{CONFIG_DIR}/cifar10_cond.json")
    assert cifar["model"]["num_heads"] == 1 and "head_dim" not in cifar["model"]


def test_heads_from_head_dim_are_announced_and_one_head_checkpoints_refused():
    """The CLIs print the head counts celeba.json gets and the JAX CLIs'
    one-head divergence (ROADMAP C4); a one-head checkpoint, as the JAX CLIs
    train from the same file, is refused by name, and a matching one loads."""
    from vdiff_tpu_torch.factory import CONFIG_DIR, heads_note, load_experiment_config, load_weights
    from vdiff_tpu_torch.models.unet import UNet

    cfg, _ = load_experiment_config(f"{CONFIG_DIR}/celeba.json")
    note = heads_note(cfg["model"])
    assert "[6, 9, 12] heads" in note and "ROADMAP C4" in note
    cifar, _ = load_experiment_config(f"{CONFIG_DIR}/cifar10_cond.json")
    assert heads_note(cifar["model"]) is None

    gen = torch.Generator().manual_seed(0)
    model = UNet(**CELEBA_SMALL, generator=gen)
    one_head = UNet(**dict(CELEBA_SMALL, num_heads=1), generator=gen)
    with pytest.raises(ValueError, match="ROADMAP C4"):
        load_weights(model, one_head.state_dict())
    twin = UNet(**CELEBA_SMALL, generator=gen)
    load_weights(model, twin.state_dict())
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                  twin.state_dict().values()))


def test_trainer_multitag_labels():
    """sample_labels draws n tag rows of the training set; sample_fn without
    a label gives a conditional model the all-zeros null tags."""
    from vdiff_tpu_torch.data import ArrayDataset, DataLoader
    from vdiff_tpu_torch.diffusion import GaussianDiffusion
    from vdiff_tpu_torch.ops.numerics import get_logsnr_schedule
    from vdiff_tpu_torch.train_lib import Trainer

    rng = np.random.RandomState(4)
    targets = (rng.rand(10, 40) < 0.5).astype(np.float32)
    ds = ArrayDataset(np.zeros((10, RES, RES, 3), np.uint8), targets)
    d = GaussianDiffusion(logsnr_fn=get_logsnr_schedule("cosine"), model_out_type="both",
                          sample_timesteps=2)
    tr = Trainer(_port_model(), d, 0, 1, DataLoader(ds, 2), use_cfg=True, num_save_images=5,
                 shape=(RES, RES, 3), device="cpu", seed=9)
    labels = tr.sample_labels()
    assert labels.shape == (5, 40) and labels.dtype == np.float32
    assert all(any((row == t).all() for t in targets) for row in labels)
    np.testing.assert_array_equal(labels, tr.sample_labels())  # seeded
    np.testing.assert_array_equal(tr._dummy_label(3), np.zeros((3, 40), np.float32))
    x = tr.sample_fn(batch_size=2, use_ddim=True)
    assert x.shape == (2, RES, RES, 3) and np.isfinite(x).all()
