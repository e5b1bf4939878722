"""Shared fixtures of the port's parity tests: one small UNet configuration,
its JAX params (every constant leaf perturbed, so zero-init layers and biases
all carry signal) and the port UNet loaded with the same weights; and a stub
of the kernel library for tests that drive the launch path on the meta
device."""

import functools

import numpy as np

# hid 32 with one head of width 32; 32×32 inputs give attention at T=256 and
# T=64, and at T=1024 in the up-resample block of level 1 — the flagship's
# three token counts.
SMALL = dict(
    in_channels=3, hid_channels=32, out_channels=3, ch_multipliers=(1, 1, 1),
    num_res_blocks=1, apply_attn=(False, True, True), drop_rate=0.0, num_heads=1,
    num_classes=10,
)
RES = 32


def perturb(params, seed=0):
    """Add N(0, 0.05) noise to every leaf that is constant (zero-init
    kernels and biases, unit GroupNorm scales)."""
    import jax

    rng = np.random.RandomState(seed)

    def f(a):
        a = np.asarray(a)
        if np.all(a == a.flat[0]):
            a = a + rng.normal(0.0, 0.05, a.shape).astype(a.dtype)
        return a

    return jax.tree.map(f, params)


@functools.lru_cache(maxsize=None)
def jax_unet(num_res_blocks=1, out_channels=3, dtype_name="float32"):
    """(JAX UNet, perturbed params as numpy) for SMALL with the overrides."""
    import jax
    import jax.numpy as jnp

    from vdiff_tpu.models.unet import UNet

    cfg = dict(SMALL, num_res_blocks=num_res_blocks, out_channels=out_channels)
    dtype = None if dtype_name == "float32" else jnp.dtype(dtype_name)
    model = UNet(dtype=dtype, **cfg)
    x = jnp.zeros((1, RES, RES, 3))
    params = model.init(jax.random.key(0), x, jnp.zeros((1,)), jnp.ones((1,)))["params"]
    return model, perturb(params, seed=num_res_blocks)


@functools.lru_cache(maxsize=None)
def jax_apply(num_res_blocks=1, out_channels=3, dtype_name="float32"):
    """Jitted forward of :func:`jax_unet`: (x, t, y) numpy → numpy."""
    import jax

    model, params = jax_unet(num_res_blocks, out_channels, dtype_name)
    fn = jax.jit(lambda x, t, y: model.apply({"params": params}, x, t, y))
    return lambda x, t, y: np.asarray(fn(x, t, y))


def port_unet(num_res_blocks=1, out_channels=3, dtype_name="float32"):
    """The port UNet with :func:`jax_unet`'s weights (via
    flax_params_to_state_dict, strict load)."""
    import torch

    from vdiff_tpu_torch.models.convert import flax_params_to_state_dict
    from vdiff_tpu_torch.models.unet import UNet

    cfg = dict(SMALL, num_res_blocks=num_res_blocks, out_channels=out_channels)
    _, params = jax_unet(num_res_blocks, out_channels, dtype_name)
    model = UNet(dtype=getattr(torch, dtype_name), **cfg)
    sd = flax_params_to_state_dict(params, cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return model.eval()


def inputs(B=2, seed=0):
    """x (B, 32, 32, 3), t (B,), labels (B,) with the null class 0 included."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, RES, RES, 3).astype(np.float32)
    t = rng.rand(B).astype(np.float32)
    y = np.arange(B, dtype=np.float32) % (SMALL["num_classes"] + 1)
    return x, t, y


class StubLibrary:
    """Stands in for the kernel library: every launch succeeds and does
    nothing; the *_max_t queries allow any T."""

    def __getattr__(self, name):
        return (lambda *a: 1 << 20) if name.endswith("_max_t") else (lambda *a: 0)
