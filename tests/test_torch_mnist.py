"""The port on mnist's model (``configs/mnist.json``: one input channel, hid
64, ch_mult [1, 2, 2], one attention head of 128 at T=256 and T=64, and at
T=1024 in the up-resample block of level 1) vs the JAX package on the CPU,
same weights (``flax_params_to_state_dict``) and numpy inputs; the config's 2
residual blocks are cut to 1 for time, the widths are the config's. Then the
launch counts of the full-width model (2 residual blocks) on the meta device,
the counts chip_smoke.py asserts on the card."""

import functools
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tests import torch_parity as P  # noqa: E402

MNIST = dict(in_channels=1, hid_channels=64, out_channels=1, ch_multipliers=(1, 2, 2),
             num_res_blocks=1, apply_attn=(False, True, True), drop_rate=0.0, num_heads=1,
             num_classes=10)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@functools.lru_cache(maxsize=None)
def _params():
    """Perturbed JAX params of MNIST: a seeded port init read by the JAX
    package's own converter (an init under jit costs ~10 s of compile here)."""
    from vdiff_tpu.models.convert import torch_unet_to_flax
    from vdiff_tpu.models.unet import UNet as JaxUNet
    from vdiff_tpu_torch.models.unet import UNet

    sd = UNet(**MNIST, generator=torch.Generator().manual_seed(0)).state_dict()
    return P.perturb(torch_unet_to_flax(sd, JaxUNet(**MNIST)), seed=3)


@functools.lru_cache(maxsize=None)
def _jax_apply(dtype_name="float32"):
    """JAX's jitted forward of MNIST (x, t, y) → output, train=False."""
    from vdiff_tpu.models.unet import UNet

    model = UNet(dtype=None if dtype_name == "float32" else jnp.dtype(dtype_name), **MNIST)
    return jax.jit(lambda x, t, y: model.apply({"params": _params()}, x, t, y))


def _port_unet(dtype_name="float32"):
    """The port's UNet with :func:`_params`' weights through
    flax_params_to_state_dict, loaded strictly."""
    from vdiff_tpu_torch.models.convert import flax_params_to_state_dict
    from vdiff_tpu_torch.models.unet import UNet

    model = UNet(dtype=getattr(torch, dtype_name), **MNIST)
    sd = flax_params_to_state_dict(_params(), MNIST)
    model.load_state_dict({k: _t(v) for k, v in sd.items()}, strict=True)
    return model.eval()


def _inputs(B=2, seed=0):
    """x (B, 32, 32, 1), t (B,), labels (B,) with the null class 0 included."""
    rng = np.random.RandomState(seed)
    return (rng.randn(B, 32, 32, 1).astype(np.float32), rng.rand(B).astype(np.float32),
            np.arange(B, dtype=np.float32) * 7 % 11)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_mnist_unet_forward_matches_jax(dtype_name):
    """f32: within 1e-4 (test_torch_unet's bound); bf16 (params f32, cast at
    use): within 2^-4 of the output's scale, test_torch_unet's bf16 bound."""
    x, t, y = _inputs()
    ref = np.asarray(_jax_apply(dtype_name)(x, t, y))
    with torch.inference_mode():
        out = _port_unet(dtype_name)(_t(x), _t(t), _t(y))
    assert out.dtype == torch.float32 and out.shape == ref.shape == (2, 32, 32, 1)
    assert np.abs(ref).max() > 0.1  # perturbed weights: not a vacuous comparison
    if dtype_name == "float32":
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=2 ** -4 * np.abs(ref).max())


def test_mnist_ancestral_cfg_steps_match_jax():
    """Four ancestral steps at CFG w=0.1 with mnist.json's diffusion (cosine,
    v, fixed_large) through the port's p_sample (the generate CLI's default
    sampler; its eager loop on the CPU), from the same x_T, against JAX's
    reverse step applied four times with the noise the port's generator
    drew passed in: f32 UNet round-off carried through four steps (the DDIM
    test's bound)."""
    from vdiff_tpu.diffusion import GaussianDiffusion as JaxDiffusion
    from vdiff_tpu.ops.numerics import get_logsnr_schedule as jax_schedule
    from vdiff_tpu_torch.diffusion import GaussianDiffusion
    from vdiff_tpu_torch.ops.numerics import get_logsnr_schedule

    T = 4
    kw = dict(sample_timesteps=T, model_out_type="v", model_var_type="fixed_large",
              w_guide=0.1)
    jd = JaxDiffusion(logsnr_fn=jax_schedule("cosine"), **kw)
    td = GaussianDiffusion(logsnr_fn=get_logsnr_schedule("cosine"), **kw)
    x_T, _, _ = _inputs(seed=4)
    y = np.array([3.0, 10.0], np.float32)
    gen = torch.Generator().manual_seed(11)
    noise = [torch.randn(x_T.shape, generator=gen).numpy() for _ in range(T)]

    table = jd.sample_tables(use_ddim=False)
    ref = jnp.asarray(x_T)
    for i in range(T):  # the step's elementwise math eagerly around the jitted UNet
        ref, _ = jd._p_sample_step(_jax_apply(), ref, {k: v[i] for k, v in table.items()},
                                   jnp.asarray(y), jnp.asarray(noise[i]))
    ref = np.asarray(ref)

    got = td.p_sample(_port_unet(), _t(x_T), label=_t(y), use_ddim=False,
                      generator=torch.Generator().manual_seed(11)).numpy()
    assert np.abs(ref - x_T).max() > 0.1  # the sampler moved
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# launch counts of the full-width mnist model (mnist.json, 2 residual blocks)
# ---------------------------------------------------------------------------

# one forward: 13 attention calls at T <= 512 (6 at T=256, 7 at T=64) and one
# at T=1024 (up_1_us); a train step runs B3/B4 at the 13 and B2/B5 at the one.
# In f32 the forward's T=1024 call is attn_fwd_qblk and each backward pass
# runs once a call; in bf16 B2 and B5 count under attn_fwd_tc / attn_bwd_tc
MNIST_COUNTS = {
    "float32": ({"attn_fwd_online": 13, "attn_fwd_qblk": 1},
                {"attn_fwd_train": 13, "attn_fwd_qblk": 1, "attn_bwd_rows": 14,
                 "attn_bwd_cols": 14}),
    "bfloat16": ({"attn_fwd_online": 13, "attn_fwd_tc": 1},
                 {"attn_fwd_train": 13, "attn_fwd_tc": 1, "attn_bwd": 13, "attn_bwd_tc": 1}),
}
# bf16 inference by (VDIFF_FUSED_GN, VDIFF_FUSED_CONV): (B10, B11). Only the
# 128-channel convs are fusable: conv2 of the 15 residual blocks of levels 1
# and 2 and the middle, and conv1 of the 5 of them that neither resample nor
# take an up-path skip (20); of the 57 GroupNorms (21 residual blocks, 14
# attention blocks, out_norm) 37 stay alone beside them
MNIST_FUSED_COUNTS = {("0", "0"): (0, 0), ("1", "0"): (57, 0), ("1", "1"): (37, 20),
                      ("0", "1"): (0, 20)}


@pytest.fixture
def stub_kernels(monkeypatch):
    """Meta tensors take every wrapper's launch path into a stub library;
    returns a function that reads the nonzero counts and sets all to 0."""
    from vdiff_tpu_torch import kernels
    from vdiff_tpu_torch.models import layers
    from vdiff_tpu_torch.models import unet as U
    from vdiff_tpu_torch.ops import attention as A
    from vdiff_tpu_torch.ops import conv3x3 as C3
    from vdiff_tpu_torch.ops import counted_wrappers
    from vdiff_tpu_torch.ops import groupnorm as G

    monkeypatch.setattr(kernels, "library", P.StubLibrary)
    monkeypatch.setattr(A, "_need_cuda", lambda *a: None)
    monkeypatch.setattr(G, "need_cuda", lambda *a: None)
    monkeypatch.setattr(C3, "need_cuda", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    # the meta device's conv drops channels_last, which cuDNN and the CPU keep
    monkeypatch.setattr(U, "conv2d", lambda x, conv, dt: layers.conv2d(x, conv, dt).contiguous(
        memory_format=torch.channels_last))
    wrappers = counted_wrappers()
    for fn in wrappers.values():
        monkeypatch.setattr(fn, "launches", 0)

    def read():
        counts = {name: fn.launches for name, fn in wrappers.items() if fn.launches}
        for fn in wrappers.values():
            fn.launches = 0
        return counts

    return read


def _full_width(dtype):
    from vdiff_tpu_torch.factory import CONFIG_DIR, build_unet, load_experiment_config

    cfg, _ = load_experiment_config(f"{CONFIG_DIR}/mnist.json")
    assert cfg["model"]["in_channels"] == 1 and cfg["model"]["num_res_blocks"] == 2
    with torch.device("meta"):
        return build_unet(dict(cfg["model"], drop_rate=0.0), in_channels=1,
                          model_out_type=cfg["diffusion"]["model_out_type"], num_classes=10,
                          multitags=False, dtype=dtype)


@pytest.mark.parametrize("dtype_name", sorted(MNIST_COUNTS))
def test_mnist_full_width_launch_counts(stub_kernels, monkeypatch, dtype_name):
    """Head dim 128 routes as JAX routes it (ROADMAP B, "Routes"): B1 at T <=
    512 and B2 above for inference, B3/B2 forward and B4/B5 backward in
    training; in bf16 with the fused switches B10 and B11 as
    MNIST_FUSED_COUNTS, the attention counts unmoved."""
    dtype = getattr(torch, dtype_name)
    model = _full_width(dtype)
    x, t, y = (torch.empty(*s, device="meta") for s in ((2, 32, 32, 1), (2,), (2,)))
    fwd, step = MNIST_COUNTS[dtype_name]
    monkeypatch.delenv("VDIFF_FUSED_GN", raising=False)
    monkeypatch.delenv("VDIFF_FUSED_CONV", raising=False)
    with torch.no_grad():
        assert model(x, t, y).shape == (2, 32, 32, 1)
    assert stub_kernels() == fwd
    model(x, t, y, train=True).float().sum().backward()
    assert stub_kernels() == step
    if dtype_name == "float32":
        return
    for (gn, conv), (n_gn, n_conv) in MNIST_FUSED_COUNTS.items():
        monkeypatch.setenv("VDIFF_FUSED_GN", gn)
        monkeypatch.setenv("VDIFF_FUSED_CONV", conv)
        with torch.no_grad():
            model(x, t, y)
        assert stub_kernels() == {k: v for k, v in dict(
            fwd, gn_film_silu_kernel=n_gn, fused_gn_silu_conv3x3=n_conv).items() if v}


def _write_mnist_idx(root, n, seed=6):
    """MNIST's train idx pair in torchvision's raw layout: n seeded 28x28
    digits and their labels 0-9."""
    import struct

    base = root / "MNIST" / "raw"
    base.mkdir(parents=True)
    rng = np.random.RandomState(seed)
    (base / "train-images-idx3-ubyte").write_bytes(
        struct.pack(">IIII", 2051, n, 28, 28) + rng.randint(0, 256, (n, 28, 28), np.uint8).tobytes())
    (base / "train-labels-idx1-ubyte").write_bytes(
        struct.pack(">II", 2049, n) + rng.randint(0, 10, n).astype(np.uint8).tobytes())


def test_mnist_clis_on_cpu(tmp_path):
    """mnist.json at the test width through both CLIs, as chip_smoke.py runs
    them on the card at full width: the train CLI on a written idx tree (32
    digits resized to 32x32, batch 16: two steps, ckpt_last.pt), then the
    generate CLI's default sampler (ancestral, CFG w=0.1) from that
    checkpoint: one greyscale 32x32 PNG a sample, the sampler's output."""
    import json

    Image = pytest.importorskip("PIL.Image")
    from vdiff_tpu_torch import generate, train
    from vdiff_tpu_torch.factory import CONFIG_DIR

    with open(f"{CONFIG_DIR}/mnist.json") as f:
        cfg = json.load(f)
    cfg["model"].update(hid_channels=32, ch_multipliers=[1, 2], num_res_blocks=1,
                        apply_attn=[False, True])
    cfg_path = tmp_path / "tiny_mnist.json"
    cfg_path.write_text(json.dumps(cfg))
    _write_mnist_idx(tmp_path / "data", 32)
    summary = train.main(["--config-path", str(cfg_path), "--device", "cpu", "--batch-size", "16",
                          "--epochs", "1", "--num-save-images", "0", "--data_root",
                          str(tmp_path / "data"), "--exp-dir", str(tmp_path / "exps")])
    assert summary["steps"] == 2 and np.isfinite(summary["loss"])
    ckpt = f"{summary['ckpt_dir']}/ckpt_last.pt"
    out = generate.main(["--config-path", str(cfg_path), "--ckpt-path", ckpt, "--device", "cpu",
                         "--use-ema", "--sample-timesteps", "3", "--total-size", "3",
                         "--batch-size", "3", "--save-dir", str(tmp_path / "gen")])
    pngs = sorted(p for p in (tmp_path / "gen").rglob("*.png"))
    assert out["images"] == len(pngs) == 3 and out["finite"]
    assert out["stats"]["eager_steps"] == 3  # the CPU runs the ancestral loop
    for p in pngs:
        with Image.open(p) as im:
            assert im.mode == "L" and im.size == (32, 32)
