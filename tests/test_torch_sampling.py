"""Port sampler (vdiff_tpu_torch.diffusion, ops.numerics' host path) vs the JAX
package on the CPU: step tables, single reverse steps with shared numpy noise,
whole DDIM runs of the small UNet from the same x_T (p_sample and
p_sample_progressive), the step a CUDA graph captures run eagerly against the
eager loop, and the generate CLI's --progressive strips."""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tests import torch_parity as P  # noqa: E402

pytest_plugins = ["torch_limits"]


def _pair(**kw):
    """The same GaussianDiffusion in both packages."""
    from vdiff_tpu.diffusion import GaussianDiffusion as JaxDiffusion
    from vdiff_tpu.ops.numerics import get_logsnr_schedule as jax_schedule
    from vdiff_tpu_torch.diffusion import GaussianDiffusion
    from vdiff_tpu_torch.ops.numerics import get_logsnr_schedule

    sched = kw.pop("schedule", ("cosine", False))
    args = dict(sample_timesteps=16, model_out_type="v", model_var_type="fixed_medium",
                intp_frac=0.3, w_guide=0.0)
    args.update(kw)
    jd = JaxDiffusion(logsnr_fn=jax_schedule(sched[0], rescale=sched[1]), **args)
    td = GaussianDiffusion(logsnr_fn=get_logsnr_schedule(sched[0], rescale=sched[1]), **args)
    return jd, td


TABLE_CASES = [
    dict(use_ddim=True),
    dict(use_ddim=False),
    dict(use_ddim=True, eta=0.5),
    dict(use_ddim=True, eta=1.0),
    dict(use_ddim=False, model_var_type="learned"),
    dict(use_ddim=False, schedule=("legacy", False), model_out_type="eps",
         model_var_type="fixed_large"),
    dict(use_ddim=True, schedule=("linear", True), x0eps_coef=True),
    dict(use_ddim=False, schedule=("sigmoid", False), x0eps_coef=True),
]


@pytest.mark.parametrize("case", TABLE_CASES, ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_sample_tables_match_jax(case):
    """Host f64 math, cast to f32 at the end, in both packages: equal to
    rtol 1e-12 (i.e. bit for bit)."""
    case = dict(case)
    use_ddim, eta = case.pop("use_ddim"), case.pop("eta", 0.0)
    jd, td = _pair(**case)
    ref = jd.sample_tables(use_ddim=use_ddim, eta=eta)
    got = td.sample_tables(use_ddim=use_ddim, eta=eta)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == np.float32, k
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=1e-12, atol=0, err_msg=k)


def _denoiser(xp, out_channels_mult):
    """The same smooth stand-in for a UNet in numpy-like namespace ``xp``."""

    def fn(x, t, y):
        out = xp.tanh(0.7 * x + 0.3 * t.reshape(-1, 1, 1, 1))
        if y is not None:
            out = out + 0.05 * y.reshape(-1, 1, 1, 1)
        if out_channels_mult == 2:
            out = (jnp.concatenate if xp is jnp else torch.cat)([out, 0.5 * out - 0.2], -1)
        return out

    return fn


STEP_CASES = [  # (model_out_type, model_var_type, x0eps_coef, clip_denoised)
    ("v", "fixed_medium", False, True),
    ("eps", "fixed_large", False, True),
    ("eps", "learned", False, True),
    ("both", "fixed_small", False, False),
    ("x0", "fixed_large", True, True),
    ("eps", "fixed_large", True, False),
]


@pytest.mark.parametrize("cfg", [False, True], ids=["nocfg", "cfg"])
@pytest.mark.parametrize("use_ddim", [False, True], ids=["ancestral", "ddim"])
@pytest.mark.parametrize("case", STEP_CASES, ids=lambda c: "-".join(map(str, c)))
def test_p_sample_step_matches_jax(case, use_ddim, cfg):
    out_type, var_type, x0eps, clip = case
    jd, td = _pair(model_out_type=out_type, model_var_type=var_type, x0eps_coef=x0eps,
                   w_guide=0.1 if cfg else 0.0)
    mult = 2 if out_type == "both" or var_type == "learned" else 1
    rng = np.random.RandomState(5)
    x = rng.randn(3, 4, 4, 3).astype(np.float32)
    y = np.array([1.0, 4.0, 0.0], np.float32) if cfg else None
    noise = None if use_ddim else rng.randn(3, 4, 4, 3).astype(np.float32)
    ref_tab = jd.sample_tables(use_ddim=use_ddim)
    got_tab = {k: torch.from_numpy(v) for k, v in td.sample_tables(use_ddim=use_ddim).items()}
    for i in (0, 7, 15):  # first step, a middle one, and the last (nonzero = 0)
        ref = jd._p_sample_step(
            _denoiser(jnp, mult), jnp.asarray(x), {k: v[i] for k, v in ref_tab.items()},
            None if y is None else jnp.asarray(y), None if noise is None else jnp.asarray(noise),
            clip_denoised=clip, use_ddim=use_ddim)
        got = td._p_sample_step(
            _denoiser(torch, mult), torch.from_numpy(x), {k: v[i] for k, v in got_tab.items()},
            None if y is None else torch.from_numpy(y),
            None if noise is None else torch.from_numpy(noise),
            clip_denoised=clip, use_ddim=use_ddim)
        # (sample, pred_x0): f32 elementwise math; unclipped x̂_0 reaches ~1e3
        # at λ=-20, so the bound scales with the output's magnitude
        for g, r in zip(got, ref):
            r = np.asarray(r)
            np.testing.assert_allclose(g.numpy(), r, rtol=1e-5,
                                       atol=1e-5 * max(1.0, np.abs(r).max()))


@pytest.mark.parametrize("w_guide", [0.0, 0.1])
def test_ddim_p_sample_matches_jax(w_guide):
    """Four deterministic DDIM steps of the small UNet from the same x_T;
    f32 UNet round-off (see test_torch_unet) carried through four steps."""
    jd, td = _pair(sample_timesteps=4, w_guide=w_guide)
    model, params = P.jax_unet()
    x, _, _ = P.inputs(B=2, seed=4)
    y = np.array([3.0, 7.0], np.float32)
    ref = jax.jit(lambda x_T, y: jd.p_sample(
        lambda a, b, c: model.apply({"params": params}, a, b, c), x_T.shape,
        jax.random.key(0), noise=x_T, label=y, use_ddim=True))(jnp.asarray(x), jnp.asarray(y))
    port = P.port_unet()
    with torch.inference_mode():
        got = td.p_sample(port, torch.from_numpy(x), label=torch.from_numpy(y), use_ddim=True)
    assert np.abs(np.asarray(ref) - x).max() > 0.1  # the sampler moved
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_p_sample_needs_a_generator_unless_deterministic():
    _, td = _pair(sample_timesteps=2)
    x = torch.zeros(1, 4, 4, 3)
    den = _denoiser(torch, 1)
    with pytest.raises(ValueError, match="Generator"):
        td.p_sample(den, x, use_ddim=False)
    a = td.p_sample(den, x, use_ddim=False, generator=torch.Generator().manual_seed(0))
    b = td.p_sample(den, x, use_ddim=False, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(td.p_sample(den, x, use_ddim=True), td.p_sample(den, x, use_ddim=True))


@pytest.mark.parametrize("name", ["pred_x0_from_eps", "pred_x0_from_x0eps", "pred_eps_from_x0",
                                  "pred_v_from_x0eps", "pred_v_from_x0", "pred_x0_from_v",
                                  "pred_eps_from_v"])
def test_pred_conversions_match_jax(name):
    from vdiff_tpu.ops import numerics as JN
    from vdiff_tpu_torch.ops import numerics as N

    rng = np.random.RandomState(2)
    a = rng.randn(3, 4, 4, 6 if name == "pred_x0_from_x0eps" else 3).astype(np.float32)
    b = rng.randn(3, 4, 4, 3).astype(np.float32)
    lam = rng.uniform(-8, 8, (3, 1, 1, 1)).astype(np.float32)
    args = (b, a, lam) if name == "pred_x0_from_x0eps" else (a, b, lam)
    ref = getattr(JN, name)(*(jnp.asarray(v) for v in args))
    got = getattr(N, name)(*(torch.from_numpy(v) for v in args))
    # f32 elementwise; exp(±λ/2) reaches ~55 at |λ|=8
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T,pred_freq", [(8, 4), (10, 4)], ids=["T8-f4", "T10-f4-head2"])
def test_p_sample_progressive_matches_jax(T, pred_freq):
    """DDIM η=0 of the small UNet from the same x_T: the final sample and the
    L = T // pred_freq snapshots of x̂_0, the most denoised first, against
    JAX's; with T % pred_freq = 2, the two leading steps take none. The
    p_sample bound (f32 UNet round-off over the steps)."""
    jd, td = _pair(sample_timesteps=T, w_guide=0.1)
    model, params = P.jax_unet()
    x, _, _ = P.inputs(B=2, seed=9)
    y = np.array([3.0, 7.0], np.float32)
    ref_x, ref_snaps = jax.jit(lambda x_T, y: jd.p_sample_progressive(
        lambda a, b, c: model.apply({"params": params}, a, b, c), x_T.shape,
        jax.random.key(0), noise=x_T, label=y, use_ddim=True, pred_freq=pred_freq))(
        jnp.asarray(x), jnp.asarray(y))
    port = P.port_unet()
    stats = {}
    got_x, got_snaps = td.p_sample_progressive(port, torch.from_numpy(x), label=torch.from_numpy(y),
                                               use_ddim=True, pred_freq=pred_freq, stats=stats)
    assert got_snaps.shape == (T // pred_freq, 2, 32, 32, 3) == ref_snaps.shape
    np.testing.assert_allclose(got_x.numpy(), np.asarray(ref_x), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_snaps.numpy(), np.asarray(ref_snaps), rtol=1e-4, atol=1e-4)
    # most denoised first: the last snapshot is the first step's x̂_0, and
    # each snapshot sits nearer the final sample than the one after it
    dist = [np.abs(s - got_x.numpy()).mean() for s in got_snaps.numpy()]
    assert dist == sorted(dist) and dist[-1] > dist[0]
    assert stats["eager_steps"] == T and stats["captures"] == stats["replays"] == 0
    np.testing.assert_array_equal(got_x.numpy(), td.p_sample(
        port, torch.from_numpy(x), label=torch.from_numpy(y), use_ddim=True).numpy())


SAMPLER_MODES = [dict(use_ddim=True, eta=0.0), dict(use_ddim=True, eta=1.0), dict(use_ddim=False)]


@pytest.mark.parametrize("mode", SAMPLER_MODES, ids=["ddim-eta0", "ddim-eta1", "ancestral"])
def test_static_step_equals_the_eager_loop_bit_for_bit(mode):
    """The step a CUDA graph captures (diffusion.StaticStep: fixed buffers,
    the table row picked on the device, noise drawn into a buffer), run
    eagerly on the CPU for all T steps, gives the eager loop's sample bit for
    bit, CFG on, from one generator seed; so do its x̂_0 at every step."""
    from vdiff_tpu_torch.diffusion import StaticStep

    T = 4
    _, td = _pair(sample_timesteps=T, w_guide=0.1)
    port = P.port_unet()
    x, _, _ = P.inputs(B=2, seed=6)
    x, y = torch.from_numpy(x), torch.tensor([3.0, 7.0])
    ref_x, ref_preds = td.p_sample_progressive(port, x, label=y, pred_freq=1,
                                               generator=torch.Generator().manual_seed(3), **mode)
    deterministic = mode["use_ddim"] and mode.get("eta") == 0.0
    step = StaticStep(td, port, x, y, td.sample_tables(**mode), deterministic,
                      dict(clip_denoised=True, use_ddim=mode["use_ddim"]))
    gen = torch.Generator().manual_seed(3)
    preds = []
    with torch.inference_mode():
        for _ in range(T):
            step.draw(gen)
            preds.append(step())
    assert int(step.index) == T
    assert torch.equal(step.x, ref_x)
    assert torch.equal(torch.stack(preds[::-1]), ref_preds)
    assert not torch.equal(ref_x, x)
    if not deterministic:  # the noise moved the sample: another seed differs
        other = td.p_sample(port, x, label=y, generator=torch.Generator().manual_seed(4), **mode)
        assert not torch.equal(other, ref_x)


def test_p_sample_stats_add_up_on_the_cpu():
    """The CPU runs the eager loop: T eager steps, no capture, and no kernel
    launch (the wrappers run their twins), summed over calls."""
    _, td = _pair(sample_timesteps=3)
    stats = {}
    for _ in range(2):
        td.p_sample(_denoiser(torch, 1), torch.zeros(1, 4, 4, 3), use_ddim=True, stats=stats)
    assert stats["eager_steps"] == 6 and stats["captures"] == stats["replays"] == 0
    assert set(stats["launches"]) >= {"attn_fwd_online", "gn_film_silu_kernel"}
    assert not any(stats["launches"].values())
    assert stats["captured_launches"] == stats["replayed_launches"] == {}


def test_generate_progressive_writes_the_snapshot_strips(tmp_path):
    """``generate --progressive`` on the CPU writes one 32×(32·L) strip per
    sample (L = 4 // 2), and the strips are the concatenated x̂_0 snapshots
    of the same x_T, labels and weights, as PNG pixels."""
    Image = pytest.importorskip("PIL.Image")
    from tests.test_torch_convert import _tiny_setup
    from vdiff_tpu_torch.data import DATA_INFO
    from vdiff_tpu_torch.factory import build_diffusion, load_experiment_config
    from vdiff_tpu_torch.generate import main, make_label_stream

    cfg_path, ckpt = _tiny_setup(tmp_path)
    summary = main(["--config-path", cfg_path, "--ckpt-path", ckpt, "--save-dir", str(tmp_path),
                    "--device", "cpu", "--use-ema", "--use-ddim", "--sample-timesteps", "4",
                    "--progressive", "--pred-freq", "2", "--batch-size", "2", "--total-size", "2",
                    "--seed", "5"])
    strips = []
    for name in sorted(os.listdir(summary["save_dir"])):
        if name.endswith(".png"):
            with Image.open(os.path.join(summary["save_dir"], name)) as im:
                strips.append(np.asarray(im))
    assert summary["images"] == len(strips) == 2 and summary["finite"]
    assert all(s.shape == (32, 64, 3) for s in strips)

    cfg, _ = load_experiment_config(cfg_path)
    diffusion, _ = build_diffusion(cfg["diffusion"], w_guide=0.1, sample_timesteps=4,
                                   continuous_gate=False)
    gen = torch.Generator().manual_seed(5)
    x_T = torch.randn((2, 32, 32, 3), generator=gen)
    y = torch.as_tensor(make_label_stream(DATA_INFO["cifar10"], True, False, 5)(2))
    _, snaps = diffusion.p_sample_progressive(P.port_unet(), x_T, label=y, use_ddim=True,
                                              pred_freq=2, generator=gen)
    want = np.clip(torch.cat(list(snaps), dim=2).numpy() * 127.5 + 127.5, 0, 255).astype(np.uint8)
    key = lambda a: a.tobytes()
    assert sorted(map(key, strips)) == sorted(map(key, want))
