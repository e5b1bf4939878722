"""Port sampler (vdiff_tpu_torch.diffusion, ops.numerics' host path) vs the JAX
package on the CPU: step tables, single reverse steps with shared numpy noise,
and a whole 4-step DDIM run of the small UNet from the same x_T."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tests import torch_parity as P  # noqa: E402


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
