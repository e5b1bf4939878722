"""The port's KL / bits-per-dim surface vs the JAX package on the CPU, same
inputs: the density helpers of ``ops/numerics.py``, ``p_mean_var`` (fixed
and learned variance, with and without ``x0eps_coef``), ``_loss_term_bpd``,
``_prior_bpd``, ``calc_all_bpd`` through the small UNet with JAX's per-step
noise fed in, and the ``kl`` training loss.

Tolerances: the elementwise helpers 1e-6 of their scale (f32 transcendental
functions of two libraries); the posterior 1e-5 (a few f32 operations more);
the bound through the UNet 1e-4 (the UNet parity tests' forward bound, summed
over T steps). The decoder's NLL (the first step's term) gets, on top, the
slack of :func:`_decoder_slack`: its bin masses are differences of two CDFs
near 0 or 1, so a tail bin's mass is known only to f32's resolution there,
and -log of it moves by up to ln(2^-20 / 1e-12) per element. So each test
feeds the decoder a model output whose bins resolve (a prediction of x_0
within a few of the decoder's standard deviations) and asserts that the
slack stays below SLACK_SHARE of the term it widens."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tests import torch_parity as P  # noqa: E402

pytest_plugins = ["torch_limits"]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, ref, rtol):
    """rtol, with an absolute floor of rtol times the array's scale."""
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1e-30))


# the CDFs of the two libraries differ by up to 3 f32 ulps of 1 (2^-24 each;
# tanh of two libraries, measured over [-12, 12]); a bin's mass is a
# difference of two, with arguments that carry the inputs' own rounding: each
# mass is held to within 2^-20
MASS_SLACK = 2.0 ** -20
LOG_TOL = 1e-12  # discretized_gaussian_loglik's tol
SLACK_SHARE = 1e-3  # the most of a decoder term that its slack may be


def _decoder_slack(jd, out, x_t, x_0, s, t, clip):
    """Per sample, in bits/dim, how far the decoder's NLL may move when each
    bin mass moves by MASS_SLACK: from JAX's own masses m, the mean over the
    elements of the largest |log(m' + tol) − log(m + tol)| with |m' − m| ≤
    MASS_SLACK. Resolved bins add ~MASS_SLACK/m, tail bins up to ~13.8 nats."""
    from vdiff_tpu.ops import numerics as JN

    (ls, _), (lt, _) = jd.t2logsnr(jnp.asarray(s)), jd.t2logsnr(jnp.asarray(t))
    _, logvar, pred = jd.p_mean_var(jnp.asarray(out), jnp.asarray(x_t), ls, lt, clip)
    ll = np.asarray(JN.discretized_gaussian_loglik(jnp.asarray(x_0), pred, 0.5 * logvar),
                    np.float64)
    m = np.maximum(np.exp(ll) - LOG_TOL, 0.0)
    up = np.log(m + MASS_SLACK + LOG_TOL) - np.log(m + LOG_TOL)
    down = np.log(m + LOG_TOL) - np.log(np.maximum(m - MASS_SLACK, 0.0) + LOG_TOL)
    return np.maximum(up, down).reshape(len(m), -1).mean(1) / np.log(2.0)


def _close_nll(got, ref, rtol, slack):
    """The decoder term: rtol of its scale plus the per-sample slack, which
    the inputs must keep below SLACK_SHARE of the term."""
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert (slack < SLACK_SHARE * np.abs(ref)).all(), (slack, ref)
    err = np.abs(got - ref)
    assert (err <= rtol * np.abs(ref).max() + slack).all(), (got, ref, slack)


def _ideal_out(jd, out_type, x_0, noise, t):
    """What a perfect denoiser outputs for x_t = q_sample(x_0, λ(t), noise):
    the noise, x_0 or v."""
    lt, _ = jd.t2logsnr(jnp.asarray(t))
    a, sd = np.sqrt(jax.nn.sigmoid(lt)), np.sqrt(jax.nn.sigmoid(-lt))
    return np.array({"eps": noise, "x0": x_0, "v": a * noise - sd * x_0}[out_type], np.float32)


def _diffusions(schedule="cosine", **kw):
    """(JAX GaussianDiffusion, the port's) with the same hyperparameters."""
    from vdiff_tpu.diffusion import GaussianDiffusion as JaxDiffusion
    from vdiff_tpu.ops.numerics import get_logsnr_schedule as jax_schedule
    from vdiff_tpu_torch.diffusion import GaussianDiffusion
    from vdiff_tpu_torch.ops.numerics import get_logsnr_schedule

    return (JaxDiffusion(logsnr_fn=jax_schedule(schedule), **kw),
            GaussianDiffusion(logsnr_fn=get_logsnr_schedule(schedule), **kw))


def _images(rng, shape=(3, 8, 8, 3)):
    """x_0 on the 8-bit grid of [-1, 1], its edges included (the decoder's
    cutoffs)."""
    x = rng.randint(0, 256, shape).astype(np.float32) / 127.5 - 1.0
    x.reshape(-1)[:2] = (-1.0, 1.0)
    return x


@pytest.mark.parametrize("name", ["q_mean_var", "normal_kl", "normal_kl_std",
                                  "approx_std_normal_cdf", "discretized_gaussian_loglik"])
def test_density_helpers_match_jax(name):
    from vdiff_tpu.ops import numerics as JN
    from vdiff_tpu_torch.ops import numerics as N

    rng = np.random.RandomState(3)
    x = _images(rng)
    a, b = (rng.randn(*x.shape).astype(np.float32) for _ in range(2))
    lv1, lv2 = (rng.uniform(-6, 1, x.shape).astype(np.float32) for _ in range(2))
    lam = rng.uniform(-10, 10, (3, 1, 1, 1)).astype(np.float32)
    args = {"q_mean_var": (x, lam), "normal_kl": (a, lv1, b, lv2),
            "approx_std_normal_cdf": (3 * a,), "discretized_gaussian_loglik": (x, x + 0.05 * a, lv1)}
    if name == "normal_kl_std":  # against N(0, I), as the prior term calls it
        ref = JN.normal_kl(jnp.asarray(a), jnp.asarray(lv1), 0.0, 0.0)
        got = N.normal_kl(_t(a), _t(lv1), 0.0, 0.0)
    else:
        ref = getattr(JN, name)(*map(jnp.asarray, args[name]))
        got = getattr(N, name)(*map(_t, args[name]))
    if name == "discretized_gaussian_loglik":
        # log of a difference of two CDFs near 1: an f32 ulp of a CDF (6e-8)
        # moves the log of a tail bin's mass by any amount. So the bin masses
        # are held to 1e-6, and the log-likelihood itself where the mass is
        # at least 0.1 (there an ulp moves the log by < 1e-6)
        ref, got = np.asarray(ref), got.numpy()
        np.testing.assert_allclose(np.exp(got), np.exp(ref), rtol=0, atol=1e-6)
        big = np.exp(ref) >= 0.1
        assert big.sum() > 20
        np.testing.assert_allclose(got[big], ref[big], rtol=1e-6, atol=1e-6)
        return
    for r, g in zip(ref if isinstance(ref, tuple) else (ref,),
                    got if isinstance(got, tuple) else (got,)):
        _close(g, np.asarray(r), 1e-6)


CASES = [  # (var type, intp_frac, x0eps_coef, out type, clip, ddim)
    ("fixed_large", None, False, "eps", True, False),
    ("fixed_small", None, True, "eps", False, False),
    ("fixed_medium", 0.3, False, "v", True, False),
    ("learned", None, False, "eps", False, False),
    ("learned", None, True, "x0", True, False),
    ("learned", None, True, "eps", False, False),
    ("fixed_large", None, True, "both", False, True),
]


@pytest.mark.parametrize("var,frac,x0eps,out_type,clip,ddim", CASES)
def test_p_mean_var_matches_jax(var, frac, x0eps, out_type, clip, ddim):
    jd, td = _diffusions(model_var_type=var, intp_frac=frac, x0eps_coef=x0eps,
                         model_out_type=out_type)
    rng = np.random.RandomState(11)
    x_t = rng.randn(3, 8, 8, 3).astype(np.float32)
    C = 3 * (2 if out_type == "both" else 1) * (2 if var == "learned" else 1)
    out = rng.randn(3, 8, 8, C).astype(np.float32)
    t = np.array([0.9, 0.5, 0.07], np.float32)
    s = t - 0.05
    (ls, _), (lt, _) = jd.t2logsnr(jnp.asarray(s)), jd.t2logsnr(jnp.asarray(t))
    ref = jd.p_mean_var(jnp.asarray(out), jnp.asarray(x_t), ls, lt, clip, use_ddim=ddim)
    (ls, _), (lt, _) = td.t2logsnr(_t(s)), td.t2logsnr(_t(t))
    got = td.p_mean_var(_t(out), _t(x_t), ls, lt, clip, use_ddim=ddim)
    for g, r in zip(got, ref):
        r = np.broadcast_to(np.asarray(r), g.shape)
        if np.isinf(r).any():  # the DDIM posterior's log-variance is -inf
            assert np.array_equal(g.numpy(), r)
        else:
            _close(g, r, 1e-5)


@pytest.mark.parametrize("var,x0eps", [("fixed_large", False), ("learned", True)])
def test_loss_term_and_prior_bpd_match_jax(var, x0eps):
    jd, td = _diffusions(schedule="legacy", model_var_type=var, x0eps_coef=x0eps)
    rng = np.random.RandomState(12)
    x_0 = _images(rng)
    noise = rng.randn(*x_0.shape).astype(np.float32)
    t = np.array([0.3, 0.02, 0.7], np.float32)
    s = np.array([0.25, 0.0, 0.65], np.float32)
    lt, _ = jd.t2logsnr(jnp.asarray(t))
    x_t = np.array(x_0 * jnp.sqrt(jax.nn.sigmoid(lt)) + noise * jnp.sqrt(jax.nn.sigmoid(-lt)))
    # a denoiser off by 0.1 of the noise, so that the decoder's bins resolve;
    # learned variance logits near 2: an interpolation fraction near 0.9
    out = _ideal_out(jd, "eps", x_0, noise, t) + 0.1 * rng.randn(*x_0.shape).astype(np.float32)
    if var == "learned":
        out = np.concatenate([out, 2.0 + 0.5 * rng.randn(*x_0.shape).astype(np.float32)], -1)
    (ls, _), (lt, _) = jd.t2logsnr(jnp.asarray(s)), jd.t2logsnr(jnp.asarray(t))
    ref = jd._loss_term_bpd(jnp.asarray(out), jnp.asarray(x_0), jnp.asarray(x_t), ls, lt, True)
    (ls, _), (lt, _) = td.t2logsnr(_t(s)), td.t2logsnr(_t(t))
    got = td._loss_term_bpd(_t(out), _t(x_0), _t(x_t), ls, lt, True)
    _close(got[0], ref[0], 1e-5)
    _close_nll(got[1], ref[1], 1e-5, _decoder_slack(jd, out, x_t, x_0, s, t, True))
    _close(got[2], ref[2], 1e-5)
    _close(td._prior_bpd(_t(x_0)), jd._prior_bpd(jnp.asarray(x_0)), 1e-5)


def _jax_step_noise(key, T, shape):
    """JAX's calc_all_bpd draws: keys = split(key, T), eps_k = normal(keys[k])
    for the step i = T−1−k; returned (T, ...) in that (scan) order."""
    keys = jax.random.split(key, T)
    return np.stack([np.asarray(jax.random.normal(keys[k], shape, jnp.float32))
                     for k in range(T)])


@pytest.mark.parametrize("var,out_type,T", [("fixed_large", "eps", 4), ("learned", "v", 6)])
def test_calc_all_bpd_small_unet_matches_jax(var, out_type, T):
    """The whole bound through the small UNet (conditional, f32) with JAX's
    per-step noise: total, loss (B, T), prior and mse within 1e-4."""
    out_ch = 6 if var == "learned" else 3
    jd, td = _diffusions(model_var_type=var, model_out_type=out_type, sample_timesteps=T)
    jm, params = P.jax_unet(out_channels=out_ch)
    x_0 = _images(np.random.RandomState(13), (2, P.RES, P.RES, 3))
    y = np.array([3.0, 0.0], np.float32)
    key = jax.random.key(5)

    # learned: the variance logits scaled by 0.1 and moved to 6 (an interpolation
    # fraction near 1, the large variance), so that the decoder's bins resolve
    scale = np.array([1.0] * 3 + [0.1] * (out_ch - 3), np.float32)
    shift = np.array([0.0] * 3 + [6.0] * (out_ch - 3), np.float32)

    def den(x_t, t_, y_):
        return jm.apply({"params": params}, x_t, t_, y_) * scale + shift

    model = P.port_unet(out_channels=out_ch)
    port_den = lambda x_t, t_, y_: model(x_t, t_, y_) * _t(scale) + _t(shift)
    ref = jax.jit(lambda x, y: jd.calc_all_bpd(den, x, y, key))(jnp.asarray(x_0), jnp.asarray(y))
    noise = _jax_step_noise(key, T, x_0.shape)
    got = td.calc_all_bpd(port_den, _t(x_0), _t(y), noise=_t(noise))
    total, loss, prior, mse = (np.asarray(r) for r in ref)
    assert got[1].shape == (2, T)
    _close(got[1][:, 1:], loss[:, 1:], 1e-4)
    _close(got[2], prior, 1e-4)
    _close(got[3], mse, 1e-4)
    # step 0, the decoder's NLL, from noise row T-1 (JAX's last key)
    s, t = np.zeros(2, np.float32), np.full(2, 1.0 / T, np.float32)
    lt, t_adj = jd.t2logsnr(jnp.asarray(t))
    x_t = np.array(x_0 * jnp.sqrt(jax.nn.sigmoid(lt)) + noise[-1] * jnp.sqrt(jax.nn.sigmoid(-lt)))
    with torch.no_grad():  # the slack from the port's output: within 1e-4 of JAX's
        out = port_den(_t(x_t), _t(np.array(t_adj)), _t(y)).numpy()
    slack = _decoder_slack(jd, out, x_t, x_0, s, t, True)
    _close_nll(got[1][:, 0], loss[:, 0], 1e-4, slack)
    _close_nll(got[0], total, 1e-4, slack)


def test_calc_all_bpd_draws_from_the_generator():
    """Without noise, the steps draw from the generator in step order T−1 … 0:
    the same generator seed gives the same bound as that noise fed in."""
    _, td = _diffusions(sample_timesteps=3)
    x_0 = _t(_images(np.random.RandomState(14), (2, 4, 4, 3)))
    den = lambda x_t, t_, y_: 0.5 * x_t + 0.1 * t_.reshape(-1, 1, 1, 1)
    gen = torch.Generator().manual_seed(9)
    noise = torch.stack([torch.randn(x_0.shape, generator=gen) for _ in range(3)])
    got = td.calc_all_bpd(den, x_0, generator=torch.Generator().manual_seed(9))
    ref = td.calc_all_bpd(den, x_0, noise=noise)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    with pytest.raises(ValueError, match="Generator"):
        td.calc_all_bpd(den, x_0)


def _near_ideal(xp, ideal, delta, learned):
    """A stand-in denoiser, the same function in both frameworks: the ideal
    output plus delta·(x_t + t + y/10), so that the decoder's bins resolve and
    the output still depends on each input; for learned variances, logits
    2 + 0.3·x_t (an interpolation fraction near 0.9)."""
    def fn(x_t, t, y):
        base = jnp.asarray(ideal) if xp is jnp else torch.from_numpy(ideal)
        out = base + delta * (x_t + t.reshape(-1, 1, 1, 1) + 0.1 * y.reshape(-1, 1, 1, 1))
        if learned:
            cat = jnp.concatenate if xp is jnp else torch.cat
            out = cat([out, 2.0 + 0.3 * x_t], -1)
        return out
    return fn


@pytest.mark.parametrize("var,out_type", [("fixed_large", "eps"), ("learned", "v"),
                                          ("fixed_small", "x0")])
def test_kl_train_loss_matches_jax(var, out_type):
    """loss_type="kl" with t and noise passed in: t quantised to ceil(t·T)/T,
    the KL where s > 0 and the decoder NLL where s = 0 (t ≤ 1/T), CFG labels
    dropped where the keep mask is false. The denoiser is near the ideal
    output at each sample's quantised t: for fixed_small, whose decoder's
    standard deviation is ~5e-5, x_0 moved to its bin's upper edge, so that
    each bin's mass is ~Φ(±1) and not 0 or 1."""
    T = 8
    kw = dict(model_var_type=var, model_out_type=out_type, loss_type="kl", p_uncond=0.1,
              sample_timesteps=T)
    jd, td = _diffusions(**kw)
    rng = np.random.RandomState(15)
    x_0 = _images(rng, (5, 8, 8, 3))
    noise = rng.randn(*x_0.shape).astype(np.float32)
    t = np.array([0.01, 0.125, 0.4, 0.93, 0.6], np.float32)  # the first two have s = 0
    y = rng.randint(1, 11, 5).astype(np.float32)
    keep = np.array([True, False, True, True, False])
    learned = var == "learned"
    ideal = _ideal_out(jd, out_type, x_0, noise, np.ceil(t * T) / T)
    delta = 0.05
    if var == "fixed_small":
        ideal, delta = ideal + np.float32(1 / 255), 3e-5
    ref = jd.train_loss(_near_ideal(jnp, ideal, delta, learned), jnp.asarray(x_0),
                        jnp.asarray(t), jnp.asarray(y * keep), jnp.asarray(noise))
    got = td.train_loss(_near_ideal(torch, ideal, delta, learned), _t(x_0), _t(t), _t(y),
                        _t(noise), keep=_t(keep))
    assert got.shape == (5,)
    kl = np.ceil(t * T) > 1  # s > 0
    _close(got[kl], np.asarray(ref)[kl], 1e-5)
    # the decoder's NLL at t = 1/T, s = 0
    lt, t_adj = jd.t2logsnr(jnp.full(5, 1.0 / T))
    x_t = np.asarray(x_0 * jnp.sqrt(jax.nn.sigmoid(lt)) + noise * jnp.sqrt(jax.nn.sigmoid(-lt)))
    out = _near_ideal(jnp, ideal, delta, learned)(jnp.asarray(x_t), t_adj, jnp.asarray(y * keep))
    slack = _decoder_slack(jd, out, x_t, x_0, np.zeros(5, np.float32),
                           np.full(5, 1.0 / T, np.float32), False)
    _close_nll(got[~kl], np.asarray(ref)[~kl], 1e-5, slack[~kl])
