"""The port's training math vs the JAX package on the CPU, same inputs: the
GroupNorm backward, the device schedules, the training loss, the small UNet's
loss and gradients, and one clip → AdamW → EMA update."""

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
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("silu", [False, True])
def test_gn_backward_matches_jax_custom_vjp(film, silu):
    from vdiff_tpu.ops.groupnorm import _gn_film_silu_core
    from vdiff_tpu_torch.ops.groupnorm import gn_film_silu

    rng = np.random.RandomState(4 + 2 * film + silu)
    x = (rng.randn(2, 4, 4, 64) * 2 + 0.5).astype(np.float32)
    gamma, beta = rng.randn(64).astype(np.float32), rng.randn(64).astype(np.float32)
    shift = rng.randn(2, 64).astype(np.float32) if film else None
    scale = rng.randn(2, 64).astype(np.float32) if film else None
    g = rng.randn(*x.shape).astype(np.float32)

    def jfn(x, gamma, beta, shift, scale):
        return _gn_film_silu_core(x, gamma, beta, shift, scale, 32, 1e-6, silu)

    jargs = [None if a is None else jnp.asarray(a) for a in (x, gamma, beta, shift, scale)]
    ref, vjp = jax.vjp(jfn, *jargs)
    refs = vjp(jnp.asarray(g))

    targs = [None if a is None else _t(a).requires_grad_() for a in (x, gamma, beta, shift, scale)]
    out = gn_film_silu(*targs, num_groups=32, eps=1e-6, apply_silu=silu)
    out.backward(_t(g))
    _close(out.detach().numpy(), ref, 1e-5)
    for a, r in zip(targs, refs):
        if a is None:
            assert r is None
        else:
            _close(a.grad.numpy(), r, 1e-5)


@pytest.mark.parametrize("schedule", ["linear", "sigmoid", "cosine", "legacy"])
@pytest.mark.parametrize("rescale", [False, True])
def test_device_schedule_matches_jax(schedule, rescale):
    from vdiff_tpu.ops.numerics import get_logsnr_schedule as jax_schedule
    from vdiff_tpu_torch.ops.numerics import get_logsnr_schedule

    t = np.random.RandomState(0).uniform(1e-3, 1 - 1e-3, 64).astype(np.float32)
    ref_l, ref_t = jax_schedule(schedule, rescale=rescale)(jnp.asarray(t))
    got_l, got_t = get_logsnr_schedule(schedule, rescale=rescale)(_t(t))
    assert got_l.dtype == torch.float32 and got_t.dtype == torch.float32
    # f32 transcendental functions of two libraries: a few ulps of |logsnr| ≤ ~20
    np.testing.assert_allclose(got_l.numpy(), np.asarray(ref_l), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,start_dim", [("q_sample", None), ("flat_mean", 1), ("flat_mean", 2),
                                            ("flat_sum", 1), ("flat_sum", 3)])
def test_device_numerics_match_jax(name, start_dim):
    from vdiff_tpu.ops import numerics as JN
    from vdiff_tpu_torch.ops import numerics as N

    rng = np.random.RandomState(5)
    x = rng.randn(3, 4, 4, 3).astype(np.float32)
    if name == "q_sample":
        eps = rng.randn(*x.shape).astype(np.float32)
        lam = rng.uniform(-8, 8, (3, 1, 1, 1)).astype(np.float32)
        ref, got = JN.q_sample(*map(jnp.asarray, (x, lam, eps))), N.q_sample(*map(_t, (x, lam, eps)))
    else:
        ref = getattr(JN, name)(jnp.asarray(x), start_dim)
        got = getattr(N, name)(_t(x), start_dim)
    assert got.shape == ref.shape
    _close(got.numpy(), ref, 1e-6)


def _denoise_np(xp):
    """A fixed stand-in denoiser, the same function in both frameworks."""
    def fn(x_t, t, y):
        out = 0.5 * x_t + 0.1 * t.reshape(-1, 1, 1, 1)
        return out if y is None else out + 0.01 * y.reshape(-1, 1, 1, 1)
    return fn


@pytest.mark.parametrize("reweight,out_type", [
    ("constant", "x0"), ("snr", "eps"), ("snr_1plus", "v"), ("snr_trunc", "v"),
    ("snr_trunc", "eps"), ("snr_trunc", "both")])
def test_train_loss_matches_jax(reweight, out_type):
    from vdiff_tpu.diffusion import GaussianDiffusion as JaxDiffusion
    from vdiff_tpu.ops.numerics import get_logsnr_schedule as jax_schedule
    from vdiff_tpu_torch.diffusion import GaussianDiffusion
    from vdiff_tpu_torch.ops.numerics import get_logsnr_schedule

    rng = np.random.RandomState(7)
    B = 6
    x0 = rng.uniform(-1, 1, (B, 8, 8, 3)).astype(np.float32)
    noise = rng.randn(B, 8, 8, 3).astype(np.float32)
    t = rng.uniform(0, 1, B).astype(np.float32)
    y = rng.randint(1, 11, B).astype(np.float32)
    keep = np.array([True, False, True, True, False, True])
    kw = dict(model_out_type=out_type, reweight_type=reweight, loss_type="mse", p_uncond=0.1)

    def jden(x_t, t_, y_):
        out = _denoise_np(jnp)(x_t, t_, y_)
        return jnp.concatenate([out, -out], -1) if out_type == "both" else out

    def tden(x_t, t_, y_):
        out = _denoise_np(torch)(x_t, t_, y_)
        return torch.cat([out, -out], -1) if out_type == "both" else out

    ref = JaxDiffusion(logsnr_fn=jax_schedule("cosine"), **kw).train_loss(
        jden, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(y * keep), jnp.asarray(noise))
    got = GaussianDiffusion(logsnr_fn=get_logsnr_schedule("cosine"), **kw).train_loss(
        tden, _t(x0), _t(t), _t(y), _t(noise), keep=_t(keep))
    assert got.shape == (B,)
    _close(got.numpy(), ref, 1e-5)


def test_train_loss_refuses_kl():
    """Named for what it checked before the kl loss was ported (a refusal);
    it now holds ``loss_type="kl"`` to JAX's: the per-sample loss at t that
    quantise to steps with s > 0 (the KL of the step, 1e-5) and to the first
    step (the decoder's NLL, 1e-5 plus tests/test_torch_bpd.py's slack, which
    must stay below 1e-3 of the term), CFG labels dropped by the keep mask,
    dropout off. The denoiser is the small UNet's output scaled by 0.1 plus
    the true noise, the same in both frameworks: a prediction near the
    noise, so that the decoder's bins resolve (the random UNet alone leaves
    some in the tails, whose masses f32 resolves only to ~2^-24)."""
    from vdiff_tpu_torch.diffusion import GaussianDiffusion
    from vdiff_tpu_torch.ops.numerics import get_logsnr_schedule
    from vdiff_tpu.diffusion import GaussianDiffusion as JaxDiffusion
    from vdiff_tpu.ops.numerics import get_logsnr_schedule as jax_schedule
    from tests.test_torch_bpd import _close_nll, _decoder_slack

    T = 16
    kw = dict(model_out_type="eps", loss_type="kl", p_uncond=0.1, sample_timesteps=T)
    x, _, y = P.inputs(B=4, seed=8)
    x = np.clip(np.round(x * 64) / 127.5, -1, 1).astype(np.float32)  # on the 8-bit grid
    t = np.array([0.02, 0.3, 0.7, 0.97], np.float32)  # the first is step 0
    noise = np.random.RandomState(9).randn(*x.shape).astype(np.float32)
    keep = np.array([True, False, True, True])
    jm, params = P.jax_unet()
    jd = JaxDiffusion(logsnr_fn=jax_schedule("cosine"), **kw)
    jden = lambda x_t, t_, y_: 0.1 * jm.apply({"params": params}, x_t, t_, y_) + noise
    ref = np.asarray(jax.jit(lambda a, b, c, d: jd.train_loss(jden, a, b, c, d))(
        jnp.asarray(x), jnp.asarray(t), jnp.asarray(y * keep), jnp.asarray(noise)))
    td = GaussianDiffusion(logsnr_fn=get_logsnr_schedule("cosine"), **kw)
    model = P.port_unet()
    tden = lambda x_t, t_, y_: 0.1 * model(x_t, t_, y_, train=True) + _t(noise)
    got = td.train_loss(tden, _t(x), _t(t), _t(y), _t(noise), keep=_t(keep)).detach().numpy()
    assert got.shape == (4,)
    _close(got[1:], ref[1:], 1e-5)
    lt, t_adj = jd.t2logsnr(jnp.full(4, 1.0 / T))
    x_t = np.array(x * jnp.sqrt(jax.nn.sigmoid(lt)) + noise * jnp.sqrt(jax.nn.sigmoid(-lt)))
    with torch.no_grad():  # the slack from the port's output: within 1e-5 of JAX's
        out = tden(_t(x_t), _t(np.array(t_adj)), _t(y * keep)).numpy()[:1]
    _close_nll(got[:1], ref[:1], 1e-5, _decoder_slack(
        jd, out, x_t[:1], x[:1], np.zeros(1, np.float32), np.full(1, 1.0 / T, np.float32), False))


def test_small_unet_loss_and_grads_match_jax():
    """value_and_grad of the training loss through the small UNet in train
    mode (dropout off), f32, same perturbed weights and inputs. JAX's grads are
    mapped to the port's state_dict layout by flax_params_to_state_dict."""
    from vdiff_tpu.diffusion import GaussianDiffusion as JaxDiffusion
    from vdiff_tpu.ops.numerics import get_logsnr_schedule as jax_schedule
    from vdiff_tpu_torch.diffusion import GaussianDiffusion
    from vdiff_tpu_torch.models.convert import flax_params_to_state_dict
    from vdiff_tpu_torch.ops.numerics import get_logsnr_schedule

    kw = dict(model_out_type="v", reweight_type="snr_trunc", loss_type="mse", p_uncond=0.1)
    x, t, y = P.inputs(B=2, seed=5)
    noise = np.random.RandomState(6).randn(*x.shape).astype(np.float32)
    jm, params = P.jax_unet()
    jd = JaxDiffusion(logsnr_fn=jax_schedule("cosine"), **kw)

    def jloss(params):
        den = lambda x_t, t_, y_: jm.apply({"params": params}, x_t, t_, y_, train=True)
        return jd.train_loss(den, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y),
                             jnp.asarray(noise)).mean()

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(params)
    ref_sd = flax_params_to_state_dict(jax.tree.map(np.asarray, ref_grads), dict(P.SMALL))

    model = P.port_unet()
    td = GaussianDiffusion(logsnr_fn=get_logsnr_schedule("cosine"), **kw)
    den = lambda x_t, t_, y_: model(x_t, t_, y_, train=True)
    loss = td.train_loss(den, _t(x), _t(t), _t(y), _t(noise)).mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert grads.keys() == ref_sd.keys()
    scale = max(np.abs(g).max() for g in ref_sd.values())
    for k, g in grads.items():
        # f32 through ~30 layers and back in two frameworks: the bound is
        # relative to the largest gradient of the model (measured 8e-7 of it)
        np.testing.assert_allclose(g.numpy(), ref_sd[k], rtol=1e-4, atol=1e-5 * scale, err_msg=k)


def test_clip_adamw_ema_matches_optax():
    """Two updates on identical grads: warmup step 0 with ‖g‖ < 1 (no clip),
    then a step with ‖g‖ > 1 (clipped), each followed by the EMA update."""
    from vdiff_tpu.train_lib import ema_update, make_optimizer
    from vdiff_tpu_torch.train_lib import Optimizer, ema_update_

    rng = np.random.RandomState(11)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2, 3)}
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * f).astype(np.float32) for k, s in shapes.items()}
             for f in (0.05, 3.0)]
    cfg = dict(lr=1e-2, beta1=0.9, beta2=0.99, weight_decay=0.1, warmup=3, grad_norm=1.0)

    tx = make_optimizer(**cfg)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jema, jstate = dict(jp), tx.init(jp)
    tp = [_t(p0[k]).clone().requires_grad_() for k in shapes]
    tema = [p.detach().clone() for p in tp]
    opt = Optimizer(tp, **cfg)
    norms = []
    for step, g in enumerate(grads):
        norms.append(np.sqrt(sum((v.astype(np.float64) ** 2).sum() for v in g.values())))
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = {k: jp[k] + upd[k] for k in shapes}
        jema = ema_update(jema, jp, step + 1, 0.99)
        for p, k in zip(tp, shapes):
            p.grad = _t(g[k]).clone()
        opt.step()
        ema_update_(tema, [p.detach() for p in tp], step + 1, 0.99)
        for p, e, k in zip(tp, tema, shapes):
            _close(p.detach().numpy(), jp[k], 1e-6)
            _close(e.numpy(), jema[k], 1e-6)
    assert norms[0] < 1.0 < norms[1]
    assert opt.count == 2
