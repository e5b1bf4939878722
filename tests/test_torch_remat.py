"""Activation checkpointing of the port's UNet (``UNet(remat=True)`` and
``UNet(remat_policy="conv")``, vdiff_tpu_torch/models/remat.py) on the CPU:
loss and gradients against JAX's ``jax.grad`` under the same mode, against
the port without remat with dropout on, the recompute rule of each mode,
one state_dict for every mode, and where remat applies."""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tests import torch_parity as P  # noqa: E402

MODES = {"none": {}, "full": {"remat": True}, "conv": {"remat_policy": "conv"}}
KW = dict(model_out_type="v", reweight_type="snr_trunc", loss_type="mse", p_uncond=0.1)


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads a test: the suite runs six workers on a few
    cores, where torch's default of one thread a core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _loss_inputs():
    x, t, y = P.inputs(B=2, seed=5)
    return x, t, y, np.random.RandomState(6).randn(*x.shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(mode):
    """JAX's value_and_grad of the training loss through the small UNet under
    ``mode`` (dropout off), the grads in the port's state_dict layout."""
    from vdiff_tpu.diffusion import GaussianDiffusion as JaxDiffusion
    from vdiff_tpu.models.unet import UNet as JaxUNet
    from vdiff_tpu.ops.numerics import get_logsnr_schedule as jax_schedule
    from vdiff_tpu_torch.models.convert import flax_params_to_state_dict

    x, t, y, noise = _loss_inputs()
    _, params = P.jax_unet()
    jm = JaxUNet(**P.SMALL, **MODES[mode])
    jd = JaxDiffusion(logsnr_fn=jax_schedule("cosine"), **KW)

    def jloss(params):
        den = lambda x_t, t_, y_: jm.apply({"params": params}, x_t, t_, y_, train=True)
        return jd.train_loss(den, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y),
                             jnp.asarray(noise)).mean()

    loss, grads = jax.jit(jax.value_and_grad(jloss))(params)
    return float(loss), flax_params_to_state_dict(jax.tree.map(np.asarray, grads), dict(P.SMALL))


def _port_model(mode, drop_rate=0.0):
    """The small UNet under ``mode`` with the JAX test weights, loaded from
    the no-remat model's state_dict."""
    from vdiff_tpu_torch.models.unet import UNet

    model = UNet(**dict(P.SMALL, drop_rate=drop_rate), **MODES[mode])
    model.load_state_dict(P.port_unet().state_dict(), strict=True)
    return model


def _port_step(model, generator=None):
    """Loss and gradients of one training loss through ``model``."""
    from vdiff_tpu_torch.diffusion import GaussianDiffusion
    from vdiff_tpu_torch.ops.numerics import get_logsnr_schedule

    x, t, y, noise = _loss_inputs()
    td = GaussianDiffusion(logsnr_fn=get_logsnr_schedule("cosine"), **KW)
    den = lambda x_t, t_, y_: model(x_t, t_, y_, train=True, generator=generator)
    loss = td.train_loss(den, _t(x), _t(t), _t(y), _t(noise)).mean()
    loss.backward()
    return loss.item(), {k: p.grad for k, p in model.named_parameters()}


@pytest.mark.parametrize("mode", ["full", "conv"])
def test_remat_loss_and_grads_match_jax(mode):
    """f32, dropout off (the frameworks draw other bits): the loss to 1e-5
    and every gradient to 1e-4 relative with a floor of 1e-5 of the largest,
    the bounds of test_torch_train_parity's no-remat test."""
    ref_loss, ref = _jax_loss_and_grads(mode)
    loss, grads = _port_step(_port_model(mode))
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    assert grads.keys() == ref.keys()
    scale = max(np.abs(g).max() for g in ref.values())
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref[k], rtol=1e-4, atol=1e-5 * scale, err_msg=k)


def test_remat_grads_equal_no_remat_with_dropout():
    """Dropout 0.2 on, one step_generator for each mode: the recompute draws
    the bits of the first forward, so loss and gradients equal the no-remat
    step's (1e-6 relative; on the CPU they come out bit for bit), and the
    generator ends in the same state in every mode."""
    from vdiff_tpu_torch.train_lib import step_generator

    runs = {}
    for mode in MODES:
        gen = step_generator(3, 7, 0, "cpu")
        runs[mode] = (*_port_step(_port_model(mode, drop_rate=0.2), gen), gen.get_state())
    loss, grads, state = runs["none"]
    # the bits matter: a step with other bits gives other gradients
    other = _port_step(_port_model("none", drop_rate=0.2), step_generator(3, 8, 0, "cpu"))[1]
    assert not torch.allclose(other["in_conv.weight"], grads["in_conv.weight"], rtol=1e-3)
    for mode in ("full", "conv"):
        got_loss, got, got_state = runs[mode]
        np.testing.assert_allclose(got_loss, loss, rtol=1e-6)
        for k, g in grads.items():
            torch.testing.assert_close(got[k], g, rtol=1e-6, atol=1e-6 * g.abs().max().item(),
                                       msg=f"{mode} {k}")
        assert torch.equal(got_state, state), mode


class _CountConvs(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the convolutions and the biased matmuls (the Dense layers and
    the attention projections; their backward runs plain ``mm``) that really
    run, by phase."""

    def __init__(self):
        super().__init__()
        self.phase = "forward"
        self.convs, self.addmms = {"forward": 0, "backward": 0}, {"forward": 0, "backward": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution.default:
            self.convs[self.phase] += 1
        elif func is torch.ops.aten.addmm.default:
            self.addmms[self.phase] += 1
        return func(*args, **(kwargs or {}))


def _convs(module):
    """The convolutions of ``module``: its Conv2d modules but the attention
    projections, which run as token matmuls."""
    return sum(isinstance(m, torch.nn.Conv2d) and not name.endswith(("proj_in", "proj_out"))
               for name, m in module.named_modules())


def _wrapped_counts(model):
    """(convs, residual blocks without attention, residual blocks with
    attention) among the blocks that remat wraps."""
    from vdiff_tpu_torch.models.unet import ResidualBlock, _ResAttn

    convs = bare = attn = 0
    for levels in (model.downsamples, model.upsamples):
        for level in levels.values():
            for blk in level:
                if isinstance(blk, _ResAttn):
                    attn += 1
                elif not isinstance(blk, ResidualBlock):
                    continue
                else:
                    bare += 1
                convs += _convs(blk)
    return convs, bare, attn


@pytest.mark.parametrize("resample_with_res", [True, False])
def test_recompute_rule(monkeypatch, resample_with_res):
    """What each mode runs again in the backward. Full remat: every conv of
    a wrapped block, except conv2 of a block without attention, whose output
    nothing in the backward reads (torch stops a recompute once the last
    saved tensor is back; XLA drops it the same way), and every Dense but
    ``proj_out``, for the same reason. "conv": no conv and no projection,
    since their outputs are kept, but the FiLM Dense of every wrapped
    residual block, which JAX does not name either. Both: the attention
    forward once per wrapped attention block (JAX re-runs its kernel too).
    The middle blocks, in_conv, the output head and the bare resampling
    convs are not wrapped."""
    from vdiff_tpu_torch.models.unet import UNet
    from vdiff_tpu_torch.ops import attention as A

    calls = []
    forward = A.QkvAttention.forward
    monkeypatch.setattr(A.QkvAttention, "forward",
                        staticmethod(lambda *a: calls.append(1) or forward(*a)))
    x, t, y = (_t(a) for a in P.inputs(B=2, seed=1))
    seen = {}
    for mode in MODES:
        model = UNet(**P.SMALL, resample_with_res=resample_with_res, **MODES[mode],
                     generator=torch.Generator().manual_seed(0))
        counter = _CountConvs()
        calls.clear()
        with counter:
            out = model(x, t, y, train=True)
            fwd_attn = len(calls)
            counter.phase = "backward"
            out.square().mean().backward()
        seen[mode] = (counter.convs, counter.addmms, fwd_attn, len(calls) - fwd_attn)
    convs, bare, attn = _wrapped_counts(model)
    total = _convs(model)
    dense = seen["none"][1]["forward"]
    assert seen["none"] == ({"forward": total, "backward": 0}, {"forward": dense, "backward": 0},
                            attn + 1, 0)
    assert seen["full"] == ({"forward": total, "backward": convs - bare},
                            {"forward": dense, "backward": bare + 2 * attn}, attn + 1, attn)
    assert seen["conv"] == ({"forward": total, "backward": 0},
                            {"forward": dense, "backward": bare + attn}, attn + 1, attn)
    assert attn > 0 and bare > 0 and convs < total


def test_one_state_dict_for_every_mode(tmp_path):
    """A state_dict saved from the no-remat model loads strictly into each
    remat model, has the same keys, and gives the same training forward."""
    from vdiff_tpu_torch.models.unet import UNet

    path = tmp_path / "m.pt"
    torch.save(P.port_unet().state_dict(), path)
    sd = torch.load(path, weights_only=True)
    x, t, y = (_t(a) for a in P.inputs(B=2, seed=2))
    outs = {}
    for mode in MODES:
        model = UNet(**P.SMALL, **MODES[mode])
        model.load_state_dict(sd, strict=True)
        assert model.state_dict().keys() == sd.keys()
        outs[mode] = model(x, t, y, train=True).detach()
    for mode in ("full", "conv"):
        assert torch.equal(outs[mode], outs["none"]), mode


def test_remat_only_where_it_trains(monkeypatch):
    """Inference, and training forwards under no_grad (a sampler, an EMA
    forward), never enter a checkpoint region; a training forward with grad
    does, once per wrapped block."""
    from vdiff_tpu_torch.models import unet as U

    entered, real = [], U.checkpoint_block

    def spy(*args):
        entered.append(1)
        return real(*args)

    monkeypatch.setattr(U, "checkpoint_block", spy)
    model = U.UNet(**P.SMALL, remat_policy="conv")
    x, t, y = (_t(a) for a in P.inputs(B=2, seed=3))
    with torch.no_grad():
        model(x, t, y)
        model(x, t, y, train=True)
    model(x, t, y)
    assert not entered
    model(x, t, y, train=True)
    _, bare, attn = _wrapped_counts(model)
    assert len(entered) == bare + attn


def test_unknown_policy_raises():
    from vdiff_tpu_torch.models.unet import UNet

    with pytest.raises(ValueError, match="remat_policy"):
        UNet(**P.SMALL, remat_policy="dots")
    model = UNet(**P.SMALL, remat_policy="conv")
    assert model.remat and model.remat_policy == "conv"
    assert not UNet(**P.SMALL).remat
