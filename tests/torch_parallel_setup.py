"""Shared set-up of the port's multi-rank CPU tests: the small UNet (its JAX
params perturbed and converted to the port's layout), the global batch and
its draws as JAX's step draws them, the generate/eval CLI files, the worker
launch, and the step tolerances of tests/test_torch_train_parity.py."""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")

# hid 32, ch_mult (1, 2), one res block, attention at the lower level, 16×16
CFG = dict(in_channels=3, hid_channels=32, out_channels=3, ch_multipliers=(1, 2),
           num_res_blocks=1, apply_attn=(False, True), num_heads=1, num_classes=10,
           drop_rate=0.0)
DIFFUSION = dict(sample_timesteps=4, model_out_type="v", model_var_type="fixed_medium",
                 reweight_type="snr_trunc", loss_type="mse", intp_frac=0.3, w_guide=0.1,
                 p_uncond=0.1)
SHAPE = (16, 16, 3)
B, NUM_ACCUM = 8, 2
LR = 1e-3
OPTIMIZER = dict(lr=LR, beta1=0.9, beta2=0.999, weight_decay=1e-3, warmup=0)
GRAD_NORM = 0.05  # below the step's gradient norm: the clip bites
EMA_DECAY = 0.99
JAX_SEED = 7

# tests/test_torch_train_parity.py's bounds: the loss relative to itself,
# gradients relative to the largest one, updated params relative to lr; an
# entry whose gradient is within the gradient bound of zero may take AdamW's
# first step (≈ lr·sign g) the other way: 2·lr plus the decay's share
LOSS_RTOL, GRAD_RTOL, PARAM_RTOL, SIGN_BOUND = 1e-5, 1e-4, 1e-2, 2.01


@functools.lru_cache(maxsize=None)
def jax_model_and_params():
    """(JAX UNet, perturbed params as numpy)."""
    import jax
    import jax.numpy as jnp

    from tests.torch_parity import perturb
    from vdiff_tpu.models.unet import UNet

    model = UNet(use_flash=False, **CFG)
    params = jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, 8, 8, 3)), jnp.zeros((1,)),
                                 jnp.ones((1,)))["params"]
    return model, perturb(params, seed=3)


def to_port(tree):
    """A JAX param-shaped tree → the port's state-dict layout (numpy)."""
    return flax_params_to_state_dict_np(tree, CFG)


def global_batch():
    rng = np.random.RandomState(11)
    x = rng.uniform(-1, 1, (B,) + SHAPE).astype(np.float32)
    y = rng.randint(1, 11, (B,)).astype(np.float32)
    return x, y


def jax_draws():
    """t, noise and keep of each global micro-batch, as JAX's
    ``make_train_step`` draws them from ``key(JAX_SEED)``."""
    import jax

    mb = B // NUM_ACCUM
    out = []
    for k in jax.random.split(jax.random.key(JAX_SEED), NUM_ACCUM):
        t_rng, noise_rng, uncond_rng, _ = jax.random.split(k, 4)
        out.append({
            "t": torch.from_numpy(np.array(jax.random.uniform(t_rng, (mb,)))),
            "noise": torch.from_numpy(np.array(
                jax.random.normal(noise_rng, (mb,) + SHAPE, np.float32))),
            "keep": torch.from_numpy(np.array(
                jax.random.uniform(uncond_rng, (mb,)) > DIFFUSION["p_uncond"])),
        })
    return out


def write_cli_files(workdir):
    """A tiny synthetic experiment config and a seeded reference-format
    checkpoint of its conditional UNet; returns (config path, ckpt path)."""
    from vdiff_tpu_torch.factory import build_unet, load_experiment_config

    cfg_path = os.path.join(workdir, "tiny.json")
    with open(cfg_path, "w") as f:
        json.dump({
            "data": {"name": "synthetic"},
            "model": {"hid_channels": 32, "ch_multipliers": [1, 2], "num_res_blocks": 1,
                      "apply_attn": [False, True], "drop_rate": 0.0, "num_heads": 1},
            "diffusion": {"logsnr_schedule": "cosine", "train_timesteps": 0,
                          "sample_timesteps": 4, "model_out_type": "v",
                          "model_var_type": "fixed_large", "reweight_type": "snr",
                          "loss_type": "mse"},
            "conditional": {"use_cfg": True, "w_guide": 0.1, "p_uncond": 0.1},
        }, f)
    config, _ = load_experiment_config(cfg_path)
    model = build_unet(config["model"], in_channels=3,
                       model_out_type=config["diffusion"]["model_out_type"], num_classes=10,
                       multitags=False,
                       generator=torch.Generator().manual_seed(4))
    with torch.no_grad():  # zero-init layers perturbed, so every layer carries signal
        g = torch.Generator().manual_seed(5)
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.05)
    ckpt = os.path.join(workdir, "tiny.pt")
    sd = model.state_dict()
    torch.save({"model": sd, "ema": {"shadow": sd}}, ckpt)
    return cfg_path, ckpt


def cli_args(cfg_path, ckpt):
    gen = ["--config-path", cfg_path, "--ckpt-path", ckpt, "--device", "cpu", "--use-ema",
           "--sample-timesteps", "4", "--total-size", "6", "--batch-size", "4", "--seed", "3"]
    ev = ["--device", "cpu", "--dataset", "synthetic", "--metrics", "nll", "--config-path",
          cfg_path, "--ckpt-path", ckpt, "--eval-batch-size", "4", "--eval-total-size", "8"]
    return gen, ev


def write_setup(workdir):
    """Everything the workers read, in ``workdir/setup.pt``; returns it."""
    _, params = jax_model_and_params()
    x, y = global_batch()
    cfg_path, ckpt = write_cli_files(workdir)
    gen, ev = cli_args(cfg_path, ckpt)
    setup = {
        "cfg": CFG, "diffusion": DIFFUSION, "shape": SHAPE, "num_accum": NUM_ACCUM,
        "optimizer": OPTIMIZER, "grad_norm": GRAD_NORM, "ema_decay": EMA_DECAY,
        "weights": {k: torch.from_numpy(np.asarray(v)) for k, v in to_port(params).items()},
        "x": torch.from_numpy(x), "y": torch.from_numpy(y), "draws": jax_draws(),
        "generate_args": gen, "eval_args": ev,
    }
    torch.save(setup, os.path.join(workdir, "setup.pt"))
    return setup


# the model-parallel serving tests (tests/test_torch_tp.py): tests/test_tp.py's
# UNet (two heads), its inputs and its 4-step CFG sampler
TP_CFG = dict(CFG, num_heads=2)
TP_RES = 16
TP_DIFFUSION = dict(sample_timesteps=4, model_out_type="eps", model_var_type="fixed_large",
                    reweight_type="snr", loss_type="mse", w_guide=0.3, p_uncond=0.1)


@functools.lru_cache(maxsize=None)
def jax_tp_model_and_params():
    """(JAX UNet of TP_CFG, perturbed params as numpy)."""
    import jax
    import jax.numpy as jnp

    from tests.torch_parity import perturb
    from vdiff_tpu.models.unet import UNet

    model = UNet(use_flash=False, **TP_CFG)
    params = jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, TP_RES, TP_RES, 3)),
                                 jnp.zeros((1,)), jnp.ones((1,)))["params"]
    return model, perturb(params, seed=5)


def tp_inputs():
    """tests/test_tp.py's forward inputs (B=2), and the sampler's x_T and
    labels (B=4)."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, TP_RES, TP_RES, 3).astype(np.float32)
    t = np.linspace(0.2, 0.8, 2).astype(np.float32)
    y = rng.randint(1, 11, (2,)).astype(np.float32)
    x_T = rng.randn(4, TP_RES, TP_RES, 3).astype(np.float32)
    y4 = rng.randint(1, 11, (4,)).astype(np.float32)
    return x, t, y, x_T, y4


def write_tp_setup(workdir):
    """What the model-parallel phases read, in ``workdir/setup.pt``: the
    two-head UNet's weights (JAX's, converted), the inputs, the CLI files
    (and a six-level config whose lowest level has one row); returns it."""
    _, params = jax_tp_model_and_params()
    cfg_path, ckpt = write_cli_files(workdir)
    with open(cfg_path) as f:
        deep = json.load(f)
    deep["model"]["ch_multipliers"] = [1] * 6
    deep["model"]["apply_attn"] = [False] * 6
    deep_path = os.path.join(workdir, "six_levels.json")
    with open(deep_path, "w") as f:
        json.dump(deep, f)
    gen, _ = cli_args(cfg_path, ckpt)
    weights = flax_params_to_state_dict_np(params, TP_CFG)
    setup = {
        "cfg": TP_CFG, "diffusion": TP_DIFFUSION,
        "weights": {k: torch.from_numpy(np.asarray(v)) for k, v in weights.items()},
        "inputs": [torch.from_numpy(a) for a in tp_inputs()],
        "generate_args": gen, "six_levels": deep_path,
    }
    torch.save(setup, os.path.join(workdir, "setup.pt"))
    return setup


def flax_params_to_state_dict_np(tree, cfg):
    import jax

    from vdiff_tpu_torch.models.convert import flax_params_to_state_dict

    return flax_params_to_state_dict(jax.tree.map(np.asarray, tree), dict(cfg))


class Ranks:
    """``world`` worker processes running ``phases``; :meth:`results` waits
    for them (each at most ``timeout`` s) and returns each rank's results."""

    def __init__(self, workdir, world, phases, timeout=600):
        env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE")}
        env.update(PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
        self.workdir, self.world, self.timeout = str(workdir), world, timeout
        self.procs = [subprocess.Popen(
            [sys.executable, WORKER, str(r), str(world), self.workdir, ",".join(phases)],
            env=env, cwd=self.workdir, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(world)]
        self._results = None

    def results(self):
        if self._results is None:
            outs = []
            try:
                for p in self.procs:
                    outs.append(p.communicate(timeout=self.timeout)[0])
            except subprocess.TimeoutExpired:
                for p in self.procs:
                    p.kill()
                raise AssertionError("workers timed out (a collective left waiting?)\n"
                                     + "\n".join(outs))
            for r, (p, out) in enumerate(zip(self.procs, outs)):
                assert p.returncode == 0 and f"WORKER_OK {r}" in out, f"rank {r}:\n{out}"
            self._results = [torch.load(os.path.join(self.workdir, f"result_{r}.pt"),
                                        weights_only=False) for r in range(self.world)]
        return self._results


def check_step(got, loss, grads, params, ema=None):
    """A port step (``got``: loss, whole grads, params and EMA) against
    reference numpy state dicts, within the bounds above (the EMA, which
    moves by a share of the params' step, within the params' bounds);
    returns the grads' norm."""
    assert abs(got["loss"] - loss) <= LOSS_RTOL * abs(loss), (got["loss"], loss)
    assert got["grads"].keys() == grads.keys() == params.keys()
    scale = max(np.abs(g).max() for g in grads.values())
    for k, g in grads.items():
        err = np.abs(got["grads"][k].numpy() - g).max()
        assert err <= GRAD_RTOL * scale, (k, err / scale)
        signed = np.abs(g) > GRAD_RTOL * scale
        for name, ref in (("params", params), ("ema", ema)):
            if ref is None:
                continue
            moved = np.abs(got[name][k].numpy() - ref[k]) / LR
            assert moved[signed].max(initial=0.0) <= PARAM_RTOL, (name, k, moved[signed].max())
            assert moved.max() <= SIGN_BOUND, (name, k, moved.max())
    return float(np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads.values())))


def as_numpy(sd):
    return {k: v.numpy() for k, v in sd.items()}


def assert_same_state(a, b):
    """Two state dicts (or optimizer state dicts) equal bit for bit."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), (sorted(a), sorted(b))
        for k in a:
            assert_same_state(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            assert_same_state(u, v)
    elif torch.is_tensor(a):
        assert torch.equal(a.cpu(), b.cpu())
    else:
        assert a == b, (a, b)
