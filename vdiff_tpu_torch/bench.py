"""Benchmark of the PyTorch/CUDA port: the root ``bench.py``'s lines, on one GPU.

    python -m vdiff_tpu_torch.bench                  # the root bench's full sizes, on CUDA
    python -m vdiff_tpu_torch.bench --sample-steps 16  # sampling cut to 16 steps
    python -m vdiff_tpu_torch.bench --device cpu     # the root bench's CPU miniature

Prints one JSON line per metric, under the root bench's metric names and in
its order; the headline, CIFAR-10 DDIM-256 sampling at w=0, B=64, is LAST:

1. ``session_canary_matmul_tf_per_sec``: a 64-trip chain of 4096³ bf16
   ``torch.matmul``s, the card's rate in this session;
2. ``cifar10_train_img_per_sec_per_chip_bf16``: the cifar10_cond recipe's
   train step (loss, backward, clip, AdamW, EMA; CFG dropout), B=192, 20 steps
   after a warm-up run of 20, eager;
3. ``celeba_samples_per_sec_per_chip_ddim256``: the celeba.json model
   (301,377,222 parameters, heads of 64, 40 tags) at B=32, 2 timed runs of
   256 DDIM steps; then its ``_fused_gn`` arm;
4. ``celeba_train_img_per_sec_per_chip``: its train step at B=48, no remat,
   8 steps after a warm-up run of 8;
5. ``cifar10_samples_per_sec_per_chip_ddim256_cfg0.1``: CFG w=0.1, B=32, 3
   timed runs (``vs_baseline_est``, against the w=0 estimate halved);
6. the headline cell's arms: ``_eager`` (``p_sample(graph=False)``, the
   Python loop) and ``_fused_gn`` (``VDIFF_FUSED_GN=1`` for the arm only);
7. ``cifar10_samples_per_sec_per_chip_ddim256``: w=0, B=64, 3 timed runs.

Every sampling line runs ``GaussianDiffusion.p_sample``, whose steps after
the first replay one CUDA graph of the step, captured in each run: the
capture is timed with the run. Each timing is CUDA events around the timed
runs after a warm-up run (``utils.profiling.benchmark``), and the window
closes before any tensor is fetched; the warm-up's output is checked finite
and of its shape. bf16 activations on CUDA, f32 on the CPU. Each section
retries on its own (2 tries, the headline 3) and prints ``<section>_error``
lines for failed tries; a headline that fails three times raises. The
bench's total time goes to the standard error, after the headline.

Every line carries ``value``, ``unit``, ``vs_baseline`` (the root bench's
constants: engineering estimates of the torch reference on an A100 in fp32,
not measurements), ``model_tf_per_sec``, ``mfu`` where the card's dense bf16
peak is known (:data:`BF16_PEAK_TFS`; the canary line says when it is not),
and ``device``: the card's name and power limit as ``nvidia-smi`` gives them,
or ``cpu``. Sampling lines add ``graph`` and ``switches`` (the fused-kernel
environment switches), arms ``arm``.

FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` cannot see the hand
kernels, which launch through ctypes. So :func:`flops_per_sample` counts one
forward (sampling) or one loss and backward (training) of a float32 copy of
the model at batch 1 on the CPU, where the kernels' plain twins run and their
attention matmuls are counted with the convolutions and projections; every
one of them is linear in the batch. A sampling run is that times the batch
(twice it under CFG, whose forward doubles the batch) times the steps; a
train step, times the batch. Elementwise work is not counted.

Imports nothing of JAX and nothing of ``vdiff_tpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

from .diffusion import GaussianDiffusion
from .models.unet import UNet
from .ops.numerics import get_logsnr_schedule
from .train_lib import Optimizer, make_train_step
from .utils.profiling import benchmark

# the root bench.py's baselines: estimates of the torch reference on an A100
# at fp32 (~32 GFLOPs a CIFAR forward × 256 steps at 6.8 TF/s; celeba 207.46
# GFLOPs a forward; training ~3× the forward), not measurements
BASELINE_SAMPLES_PER_SEC = 0.83
BASELINE_TRAIN_IMG_PER_SEC = 71.0
BASELINE_CELEBA_SAMPLES_PER_SEC = 0.128
BASELINE_CELEBA_TRAIN_IMG_PER_SEC = 10.9

# dense bf16 tensor-core peak (TFLOP/s) by torch.cuda.get_device_name(): the
# H100 SXM5's, NVIDIA H100 Tensor Core GPU data sheet (989.4 without sparsity)
BF16_PEAK_TFS = {"NVIDIA H100 80GB HBM3": 989.4}

SWITCHES = ("VDIFF_FUSED_GN", "VDIFF_FUSED_CONV")


class Bench:
    """One bench run's settings and what every line shares."""

    def __init__(self, device: torch.device, sample_steps=None):
        self.device = device
        self.on_cuda = device.type == "cuda"
        self.dtype = torch.bfloat16 if self.on_cuda else torch.float32
        self.sample_steps = sample_steps
        if self.on_cuda:
            self.name = torch.cuda.get_device_name(device)
            self.card = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()[0]
        else:
            self.name = self.card = "cpu"
        self.peak = BF16_PEAK_TFS.get(self.name)
        self.lines = []
        self._flops = {}

    def flops(self, model_kwargs, res, label_shape, train_diffusion=None):
        """:func:`flops_per_sample`, counted once per model and kind."""
        key = (repr(sorted(model_kwargs.items())), res, tuple(label_shape),
               train_diffusion is not None)
        if key not in self._flops:
            self._flops[key] = flops_per_sample(model_kwargs, res, label_shape, train_diffusion)
        return self._flops[key]

    def steps(self, full, mini):
        if self.sample_steps:
            return self.sample_steps
        return full if self.on_cuda else mini

    def emit(self, metric, value, unit, flops_per_s=None, **fields):
        """Print one line; ``flops_per_s`` gives model_tf_per_sec and mfu."""
        line = {"metric": metric, "value": value, "unit": unit, **fields}
        if flops_per_s is not None:
            tfs = flops_per_s / 1e12
            line["model_tf_per_sec"] = tfs
            if self.peak:
                line["mfu"] = tfs / self.peak
        line["device"] = self.card
        print(json.dumps(line), flush=True)
        self.lines.append(line)
        return line

    def time(self, fn, runs):
        """Mean seconds of ``fn()`` over ``runs`` timed calls after one warm-up
        call, whose result is returned for checking."""
        out = fn()
        return benchmark(fn, warmup=0, iters=runs, device=self.device)["mean"], out


@contextlib.contextmanager
def switches(**values):
    """Set the fused-kernel environment switches for a block, restore after."""
    before = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in before.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def _switch_state():
    return {k: os.environ.get(k, "0") for k in SWITCHES}


def _flagship(b: Bench):
    """cifar10_cond.json's model (hid 256, ch_mult [1,1,1], 3 res blocks,
    attention (F,T,T), one head) and the root bench's diffusion; hid 32 and 4
    steps in the CPU miniature."""
    model = dict(in_channels=3, hid_channels=256 if b.on_cuda else 32, out_channels=3,
                 ch_multipliers=(1, 1, 1), num_res_blocks=3, apply_attn=(False, True, True),
                 drop_rate=0.2, num_heads=1, num_classes=10)
    diffusion = GaussianDiffusion(
        logsnr_fn=get_logsnr_schedule("cosine"), sample_timesteps=b.steps(256, 4),
        model_out_type="v", model_var_type="fixed_medium", reweight_type="snr_trunc",
        loss_type="mse", intp_frac=0.3, w_guide=0.0, p_uncond=0.1)
    return model, diffusion


def _celeba(b: Bench):
    """celeba.json's model (301,377,222 parameters: hid 192, ch_mult
    [1,2,3,4], attention (F,T,T,T), heads of 64, 40 multi-hot tags, 'both'
    head) and the root bench's diffusion. The CPU miniature is the root
    bench's with heads of 32, the kernels' smallest head dim (its 16)."""
    if b.on_cuda:
        model = dict(in_channels=3, hid_channels=192, out_channels=6, ch_multipliers=(1, 2, 3, 4),
                     num_res_blocks=3, apply_attn=(False, True, True, True), embedding_dim=768,
                     drop_rate=0.1, head_dim=64, num_classes=40, multitags=True)
    else:
        model = dict(in_channels=3, hid_channels=32, out_channels=6, ch_multipliers=(1, 2),
                     num_res_blocks=1, apply_attn=(False, True), drop_rate=0.1, head_dim=32,
                     num_classes=40, multitags=True)
    diffusion = GaussianDiffusion(
        logsnr_fn=get_logsnr_schedule("cosine"), sample_timesteps=b.steps(256, 2),
        model_out_type="both", model_var_type="fixed_large", reweight_type="snr_trunc",
        loss_type="mse", w_guide=0.0, p_uncond=0.1)
    return model, diffusion


def _build(b: Bench, model_kwargs):
    """The model with seeded random weights, on the bench's device."""
    return UNet(**model_kwargs, dtype=b.dtype,
                generator=torch.Generator().manual_seed(0)).to(b.device).eval()


def flops_per_sample(model_kwargs, res, label_shape, train_diffusion=None) -> int:
    """FLOPs ``FlopCounterMode`` counts for one sample: one forward of the
    model, or with ``train_diffusion`` one loss and its backward, on a
    float32 copy at batch 1 on the CPU (zero weights: the count depends on
    shapes only), where the attention wrappers run their twins."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        model = UNet(**model_kwargs)
    model.to_empty(device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    x, t = torch.zeros(1, res, res, 3), torch.full((1,), 0.5)
    y = torch.zeros((1,) + tuple(label_shape))
    with FlopCounterMode(display=False) as counter:
        if train_diffusion is None:
            with torch.no_grad():
                model(x, t, y)
        else:
            gen = torch.Generator().manual_seed(0)
            train_diffusion.train_loss(
                lambda a, b, c: model(a, b, c, train=True, generator=gen), x, t, y,
                torch.zeros_like(x)).mean().backward()
    return counter.get_total_flops()


def _check(name, out, shape):
    if tuple(out.shape) != tuple(shape) or not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"{name}: output {tuple(out.shape)} (want {tuple(shape)}), "
                           f"finite={bool(torch.isfinite(out).all())}")


def bench_session_canary(b: Bench):
    """A chain of 64 4096³ bf16 matmuls (each rescaled by 1/n to stay
    finite), timed as one call after a warm-up call: the card's matmul rate
    in this session, beside its peak. 2 trips of 64³ on the CPU."""
    n, trips = (4096, 64) if b.on_cuda else (64, 2)
    x = torch.ones(n, n, dtype=torch.bfloat16, device=b.device) / n
    w = torch.ones(n, n, dtype=torch.bfloat16, device=b.device)

    def chain():
        c = x
        for _ in range(trips):
            c = torch.matmul(c, w) * (1.0 / n)
        return c

    seconds, out = b.time(chain, 1)
    _check("session canary", out, (n, n))
    note = (f"dense bf16 peak {b.peak} TFLOP/s ({b.name}, NVIDIA data sheet)" if b.peak else
            f"no dense bf16 peak is known for {b.name!r}: no line carries mfu")
    return b.emit("session_canary_matmul_tf_per_sec", 2 * n ** 3 * trips / seconds / 1e12,
                  "TF/s/chip", note=note)


def _train_line(b: Bench, metric, model, model_kwargs, diffusion, batch, n_steps, x, y, lr,
                warmup, baseline):
    """n_steps train steps timed after a warm-up run of n_steps."""
    res = x.shape[1]
    ema = copy.deepcopy(model).requires_grad_(False)
    opt = Optimizer(model.parameters(), lr=lr, warmup=warmup, grad_norm=1.0)
    step_fn = make_train_step(model, diffusion, opt, timesteps=0, num_accum=1, use_cfg=True,
                              ema_model=ema)
    counter = {"step": 0}

    def run():
        loss = None
        for _ in range(n_steps):
            loss = step_fn(x, y, 0, counter["step"])
            counter["step"] += 1
        return loss

    seconds, loss = b.time(run, 1)
    _check(metric, loss, ())
    dt = seconds / n_steps
    flops = b.flops(model_kwargs, res, y.shape[1:], train_diffusion=diffusion) * batch
    value = batch / dt
    return b.emit(metric, value, "img/s/chip", flops / dt, vs_baseline=value / baseline,
                  batch=batch, steps=n_steps)


def bench_train(b: Bench):
    """The cifar10_cond recipe's train step at B=192 (8 on the CPU), 20
    steps (2), synthetic batches: x ~ U(-1, 1), labels 1..10."""
    model_kwargs, diffusion = _flagship(b)
    batch, n_steps = (192, 20) if b.on_cuda else (8, 2)
    model = UNet(**model_kwargs, dtype=b.dtype,
                 generator=torch.Generator().manual_seed(0)).to(b.device)
    gen = torch.Generator(device=b.device).manual_seed(1)
    x = torch.rand(batch, 32, 32, 3, generator=gen, device=b.device) * 2 - 1
    y = (torch.arange(batch, dtype=torch.float32, device=b.device) % 10) + 1
    return _train_line(b, "cifar10_train_img_per_sec_per_chip_bf16", model, model_kwargs,
                       diffusion, batch, n_steps, x, y, lr=2e-4, warmup=5000,
                       baseline=BASELINE_TRAIN_IMG_PER_SEC)


def _sampling_line(b: Bench, metric, model, model_kwargs, diffusion, batch, res, y, runs,
                   baseline, baseline_key="vs_baseline", graph=True, arm=None):
    """``runs`` timed calls of p_sample (DDIM, η=0) from fresh x_T after a
    warm-up call."""
    gen = torch.Generator(device=b.device).manual_seed(2)
    shape = (batch, res, res, 3)

    def run():
        x_T = torch.randn(shape, generator=gen, device=b.device)
        return diffusion.p_sample(model, x_T, label=y, use_ddim=True, graph=graph)

    seconds, out = b.time(run, runs)
    _check(metric, out, shape)
    cfg = 2 if diffusion.w_guide > 0 else 1
    steps = diffusion.sample_timesteps
    flops = b.flops(model_kwargs, res, y.shape[1:]) * batch * cfg * steps
    value = batch / seconds
    extra = {"arm": arm} if arm else {}
    return b.emit(metric, value, "samples/s/chip", flops / seconds,
                  **{baseline_key: value / baseline}, **extra, batch=batch, steps=steps,
                  runs=runs, graph=graph and b.on_cuda, switches=_switch_state())


def bench_celeba(b: Bench):
    """celeba sampling at B=32 (2 timed runs), its VDIFF_FUSED_GN=1 arm, then
    its train step at B=48, 8 steps (B=2, 1 run and 2 steps on the CPU)."""
    model_kwargs, diffusion = _celeba(b)
    model = _build(b, model_kwargs)
    res = 64
    batch, runs = (32, 2) if b.on_cuda else (2, 1)
    y = torch.zeros(batch, 40, device=b.device)
    metric = "celeba_samples_per_sec_per_chip_ddim256"
    lines = [_sampling_line(b, metric, model, model_kwargs, diffusion, batch, res, y, runs,
                            BASELINE_CELEBA_SAMPLES_PER_SEC)]
    with switches(VDIFF_FUSED_GN=1):
        lines.append(_sampling_line(b, metric + "_fused_gn", model, model_kwargs, diffusion, batch,
                                    res, y, runs, BASELINE_CELEBA_SAMPLES_PER_SEC,
                                    arm="fused_gn"))
    batch, n_steps = (48, 8) if b.on_cuda else (2, 2)
    gen = torch.Generator(device=b.device).manual_seed(1)
    x = torch.rand(batch, res, res, 3, generator=gen, device=b.device) * 2 - 1
    y = (torch.rand(batch, 40, generator=gen, device=b.device) < 0.5).float()
    lines.append(_train_line(b, "celeba_train_img_per_sec_per_chip", model, model_kwargs,
                             diffusion, batch, n_steps, x, y, lr=3e-4, warmup=1000,
                             baseline=BASELINE_CELEBA_TRAIN_IMG_PER_SEC))
    return lines


def bench_sampling(b: Bench, w_guide, metric, baseline, baseline_key="vs_baseline", graph=True,
                   arm=None):
    """CIFAR-10 DDIM sampling of the flagship model: w=0 at B=64, CFG w=0.1
    at B=32 (B=4 on the CPU), 3 timed runs (1 on the CPU), labels 1..10."""
    model_kwargs, diffusion = _flagship(b)
    if w_guide:
        diffusion = dataclasses.replace(diffusion, w_guide=w_guide)
    model = _build(b, model_kwargs)
    batch = (32 if w_guide else 64) if b.on_cuda else 4
    y = (torch.arange(batch, dtype=torch.float32, device=b.device) % 10) + 1
    return _sampling_line(b, metric, model, model_kwargs, diffusion, batch, 32, y,
                          3 if b.on_cuda else 1, baseline, baseline_key, graph, arm)


def _attempt(fn, name, tries=2):
    """Run a bench section, retrying it; a try that fails prints a
    ``{name}_error`` line, and a section that fails every try prints no line
    of its own, so the later sections and the headline still run."""
    for i in range(1, tries + 1):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — one section's failure must not stop the rest
            print(json.dumps({"metric": f"{name}_error", "attempt": i, "error": str(e)[:300]}),
                  flush=True)
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    return None


HEADLINE = "cifar10_samples_per_sec_per_chip_ddim256"


def main(argv=None) -> list:
    """Run the bench; returns its lines (dicts) in the order printed."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (the full sizes) or cpu (the miniature)")
    p.add_argument("--sample-steps", type=int, default=None,
                   help="DDIM steps of every sampling line (default 256; 4 and 2 on the CPU)")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    # f32 means f32 (the CPU miniature); bf16 runs are unaffected
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    b = Bench(device, args.sample_steps)
    _attempt(lambda: bench_session_canary(b), "session_canary")
    _attempt(lambda: bench_train(b), "train_bench")
    _attempt(lambda: bench_celeba(b), "celeba_bench")
    _attempt(lambda: bench_sampling(b, 0.1, f"{HEADLINE}_cfg0.1", BASELINE_SAMPLES_PER_SEC / 2,
                                    baseline_key="vs_baseline_est"), "cfg_bench")
    _attempt(lambda: bench_sampling(b, 0.0, f"{HEADLINE}_eager", BASELINE_SAMPLES_PER_SEC,
                                    graph=False, arm="eager"), "eager_arm")
    with switches(VDIFF_FUSED_GN=1):
        _attempt(lambda: bench_sampling(b, 0.0, f"{HEADLINE}_fused_gn", BASELINE_SAMPLES_PER_SEC,
                                        arm="fused_gn"), "fused_gn_arm")
    # the headline, last: retried hardest, and a third failure raises
    for i in range(1, 4):
        try:
            bench_sampling(b, 0.0, HEADLINE, BASELINE_SAMPLES_PER_SEC)
            break
        except Exception as e:  # noqa: BLE001
            if i == 3:
                raise
            print(json.dumps({"metric": "headline_bench_error", "attempt": i,
                              "error": str(e)[:300]}), flush=True)
    # on stderr: the headline stays the last line of the standard output
    print(f"bench: {len(b.lines)} lines in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return b.lines


if __name__ == "__main__":
    main()
