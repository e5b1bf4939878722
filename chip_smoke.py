#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port (``vdiff_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one output line each (any failure raises and exits non-zero):
  1. card: the GPU's name and power limit as nvidia-smi reports them;
  2. kernels: builds the CUDA attention kernels from vdiff_tpu_torch/csrc and
     holds each sampling kernel against its plain PyTorch twin at the
     sampler's shapes, f32 and bf16, and times both with CUDA events;
  3. unet: the full-width cifar10_cond UNet (random weights, zero-init layers
     perturbed) in f32 on the GPU against the same UNet on the CPU;
  4. sample: the port's CLI (vdiff_tpu_torch.generate) draws 256-step DDIM
     samples at w=0 (B=64, two batches) and with CFG at w=0.1 (B=32), and the
     kernels' launch counters must show 17 + 1 launches per UNet forward;
  5. train-kernels: the training forward (attn_fwd_train; attn_fwd_qblk at
     T=1024) and the two-pass backward (attn_bwd_rows + attn_bwd_cols)
     against their twins at the train step's shapes (B=128; T=64/256/1024 at
     C=256, and two heads of 128), f32 and bf16, timed with CUDA events;
  6. train-unet: one full-width train step (loss, backward, clip, AdamW, EMA)
     in f32 at B=2 on the GPU against the same step on the CPU, same weights,
     t, noise and CFG mask, dropout off; one step must launch attn_fwd_train
     17 times, attn_fwd_qblk once, each backward pass 18 times and
     attn_fwd_online never;
  7. train-cli: the port's train CLI (vdiff_tpu_torch.train) on
     synthetic_flagship.json with --allow-bf16 --epochs 1 (4 steps of 128, the
     epoch-end sample grid, ckpt_last), then generate samples from ckpt_last.
The line before last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

import copy
import glob
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "vdiff_tpu", "configs")
CONFIG = os.path.join(CONFIGS, "cifar10_cond.json")
TRAIN_CONFIG = os.path.join(CONFIGS, "synthetic_flagship.json")
STEPS = 256
# attention calls per cifar10_cond UNet forward: 17 at T <= 512 (8 at T=256,
# 9 at T=64) go to the online kernel (attn_fwd_train when training), 1 at
# T=1024 (up_1_us) to the q-blocked one; a training backward runs each
# backward pass once per call
ONLINE_PER_FWD, QBLK_PER_FWD = 17, 1
TRAIN_STEP_LAUNCHES = {"attn_fwd_online": 0, "attn_fwd_train": 17, "attn_fwd_qblk": 1,
                       "attn_bwd_rows": 18, "attn_bwd_cols": 18}
KERNELS = tuple(TRAIN_STEP_LAUNCHES)

# f32: both sides do f32 math; only the summation order differs.
F32_ATOL = 1e-4
# bf16: the kernel does f32 math on the bf16 values and rounds once at the
# output, so it must sit within half a bf16 ulp (2^-8 relative) of the twin
# run in f32 on the same values, plus the f32 allowance.
BF16_RTOL = 2.0 ** -8
# UNet f32 on the GPU vs the CPU, relative to the output's scale: GEMM/conv
# summation order and the kernels' order differ across ~60 layers.
UNET_RTOL = 1e-3
# attention backward vs attention_qkv_bwd_reference, per d(qkv) slot (dq, dk,
# dv), relative to the slot's scale max(1, max|ref|). f32: both sides do f32
# math; the sums run in other orders and the column pass takes P as
# exp(S - lse) where the twin divides by the row sum.
BWD_F32_RTOL = 1e-4
# bf16: kernel and twin round P and dS to bf16 as matmul operands at the same
# points and round each output once; their f32 sums differ in order, which can
# move a rounding by one step. One bf16 step of each output (2^-7 relative),
# plus 2^-8 of the slot's scale for P/dS operands that round the other way.
BWD_BF16_RTOL, BWD_BF16_SCALE = 2.0 ** -7, 2.0 ** -8
# one f32 train step on the GPU vs the CPU: the loss relative to itself and
# the gradients relative to the largest one (the UNet bound's reasoning, over a
# forward and a backward); the updated params relative to the step's size, lr.
# AdamW's first update is lr·g/(|g|+eps) ≈ lr·sign(g) per entry, so an entry
# whose gradient lies within the gradients' own tolerance of zero may move the
# other way on the other device: those entries are held to Adam's bound of
# 2·lr (plus the decay's share), all others to 1e-2·lr.
STEP_LOSS_RTOL, STEP_GRAD_RTOL, STEP_PARAM_RTOL, STEP_SIGN_BOUND = 1e-4, 1e-3, 1e-2, 2.01
STEP_LR = 2e-4


def fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` in ms (CUDA events around ``iters`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    print(out[0], flush=True)
    return out[0]


def phase_kernels():
    """Each kernel vs attention_qkv_reference on the same inputs. Returns the
    per-kernel record at the sampler's shape (bf16, as --allow-bf16 runs)."""
    from vdiff_tpu_torch import kernels
    from vdiff_tpu_torch.ops import attention as A

    t0 = time.perf_counter()
    kernels.library()  # nvcc build (or the cached library) + load
    print(f"kernels: built {kernels.build_library()} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [  # (wrapper, B, T, N, C); first case per wrapper is the sampler's shape
        (A.attn_fwd_online, 64, 256, 1, 256),
        (A.attn_fwd_online, 64, 64, 1, 256),
        (A.attn_fwd_online, 64, 256, 2, 128),
        (A.attn_fwd_qblk, 64, 1024, 1, 256),
        (A.attn_fwd_qblk, 64, 1024, 2, 128),
    ]
    record = {}
    for fn, B, T, N, C in cases:
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.randn(B, T, 3 * N * C, device="cuda", generator=gen).to(dtype)
            tag = f"{fn.__name__} B={B} T={T} N={N} C={C} {str(dtype)[6:]}"
            max_err = _check_fwd(tag, fn(qkv, N), A.attention_qkv_reference(qkv.float(), N), dtype)
            ms = cuda_ms(lambda: fn(qkv, N))
            plain_ms = cuda_ms(lambda: A.attention_qkv_reference(qkv, N))
            print(f"kernels: {tag}: max_abs_err={max_err} ms={ms} plain_ms={plain_ms}", flush=True)
            if dtype == torch.bfloat16 and fn.__name__ not in record:
                record[fn.__name__] = {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}
            del qkv
    return record


def _check_fwd(name, out, ref, dtype):
    """A forward kernel's output vs the twin run in f32 on the same values;
    returns the largest absolute error."""
    torch.cuda.synchronize()  # a fault during the launch surfaces here
    if out.shape != ref.shape or out.dtype != dtype:
        fail(f"{name}: got {tuple(out.shape)} {out.dtype}")
    err = (out.float() - ref).abs()
    tol = torch.full_like(ref, F32_ATOL) if dtype == torch.float32 else BF16_RTOL * ref.abs() + F32_ATOL
    if not bool(torch.isfinite(out).all()) or bool((err > tol).any()):
        fail(f"{name}: max err {err.max().item()} over tolerance "
             f"({'atol 1e-4' if dtype == torch.float32 else '2^-8 rel + 1e-4'})")
    return err.max().item()


def _check_bwd(name, got, ref, dtype):
    """d(qkv) of the kernel pair vs attention_qkv_bwd_reference in the same
    dtype, slot by slot; returns the largest absolute error."""
    torch.cuda.synchronize()
    if got.shape != ref.shape or got.dtype != dtype:
        fail(f"{name}: got {tuple(got.shape)} {got.dtype}")
    worst = 0.0
    for slot, (a, r) in zip("qkv", zip(got.float().chunk(3, -1), ref.float().chunk(3, -1))):
        scale = max(1.0, r.abs().max().item())
        err = (a - r).abs()
        if dtype == torch.float32:
            tol = torch.full_like(r, BWD_F32_RTOL * scale)
        else:
            tol = BWD_BF16_RTOL * r.abs() + BWD_BF16_SCALE * scale
        if not bool(torch.isfinite(a).all()) or bool((err > tol).any()):
            fail(f"{name}: d{slot} max err {err.max().item()} (scale {scale}) over tolerance")
        worst = max(worst, err.max().item())
    return worst


def phase_train_kernels():
    """The training kernels vs their twins at the train step's shapes (B=128,
    the config's batch), f32 and bf16, timed with CUDA events; the forward at
    T=1024 is B2's attn_fwd_qblk, whose record stays phase 2's. Returns the
    per-kernel record at T=256, C=256 in bf16 (8 of the 18 attention calls of
    a training forward; --allow-bf16)."""
    from vdiff_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [(128, 256, 1, 256), (128, 64, 1, 256), (128, 1024, 1, 256),
             (128, 256, 2, 128), (128, 1024, 2, 128)]
    record = {}
    for B, T, N, C in cases:
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"B={B} T={T} N={N} C={C} {str(dtype)[6:]}"
            qkv = torch.randn(B, T, 3 * N * C, device="cuda", generator=gen).to(dtype)
            g = torch.randn(B, T, N * C, device="cuda", generator=gen).to(dtype)
            # the training forward: B3's kernel at T <= 512, B2's above
            fwd = A.attn_fwd_train if T <= A.QBLK_THRESHOLD else A.attn_fwd_qblk
            err = _check_fwd(f"{fwd.__name__} {tag}", fwd(qkv, N),
                             A.attention_qkv_reference(qkv.float(), N), dtype)
            rec = {fwd.__name__: {
                "max_abs_err": err, "ms": cuda_ms(lambda: fwd(qkv, N), iters=10),
                "plain_ms": cuda_ms(lambda: A.attention_qkv_reference(qkv, N), iters=10)}}
            dqkv = A.attn_bwd(qkv, g, N)
            err = _check_bwd(f"attn_bwd {tag}", dqkv, A.attention_qkv_bwd_reference(qkv, g, N), dtype)
            lse, delta = A.attn_bwd_rows(qkv, g, N, dqkv)
            plain = cuda_ms(lambda: A.attention_qkv_bwd_reference(qkv, g, N), iters=10)
            rec["attn_bwd_rows"] = {"max_abs_err": err, "plain_ms": plain,
                                    "ms": cuda_ms(lambda: A.attn_bwd_rows(qkv, g, N, dqkv), iters=10)}
            rec["attn_bwd_cols"] = {"max_abs_err": err, "plain_ms": plain, "ms": cuda_ms(
                lambda: A.attn_bwd_cols(qkv, g, N, lse, delta, dqkv), iters=10)}
            for name, r in rec.items():
                print(f"train-kernels: {name} {tag}: max_abs_err={r['max_abs_err']} ms={r['ms']} "
                      f"plain_ms={r['plain_ms']}" + (" (plain: whole backward)" if "bwd" in name else ""),
                      flush=True)
                if dtype == torch.bfloat16 and name not in record:
                    record[name] = r
            del qkv, g, dqkv, lse, delta
    return record


def _perturbed_unet(cfg, dtype=torch.float32):
    """Full-width UNet with random weights; zero-init layers get noise so the
    output (and every check on it) is not trivially zero."""
    from vdiff_tpu_torch.factory import build_unet

    gen = torch.Generator().manual_seed(1234)
    model = build_unet(cfg["model"], in_channels=3, model_out_type=cfg["diffusion"]["model_out_type"],
                       num_classes=10, multitags=False, dtype=dtype, generator=gen)
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim >= 2 and not bool(p.any()):
                p.normal_(0.0, 0.05, generator=gen)
    return model.eval()


def phase_unet(cfg):
    from vdiff_tpu_torch.ops import attention as A

    model = _perturbed_unet(cfg)
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(2, 32, 32, 3, generator=gen)
    t = torch.rand(2, generator=gen)
    y = torch.tensor([3.0, 0.0])  # a class and the CFG null label
    with torch.inference_mode():
        ref = model(x, t, y)
        model_gpu = copy.deepcopy(model).cuda()
        n_on, n_q = A.attn_fwd_online.launches, A.attn_fwd_qblk.launches
        out = model_gpu(x.cuda(), t.cuda(), y.cuda()).cpu()
    d_on, d_q = A.attn_fwd_online.launches - n_on, A.attn_fwd_qblk.launches - n_q
    scale = max(1.0, ref.abs().max().item())
    err = (out - ref).abs().max().item()
    print(f"unet: cifar10_cond full width B=2 f32, cuda vs cpu max_abs_err={err} "
          f"(|ref|max={scale}), kernel launches online={d_on} qblk={d_q}", flush=True)
    if not bool(torch.isfinite(out).all()) or err > UNET_RTOL * scale:
        fail(f"unet: cuda vs cpu max err {err} > {UNET_RTOL} * {scale}")
    if (d_on, d_q) != (ONLINE_PER_FWD, QBLK_PER_FWD):
        fail(f"unet: one forward launched online={d_on} qblk={d_q} kernels, "
             f"expected {ONLINE_PER_FWD} and {QBLK_PER_FWD}")
    return model


def _counts():
    from vdiff_tpu_torch.ops import attention as A

    return {name: getattr(A, name).launches for name in KERNELS}


def _reset_counts():
    from vdiff_tpu_torch.ops import attention as A

    for name in KERNELS:
        getattr(A, name).launches = 0


def phase_train_unet(cfg):
    """One full-width f32 train step at B=2 on CUDA vs the CPU; returns the
    kernels' launch counts of the CUDA step."""
    from vdiff_tpu_torch.factory import build_diffusion
    from vdiff_tpu_torch.train_lib import Optimizer, make_train_step

    model = _perturbed_unet(dict(cfg, model=dict(cfg["model"], drop_rate=0.0)))
    cond = cfg["conditional"]
    diffusion, timesteps = build_diffusion(cfg["diffusion"], w_guide=cond["w_guide"],
                                           p_uncond=cond["p_uncond"])
    gen = torch.Generator().manual_seed(11)
    x = torch.rand(2, 32, 32, 3, generator=gen) * 2 - 1
    y = torch.tensor([3, 7])
    draws = [{"t": torch.rand(2, generator=gen), "noise": torch.randn(2, 32, 32, 3, generator=gen),
              "keep": torch.tensor([True, False])}]

    def run(device):
        m = copy.deepcopy(model).to(device)
        ema = copy.deepcopy(m).requires_grad_(False)
        opt = Optimizer(m.parameters(), lr=STEP_LR, weight_decay=1e-3, warmup=0, grad_norm=1.0)
        step = make_train_step(m, diffusion, opt, timesteps, use_cfg=True, ema_model=ema)
        d = [{k: v.to(device) for k, v in draws[0].items()}]
        before = _counts()
        loss = step(x.to(device), y.to(device), 0, 0, draws=d).item()
        launched = {k: v - before[k] for k, v in _counts().items()}
        grads = torch.cat([p.grad.flatten().cpu() for p in m.parameters()])
        params = torch.cat([p.detach().flatten().cpu() for p in m.parameters()])
        return loss, grads, params, launched

    cpu_loss, cpu_g, cpu_p, _ = run("cpu")
    loss, g, p, launched = run("cuda")
    loss_err = abs(loss - cpu_loss) / abs(cpu_loss)
    grad_scale = cpu_g.abs().max().item()
    grad_err = (g - cpu_g).abs().max().item() / grad_scale
    moved = (p - cpu_p).abs() / STEP_LR
    signed = cpu_g.abs() > STEP_GRAD_RTOL * grad_scale
    param_err, near_zero_err = moved[signed].max().item(), moved.max().item()
    print(f"train-unet: cifar10_cond full width B=2 f32 one step, cuda vs cpu: loss {loss} vs "
          f"{cpu_loss} (rel {loss_err}), grads max err {grad_err} of the largest, params max "
          f"err {param_err} of lr ({near_zero_err} of lr over the {int((~signed).sum())} entries "
          f"whose gradient is within tolerance of zero), launches {launched}", flush=True)
    if not (math.isfinite(loss) and loss_err <= STEP_LOSS_RTOL and grad_err <= STEP_GRAD_RTOL
            and param_err <= STEP_PARAM_RTOL and near_zero_err <= STEP_SIGN_BOUND):
        fail("train-unet: cuda step disagrees with the cpu step")
    if launched != TRAIN_STEP_LAUNCHES:
        fail(f"train-unet: one step launched {launched}, expected {TRAIN_STEP_LAUNCHES}")


def phase_train_cli(tmp):
    """The train CLI end to end, then generate from its ckpt_last; returns the
    kernels' launch counts of the training run."""
    from vdiff_tpu_torch import generate, train

    _reset_counts()
    t0 = time.perf_counter()
    summary = train.main(["--config-path", TRAIN_CONFIG, "--allow-bf16", "--epochs", "1",
                          "--exp-dir", os.path.join(tmp, "exps")])
    seconds = time.perf_counter() - t0
    launched = _counts()
    ckpt = os.path.join(summary["ckpt_dir"], "ckpt_last.pt")
    print(f"train-cli: synthetic_flagship bf16 B=128, {summary['steps']} steps, loss "
          f"{summary['loss']}, {summary['img_per_s']} img/s over the steps after the first, "
          f"{seconds:.1f} s with the sample grid and checkpoint, launches {launched}", flush=True)
    steps = summary["steps"]
    if steps != 4 or summary["loss"] is None or not math.isfinite(summary["loss"]):
        fail(f"train-cli: {steps} steps, loss {summary['loss']}")
    if not (os.path.exists(ckpt) and os.path.exists(os.path.join(summary["image_dir"], "1.png"))):
        fail("train-cli: no ckpt_last.pt or sample grid")
    want = {k: v * steps for k, v in TRAIN_STEP_LAUNCHES.items()}
    # the epoch-end sample grid: one inference forward per sampling step
    want["attn_fwd_online"] += ONLINE_PER_FWD * STEPS
    want["attn_fwd_qblk"] += QBLK_PER_FWD * STEPS
    if launched != want:
        fail(f"train-cli: launches {launched}, expected {want}")
    out = generate.main(["--config-path", TRAIN_CONFIG, "--ckpt-path", ckpt, "--use-ema",
                         "--use-ddim", "--allow-bf16", "--sample-timesteps", "8", "--batch-size",
                         "16", "--total-size", "16", "--save-dir", os.path.join(tmp, "gen")])
    print(f"train-cli: generate from ckpt_last: {out['images']} samples, 8 DDIM steps, "
          f"finite={out['finite']}", flush=True)
    if out["images"] != 16 or not out["finite"]:
        fail(f"train-cli: generate from ckpt_last gave {out}")
    return launched


def phase_sample(model, tmp):
    """The CLI end to end; returns the launch counts of the whole phase."""
    from vdiff_tpu_torch import generate
    from vdiff_tpu_torch.ops import attention as A

    ckpt = os.path.join(tmp, "model.pt")
    sd = model.state_dict()
    torch.save({"model": sd, "ema": {"shadow": sd}}, ckpt)
    runs = [("w=0", "0", 64, 128), ("cfg w=0.1", "0.1", 32, 32)]
    _reset_counts()
    for name, w, bs, total in runs:
        n_on, n_q = A.attn_fwd_online.launches, A.attn_fwd_qblk.launches
        summary = generate.main([
            "--config-path", CONFIG, "--ckpt-path", ckpt, "--save-dir", os.path.join(tmp, "out"),
            "--use-ema", "--use-ddim", "--allow-bf16", "--sample-timesteps", str(STEPS),
            "--w-guide", w, "--batch-size", str(bs), "--total-size", str(total), "--seed", "0",
        ])
        forwards = STEPS * (total // bs)
        d_on, d_q = A.attn_fwd_online.launches - n_on, A.attn_fwd_qblk.launches - n_q
        pngs = len(glob.glob(os.path.join(summary["save_dir"], "*.png")))
        print(f"sample: {name} B={bs} x{total // bs} batches, {STEPS} DDIM steps: "
              f"{summary['images'] / summary['seconds']} samples/s, {pngs} PNGs, "
              f"finite={summary['finite']}, launches online={d_on} qblk={d_q}", flush=True)
        if pngs != total or not summary["finite"]:
            fail(f"sample {name}: {pngs} PNGs (want {total}), finite={summary['finite']}")
        if (d_on, d_q) != (ONLINE_PER_FWD * forwards, QBLK_PER_FWD * forwards):
            fail(f"sample {name}: launches online={d_on} qblk={d_q}, expected "
                 f"{ONLINE_PER_FWD * forwards} and {QBLK_PER_FWD * forwards}")
    launched = _counts()
    if any(launched[k] for k in ("attn_fwd_train", "attn_bwd_rows", "attn_bwd_cols")):
        fail(f"sample: the sampler launched training kernels: {launched}")
    return launched


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs an NVIDIA GPU")
    from vdiff_tpu_torch.factory import load_experiment_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_card()
    record = phase_kernels()
    cfg, _ = load_experiment_config(CONFIG)
    model = phase_unet(cfg)
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_sample(model, tmp)
        del model
        for name, r in phase_train_kernels().items():  # the sampling shape's record stays
            record.setdefault(name, r)
        phase_train_unet(cfg)
        train_launches = phase_train_cli(tmp)
    # the sampling kernels' counts are the sampling CLI's, the training
    # kernels' the train CLI's
    launches.update({k: train_launches[k] for k in ("attn_fwd_train", "attn_bwd_rows",
                                                     "attn_bwd_cols")})

    meta = {
        "attn_fwd_online": ("vdiff_tpu_torch/csrc/attn_fwd_online.cu",
                            "vdiff_tpu/ops/attention.py:37"),
        "attn_fwd_qblk": ("vdiff_tpu_torch/csrc/attn_fwd_qblk.cu",
                          "vdiff_tpu/ops/attention.py:224"),
        "attn_fwd_train": ("vdiff_tpu_torch/csrc/attn_fwd_train.cu",
                           "vdiff_tpu/ops/attention.py:184"),
        "attn_bwd_rows": ("vdiff_tpu_torch/csrc/attn_bwd_rows.cu",
                          "vdiff_tpu/ops/attention.py:204"),
        "attn_bwd_cols": ("vdiff_tpu_torch/csrc/attn_bwd_cols.cu",
                          "vdiff_tpu/ops/attention.py:240"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        if launches[name] == 0:
            fail(f"{name} was not launched on the main path")
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], **record[name]})
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
