#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port (``vdiff_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one output line each (any failure raises and exits non-zero):
  1. card: the GPU's name and power limit as nvidia-smi reports them;
  2. kernels: builds the CUDA attention kernels from vdiff_tpu_torch/csrc and
     holds each against its plain PyTorch twin at the sampler's shapes, f32
     and bf16, and times both with CUDA events;
  3. unet: the full-width cifar10_cond UNet (random weights, zero-init layers
     perturbed) in f32 on the GPU against the same UNet on the CPU;
  4. sample: the port's CLI (vdiff_tpu_torch.generate) draws 256-step DDIM
     samples at w=0 (B=64, two batches) and with CFG at w=0.1 (B=32), and the
     kernels' launch counters must show 17 + 1 launches per UNet forward.
The line before last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

import copy
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "vdiff_tpu", "configs", "cifar10_cond.json")
STEPS = 256
# attention calls per cifar10_cond UNet forward: 17 at T <= 512 (8 at T=256,
# 9 at T=64) go to the online kernel, 1 at T=1024 (up_1_us) to the q-blocked one
ONLINE_PER_FWD, QBLK_PER_FWD = 17, 1

# f32: both sides do f32 math; only the summation order differs.
F32_ATOL = 1e-4
# bf16: the kernel does f32 math on the bf16 values and rounds once at the
# output, so it must sit within half a bf16 ulp (2^-8 relative) of the twin
# run in f32 on the same values, plus the f32 allowance.
BF16_RTOL = 2.0 ** -8
# UNet f32 on the GPU vs the CPU, relative to the output's scale: GEMM/conv
# summation order and the kernels' order differ across ~60 layers.
UNET_RTOL = 1e-3


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
            out = fn(qkv, N)
            ref = A.attention_qkv_reference(qkv.float(), N)
            torch.cuda.synchronize()
            if out.shape != ref.shape or out.dtype != dtype:
                fail(f"{fn.__name__}: got {tuple(out.shape)} {out.dtype}")
            err = (out.float() - ref).abs()
            if dtype == torch.float32:
                tol = torch.full_like(ref, F32_ATOL)
            else:
                tol = BF16_RTOL * ref.abs() + F32_ATOL
            if not bool(torch.isfinite(out).all()) or bool((err > tol).any()):
                fail(f"{fn.__name__} B={B} T={T} N={N} C={C} {dtype}: max err {err.max().item()} "
                     f"over tolerance ({'atol 1e-4' if dtype == torch.float32 else '2^-8 rel + 1e-4'})")
            ms = cuda_ms(lambda: fn(qkv, N))
            plain_ms = cuda_ms(lambda: A.attention_qkv_reference(qkv, N))
            max_err = err.max().item()
            print(f"kernels: {fn.__name__} B={B} T={T} N={N} C={C} {str(dtype)[6:]}: "
                  f"max_abs_err={max_err} ms={ms} plain_ms={plain_ms}", flush=True)
            if dtype == torch.bfloat16 and fn.__name__ not in record:
                record[fn.__name__] = {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}
            del qkv, out, ref, err, tol
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


def phase_sample(model, tmp):
    """The CLI end to end; returns the launch counts of the whole phase."""
    from vdiff_tpu_torch import generate
    from vdiff_tpu_torch.ops import attention as A

    ckpt = os.path.join(tmp, "model.pt")
    sd = model.state_dict()
    torch.save({"model": sd, "ema": {"shadow": sd}}, ckpt)
    runs = [("w=0", "0", 64, 128), ("cfg w=0.1", "0.1", 32, 32)]
    A.attn_fwd_online.launches = A.attn_fwd_qblk.launches = 0
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
    return {"attn_fwd_online": A.attn_fwd_online.launches, "attn_fwd_qblk": A.attn_fwd_qblk.launches}


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

    meta = {
        "attn_fwd_online": ("vdiff_tpu_torch/csrc/attn_fwd_online.cu",
                            "vdiff_tpu/ops/attention.py:37"),
        "attn_fwd_qblk": ("vdiff_tpu_torch/csrc/attn_fwd_qblk.cu",
                          "vdiff_tpu/ops/attention.py:224"),
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
