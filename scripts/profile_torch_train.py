"""Where the port's train step spends its time on the GPU.

    python scripts/profile_torch_train.py [--config synthetic_flagship|celeba|mnist] [--batch B]
        [--steps 8] [--cudnn-benchmark] [--remat | --remat-policy conv]
        [--out profile_train.txt]

Builds the full-width UNet of ``vdiff_tpu_torch`` for ``--config`` (random
weights, bf16 activations, dropout as configured): synthetic_flagship, the
cifar10_cond model at the default B=128, celeba at the JAX bench's B=48
(bench.py:380-408: no remat, multi-hot tags), or mnist (one input channel,
heads of 128) at its config's B=128. Its train step (loss, backward,
clip, AdamW, EMA; the config's optimizer settings) runs on seeded images and
labels: 3 warm-up steps (each timed on its own), then ``--steps`` steps timed
(host clock around synchronised steps), then 2 steps profiled with ``torch.profiler``. Prints the
card's name and power limit, the step time,
images/s, the device-busy share (summed kernel time over the profiled wall
time, which the profiler's own host cost lengthens, and over the unprofiled
step), peak device memory and the kernels by total device time; the full
table goes to ``--out``. TF32 is off and cuDNN's autotuner is off unless
``--cudnn-benchmark`` is given, as the train CLI leaves them without its
``--allow-tf32`` and ``--cudnn-benchmark``. ``--remat`` and ``--remat-policy``
checkpoint the UNet's down and up blocks as the train CLI's flags do. Needs a
CUDA device.
"""

import argparse
import copy
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vdiff_tpu_torch.factory import (CONFIG_DIR, build_diffusion, build_unet,  # noqa: E402
                                     load_experiment_config)
from vdiff_tpu_torch.train_lib import Optimizer, make_train_step  # noqa: E402

# config → (classes, multi-tag, resolution, default batch, input channels)
SETUPS = {"synthetic_flagship": (10, False, 32, 128, 3), "celeba": (40, True, 64, 48, 3),
          "mnist": (10, False, 32, 128, 1)}


def _device_us(evt):
    """Device time of a kernel/memcpy event; 0 for host-side (aten) events and
    for user ranges on the device timeline (``Optimizer.step#AdamW.step``),
    whose time would count their kernels a second time."""
    if not str(evt.device_type).endswith("CUDA") or getattr(evt, "is_user_annotation", False):
        return 0
    return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", choices=sorted(SETUPS), default="synthetic_flagship")
    p.add_argument("--batch", type=int, help="default: the config's (128; celeba 48)")
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--cudnn-benchmark", action="store_true", help="cuDNN autotuner, as the CLI flag")
    p.add_argument("--remat", action="store_true", help="checkpoint the down and up blocks")
    p.add_argument("--remat-policy", choices=["conv"], help="keep their conv outputs")
    p.add_argument("--out", default="profile_train.txt")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_train: needs a CUDA device")
    print("card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0])
    torch.backends.cudnn.benchmark = args.cudnn_benchmark
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    num_classes, multitags, res, batch, channels = SETUPS[args.config]
    args.batch = args.batch or batch
    cfg, _ = load_experiment_config(os.path.join(CONFIG_DIR, f"{args.config}.json"))
    tr, cond = cfg["train"], cfg["conditional"]
    model = build_unet(cfg["model"], in_channels=channels,
                       model_out_type=cfg["diffusion"]["model_out_type"],
                       num_classes=num_classes, multitags=multitags, dtype=torch.bfloat16,
                       generator=torch.Generator().manual_seed(0), remat=args.remat,
                       remat_policy=args.remat_policy).cuda()
    ema = copy.deepcopy(model).requires_grad_(False)
    diffusion, timesteps = build_diffusion(cfg["diffusion"], w_guide=cond["w_guide"],
                                           p_uncond=cond["p_uncond"])
    opt = Optimizer(model.parameters(), lr=tr["lr"], weight_decay=tr["weight_decay"],
                    warmup=tr["warmup"], grad_norm=tr["grad_norm"])
    step = make_train_step(model, diffusion, opt, timesteps, use_cfg=True,
                           ema_decay=tr["ema_decay"], ema_model=ema)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand(args.batch, res, res, channels, device="cuda", generator=gen) * 2 - 1
    if multitags:
        y = (torch.rand(args.batch, num_classes, device="cuda", generator=gen) < 0.5).float()
    else:
        y = torch.randint(1, num_classes + 1, (args.batch,), device="cuda", generator=gen)

    n, warm_ms = 0, []
    for _ in range(3):  # the first steps build the kernels and tune cuDNN
        t0 = time.perf_counter()
        step(x, y, 0, n)
        torch.cuda.synchronize()
        warm_ms.append((time.perf_counter() - t0) * 1e3)
        n += 1
    print("warm-up steps (ms, each synchronised): " + ", ".join(f"{t:.1f}" for t in warm_ms))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        loss = step(x, y, 0, n)
        n += 1
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / args.steps * 1e3
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            step(x, y, 0, n)
            n += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    busy_us = sum(_device_us(e) for e in events)
    remat = f"remat_policy={args.remat_policy}" if model.remat_policy else f"remat={model.remat}"
    head = (f"{args.config} train step bf16 B={args.batch} {remat} "
            f"cudnn.benchmark={args.cudnn_benchmark}: "
            f"{step_ms:.3f} ms/step "
            f"({args.batch * 1e3 / step_ms:.1f} img/s, loss {loss.item():.4f}), device busy "
            f"{busy_us / (wall * 1e6):.3f} of the profiled wall time and "
            f"{busy_us / 2 / 1e3 / step_ms:.3f} of the unprofiled step, kernel time "
            f"{busy_us / 2 / 1e3:.3f} ms/step, peak memory {peak_gib:.2f} GiB")
    print(head)
    top = sorted((e for e in events if _device_us(e) > 0), key=_device_us, reverse=True)
    for e in top[:16]:
        print(f"  {_device_us(e) / 2 / 1e3:8.3f} ms/step  {e.count // 2:5d}x/step  {e.key[:90]}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        key = "self_device_time_total" if hasattr(events[0], "self_device_time_total") \
            else "self_cuda_time_total"
        f.write(head + "\n" + events.table(sort_by=key, row_limit=80) + "\n")


if __name__ == "__main__":
    main()
