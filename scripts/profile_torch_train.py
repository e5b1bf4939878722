"""Where the port's train step spends its time on the GPU.

    python scripts/profile_torch_train.py [--batch 128] [--steps 8] [--cudnn-benchmark]
        [--out profile_train.txt]

Builds the full-width cifar10_cond UNet of ``vdiff_tpu_torch`` (random
weights, bf16 activations, dropout 0.2 as configured) and its train step (loss,
backward, clip, AdamW, EMA; synthetic_flagship.json's optimizer settings), runs
3 warm-up steps (each timed on its own), times ``--steps`` steps (host clock
around synchronised steps)
and then profiles 2 steps with ``torch.profiler``. Prints the step time,
images/s, the device-busy share (summed kernel time over the profiled wall
time, which the profiler's own host cost lengthens, and over the unprofiled
step), peak device memory and the kernels by total device time; the full
table goes to ``--out``. TF32 is off and cuDNN's autotuner is off unless
``--cudnn-benchmark`` is given, as the train CLI leaves them without its
``--allow-tf32`` and ``--cudnn-benchmark``. Needs a CUDA device.
"""

import argparse
import copy
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vdiff_tpu_torch.factory import build_diffusion, build_unet, load_experiment_config  # noqa: E402
from vdiff_tpu_torch.train_lib import Optimizer, make_train_step  # noqa: E402

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "vdiff_tpu", "configs", "synthetic_flagship.json")


def _device_us(evt):
    """Device time of a kernel/memcpy event; 0 for host-side (aten) events and
    for user ranges on the device timeline (``Optimizer.step#AdamW.step``),
    whose time would count their kernels a second time."""
    if not str(evt.device_type).endswith("CUDA") or getattr(evt, "is_user_annotation", False):
        return 0
    return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--cudnn-benchmark", action="store_true", help="cuDNN autotuner, as the CLI flag")
    p.add_argument("--out", default="profile_train.txt")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_train: needs a CUDA device")
    torch.backends.cudnn.benchmark = args.cudnn_benchmark
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg, _ = load_experiment_config(CONFIG)
    tr, cond = cfg["train"], cfg["conditional"]
    model = build_unet(cfg["model"], in_channels=3, model_out_type="v", num_classes=10,
                       multitags=False, dtype=torch.bfloat16,
                       generator=torch.Generator().manual_seed(0)).cuda()
    ema = copy.deepcopy(model).requires_grad_(False)
    diffusion, timesteps = build_diffusion(cfg["diffusion"], w_guide=cond["w_guide"],
                                           p_uncond=cond["p_uncond"])
    opt = Optimizer(model.parameters(), lr=tr["lr"], weight_decay=tr["weight_decay"],
                    warmup=tr["warmup"], grad_norm=tr["grad_norm"])
    step = make_train_step(model, diffusion, opt, timesteps, use_cfg=True,
                           ema_decay=tr["ema_decay"], ema_model=ema)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand(args.batch, 32, 32, 3, device="cuda", generator=gen) * 2 - 1
    y = torch.randint(1, 11, (args.batch,), device="cuda", generator=gen)

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
    head = (f"train step bf16 B={args.batch} cudnn.benchmark={args.cudnn_benchmark}: "
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
